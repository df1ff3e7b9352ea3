"""Phases 25-26 of ``chip_smoke.py`` alone: the mesh lifecycle and serving
over a mesh, the only phases whose work depends on how many cards the
machine has (with 2+ cards they add the NCCL meshes). Builds the kernels,
then runs ``chip_smoke.mesh_phase``; its lines are the full script's.

    python3 scripts/mesh_phases.py
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from phoneme_vqa_torch.ops import _build  # noqa: E402

if __name__ == "__main__":  # run_mesh spawns processes that import this module
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    _build.build(*cs.KERNELS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        cs.mesh_phase(root)
    print(f"mesh phases: {time.perf_counter() - t0:.1f} s", flush=True)
