"""The ``--aot DIR`` store of ``serve.py`` (counterpart of
``phoneme_vqa_tpu/serving/aot.py``).

The JAX store serializes the compiled serve executables under a manifest of
the environment, so a restart answers with zero compiles. The port's serve
path has two compiled parts: the CUDA kernels, built by ``nvcc`` at first
use (``ops/_build.py``), and the CUDA graphs of the decode, captured at
warmup (``serving/graphs.py``). A CUDA graph cannot be serialized, so the
store holds what can be kept: the kernels' built shared libraries, under a
manifest that names the card, the driver, the CUDA toolkit, the torch
version, the nvcc flags and, in each library's file name, the hash of its
source. ``load`` copies the libraries of a matching store into the build
directory, where ``_build.build`` finds them and starts no ``nvcc``; every
process still captures its own graphs (README). A store that is missing,
unreadable, or packed for another environment or other sources is a clean
miss: the kernels build as usual and ``pack`` (re)writes the store.

Over a serving mesh (``serve.py`` under torchrun) rank 0 loads the store,
builds what it lacks and packs, while the other ranks wait at a barrier and
then load; a library already in the build directory is not copied again,
so no two ranks write it at once. The manifest records the mesh the store
was packed under (``data``, ``model``, ``world``), as the JAX store records
its device ids. The libraries do not depend on the mesh (a rank runs the
same kernels on its head slices or its rows), so a store packed under
another mesh, or none, still loads: the difference is logged, not a miss.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import Dict, List, Optional, Sequence

from ..ops import _build
from ..utils.logger import get_logger

log = get_logger(__name__)

_MANIFEST = "manifest.json"
_FORMAT = 1
#: the port's kernels (ops/flash_attention.py, ops/sal_fused_attention.py)
KERNELS = ("flash_attention", "sal_fused_attention")


def _query(cmd: Sequence[str]) -> Optional[str]:
    try:
        out = subprocess.run(list(cmd), capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def env_fingerprint() -> Dict[str, object]:
    """What a built kernel library is specialized to."""
    import torch

    driver = _query(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"])
    try:
        nvcc = _query([_build._nvcc(), "--version"])
    except RuntimeError:
        nvcc = None
    return {
        "format": _FORMAT,
        "device_kind": torch.cuda.get_device_name(0) if torch.cuda.is_available() else None,
        "driver": driver.splitlines()[0] if driver else None,
        "cuda_toolkit": nvcc.splitlines()[-1] if nvcc else None,
        "torch": torch.__version__,
        "nvcc_flags": " ".join(_build.NVCC_FLAGS),
    }


def library_file(name: str) -> str:
    """The file name of ``name``'s library: it carries the hash of the
    source, the headers and the flags (``_build._lib_path``)."""
    return os.path.basename(_build._lib_path(name))


def built(names: Sequence[str] = KERNELS, build_dir: str = None) -> List[str]:
    """The kernels of ``names`` whose library for the current sources is in
    ``build_dir``."""
    build_dir = build_dir or _build.BUILD_DIR
    return [n for n in names if os.path.isfile(os.path.join(build_dir, library_file(n)))]


def mesh_record(mesh) -> Optional[Dict[str, int]]:
    """The manifest's record of a serving mesh (``parallel/mesh.py: Mesh``),
    or None for one process."""
    if mesh is None:
        return None
    return {"data": int(mesh.dp), "model": int(mesh.tp), "world": int(mesh.dp * mesh.tp)}


def load(path: str, build_dir: str = None, mesh=None) -> List[str]:
    """Copy the libraries of the store at ``path`` into ``build_dir`` and
    return the kernels loaded, or ``[]`` (with the reason logged) when the
    store is absent, unreadable or packed for another environment. A
    library built from other sources is skipped; one already in
    ``build_dir`` is kept as it is. ``mesh``: the serving mesh, compared
    with the manifest's (logged only)."""
    build_dir = build_dir or _build.BUILD_DIR
    manifest_path = os.path.join(path, _MANIFEST)
    if not os.path.exists(manifest_path):
        log.info(f"## AOT store: no manifest at {path} (first start?)")
        return []
    try:
        with open(manifest_path, encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        log.warning(f"(!) AOT store: unreadable manifest ({e!r}): ignoring it")
        return []
    env = env_fingerprint()
    stale = {k: (manifest.get("env", {}).get(k), v) for k, v in env.items()
             if manifest.get("env", {}).get(k) != v}
    if stale:
        log.warning(f"(!) AOT store at {path} was packed for a different environment "
                    f"({stale}): ignoring it; the kernels build and the store is re-packed")
        return []
    if manifest.get("mesh") != mesh_record(mesh):
        log.info(f"## AOT store at {path} was packed under mesh {manifest.get('mesh')}, this "
                 f"process serves under {mesh_record(mesh)}: the kernel libraries do not depend "
                 "on the mesh, loading them")
    os.makedirs(build_dir, exist_ok=True)
    loaded = []
    for name, fname in manifest.get("kernels", {}).items():
        if name not in KERNELS or fname != library_file(name):
            log.info(f"## AOT store: {fname} is not the library of the current {name} source")
            continue
        src = os.path.join(path, fname)
        if not os.path.isfile(src):
            log.warning(f"(!) AOT store: {src} is missing: skipped")
            continue
        if os.path.isfile(os.path.join(build_dir, fname)):  # the same source hash
            loaded.append(name)
            continue
        tmp = os.path.join(build_dir, fname + ".tmp")
        shutil.copyfile(src, tmp)
        os.replace(tmp, os.path.join(build_dir, fname))
        loaded.append(name)
    if loaded:
        log.info(f"## AOT store loaded {loaded} from {path}: no nvcc for them")
    return loaded


def pack(path: str, build_dir: str = None, mesh=None) -> List[str]:
    """Write the built kernel libraries of ``build_dir`` and the manifest
    (with ``mesh``, the serving mesh) into ``path``; return the kernels
    packed."""
    build_dir = build_dir or _build.BUILD_DIR
    names = built(KERNELS, build_dir)
    os.makedirs(path, exist_ok=True)
    for name in names:
        fname = library_file(name)
        shutil.copyfile(os.path.join(build_dir, fname), os.path.join(path, fname))
    manifest = {"env": env_fingerprint(), "mesh": mesh_record(mesh),
                "kernels": {n: library_file(n) for n in names}}
    tmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(path, _MANIFEST))
    log.info(f"## AOT store packed {names} into {path}")
    return names
