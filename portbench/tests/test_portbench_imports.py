"""Nothing the benchmark runs imports JAX, flax, the JAX package, chip_smoke
or the JAX bench scripts, by whole top-level module name."""

import os
import subprocess
import sys

from .conftest import ROOT

CODE = """
import sys
sys.path.insert(0, {root!r})
import runpy
from portbench import bench, checks, control, drivers, fixture, flops, manifest, trace, weights
import phoneme_vqa_torch.train, phoneme_vqa_torch.serving
for name in [m["name"] for m in manifest.benchmark()["per_layer"]]:
    manifest.reader(name)
for w in manifest.benchmark()["workloads"]:
    mix = manifest.traffic(w["traffic"])
    manifest.driver(mix["driver"])
    manifest.generator(mix["generator"])
    manifest.layout(manifest.family(manifest.config(w["config"])["family"]).FIXTURE)
found = bench.forbidden_modules()
print("FOUND", found)
sys.exit(1 if found else 0)
"""


def test_no_jax_in_the_benchmark_process():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", CODE.format(root=ROOT)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "FOUND []" in out.stdout


def test_the_check_compares_whole_top_level_names():
    from portbench import bench

    sys.modules.setdefault("jaxlib_not_really", sys)
    try:
        assert "jaxlib_not_really" not in bench.forbidden_modules()
    finally:
        del sys.modules["jaxlib_not_really"]
