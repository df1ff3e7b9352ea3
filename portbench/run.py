"""Runs one cell of the benchmark of ``phoneme_vqa_torch`` once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. The cell is
``portbench/workloads/<cell>.json``; it names a configuration
(``portbench/configs/``) and a traffic mix (``portbench/traffic/``). The run
builds its fixture and weights from the seed, warms up the cell's shapes,
measures for ``--seconds``, checks the outputs against the plain float32
reference in ``portbench/reference/`` and prints one JSON line last on
standard output (with ``--trace 1`` the cell's per-layer metrics, read from
a profiler slice inside the window). It exits non-zero and prints no result
without a card, without the port, or when the outputs are not checked.
"""

import os
import sys
import time


def _process_start() -> float:
    """When this process started, on the ``time.time()`` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


START = _process_start()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# one bytecode cache at a fixed path inside the checkout, set before the
# first heavy import: a run after the first compiles no Python source
sys.pycache_prefix = os.path.join(HERE, ".pycache")
sys.dont_write_bytecode = False
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.bench import main

    sys.exit(main(sys.argv[1:], START))
