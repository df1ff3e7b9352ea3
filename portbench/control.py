"""The readings the output check's limits are set from, on the card, at a
cell's own sizes: for each seed, a short run of the cell (the program's
numbers, as every run reads them) and, in the same process, its control:
the reference in the program's place computed with the operands of every
matrix product rounded to float8 e4m3 (``reference/nn.py: fp8``), the
nearest precision below the configurations' bfloat16. A train cell also
reads the fault "half of the batch left out, the mean taken over the rest"
in the reference.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 4 [--out FILE]

Benchmark runs do not run it. Prints one JSON line a seed.
"""

import argparse
import faulthandler
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.pycache_prefix = os.path.join(HERE, ".pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, os.path.dirname(HERE))


def controls(run, driver) -> dict:
    """The driver's control and faults (``controls()``)."""
    return driver.controls()


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch
    from portbench import bench

    if not torch.cuda.is_available():
        print("control: no CUDA card is available", file=sys.stderr)
        return 2
    for seed in [int(s) for s in a.seeds.split(",")]:
        args = argparse.Namespace(workload=a.workload, seed=seed, seconds=a.seconds, trace=0)
        faulthandler.dump_traceback_later(2 * bench.RUN_LIMIT_S, exit=True)
        result, _ = bench.run_cell(args, torch.device("cuda"), time.time(), extra=controls)
        faulthandler.cancel_dump_traceback_later()
        line = json.dumps({"workload": a.workload, "seed": seed, "correct": result["correct"],
                           "checks": result["checks"], **result["extra"],
                           "metrics": result["metrics"]})
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
