"""The port's CLI, the counterpart of the root ``run.py``:

    python -m phoneme_vqa_torch.run --config-file F --mode {train,eval,predict}
        [--evaltype {last,best}] [--predicttype {last,best}] [--device cuda|cpu]

The ``EXECUTOR`` string in the YAML selects the executor from the registry.
The device is the ``--device`` argument (default: the card), never the
preset's ``DEVICE`` key.
"""

from __future__ import annotations

import argparse

from .config import get_config
from . import train  # noqa: F401  (registers the executors)
from .utils.registry import EXECUTORS


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m phoneme_vqa_torch.run")
    parser.add_argument("--config-file", type=str, required=True)
    parser.add_argument("--mode", type=str, required=True, choices=["train", "eval", "predict"])
    parser.add_argument("--evaltype", type=str, default="last", choices=["last", "best"])
    parser.add_argument("--predicttype", type=str, default="best", choices=["last", "best"])
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    config = get_config(args.config_file)
    executor = EXECUTORS.get(config.EXECUTOR)(
        config, args.mode, args.evaltype, args.predicttype, device=args.device
    )
    return executor.run()


if __name__ == "__main__":
    main()
