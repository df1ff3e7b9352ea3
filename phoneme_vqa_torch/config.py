"""Config: an attribute-access dict with the JAX package's key names.

``Config`` accepts a plain dict, so the serving path and ``chip_smoke.py``
need no YAML parser; PyYAML is imported only inside :func:`get_config`,
which the CLIs (``phoneme_vqa_torch/run.py``, ``serve.py``) call to read a
preset that is not JSON. The
presets' ``DEVICE`` key is not read: the port takes its device from the
caller.
"""

from __future__ import annotations

import json
from typing import Any, Mapping


class Config(dict):
    """Attribute-access dict (recursive). ``cfg.LR``, ``cfg.get('SAVE', True)``."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = Config(v) if isinstance(v, Mapping) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"Config has no key {name!r}") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def require(self, *keys: str) -> None:
        """Fail fast with every missing (or null) key named."""
        missing = [k for k in keys if k not in self or self[k] is None]
        if missing:
            raise ValueError(
                f"config is missing required key(s) {missing}: add them to the YAML preset "
                f"(configs/ holds complete examples)"
            )


# Defaults for keys that executors read but some YAML presets omit.
_DEFAULTS: dict[str, Any] = {
    "DEVICE": "cuda",
    "SAVE": True,
    "NUM_FREEZE_EPOCH": 0,
    "get_predict_score": False,
    "NUMWORKERS": 0,
    "SEED": 13,
    "DTYPE": "bfloat16",
}


def get_config(yaml_file: str) -> Config:
    """Load a YAML preset into a Config (the same presets the JAX package
    reads); a ``.json`` file is read with the standard library (a machine
    without PyYAML)."""
    with open(yaml_file, "r", encoding="utf-8") as f:
        if yaml_file.endswith(".json"):
            raw = json.load(f)
        else:
            import yaml

            raw = yaml.safe_load(f) or {}
    cfg = Config(_DEFAULTS)
    for k, v in Config(raw).items():
        cfg[k] = v
    return cfg
