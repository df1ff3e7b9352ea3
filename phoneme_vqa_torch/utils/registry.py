"""String-keyed registries.

Config values such as ``EXECUTOR: "LaTr_Executor"``, ``MODEL_CLASS: "LaTr"``
or ``MODEL_MOD_CONFIG_CLASS: "LaTr_config"`` (and ``DecodeTokenizer:
"BPE_Tokenizer"``) resolve to classes through these
dict-based registries, as they do in ``phoneme_vqa_tpu.utils.registry``.
The port keeps its own instances: ``register`` raises when a name is
already bound to a different class.
"""

from __future__ import annotations

from typing import Callable, Dict, TypeVar

T = TypeVar("T")


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, type] = {}

    def register(self, name: str | None = None) -> Callable[[T], T]:
        def wrap(cls: T) -> T:
            key = name or cls.__name__
            if key in self._entries and self._entries[key] is not cls:
                raise KeyError(f"{self.kind} registry already has {key!r}")
            self._entries[key] = cls
            return cls

        return wrap

    def get(self, name: str) -> type:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(
                f"Unknown {self.kind} {name!r}. Registered: {known}"
            ) from None


EXECUTORS = Registry("executor")
MODELS = Registry("model")
MODEL_CONFIGS = Registry("model_config")
TOKENIZERS = Registry("tokenizer")
