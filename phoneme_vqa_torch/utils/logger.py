"""Logging facade: ``get_logger(name)`` returns an INFO logger with a
``[%(asctime)s] %(message)s`` format, as in the JAX package."""

import logging

_FORMAT = "[%(asctime)s] %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if not _configured:
        logging.basicConfig(format=_FORMAT, level=logging.INFO)
        _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure()
    return logging.getLogger(name)
