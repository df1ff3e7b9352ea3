from .logger import get_logger
from .registry import Registry

__all__ = ["get_logger", "Registry"]
