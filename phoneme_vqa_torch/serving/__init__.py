from .engine import SaLInputs, ServingEngine, featurize_requests

__all__ = ["SaLInputs", "ServingEngine", "featurize_requests"]
