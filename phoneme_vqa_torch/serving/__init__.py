from .engine import ServingEngine, featurize_requests

__all__ = ["ServingEngine", "featurize_requests"]
