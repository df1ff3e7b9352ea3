from .continuous import ContinuousEngine
from .engine import ServingEngine, decode_answer_rows, decode_rows, featurize_requests
from .graphs import GraphDecoder
from .watchdog import StallWatchdog, fail_future

__all__ = ["ContinuousEngine", "GraphDecoder", "ServingEngine", "StallWatchdog",
           "decode_answer_rows", "decode_rows", "fail_future", "featurize_requests"]
