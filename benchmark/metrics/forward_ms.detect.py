"""Mean device time of a batch's ``KeypointPipeline.infer``: CUDA
events around each call."""
from benchmark.metrics._shared import mean


def read(w):
    return mean(w.events_ms.get("forward", []))
