"""Mean device time of a train step: CUDA events around each call of
the engine's ``train_step``."""
from benchmark.metrics._shared import mean


def read(w):
    return mean(w.events_ms.get("train_step", []))
