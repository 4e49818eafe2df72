"""The device's idle share of the traced window while the engine waited
for its next batch (``usip.engine.wait_batch``)."""
from benchmark.metrics._spans import idle_in


def read(w):
    return idle_in(w, ("usip.engine.wait_batch",))
