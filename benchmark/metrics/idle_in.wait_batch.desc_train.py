"""The device's idle share of the traced window while the descriptor's
engine waited for its next pair batch (``usip.engine.wait_batch``)."""
from benchmark.metrics._spans import idle_in


def read(w):
    return idle_in(w, ("usip.engine.wait_batch",))
