"""The device's idle share of the traced window in the node kNN and the
fused chain (``usip.infer.fusion``)."""
from benchmark.metrics._spans import idle_in


def read(w):
    return idle_in(w, ("usip.infer.fusion",))
