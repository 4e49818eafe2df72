"""The device's idle share of the traced window in the detector's trunk
(``usip.infer.trunk``)."""
from benchmark.metrics._spans import idle_in


def read(w):
    return idle_in(w, ("usip.infer.trunk",))
