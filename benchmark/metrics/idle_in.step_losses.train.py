"""The device's idle share of the traced window in the train step's losses
(``usip.step.losses``)."""
from benchmark.metrics._spans import idle_in


def read(w):
    return idle_in(w, ("usip.step.losses",))
