"""The device's idle share of the traced window in the train step's
forward (``usip.step.forward``, with torch's ``Optimizer.zero_grad#...``
inside it)."""
from benchmark.metrics._spans import idle_in


def read(w):
    return idle_in(w, ("usip.step.forward",), ("Optimizer.zero_grad#",))
