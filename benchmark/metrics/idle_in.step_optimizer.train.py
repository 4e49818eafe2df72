"""The device's idle share of the traced window in the train step's Adam
update (``usip.step.optimizer``, with torch's ``Optimizer.step#...``
inside it)."""
from benchmark.metrics._spans import idle_in


def read(w):
    return idle_in(w, ("usip.step.optimizer",), ("Optimizer.step#",))
