"""The device's idle share of the traced window of a train cell."""
from benchmark.metrics._shared import idle_share


def read(w):
    return idle_share(w)
