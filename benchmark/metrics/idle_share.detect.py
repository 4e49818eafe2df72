"""The device's idle share of the traced window of a detect cell."""
from benchmark.metrics._shared import idle_share


def read(w):
    return idle_share(w)
