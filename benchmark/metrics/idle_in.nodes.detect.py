"""The device's idle share of the traced window while ``infer`` drew
its nodes (``usip.infer.nodes``: the random subset and FPS)."""
from benchmark.metrics._spans import idle_in


def read(w):
    return idle_in(w, ("usip.infer.nodes",))
