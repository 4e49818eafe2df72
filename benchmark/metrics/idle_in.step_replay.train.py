"""The device's idle share of the traced window in the replay of the
detector step's CUDA graph (``usip.step.replay``: the launch of its device
part, from the input preparation to the gradients). None where no gap
carries that label: a program that runs the step eagerly has no such
span."""
from benchmark.metrics._spans import idle_in

REPLAY = "usip.step.replay"


def read(w):
    if w.trace is None or all(label != REPLAY
                              for label, _ in w.trace["idle_gaps"]):
        return None
    return idle_in(w, (REPLAY,))
