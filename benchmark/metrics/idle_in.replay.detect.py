"""The device's idle share of the traced window in the replay of the
eval forward's CUDA graph (``usip.infer.replay``: the input copies and the
launch). None where no gap carries that label: a program that runs the
forward eagerly has no such span."""
from benchmark.metrics._spans import idle_in

REPLAY = "usip.infer.replay"


def read(w):
    if w.trace is None or all(label != REPLAY
                              for label, _ in w.trace["idle_gaps"]):
        return None
    return idle_in(w, (REPLAY,))
