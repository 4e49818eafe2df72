"""Forward model FLOPs of the clouds detected over the window's wall
time at the bf16 peak."""
from benchmark.metrics._shared import mfu


def read(w):
    return mfu(w)
