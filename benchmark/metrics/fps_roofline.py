"""Farthest point sampling (K1, ``csrc/fps.cu``): its bound at the
cell's shape times its launches, over its device time in the trace."""
from benchmark.metrics._shared import roofline


def read(w):
    return roofline(w, "fps", "fps_kernel")
