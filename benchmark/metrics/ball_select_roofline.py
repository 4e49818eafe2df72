"""The ball query's selection (K4's block form, ``csrc/smallest_k.cu``
``smallest_k_block``, at (2B, M, N) k=64 in natural order): its bound at
the cell's shape times its launches, one a step, over its device time in
the trace. The node kNN's K4 runs the warp form and is not counted."""
from benchmark.metrics._shared import roofline


def read(w):
    return roofline(w, "ball_select", "smallest_k_block")
