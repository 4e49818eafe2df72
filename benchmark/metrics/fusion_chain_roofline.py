"""The fused kNN-fusion chain kernel (K3, ``csrc/fusion_chain.cu``):
its bound at the cell's shape times its launches, over its device time in
the trace."""
from benchmark.metrics._shared import roofline


def read(w):
    return roofline(w, "fusion_chain", "fusion_chain_kernel")
