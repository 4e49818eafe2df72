"""Pointwise building blocks."""

from usip_tpu_torch.nn.layers import (BatchNorm, Conv1x1, PointwiseLayer,
                                      SharedMLP, activation_fn)

__all__ = ["BatchNorm", "Conv1x1", "PointwiseLayer", "SharedMLP",
           "activation_fn"]
