"""Pointwise building blocks, channels-last (port of ``usip_tpu/nn/layers.py``).

Every "1x1 conv" of the reference is a dense map over the trailing channel
axis. Parameters keep the reference's ``state_dict`` names and shapes
(``conv.weight (O, I, 1[, 1])``, ``conv.bias``, ``norm.weight|bias|
running_mean|running_var|num_batches_tracked``), so a reference ``.pth``
loads with ``load_state_dict(strict=True)``.

``BatchNorm`` has usip_tpu's train mode: batch statistics, the running
statistics updated with a momentum that the train step sets from
``bn_momentum_schedule``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor


def activation_fn(name: Optional[str]):
    """Activation zoo of the reference (models/layers.py:264-273)."""
    if name is None:
        return lambda x: x
    if name == "relu":
        return torch.relu
    if name == "elu":
        return F.elu
    if name == "swish":
        # the reference's normalized swish (models/layers.py:15-20)
        return lambda x: 1.78718727865 * (x * torch.sigmoid(x) - 0.20662096414)
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, negative_slope=0.01)
    if name == "selu":
        return F.selu
    raise ValueError(f"unknown activation {name!r}")


def bn_momentum_schedule(base: float, epoch: Optional[int],
                         decay_step: Optional[int], decay: float) -> float:
    """Epoch-decayed BatchNorm momentum, clamped at 0.01 and applied from
    epoch 1 on (usip_tpu ``nn/layers.py bn_momentum_schedule``, the
    reference's models/layers.py:61-66)."""
    if epoch is None or decay_step is None or decay_step <= 0 or epoch < 1:
        return base
    return max(base * decay ** math.floor(epoch / decay_step), 0.01)


class BatchNorm(nn.Module):
    """Batch norm over the trailing channel axis, in fp32, returned in the
    input's dtype: ``(x - mean) * rsqrt(var + eps) * weight + bias``.

    Eval mode uses the running statistics. Train mode is usip_tpu's
    (``nn/layers.py BatchNorm``): the batch mean and the biased variance
    ``E[x^2] - E[x]^2`` (clamped at 0) normalize; the unbiased variance feeds
    the running statistics, ``running = (1 - m) running + m batch`` with
    ``m = self.momentum`` (``set_bn_momentum``)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.momentum = 0.1
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x: Tensor) -> Tensor:
        x32 = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            count = x.numel() // x.shape[-1]
            mean = x32.mean(dims)
            var = (x32.square().mean(dims) - mean.square()).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (count / max(count - 1, 1))
                self.running_mean.copy_((1.0 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1.0 - m) * self.running_var
                                       + m * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


def set_bn_momentum(module: nn.Module, momentum: float) -> None:
    """Set the running-statistics momentum of every ``BatchNorm`` under
    ``module`` (usip_tpu passes it to each call instead)."""
    for mod in module.modules():
        if isinstance(mod, BatchNorm):
            mod.momentum = momentum


class Conv1x1(nn.Module):
    """A 1x1 convolution applied channels-last. ``weight`` keeps the
    reference's conv shape ``(O, I, 1)`` (``kernel_dims=1``) or
    ``(O, I, 1, 1)`` (``kernel_dims=2``); He-normal init, zero bias."""

    def __init__(self, cin: int, cout: int, kernel_dims: int = 1):
        super().__init__()
        w = torch.empty(cout, cin, *([1] * kernel_dims))
        nn.init.normal_(w, std=(2.0 / cin) ** 0.5)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(cout))

    def kernel(self) -> Tensor:
        """The dense kernel ``(I, O)``."""
        return self.weight.flatten(1).t()

    def forward(self, x: Tensor, dtype: Optional[torch.dtype] = None) -> Tensor:
        dt = dtype or torch.float32
        return x.to(dt) @ self.kernel().to(dt) + self.bias.to(dt)


class PointwiseLayer(nn.Module):
    """Dense + optional BatchNorm + optional activation over the channel axis.

    ``dtype`` is the matmul compute dtype (None = fp32); parameters stay fp32.
    ``forward`` also takes a tuple of parts, the virtual concatenation of the
    split-kernel layer in the tuple's order: the kernel's rows are cut at the
    parts' widths, each block acting on its part, and a part of one row
    (``(..., 1, C)``, the max over K) broadcasts over the K neighbours. The
    kNN-fusion layer passes ``(h_max, h)`` (concat ``[h_max, h]``), the
    grouped trunk's conv4 ``(h, h_max)`` (concat ``[h, h_max]``); the order
    must be the reference's, since a flipped order loads the same weights
    and computes something else.
    """

    def __init__(self, cin: int, cout: int, activation: Optional[str] = "relu",
                 normalization: Optional[str] = "batch",
                 dtype: Optional[torch.dtype] = None, kernel_dims: int = 1):
        super().__init__()
        if normalization not in ("batch", None):
            raise ValueError(f"unsupported normalization {normalization!r}")
        self.conv = Conv1x1(cin, cout, kernel_dims)
        self.norm = BatchNorm(cout) if normalization == "batch" else None
        self.act = activation_fn(activation)
        self.dtype = dtype

    def forward(self, x) -> Tensor:
        if isinstance(x, tuple):
            dt = self.dtype or torch.float32
            kern = self.conv.kernel().to(dt)
            y, off = None, 0
            for part in x:
                w = part.shape[-1]
                t = part.to(dt) @ kern[off:off + w]
                y = t if y is None else y + t
                off += w
            y = y + self.conv.bias.to(dt)
        else:
            y = self.conv(x, self.dtype)
        if self.norm is not None:
            y = self.norm(y)
        return self.act(y)


class SharedMLP(nn.Module):
    """Stack of PointwiseLayers under ``layers.{i}``; the last layer is linear
    (no norm, no activation), like the reference's ``PointNet``."""

    def __init__(self, cin: int, features: Sequence[int],
                 activation: Optional[str] = "relu",
                 normalization: Optional[str] = "batch",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        layers = []
        for i, c in enumerate(features):
            last = i == len(features) - 1
            layers.append(PointwiseLayer(
                cin, c, activation=None if last else activation,
                normalization=None if last else normalization, dtype=dtype))
            cin = c
        self.layers = nn.ModuleList(layers)

    def forward(self, x: Tensor) -> Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
