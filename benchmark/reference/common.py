"""Plain PyTorch building blocks of the reference: fp32 dense layers with
BatchNorm, squared distances, nearest neighbours, scatter reductions, and the
lower-precision matrix product of the control.

Everything here follows the published USIP networks (lijx10/USIP
``models/networks.py``, ``models/layers.py``, ``models/losses.py``) as plain
tensor operations. It imports nothing of the program under test, nor JAX.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# float8 e4m3's largest finite value, and e5m2's
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def fp32_mode() -> None:
    """Full fp32 products on the card: TF32 keeps about three decimal
    digits, and the reference is fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fake_fp8(x: Tensor, dtype, top: float) -> Tensor:
    """``x`` through float8 ``dtype`` with one scale for the tensor (its
    largest magnitude mapped to ``top``), back in fp32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """Forward operand in float8 e4m3, its gradient in float8 e5m2: the
    usual fp8 training recipe, as the control's precision."""

    @staticmethod
    def forward(ctx, x):
        return _fake_fp8(x.float(), torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fake_fp8(g.float(), torch.float8_e5m2, E5M2_MAX)


class Precision:
    """How the reference computes.

    ``name``: the precision of the trunk's, the fusion's and the
    descriptor's layers: ``'fp32'`` (the reference) or ``'fp8'`` (the
    control: each product's operands and each layer's outputs rounded to
    float8 with a scale a tensor, as the program rounds them to its bf16;
    products summed in fp32; gradients rounded to float8 e5m2).

    ``assignment`` and ``ball``: the dtype in which the configuration
    states that the point-to-node assignment compares its squared
    distances, and the ball query its squared distances and priorities
    (``'bfloat16'`` or ``'float32'``). These are the rules of the choice,
    as the draws are its inputs: the reference rounds the values it
    compares to that dtype, its arithmetic staying fp32, so that it makes
    the choices the configuration makes; the control rounds them to
    float8."""

    def __init__(self, name: str = "fp32", assignment: str = "float32",
                 ball: str = "float32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name, self.assignment, self.ball = name, assignment, ball

    def q(self, x: Tensor) -> Tensor:
        return _Fp8.apply(x) if self.name == "fp8" else x.float()

    def _compared(self, x: Tensor, dtype: str) -> Tensor:
        if self.name == "fp8":
            return _fake_fp8(x, torch.float8_e4m3fn, E4M3_MAX)
        if dtype == "bfloat16":
            return x.to(torch.bfloat16).float()
        return x

    def assignment_distances(self, sq: Tensor) -> Tensor:
        """Squared distances as the point-to-node assignment compares
        them (then clamped at 0)."""
        return self._compared(sq, self.assignment).clamp_min(0.0)

    def ball_values(self, x: Tensor) -> Tensor:
        """Squared distances or priorities as the ball query compares
        them."""
        return self._compared(x, self.ball)


def precision(config: dict, name: str = "fp32") -> Precision:
    """The reference's (``'fp32'``) or the control's (``'fp8'``) way of
    computing a configuration file's model."""
    s = config["sizes"]
    return Precision(name, s.get("compute_dtype", "float32"),
                     s.get("ball_compute_dtype", "float32"))


FP32 = Precision("fp32")


def dense(p: dict, name: str, x: Tensor, prec: Precision = FP32) -> Tensor:
    """The 1x1 convolution ``name`` over the last axis of ``x``:
    ``x @ W^T + b`` with ``W`` of shape ``(O, I, 1[, 1])``."""
    w = p[name + ".conv.weight"].flatten(1)
    return prec.q(x) @ prec.q(w).t() + p[name + ".conv.bias"]


def batchnorm(p: dict, name: str, x: Tensor, train: bool,
              eps: float = 1e-5, stats: dict = None) -> Tensor:
    """BatchNorm over every axis but the last: batch statistics (biased
    variance) in train mode, the running statistics in eval mode. In
    train mode ``stats``, where given, keeps each layer's batch mean and
    variance under its name."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dims)
        var = x.var(dims, unbiased=False)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = p[name + ".norm.running_mean"], p[name + ".norm.running_var"]
    y = (x - mean) / torch.sqrt(var + eps)
    return y * p[name + ".norm.weight"] + p[name + ".norm.bias"]


def layer(p: dict, name: str, x: Tensor, train: bool,
          prec: Precision = FP32, norm: bool = True, relu: bool = True,
          stats: dict = None) -> Tensor:
    """Dense, BatchNorm, ReLU (each of the last two where asked)."""
    y = prec.q(dense(p, name, x, prec))
    if norm:
        y = batchnorm(p, name, y, train, stats=stats)
    return prec.q(torch.relu(y) if relu else y)


def sqdist(a: Tensor, b: Tensor) -> Tensor:
    """Squared distances ``(..., M, N)`` between rows of ``a (..., M, D)``
    and ``b (..., N, D)``, as the sum of squared differences (no
    cancellation)."""
    return (a[..., :, None, :] - b[..., None, :, :]).square().sum(-1)


def sqdist_blocked(a: Tensor, b: Tensor, block: int = 2048) -> Tensor:
    """``sqdist`` over blocks of ``a``'s rows, for long clouds."""
    return torch.cat([sqdist(a[..., i:i + block, :], b)
                      for i in range(0, a.shape[-2], block)], dim=-2)


def nearest(src: Tensor, dst: Tensor, block: int = 2048):
    """Each src row's nearest dst row: ``(distance (B, M), index (B, M))``.
    The index is found without gradient; the distance is recomputed from
    the pair, differentiable in both (0 with a zero gradient at coincident
    points)."""
    with torch.no_grad():
        idx = torch.cat([sqdist(src[:, i:i + block], dst).argmin(-1)
                         for i in range(0, src.shape[1], block)], dim=1)
    diff = src - gather(dst, idx)
    sq = diff.square().sum(-1)
    pos = sq > 0
    dist = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    return dist, idx


def gather(x: Tensor, idx: Tensor) -> Tensor:
    """Rows of ``x (B, N, C)`` at ``idx (B, ...)`` -> ``(B, ..., C)``."""
    b = x.shape[0]
    batch = torch.arange(b, device=x.device).view(b, *([1] * (idx.dim() - 1)))
    return x[batch, idx.long()]


def scatter_max(f: Tensor, ids: Tensor, m: int) -> Tensor:
    """Per-node channel max of ``f (B, N, C)`` over ``ids (B, N)``; a node
    no point maps to is 0. The gradient is split evenly among tied maxima
    (PyTorch's rule for ``amax``)."""
    b, _, c = f.shape
    out = f.new_zeros((b, m, c))
    return out.scatter_reduce(1, ids[..., None].expand(-1, -1, c), f, "amax",
                              include_self=False)


def scatter_mean(x: Tensor, ids: Tensor, m: int, eps: float = 1e-5):
    """Per-node mean ``sums / (counts + eps)`` and the counts."""
    b, _, c = x.shape
    sums = x.new_zeros((b, m, c)).scatter_add(
        1, ids[..., None].expand(-1, -1, c), x)
    counts = x.new_zeros((b, m)).scatter_add(1, ids, torch.ones_like(
        ids, dtype=x.dtype))
    return sums / (counts[..., None] + eps), counts


def smallest_k_idx(scores: Tensor, k: int) -> Tensor:
    """The k smallest entries' indices along the last axis, ascending, ties
    to the lowest index."""
    return torch.sort(scores, dim=-1, stable=True).indices[..., :k]


def fps(points: Tensor, first: Tensor, k: int) -> Tensor:
    """Farthest point sampling of ``points (B, S, 3)`` from the seed rows
    ``first (B,)``: ``(B, k)`` picks, the first of equal maxima."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    picks = torch.empty((b, k), dtype=torch.long, device=points.device)
    cur = first.long().to(points.device)
    picks[:, 0] = cur
    dists = (points - points[rows, cur][:, None]).square().sum(-1)
    for i in range(1, k):
        cur = dists.argmax(-1)
        picks[:, i] = cur
        dists = torch.minimum(dists,
                              (points - points[rows, cur][:, None])
                              .square().sum(-1))
    return picks


def euler_rotation(angles: Tensor) -> Tensor:
    """``R = Rz Ry Rx`` of Euler angles ``(B, 3)`` (USIP
    ``data/augmentation.py``)."""
    ax, ay, az = angles.unbind(-1)
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([[one, zero, zero], [zero, ax.cos(), -ax.sin()],
              [zero, ax.sin(), ax.cos()]])
    ry = mat([[ay.cos(), zero, ay.sin()], [zero, one, zero],
              [-ay.sin(), zero, ay.cos()]])
    rz = mat([[az.cos(), -az.sin(), zero], [az.sin(), az.cos(), zero],
              [zero, zero, one]])
    return rz @ ry @ rx


def rotate(points: Tensor, R: Tensor) -> Tensor:
    """``R @ p`` for each row of ``points (B, N, 3)``."""
    return points @ R.transpose(1, 2)
