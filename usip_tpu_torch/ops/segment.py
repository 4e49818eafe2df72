"""Scatter/segment reductions onto nodes (port of ``usip_tpu/ops/segment.py``).

The masked scatter-max is the scatter-max kernel (``ops.kernels.scatter_max``,
the counterpart of ``scripts/bench_scatter_pallas.py scatter_max_pallas``) for
CUDA tensors; the sums and gathers are plain PyTorch (a sorted segment sum,
``scatter_add``, gather).
"""

from __future__ import annotations

from typing import Tuple

import torch

from usip_tpu_torch.ops import kernels

Tensor = torch.Tensor


def _expand(ids: Tensor, c: int) -> Tensor:
    return ids[..., None].expand(*ids.shape, c)


class MaskedScatterMax(torch.autograd.Function):
    """The masked scatter-max with usip_tpu's gradients. The forward is the
    scatter-max kernel; the backward is plain PyTorch (usip_tpu has no
    backward kernel either: ``_masked_max_fast`` takes XLA's scatter-max
    gradient). A point whose feature equals its node's max in a channel
    takes that cell's cotangent: under ``'fast'`` split equally among the
    tied points (XLA's rule), under ``'native'`` all to the first of them
    (the reference's ``index_max``). Empty nodes pass no gradient."""

    @staticmethod
    def forward(ctx, f: Tensor, ids: Tensor, num_segments: int,
                backend: str):
        out = kernels.scatter_max(f, ids, num_segments)
        ctx.save_for_backward(f, ids, out)
        ctx.backend = backend
        return out

    @staticmethod
    def backward(ctx, g):
        f, ids, out = ctx.saved_tensors
        c = f.shape[-1]
        at_max = f == scatter_back(out, ids)                   # (B, N, C)
        g_pt = scatter_back(g, ids)
        if ctx.backend == "fast":
            ties = torch.zeros_like(out)
            ties.scatter_add_(1, _expand(ids, c), at_max.to(out.dtype))
            share = g_pt / scatter_back(ties, ids).clamp_min(1.0)
            g_f = torch.where(at_max, share, torch.zeros_like(share))
        else:
            n = f.shape[1]
            point = torch.arange(n, device=f.device).view(1, n, 1)
            cand = torch.where(at_max, point, n)
            first = torch.full(out.shape, n, dtype=cand.dtype,
                               device=f.device)
            first = first.scatter_reduce(1, _expand(ids, c), cand, "amin")
            g_f = torch.where(point == scatter_back(first, ids), g_pt,
                              torch.zeros_like(g_pt))
        return g_f, None, None, None


def masked_scatter_max(f: Tensor, ids: Tensor, num_segments: int,
                       backend: str = "fast") -> Tensor:
    """Per-node channel max of point features: ``f (B, N, C)`` fp32,
    ``ids (B, N)`` int64 -> ``(B, M, C)``; empty nodes are 0.
    Differentiable in ``f`` with the ``backend``'s tie rule, ``'fast'``
    (XLA's: the cotangent split among tied maxima) or ``'native'`` (the
    first argmax); ``'onehot'``, a forward-only TPU workaround, is not
    ported."""
    if backend not in ("fast", "native"):
        raise ValueError(f"unknown scatter backend {backend!r}; the port "
                         "has 'fast' and 'native'")
    return MaskedScatterMax.apply(f, ids, num_segments, backend)


def segment_mean_count(x: Tensor, ids: Tensor, num_segments: int,
                       eps: float = 1e-5) -> Tuple[Tensor, Tensor]:
    """Per-node mean of ``x (B, N, D)`` and the count of points:
    ``sums / (counts + eps)``, ``counts`` -> ``(B, M, D)``, ``(B, M)``.
    Each node's sum runs over its points in index order (a stable sort by
    node, then a segment sum): the same bits on every run and for a cloud
    in any batch, where CUDA's atomic scatter-add sums in the order its
    threads arrive. The counts are taken in int64, exact in any order and
    at any size, and the segment lengths are those integers. The sums and
    the division run in fp32 (a bf16 sum stops growing at 256 ones); the
    means and counts come back in ``x``'s dtype."""
    b, _, d = x.shape
    lengths = torch.zeros((b, num_segments), dtype=torch.int64,
                          device=x.device)
    lengths.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.int64))
    order = ids.argsort(dim=1, stable=True)
    sums = torch.segment_reduce(
        torch.gather(x.float(), 1, _expand(order, d)), "sum",
        lengths=lengths, axis=1, unsafe=True)
    means = sums / (lengths[..., None].float() + eps)
    return means.to(x.dtype), lengths.to(x.dtype)


def scatter_back(node_features: Tensor, ids: Tensor) -> Tensor:
    """Each point's node feature: ``out[b, n] = nf[b, ids[b, n]]``."""
    return torch.gather(node_features, 1,
                        _expand(ids, node_features.shape[-1]))
