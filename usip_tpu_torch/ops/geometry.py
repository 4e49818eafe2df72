"""Pairwise-distance primitives (PyTorch port of ``usip_tpu/ops/geometry.py``).

Squared distances use the expansion ``|a|^2 - 2 a.b + |b|^2`` in that order,
clamped at 0, like the reference package. The three coordinate products and
their sums are separate elementwise ops (no matmul, no fused multiply-add), so
the CUDA kernels that reproduce them with round-to-nearest intrinsics give
bit-identical results.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def sq_norm(x: Tensor) -> Tensor:
    """``x0*x0 + x1*x1 + x2*x2`` over the last axis of ``(..., 3)``, left to right."""
    x0, x1, x2 = x.unbind(-1)
    return x0 * x0 + x1 * x1 + x2 * x2


def cross_dot(a: Tensor, b: Tensor) -> Tensor:
    """``(..., M, 3) x (..., N, 3) -> (..., M, N)`` dot products, as three
    elementwise products summed left to right."""
    a0, a1, a2 = (c[..., :, None] for c in a.unbind(-1))
    b0, b1, b2 = (c[..., None, :] for c in b.unbind(-1))
    return a0 * b0 + a1 * b1 + a2 * b2


def pairwise_sqdist(a: Tensor, b: Tensor, *, round_bf16: bool = False) -> Tensor:
    """Squared euclidean distances ``(..., M, N)`` between ``a (..., M, 3)``
    and ``b (..., N, 3)``, clamped at 0.

    ``round_bf16`` rounds each fp32 distance to bfloat16 (round to nearest
    even) before the clamp, the reference's ``compute_dtype=bfloat16`` mode
    used by the point->node assignment. The result is returned as fp32.
    """
    a = a.float()
    b = b.float()
    sq = sq_norm(a)[..., :, None] - 2.0 * cross_dot(a, b) + sq_norm(b)[..., None, :]
    if round_bf16:
        sq = sq.to(torch.bfloat16).float()
    return sq.clamp_min(0.0)


def knn(query: Tensor, database: Tensor, k: int):
    """k nearest neighbours of each query row: ``(sqdists, indices)``, each
    ``(..., M, k)``, ascending by distance, ties to the lowest index.

    ``torch.topk`` documents no tie order, so this takes the first k of a
    stable sort, which matches ``lax.top_k``'s lowest-index rule.
    """
    sq = pairwise_sqdist(query, database)
    vals, idx = torch.sort(sq, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def gather_points(points: Tensor, idx: Tensor) -> Tensor:
    """Rows of ``points (B, N, C)`` at ``idx (B, K)`` -> ``(B, K, C)``, or at
    ``idx (B, M, K)`` -> ``(B, M, K, C)``."""
    b = points.shape[0]
    batch = torch.arange(b, device=points.device).view(b, *([1] * (idx.dim() - 1)))
    return points[batch, idx.long()]
