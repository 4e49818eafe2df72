"""Pairwise-distance primitives (PyTorch port of ``usip_tpu/ops/geometry.py``).

Squared distances use the expansion ``|a|^2 - 2 a.b + |b|^2`` in that order,
clamped at 0, like the reference package. For points (3-wide rows) the three
coordinate products and their sums are separate elementwise ops (no matmul,
no fused multiply-add), so the CUDA kernels that reproduce them with
round-to-nearest intrinsics give bit-identical results. Wider rows (the
descriptors of the descriptor losses) take one fp32 matrix product, as
usip_tpu's einsum at HIGHEST precision does; the entry points turn TF32 off.
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
    """Squared euclidean distances ``(..., M, N)`` between ``a (..., M, D)``
    and ``b (..., N, D)``, clamped at 0: elementwise for points (D = 3),
    one fp32 matrix product for wider rows.

    ``round_bf16`` rounds each fp32 distance to bfloat16 (round to nearest
    even) before the clamp, the reference's ``compute_dtype=bfloat16`` mode
    used by the point->node assignment and the descriptor's ball query. The
    result is returned as fp32.
    """
    a = a.float()
    b = b.float()
    if a.shape[-1] == 3:
        sq = (sq_norm(a)[..., :, None] - 2.0 * cross_dot(a, b)
              + sq_norm(b)[..., None, :])
    else:
        sq = ((a * a).sum(-1)[..., :, None] - 2.0 * (a @ b.transpose(-1, -2))
              + (b * b).sum(-1)[..., None, :])
    if round_bf16:
        sq = sq.to(torch.bfloat16).float()
    return sq.clamp_min(0.0)


def knn(query: Tensor, database: Tensor, k: int):
    """k nearest neighbours of each query row: ``(sqdists, indices int32)``,
    each ``(..., M, k)``, ascending by distance, ties to the lowest index.

    The selection is ``ops.topk.smallest_k`` (the smallest-k kernel for CUDA
    tensors): ``torch.topk`` documents no tie order, and ``lax.top_k`` breaks
    ties toward the lowest index.
    """
    # imported here: ops.kernels imports this module
    from usip_tpu_torch.ops.topk import smallest_k
    return smallest_k(pairwise_sqdist(query, database), k)


def gather_points(points: Tensor, idx: Tensor) -> Tensor:
    """Rows of ``points (B, N, C)`` at ``idx (B, K)`` -> ``(B, K, C)``, or at
    ``idx (B, M, K)`` -> ``(B, M, K, C)``."""
    b = points.shape[0]
    batch = torch.arange(b, device=points.device).view(b, *([1] * (idx.dim() - 1)))
    return points[batch, idx.long()]


def safe_sqrt(x: Tensor, eps: float = 1e-12) -> Tensor:
    """``sqrt(max(x, eps))`` for ``x > 0`` and 0 for ``x <= 0``, with a zero
    (not NaN) gradient at 0: usip_tpu's ``safe_sqrt``."""
    is_zero = x <= 0.0
    masked = torch.where(is_zero, torch.ones_like(x), x)
    return torch.where(is_zero, torch.zeros_like(x),
                       torch.sqrt(torch.maximum(masked, x.new_tensor(eps))))


def pairwise_dist(a: Tensor, b: Tensor) -> Tensor:
    """Euclidean distances ``(..., M, N)``, with a zero gradient where a
    distance is 0 (``safe_sqrt``)."""
    return safe_sqrt(pairwise_sqdist(a, b))


class NearestNeighbor(torch.autograd.Function):
    """For each ``src (B, M, 3)`` row the euclidean distance to its nearest
    ``dst (B, N, 3)`` row and that row's index: ``((B, M), (B, M) int32)``.

    The forward is the min/argmin kernel (``kernels.min_argmin``, fp32, the
    first of equal minima) and a safe sqrt; the backward is usip_tpu's
    custom VJP (``ops/geometry.py`` ``_nearest_bwd``): the gradient of
    ``|s - d*|`` goes to the winning pair only, ``(s - d*) / |s - d*|`` (0
    at coincident points) to src and its negation, scattered, to dst. The
    ``(B, M, N)`` matrix is never built."""

    @staticmethod
    def forward(ctx, src: Tensor, dst: Tensor):
        # imported here: ops.kernels imports this module
        from usip_tpu_torch.ops import kernels
        sq, idx = kernels.min_argmin(src.float().contiguous(),
                                     dst.float().contiguous())
        dist = safe_sqrt(sq)
        ctx.save_for_backward(src, dst, dist, idx)
        ctx.mark_non_differentiable(idx)
        return dist, idx

    @staticmethod
    def backward(ctx, g_dist, _g_idx):
        src, dst, dist, idx = ctx.saved_tensors
        diff = src.float() - gather_points(dst.float(), idx)
        pos = (dist > 0)[..., None]
        denom = torch.where(pos, dist[..., None], torch.ones_like(diff))
        direction = torch.where(pos, diff / denom, torch.zeros_like(diff))
        g_src = g_dist[..., None] * direction
        g_dst = torch.zeros(dst.shape, dtype=g_src.dtype, device=dst.device)
        g_dst.scatter_add_(1, idx.long()[..., None].expand(-1, -1, 3), -g_src)
        return g_src.to(src.dtype), g_dst.to(dst.dtype)


def nearest_neighbor(src: Tensor, dst: Tensor):
    """``(distance (B, M), index (B, M) int32)`` of each src row's nearest
    dst row; differentiable in the distance (``NearestNeighbor``)."""
    return NearestNeighbor.apply(src, dst)


def apply_se3(points: Tensor, R: Tensor, scale: Tensor, shift: Tensor
              ) -> Tensor:
    """The GT transform ``p -> (R @ p) * scale + shift`` batch-wise:
    ``points (B, N, 3)``, ``R (B, 3, 3)``, ``scale (B,)`` or ``(B, 1)``,
    ``shift (B, 3)`` or ``(B, 3, 1)``."""
    scale = scale.reshape(scale.shape[0], 1, 1)
    shift = shift.reshape(shift.shape[0], 1, 3)
    return rotate(points, R) * scale + shift


def rotate(points: Tensor, R: Tensor) -> Tensor:
    """``(R @ p)`` for every row of ``points (B, N, 3)``, ``R (B, 3, 3)``:
    each coordinate three products summed left to right, elementwise (no
    matmul, so no TF32 on the card)."""
    x, y, z = (c[:, :, None] for c in points.unbind(-1))
    r = R[:, None, :, :]                                   # (B, 1, 3, 3)
    return x * r[..., 0] + y * r[..., 1] + z * r[..., 2]
