"""Point -> node assignment and the ball query (port of
``usip_tpu/ops/grouping.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from usip_tpu_torch.ops import kernels
from usip_tpu_torch.ops.geometry import pairwise_sqdist
from usip_tpu_torch.ops.topk import smallest_k

Tensor = torch.Tensor


class NodeAssignment(NamedTuple):
    """Result of point->node association (``som.query_topk`` semantics).

    Attributes:
      ids: ``(B, kN)`` int64 node index of each stacked point, k-major (all
        points' nearest node, then all points' second nearest, ...).
      occupancy: ``(B, M)`` float 0/1, whether any point maps to the node.
      counts: ``(B, M)`` float, points per node.
    """

    ids: Tensor
    occupancy: Tensor
    counts: Tensor


def assign_points_to_nodes(points: Tensor, nodes: Tensor, k: int = 1,
                           round_bf16: bool = False) -> NodeAssignment:
    """Each point's k nearest nodes (k-major flattened), plus occupancy.

    k=1 goes through the min/argmin kernel, which never builds the
    ``(B, N, M)`` matrix. k>1 selects the k nearest from the matrix with
    ``smallest_k``, ties to the lowest node index. ``round_bf16`` rounds the
    distances to bf16 before the compare, the reference's
    ``compute_dtype=bfloat16``.
    """
    b, n, _ = points.shape
    m = nodes.shape[1]
    if k == 1:
        _, ids = kernels.min_argmin(points.float().contiguous(),
                                    nodes.float().contiguous(), round_bf16)
        ids = ids.long()
    else:
        sq = pairwise_sqdist(points, nodes, round_bf16=round_bf16)
        idx = smallest_k(sq, k)[1].long()                      # (B, N, k)
        ids = idx.transpose(1, 2).reshape(b, k * n)
    counts = torch.zeros((b, m), dtype=torch.float32, device=points.device)
    counts.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float32))
    return NodeAssignment(ids=ids, occupancy=(counts > 0).float(),
                          counts=counts)


class BallQueryResult(NamedTuple):
    """Fixed-shape ball query.

    Attributes:
      idx: ``(B, M, K)`` int32 point indices; the in-radius points in
        priority order, cyclically padded when fewer than K are in the ball,
        all 0 when the ball is empty.
      valid: ``(B, M, K)`` bool, True for genuine (not padded) neighbours.
      counts: ``(B, M)`` int32, in-radius points found (at most K).
    """

    idx: Tensor
    valid: Tensor
    counts: Tensor


def ball_scores(points: Tensor, centers: Tensor, radius: float) -> Tensor:
    """The ball query's selection scores ``(B, M, N)`` fp32: each point's
    natural-order priority (its index) where ``sqdist <= radius^2``, +inf
    outside the ball."""
    n = points.shape[1]
    sq = pairwise_sqdist(centers, points)
    priority = torch.arange(n, dtype=torch.float32, device=points.device)
    return torch.where(sq <= radius * radius, priority, torch.inf)


def ball_select(scores: Tensor, k: int) -> BallQueryResult:
    """The first k in-ball points of each ball by priority (``smallest_k``,
    ties to the lowest index), cyclically padded: slot j past the count
    reuses slot ``j % count``; an empty ball gives index 0."""
    vals, idx = smallest_k(scores, k)
    found = torch.isfinite(vals)
    counts = found.sum(dim=-1, dtype=torch.int32)
    slot = torch.arange(k, dtype=torch.int32, device=scores.device)
    wrapped = torch.where(found, slot, slot % counts.clamp_min(1)[..., None])
    idx = torch.gather(idx, -1, wrapped.long())
    idx = torch.where(counts[..., None] > 0, idx, 0).int()
    return BallQueryResult(idx=idx, valid=found, counts=counts)


def ball_query(points: Tensor, centers: Tensor, radius: float, k: int,
               key=None, method: str = "exact") -> BallQueryResult:
    """Exact ball query with natural-order priorities: for each center of
    ``centers (B, M, 3)``, the first k points of ``points (B, N, 3)`` (in
    index order) within ``radius``, fp32 distances. The reference's ball
    query scanning an unpermuted cloud, as the ball detector runs it.

    ``key`` (random priorities) and ``method='approx'``, the descriptor's
    selection through ``lax.approx_min_k``, have no counterpart here: torch
    has no analog of ``lax.approx_min_k``, and both raise.
    """
    if key is not None:
        raise NotImplementedError(
            "ball_query with random priorities (a key) is the descriptor's "
            "and is not ported; pass key=None for natural-order priorities")
    if method == "approx":
        raise NotImplementedError(
            "ball_query(method='approx') selects with lax.approx_min_k, "
            "which has no torch analog; use method='exact'")
    if method not in ("auto", "exact"):
        raise ValueError(f"unknown ball_query method {method!r}")
    return ball_select(ball_scores(points, centers, radius), k)
