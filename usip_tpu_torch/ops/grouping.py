"""Point -> node assignment and the ball query (port of
``usip_tpu/ops/grouping.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
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


def ball_scores(points: Tensor, centers: Tensor, radius: float,
                priority: Optional[Tensor] = None,
                round_bf16: bool = False) -> Tensor:
    """The ball query's selection scores ``(B, M, N)`` fp32: each point's
    priority where ``sqdist <= radius^2``, +inf outside the ball.

    Without ``priority`` it is the point's index (natural order, fp32
    distances). ``priority (B, N)`` holds random priorities, one per point
    shared by every ball of the cloud. ``round_bf16`` is usip_tpu's
    ``compute_dtype=bfloat16`` (which it applies to random priorities
    only): the fp32 distances rounded to bf16, then clamped at 0, compared
    with ``radius^2`` in bf16, and the priorities rounded to bf16 (which
    makes ties among them).
    """
    n = points.shape[1]
    sq = pairwise_sqdist(centers, points, round_bf16=round_bf16)
    if priority is None:
        priority = torch.arange(n, dtype=torch.float32, device=points.device)
    else:
        priority = priority.to(points.device, torch.float32)[:, None, :]
    if round_bf16:
        priority = priority.to(torch.bfloat16).float()
    return torch.where(sq <= _radius_sq(radius, round_bf16), priority,
                       torch.inf)


def _radius_sq(radius: float, round_bf16: bool) -> float:
    """``radius^2`` rounded to fp32 (and then to bf16, to nearest even,
    with ``round_bf16``), as a Python float: computed on the host, so that
    a traced program (``torch.export``) holds it as a constant."""
    bits = np.array([radius * radius], np.float32).view(np.uint32)
    if round_bf16:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return float(bits.astype(np.uint32).view(np.float32)[0])


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


def ball_priority_draws(b: int, n: int, *, generator: torch.Generator
                        ) -> Tensor:
    """``ball_query``'s random priorities ``(B, N)``, uniform in ``[0, 1)``,
    on the generator's device."""
    return torch.rand((b, n), generator=generator, device=generator.device)


def ball_query(points: Tensor, centers: Tensor, radius: float, k: int,
               priority: Optional[Tensor] = None, *,
               generator: Optional[torch.Generator] = None,
               method: str = "exact",
               round_bf16: bool = False) -> BallQueryResult:
    """For each center of ``centers (B, M, 3)``, the first k points of
    ``points (B, N, 3)`` within ``radius`` in priority order, cyclically
    padded (the reference's ball query over a permuted cloud).

    Priorities: ``priority (B, N)`` (random, e.g. JAX's
    ``jax.random.uniform(key, (B, N))`` in the tests), else uniform
    ``[0, 1)`` draws from ``generator``; with neither, natural order (the
    point's index, as the ball detector scans its cloud). ``round_bf16``
    applies to random priorities only (``ball_scores``), as in usip_tpu.

    ``method``: usip_tpu's ``'exact'``, ``'auto'`` and ``'approx'`` all
    select exactly here, on the smallest-k kernel, ties to the lowest index.
    usip_tpu's ``'approx'`` (and ``'auto'`` on random priorities at N >=
    4096) runs ``lax.approx_min_k``, a TPU partial reduction: it draws the
    same uniform in-ball subset under iid priorities, but not the same
    indices, and torch has no counterpart of it.
    """
    if method not in ("auto", "exact", "approx"):
        raise ValueError(f"unknown ball_query method {method!r}")
    if priority is None and generator is not None:
        priority = ball_priority_draws(*points.shape[:2], generator=generator)
    if priority is not None and tuple(priority.shape) != tuple(
            points.shape[:2]):
        raise ValueError(f"priority of shape {tuple(priority.shape)}, "
                         f"expected (B, N) = {tuple(points.shape[:2])}")
    return ball_select(ball_scores(
        points, centers, radius, priority,
        round_bf16=round_bf16 and priority is not None), k)
