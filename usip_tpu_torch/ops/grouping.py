"""Point -> node assignment (port of ``usip_tpu/ops/grouping.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from usip_tpu_torch.ops import kernels
from usip_tpu_torch.ops.geometry import pairwise_sqdist

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
    ``(B, N, M)`` matrix. k>1 is plain: a stable sort of the distances, first
    k, ties to the lowest node index. ``round_bf16`` rounds the distances to
    bf16 before the compare, the reference's ``compute_dtype=bfloat16``.
    """
    b, n, _ = points.shape
    m = nodes.shape[1]
    if k == 1:
        _, ids = kernels.min_argmin(points.float().contiguous(),
                                    nodes.float().contiguous(), round_bf16)
        ids = ids.long()
    else:
        sq = pairwise_sqdist(points, nodes, round_bf16=round_bf16)
        idx = torch.sort(sq, dim=-1, stable=True).indices[..., :k]  # (B, N, k)
        ids = idx.transpose(1, 2).reshape(b, k * n)
    counts = torch.zeros((b, m), dtype=torch.float32, device=points.device)
    counts.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float32))
    return NodeAssignment(ids=ids, occupancy=(counts > 0).float(),
                          counts=counts)
