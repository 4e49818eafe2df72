"""Scatter/segment reductions onto nodes (port of ``usip_tpu/ops/segment.py``).

The reference package has no Pallas kernel here; these are plain PyTorch
scatters (``scatter_reduce``/``scatter_add``/gather).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor


def _expand(ids: Tensor, c: int) -> Tensor:
    return ids[..., None].expand(*ids.shape, c)


def masked_scatter_max(f: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Per-node channel max of point features, the ``fast`` semantics:
    ``f (B, N, C)``, ``ids (B, N)`` -> ``(B, M, C)``; empty nodes are 0."""
    b, _, c = f.shape
    out = torch.zeros((b, num_segments, c), dtype=f.dtype, device=f.device)
    return out.scatter_reduce(1, _expand(ids, c), f, "amax",
                              include_self=False)


def segment_mean_count(x: Tensor, ids: Tensor, num_segments: int,
                       eps: float = 1e-5) -> Tuple[Tensor, Tensor]:
    """Per-node mean of ``x (B, N, D)`` and the count of points:
    ``sums / (counts + eps)``, ``counts`` -> ``(B, M, D)``, ``(B, M)``."""
    b, _, d = x.shape
    sums = torch.zeros((b, num_segments, d), dtype=x.dtype, device=x.device)
    sums.scatter_add_(1, _expand(ids, d), x)
    counts = torch.zeros((b, num_segments), dtype=x.dtype, device=x.device)
    counts.scatter_add_(1, ids, torch.ones_like(ids, dtype=x.dtype))
    return sums / (counts[..., None] + eps), counts


def scatter_back(node_features: Tensor, ids: Tensor) -> Tensor:
    """Each point's node feature: ``out[b, n] = nf[b, ids[b, n]]``."""
    return torch.gather(node_features, 1,
                        _expand(ids, node_features.shape[-1]))
