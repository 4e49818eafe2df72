"""Scatter/segment reductions onto nodes (port of ``usip_tpu/ops/segment.py``).

The masked scatter-max is the scatter-max kernel (``ops.kernels.scatter_max``,
the counterpart of ``scripts/bench_scatter_pallas.py scatter_max_pallas``) for
CUDA tensors; the sums and gathers are plain PyTorch
(``scatter_add``/gather).
"""

from __future__ import annotations

from typing import Tuple

import torch

from usip_tpu_torch.ops import kernels

Tensor = torch.Tensor


def _expand(ids: Tensor, c: int) -> Tensor:
    return ids[..., None].expand(*ids.shape, c)


def masked_scatter_max(f: Tensor, ids: Tensor, num_segments: int) -> Tensor:
    """Per-node channel max of point features, the ``fast`` semantics:
    ``f (B, N, C)``, ``ids (B, N)`` int64 -> ``(B, M, C)``; empty nodes are
    0. Forward only."""
    return kernels.scatter_max(f, ids, num_segments)


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
