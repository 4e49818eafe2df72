"""Point sampling: random subsets and farthest point sampling (port of
``usip_tpu/ops/sampling.py``).

The random draws are inputs: the subset indices ``(B, sub)`` and the FPS seed
rows ``first``. ``sample_nodes`` draws both from a ``torch.Generator`` (on the
generator's device, ``node_draws``) where neither is given; tests pass in the
reference package's own draws instead, since JAX keys and torch generators
never agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from usip_tpu_torch.ops import kernels
from usip_tpu_torch.ops.geometry import gather_points

Tensor = torch.Tensor


def _fps_single(points: Tensor, k: int, first: Tensor) -> Tuple[Tensor, Tensor]:
    """FPS on one cloud ``(N, 3)`` from seed row ``first`` -> ``(k, 3)``
    samples and ``(k,)`` int32 indices: the plain reference loop."""
    idx = kernels.fps_plain(points[None], first.reshape(1), k)[0]
    return points[idx.long()], idx


def farthest_point_sampling(points: Tensor, k: int, parallel: int = 1, *,
                            first: Tensor) -> Tuple[Tensor, Tensor]:
    """Batched FPS: ``points (B, N, 3)`` -> samples ``(B, k, 3)``, indices
    ``(B, k)`` int32.

    ``parallel=t > 1`` runs t independent FPS instances over t contiguous
    row-buckets (``B * t`` clouds of ``N / t`` rows, ``k / t`` picks each) and
    concatenates their picks, offset back into the whole cloud. ``first``
    holds the seed row of each instance (``(B * t,)``, bucket-local, on any
    device).
    """
    b, n, _ = points.shape
    if parallel > 1:
        if n % parallel or k % parallel:
            raise ValueError(f"parallel={parallel} must divide N={n} and k={k}")
        nc, kc = n // parallel, k // parallel
        chunks = points.float().reshape(b * parallel, nc, 3).contiguous()
        idx = kernels.fps(chunks, first.to(points.device, torch.int32)
                          .contiguous(), kc)
        offs = (torch.arange(b * parallel, device=points.device,
                             dtype=torch.int32) % parallel) * nc
        idx = (idx + offs[:, None]).reshape(b, k)
    else:
        idx = kernels.fps(points.float().contiguous(),
                          first.to(points.device, torch.int32).contiguous(),
                          k)
    return gather_points(points, idx), idx


def random_subset(points: Tensor, k: int, *, idx: Tensor) -> Tensor:
    """k distinct random rows of each batch element, in random order:
    ``points (B, N, C)`` -> ``(B, k, C)``. ``idx (B, k)`` (on any device)
    gives the rows."""
    return gather_points(points, idx.to(points.device))


def _node_shapes(n: int, node_num: int, subsample_ratio: int,
                 parallel: int) -> Tuple[int, int]:
    """``sample_nodes``' subset size and FPS bucket count (1 where
    ``parallel`` does not divide the shapes)."""
    sub = max(node_num, n // subsample_ratio)
    if parallel > 1 and (sub % parallel or node_num % parallel):
        parallel = 1
    return sub, parallel


def node_draws(b: int, n: int, node_num: int, subsample_ratio: int = 4,
               parallel: int = 1, *, generator: torch.Generator
               ) -> Tuple[Tensor, Tensor]:
    """The draws of ``sample_nodes`` for ``b`` clouds of ``n`` points, in
    its order, on the generator's device: the subset rows ``(B, sub)``,
    then the FPS seed rows ``(B * parallel,)`` int32."""
    _, parallel = _node_shapes(n, node_num, subsample_ratio, parallel)
    dev = generator.device
    keys = torch.empty((b, n), device=dev)
    first = torch.empty((b * parallel,), dtype=torch.int64, device=dev)
    draw_node_uniforms(keys, first, node_num, subsample_ratio, parallel,
                       generator=generator)
    return draws_from_uniforms(keys, first, node_num, subsample_ratio,
                               parallel)


def draw_node_uniforms(keys: Tensor, first: Tensor, node_num: int,
                       subsample_ratio: int = 4, parallel: int = 1, *,
                       generator: torch.Generator) -> None:
    """The random numbers of ``node_draws``, written in place, in its
    order: the subset's sort keys ``keys (B, N)`` (``torch.rand``'s
    uniforms) and the FPS seed rows ``first (B * parallel,)`` int64
    (``torch.randint``'s). ``torch.rand`` and ``torch.randint`` are these
    fills of a new tensor, so they take the same numbers from
    ``generator``."""
    sub, parallel = _node_shapes(keys.shape[1], node_num, subsample_ratio,
                                 parallel)
    keys.uniform_(generator=generator)
    first.random_(0, sub // parallel, generator=generator)


def node_uniform_buffers(b: int, n: int, node_num: int,
                         subsample_ratio: int = 4, parallel: int = 1, *,
                         device) -> Tuple[Tensor, Tensor]:
    """Zeroed tensors for ``draw_node_uniforms``' numbers over ``b`` clouds
    of ``n`` points: the sort keys ``(B, N)`` and the FPS seed rows
    ``(B * parallel,)`` int64; zeros are valid draws, so a graph may be
    captured on them."""
    _, parallel = _node_shapes(n, node_num, subsample_ratio, parallel)
    return (torch.zeros((b, n), device=device),
            torch.zeros((b * parallel,), dtype=torch.int64, device=device))


def draws_from_uniforms(keys: Tensor, first: Tensor, node_num: int,
                        subsample_ratio: int = 4, parallel: int = 1
                        ) -> Tuple[Tensor, Tensor]:
    """``node_draws``' subset rows ``(B, sub)`` and int32 FPS seed rows
    from ``draw_node_uniforms``' numbers: the first ``sub`` rows of the
    keys' ascending order."""
    sub, _ = _node_shapes(keys.shape[1], node_num, subsample_ratio, parallel)
    return keys.argsort(dim=1)[:, :sub], first.int()


def sample_nodes(points: Tensor, node_num: int, subsample_ratio: int = 4,
                 parallel: int = 1, *, subset_idx: Optional[Tensor] = None,
                 first: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
    """Nodes ``(B, node_num, 3)``: FPS over a random subset of
    ``max(node_num, N // subsample_ratio)`` rows. The subset's rows are in
    random order, so ``parallel`` bucketing is a random partition; it falls
    back to exact FPS when the factor does not divide the shapes. Where
    neither draw is given, both come from ``generator`` (``node_draws``)."""
    b, n = points.shape[:2]
    if subset_idx is None and first is None and generator is not None:
        subset_idx, first = node_draws(b, n, node_num, subsample_ratio,
                                       parallel, generator=generator)
    if subset_idx is None or first is None:
        raise ValueError("pass both draws `subset_idx` and `first`, or "
                         "neither and a torch.Generator")
    sub, parallel = _node_shapes(n, node_num, subsample_ratio, parallel)
    subset = random_subset(points, sub, idx=subset_idx)
    nodes, _ = farthest_point_sampling(subset, node_num, parallel, first=first)
    return nodes
