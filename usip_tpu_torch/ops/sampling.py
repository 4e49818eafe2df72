"""Point sampling: random subsets and farthest point sampling (port of
``usip_tpu/ops/sampling.py``).

The random draws are optional inputs: the subset indices ``(B, sub)`` and the
FPS seed rows ``first``. When they are absent they are drawn from the given
``torch.Generator`` (on the generator's device); tests pass in the reference
package's own draws instead, since JAX keys and torch generators never agree.
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


def _draw_first(b: int, n: int, generator: Optional[torch.Generator],
                device: torch.device) -> Tensor:
    if generator is None:
        raise ValueError("pass the seed rows `first` or a torch.Generator")
    first = torch.randint(0, n, (b,), generator=generator,
                          device=generator.device)
    return first.to(device=device, dtype=torch.int32)


def farthest_point_sampling(points: Tensor, k: int, parallel: int = 1, *,
                            first: Optional[Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[Tensor, Tensor]:
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
        if first is None:
            first = _draw_first(b * parallel, nc, generator, points.device)
        idx = kernels.fps(chunks, first.to(points.device, torch.int32)
                          .contiguous(), kc)
        offs = (torch.arange(b * parallel, device=points.device,
                             dtype=torch.int32) % parallel) * nc
        idx = (idx + offs[:, None]).reshape(b, k)
    else:
        if first is None:
            first = _draw_first(b, n, generator, points.device)
        idx = kernels.fps(points.float().contiguous(),
                          first.to(points.device, torch.int32).contiguous(),
                          k)
    return gather_points(points, idx), idx


def _subset_rows(b: int, n: int, k: int, generator: torch.Generator
                 ) -> Tensor:
    """k distinct random rows of ``[0, n)`` for each of ``b`` clouds, in
    random order ``(B, k)``, on the generator's device."""
    keys = torch.rand((b, n), generator=generator, device=generator.device)
    return keys.argsort(dim=1)[:, :k]


def random_subset(points: Tensor, k: int, *, idx: Optional[Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> Tensor:
    """k distinct random rows of each batch element, in random order:
    ``points (B, N, C)`` -> ``(B, k, C)``. ``idx (B, k)`` (on any device)
    gives the rows."""
    if idx is None:
        if generator is None:
            raise ValueError("pass the subset indices `idx` or a "
                             "torch.Generator")
        b, n, _ = points.shape
        idx = _subset_rows(b, n, k, generator)
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
    sub, parallel = _node_shapes(n, node_num, subsample_ratio, parallel)
    subset = _subset_rows(b, n, sub, generator)
    first = _draw_first(b * parallel, sub // parallel, generator,
                        generator.device)
    return subset, first


def sample_nodes(points: Tensor, node_num: int, subsample_ratio: int = 4,
                 parallel: int = 1, *, subset_idx: Optional[Tensor] = None,
                 first: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
    """Nodes ``(B, node_num, 3)``: FPS over a random subset of
    ``max(node_num, N // subsample_ratio)`` rows. The subset's rows are in
    random order, so ``parallel`` bucketing is a random partition; it falls
    back to exact FPS when the factor does not divide the shapes. Draws
    not given come from ``generator`` (``node_draws``)."""
    b, n = points.shape[:2]
    if subset_idx is None and first is None and generator is not None:
        subset_idx, first = node_draws(b, n, node_num, subsample_ratio,
                                       parallel, generator=generator)
    sub, parallel = _node_shapes(n, node_num, subsample_ratio, parallel)
    subset = random_subset(points, sub, idx=subset_idx, generator=generator)
    nodes, _ = farthest_point_sampling(subset, node_num, parallel, first=first,
                                       generator=generator)
    return nodes
