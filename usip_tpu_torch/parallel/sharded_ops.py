"""Point-sharded distance reductions (counterpart of
``usip_tpu/parallel/sharded_ops.py``): the cloud's N axis cut over the ranks
of a ``points`` mesh.

Each rank holds its shard of the sharded inputs (``shard_points`` cuts a
whole tensor) and the replicated inputs whole; it computes against its
shard and reduces locally, and the ranks combine the tiny per-shard
results: a two-stage min with a global argmin, and a per-shard smallest-k
(the K4 kernel on CUDA tensors) merged into the global selection. The
outputs are replicated. Gradients follow ``parallel/collectives.py``'s rule
(a loss computed from the replicated outputs is the same on every rank).

A rank's shard of N starts at ``rank * N / R``: the merged indices are
global, ties ordered by global index as the one-device selection orders
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from usip_tpu_torch import losses as L
from usip_tpu_torch.ops.geometry import nearest_neighbor, pairwise_sqdist
from usip_tpu_torch.ops.grouping import ball_scores
from usip_tpu_torch.ops.topk import smallest_k
from usip_tpu_torch.parallel.collectives import (all_gather, all_gather_stack,
                                                 psum, pvary)
from usip_tpu_torch.parallel.mesh import Mesh, make_mesh

Tensor = torch.Tensor

def make_point_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The 1-D ``points`` mesh over every rank."""
    return make_mesh(num_devices, device)


def shard_points(mesh: Mesh, x: Tensor, dim: int = 1) -> Tensor:
    """This rank's shard of ``x`` along ``dim`` (the point axis); the size
    must divide by the ranks."""
    n = x.shape[dim]
    if n % mesh.size:
        raise ValueError(f"point count {n} does not split over {mesh.size} "
                         "ranks")
    w = n // mesh.size
    return x.narrow(dim, mesh.rank * w, w)


def _offset(mesh: Mesh, n_local: int) -> int:
    return mesh.rank * n_local


def _two_stage_min(local_min: Tensor, local_idx: Tensor, mesh: Mesh
                   ) -> Tuple[Tensor, Tensor]:
    """Every shard's ``(min, global argmin)`` gathered ``(S, ...)``, the
    winner picked (the first shard among equal minima, i.e. the lowest
    global index); replicated."""
    mins = all_gather_stack(local_min, mesh)
    idxs = all_gather_stack(local_idx, mesh)
    best = mins.argmin(dim=0, keepdim=True)
    return (mins.gather(0, best)[0], idxs.gather(0, best)[0])


def sharded_min_dist(src: Tensor, dst_shard: Tensor, mesh: Mesh
                     ) -> Tuple[Tensor, Tensor]:
    """Distance from each replicated ``src (B, M, 3)`` row to the sharded
    ``dst`` cloud, and its global argmin: ``((B, M), (B, M) int64)``,
    replicated. The local part is ``nearest_neighbor`` (the min/argmin
    kernel on CUDA tensors)."""
    d, idx = nearest_neighbor(pvary(src, mesh), dst_shard)
    idx = idx.long() + _offset(mesh, dst_shard.shape[1])
    return _two_stage_min(d, idx, mesh)


def sharded_chamfer_probabilistic(mesh: Mesh, src: Tensor, dst: Tensor,
                                  sigma_src: Tensor, sigma_dst: Tensor
                                  ) -> L.ChamferOutput:
    """``losses.chamfer_probabilistic`` with both keypoint sets sharded on
    their point axes (``src``/``sigma_src`` this rank's shard of M rows,
    ``dst``/``sigma_dst`` of N): each rank matches its rows against the
    gathered other set, the sums are all-reduced. Replicated; equal to the
    one-device loss up to reduction order."""
    b = src.shape[0]
    m, n = src.shape[1] * mesh.size, dst.shape[1] * mesh.size
    # the other set whole on every rank, used by this rank's rows
    dst_full = pvary(all_gather(dst, mesh, 1), mesh)
    dsig_full = pvary(all_gather(sigma_dst, mesh, 1), mesh)
    src_full = pvary(all_gather(src, mesh, 1), mesh)
    ssig_full = pvary(all_gather(sigma_src, mesh, 1), mesh)

    fmin, fidx = nearest_neighbor(src, dst_full)
    sig_f = (sigma_src + dsig_full.gather(1, fidx.long())) / 2.0
    fwd = psum((torch.log(sig_f) + fmin / sig_f).sum(), mesh) / (b * m)
    bmin, bidx = nearest_neighbor(dst, src_full)
    sig_b = (sigma_dst + ssig_full.gather(1, bidx.long())) / 2.0
    bwd = psum((torch.log(sig_b) + bmin / sig_b).sum(), mesh) / (b * n)

    with torch.no_grad():
        def mean(x, count):
            return psum(x.sum(), mesh) / count
        pure = mean(fmin, b * m) + mean(bmin, b * n)
        w_f = (1.0 / sig_f) / mean(1.0 / sig_f, b * m)
        w_b = (1.0 / sig_b) / mean(1.0 / sig_b, b * n)
        weighted = mean(w_f * fmin, b * m) + mean(w_b * bmin, b * n)
    return L.ChamferOutput(fwd + bwd, pure, weighted)


def sharded_single_side_chamfer(mesh: Mesh, keypoints: Tensor,
                                pc_shard: Tensor) -> Tensor:
    """Each replicated keypoint's distance to the sharded cloud, ``(B, M)``,
    replicated (the on-cloud loss for clouds beyond one card). On a 2-D
    ``data x points`` grid ``keypoints`` and ``pc_shard`` hold this rank's
    batch rows. The cross-shard min gathers the ``(S, B, M)`` candidates
    (differentiable, as usip_tpu's)."""
    d, _ = nearest_neighbor(pvary(keypoints, mesh), pc_shard)
    return all_gather_stack(d, mesh).amin(dim=0)


def _merge_smallest(mesh: Mesh, vals: Tensor, k: int
                    ) -> Tuple[Tensor, Tensor]:
    """Per-shard smallest-k ``(B, M, k)`` values, gathered along the last
    axis in rank order and re-selected: the global k smallest, ties to the
    lowest global index (a shard's candidates come in index order among
    ties, and the shards in index order). Returns the values and the
    positions into the gathered candidates."""
    all_v = all_gather(vals, mesh, -1)
    sel_v, sel = smallest_k(all_v, k)
    return sel_v, sel.long()


def _take(x: Tensor, sel: Tensor) -> Tensor:
    """``x (B, M, S*k, ...)`` at the positions ``sel (B, M, k)``."""
    shape = sel.shape + x.shape[3:]
    index = sel.reshape(*sel.shape, *([1] * (x.dim() - 3))).expand(shape)
    return x.gather(2, index)


def sharded_knn_gather(mesh: Mesh, query: Tensor, database: Tensor,
                       features: Tensor, k: int,
                       return_indices: bool = False):
    """kNN of the replicated ``query (B, M, 3)`` rows in the sharded
    ``database (B, n, 3)`` and the gather of the sharded ``features (B, n,
    C)``: each shard's k nearest (smallest-k), merged. Returns ``(sqdists
    (B, M, k), features (B, M, k, C))`` and, with ``return_indices``, the
    global indices ``(B, M, k)`` int64; replicated."""
    sq = pairwise_sqdist(pvary(query, mesh), database)
    d_loc, idx = smallest_k(sq, k)
    idx = idx.long()
    cand_f = _take(features[:, None].expand(-1, sq.shape[1], -1, -1), idx)
    gidx = idx + _offset(mesh, database.shape[1])
    d, sel = _merge_smallest(mesh, d_loc, k)
    feats = _take(all_gather(cand_f, mesh, 2), sel)
    if not return_indices:
        return d, feats
    return d, feats, _take(all_gather(gidx, mesh, -1)[..., None], sel)[..., 0]


def sharded_ball_gather(mesh: Mesh, centers: Tensor, points: Tensor,
                        features: Tensor, radius: float, k: int,
                        priority: Tensor, return_indices: bool = False):
    """The random-priority ball query and feature gather with the cloud
    sharded on N (``points (B, n, 3)``, ``features (B, n, C)``, ``priority
    (B, n)`` this rank's shards; ``centers (B, M, 3)`` replicated). Each
    shard selects its k lowest-priority in-ball points (smallest-k), the
    candidates are gathered and re-selected: the global k lowest, exactly
    the one-device selection. Returns ``(feats (B, M, k, C), found (B, M,
    k), counts (B, M))`` (and the global indices ``(B, M, k)`` with
    ``return_indices``), replicated, with the one-device op's cyclic
    padding; an empty ball's features are 0 (usip_tpu's deliberate
    deviation: the one-device op gathers point 0)."""
    scores = ball_scores(points, centers, radius, priority)
    kk = min(k, scores.shape[-1])
    s_loc, idx = smallest_k(scores, kk)
    idx = idx.long()
    cand_f = _take(features[:, None].expand(-1, scores.shape[1], -1, -1),
                   idx)
    gidx = idx + _offset(mesh, points.shape[1])
    s, sel = _merge_smallest(mesh, s_loc, k)
    found = torch.isfinite(s)
    counts = found.sum(dim=-1, dtype=torch.int32)
    slot = torch.arange(k, device=s.device)
    sel = sel.gather(-1, torch.where(found, slot, slot % counts.clamp_min(
        1)[..., None]).long())
    feats = _take(all_gather(cand_f, mesh, 2), sel)
    feats = torch.where(counts[..., None, None] > 0, feats,
                        torch.zeros_like(feats))
    if not return_indices:
        return feats, found, counts
    gsel = _take(all_gather(gidx, mesh, -1)[..., None], sel)[..., 0]
    return feats, found, counts, gsel
