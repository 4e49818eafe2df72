"""The detector's training losses (port of ``usip_tpu/losses.py``),
channels-last.

* ``chamfer_probabilistic``: the probabilistic chamfer between two keypoint
  sets with per-pair averaged sigmas, plus its ``chamfer_pure`` and
  ``chamfer_weighted`` diagnostics (the reference's models/losses.py:44-99);
* ``single_side_chamfer`` / ``point_on_surface``: keypoints must lie on the
  cloud (models/losses.py:102-183).

Every nearest-neighbour search is ``ops.geometry.nearest_neighbor``, the
min/argmin kernel on CUDA tensors with a backward that never builds the
``(B, M, N)`` distance matrix.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from usip_tpu_torch.ops.geometry import (gather_points, nearest_neighbor,
                                         safe_sqrt)

Tensor = torch.Tensor


class ChamferOutput(NamedTuple):
    loss: Tensor              # scalar: the objective
    chamfer_pure: Tensor      # scalar: plain chamfer, detached
    chamfer_weighted: Tensor  # scalar: inverse-sigma weighted chamfer, detached


def chamfer_probabilistic(src: Tensor, dst: Tensor,
                          sigma_src: Optional[Tensor] = None,
                          sigma_dst: Optional[Tensor] = None
                          ) -> ChamferOutput:
    """Probabilistic chamfer between ``src (B, M, 3)`` (already in the dst
    frame) and ``dst (B, N, 3)`` with uncertainties ``sigma_src (B, M)`` and
    ``sigma_dst (B, N)``: for each matched pair ``s = (sigma_a + sigma_b) /
    2``, the mean of ``log(s) + d / s`` in both directions. Without sigmas,
    the plain chamfer (the sum of both directions' mean distances)."""
    fwd_min, fwd_idx = nearest_neighbor(src, dst)              # (B, M)
    bwd_min, bwd_idx = nearest_neighbor(dst, src)              # (B, N)
    if sigma_src is None or sigma_dst is None:
        loss = fwd_min.mean() + bwd_min.mean()
        return ChamferOutput(loss, loss.detach(), loss.detach())

    sigma_fwd = (sigma_src + sigma_dst.gather(1, fwd_idx.long())) / 2.0
    forward_loss = (torch.log(sigma_fwd) + fwd_min / sigma_fwd).mean()
    sigma_bwd = (sigma_dst + sigma_src.gather(1, bwd_idx.long())) / 2.0
    backward_loss = (torch.log(sigma_bwd) + bwd_min / sigma_bwd).mean()

    with torch.no_grad():
        chamfer_pure = fwd_min.mean() + bwd_min.mean()
        w_fwd = (1.0 / sigma_fwd) / (1.0 / sigma_fwd).mean()
        w_bwd = (1.0 / sigma_bwd) / (1.0 / sigma_bwd).mean()
        chamfer_weighted = ((w_fwd * fwd_min).mean()
                            + (w_bwd * bwd_min).mean())
    return ChamferOutput(forward_loss + backward_loss, chamfer_pure,
                         chamfer_weighted)


def single_side_chamfer(keypoints: Tensor, pc: Tensor) -> Tensor:
    """Each keypoint's distance to its nearest cloud point, ``(B, M)``."""
    return nearest_neighbor(keypoints, pc)[0]


def point_on_surface(keypoints: Tensor, pc: Tensor, sn: Tensor) -> Tensor:
    """Squared cosine between ``keypoint - nearest point`` and that point's
    surface normal ``sn[..., :3]``, ``(B, M)``; the search itself carries no
    gradient."""
    _, idx = nearest_neighbor(keypoints.detach(), pc)
    v = keypoints - gather_points(pc, idx)
    n = gather_points(sn[..., 0:3], idx)
    v_unit = v / (safe_sqrt((v * v).sum(-1, keepdim=True)) + 1e-7)
    cos = (n * v_unit).sum(-1)
    return cos * cos


def keypoint_on_pc(keypoints: Tensor, pc: Tensor,
                   sn: Optional[Tensor] = None) -> Tensor:
    """``single_side_chamfer`` without normals, ``point_on_surface`` with
    them (the reference's KeypointOnPCLoss)."""
    if sn is None:
        return single_side_chamfer(keypoints, pc)
    return point_on_surface(keypoints, pc, sn)
