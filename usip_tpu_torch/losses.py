"""The training losses (port of ``usip_tpu/losses.py``), channels-last.

The detector's:

* ``chamfer_probabilistic``: the probabilistic chamfer between two keypoint
  sets with per-pair averaged sigmas, plus its ``chamfer_pure`` and
  ``chamfer_weighted`` diagnostics (the reference's models/losses.py:44-99);
* ``single_side_chamfer`` / ``point_on_surface``: keypoints must lie on the
  cloud (models/losses.py:102-183).

Every nearest-neighbour search there is ``ops.geometry.nearest_neighbor``,
the min/argmin kernel on CUDA tensors with a backward that never builds the
``(B, M, N)`` distance matrix.

The descriptor's (models/losses.py:190-369): the scan triplet
``desc_pair_scan_loss``, the keypoint-level CGF triplet ``desc_cgf_loss``
(its random draws an input, ``CGFDraws``, or drawn from a generator), and
the 1-NN ``descriptor_matching_accuracy``. Their minima are ``amin``, which
splits the gradient among ties as ``jnp.min`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from usip_tpu_torch.ops.geometry import (gather_points, nearest_neighbor,
                                         pairwise_dist, safe_sqrt)

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


# ------------------------------------------------------------ descriptor ----

def _sigma_weights(sigmas: Tensor, sigma_max: float) -> Tensor:
    """``clamp(sigma_max - sigma)`` normalised to mean 1 over the keypoints,
    detached (losses.py:231-234), guarded against an all-clamped batch."""
    w = (sigma_max - sigmas).clamp_min(0.0)
    w = w / w.mean(dim=1, keepdim=True).clamp_min(1e-8)
    return w.detach()


def desc_pair_scan_loss(anc_desc: Tensor, pos_desc: Tensor,
                        neg_desc: Tensor, anc_sigmas: Tensor, *,
                        gamma: float, sigma_max: float
                        ) -> Tuple[Tensor, Tensor]:
    """Scan-level triplet on the smallest descriptor distances
    (losses.py:190-237): descriptors ``(B, M, C)``, unit length;
    ``anc_sigmas (B, M)``. Returns the sigma-weighted loss per keypoint
    ``(B, M)`` and the share of active triplets ``(B,)``."""
    min_pos = pairwise_dist(anc_desc, pos_desc).amin(dim=2)
    min_neg = pairwise_dist(anc_desc, neg_desc).amin(dim=2)
    before_clamp = min_pos - min_neg + gamma
    active = (before_clamp > 0).float().mean(dim=1)
    loss = _sigma_weights(anc_sigmas, sigma_max) * before_clamp.clamp_min(0.0)
    return loss, active


class CGFDraws(NamedTuple):
    """The CGF loss's draws: uniforms ``rand_pos (B, M, M)`` (which in-radius
    keypoint is the positive), ``rand_out (B, M, M)`` (which outside one is
    the random negative) and ``select (B, M)`` (below 0.5: the closest
    outside keypoint is the negative)."""
    rand_pos: Tensor
    rand_out: Tensor
    select: Tensor


def cgf_draws(b: int, m: int, *, generator: torch.Generator) -> CGFDraws:
    """``desc_cgf_loss``'s uniforms for ``b`` clouds of ``m`` keypoints, in
    its order, on the generator's device."""
    u = lambda shape: torch.rand(shape, generator=generator,  # noqa: E731
                                 device=generator.device)
    return CGFDraws(u((b, m, m)), u((b, m, m)), u((b, m)))


def desc_cgf_loss(anc_keypoints: Tensor, anc_desc: Tensor,
                  pos_keypoints: Tensor, pos_desc: Tensor,
                  anc_sigmas: Tensor, *, cgf_radius: float, gamma: float,
                  sigma_max: float, draws: Optional[CGFDraws] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[Tensor, Tensor]:
    """CGF-style keypoint-level triplet (losses.py:240-369).
    ``anc_keypoints`` are already aligned to the pos frame. The positive is
    a random in-radius match; the negative, half the time (per keypoint),
    the closest outside-radius keypoint, else a random one. The loss is
    rescaled by ``M / (#matched + 1)`` and sigma-weighted. Returns the loss
    per keypoint ``(B, M)`` and the active share ``(B,)``."""
    b, m, _ = anc_keypoints.shape
    if draws is None:
        if generator is None:
            raise ValueError("pass the CGF draws or a torch.Generator")
        draws = cgf_draws(b, m, generator=generator)
    rand_pos, rand_out, select_u = (t.to(anc_desc.device) for t in draws)
    desc_diff = pairwise_dist(anc_desc, pos_desc)              # (B, M, M)
    kp_diff = pairwise_dist(anc_keypoints, pos_keypoints)      # (B, M, M)
    pos_mask = kp_diff <= cgf_radius
    has_match = pos_mask.any(dim=2).float()                    # (B, M)

    def at(idx):
        return desc_diff.gather(2, idx[..., None])[..., 0]

    # torch's argmax/argmin give the first extremum, as jnp's do
    positive_dist = at((pos_mask.float() * rand_pos).argmax(dim=2))
    far_close_dist = at((kp_diff + pos_mask.float() * 1000.0).argmin(dim=2))
    outside = (kp_diff > cgf_radius).float()
    outside_dist = at((rand_out * outside).argmax(dim=2))
    select = (select_u < 0.5).float()
    negative_dist = select * far_close_dist + (1.0 - select) * outside_dist

    match_count = has_match.sum(dim=1)                         # (B,)
    scaling = (m / (match_count + 1.0)).detach()
    before_clamp = (positive_dist - negative_dist + gamma) * has_match
    active = (before_clamp > 1e-5).float().sum(dim=1) / (match_count + 1.0)
    loss = (_sigma_weights(anc_sigmas, sigma_max)
            * before_clamp.clamp_min(0.0) * scaling[:, None])
    return loss, active


def descriptor_matching_accuracy(anc_keypoints: Tensor, anc_desc: Tensor,
                                 pos_keypoints: Tensor, pos_desc: Tensor, *,
                                 radius: float) -> Tensor:
    """Per-cloud 1-NN descriptor matching accuracy ``(B,)``, the
    registration proxy of ``train.select_best_by='match_acc'``: among the
    anchor keypoints with a pos keypoint within ``radius`` (the others are
    left out of the denominator), the share whose nearest pos descriptor
    belongs to a pos keypoint within ``radius``. ``anc_keypoints`` are
    aligned to the pos frame."""
    desc_diff = pairwise_dist(anc_desc, pos_desc)
    kp_diff = pairwise_dist(anc_keypoints, pos_keypoints)
    has_match = (kp_diff <= radius).any(dim=2)
    nn_idx = desc_diff.argmin(dim=2)
    nn_kp_dist = kp_diff.gather(2, nn_idx[..., None])[..., 0]
    correct = (nn_kp_dist <= radius) & has_match
    denom = has_match.float().sum(dim=1).clamp_min(1.0)
    return correct.float().sum(dim=1) / denom
