"""Train-time augmentation on the device (port of ``usip_tpu/data/augment.py``).

The same two stages as usip_tpu:

1. ``shared_augment``: one rotation, scale (and shift) applied to both
   siamese copies, with per-copy jitter (the loaders' ``.augment()``);
2. ``random_se3``: the ground-truth transform of the dst copy, returned as
   ``SE3`` for the chamfer alignment.

Every random draw is an input: each function takes a record of its draws
(``SE3Draws``, ``AugmentDraws``, the height scales) or, where that is None,
draws them from the given ``torch.Generator`` on the generator's device. JAX
keys and torch generators never give the same numbers, so the tests hand
JAX's draws in.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from usip_tpu_torch.config import AugmentConfig
from usip_tpu_torch.ops.geometry import rotate

Tensor = torch.Tensor


def rotation_matrix(angles: Tensor) -> Tensor:
    """Euler XYZ rotation ``R = Rz @ Ry @ Rx``: ``angles (..., 3)`` ->
    ``(..., 3, 3)`` (the reference's data/augmentation.py:15-26)."""
    ax, ay, az = angles.unbind(-1)
    cx, sx, cy, sy = ax.cos(), ax.sin(), ay.cos(), ay.sin()
    cz, sz = az.cos(), az.sin()
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return rz @ ry @ rx


def _uniform(generator: torch.Generator, shape, low: float, high: float
             ) -> Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return low + (high - low) * u


def _need(generator: Optional[torch.Generator], what: str) -> None:
    if generator is None:
        raise ValueError(f"pass the {what} draws or a torch.Generator")


def sample_angles(rot_type: Optional[str], rot_perturbation: bool, batch: int,
                  generator: torch.Generator) -> Tensor:
    """Per-sample Euler angles ``(B, 3)`` of the rotation regime: ``'2d'`` a
    uniform angle about y, ``'3d'`` three uniform angles, None none; plus,
    with ``rot_perturbation``, N(0, 0.06^2) clipped at 0.18 on each."""
    dev = generator.device
    if rot_type == "2d":
        y = _uniform(generator, (batch,), 0.0, 2 * math.pi)
        zero = torch.zeros_like(y)
        angles = torch.stack([zero, y, zero], -1)
    elif rot_type == "3d":
        angles = _uniform(generator, (batch, 3), 0.0, 2 * math.pi)
    elif rot_type is None:
        angles = torch.zeros((batch, 3), device=dev)
    else:
        raise ValueError(f"invalid rot_type {rot_type!r}")
    if rot_perturbation:
        pert = 0.06 * torch.randn((batch, 3), generator=generator, device=dev)
        angles = angles + pert.clamp(-0.18, 0.18)
    return angles


class SE3(NamedTuple):
    """Ground-truth transform of the dst copy: ``p -> (R @ p) * scale +
    shift``."""
    R: Tensor      # (B, 3, 3)
    scale: Tensor  # (B,)
    shift: Tensor  # (B, 3)


class SE3Draws(NamedTuple):
    """The draws of ``random_se3``: Euler angles ``(B, 3)`` (perturbation
    included), scale ``(B,)``, shift ``(B, 3)``."""
    angles: Tensor
    scale: Tensor
    shift: Tensor


def se3_draws(b: int, rot_type: Optional[str], rot_perturbation: bool,
              scale_thre: float, shift_thre: float,
              generator: torch.Generator) -> SE3Draws:
    """``random_se3``'s draws for ``b`` clouds, in its order."""
    angles = sample_angles(rot_type, rot_perturbation, b, generator)
    return SE3Draws(angles,
                    _uniform(generator, (b,), 1.0 - scale_thre,
                             1.0 + scale_thre),
                    _uniform(generator, (b, 3), -shift_thre, shift_thre))


def random_se3(pc: Tensor, sn: Tensor, node: Tensor, *,
               rot_type: Optional[str], scale_thre: float = 0.2,
               shift_thre: float = 0.2, rot_perturbation: bool = False,
               draws: Optional[SE3Draws] = None,
               generator: Optional[torch.Generator] = None
               ) -> Tuple[Tensor, Tensor, Tensor, SE3]:
    """The batched ``transform_pc_pytorch``: rotate, scale uniformly in
    ``[1 - scale_thre, 1 + scale_thre]``, shift uniformly in
    ``[-shift_thre, shift_thre]``. ``pc (B, N, 3)``, ``sn (B, N, S)`` (only
    its first three channels rotate; scale and shift leave it), ``node
    (B, M, 3)``. Returns the transformed ``(pc, sn, node)`` and the SE3."""
    b = pc.shape[0]
    if draws is None:
        _need(generator, "SE3")
        draws = se3_draws(b, rot_type, rot_perturbation, scale_thre,
                          shift_thre, generator)
    R = rotation_matrix(draws.angles.to(pc))
    scale, shift = draws.scale.to(pc), draws.shift.to(pc)
    pc = rotate(pc, R) * scale[:, None, None] + shift[:, None, :]
    node = rotate(node, R) * scale[:, None, None] + shift[:, None, :]
    if sn.shape[-1] >= 3:
        sn = torch.cat([rotate(sn[..., 0:3], R), sn[..., 3:]], -1)
    return pc, sn, node, SE3(R, scale, shift)


class AugmentDraws(NamedTuple):
    """The draws of ``shared_augment``: Euler angles ``(B, 3)``, scale
    ``(B,)``, shift ``(B, 3)``, and per pack the standard-normal jitter
    noise ``(pc (B, N, 3), sn (B, N, S), node (B, M, 3))`` before its sigma
    and clip (one entry for all packs under ``shared_jitter``; None without
    jitter)."""
    angles: Tensor
    scale: Tensor
    shift: Tensor
    jitter: Optional[Sequence[Tuple[Tensor, Tensor, Tensor]]] = None


def augment_draws(shapes, cfg: AugmentConfig, scale_low: float,
                  scale_high: float, shared_jitter: bool,
                  generator: torch.Generator) -> AugmentDraws:
    """``shared_augment``'s draws, in its order, for packs of the
    ``shapes`` ``[(pc, sn, node) shapes, ...]`` (batch first)."""
    b = shapes[0][0][0]
    angles = sample_angles(cfg.rot_type, cfg.rot_perturbation, b, generator)
    scale = _uniform(generator, (b,), scale_low, scale_high)
    shift = _uniform(generator, (b, 3), -0.1, 0.1)
    jitter = None
    if cfg.jitter:
        jitter = [tuple(torch.randn(sh, generator=generator,
                                    device=generator.device) for sh in pack)
                  for pack in shapes[:1 if shared_jitter else None]]
    return AugmentDraws(angles, scale, shift, jitter)


def shared_augment(packs, cfg: AugmentConfig, *, scale_low: float = 0.9,
                   scale_high: float = 1.1, shared_jitter: bool = False,
                   draws: Optional[AugmentDraws] = None,
                   generator: Optional[torch.Generator] = None):
    """The loaders' train augmentation on a list of ``(pc, sn, node)``
    packs with shared rotation, scale and shift: rotation of pc, sn[..., :3]
    and node by ``cfg.rot_type``; jitter (``cfg.jitter``) of pc, sn and
    node, per pack unless ``shared_jitter``; scale of pc and node (and sn
    with ``cfg.scale_sn``); shift only with
    ``cfg.translation_perturbation``."""
    if draws is None:
        _need(generator, "augment")
        draws = augment_draws([tuple(t.shape for t in pack)
                               for pack in packs], cfg, scale_low,
                              scale_high, shared_jitter, generator)
    ref = packs[0][0]
    R = rotation_matrix(draws.angles.to(ref))
    scale, shift = draws.scale.to(ref), draws.shift.to(ref)
    out = []
    for i, (pc, sn, node) in enumerate(packs):
        pc, node = rotate(pc, R), rotate(node, R)
        if sn.shape[-1] >= 3:
            sn = torch.cat([rotate(sn[..., 0:3], R), sn[..., 3:]], -1)
        if cfg.jitter:
            n_pc, n_sn, n_node = (t.to(ref) for t in
                                  draws.jitter[0 if shared_jitter else i])
            clip_pc, clip_node = cfg.jitter_pc_clip, cfg.jitter_node_clip
            pc = pc + (cfg.jitter_pc_sigma * n_pc).clamp(-clip_pc, clip_pc)
            sn = sn + (cfg.jitter_pc_sigma * n_sn).clamp(-clip_pc, clip_pc)
            node = node + (cfg.jitter_node_sigma * n_node).clamp(-clip_node,
                                                                 clip_node)
        pc = pc * scale[:, None, None]
        node = node * scale[:, None, None]
        if cfg.scale_sn:
            sn = sn * scale[:, None, None]
        if cfg.translation_perturbation:
            pc = pc + shift[:, None, :]
            node = node + shift[:, None, :]
        out.append((pc, sn, node))
    return out


def height_scale_draws(b: int, low: float, high: float,
                       generator: torch.Generator) -> Tensor:
    """``random_height_scale``'s factors ``(B,)``, uniform in ``[low,
    high)``."""
    return _uniform(generator, (b,), low, high)


def random_height_scale(pcs, low: float = 0.25, high: float = 1.2,
                        axis: int = 2, *, scale: Optional[Tensor] = None,
                        generator: Optional[torch.Generator] = None):
    """Oxford's up-axis height scaling, one factor a sample shared by every
    cloud of ``pcs`` (a list of ``(B, N, 3)``): coordinate ``axis`` times
    ``scale (B,)``, uniform in ``[low, high)`` where not given (``axis=1``
    in the camera frame the clouds are stored in)."""
    if scale is None:
        _need(generator, "height scale")
        scale = height_scale_draws(pcs[0].shape[0], low, high, generator)
    scale = scale.to(pcs[0])
    ones = torch.ones_like(scale)
    cols = [ones, ones, ones]
    cols[axis] = scale
    factor = torch.stack(cols, -1)[:, None, :]
    return [pc * factor for pc in pcs]


def coordinate_nwu_to_cam(points):
    """NWU -> camera axes on the host: x <- -y, y <- -z, z <- x (numpy,
    (N, 3); usip_tpu's ``data/augment.py:188``)."""
    out = np.copy(points)
    out[:, 0] = -points[:, 1]
    out[:, 1] = -points[:, 2]
    out[:, 2] = points[:, 0]
    return out


def coordinate_enu_to_cam(points):
    """ENU -> camera axes on the host: x <- x, y <- -z, z <- y (numpy,
    (N, 3); usip_tpu's ``data/augment.py:198``, used by the Oxford
    loaders)."""
    out = np.copy(points)
    out[:, 1] = -points[:, 2]
    out[:, 2] = points[:, 1]
    return out
