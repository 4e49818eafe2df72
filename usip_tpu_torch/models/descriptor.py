"""Keypoint descriptor (port of ``usip_tpu/models/descriptor.py``; the
reference's DescriptorLiteOld / DescriptorLiteOldGlobal, networks.py:310-479),
channels-last.

Ball grouping around the keypoints, then ``conv1..conv3``, the split-kernel
``conv4`` over ``(h, h_max)``, ``conv5`` (no norm, no activation), the max
over the ball and a safe L2 normalisation. With ``use_global_context`` the
PPFNet-style global fusion ``fc1..fc3`` runs before the normalisation. The
module names and shapes are the reference's (``conv{i}.conv.weight (O, I, 1,
1)``, ``fc{i}.conv.weight (O, I, 1)``), so a reference ``state_dict`` loads
with ``strict=True``.

The ball query's priorities are random, one per point shared by every ball
(the reference permutes the cloud once per forward, networks.py:344-347):
an input ``priority (B, N)`` or draws from a ``torch.Generator``. Its
selection is the smallest-k kernel on the card.

Both maxima over the ball are ``amax``, which splits the gradient evenly
among tied maxima as ``jnp.max`` does: a ball with fewer than K points is
padded by repeating its points, so its maxima tie.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from usip_tpu_torch.config import DescriptorConfig
from usip_tpu_torch.nn.layers import PointwiseLayer, set_bn_momentum
from usip_tpu_torch.ops import ball_query, gather_points
from usip_tpu_torch.ops.geometry import safe_sqrt

Tensor = torch.Tensor


class Descriptor(nn.Module):
    """Ball-grouping descriptor; ``cfg.use_global_context`` adds the indoor
    (PPFNet fusion) head."""

    def __init__(self, cfg: DescriptorConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.descriptor_len
        dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None
        act, norm = cfg.activation, cfg.normalization
        cin = 3 + cfg.surface_normal_len
        for i, c in enumerate((d // 4, d // 2, d)):
            setattr(self, f"conv{i + 1}", PointwiseLayer(
                cin, c, act, norm, dt, kernel_dims=2))
            cin = c
        # virtual concat [h, h_max] through the split kernel
        self.conv4 = PointwiseLayer(2 * d, d, act, norm, dt, kernel_dims=2)
        self.conv5 = PointwiseLayer(d, d, None, None, kernel_dims=2)
        if cfg.use_global_context:
            # virtual concat [desc, global max] through the split kernel
            self.fc1 = PointwiseLayer(2 * d, 2 * d, act, norm)
            self.fc2 = PointwiseLayer(2 * d, d, act, norm)
            self.fc3 = PointwiseLayer(d, d, None, None)

    def group(self, pc: Tensor, sn: Tensor, keypoints: Tensor,
              priority: Optional[Tensor] = None,
              generator: Optional[torch.Generator] = None) -> Tensor:
        """Ball features ``(B, M, K, 3 + S)``: ``[xyz - keypoint, sn]`` of
        the ball's points."""
        cfg = self.cfg
        x_aug = torch.cat([pc, sn], -1) if cfg.surface_normal_len > 0 else pc
        bq = ball_query(pc.detach(), keypoints.detach(), cfg.ball_radius,
                        cfg.ball_nsamples, priority, generator=generator,
                        method=cfg.ball_method,
                        round_bf16=cfg.ball_compute_dtype == "bfloat16")
        g = gather_points(x_aug, bq.idx)
        return torch.cat([g[..., 0:3] - keypoints[:, :, None, :],
                          g[..., 3:]], -1)

    def forward(self, pc: Tensor, sn: Tensor, keypoints: Tensor,
                priority: Optional[Tensor] = None,
                generator: Optional[torch.Generator] = None,
                bn_momentum: Optional[float] = None
                ) -> Tuple[Tensor, Tensor]:
        """``pc (B, N, 3)``, ``sn (B, N, S)``, ``keypoints (B, M, 3)`` ->
        (descriptors ``(B, M, descriptor_len)`` fp32, unit length; ball
        features ``(B, M, K, 3 + S)``). ``bn_momentum``, where given, is set
        on every BatchNorm first."""
        if bn_momentum is not None:
            set_bn_momentum(self, bn_momentum)
        feats = self.group(pc, sn, keypoints, priority, generator)
        return self.describe(feats), feats

    def describe(self, feats: Tensor) -> Tensor:
        """Ball features ``(B, M, K, 3 + S)`` -> unit descriptors ``(B, M,
        descriptor_len)`` fp32: the layers after the ball query."""
        h = self.conv3(self.conv2(self.conv1(feats)))
        y = self.conv5(self.conv4((h, h.amax(dim=-2, keepdim=True))))
        desc = y.amax(dim=-2).float()                          # (B, M, d)
        if self.cfg.use_global_context:
            z = self.fc1((desc, desc.amax(dim=-2, keepdim=True)))
            desc = self.fc3(self.fc2(z))
        norm = safe_sqrt((desc * desc).sum(-1, keepdim=True))
        return desc / (norm + 1e-5)
