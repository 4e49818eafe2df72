"""Point-sharded descriptor forward (counterpart of
``usip_tpu/parallel/sharded_descriptor.py``): the ball grouping over a
cloud whose N axis is cut over the ranks of a ``points`` mesh
(``sharded_ball_gather``: a per-shard smallest-k and one small gather),
then the descriptor's layers on the replicated ``(B, M, K, C)`` ball
features, the ``Descriptor``'s own modules, so any checkpoint serves
unchanged.

With the same priorities it is the one-device ``Descriptor`` forward, but
for empty balls (zero features here, point 0's there; usip_tpu's
deliberate deviation).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from usip_tpu_torch.config import Config
from usip_tpu_torch.nn.layers import set_bn_momentum
from usip_tpu_torch.parallel.mesh import Mesh
from usip_tpu_torch.parallel.sharded_ops import sharded_ball_gather

Tensor = torch.Tensor


@torch.no_grad()
def sharded_describe(mesh: Mesh, cfg: Config, model, pc: Tensor, sn: Tensor,
                     keypoints: Tensor, priority: Tensor
                     ) -> Tuple[Tensor, Tensor]:
    """The eval descriptor forward of ``model`` with ``pc (B, n, 3)``, ``sn
    (B, n, S)`` and the ball priorities ``priority (B, n)`` this rank's
    shards, ``keypoints (B, M, 3)`` replicated: ``(descriptors (B, M, D),
    ball features (B, M, K, 3 + S))``, replicated."""
    dcfg = cfg.descriptor
    x_aug = torch.cat([pc, sn], dim=-1) if dcfg.surface_normal_len > 0 \
        else pc
    feats, _, _ = sharded_ball_gather(mesh, keypoints, pc, x_aug,
                                      dcfg.ball_radius, dcfg.ball_nsamples,
                                      priority)
    ball_feats = torch.cat([feats[..., 0:3] - keypoints[:, :, None, :],
                            feats[..., 3:]], dim=-1)
    desc, _ = describe_from_ball_feats(cfg, model, ball_feats)
    return desc, ball_feats


def describe_from_ball_feats(cfg: Config, model, ball_feats: Tensor,
                             train: bool = False, bn_momentum: float = 0.1
                             ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The descriptor's layers after the grouping on replicated,
    decentred ball features ``(B, M, K, 3 + S)``: ``(descriptors, the
    running statistics)``. Train mode normalises with the batch's
    statistics, global by construction (the features are replicated), and
    updates the running statistics in place (usip_tpu returns them)."""
    del cfg  # the model carries its config
    model.train(train)
    if train:
        set_bn_momentum(model, bn_momentum)
    desc = model.describe(ball_feats)
    return desc, {k: v for k, v in model.named_buffers()
                  if k.endswith(("running_mean", "running_var"))}
