"""Point-sharded detector forward (counterpart of
``usip_tpu/parallel/sharded_detector.py``): the cloud's N axis cut over the
ranks of a ``points`` mesh, for clouds beyond one card.

The SOM trunk is local but for three small collectives (``sharded_train``'s
trunk in eval mode): the point->node assignment on each rank's shard (the
min/argmin kernel), the cluster sums and counts all-reduced, the node max a
local masked scatter-max (the scatter-max kernel) and an all-reduce MAX,
with the nodes empty on a rank set to -inf there and the nodes empty
everywhere to 0. The kNN fusion (the fused chain kernel) and the head run
on the replicated ``(B, M, .)`` node tensors: the port's serving forward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from usip_tpu_torch.config import Config
from usip_tpu_torch.models.detector import knn_group
from usip_tpu_torch.ops.kernels import (fusion_chain, fusion_chain_params,
                                        prepare_chain)
from usip_tpu_torch.parallel.mesh import Mesh
from usip_tpu_torch.parallel.sharded_train import sharded_trunk_apply

Tensor = torch.Tensor


@torch.no_grad()
def sharded_detector_forward(mesh: Mesh, cfg: Config, model, pc: Tensor,
                             sn: Tensor, node: Tensor, chain=None
                             ) -> Tuple[Tensor, Tensor, Tensor]:
    """The eval forward of ``model`` (a som/k=1 ``Detector``) with ``pc
    (B, n, 3)``, ``sn (B, n, S)`` this rank's shards and ``node (B, M, 3)``
    replicated: ``(anchors, keypoints, sigmas)``, replicated, the
    one-device forward's up to reduction order. ``chain``: the fused
    chain's packed weights (``prepare_chain``), for callers that pack them
    once."""
    model.eval()
    anchors, feat = sharded_trunk_apply(mesh, cfg, model, pc, sn, node,
                                        train=False)
    if chain is None:
        chain = prepare_chain(*fusion_chain_params(model.knnlayer_1))
    grouped = knn_group(anchors, anchors, feat, cfg.detector.node_knn_k)
    knn_feat = fusion_chain(grouped.contiguous(), chain)
    keypoints, sigmas = model.keypoint_head(
        torch.cat([feat, knn_feat], dim=-1), anchors)
    return anchors, keypoints, sigmas
