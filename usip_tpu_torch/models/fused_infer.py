"""Eval-mode detector forward with the kNN-fusion stack on the fused chain
kernel (port of ``usip_tpu/models/fused_infer.py``).

The SOM trunk and the head are the ``Detector``'s own modules; the fusion
stack's five dense layers run in ``ops.kernels.fusion_chain`` with BatchNorm
folded into the weights. This is the port's serving forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from usip_tpu_torch.models.detector import Detector, knn_group
from usip_tpu_torch.ops.kernels import fusion_chain, fusion_chain_params

Tensor = torch.Tensor


@torch.no_grad()
def detector_infer_fused(det: Detector, pc: Tensor, sn: Tensor, node: Tensor,
                         chain: Optional[tuple] = None
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Full detector eval forward -> ``(anchors, keypoints, sigmas)``, like
    ``det(pc, sn, node)`` in eval mode. ``chain`` is
    ``fusion_chain_params(det.knnlayer_1)``, passed in by callers that fold
    the weights once."""
    if det.training:
        raise ValueError("detector_infer_fused is the eval forward; call "
                         "det.eval() first")
    anchors, feat = det.som_trunk(pc, sn, node)
    grouped = knn_group(anchors, anchors, feat, det.cfg.node_knn_k)
    ws, bs = chain if chain is not None else fusion_chain_params(det.knnlayer_1)
    knn_feature = fusion_chain(grouped.contiguous(), ws, bs)
    keypoints, sigmas = det.keypoint_head(
        torch.cat([feat, knn_feature], dim=-1), anchors)
    return anchors, keypoints, sigmas
