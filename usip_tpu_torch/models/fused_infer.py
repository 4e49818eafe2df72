"""Eval-mode detector forward with the kNN-fusion stack on the fused chain
kernel (port of ``usip_tpu/models/fused_infer.py``).

The trunk (SOM, knn or ball) and the head are the ``Detector``'s own
modules; the fusion stack's five dense layers run in
``ops.kernels.fusion_chain`` with BatchNorm folded into the weights, for
every trunk family (usip_tpu's fused path is SOM-only because it replays the
SOM trunk by name). This is the port's serving forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from usip_tpu_torch.models.detector import Detector, knn_group
from usip_tpu_torch.ops.kernels import (FusionChain, fusion_chain,
                                        fusion_chain_params, prepare_chain)
from usip_tpu_torch.utils.logging import span

Tensor = torch.Tensor


@torch.no_grad()
def detector_infer_fused(det: Detector, pc: Tensor, sn: Tensor, node: Tensor,
                         chain: Optional[FusionChain] = None
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """Full detector eval forward -> ``(anchors, keypoints, sigmas)``, like
    ``det(pc, sn, node)`` in eval mode. ``chain`` is
    ``prepare_chain(*fusion_chain_params(det.knnlayer_1))``, passed in by
    callers that fold and pack the weights once. Its parts are the spans
    ``usip.infer.trunk``, ``.fusion`` and ``.head``."""
    if det.training:
        raise ValueError("detector_infer_fused is the eval forward; call "
                         "det.eval() first")
    with span("usip.infer.trunk"):
        anchors, feat = det.trunk(pc, sn, node)
    with span("usip.infer.fusion"):
        grouped = knn_group(anchors, anchors, feat, det.cfg.node_knn_k)
        if chain is None:
            chain = prepare_chain(*fusion_chain_params(det.knnlayer_1))
        knn_feature = fusion_chain(grouped.contiguous(), chain)
    with span("usip.infer.head"):
        keypoints, sigmas = det.keypoint_head(
            torch.cat([feat, knn_feature], dim=-1), anchors)
    return anchors, keypoints, sigmas
