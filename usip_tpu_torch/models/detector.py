"""USIP keypoint detector, SOM grouping (port of ``usip_tpu/models/detector.py``).

Channels-last: pc ``(B, N, 3)``, sn ``(B, N, S)``, nodes ``(B, M, 3)``.
Outputs: anchors (the recomputed nodes) ``(B, M, 3)``, keypoints ``(B, M, 3)``,
sigmas ``(B, M)``.

Module and parameter names are the reference ``RPN_Detector``'s
(``first_pointnet.layers.{i}``, ``second_pointnet.layers.{i}``,
``knnlayer_1.layers_before|after.{i}``, ``mlp{1,2,3}``), so a reference
``state_dict`` loads with ``strict=True``. Eval mode only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from usip_tpu_torch.config import DetectorConfig
from usip_tpu_torch.nn.layers import PointwiseLayer, SharedMLP
from usip_tpu_torch.ops import (assign_points_to_nodes, gather_points, knn,
                                masked_scatter_max, scatter_back,
                                segment_mean_count)

Tensor = torch.Tensor

# mlp3 (keypoint/sigma head) init: N(0, 1e-4), zero bias (networks.py:70-71)
HEAD_INIT_STD = 1e-4


def compute_dtype(cfg: DetectorConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def knn_group(query: Tensor, database: Tensor, x: Tensor, k: int) -> Tensor:
    """The kNN-fusion input: for each query row its k nearest database rows
    as ``[xyz - query, feature]`` -> ``(B, M, k, 3 + C)`` fp32."""
    _, idx = knn(query, database, k)
    return torch.cat([gather_points(database, idx) - query[:, :, None, :],
                      gather_points(x, idx)], dim=-1)


class KNNFusionOnNodes(nn.Module):
    """GeneralKNNFusionModule, layered: kNN grouping, three pre-layers, max
    over K, the split-kernel ``after0`` over ``(h_max, h)``, ``after1``, max
    over K. Every layer carries BatchNorm and ReLU. The serving path runs the
    same weights through the fused chain kernel instead
    (``models.fused_infer``); this module is the fp32 reference."""

    def __init__(self, cin: int, features_before, features_after, k: int,
                 activation: str = "relu", normalization: str = "batch",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.k = k
        before = []
        for c in features_before:
            before.append(PointwiseLayer(cin, c, activation, normalization,
                                         dtype, kernel_dims=2))
            cin = c
        after = []
        cin = 2 * cin  # virtual concat [h_max, h]
        for c in features_after:
            after.append(PointwiseLayer(cin, c, activation, normalization,
                                        dtype, kernel_dims=2))
            cin = c
        self.layers_before = nn.ModuleList(before)
        self.layers_after = nn.ModuleList(after)

    def forward(self, query: Tensor, database: Tensor, x: Tensor) -> Tensor:
        h = knn_group(query, database, x, self.k)
        for layer in self.layers_before:
            h = layer(h)
        y = (h.amax(dim=-2, keepdim=True), h)
        for layer in self.layers_after:
            y = layer(y)
        return y.amax(dim=-2).float()                          # (B, M, C2)


class Detector(nn.Module):
    """USIP keypoint detector with the SOM trunk (``RPN_Detector``)."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        if cfg.grouping != "som":
            raise NotImplementedError(
                f"grouping {cfg.grouping!r}: only the som trunk is ported")
        if cfg.k != 1:
            raise NotImplementedError("only k=1 point->node assignment is "
                                      "wired into the som trunk")
        self.cfg = cfg
        dt = compute_dtype(cfg)
        act, norm = cfg.activation, cfg.normalization
        c1, c2 = cfg.c1, cfg.c2
        self.first_pointnet = SharedMLP(3 + cfg.surface_normal_len,
                                        (c1 // 2,) * 3, act, norm, dt)
        self.second_pointnet = SharedMLP(c1, (c1, c1), act, norm, dt)
        self.knnlayer_1 = KNNFusionOnNodes(3 + c1, (c2 // 2,) * 3, (c2, c2),
                                           cfg.node_knn_k, act, norm, dt)
        # the head runs in fp32 whatever the compute dtype
        self.mlp1 = PointwiseLayer(c1 + c2, 512, act, norm)
        self.mlp2 = PointwiseLayer(512, 256, act, norm)
        self.mlp3 = PointwiseLayer(256, 4, None, None)
        nn.init.normal_(self.mlp3.conv.weight, std=HEAD_INIT_STD)

    def som_trunk(self, pc: Tensor, sn: Tensor, node: Tensor
                  ) -> Tuple[Tensor, Tensor]:
        """Assignment -> cluster means -> decentre -> PointNet -> scatter-max
        -> scatter-back fusion -> PointNet -> scatter-max. Returns the
        anchors ``(B, M, 3)`` and node features ``(B, M, C1)`` fp32."""
        cfg = self.cfg
        m = node.shape[1]
        assign = assign_points_to_nodes(
            pc, node, round_bf16=cfg.compute_dtype == "bfloat16")
        ids = assign.ids
        occ = assign.occupancy[..., None]
        cluster_mean, _ = segment_mean_count(pc, ids, m)
        decentered = pc - scatter_back(cluster_mean, ids)
        x_aug = (torch.cat([decentered, sn], dim=-1)
                 if cfg.surface_normal_len else decentered)
        f1 = self.first_pointnet(x_aug).float()
        n1 = masked_scatter_max(f1, ids, m) * occ
        s1 = scatter_back(n1, ids)
        f2 = self.second_pointnet(torch.cat([f1, s1], dim=-1)).float()
        n2 = masked_scatter_max(f2, ids, m) * occ
        return cluster_mean, n2

    def keypoint_head(self, feature: Tensor, anchors: Tensor
                      ) -> Tuple[Tensor, Tensor]:
        """The reference's KeypointHead: mlp1 -> mlp2 -> mlp3 giving keypoint
        offsets and sigma = softplus + ``sigma_lower_bound``."""
        y = self.mlp3(self.mlp2(self.mlp1(feature)))
        keypoints = y[..., 0:3] + anchors
        sigmas = (torch.nn.functional.softplus(y[..., 3])
                  + self.cfg.sigma_lower_bound)
        return keypoints, sigmas

    def forward(self, pc: Tensor, sn: Tensor, node: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
        anchors, feat = self.som_trunk(pc, sn, node)
        knn_feature = self.knnlayer_1(anchors, anchors, feat)
        keypoints, sigmas = self.keypoint_head(
            torch.cat([feat, knn_feature], dim=-1), anchors)
        return anchors, keypoints, sigmas
