"""USIP keypoint detector (port of ``usip_tpu/models/detector.py``) with
both trunk families:

* ``som``: point->node assignment and scatter-max pooling (the reference's
  ``RPN_Detector``; module names ``first_pointnet.layers.{i}``,
  ``second_pointnet.layers.{i}``);
* ``knn`` / ``ball``: a fixed-size neighbourhood of each node, by kNN or by a
  natural-order ball query, through ``conv1..conv5`` (the reference's
  ``RPN_Detector_KNN`` / ``RPN_Detector_Ball``, whose ``conv{i}`` weights are
  ``(O, I, 1, 1)``; the released Oxford model is ``ball``, radius 2, K 64).

Both share the kNN-fusion layer (``knnlayer_1.layers_before|after.{i}``) and
the head (``mlp{1,2,3}``). With the reference's names, a reference
``state_dict`` loads with ``strict=True``.

In train mode (``.train()``) every BatchNorm uses batch statistics and
updates its running statistics with the momentum ``forward`` is given, and
the SOM trunk's scatter-max passes gradients by ``cfg.scatter_backend``'s
tie rule; the kNN-fusion layer runs layered (the fused chain kernel folds
eval-mode BatchNorm and serves only eval). Training is wired and checked for
the SOM trunk.

Channels-last: pc ``(B, N, 3)``, sn ``(B, N, S)``, nodes ``(B, M, 3)``.
Outputs: anchors ``(B, M, 3)`` (the recomputed nodes of the SOM trunk, the
nodes themselves for the grouped trunks), keypoints ``(B, M, 3)``, sigmas
``(B, M)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from usip_tpu_torch.config import DetectorConfig
from usip_tpu_torch.nn.layers import (PointwiseLayer, SharedMLP,
                                      set_bn_momentum)
from usip_tpu_torch.ops import (assign_points_to_nodes, ball_query,
                                gather_points, knn, masked_scatter_max,
                                scatter_back, segment_mean_count)

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
    """USIP keypoint detector; the trunk family is ``cfg.grouping``."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        if cfg.grouping not in ("som", "knn", "ball"):
            raise ValueError(f"unknown grouping {cfg.grouping!r}")
        if cfg.grouping == "som" and cfg.k != 1:
            raise NotImplementedError("only k=1 point->node assignment is "
                                      "wired into the som trunk")
        if cfg.group_method not in ("exact", "approx"):
            raise ValueError(f"unknown group_method {cfg.group_method!r}")
        self.cfg = cfg
        dt = compute_dtype(cfg)
        act, norm = cfg.activation, cfg.normalization
        c1, c2 = cfg.c1, cfg.c2
        if cfg.grouping == "som":
            self.first_pointnet = SharedMLP(3 + cfg.surface_normal_len,
                                            (c1 // 2,) * 3, act, norm, dt)
            self.second_pointnet = SharedMLP(c1, (c1, c1), act, norm, dt)
        else:
            # conv1..3: [xyz - node, sn] -> c1/2; conv4 over (h, h_max)
            # -> c1; conv5 c1 -> c1; every layer with norm and activation
            cin = 3 + cfg.surface_normal_len
            for i, cout in enumerate((c1 // 2,) * 3 + (c1, c1)):
                setattr(self, f"conv{i + 1}", PointwiseLayer(
                    cin, cout, act, norm, dt, kernel_dims=2))
                cin = 2 * cout if i == 2 else cout
        self.knnlayer_1 = KNNFusionOnNodes(3 + c1, (c2 // 2,) * 3, (c2, c2),
                                           cfg.node_knn_k, act, norm, dt)
        # the head runs in fp32 whatever the compute dtype
        self.mlp1 = PointwiseLayer(c1 + c2, 512, act, norm)
        self.mlp2 = PointwiseLayer(512, 256, act, norm)
        self.mlp3 = PointwiseLayer(256, 4, None, None)
        nn.init.normal_(self.mlp3.conv.weight, std=HEAD_INIT_STD)

    def trunk(self, pc: Tensor, sn: Tensor, node: Tensor
              ) -> Tuple[Tensor, Tensor]:
        """The trunk of ``cfg.grouping``: anchors ``(B, M, 3)`` and node
        features ``(B, M, C1)`` fp32."""
        if self.cfg.grouping == "som":
            return self.som_trunk(pc, sn, node)
        return self.group_trunk(pc, sn, node)

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
        n1 = masked_scatter_max(f1, ids, m, cfg.scatter_backend) * occ
        s1 = scatter_back(n1, ids)
        f2 = self.second_pointnet(torch.cat([f1, s1], dim=-1)).float()
        n2 = masked_scatter_max(f2, ids, m, cfg.scatter_backend) * occ
        return cluster_mean, n2

    def group_indices(self, pc: Tensor, node: Tensor) -> Tensor:
        """Each node's neighbourhood ``(B, M, group_k)`` int32: its kNN in
        the cloud, or the first ``group_k`` points within ``group_radius``
        in index order (the ball detector scans the cloud unpermuted).
        Both select exactly whatever ``group_method`` says: usip_tpu's
        ``'approx'`` is ``lax.approx_min_k``, a TPU partial reduction with
        no torch counterpart (``ops.grouping.ball_query``)."""
        cfg = self.cfg
        if cfg.grouping == "knn":
            return knn(node, pc, cfg.group_k)[1]
        return ball_query(pc, node, cfg.group_radius, cfg.group_k).idx

    def group_features(self, pc: Tensor, sn: Tensor, node: Tensor,
                       idx: Tensor) -> Tensor:
        """Gather ``[pc, sn]`` at ``idx``, decentre the xyz on the node, then
        conv1..3, the split-kernel conv4 over ``(h, h_max)``, conv5 and a
        max over the neighbourhood -> ``(B, M, C1)`` fp32."""
        x_aug = (torch.cat([pc, sn], dim=-1) if self.cfg.surface_normal_len
                 else pc)
        g = gather_points(x_aug, idx)                          # (B, M, K, C0)
        g = torch.cat([g[..., 0:3] - node[:, :, None, :], g[..., 3:]], dim=-1)
        h = self.conv3(self.conv2(self.conv1(g)))
        y = (h, h.amax(dim=-2, keepdim=True))  # virtual concat [h, h_max]
        y = self.conv5(self.conv4(y))
        return y.amax(dim=-2).float()

    def group_trunk(self, pc: Tensor, sn: Tensor, node: Tensor
                    ) -> Tuple[Tensor, Tensor]:
        """kNN/ball trunk: anchors are the nodes themselves."""
        return node, self.group_features(pc, sn, node,
                                         self.group_indices(pc, node))

    def keypoint_head(self, feature: Tensor, anchors: Tensor
                      ) -> Tuple[Tensor, Tensor]:
        """The reference's KeypointHead: mlp1 -> mlp2 -> mlp3 giving keypoint
        offsets and sigma = softplus + ``sigma_lower_bound``."""
        y = self.mlp3(self.mlp2(self.mlp1(feature)))
        keypoints = y[..., 0:3] + anchors
        sigmas = (torch.nn.functional.softplus(y[..., 3])
                  + self.cfg.sigma_lower_bound)
        return keypoints, sigmas

    def forward(self, pc: Tensor, sn: Tensor, node: Tensor,
                bn_momentum: Optional[float] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
        """Anchors, keypoints and sigmas. ``bn_momentum``, where given, is
        set on every BatchNorm first (the train step's epoch-decayed
        momentum)."""
        if bn_momentum is not None:
            set_bn_momentum(self, bn_momentum)
        anchors, feat = self.trunk(pc, sn, node)
        knn_feature = self.knnlayer_1(anchors, anchors, feat)
        keypoints, sigmas = self.keypoint_head(
            torch.cat([feat, knn_feature], dim=-1), anchors)
        return anchors, keypoints, sigmas
