"""The USIP keypoint detector with the ball trunk (lijx10/USIP
``models/networks.py`` ``RPN_Detector_Ball``, the released Oxford RobotCar
model ``BALL-16384-512-r2k64-k16``), its siamese train step on Oxford's
augmentation, in plain PyTorch fp32 (TF32 off) over a dict of named tensors.

* Ball query, per node: the first ``group_k`` points, in the cloud's index
  order, whose squared distance to the node is at most ``group_radius^2``;
  a short ball padded by repeating its points cyclically, an empty ball all
  point 0 (``benchmark.reference.descriptor.ball_query`` with the point's
  index as its priority).
* Per ball: ``[xyz - node, sn]`` through conv1..conv3 (3 + S -> c1/2, c1/2,
  c1/2), conv4 over the concatenation ``[h, max over the ball of h]`` (c1 ->
  c1), conv5 (c1 -> c1), every layer dense, BatchNorm and ReLU; the max
  over the ball gives the node's feature ``(B, M, c1)``.
* The kNN fusion over the ``node_knn_k`` nearest nodes and the head, as the
  SOM detector's (``benchmark.reference.detector``), the anchors being the
  nodes themselves.
* The loss and Adam are ``benchmark.reference.detector``'s: the
  probabilistic chamfer plus alpha times each copy's keypoint-to-cloud
  distance.
* Oxford's augmentation (``oxford/oxford_detector_loader.py``): each
  parent's up axis (camera y) scaled by one factor a sample, uniform in
  ``[height_scale_low, height_scale_high)``, before the nodes are drawn;
  then the shared rotation about the up axis, the jitter and the shared
  scale, and the ground-truth transform of the second copy
  (``benchmark.reference.detector.prepare``).

Departures from the published code, each the port's too:

* the two copies are the parent's first and last ``input_pc_num`` rows (the
  rows in random order), not two independent draws from the file;
* the nodes are FPS over a random ``1 / fps_subsample_ratio`` subset of
  each copy, from a random seed row (as the SOM reference);
* the published code draws in numpy and on its own generator: here every
  draw is an input (``BallDraws``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from benchmark.reference import detector as det
from benchmark.reference.common import (FP32, Precision, gather, layer,
                                        smallest_k_idx, sqdist_blocked)
from benchmark.reference.descriptor import ball_query as _ball_query

Tensor = torch.Tensor


class BallSizes(NamedTuple):
    """The ball detector's widths and shapes: the SOM detector's, the
    ball's radius and size, and the height scale's range."""
    input_pc_num: int
    parent_pc_num: int
    node_num: int
    c1: int
    c2: int
    node_knn_k: int
    surface_normal_len: int
    fps_subsample_ratio: int
    batch_size: int
    sigma_lower_bound: float
    keypoint_on_pc_alpha: float
    lr: float
    bn_momentum: float
    jitter_pc_sigma: float
    jitter_pc_clip: float
    jitter_node_sigma: float
    jitter_node_clip: float
    group_radius: float
    group_k: int


def sizes_from(config: dict) -> BallSizes:
    s = config["sizes"]
    return BallSizes(**{k: s[k] for k in BallSizes._fields})


def param_shapes(z: BallSizes) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every tensor of the ball detector, ``(name, shape, kind)`` as
    ``benchmark.reference.detector.param_shapes``: conv1..conv5 (the
    published names), then the SOM detector's fusion and head."""
    out = []
    h, c1 = z.c1 // 2, z.c1
    widths = [(3 + z.surface_normal_len, h), (h, h), (h, h), (2 * h, c1),
              (c1, c1)]
    for i, (cin, cout) in enumerate(widths):
        name = f"conv{i + 1}"
        out.append((name + ".conv.weight", (cout, cin, 1, 1), "conv"))
        out.append((name + ".conv.bias", (cout,), "zero"))
        out.extend([(name + ".norm.weight", (cout,), "one"),
                    (name + ".norm.bias", (cout,), "zero"),
                    (name + ".norm.running_mean", (cout,), "zero"),
                    (name + ".norm.running_var", (cout,), "one"),
                    (name + ".norm.num_batches_tracked", (), "count")])
    return out + [s for s in det.param_shapes(z)
                  if not s[0].startswith(("first_pointnet",
                                          "second_pointnet"))]


def ball_indices(pc: Tensor, node: Tensor, z: BallSizes,
                 prec: Precision = FP32) -> Tensor:
    """Each node's ball ``(B, M, group_k)``: its first in-radius points in
    index order, cyclically padded, 0 where empty."""
    order = torch.arange(pc.shape[1], dtype=torch.float32,
                         device=pc.device).expand(pc.shape[0], -1)
    return _ball_query(pc.detach(), node.detach(), order, z.group_radius,
                       z.group_k, prec)


def ball_counts(pc: Tensor, node: Tensor, z: BallSizes,
                block: int = 64) -> Tensor:
    """Each node's in-radius points ``(B, M)``, not capped at
    ``group_k``: the fill of its ball."""
    r2 = z.group_radius * z.group_radius
    return torch.cat([(sqdist_blocked(node[:, i:i + block], pc) <= r2).sum(-1)
                      for i in range(0, node.shape[1], block)], 1)


def forward(p: Dict[str, Tensor], z: BallSizes, pc: Tensor, sn: Tensor,
            node: Tensor, train: bool, prec: Precision = FP32,
            stats=None) -> Tuple[Tensor, Tensor, Tensor]:
    """Anchors (the nodes), keypoints ``(B, M, 3)`` and sigmas ``(B, M)``
    of clouds ``pc (B, N, 3)``, ``sn (B, N, S)`` with nodes ``(B, M, 3)``;
    BatchNorm over the batch in train mode."""
    idx = ball_indices(pc, node, z, prec)
    g = gather(torch.cat([pc, sn], -1), idx)                  # (B, M, K, C0)
    h = torch.cat([g[..., 0:3] - node[:, :, None, :], g[..., 3:]], -1)
    for i in range(3):
        h = layer(p, f"conv{i + 1}", h, train, prec, stats=stats)
    h = torch.cat([h, h.amax(-2, keepdim=True).expand_as(h)], -1)
    h = layer(p, "conv4", h, train, prec, stats=stats)
    h = layer(p, "conv5", h, train, prec, stats=stats)
    feat = h.amax(-2)                                          # (B, M, c1)

    with torch.no_grad():
        nbr = smallest_k_idx(sqdist_blocked(node, node), z.node_knn_k)
    f = torch.cat([gather(node, nbr) - node[:, :, None, :],
                   gather(feat, nbr)], -1)                    # (B, M, K, 3+c1)
    for i in range(3):
        f = layer(p, f"knnlayer_1.layers_before.{i}", f, train, prec,
                  stats=stats)
    f = torch.cat([f.amax(-2, keepdim=True).expand_as(f), f], -1)
    for i in range(2):
        f = layer(p, f"knnlayer_1.layers_after.{i}", f, train, prec,
                  stats=stats)
    fused = f.amax(-2)                                         # (B, M, c2)

    y = torch.cat([feat, fused], -1)
    y = layer(p, "mlp1", y, train, stats=stats)
    y = layer(p, "mlp2", y, train, stats=stats)
    y = layer(p, "mlp3", y, train, norm=False, relu=False)
    keypoints = y[..., 0:3] + node
    sigmas = torch.nn.functional.softplus(y[..., 3]) + z.sigma_lower_bound
    return node, keypoints, sigmas


class BallDraws(NamedTuple):
    """Every random draw of one train step: ``benchmark.reference.detector
    .DetectorDraws``' fields, then each sample's height scale ``(B,)``."""
    subset_src: Tensor
    first_src: Tensor
    subset_dst: Tensor
    first_dst: Tensor
    aug_angles: Tensor
    aug_scale: Tensor
    jitter: Tuple[Tuple[Tensor, Tensor, Tensor], ...]
    gt_angles: Tensor
    gt_scale: Tensor
    gt_shift: Tensor
    height: Tensor


def prepare(z: BallSizes, pc_parent: Tensor, sn_parent: Tensor,
            d: BallDraws):
    """The parents' up axis (camera y) scaled by ``d.height``, then the
    SOM reference's ``prepare``: the two copies, their nodes, the shared
    augmentation and the ground-truth transform of the second."""
    ones = torch.ones_like(d.height)
    factor = torch.stack([ones, d.height, ones], -1)[:, None, :]
    return det.prepare(z, pc_parent.float() * factor, sn_parent, d)


def step_loss(p, z: BallSizes, pc_parent: Tensor, sn_parent: Tensor,
              d: BallDraws, prec: Precision = FP32) -> Tensor:
    """One siamese step's loss: both copies through one train-mode forward
    over the concatenated batch."""
    src, dst, gt = prepare(z, pc_parent, sn_parent, d)
    b = src[0].shape[0]
    pc, sn, node = (torch.cat([a, c], 0) for a, c in zip(src, dst))
    out = forward(p, z, pc, sn, node, True, prec)
    return det.loss(z, tuple(t[:b] for t in out), tuple(t[b:] for t in out),
                    src[0], dst[0], gt)


def train_steps(weights: Dict[str, Tensor], z: BallSizes, batches, draws,
                prec: Precision = FP32) -> det.TrainRecord:
    """``len(batches)`` train steps from ``weights`` (not modified), batch
    ``(pc_parent, sn_parent)`` and ``BallDraws`` by step."""
    params = {k: v.detach().clone().float() for k, v in weights.items()
              if det.trainable(k)}
    start = {k: v.clone() for k, v in params.items()}
    opt = det.Adam(params, z.lr)
    losses, first = [], None
    for (pc, sn), d in zip(batches, draws):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        value = step_loss({**weights, **leaves}, z, pc, sn, d, prec)
        grads = dict(zip(leaves, torch.autograd.grad(value,
                                                     list(leaves.values()))))
        for v in params.values():
            v.requires_grad_(False)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(value.detach()))
    return det.TrainRecord(losses, first,
                           {k: params[k] - start[k] for k in params})


@torch.no_grad()
def step_fill(z: BallSizes, pc_parent: Tensor, sn_parent: Tensor,
              d: BallDraws) -> Tensor:
    """The in-radius count of every ball ``(2B, M)`` of one step, both
    copies' nodes over their prepared clouds."""
    src, dst, _ = prepare(z, pc_parent, sn_parent, d)
    return torch.cat([ball_counts(src[0], src[2], z),
                      ball_counts(dst[0], dst[2], z)])


def train_flops(sizes: dict) -> float:
    """Model FLOPs of a cloud's share of a train step (three forwards; 2 a
    multiply-add; dense layers only, as ``benchmark/flops.py``): the ball
    PointNet over ``node_num x group_k`` rows, conv4's split layer (the
    per-row half and, once a ball, the max's half), then the fusion with
    its split layer and the head, counted as ``benchmark/flops.py`` counts
    the SOM detector's."""
    m, k, c1, c2 = (sizes[x] for x in ("node_num", "group_k", "c1", "c2"))
    h, c = c1 // 2, c2 // 2
    cin = 3 + sizes["surface_normal_len"]
    ball = m * k * (cin * h + 2 * h * h + h * c1 + c1 * c1) + m * h * c1
    rows = m * sizes["node_knn_k"]
    fusion = (rows * ((3 + c1) * c + 2 * c * c + c * c2 + c2 * c2)
              + m * c * c2)
    head = m * ((c1 + c2) * 512 + 512 * 256 + 256 * 4)
    return 3.0 * 2.0 * (ball + fusion + head)
