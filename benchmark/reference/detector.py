"""The USIP keypoint detector with the SOM trunk, its siamese train step and
its eval forward, in plain PyTorch fp32 (TF32 off) over a dict of named
tensors.

The architecture is the published one (lijx10/USIP ``models/networks.py``
``RPN_Detector``, ``models/keypoint_detector.py``, ``models/losses.py``):

* each point joins its nearest node; the points are decentred on their
  cluster's mean; PointNet (3 + S -> c1/2, c1/2, c1/2) per point, a max over
  each cluster, the max scattered back and concatenated, PointNet (c1 ->
  c1, c1), a max over each cluster;
* the kNN fusion over the node_knn_k nearest nodes: three dense layers to
  c2/2, a max over the neighbours concatenated before each neighbour's row,
  two dense layers to c2, a max over the neighbours;
* the head (c1 + c2 -> 512 -> 256 -> 4): keypoint = node mean + offset,
  sigma = softplus + lower bound;
* the loss: the probabilistic chamfer between the two copies' keypoints
  (the source's moved by the ground-truth transform) plus alpha times each
  copy's keypoint-to-cloud distance; Adam.

The train step's random draws (node subsets and FPS seeds, augmentation,
ground-truth transform) are inputs: ``DetectorDraws`` below. The names of
the tensors are the published model's ``state_dict`` keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from benchmark.reference.common import (FP32, Precision, euler_rotation, fps,
                                        gather, layer, nearest, rotate,
                                        scatter_max, scatter_mean,
                                        smallest_k_idx, sqdist_blocked)

Tensor = torch.Tensor


class Sizes(NamedTuple):
    """The detector's widths and shapes, read from a configuration file."""
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


def sizes_from(config: dict) -> Sizes:
    """The sizes of a configuration file's ``sizes`` object."""
    s = config["sizes"]
    return Sizes(**{k: s[k] for k in Sizes._fields})


def param_shapes(z: Sizes) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every tensor of the detector: ``(name, shape, kind)`` with kind one
    of ``conv`` (He-normal init), ``head`` (N(0, 1e-4)), ``zero``, ``one``."""
    out = []

    def pw(name, cin, cout, dims, norm=True, head=False):
        out.append((name + ".conv.weight", (cout, cin) + (1,) * dims,
                    "head" if head else "conv"))
        out.append((name + ".conv.bias", (cout,), "zero"))
        if norm:
            out.extend([(name + ".norm.weight", (cout,), "one"),
                        (name + ".norm.bias", (cout,), "zero"),
                        (name + ".norm.running_mean", (cout,), "zero"),
                        (name + ".norm.running_var", (cout,), "one"),
                        (name + ".norm.num_batches_tracked", (), "count")])

    c1, c2, s = z.c1, z.c2, z.surface_normal_len
    cin = 3 + s
    for i in range(3):
        pw(f"first_pointnet.layers.{i}", cin, c1 // 2, 1, norm=i < 2)
        cin = c1 // 2
    cin = c1
    for i in range(2):
        pw(f"second_pointnet.layers.{i}", cin, c1, 1, norm=i < 1)
        cin = c1
    cin = 3 + c1
    for i in range(3):
        pw(f"knnlayer_1.layers_before.{i}", cin, c2 // 2, 2)
        cin = c2 // 2
    cin = c2
    for i in range(2):
        pw(f"knnlayer_1.layers_after.{i}", cin, c2, 2)
        cin = c2
    pw("mlp1", c1 + c2, 512, 1)
    pw("mlp2", 512, 256, 1)
    pw("mlp3", 256, 4, 1, norm=False, head=True)
    return out


def trainable(name: str) -> bool:
    """Parameters (not BatchNorm statistics)."""
    return not any(name.endswith(s) for s in
                   ("running_mean", "running_var", "num_batches_tracked"))


def forward(p: Dict[str, Tensor], z: Sizes, pc: Tensor, sn: Tensor,
            node: Tensor, train: bool, prec: Precision = FP32,
            stats: Optional[dict] = None) -> Tuple[Tensor, Tensor, Tensor]:
    """Anchors (node means), keypoints ``(B, M, 3)`` and sigmas ``(B, M)``
    of clouds ``pc (B, N, 3)``, ``sn (B, N, S)`` with nodes ``(B, M, 3)``.
    ``train``: BatchNorm over the batch (its statistics kept in
    ``stats``, where given), else its running statistics."""
    m = node.shape[1]
    with torch.no_grad():
        ids = torch.cat([
            prec.assignment_distances(
                sqdist_blocked(pc[:, i:i + 2048], node)).argmin(-1)
            for i in range(0, pc.shape[1], 2048)], dim=1)
    mean, counts = scatter_mean(pc, ids, m)
    occ = (counts > 0).float()[..., None]
    decentred = (pc - gather(mean, ids)).detach()
    x = torch.cat([decentred, sn], -1)
    for i in range(3):
        x = layer(p, f"first_pointnet.layers.{i}", x, train, prec,
                  norm=i < 2, relu=i < 2, stats=stats)
    n1 = scatter_max(x, ids, m) * occ
    x = torch.cat([x, gather(n1, ids)], -1)
    for i in range(2):
        x = layer(p, f"second_pointnet.layers.{i}", x, train, prec,
                  norm=i < 1, relu=i < 1, stats=stats)
    feat = scatter_max(x, ids, m) * occ                        # (B, M, c1)

    with torch.no_grad():
        nbr = smallest_k_idx(sqdist_blocked(mean, mean), z.node_knn_k)
    h = torch.cat([gather(mean, nbr) - mean[:, :, None, :],
                   gather(feat, nbr)], -1)                     # (B, M, K, 3+c1)
    for i in range(3):
        h = layer(p, f"knnlayer_1.layers_before.{i}", h, train, prec,
                  stats=stats)
    h = torch.cat([h.amax(-2, keepdim=True).expand_as(h), h], -1)
    for i in range(2):
        h = layer(p, f"knnlayer_1.layers_after.{i}", h, train, prec,
                  stats=stats)
    fused = h.amax(-2)                                         # (B, M, c2)

    y = torch.cat([feat, fused], -1)
    y = layer(p, "mlp1", y, train, stats=stats)
    y = layer(p, "mlp2", y, train, stats=stats)
    y = layer(p, "mlp3", y, train, norm=False, relu=False)
    keypoints = y[..., 0:3] + mean
    sigmas = torch.nn.functional.softplus(y[..., 3]) + z.sigma_lower_bound
    return mean, keypoints, sigmas


def sample_nodes(pc: Tensor, z: Sizes, subset: Tensor, first: Tensor
                 ) -> Tensor:
    """FPS of ``node_num`` nodes over the rows ``subset (B, sub)`` of
    ``pc``, from the seed rows ``first (B,)``."""
    sub = gather(pc, subset.to(pc.device))
    return gather(sub, fps(sub, first, z.node_num))


class DetectorDraws(NamedTuple):
    """Every random draw of one train step: node subsets ``(B, sub)`` and
    FPS seed rows ``(B,)`` of each copy; the shared augmentation's angles
    ``(B, 3)``, scale ``(B,)`` and the per-copy standard-normal jitter of
    ``(pc, sn, node)``; the ground-truth transform's angles, scale and
    shift."""
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


def prepare(z: Sizes, pc_parent: Tensor, sn_parent: Tensor,
            d: DetectorDraws):
    """The two copies of each parent cloud (its first and last
    ``input_pc_num`` rows, the rows being in random order), their nodes,
    the shared augmentation and the ground-truth transform of the second:
    ``(src (pc, sn, node), dst (pc, sn, node), (R, scale, shift))``."""
    n = z.input_pc_num
    pc, sn = pc_parent.float(), sn_parent.float()
    src = [pc[:, :n], sn[:, :n]]
    dst = [pc[:, -n:], sn[:, -n:]]
    src.append(sample_nodes(src[0], z, d.subset_src, d.first_src))
    dst.append(sample_nodes(dst[0], z, d.subset_dst, d.first_dst))
    R = euler_rotation(d.aug_angles)
    s_pc, c_pc = z.jitter_pc_sigma, z.jitter_pc_clip
    s_node, c_node = z.jitter_node_sigma, z.jitter_node_clip
    out = []
    for (p, s, nd), (j_pc, j_sn, j_node) in zip((src, dst), d.jitter):
        p, nd = rotate(p, R), rotate(nd, R)
        s = torch.cat([rotate(s[..., 0:3], R), s[..., 3:]], -1)
        p = p + (s_pc * j_pc).clamp(-c_pc, c_pc)
        s = s + (s_pc * j_sn).clamp(-c_pc, c_pc)
        nd = nd + (s_node * j_node).clamp(-c_node, c_node)
        scale = d.aug_scale[:, None, None]
        out.append([p * scale, s, nd * scale])
    G = euler_rotation(d.gt_angles)
    gs, gt = d.gt_scale[:, None, None], d.gt_shift[:, None, :]
    p, s, nd = out[1]
    out[1] = [rotate(p, G) * gs + gt,
              torch.cat([rotate(s[..., 0:3], G), s[..., 3:]], -1),
              rotate(nd, G) * gs + gt]
    return out[0], out[1], (G, gs, gt)


def loss(z: Sizes, src_out, dst_out, src_pc, dst_pc, gt) -> Tensor:
    """The probabilistic chamfer between the copies' keypoints plus alpha
    times the mean keypoint-to-cloud distance of each copy."""
    _, src_kp, src_sig = src_out
    _, dst_kp, dst_sig = dst_out
    on_src = nearest(src_kp, src_pc)[0].mean()
    on_dst = nearest(dst_kp, dst_pc)[0].mean()
    G, gs, gt_shift = gt
    src_t = rotate(src_kp, G) * gs + gt_shift
    fwd, fwd_idx = nearest(src_t, dst_kp)
    bwd, bwd_idx = nearest(dst_kp, src_t)
    s_fwd = (src_sig + dst_sig.gather(1, fwd_idx)) / 2.0
    s_bwd = (dst_sig + src_sig.gather(1, bwd_idx)) / 2.0
    chamfer = ((torch.log(s_fwd) + fwd / s_fwd).mean()
               + (torch.log(s_bwd) + bwd / s_bwd).mean())
    return chamfer + z.keypoint_on_pc_alpha * (on_src + on_dst)


def step_loss(p, z: Sizes, pc_parent: Tensor, sn_parent: Tensor,
              d: DetectorDraws, prec: Precision = FP32) -> Tensor:
    """One siamese step's loss: both copies through one train-mode forward
    over the concatenated batch."""
    src, dst, gt = prepare(z, pc_parent, sn_parent, d)
    b = src[0].shape[0]
    pc, sn, node = (torch.cat([a, c], 0) for a, c in zip(src, dst))
    out = forward(p, z, pc, sn, node, True, prec)
    return loss(z, tuple(t[:b] for t in out), tuple(t[b:] for t in out),
                src[0], dst[0], gt)


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8, no weight decay) on a dict of
    leaf tensors, in place."""

    def __init__(self, params: Dict[str, Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, Tensor], grads: Dict[str, Tensor]
             ) -> None:
        self.t += 1
        b1, b2 = 0.9, 0.999
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / c2).sqrt() + 1e-8
            params[k].sub_(self.lr * (self.m[k] / c1) / denom)


class TrainRecord(NamedTuple):
    """What the comparison reads of ``steps`` train steps: each step's
    loss, each leaf's first gradient, and each leaf's change after the
    last step."""
    losses: List[float]
    first_grads: Dict[str, Tensor]
    change: Dict[str, Tensor]


def train_steps(weights: Dict[str, Tensor], z: Sizes, batches, draws,
                prec: Precision = FP32) -> TrainRecord:
    """``len(batches)`` train steps from ``weights`` (not modified), batch
    ``(pc_parent, sn_parent)`` and ``DetectorDraws`` by step."""
    params = {k: v.detach().clone().float() for k, v in weights.items()
              if trainable(k)}
    start = {k: v.clone() for k, v in params.items()}
    opt = Adam(params, z.lr)
    losses, first = [], None
    for (pc, sn), d in zip(batches, draws):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        value = step_loss({**weights, **leaves}, z, pc, sn, d, prec)
        grads = torch.autograd.grad(value, list(leaves.values()))
        grads = dict(zip(leaves.keys(), grads))
        for v in params.values():
            v.requires_grad_(False)
        if first is None:
            first = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(value.detach()))
    return TrainRecord(losses, first,
                       {k: params[k] - start[k] for k in params})


@torch.no_grad()
def eval_forward(weights: Dict[str, Tensor], z: Sizes, pc: Tensor,
                 sn: Tensor, node: Tensor, prec: Precision = FP32,
                 block: int = 8, anchors: bool = False):
    """The eval forward's keypoints and sigmas (and, with ``anchors``, the
    node means the keypoints are offsets from), ``block`` clouds at a
    time."""
    p = {k: v.float() for k, v in weights.items()}
    outs = []
    for i in range(0, pc.shape[0], block):
        outs.append(forward(p, z, pc[i:i + block].float(),
                            sn[i:i + block].float(),
                            node[i:i + block].float(), False, prec))
    mean, kp, sig = (torch.cat([o[j] for o in outs]) for j in range(3))
    return (kp, sig, mean) if anchors else (kp, sig)


def he_std(shape) -> float:
    """He-normal's standard deviation for a kernel of ``shape`` (fan-in
    its second axis)."""
    return math.sqrt(2.0 / shape[1])
