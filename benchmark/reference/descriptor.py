"""The USIP keypoint descriptor (lijx10/USIP ``models/networks.py``
``DescriptorLiteOld``) with its ball query, its scan triplet train step on
keypoints of a frozen detector, and its eval forward, in plain PyTorch fp32
(TF32 off) over a dict of named tensors.

* Ball query: for each keypoint, the points within ``ball_radius`` in the
  order of one random priority a point (the published code permutes the
  cloud once a forward), the first ``ball_nsamples``, a short ball padded by
  repeating its points cyclically, an empty ball all point 0.
* Per ball: ``[xyz - keypoint, sn]`` through dense layers to d/4, d/2, d,
  the ball's max concatenated after each row, a dense layer to d, one more
  (no norm, no activation), the max over the ball, L2 normalisation.
* Scan triplet (``models/losses.py``): for each anchor keypoint, the
  smallest descriptor distance to the positive scan's minus that to the
  negative scan's plus gamma, clamped at 0, weighted by ``sigma_max -
  sigma`` normalised to mean 1 (detached); the mean. The anchor and the
  positive pass the descriptor in turn, each with its own batch
  statistics.

The frozen detector is ``benchmark.reference.detector``'s eval forward
(``detector_stage``). The train steps take its keypoints and sigmas as an
input: the reference checks that stage on its own and follows the
descriptor's steps from the keypoints the program's detector gave, since
a ball's members at its rim change with the last bits of its centre.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from benchmark.reference import detector as det
from benchmark.reference.common import (FP32, Precision, gather, layer,
                                        sqdist)

Tensor = torch.Tensor


class DescSizes(NamedTuple):
    """The descriptor's widths and its loss's constants."""
    descriptor_len: int
    ball_radius: float
    ball_nsamples: int
    surface_normal_len: int
    triple_loss_gamma: float
    sigma_max: float
    lr: float


def desc_sizes_from(config: dict) -> DescSizes:
    s = config["sizes"]
    return DescSizes(**{k: s[k] for k in DescSizes._fields})


def param_shapes(d: DescSizes) -> List[Tuple[str, Tuple[int, ...], str]]:
    """Every tensor of the descriptor: ``(name, shape, kind)``."""
    out = []
    n = d.descriptor_len
    cin = 3 + d.surface_normal_len
    widths = [(cin, n // 4), (n // 4, n // 2), (n // 2, n), (2 * n, n),
              (n, n)]
    for i, (a, b) in enumerate(widths):
        name = f"conv{i + 1}"
        out.append((name + ".conv.weight", (b, a, 1, 1), "conv"))
        out.append((name + ".conv.bias", (b,), "zero"))
        if i < 4:
            out.extend([(name + ".norm.weight", (b,), "one"),
                        (name + ".norm.bias", (b,), "zero"),
                        (name + ".norm.running_mean", (b,), "zero"),
                        (name + ".norm.running_var", (b,), "one"),
                        (name + ".norm.num_batches_tracked", (), "count")])
    return out


def ball_query(pc: Tensor, centres: Tensor, priority: Tensor, radius: float,
               k: int, prec: Precision = FP32, block: int = 64) -> Tensor:
    """``(B, M, k)`` indices: each centre's in-radius points by ascending
    priority (ties to the lowest index), cyclically padded, 0 for an empty
    ball. Distances and priorities are compared as ``prec`` says (the
    configuration's bf16, or the control's float8)."""
    pri = prec.ball_values(priority.float())[:, None, :]
    r2 = float(prec.ball_values(torch.tensor(radius * radius)))
    out = []
    for i in range(0, centres.shape[1], block):
        sq = prec.ball_values(sqdist(centres[:, i:i + block], pc))
        scores = torch.where(sq <= r2, pri, torch.inf)
        vals, idx = torch.sort(scores, dim=-1, stable=True)
        if k > scores.shape[-1]:
            pad = k - scores.shape[-1]
            vals = torch.nn.functional.pad(vals, (0, pad), value=torch.inf)
            idx = torch.nn.functional.pad(idx, (0, pad),
                                          value=scores.shape[-1] - 1)
        vals, idx = vals[..., :k], idx[..., :k]
        found = torch.isfinite(vals)
        counts = found.sum(-1, keepdim=True)
        slot = torch.arange(k, device=pc.device)
        wrapped = torch.where(found, slot, slot % counts.clamp_min(1))
        idx = torch.gather(idx, -1, wrapped)
        out.append(torch.where(counts > 0, idx, 0))
    return torch.cat(out, dim=1)


def group(pc: Tensor, sn: Tensor, kp: Tensor, priority: Tensor,
          d: DescSizes, prec: Precision = FP32) -> Tensor:
    """Ball features ``(B, M, K, 3 + S)``: ``[xyz - keypoint, sn]``."""
    idx = ball_query(pc.detach(), kp.detach(), priority, d.ball_radius,
                     d.ball_nsamples, prec)
    g = gather(torch.cat([pc, sn], -1), idx)
    return torch.cat([g[..., 0:3] - kp[:, :, None, :], g[..., 3:]], -1)


def describe(p: Dict[str, Tensor], feats: Tensor, train: bool,
             prec: Precision = FP32) -> Tensor:
    """Ball features -> unit descriptors ``(B, M, d)``."""
    h = feats
    for i in range(3):
        h = layer(p, f"conv{i + 1}", h, train, prec)
    h = torch.cat([h, h.amax(-2, keepdim=True).expand_as(h)], -1)
    h = layer(p, "conv4", h, train, prec)
    y = layer(p, "conv5", h, train, norm=False, relu=False).amax(-2)
    sq = y.square().sum(-1, keepdim=True)
    pos = sq > 0
    norm = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    return y / (norm + 1e-5)


def _dist(a: Tensor, b: Tensor) -> Tensor:
    """Euclidean distances ``(B, M, N)`` of descriptor rows, with a zero
    gradient where a distance is 0."""
    sq = sqdist(a, b)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def scan_loss(anc: Tensor, pos: Tensor, neg: Tensor, anc_sig: Tensor,
              d: DescSizes) -> Tensor:
    """The sigma-weighted scan triplet, averaged."""
    before = (_dist(anc, pos).amin(2) - _dist(anc, neg).amin(2)
              + d.triple_loss_gamma)
    w = (d.sigma_max - anc_sig).clamp_min(0.0)
    w = (w / w.mean(dim=1, keepdim=True).clamp_min(1e-8)).detach()
    return (w * before.clamp_min(0.0)).mean()


class DescriptorDraws(NamedTuple):
    """One descriptor step's draws: the node subsets ``(B, sub)`` and FPS
    seed rows ``(B,)`` of the anchor and positive clouds, and each cloud's
    ball priorities ``(B, N)``."""
    subset_anc: Tensor
    first_anc: Tensor
    subset_pos: Tensor
    first_pos: Tensor
    ball_anc: Tensor
    ball_pos: Tensor


def detector_stage(detector_weights, z: det.Sizes, x: Tensor,
                   dr: DescriptorDraws, prec: Precision = FP32):
    """The frozen detector's keypoints, sigmas and node means of both
    clouds of the packed pair ``x (B, 2, N, 3 + S)`` (eval forward, one
    call over the anchors then the positives)."""
    x = x.float()
    anc_pc, anc_sn = x[:, 0, :, :3], x[:, 0, :, 3:]
    pos_pc, pos_sn = x[:, 1, :, :3], x[:, 1, :, 3:]
    anc_node = det.sample_nodes(anc_pc, z, dr.subset_anc, dr.first_anc)
    pos_node = det.sample_nodes(pos_pc, z, dr.subset_pos, dr.first_pos)
    return det.eval_forward(
        detector_weights, z, torch.cat([anc_pc, pos_pc]),
        torch.cat([anc_sn, pos_sn]), torch.cat([anc_node, pos_node]),
        prec, block=2 * x.shape[0], anchors=True)


def step_loss(p, d: DescSizes, x: Tensor, neg_idx: Tensor,
              dr: DescriptorDraws, kp: Tensor, sig: Tensor,
              prec: Precision = FP32) -> Tensor:
    """One descriptor step's loss from the packed pair ``x (B, 2, N, 3 +
    S)`` and the frozen detector's keypoints ``kp (2B, M, 3)`` and sigmas
    ``(2B, M)`` of its anchors then positives: the two ball groupings, the
    descriptor on the anchor then on the positive, the scan triplet
    against the anchors at ``neg_idx``."""
    x = x.float()
    anc_pc, anc_sn = x[:, 0, :, :3], x[:, 0, :, 3:]
    pos_pc, pos_sn = x[:, 1, :, :3], x[:, 1, :, 3:]
    b = x.shape[0]
    kp, sig = kp.float(), sig.float()
    anc_desc = describe(p, group(anc_pc, anc_sn, kp[:b], dr.ball_anc, d,
                                 prec), True, prec)
    pos_desc = describe(p, group(pos_pc, pos_sn, kp[b:], dr.ball_pos, d,
                                 prec), True, prec)
    neg = anc_desc[neg_idx.long().to(anc_desc.device)]
    return scan_loss(anc_desc, pos_desc, neg, sig[:b], d)


def train_steps(weights: Dict[str, Tensor], d: DescSizes, batches, draws,
                keypoints, prec: Precision = FP32) -> det.TrainRecord:
    """``len(batches)`` descriptor train steps from ``weights``; a batch
    is ``(x, neg_idx)``, ``keypoints`` the frozen detector's ``(kp,
    sigma)`` of each step."""
    params = {k: v.detach().clone().float() for k, v in weights.items()
              if det.trainable(k)}
    start = {k: v.clone() for k, v in params.items()}
    opt = det.Adam(params, d.lr)
    losses, first = [], None
    for (x, neg_idx), dr, (kp, sig) in zip(batches, draws, keypoints):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        value = step_loss({**weights, **leaves}, d, x, neg_idx, dr, kp, sig,
                          prec)
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
def eval_describe(weights: Dict[str, Tensor], d: DescSizes, pc: Tensor,
                  sn: Tensor, kp: Tensor, priority: Tensor,
                  prec: Precision = FP32) -> Tensor:
    """Descriptors ``(B, M, d)`` of keypoints ``kp (B, M, 3)`` of clouds
    ``pc``, ``sn`` with ball priorities ``(B, N)``, running statistics."""
    p = {k: v.float() for k, v in weights.items()}
    return describe(p, group(pc.float(), sn.float(), kp.float(), priority, d,
                             prec), False, prec)
