"""Point-sharded detector training (counterpart of
``usip_tpu/parallel/sharded_train.py``): gradients and BatchNorm statistics
over a cloud whose N axis is cut over the ranks of a ``points`` mesh.

The trunk runs on each rank's shard: the assignment (the min/argmin
kernel), the cluster sums and counts all-reduced, the PointNets with
BatchNorm synchronised over every rank that holds part of the batch, the
node max a local masked scatter-max (the scatter-max kernel; nodes empty on
this rank set to -inf) combined over the ranks. The node part (kNN fusion,
head), the chamfer loss and the optimizer run on the replicated node
tensors. On a 2-D ``data x points`` grid (``make_grid``) the batch is also
cut over the data axis: the node part's BatchNorm synchronises over it and
the losses gather it.

Gradients: the trunk's parameters act on each rank's points, so their
gradients are summed over every rank; the node part's act on replicated
tensors over the points axis, so theirs are summed over the data axis only
(``parallel/collectives.py``'s rule).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from usip_tpu_torch import losses
from usip_tpu_torch.config import Config
from usip_tpu_torch.nn.layers import (bn_momentum_schedule, set_bn_momentum,
                                      set_bn_process_group)
from usip_tpu_torch.ops import assign_points_to_nodes, scatter_back
from usip_tpu_torch.ops.geometry import apply_se3
from usip_tpu_torch.ops.segment import masked_scatter_max
from usip_tpu_torch.parallel.collectives import (all_gather, all_gather_stack,
                                                 all_reduce_grads, pmax, psum,
                                                 pvary)
from usip_tpu_torch.parallel.mesh import Mesh, world_size
from usip_tpu_torch.parallel.sharded_ops import sharded_single_side_chamfer
from usip_tpu_torch.train.state import TrainState

Tensor = torch.Tensor


def _grid_mesh(mesh: Mesh, data_mesh: Optional[Mesh]) -> Mesh:
    """The ranks that hold part of the batch: the points mesh, or every
    rank of a ``data x points`` grid."""
    if data_mesh is None:
        return mesh
    return Mesh(None, tuple(range(world_size())), mesh.device)


def _check_trunk(cfg: Config) -> None:
    dcfg = cfg.detector
    if dcfg.grouping != "som":
        raise NotImplementedError(
            "sharded_trunk_apply implements the som trunk only (point->node "
            f"argmin + scatter-max); got grouping={dcfg.grouping!r}. Use the "
            "unsharded Detector for knn/ball variants.")
    if dcfg.k != 1:
        raise NotImplementedError(
            "sharded_trunk_apply hardcodes k=1 nearest-node assignment; got "
            f"detector.k={dcfg.k}. The released configs all use k=1 "
            "(SURVEY §5.6); the k=3 averaging path is unsharded-only.")


def _node_max(f: Tensor, ids: Tensor, m: int, local_counts: Tensor,
              occ: Tensor, mesh: Mesh, backend: str) -> Tensor:
    """Every node's channel max over all ranks' points: the local masked
    scatter-max (the kernel writes 0 to a node empty on this rank, which
    would beat negative features elsewhere, so such nodes become -inf),
    then the max over the ranks (gathered and reduced where a gradient is
    wanted, an all-reduce MAX otherwise); nodes empty everywhere are 0."""
    local = masked_scatter_max(f, ids, m, backend)
    local = torch.where(local_counts[..., None] > 0, local,
                        torch.full_like(local, -torch.inf))
    if torch.is_grad_enabled() and f.requires_grad:
        out = all_gather_stack(local, mesh).amax(dim=0)
    else:
        out = pmax(local, mesh)
    return torch.where(torch.isneginf(out), torch.zeros_like(out), out) * occ


def sharded_trunk_apply(mesh: Mesh, cfg: Config, model, pc: Tensor,
                        sn: Tensor, node: Tensor, train: bool,
                        bn_momentum: float = 0.1,
                        data_mesh: Optional[Mesh] = None
                        ) -> Tuple[Tensor, Tensor]:
    """The SOM trunk of ``model`` (a ``Detector``) with ``pc (B, n, 3)``,
    ``sn (B, n, S)`` this rank's shards of the cloud and ``node (B, M, 3)``
    replicated: ``(anchors (B, M, 3), node features (B, M, C1))``,
    replicated over the points axis. In train mode the PointNets'
    BatchNorm uses the statistics of every rank's points and updates the
    running statistics in place (usip_tpu returns them)."""
    _check_trunk(cfg)
    dcfg = cfg.detector
    m = node.shape[1]
    group = _grid_mesh(mesh, data_mesh)
    pc_sg, node_sg = pc.detach(), node.detach()
    ids = assign_points_to_nodes(pc_sg, node_sg).ids          # (B, n)
    b = pc.shape[0]
    sums = torch.zeros((b, m, 3), dtype=pc_sg.dtype, device=pc.device)
    sums.scatter_add_(1, ids[..., None].expand(-1, -1, 3), pc_sg)
    local_counts = torch.zeros((b, m), dtype=torch.float32, device=pc.device)
    local_counts.scatter_add_(1, ids, torch.ones_like(ids, dtype=torch.float32))
    counts = psum(local_counts, mesh)
    mean = psum(sums, mesh) / (counts[..., None] + 1e-5)
    occ = (counts > 0).float()[..., None]

    decentered = pc_sg - scatter_back(mean, ids)
    x_aug = (torch.cat([decentered, sn], dim=-1) if dcfg.surface_normal_len
             else decentered)
    pointnets = (model.first_pointnet, model.second_pointnet)
    for net in pointnets:
        net.train(train)
        if train:
            set_bn_momentum(net, bn_momentum)
            set_bn_process_group(net, group)
    f1 = model.first_pointnet(x_aug).float()
    n1 = _node_max(f1, ids, m, local_counts, occ, mesh, dcfg.scatter_backend)
    s1 = scatter_back(pvary(n1, mesh), ids)
    f2 = model.second_pointnet(torch.cat([f1, s1], dim=-1)).float()
    n2 = _node_max(f2, ids, m, local_counts, occ, mesh, dcfg.scatter_backend)
    return mean, n2


def sharded_detector_apply(mesh: Mesh, cfg: Config, model, pc: Tensor,
                           sn: Tensor, node: Tensor, train: bool = False,
                           bn_momentum: float = 0.1,
                           data_mesh: Optional[Mesh] = None
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """The whole detector (trainable) with the cloud sharded on N:
    ``(anchors, keypoints, sigmas)``, replicated over the points axis. The
    node part runs layered (train-mode BatchNorm over ``data_mesh``'s
    rows where there is one)."""
    anchors, feat = sharded_trunk_apply(mesh, cfg, model, pc, sn, node,
                                        train, bn_momentum, data_mesh)
    for part in (model.knnlayer_1, model.mlp1, model.mlp2, model.mlp3):
        part.train(train)
        if train:
            set_bn_momentum(part, bn_momentum)
            set_bn_process_group(part, data_mesh)
    knn_feat = model.knnlayer_1(anchors, anchors, feat)
    keypoints, sigmas = model.keypoint_head(
        torch.cat([feat, knn_feat], dim=-1), anchors)
    return anchors, keypoints, sigmas


def _split_grads(model, mesh: Mesh, data_mesh: Optional[Mesh]) -> None:
    """Sum the trunk's gradients over every rank holding part of the
    batch and the node part's over the data axis."""
    trunk = [p for net in (model.first_pointnet, model.second_pointnet)
             for p in net.parameters()]
    ids = {id(p) for p in trunk}
    all_reduce_grads(trunk, _grid_mesh(mesh, data_mesh))
    all_reduce_grads([p for p in model.parameters() if id(p) not in ids],
                     data_mesh)


def make_sharded_detector_train_step(cfg: Config, mesh: Mesh,
                                     data_mesh: Optional[Mesh] = None):
    """The point-sharded siamese train step::

        step(state, src_pc, src_sn, src_node, dst_pc, dst_sn, dst_node,
             gt_R, gt_scale, gt_shift, epoch) -> metrics

    with the clouds this rank's shards (and, on a ``data x points`` grid,
    this rank's batch rows of everything), already augmented, nodes
    sampled upstream (usip_tpu's signature). Forward, the chamfer and
    on-cloud losses, backward and Adam; updates ``state`` in place."""

    def step(state: TrainState, src_pc, src_sn, src_node, dst_pc, dst_sn,
             dst_node, gt_R, gt_scale, gt_shift, epoch):
        model, opt = state.model, state.optimizer
        momentum = bn_momentum_schedule(
            cfg.train.bn_momentum, epoch, cfg.train.bn_momentum_decay_step,
            cfg.train.bn_momentum_decay)
        opt.zero_grad(set_to_none=True)
        b = src_pc.shape[0]
        _, kp, sig = sharded_detector_apply(
            mesh, cfg, model, torch.cat([src_pc, dst_pc]),
            torch.cat([src_sn, dst_sn]), torch.cat([src_node, dst_node]),
            train=True, bn_momentum=momentum, data_mesh=data_mesh)
        s_kp, d_kp, s_sig, d_sig = kp[:b], kp[b:], sig[:b], sig[b:]
        alpha = cfg.loss.keypoint_on_pc_alpha
        on_s = sharded_single_side_chamfer(mesh, s_kp, src_pc)
        on_d = sharded_single_side_chamfer(mesh, d_kp, dst_pc)
        gt = (gt_R, gt_scale, gt_shift)
        if data_mesh is not None:
            s_kp, d_kp, s_sig, d_sig, on_s, on_d = (
                all_gather(t, data_mesh) for t in (s_kp, d_kp, s_sig, d_sig,
                                                   on_s, on_d))
            gt = tuple(all_gather(t, data_mesh) for t in gt)
        chamfer = losses.chamfer_probabilistic(apply_se3(s_kp, *gt), d_kp,
                                               s_sig, d_sig)
        on_pc = (on_s.mean() + on_d.mean()) * alpha
        total = chamfer.loss + on_pc
        total.backward()
        _split_grads(model, mesh, data_mesh)
        opt.step()
        state.step += 1
        return {"loss": total.detach(), "chamfer": chamfer.loss.detach(),
                "chamfer_pure": chamfer.chamfer_pure,
                "keypoint_on_pc": on_pc.detach()}

    return step


def make_sharded_descriptor_train_step(cfg: Config, mesh: Mesh,
                                       use_cgf: bool = False):
    """The point-sharded descriptor train step::

        step(state, detector, anc_pc, anc_sn, anc_node, pos_pc, pos_sn,
             pos_node, neg_idx, priorities, epoch, height=None) -> metrics

    The frozen detector's sharded eval forward gives the keypoints; the
    ball grouping runs over the sharded clouds (``sharded_ball_gather``,
    ``priorities = (anchor's, positive's)`` this rank's shards of the
    ``(B, N)`` priorities, usip_tpu's ``jax.random.uniform`` draws);
    Oxford's height scale (``height (B,)``, where the preset has it) scales
    clouds and keypoints; the descriptor's layers, the scan triplet
    (negatives ``anc_desc[neg_idx]``), backward and Adam run on the
    replicated ball features, whose BatchNorm statistics are global by
    construction. The CGF objective is refused, as in usip_tpu."""
    from usip_tpu_torch.parallel.sharded_descriptor import (
        describe_from_ball_feats)
    from usip_tpu_torch.parallel.sharded_ops import sharded_ball_gather

    if use_cgf:
        raise NotImplementedError(
            "sharded descriptor training implements the outdoor scan-triplet "
            "objective; the CGF/indoor preset operates on small fragments "
            "that do not need point sharding — use the unsharded step")
    dcfg = cfg.descriptor

    def balls(pc, sn, kp, priority):
        x_aug = torch.cat([pc, sn], dim=-1) if dcfg.surface_normal_len \
            else pc
        feats, _, _ = sharded_ball_gather(mesh, kp.detach(), pc.detach(),
                                          x_aug.detach(), dcfg.ball_radius,
                                          dcfg.ball_nsamples, priority)
        return torch.cat([feats[..., 0:3] - kp[:, :, None, :],
                          feats[..., 3:]], dim=-1)

    def step(state: TrainState, detector, anc_pc, anc_sn, anc_node, pos_pc,
             pos_sn, pos_node, neg_idx, priorities, epoch, height=None):
        b = anc_pc.shape[0]
        with torch.no_grad():
            _, kp, sig = sharded_detector_apply(
                mesh, cfg, detector, torch.cat([anc_pc, pos_pc]),
                torch.cat([anc_sn, pos_sn]), torch.cat([anc_node, pos_node]),
                train=False)
        anc_kp, pos_kp, anc_sig = kp[:b], kp[b:], sig[:b]
        if cfg.augment.height_scale:
            from usip_tpu_torch.data.augment import random_height_scale
            if height is None:
                raise ValueError("augment.height_scale: pass the height "
                                 "scales (B,)")
            anc_pc, pos_pc, anc_kp, pos_kp = random_height_scale(
                [anc_pc, pos_pc, anc_kp, pos_kp], axis=1, scale=height)
        ball_a = balls(anc_pc, anc_sn, anc_kp, priorities[0])
        ball_p = balls(pos_pc, pos_sn, pos_kp, priorities[1])
        model, opt = state.model, state.optimizer
        momentum = bn_momentum_schedule(
            cfg.train.bn_momentum, epoch, cfg.train.bn_momentum_decay_step,
            cfg.train.bn_momentum_decay)
        opt.zero_grad(set_to_none=True)
        anc_desc, _ = describe_from_ball_feats(cfg, model, ball_a, True,
                                               momentum)
        pos_desc, _ = describe_from_ball_feats(cfg, model, ball_p, True,
                                               momentum)
        neg_desc = anc_desc[neg_idx.to(anc_desc.device).long()]
        loss_bm, active = losses.desc_pair_scan_loss(
            anc_desc, pos_desc, neg_desc, anc_sig,
            gamma=cfg.loss.triple_loss_gamma, sigma_max=cfg.loss.sigma_max)
        total = loss_bm.mean()
        total.backward()
        from usip_tpu_torch.train.steps import global_norm
        metrics = {"loss": total.detach(), "active_percentage": active.mean(),
                   "sigma_mean": anc_sig.mean(),
                   "grad_norm": global_norm(p.grad for p in
                                            model.parameters())}
        opt.step()
        state.step += 1
        return metrics

    return step

