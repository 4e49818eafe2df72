"""Channel-sharded (tensor-parallel) detector (counterpart of
``usip_tpu/parallel/tensor_parallel.py``).

The FLOP-dominant stages, the kNN-fusion block and the head, are cut over
the ranks of a ``channels`` mesh, Megatron-style:

* a column-parallel layer holds the kernel's column block ``W[:, j w:(j +
  1) w]`` and its bias and BatchNorm slices, and makes this rank's channel
  block of the activation (normalisation and activation stay local);
* a row-parallel layer takes a channel block with the kernel's row block,
  and one all-reduce rebuilds the full output, after which its bias and
  BatchNorm run replicated;
* column -> row pairs need one collective a pair.

``shard_tp_params`` cuts the weights; a rank keeps only its blocks
(``rank=``). The SOM trunk runs replicated. ``tensor_parallel_detector_
forward`` is the eval forward. ``shard_state_tp`` makes the trainable form
(``TPDetector``: this rank's blocks as parameters, their Adam state cut
alike), which ``make_tp_train_step`` trains: the detector's train step with
the TP model's gradient reduction and norm (usip_tpu jits its step with
``tp_state_sharding``'s layouts); on a ``data x channels`` grid
(``make_dp_tp_mesh``) with the data mesh as the step's.

In fp32 the result is the one-device model's up to the all-reduce's
summation order; in bf16 each row block's partial product is rounded
before the sum, so bf16 agrees approximately (the partial sums are added in
fp32 here).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from usip_tpu_torch.config import Config
from usip_tpu_torch.models.detector import Detector, compute_dtype, knn_group
from usip_tpu_torch.nn.layers import BatchNorm, activation_fn
from usip_tpu_torch.parallel.collectives import (all_reduce_grads, psum,
                                                 pvary)
from usip_tpu_torch.parallel.mesh import Mesh, make_grid, make_mesh
from usip_tpu_torch.train.state import TrainState, make_adam

Tensor = torch.Tensor

# fusion-block and head layers whose channels are cut (the trunk's widths
# are small); usip_tpu's names
TP_LAYER_NAMES = frozenset({"before0", "before1", "before2", "after0",
                            "after1", "mlp1", "mlp2"})
# usip_tpu's layer name -> the port's module path, and its form
_LAYERS = (("before0", "knnlayer_1.layers_before.0", "col"),
           ("before1", "knnlayer_1.layers_before.1", "row"),
           ("before2", "knnlayer_1.layers_before.2", "col"),
           ("after0", "knnlayer_1.layers_after.0", "row"),
           ("after1", "knnlayer_1.layers_after.1", "col"),
           ("mlp1", "mlp1", "row"),
           ("mlp2", "mlp2", "col"),
           ("mlp3", "mlp3", "row"))


def make_channel_mesh(num_devices: Optional[int] = None,
                      device="cuda") -> Mesh:
    """The 1-D ``channels`` mesh over every rank."""
    return make_mesh(num_devices, device)


def make_dp_tp_mesh(dp: int, tp: int, device="cuda") -> Tuple[Mesh, Mesh]:
    """A ``data x channels`` grid over ``dp * tp`` ranks: this rank's
    ``(data mesh, channel mesh)``."""
    return make_grid(dp, tp, device)


def _layer(model: Detector, path: str):
    mod = model
    for part in path.split("."):
        mod = getattr(mod, part)
    return mod


def _detector_cfg(cfg):
    """The detector section of a ``Config`` (or a ``DetectorConfig``)."""
    return getattr(cfg, "detector", cfg)


def _check_widths(cfg, d: int) -> None:
    dcfg = _detector_cfg(cfg)
    for width, what in ((dcfg.c2 // 2, "c2/2"), (dcfg.c1, "c1"),
                        (512, "head mlp1"), (256, "head mlp2")):
        if width % d:
            raise AssertionError(f"{what}={width} not divisible by {d} "
                                 "shards")


def shard_tp_params(cfg, model: Detector, n_shards: int,
                    rank: Optional[int] = None):
    """The fusion-block and head weights of ``model`` (``cfg`` its
    ``Config`` or ``DetectorConfig``) cut for ``n_shards`` ranks:
    ``(tp, rp)``, ``tp`` the cut tensors, ``rp`` the row layers' bias and
    BatchNorm, whole. With ``rank=None`` every ``tp`` entry is the stack
    ``(n_shards, ...)`` of all ranks' blocks (usip_tpu's layout); with a
    rank, that rank's block only. Kernels are ``(Cin, Cout)``; names as
    usip_tpu's (``before0_w``, ``after0_wmax``/``_wh``, ``mlp1_wf``/``_wk``,
    ``*_b``, BatchNorm ``*_s``/``*_sb``/``*_m``/``*_v``)."""
    dcfg = _detector_cfg(cfg)
    d = n_shards
    _check_widths(dcfg, d)
    c1, c2h = dcfg.c1, dcfg.c2 // 2
    pick = (lambda t: t) if rank is None else (lambda t: t[rank])
    tp, rp = {}, {}
    splits = {"after0": (("max", c2h), ("h", c2h)),
              "mlp1": (("f", c1), ("k", dcfg.c2))}
    with torch.no_grad():
        for key, path, form in _LAYERS:
            layer = _layer(model, path)
            w = layer.conv.kernel().detach()                   # (Cin, Cout)
            vecs = {"b": layer.conv.bias}
            if layer.norm is not None:
                vecs.update(s=layer.norm.weight, sb=layer.norm.bias,
                            m=layer.norm.running_mean,
                            v=layer.norm.running_var)
            if form == "col":
                cin, cout = w.shape
                tp[key + "_w"] = pick(w.reshape(cin, d, cout // d)
                                      .permute(1, 0, 2).contiguous())
                for f, v in vecs.items():
                    tp[f"{key}_{f}"] = pick(v.detach().reshape(d, -1))
                continue
            parts = splits.get(key, (("", w.shape[0]),))
            off = 0
            for part, width in parts:
                block = w[off:off + width]
                tp[f"{key}_w{part}"] = pick(block.reshape(
                    d, width // d, block.shape[1]))
                off += width
            for f, v in vecs.items():
                rp[f"{key}_{f}"] = v.detach()
    return tp, rp


def _bn(y: Tensor, p: Dict[str, Tensor], key: str) -> Tensor:
    y32 = (y.float() - p[key + "_m"]) * torch.rsqrt(p[key + "_v"] + 1e-5)
    return (y32 * p[key + "_s"] + p[key + "_sb"]).to(y.dtype)


@torch.no_grad()
def tensor_parallel_detector_forward(mesh: Mesh, cfg: Config,
                                     model: Detector, pc: Tensor,
                                     sn: Tensor, node: Tensor,
                                     tp_params=None
                                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """The SOM detector's eval forward with the fusion block's and the
    head's channels cut over ``mesh``: ``(anchors, keypoints, sigmas)``,
    replicated. ``tp_params``: this rank's ``shard_tp_params(cfg, model,
    mesh.size, mesh.rank)``, passed by serving loops that cut once."""
    dcfg = cfg.detector
    if dcfg.grouping != "som":
        raise AssertionError("TP forward implemented for the som detector")
    d, i = mesh.size, mesh.rank
    dt = compute_dtype(dcfg) or torch.float32
    act = activation_fn(dcfg.activation)
    model.eval()
    anchors, feat = model.trunk(pc, sn, node)
    h0 = knn_group(anchors, anchors, feat, dcfg.node_knn_k)
    tp, rp = tp_params if tp_params is not None \
        else shard_tp_params(cfg, model, d, i)

    def col(key, x, cdt=dt):
        y = x.to(cdt) @ tp[key + "_w"].to(cdt) + tp[key + "_b"].to(cdt)
        return act(_bn(y, tp, key))

    def row(key, partial, linear=False):
        y = (psum(partial.float(), mesh).to(partial.dtype)
             + rp[key + "_b"].to(partial.dtype))
        return y if linear else act(_bn(y, rp, key))

    # the fusion block honours compute_dtype; the head is fp32
    h = col("before0", h0)
    h = row("before1", h.to(dt) @ tp["before1_w"].to(dt))
    h = col("before2", h)
    h_max = h.amax(dim=-2, keepdim=True)
    y = row("after0", h_max.to(dt) @ tp["after0_wmax"].to(dt)
            + h.to(dt) @ tp["after0_wh"].to(dt))
    y = col("after1", y)
    knn_loc = y.amax(dim=-2).float()
    w1 = dcfg.c1 // d
    y = row("mlp1", feat[..., i * w1:(i + 1) * w1] @ tp["mlp1_wf"]
            + knn_loc @ tp["mlp1_wk"])
    y = col("mlp2", y, torch.float32)
    y4 = row("mlp3", y @ tp["mlp3_w"], linear=True).float()
    keypoints = y4[..., 0:3] + anchors
    sigmas = torch.nn.functional.softplus(y4[..., 3]) + dcfg.sigma_lower_bound
    return anchors, keypoints, sigmas


# ---------------------------------------------------- tensor-parallel training --

class _ColLayer(nn.Module):
    """This rank's column block of a PointwiseLayer: kernel ``(Cin,
    Cout/d)``, bias and BatchNorm slices."""

    def __init__(self, w: Tensor, b: Tensor, norm: Optional[Dict[str, Tensor]]):
        super().__init__()
        self.w = nn.Parameter(w.clone())
        self.b = nn.Parameter(b.clone())
        self.norm = None
        if norm is not None:
            self.norm = BatchNorm(w.shape[1])
            _load_bn(self.norm, norm)

    def forward(self, x: Tensor, dtype, act) -> Tensor:
        y = x.to(dtype) @ self.w.to(dtype) + self.b.to(dtype)
        return act(self.norm(y)) if self.norm is not None else y


class _RowLayer(nn.Module):
    """This rank's row blocks of a PointwiseLayer's kernel (one a part of
    its virtual concat), its bias and BatchNorm whole (replicated)."""

    def __init__(self, blocks: Dict[str, Tensor], b: Tensor,
                 norm: Optional[Dict[str, Tensor]]):
        super().__init__()
        self.w = nn.ParameterDict({k or "w": nn.Parameter(v.clone())
                                   for k, v in blocks.items()})
        self.b = nn.Parameter(b.clone())
        self.norm = None
        if norm is not None:
            self.norm = BatchNorm(b.shape[0])
            _load_bn(self.norm, norm)

    def forward(self, parts, dtype, act, mesh: Mesh) -> Tensor:
        partial = None
        for key, x in parts:
            t = x.to(dtype) @ self.w[key or "w"].to(dtype)
            partial = t if partial is None else partial + t
        y = psum(partial.float(), mesh).to(dtype) + self.b.to(dtype)
        return act(self.norm(y)) if self.norm is not None else y


def _load_bn(bn: BatchNorm, p: Dict[str, Tensor]) -> None:
    with torch.no_grad():
        bn.weight.copy_(p["s"])
        bn.bias.copy_(p["sb"])
        bn.running_mean.copy_(p["m"])
        bn.running_var.copy_(p["v"])


class TPDetector(nn.Module):
    """The SOM detector with the fusion block and head cut over ``mesh``:
    the trunk whole (replicated), this rank's column and row blocks. Its
    forward (train or eval mode) is ``Detector``'s: ``(anchors, keypoints,
    sigmas)``, replicated over the channels; ``make_tp_train_step`` trains
    it. The replicated inputs of the column layers pass ``pvary``, so the
    trunk's gradients are whole on every rank."""

    def __init__(self, model: Detector, mesh: Mesh):
        super().__init__()
        cfg = model.cfg
        if cfg.grouping != "som":
            raise AssertionError("TP training implemented for the som "
                                 "detector")
        self.cfg = cfg
        self.mesh = mesh
        self.first_pointnet = model.first_pointnet
        self.second_pointnet = model.second_pointnet
        tp, rp = shard_tp_params(cfg, model, mesh.size, mesh.rank)
        layers = {}
        for key, _, form in _LAYERS:
            def vec(src, f):
                return src.get(f"{key}_{f}")
            norm = None
            src = tp if form == "col" else rp
            if vec(src, "s") is not None:
                norm = {f: vec(src, f) for f in ("s", "sb", "m", "v")}
            if form == "col":
                layers[key] = _ColLayer(tp[key + "_w"], tp[key + "_b"], norm)
            else:
                blocks = {k[len(key) + 2:]: v for k, v in tp.items()
                          if k.startswith(key + "_w")}
                layers[key] = _RowLayer(blocks, rp[key + "_b"], norm)
        self.tp = nn.ModuleDict(layers).to(next(model.parameters()).device)

    som_trunk = Detector.som_trunk

    def _is_cut(self, name: str) -> bool:
        """Whether parameter ``name`` is this rank's block (else whole on
        every rank)."""
        parts = name.split(".")
        return parts[0] == "tp" and (
            isinstance(self.tp[parts[1]], _ColLayer) or parts[2] == "w")

    @torch.no_grad()
    def reduce_grads(self, data_mesh: Optional[Mesh] = None) -> None:
        """The train step's gradient reduction: the whole parameters'
        gradients averaged over the channel ranks (each holds the whole
        gradient already; the replicated trunk's backward scatter-adds
        sum in an order that varies on the card, and the average keeps the
        replicas bit-identical), then every gradient summed over
        ``data_mesh``."""
        whole = [p for n, p in self.named_parameters()
                 if p.grad is not None and not self._is_cut(n)]
        all_reduce_grads(whole, self.mesh)
        for p in whole:
            p.grad.div_(self.mesh.size)
        all_reduce_grads(self.parameters(), data_mesh)

    def grad_norm(self) -> Tensor:
        """The gradient's global norm over every rank's blocks (the train
        step's ``grad_norm``): the cut blocks' squares summed over the
        ranks, the whole (replicated) parameters' counted once."""
        cut, whole = [], []
        for name, p in self.named_parameters():
            if p.grad is None:
                continue
            g2 = p.grad.float().square().sum()
            (cut if self._is_cut(name) else whole).append(g2)
        total = psum(torch.stack(cut).sum(), self.mesh) if cut \
            else torch.zeros(())
        if whole:
            total = total + torch.stack(whole).sum()
        return total.sqrt()

    def forward(self, pc: Tensor, sn: Tensor, node: Tensor,
                bn_momentum: Optional[float] = None
                ) -> Tuple[Tensor, Tensor, Tensor]:
        from usip_tpu_torch.nn.layers import set_bn_momentum
        if bn_momentum is not None:
            set_bn_momentum(self, bn_momentum)
        cfg, mesh, L = self.cfg, self.mesh, self.tp
        dt = compute_dtype(cfg) or torch.float32
        f32 = torch.float32
        act = activation_fn(cfg.activation)
        anchors, feat = self.som_trunk(pc, sn, node)
        h0 = pvary(knn_group(anchors, anchors, feat, cfg.node_knn_k), mesh)
        h = L["before0"](h0, dt, act)
        h = L["before1"]([("", h)], dt, act, mesh)
        h = L["before2"](pvary(h, mesh), dt, act)
        y = L["after0"]([("max", h.amax(dim=-2, keepdim=True)), ("h", h)],
                        dt, act, mesh)
        y = L["after1"](pvary(y, mesh), dt, act)
        knn_loc = y.amax(dim=-2).float()
        w1 = cfg.c1 // mesh.size
        i = mesh.rank
        feat_loc = pvary(feat, mesh)[..., i * w1:(i + 1) * w1]
        y = L["mlp1"]([("f", feat_loc), ("k", knn_loc)], f32, act, mesh)
        y = L["mlp2"](pvary(y, mesh), f32, act)
        y4 = L["mlp3"]([("", y)], f32, lambda x: x, mesh).float()
        keypoints = y4[..., 0:3] + anchors
        sigmas = (torch.nn.functional.softplus(y4[..., 3])
                  + cfg.sigma_lower_bound)
        return anchors, keypoints, sigmas


def make_tp_train_step(cfg: Config, data_mesh: Optional[Mesh] = None):
    """The detector's train step (``train.steps.make_detector_train_step``)
    for a ``shard_state_tp`` state: ``TPDetector.reduce_grads`` over the
    channel ranks and ``data_mesh``, ``TPDetector.grad_norm`` over every
    rank's blocks."""
    from usip_tpu_torch.train.steps import make_detector_train_step
    return make_detector_train_step(
        cfg, data_mesh, reduce_grads=TPDetector.reduce_grads,
        grad_norm=TPDetector.grad_norm)


def tp_state_sharding(mesh: Mesh, state: TrainState) -> Dict[str, Optional[int]]:
    """For each entry of the one-device model's ``state_dict``, the
    dimension that ``shard_state_tp`` cuts over ``mesh``'s channels (None:
    whole on every rank): a column layer's conv weight on its output
    channels (dim 0), its bias and BatchNorm alike; a row layer's conv
    weight on its input channels (dim 1), its bias and BatchNorm whole. The
    Adam moments follow their parameters. (usip_tpu's GSPMD layout cuts
    every TP layer's output channels and lets XLA place the collectives;
    the port's row layers are Megatron's.)"""
    del mesh
    forms = {path: form for key, path, form in _LAYERS
             if key in TP_LAYER_NAMES}
    out = {}
    for name in state.model.state_dict():
        layer, kind = name.rsplit(".", 2)[0], name.split(".")[-2]
        form = forms.get(layer)
        cut = None
        if form == "col" and not name.endswith("num_batches_tracked"):
            cut = 0
        elif form == "row" and kind == "conv" and name.endswith("weight"):
            cut = 1
        out[name] = cut
    return out


def shard_state_tp(mesh: Mesh, state: TrainState) -> TrainState:
    """``state`` (a SOM ``Detector`` and its Adam) laid out over ``mesh``'s
    channels: a ``TPDetector`` holding this rank's blocks and an Adam over
    them, carrying ``state``'s moments cut alike where it has taken steps
    (usip_tpu's ``shard_state_tp``). The step count carries over."""
    tp_model = TPDetector(state.model, mesh)
    lr = state.optimizer.param_groups[0]["lr"]
    opt = make_adam(tp_model.parameters(), lr)
    if state.optimizer.state:
        _cut_adam(state, tp_model, opt, mesh)
    return TrainState(tp_model, opt, state.step)


def _cut_adam(state: TrainState, tp_model: TPDetector, opt, mesh: Mesh
              ) -> None:
    """Cut the Adam moments of ``state``'s parameters into ``tp_model``'s,
    by the parameters' own cut (a shadow model holding the moments)."""
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        shadow = Detector(state.model.cfg)
        with torch.no_grad():
            for p, q in zip(state.model.parameters(), shadow.parameters()):
                st = state.optimizer.state.get(p)
                q.copy_(st[key] if st else torch.zeros_like(p))
        moments[key] = TPDetector(shadow.to(next(
            state.model.parameters()).device), mesh)
    step_t = next(iter(state.optimizer.state.values()))["step"]
    for p, m1, m2 in zip(tp_model.parameters(),
                         moments["exp_avg"].parameters(),
                         moments["exp_avg_sq"].parameters()):
        opt.state[p] = {"step": step_t.clone(),
                        "exp_avg": m1.detach().clone(),
                        "exp_avg_sq": m2.detach().clone()}


__all__ = ["TP_LAYER_NAMES", "TPDetector",
           "make_channel_mesh", "make_dp_tp_mesh", "make_tp_train_step",
           "shard_state_tp",
           "shard_tp_params", "tensor_parallel_detector_forward",
           "tp_state_sharding"]
