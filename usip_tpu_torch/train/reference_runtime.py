"""Run the reference PyTorch implementation on the CPU beside the port
(counterpart of ``usip_tpu/train/reference_runtime.py``).

The port's networks use the reference's ``state_dict`` names, so the
reference's own ``RPN_Detector`` / ``DescriptorLiteOld`` (imported from a
reference checkout, when one is on disk) load the port's weights as they
are, and ``detector_side_by_side`` runs both forwards on one input.

The reference hardcodes its CUDA extensions
(``index_max.forward_cuda_shared_mem``, networks.py:117-133;
``ball_query.forward_cuda_shared_mem``, networks.py:355-359) but the
surrounding ``torch.cuda.device(tensor.get_device())`` context is a no-op for
CPU tensors (device index -1), so pure-torch shims installed under those
module names make the unmodified reference runnable without a GPU:

  * index_max: scatter-argmax with the CUDA kernel's first-argmax tie rule
    (strictly-greater update while scanning ascending n,
    index_max_cuda.cu:9-25); empty (node, channel) cells return index 0 like
    the zero-initialized kernel output.
  * ball_query: "first K points with dist <= radius in scan order", cyclic
    padding, all-zero row when the ball is empty (ball_query_cuda.cu:10-49).

Nothing here imports a reference checkout at import time.
"""

from __future__ import annotations

import importlib
import os
import sys
import types
from typing import Any, Dict, Optional

import numpy as np
import torch


def index_max_forward(data, index, m: int):
    """Shim for ``index_max.forward_*``: (B, C, N) data + (B, N) int cluster
    ids -> (B, C, M) int32 index of the first argmax point per (cluster,
    channel). Matches the CUDA kernel's strict-> update rule (first argmax)
    and its zero-initialized output for empty cells."""
    data = data.detach()
    b, c, n = data.shape
    idx = index.long().unsqueeze(1).expand(b, c, n)
    seg = torch.full((b, c, m), float("-inf"), dtype=data.dtype)
    seg = seg.scatter_reduce(2, idx, data, reduce="amax", include_self=True)
    at_max = data >= seg.gather(2, idx)
    pos = torch.arange(n).view(1, 1, n).expand(b, c, n)
    cand = torch.where(at_max, pos, torch.full_like(pos, n))
    first = torch.full((b, c, m), n, dtype=torch.long)
    first = first.scatter_reduce(2, idx, cand, reduce="amin", include_self=True)
    return torch.where(first == n, torch.zeros_like(first), first).int()


def ball_query_forward(dist, radius: float, k: int):
    """Shim for ``ball_query.forward_cuda_shared_mem``: (B, M, N) distances ->
    (B, M, K) indices of the first K in-ball points in scan order, cyclically
    padded; all-zero row for empty balls (ball_query_cuda.cu:22-46)."""
    b, m, n = dist.shape
    within = dist <= radius
    order = torch.arange(n).view(1, 1, n).expand(b, m, n)
    key = torch.where(within, order, torch.full_like(order, n))
    sel = torch.sort(key, dim=2).values[:, :, :k]  # first K scan-order indices
    counts = within.sum(2, keepdim=True)  # (B, M, 1)
    slot = torch.arange(k).view(1, 1, k).expand(b, m, k)
    take = torch.where(counts > 0, slot % counts.clamp(min=1),
                       torch.zeros_like(slot))
    first_k = torch.gather(sel, 2, take)
    return torch.where(counts > 0, first_k, torch.zeros_like(first_k)).int()


def install_extension_shims() -> None:
    """Register pure-torch ``index_max`` / ``ball_query`` modules so the
    reference's module-level imports (networks.py:17-18) resolve on CPU."""
    im = types.ModuleType("index_max")
    im.forward_cpu = index_max_forward
    im.forward_multi_thread_cpu = index_max_forward
    im.forward_cuda = index_max_forward
    im.forward_cuda_shared_mem = index_max_forward
    bq = types.ModuleType("ball_query")
    bq.forward_cuda_shared_mem = ball_query_forward
    bq.forward_cuda = ball_query_forward
    sys.modules.setdefault("index_max", im)
    sys.modules.setdefault("ball_query", bq)
    # unused-at-forward-time heavyweight imports in the reference tree
    # (util/som.py imports torchvision; util/visualizer.py imports visdom).
    # Only stub what genuinely isn't importable: a stub would otherwise
    # shadow a real installed package for the rest of the process.
    for name in ("torchvision", "visdom"):
        if name in sys.modules:
            continue
        try:
            importlib.import_module(name)
        except ImportError:
            sys.modules[name] = types.ModuleType(name)


def load_reference_networks(reference_root: str):
    """Import ``models.networks`` from a reference checkout (read-only).

    Installs the extension shims, forces a headless matplotlib backend, and
    puts the checkout on sys.path. Returns the imported module."""
    if not os.path.isdir(os.path.join(reference_root, "models")):
        raise FileNotFoundError(f"no reference checkout at {reference_root}")
    os.environ.setdefault("MPLBACKEND", "Agg")
    install_extension_shims()
    if reference_root not in sys.path:
        sys.path.insert(0, reference_root)
    return importlib.import_module("models.networks")


def make_reference_opt(cfg, **overrides: Any):
    """The argparse-style ``opt`` namespace the reference networks read (the
    subset of */options_detector.py consumed at forward time) from the
    port's Config."""
    ns = types.SimpleNamespace(
        surface_normal_len=cfg.detector.surface_normal_len,
        activation=cfg.detector.activation,
        normalization=cfg.detector.normalization,
        bn_momentum=0.1,
        bn_momentum_decay_step=None,
        bn_momentum_decay=0.6,
        k=cfg.detector.k,
        node_knn_k_1=cfg.detector.node_knn_k,
        node_num=cfg.data.node_num,
        input_pc_num=cfg.data.input_pc_num,
        loss_sigma_lower_bound=cfg.detector.sigma_lower_bound,
        descriptor_len=cfg.descriptor.descriptor_len,
        ball_radius=cfg.descriptor.ball_radius,
        ball_nsamples=cfg.descriptor.ball_nsamples,
    )
    for k, v in overrides.items():
        setattr(ns, k, v)
    return ns


def _load(net, state_dict: Optional[Dict[str, torch.Tensor]]):
    if state_dict is not None:
        net.load_state_dict({k: v.detach().cpu() for k, v in
                             state_dict.items()}, strict=True)
    return net.eval()


def build_reference_detector(cfg, reference_root: str,
                             state_dict: Optional[Dict[str, torch.Tensor]]
                             = None):
    """The reference detector of ``cfg.detector.grouping`` on the CPU:
    ``RPN_Detector`` (som), ``RPN_Detector_KNN`` (knn, networks.py:482-608)
    or ``RPN_Detector_Ball`` (ball, networks.py:611-738; the released
    Oxford BALL-16384-512-r2k64-k16 model's net), holding ``state_dict``
    (the port's detector's, strict) where given."""
    networks = load_reference_networks(reference_root)
    cls = {"som": networks.RPN_Detector,
           "knn": networks.RPN_Detector_KNN,
           "ball": networks.RPN_Detector_Ball}[cfg.detector.grouping]
    return _load(cls(make_reference_opt(cfg)), state_dict)


def build_reference_descriptor(cfg, reference_root: str,
                               state_dict: Optional[Dict[str, torch.Tensor]]
                               = None):
    """The reference ``DescriptorLiteOld`` on the CPU, holding
    ``state_dict`` (the port's descriptor's, strict) where given."""
    networks = load_reference_networks(reference_root)
    return _load(networks.DescriptorLiteOld(make_reference_opt(cfg)),
                 state_dict)


def load_reference_export_fns(reference_root: str):
    """The reference export tool's post-processing, ``nms`` (greedy
    sigma-ascending suppression, save_keypoints.py:180-216) and
    ``ensure_keypoint_number`` (random subsample / pad-from-cloud,
    :219-227), as callables running the reference's own code.

    ``evaluation/save_keypoints.py`` runs heavy module-level code at import
    (matplotlib TkAgg, per-dataset option parsing, ``import PCLKeypoint``),
    so the two pure functions are extracted from its AST and run in a
    minimal numpy namespace instead. Returns ``(nms,
    ensure_keypoint_number)``."""
    import ast

    path = os.path.join(reference_root, "evaluation", "save_keypoints.py")
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    wanted = {"nms", "ensure_keypoint_number"}
    module = ast.Module(
        body=[n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name in wanted],
        type_ignores=[])
    ns: dict = {"np": np}
    exec(compile(module, path, "exec"), ns)  # noqa: S102 - read-only checkout
    missing = wanted - ns.keys()
    if missing:
        raise RuntimeError(f"functions {missing} not found in {path}")
    return ns["nms"], ns["ensure_keypoint_number"]


def detector_side_by_side(cfg, reference_root: str, model, pc, sn, node
                          ) -> Dict[str, Any]:
    """The reference detector holding ``model``'s weights and ``model``
    itself (the port's, eval mode) on one input, both on the CPU: ``pc (B,
    N, 3)``, ``sn (B, N, S)``, ``node (B, M, 3)`` numpy. Returns each side's
    ``(anchors, keypoints, sigmas)`` channels-last and the largest
    difference of each."""
    net = build_reference_detector(cfg, reference_root, model.state_dict())
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float32))
    model = model.eval()
    with torch.no_grad():
        r_anchor, r_kp, r_sg, _ = net(t(pc).transpose(1, 2),
                                      t(sn).transpose(1, 2),
                                      t(node).transpose(1, 2),
                                      is_train=False, epoch=None)
        dev = next(model.parameters()).device
        ours = model(t(pc).to(dev), t(sn).to(dev), t(node).to(dev))
    ref = (r_anchor.transpose(1, 2).numpy(), r_kp.transpose(1, 2).numpy(),
           r_sg.numpy())
    port = tuple(x.float().cpu().numpy() for x in ours)
    return {"reference": ref, "port": port,
            "max_abs_diff": {name: float(np.abs(a - b).max()) for name, a, b
                             in zip(("anchors", "keypoints", "sigmas"),
                                    port, ref)}}
