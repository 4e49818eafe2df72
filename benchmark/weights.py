"""The cells' weights, made from the run's seed on the device in one draw,
and the port's configuration of a configuration file."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.detector import Sizes, he_std, param_shapes

# configuration file size -> the port's dotted config key
PORT_KEYS = {
    "input_pc_num": "data.input_pc_num",
    "parent_pc_num": "data.parent_pc_num",
    "node_num": "data.node_num",
    "fps_subsample_ratio": "data.fps_subsample_ratio",
    "c1": "detector.c1",
    "c2": "detector.c2",
    "node_knn_k": "detector.node_knn_k",
    "surface_normal_len": "detector.surface_normal_len",
    "sigma_lower_bound": "detector.sigma_lower_bound",
    "keypoint_on_pc_alpha": "loss.keypoint_on_pc_alpha",
    "batch_size": "train.batch_size",
    "lr": "train.lr",
    "bn_momentum": "train.bn_momentum",
    "compute_dtype": "detector.compute_dtype",
    "wire_dtype": "data.wire_dtype",
    "jitter_pc_sigma": "augment.jitter_pc_sigma",
    "jitter_pc_clip": "augment.jitter_pc_clip",
    "jitter_node_sigma": "augment.jitter_node_sigma",
    "jitter_node_clip": "augment.jitter_node_clip",
    "descriptor_len": "descriptor.descriptor_len",
    "ball_radius": "descriptor.ball_radius",
    "ball_nsamples": "descriptor.ball_nsamples",
    "ball_compute_dtype": "descriptor.ball_compute_dtype",
    "descriptor_compute_dtype": "descriptor.compute_dtype",
    "triple_loss_gamma": "loss.triple_loss_gamma",
    "sigma_max": "loss.sigma_max",
    "positive_radius": "data.positive_radius",
    "negative_radius": "data.negative_radius",
}


def port_config(config: dict, **extra):
    """The port's ``Config`` of a configuration file: its preset and role,
    with every size of the file set (so the file, not the preset, says
    what runs), then ``extra`` dotted keys."""
    from usip_tpu_torch.config import get_config
    sizes = config["sizes"]
    overrides = {PORT_KEYS[k]: v for k, v in sizes.items() if k in PORT_KEYS}
    overrides.update(extra)
    return get_config(config["preset"], role=config["role"], **overrides)


def seed_words(seed: int, role: int) -> int:
    """A 63-bit generator seed, a fixed function of the run's seed and a
    role (weights, draws, ...)."""
    w = np.random.SeedSequence([seed, role]).generate_state(2, np.uint32)
    return (int(w[0]) << 31) ^ int(w[1])


def make_tensors(shapes, seed: int, role: int, device, head: str
                 ) -> Dict[str, torch.Tensor]:
    """Tensors of ``shapes`` (``(name, shape, kind)``) from ``seed``:
    He-normal kernels and zero biases, BatchNorm at its initial values, a
    ``head`` kernel N(0, 1e-4) (``head='init'``) or He-normal (``'he'``);
    the kernels from one draw on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed_words(seed, role))
    drawn = [(n, s, k) for n, s, k in shapes if k in ("conv", "head")]
    total = sum(int(np.prod(s)) for _, s, _ in drawn)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in shapes:
        if kind in ("conv", "head"):
            size = int(np.prod(shape))
            std = 1e-4 if kind == "head" and head == "init" else he_std(shape)
            out[name] = flat[off:off + size].view(shape) * std
            off += size
        elif kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            fill = 1.0 if kind == "one" else 0.0
            out[name] = torch.full(shape, fill, device=device)
    return out


def detector_weights(z: Sizes, seed: int, device, head: str = "init"
                     ) -> Dict[str, torch.Tensor]:
    """The detector's tensors from ``seed``: the initialisers training
    starts from (``head='init'``: the head's last kernel N(0, 1e-4)), or
    with that kernel He-normal too (``head='he'``: a detector whose
    keypoints and sigmas depend on its features, standing for trained
    weights)."""
    return make_tensors(param_shapes(z), seed, 1, device, head)


@torch.no_grad()
def serving_detector_weights(z: Sizes, seed: int, device, clouds: int = 4
                             ) -> Dict[str, torch.Tensor]:
    """A detector standing for trained weights: ``head='he'`` kernels, and
    each BatchNorm's running statistics those of a train-mode forward
    (the fp32 reference's) over ``clouds`` scans made from the seed, with
    random nodes; so that each layer's eval output is normalised, as in a
    trained checkpoint, and the keypoints' offsets and the sigmas come out
    in metres and units whatever the seed."""
    from benchmark.data.kitti_scans import scan_pool
    from benchmark.reference.detector import forward
    w = detector_weights(z, seed, device, head="he")
    scans = scan_pool(seed_words(seed, 7), clouds, z.parent_pc_num)
    rng = np.random.default_rng(seed_words(seed, 8))
    rows = np.stack([rng.permutation(z.parent_pc_num)[:z.input_pc_num]
                     for _ in range(clouds)])
    picked = torch.from_numpy(np.take_along_axis(scans, rows[..., None], 1))
    picked = picked.to(device)
    pc, sn = picked[..., :3], picked[..., 3:3 + z.surface_normal_len]
    stats: dict = {}
    forward(w, z, pc, sn, pc[:, :z.node_num], True, stats=stats)
    for name, (mean, var) in stats.items():
        w[name + ".norm.running_mean"] = mean
        w[name + ".norm.running_var"] = var
    return w


def descriptor_weights(d, seed: int, device) -> Dict[str, torch.Tensor]:
    """The descriptor's tensors from ``seed``: its initialisers."""
    from benchmark.reference.descriptor import param_shapes as desc_shapes
    return make_tensors(desc_shapes(d), seed, 6, device, "he")
