"""Detector weights: reference-named ``state_dict``s for the port.

* ``state_dict_from_jax`` maps a usip_tpu variables tree (as numpy arrays,
  ``{'params': ..., 'batch_stats': ...}``) onto the port's ``state_dict``;
* ``load_detector_weights`` reads a reference ``.pth`` (what the reference
  saves, ``<epoch>_net_detector.pth``);
* ``seeded_state_dict`` makes random weights from a seed, with nontrivial
  BatchNorm statistics, for tests and the on-card smoke run.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from usip_tpu_torch.config import DetectorConfig

# (reference module path, usip_tpu module, usip_tpu layer, conv kernel dims)
DETECTOR_LAYOUT = (
    ("first_pointnet.layers.0", "first_pointnet", "layer0", 1),
    ("first_pointnet.layers.1", "first_pointnet", "layer1", 1),
    ("first_pointnet.layers.2", "first_pointnet", "layer2", 1),
    ("second_pointnet.layers.0", "second_pointnet", "layer0", 1),
    ("second_pointnet.layers.1", "second_pointnet", "layer1", 1),
    ("knnlayer_1.layers_before.0", "knnlayer", "before0", 2),
    ("knnlayer_1.layers_before.1", "knnlayer", "before1", 2),
    ("knnlayer_1.layers_before.2", "knnlayer", "before2", 2),
    ("knnlayer_1.layers_after.0", "knnlayer", "after0", 2),
    ("knnlayer_1.layers_after.1", "knnlayer", "after1", 2),
    ("mlp1", "head", "mlp1", 1),
    ("mlp2", "head", "mlp2", 1),
    ("mlp3", "head", "mlp3", 1),
)


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """usip_tpu SOM-detector variables -> the port's ``state_dict``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}
    for src, module, layer, dims in DETECTOR_LAYOUT:
        p = params[module][layer]
        kern = np.asarray(p["dense"]["kernel"], np.float32).T
        out[f"{src}.conv.weight"] = torch.tensor(
            kern.reshape(kern.shape + (1,) * dims))
        out[f"{src}.conv.bias"] = torch.tensor(
            np.asarray(p["dense"]["bias"], np.float32))
        if "norm" in p:
            s = stats[module][layer]["norm"]
            for key, value in (("weight", p["norm"]["scale"]),
                               ("bias", p["norm"]["bias"]),
                               ("running_mean", s["mean"]),
                               ("running_var", s["var"])):
                out[f"{src}.norm.{key}"] = torch.tensor(
                    np.asarray(value, np.float32))
            out[f"{src}.norm.num_batches_tracked"] = torch.tensor(0)
    return out


def load_detector_weights(path: str) -> Dict[str, torch.Tensor]:
    """A reference-named detector ``state_dict`` from a ``.pth`` file, with
    the ``nn.DataParallel`` ``module.`` prefix stripped when every key has it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


def seeded_state_dict(cfg: DetectorConfig, seed: int) -> Dict[str, np.ndarray]:
    """Random detector weights in the reference layout, as numpy arrays.

    He-normal kernels, small random biases, BatchNorm scale 1 + N(0, 0.1^2),
    bias N(0, 0.1^2), running mean N(0, 0.1^2), running var U(0.5, 1.5). The
    ``mlp3`` kernel is N(0, 0.05^2) instead of the training init N(0, 1e-4),
    so that keypoint offsets depend on the trunk and a parity check on them
    is not trivially satisfied by ``keypoints ~= anchors``.
    """
    from usip_tpu_torch.models.detector import Detector

    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, t in Detector(cfg).state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            out[name] = np.asarray(0, np.int64)
            continue
        if name.endswith("conv.weight"):
            std = 0.05 if name.startswith("mlp3.") else np.sqrt(2.0 / shape[1])
            v = rng.normal(0.0, std, shape)
        elif name.endswith("norm.weight"):
            v = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name.endswith("norm.running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # conv.bias, norm.bias, norm.running_mean
            v = rng.normal(0.0, 0.1, shape)
        out[name] = v.astype(np.float32)
    return out
