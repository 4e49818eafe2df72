"""Detector and descriptor weights: reference-named ``state_dict``s for the
port.

* ``state_dict_from_jax`` maps a usip_tpu variables tree (as numpy arrays,
  ``{'params': ..., 'batch_stats': ...}``) of either detector trunk family
  or of the descriptor (lite or global) onto the port's ``state_dict``;
* ``load_detector_weights`` / ``load_descriptor_weights`` read a reference
  ``.pth`` (what the reference saves, ``<epoch>_net_detector.pth``, with the
  ``nn.DataParallel`` prefix where it has one), the port's ``.pt``
  checkpoint or a usip_tpu ``.msgpack``;
* ``seeded_state_dict`` / ``seeded_descriptor_state_dict`` make random
  weights from a seed, with nontrivial BatchNorm statistics, for tests and
  the on-card smoke run.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from usip_tpu_torch.config import DescriptorConfig, DetectorConfig

# the kNN-fusion layer and the head, shared by both trunk families
_SHARED_LAYOUT = (
    ("knnlayer_1.layers_before.0", "knnlayer", "before0", 2),
    ("knnlayer_1.layers_before.1", "knnlayer", "before1", 2),
    ("knnlayer_1.layers_before.2", "knnlayer", "before2", 2),
    ("knnlayer_1.layers_after.0", "knnlayer", "after0", 2),
    ("knnlayer_1.layers_after.1", "knnlayer", "after1", 2),
    ("mlp1", "head", "mlp1", 1),
    ("mlp2", "head", "mlp2", 1),
    ("mlp3", "head", "mlp3", 1),
)
# (reference module path, usip_tpu module, usip_tpu layer or None for a
# top-level layer, conv kernel dims): RPN_Detector's SOM trunk ...
DETECTOR_LAYOUT = (
    ("first_pointnet.layers.0", "first_pointnet", "layer0", 1),
    ("first_pointnet.layers.1", "first_pointnet", "layer1", 1),
    ("first_pointnet.layers.2", "first_pointnet", "layer2", 1),
    ("second_pointnet.layers.0", "second_pointnet", "layer0", 1),
    ("second_pointnet.layers.1", "second_pointnet", "layer1", 1),
) + _SHARED_LAYOUT
# ... and RPN_Detector_KNN / RPN_Detector_Ball's grouped trunk conv1..5,
# whose state_dict keys are identical for knn and ball
GROUP_DETECTOR_LAYOUT = tuple(
    (f"conv{i}", f"conv{i}", None, 2) for i in range(1, 6)) + _SHARED_LAYOUT
# DescriptorLiteOld's conv1..5, and DescriptorLiteOldGlobal's fc1..3 on top
DESCRIPTOR_LAYOUT = tuple(
    (f"conv{i}", f"conv{i}", None, 2) for i in range(1, 6))
DESCRIPTOR_GLOBAL_LAYOUT = DESCRIPTOR_LAYOUT + tuple(
    (f"fc{i}", f"fc{i}", None, 1) for i in range(1, 4))


def jax_layout(params: Mapping):
    """The layout of a usip_tpu variables tree: the SOM detector, the
    grouped (knn/ball) detector, or the descriptor, lite or global; as
    ``usip_tpu.train.torch_import``'s exporters tell them apart."""
    if "knnlayer" not in params:
        return (DESCRIPTOR_GLOBAL_LAYOUT if "fc1" in params
                else DESCRIPTOR_LAYOUT)
    return (DETECTOR_LAYOUT if "first_pointnet" in params
            else GROUP_DETECTOR_LAYOUT)


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """usip_tpu detector or descriptor variables -> the port's
    ``state_dict``; which model it is, is read from the tree
    (``jax_layout``)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    layout = jax_layout(params)
    out: Dict[str, torch.Tensor] = {}
    for src, module, layer, dims in layout:
        p = params[module] if layer is None else params[module][layer]
        kern = np.asarray(p["dense"]["kernel"], np.float32).T
        out[f"{src}.conv.weight"] = torch.tensor(
            kern.reshape(kern.shape + (1,) * dims))
        out[f"{src}.conv.bias"] = torch.tensor(
            np.asarray(p["dense"]["bias"], np.float32))
        if "norm" in p:
            s = (stats[module] if layer is None else stats[module][layer])
            for key, value in (("weight", p["norm"]["scale"]),
                               ("bias", p["norm"]["bias"]),
                               ("running_mean", s["norm"]["mean"]),
                               ("running_var", s["norm"]["var"])):
                out[f"{src}.norm.{key}"] = torch.tensor(
                    np.asarray(value, np.float32))
            out[f"{src}.norm.num_batches_tracked"] = torch.tensor(0)
    return out


def detector_family(state_dict: Mapping) -> str:
    """``'som'`` for an RPN_Detector ``state_dict``, ``'group'`` for the
    RPN_Detector_KNN / RPN_Detector_Ball family (``conv1..5``; knn and ball
    have the same keys, the config's ``detector.grouping`` tells them
    apart)."""
    return "group" if f"{GROUP_DETECTOR_LAYOUT[0][0]}.conv.weight" in \
        state_dict else "som"


def load_detector_weights(path: str) -> Dict[str, torch.Tensor]:
    """A reference-named ``state_dict`` (a detector's or a descriptor's)
    from a checkpoint file: a
    usip_tpu ``.msgpack`` (its parameters and BatchNorm statistics), the
    port's own ``.pt`` (its ``"model"`` entry) or a reference ``.pth``, with
    the ``nn.DataParallel`` ``module.`` prefix stripped when every key has
    it."""
    if path.endswith(".msgpack"):
        from usip_tpu_torch.train.checkpoint import state_dict_from_msgpack
        return state_dict_from_msgpack(path)[0]
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in sd and isinstance(sd["model"], Mapping):
        sd = sd["model"]
    if sd and all(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    return sd


# a descriptor's files are read alike: the layout is the file's own
load_descriptor_weights = load_detector_weights


def _seeded(names_shapes, seed: int, head: Optional[str]
            ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out: Dict[str, np.ndarray] = {}
    for name, shape in names_shapes:
        if name.endswith("num_batches_tracked"):
            out[name] = np.asarray(0, np.int64)
            continue
        if name.endswith("conv.weight"):
            std = (0.05 if head and name.startswith(head)
                   else np.sqrt(2.0 / shape[1]))
            v = rng.normal(0.0, std, shape)
        elif name.endswith("norm.weight"):
            v = 1.0 + rng.normal(0.0, 0.1, shape)
        elif name.endswith("norm.running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # conv.bias, norm.bias, norm.running_mean
            v = rng.normal(0.0, 0.1, shape)
        out[name] = v.astype(np.float32)
    return out


def seeded_state_dict(cfg: DetectorConfig, seed: int) -> Dict[str, np.ndarray]:
    """Random detector weights in the reference layout, as numpy arrays.

    He-normal kernels, small random biases, BatchNorm scale 1 + N(0, 0.1^2),
    bias N(0, 0.1^2), running mean N(0, 0.1^2), running var U(0.5, 1.5). The
    ``mlp3`` kernel is N(0, 0.05^2) instead of the training init N(0, 1e-4),
    so that keypoint offsets depend on the trunk and a parity check on them
    is not trivially satisfied by ``keypoints ~= anchors``.
    """
    from usip_tpu_torch.models.detector import Detector
    return _seeded(((n, tuple(t.shape)) for n, t in
                    Detector(cfg).state_dict().items()), seed, "mlp3.")


def seeded_descriptor_state_dict(cfg: DescriptorConfig, seed: int
                                 ) -> Dict[str, np.ndarray]:
    """Random descriptor weights in the reference layout, as numpy arrays,
    drawn as ``seeded_state_dict`` draws a detector's (He-normal kernels,
    no narrower last layer)."""
    from usip_tpu_torch.models.descriptor import Descriptor
    return _seeded(((n, tuple(t.shape)) for n, t in
                    Descriptor(cfg).state_dict().items()), seed, None)


def tp_params_from_jax(cfg, variables: Mapping, n_shards: int,
                       rank: Optional[int] = None):
    """usip_tpu detector variables cut for ``n_shards`` tensor-parallel
    ranks (``parallel.tensor_parallel.shard_tp_params``'s ``(tp, rp)``:
    every rank's stacks, or ``rank``'s blocks): the port's own full
    ``state_dict`` of them, then its cut."""
    from usip_tpu_torch.models import Detector
    from usip_tpu_torch.parallel.tensor_parallel import shard_tp_params
    model = Detector(cfg.detector)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return shard_tp_params(cfg, model, n_shards, rank)
