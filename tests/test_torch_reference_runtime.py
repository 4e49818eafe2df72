"""The port's reference runtime (``usip_tpu_torch.train.reference_runtime``)
against usip_tpu's, on the CPU.

The pure-torch shims of the reference's CUDA extensions give usip_tpu's
shims' indices exactly, on random inputs with ties (integer-valued data and
distances) and on empty cells and balls; the ``opt`` namespaces agree; the
shims install under the extensions' module names. With a reference
checkout named by ``USIP_REFERENCE`` the reference's own ``RPN_Detector``
holding the port's weights runs side by side with the port's detector;
where the variable is unset or names no checkout, that test skips.
"""

import os
import sys

import numpy as np
import pytest
import torch

from usip_tpu.config import get_config as jax_get_config
from usip_tpu.train import reference_runtime as jax_rr
from usip_tpu_torch.config import get_config
from usip_tpu_torch.models import Detector
from usip_tpu_torch.train import reference_runtime as rr
from usip_tpu_torch.weights import seeded_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = os.environ.get("USIP_REFERENCE", "")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_max_shim_equals_usip_tpu(seed):
    """Integer data (ties everywhere: first argmax), more clusters than ids
    in use (empty cells -> index 0)."""
    rng = np.random.default_rng(seed)
    data = torch.as_tensor(rng.integers(-3, 4, (2, 8, 200)).astype(
        np.float32))
    ids = torch.as_tensor(rng.integers(0, 12, (2, 200)).astype(np.int32))
    for m in (12, 16):
        ours = rr.index_max_forward(data, ids, m)
        ref = jax_rr.index_max_forward(data, ids, m)
        assert ours.dtype == ref.dtype == torch.int32
        assert torch.equal(ours, ref)
    empty = set(range(16)) - set(ids[0].tolist())
    assert empty and all((rr.index_max_forward(data, ids, 16)[0, :, e] == 0)
                         .all() for e in empty)


@pytest.mark.parametrize("seed", [0, 1])
def test_ball_query_shim_equals_usip_tpu(seed):
    """Distances on a grid (ties at the radius), balls past K, short of it
    (cyclic padding) and empty (all-zero rows)."""
    rng = np.random.default_rng(seed)
    dist = torch.as_tensor(rng.integers(0, 40, (2, 10, 300)).astype(
        np.float32) / 4)
    dist[0, 3] = 100.0  # an empty ball
    dist[1, 4, :5] = 0.0  # a ball of 5 points
    dist[1, 4, 5:] = 100.0
    for radius, k in ((1.0, 8), (2.5, 64), (0.0, 4)):
        ours = rr.ball_query_forward(dist, radius, k)
        ref = jax_rr.ball_query_forward(dist, radius, k)
        assert ours.dtype == ref.dtype and torch.equal(ours, ref)
    out = rr.ball_query_forward(dist, 2.5, 8)
    assert (out[0, 3] == 0).all()
    assert out[1, 4].tolist() == [0, 1, 2, 3, 4, 0, 1, 2]


def test_opt_and_shim_install(monkeypatch):
    for grouping in ("som", "ball"):
        over = {"detector.grouping": grouping, "data.node_num": 64}
        a = rr.make_reference_opt(get_config("kitti", **over), sigma_max=3.0)
        b = jax_rr.make_reference_opt(jax_get_config("kitti", **over),
                                      sigma_max=3.0)
        assert vars(a) == vars(b)
    for name in ("index_max", "ball_query"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "torchvision", sys.modules.get(
        "torchvision", object()))
    monkeypatch.setitem(sys.modules, "visdom", sys.modules.get(
        "visdom", object()))
    rr.install_extension_shims()
    assert sys.modules["index_max"].forward_cuda_shared_mem is \
        rr.index_max_forward
    assert sys.modules["ball_query"].forward_cuda_shared_mem is \
        rr.ball_query_forward
    with pytest.raises(FileNotFoundError):
        rr.load_reference_networks(os.path.join(REPO, "no_such_checkout"))


@pytest.mark.skipif(not (REFERENCE and
                         os.path.isdir(os.path.join(REFERENCE, "models"))),
                    reason="USIP_REFERENCE names no reference checkout")
def test_detector_side_by_side_with_the_reference():
    """The reference's RPN_Detector holding the port's seeded weights
    against the port's fp32 eval forward (``tests/test_reference_parity.py``'s
    tolerances)."""
    over = {"data.input_pc_num": 512, "data.node_num": 64,
            "detector.compute_dtype": "float32"}
    cfg = get_config("kitti", **over)
    det = Detector(cfg.detector)
    det.load_state_dict({k: torch.as_tensor(v) for k, v in
                         seeded_state_dict(cfg.detector, 1).items()},
                        strict=False)
    rng = np.random.default_rng(1)
    pc = rng.normal(size=(2, 512, 3)).astype(np.float32)
    sn = rng.normal(size=(2, 512, 4)).astype(np.float32)
    out = rr.detector_side_by_side(cfg, REFERENCE, det, pc, sn,
                                   pc[:, :64].copy())
    diff = out["max_abs_diff"]
    assert diff["anchors"] < 1e-4
    assert diff["keypoints"] < 1e-2 and diff["sigmas"] < 1e-3
