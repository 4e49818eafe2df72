"""The grouped detector trunks (knn, ball) of the port against usip_tpu.

Clouds lie on a 1/8 grid, where every coordinate product and sum is exact:
usip_tpu's matmul distances and the port's elementwise ones then agree bit
for bit, so ball membership (``sqdist <= r^2``) and kNN order are compared
exactly, and the many equal distances test the lowest-index tie rule. Both
sides load the same seeded weights and see the same inputs and nodes.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from usip_tpu.config import get_config
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.ops import ball_query as jax_ball_query
from usip_tpu.ops import knn as jax_knn
from usip_tpu.train.torch_import import (convert_detector_state_dict,
                                         export_detector_state_dict)
from usip_tpu_torch import ops as tops
from usip_tpu_torch.models import Detector
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.weights import seeded_state_dict, state_dict_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, N, M, S = 2, 600, 64, 4
SMALL = {"detector.c1": 16, "detector.c2": 32, "detector.node_knn_k": 4,
         "detector.group_k": 16, "detector.group_radius": 0.5,
         "detector.compute_dtype": "float32"}


def _cfg(grouping, **extra):
    return get_config("oxford", **{"detector.grouping": grouping, **SMALL,
                                   **extra})


def _grid_cloud(rng, b=B, n=N):
    """Points on a 1/8 grid: three quarters spread over a 3-unit cube, a
    quarter packed into a half-unit blob (balls there overflow K), with
    many exact duplicates."""
    spread = rng.integers(-12, 13, size=(b, n - n // 4, 3))
    blob = rng.integers(-2, 3, size=(b, n // 4, 3))
    pc = np.concatenate([spread, blob], axis=1) / 8.0
    return rng.permuted(pc, axis=1).astype(np.float32)


def _nodes(rng, pc, m=M):
    sel = np.stack([rng.choice(pc.shape[1], m, replace=False)
                    for _ in range(pc.shape[0])])
    return np.take_along_axis(pc, sel[..., None], axis=1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("n,k", [(600, 16), (4500, 64)])
def test_knn_on_grid_matches_jax(n, k):
    """kNN indices and squared distances identical to usip_tpu's knn (direct
    top_k below 4096 points, its two-stage form above)."""
    rng = np.random.default_rng(n)
    pc = _grid_cloud(rng, n=n)
    node = _nodes(rng, pc)
    d_ref, i_ref = jax_knn(jnp.asarray(node), jnp.asarray(pc), k)
    d, i = tops.knn(_t(node), _t(pc), k)
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))


@pytest.mark.parametrize("radius,k", [(0.5, 16), (0.25, 8), (1.0, 64)])
def test_ball_query_on_grid_matches_jax(radius, k):
    """Natural-order ball query: idx, valid and counts identical to
    usip_tpu's ball_query(key=None), with overflowing, padded and empty
    balls (the last center lies far from every point)."""
    rng = np.random.default_rng(int(radius * 100) + k)
    pc = _grid_cloud(rng)
    centers = _nodes(rng, pc)
    centers[:, -1] = 50.0
    ref = jax_ball_query(jnp.asarray(pc), jnp.asarray(centers), radius, k,
                         key=None)
    out = tops.ball_query(_t(pc), _t(centers), radius, k)
    np.testing.assert_array_equal(out.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    counts = out.counts.numpy()
    assert (counts == k).any() and ((counts > 0) & (counts < k)).any()
    assert (counts[:, -1] == 0).all() and (out.idx.numpy()[:, -1] == 0).all()


def test_ball_query_refuses_what_is_not_ported():
    """Random priorities and ``method='approx'`` are ported: usip_tpu's
    ``lax.approx_min_k`` selection becomes the exact one, so 'approx' gives
    what 'exact' gives, and a detector with ``group_method='approx'``
    builds. What is still refused: an unknown method or group_method, and
    priorities that are not one per point of the cloud."""
    rng = np.random.default_rng(0)
    pc = _t(rng.normal(size=(2, 64, 3)).astype(np.float32))
    prio = _t(rng.uniform(size=(2, 64)).astype(np.float32))
    exact = tops.ball_query(pc, pc[:, :8], 1.0, 4, prio)
    approx = tops.ball_query(pc, pc[:, :8], 1.0, 4, prio, method="approx")
    for a, b in zip(exact, approx):
        assert torch.equal(a, b)
    Detector(_cfg("ball", **{"detector.group_method": "approx"}).detector)
    with pytest.raises(ValueError, match="method"):
        tops.ball_query(pc, pc, 1.0, 4, method="bucketed")
    with pytest.raises(ValueError, match="priority"):
        tops.ball_query(pc, pc, 1.0, 4, prio[:, :8])
    with pytest.raises(ValueError, match="group_method"):
        Detector(_cfg("ball", **{"detector.group_method": "topk"}).detector)


def _setup(grouping, seed):
    cfg = _cfg(grouping)
    rng = np.random.default_rng(seed)
    pc = _grid_cloud(rng)
    sn = rng.normal(size=(B, N, S)).astype(np.float32)
    node = _nodes(rng, pc)
    sd = seeded_state_dict(cfg.detector, seed)
    jax_model = JaxDetector(cfg.detector)
    init = jax_model.init(jax.random.PRNGKey(0), jnp.asarray(pc[:1]),
                          jnp.asarray(sn[:1]), jnp.asarray(node[:1]),
                          train=False)
    variables = convert_detector_state_dict(sd, init)
    det = Detector(cfg.detector)
    det.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                        strict=True)
    ref = [np.asarray(t) for t in jax_model.apply(
        variables, jnp.asarray(pc), jnp.asarray(sn), jnp.asarray(node),
        train=False)]
    return pc, sn, node, variables, det.eval(), ref


@pytest.mark.parametrize("grouping", ["knn", "ball"])
def test_group_detector_fp32_matches_jax(grouping):
    """The port's layered knn/ball Detector in fp32 against Detector.apply
    (train=False): anchors (the nodes), keypoints and sigmas within 1e-4."""
    pc, sn, node, _, det, ref = _setup(grouping, 3)
    with torch.no_grad():
        out = det(_t(pc), _t(sn), _t(node))
    assert np.abs(ref[1] - ref[0]).max() > 1e-2
    np.testing.assert_array_equal(out[0].numpy(), node)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-4, rtol=0)


@pytest.mark.parametrize("grouping", ["knn", "ball"])
def test_group_fused_infer_within_chain_bounds(grouping):
    """detector_infer_fused on the grouped trunks (the fusion layer on the
    fused chain) against Detector.apply(train=False): anchors identical;
    keypoints and sigmas within 2e-2 * max|ref|, median within 2e-3 *
    max|ref| (the chain's bf16 operands)."""
    pc, sn, node, _, det, ref = _setup(grouping, 4)
    out = [t.numpy() for t in detector_infer_fused(det, _t(pc), _t(sn),
                                                   _t(node))]
    np.testing.assert_array_equal(out[0], ref[0])
    for o, r in zip(out[1:], ref[1:]):
        scale = np.abs(r).max()
        err = np.abs(o - r)
        assert err.max() <= 2e-2 * scale, (err.max(), scale)
        assert np.median(err) <= 2e-3 * scale, (np.median(err), scale)


def test_group_trunk_split_kernel_order():
    """conv4 acts on [h, h_max] (the reference's order), not [h_max, h]:
    swapping conv4's two kernel halves changes the trunk's features."""
    pc, sn, node, _, det, _ = _setup("ball", 5)
    with torch.no_grad():
        feat = det.trunk(_t(pc), _t(sn), _t(node))[1]
        w = det.conv4.conv.weight
        half = w.shape[1] // 2
        w.copy_(torch.cat([w[:, half:], w[:, :half]], dim=1))
        swapped = det.trunk(_t(pc), _t(sn), _t(node))[1]
    assert not torch.allclose(feat, swapped, atol=1e-3)


def test_state_dict_from_jax_group_matches_export():
    """The grouped family (conv1..5): key for key and value for value the
    same as export_detector_state_dict, (O, I, 1, 1) conv weights, and it
    loads with strict=True."""
    _, _, _, variables, _, _ = _setup("knn", 6)
    ours = state_dict_from_jax(variables)
    ref = export_detector_state_dict(variables)
    assert sorted(ours) == sorted(ref)
    assert "conv1.conv.weight" in ours and "first_pointnet" not in str(ours)
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
        assert ours[k].shape == v.shape, k
    assert ours["conv4.conv.weight"].shape == (16, 16, 1, 1)
    result = Detector(_cfg("knn").detector).load_state_dict(ours, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


SERVE_OVERRIDES = {"detector.grouping": "ball", "detector.c1": 16,
                   "detector.c2": 32, "detector.node_knn_k": 4,
                   "detector.group_radius": 0.5, "data.input_pc_num": 512,
                   "data.node_num": 64}


@pytest.fixture
def ball_checkpoint(tmp_path):
    cfg = get_config("oxford", **SERVE_OVERRIDES)
    ckpt = tmp_path / "ball.pth"
    torch.save({k: torch.tensor(v) for k, v in
                seeded_state_dict(cfg.detector, 0).items()}, ckpt)
    return cfg, ckpt


def test_serve_cpu_oxford_ball(ball_checkpoint, tmp_path):
    """serve --dataset oxford --override detector.grouping=ball --device cpu
    answers 2 requests from a conv1..5 checkpoint at a reduced size."""
    _, ckpt = ball_checkpoint
    rng = np.random.default_rng(0)
    clouds = []
    for i in range(2):
        path = tmp_path / f"cloud{i}.npy"
        np.save(path, rng.normal(size=(700, 7)).astype(np.float32))
        clouds.append(path)
    out = tmp_path / "out"
    reqs = [{"id": i, "input": str(c), "out": str(out), "num_keypoints": 24}
            for i, c in enumerate(clouds)] + [{"cmd": "shutdown"}]
    args = [a for k, v in SERVE_OVERRIDES.items()
            for a in ("--override", f"{k}={v}")]
    proc = subprocess.run(
        [sys.executable, "-m", "usip_tpu_torch.cli", "serve", "--device",
         "cpu", "--dataset", "oxford", "--checkpoint", str(ckpt), *args],
        input="".join(json.dumps(r) + "\n" for r in reqs), text=True,
        capture_output=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(s) for s in proc.stdout.splitlines()]
    assert lines[0]["status"] == "ready" and lines[-1] == {"status": "bye"}
    for i, reply in enumerate(lines[1:-1]):
        assert reply["id"] == i and reply["n"] == 24, reply
        kp = np.fromfile(reply["keypoints"], np.float32).reshape(-1, 3)
        assert kp.shape == (24, 3) and np.isfinite(kp).all()


def test_pipeline_refuses_family_mismatch(ball_checkpoint):
    """A grouped checkpoint under the som preset (and the reverse) is
    refused with the grouping to set, not a key-mismatch traceback."""
    from usip_tpu_torch.inference import KeypointPipeline

    cfg, ckpt = ball_checkpoint
    som = get_config("oxford", **{k: v for k, v in SERVE_OVERRIDES.items()
                                  if k != "detector.grouping"})
    with pytest.raises(ValueError, match="detector.grouping=ball"):
        KeypointPipeline(som, str(ckpt), "cpu")
    pipe = KeypointPipeline(cfg, str(ckpt), "cpu")
    kp, sig = pipe.detect(np.random.default_rng(1).normal(
        size=(600, 3)).astype(np.float32), num_keypoints=8)
    assert kp.shape == (8, 3) and sig.shape == (8,)
