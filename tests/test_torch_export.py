"""Keypoint export (``usip_tpu_torch.eval.export_runner``), the
repeatability command and the quality gate, on the CPU.

From one usip_tpu checkpoint, on the same test frames of a synthetic KITTI
tree, with JAX's node draws handed to the port:
* the port's ``model`` export writes the frames usip_tpu writes, with the
  same keypoint count per frame and coordinates within the parity tolerance
  of ``tests/test_torch_parity.py`` (2e-3); both sides run the fusion stack
  as the fused chain with its bf16 operands (usip_tpu's Pallas kernel in
  interpret mode, the port's plain version of its kernel);
* ``random`` and the ISS, Harris-3D and SIFT-3D baselines are
  byte-identical to usip_tpu's;
* a ragged last batch is written whole.
The quality gate runs end to end at a tiny size (no ratio asserted).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from usip_tpu.config import get_config as jax_get_config
from usip_tpu.eval import export_runner as jax_export_runner
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu.train.torch_import import convert_detector_state_dict
from usip_tpu_torch import cli, quality
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data.eval_loaders import KittiTestFrames
from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree
from usip_tpu_torch.eval import export_runner
from usip_tpu_torch.eval.export import read_keypoints_bin
from usip_tpu_torch.weights import seeded_state_dict

torch.set_num_threads(1)

N, M, BATCH, RATIO = 256, 32, 5, 2
OVERRIDES = {"data.input_pc_num": N, "data.node_num": M,
             "data.fps_subsample_ratio": RATIO, "detector.c1": 16,
             "detector.c2": 64, "detector.node_knn_k": 4,
             "detector.compute_dtype": "float32",
             "detector.fusion_backend": "pallas"}
TOL = 2e-3  # tests/test_torch_parity.py:151-153


class _Items:
    """Precomputed eval items: both exports see the same clouds in the same
    order, whatever their loaders' thread scheduling."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tree"))
    build_synthetic_kitti_tree(root, train_seqs=(), test_seqs=(9, 10),
                               test_frames_per_seq=10, target_points=400,
                               seed=1)
    over = {**OVERRIDES, "data.dataroot": root}
    cfg, jcfg = get_config("kitti", **over), jax_get_config("kitti", **over)
    frames = KittiTestFrames(
        cfg.data, os.path.join(root, "kitti-reg-test"),
        os.path.join(root, "data_odometry_velodyne", "numpy"), seed=2)
    items = _Items([frames[i] for i in range(len(frames))])
    assert len(items) % BATCH, "the last batch must be ragged"
    rng = np.random.default_rng(3)
    jmodel = JaxDetector(jcfg.detector)
    init = jmodel.init(jax.random.PRNGKey(0),
                       rng.normal(size=(1, N, 3)).astype(np.float32),
                       rng.normal(size=(1, N, 4)).astype(np.float32),
                       rng.normal(size=(1, M, 3)).astype(np.float32),
                       train=False)
    variables = convert_detector_state_dict(
        seeded_state_dict(cfg.detector, 4), init)
    ckpt = os.path.join(root, "best.msgpack")
    jax_save_checkpoint(ckpt, JaxTrainState.create(
        variables, jax_make_adam(jcfg.train.lr)))
    return root, cfg, jcfg, items, ckpt


def _jax_node_draws(i):
    """usip_tpu's run_export draws batch i's nodes from fold_in(key(123), i)
    (sample_nodes: subset rows, then the FPS seed rows)."""
    key = jax.random.fold_in(jax.random.PRNGKey(123), i)
    k1, k2 = jax.random.split(key)
    sub = max(M, N // RATIO)
    subset = np.stack([np.asarray(jax.random.choice(kb, N, shape=(sub,),
                                                    replace=False))
                       for kb in jax.random.split(k1, BATCH)])
    first = np.array(jax.random.randint(k2, (BATCH,), 0, sub))
    return torch.from_numpy(subset), torch.from_numpy(first)


def _bins(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_model_export_matches_usip_tpu(setup, tmp_path):
    root, cfg, jcfg, items, ckpt = setup
    ref_dir, out_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    kw = dict(desired_num=M, dataset=items, batch_size=BATCH)
    ref = jax_export_runner.run_export(jcfg, ckpt, ref_dir, **kw)
    ours = export_runner.run_export(cfg, ckpt, out_dir, device="cpu",
                                    node_draws=_jax_node_draws, **kw)
    assert ours["frames"] == ref["frames"] == len(items)
    assert ours["mean_keypoints"] == ref["mean_keypoints"] == M
    files = _bins(out_dir)
    assert files == _bins(ref_dir) and len(files) == len(items)
    spread = 0.0
    for f in files:
        got = read_keypoints_bin(os.path.join(out_dir, f))
        want = read_keypoints_bin(os.path.join(ref_dir, f))
        assert got.shape == want.shape == (M, 3), f
        np.testing.assert_allclose(got, want, atol=TOL, err_msg=f)
        spread = max(spread, float(np.abs(want).max()))
    assert spread > 1.0

    # --with-sigmas: the same rows, with their sigmas ascending
    sig_dir = str(tmp_path / "sig")
    export_runner.run_export(cfg, ckpt, sig_dir, device="cpu",
                             node_draws=_jax_node_draws, with_sigmas=True,
                             **kw)
    for f in files:
        rows = read_keypoints_bin(os.path.join(sig_dir, f), 4)
        assert np.array_equal(rows[:, :3],
                              read_keypoints_bin(os.path.join(out_dir, f)))
        assert np.all(np.diff(rows[:, 3]) >= 0)


@pytest.mark.parametrize("batch", [BATCH, 7])
def test_random_export_byte_identical_and_ragged_tail(setup, tmp_path, batch):
    """Every frame written, the ragged last batch included, each file
    byte-identical to usip_tpu's (with and without input noise)."""
    root, cfg, jcfg, items, _ = setup
    for noise in (0.0, 0.05):
        kw = dict(desired_num=48, dataset=items, batch_size=batch,
                  method="random", noise_sigma=noise)
        ref_dir, out_dir = (str(tmp_path / f"{k}{noise}") for k in "rp")
        ref = jax_export_runner.run_export(jcfg, None, ref_dir, **kw)
        ours = export_runner.run_export(cfg, None, out_dir, device="cpu",
                                        **kw)
        assert ours["frames"] == ref["frames"] == len(items)
        files = _bins(out_dir)
        assert files == _bins(ref_dir) and len(files) == len(items)
        for f in files:
            with open(os.path.join(out_dir, f), "rb") as a, \
                    open(os.path.join(ref_dir, f), "rb") as b:
                data = a.read()
                assert data == b.read(), f
                assert len(data) == 48 * 3 * 4


@pytest.mark.parametrize("method", ["iss", "harris", "sift"])
def test_baseline_export_byte_identical(setup, tmp_path, method):
    """The classical baselines through run_export (their defaults, padded
    from the cloud to the asked count): every frame byte-identical to
    usip_tpu's export."""
    _, cfg, jcfg, items, _ = setup
    kw = dict(desired_num=48, dataset=items, batch_size=BATCH, method=method)
    ref_dir, out_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = jax_export_runner.run_export(jcfg, None, ref_dir, **kw)
    ours = export_runner.run_export(cfg, None, out_dir, device="cpu", **kw)
    assert ours["frames"] == ref["frames"] == len(items)
    files = _bins(out_dir)
    assert files == _bins(ref_dir) and len(files) == len(items)
    for f in files:
        with open(os.path.join(out_dir, f), "rb") as a, \
                open(os.path.join(ref_dir, f), "rb") as b:
            assert a.read() == b.read(), f


def test_export_and_eval_repeatability_commands(setup, tmp_path, capsys):
    """``export-keypoints --method random`` over the tree's test frames,
    then ``eval-repeatability`` with the KITTI coordinate fix, through
    ``cli.main`` on the CPU."""
    root = setup[0]
    out = str(tmp_path / "kp")
    cli.main(["export-keypoints", "--dataset", "kitti", "--dataroot", root,
              "--method", "random", "--num-keypoints", "40", "--out", out,
              "--device", "cpu", "--override", f"data.input_pc_num={N}"])
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == len(setup[3]) and stats["mean_keypoints"] == 40
    cli.main(["eval-repeatability", "--anc-dir", out, "--pos-dir", out,
              "--kitti-gt", os.path.join(root, "kitti-reg-test"),
              "--coord-fix", "kitti", "--calib-root",
              os.path.join(root, "calib"), "--inlier-radius", "2.0"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["pairs"] > 0 and 0.0 <= rep["min"] <= rep["repeatability"] \
        <= rep["max"] <= 1.0


def test_quality_gate_tiny(tmp_path):
    """The gate's phases end to end at a tiny size on the CPU: tree, two
    epochs through the CLI, exports of the trained and random keypoints,
    repeatability of both; its JSON has every field (no ratio asserted)."""
    res = quality.run(str(tmp_path), epochs=2, factor=0.0, device="cpu",
                      overrides=["data.input_pc_num=256",
                                 "data.parent_pc_num=320", "data.node_num=16",
                                 "detector.c1=16", "detector.c2=64"],
                      frames=2, test_frames=10, points=600)
    json.dumps(res)
    assert res["phase"] == "smoke" and res["pairs"] > 0 and res["passed"]
    assert res["checkpoint"].endswith(("best.pt", "last.pt"))
    assert os.path.exists(res["checkpoint"])
    for arm in ("trained", "random"):
        assert res[arm]["frames"] > 0 and res[arm]["pairs"] == res["pairs"]
        assert 0.0 <= res[arm]["repeatability"] <= 1.0
    assert np.isfinite(res["ratio"])
    assert set(res["seconds"]) == {"gen", "train", "eval"}
