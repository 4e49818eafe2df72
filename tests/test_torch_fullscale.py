"""The full-scale KITTI protocol's runner (``python -m
usip_tpu_torch.fullscale``) against ``scripts/fullscale_quality.py``, on the
CPU at a tiny size.

On one tiny synthetic KITTI tree, from one usip_tpu-written ``.msgpack``
detector and descriptor (fp32 trunk; the port reads them as its ``best.pt``
after ``restore_checkpoint``):
* ``eval`` prints the script's JSON keys; ``random_keypoints`` equals the
  script's exactly (host numpy, the same seeds); the trained arms, with
  JAX's node draws handed to the port, agree within one keypoint a pair
  (repeatability within 1/128) and both run the fused chain with its bf16
  operands, as ``tests/test_torch_export.py`` does;
* ``eval-reg --yaw`` prints the script's JSON keys (its ``--yaw`` arms'
  keys are its aligned arms'), its arms' frame counts, and a
  ``random_desc_floor`` equal to the script's ``_random_desc_arm`` on the
  same keypoints; the yaw arms run a ragged last batch;
* the train phase's loaders of both packages on their default paths (the
  native batch loaders) give the same batches over two epochs;
* ``train``, ``train-desc`` (1 epoch each) and ``gen`` run through
  ``main``, and ``smoke`` is ``python -m usip_tpu_torch.quality``.
"""

import argparse
import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import usip_tpu.native
import usip_tpu_torch.native
from usip_tpu.config import get_config as jax_get_config
from usip_tpu.data import pipeline as jax_pipeline
from usip_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from usip_tpu.train.descriptor_loop import (
    init_descriptor_state as jax_init_descriptor_state)
from usip_tpu.train.loop import init_detector_state as jax_init_detector_state
from usip_tpu_torch import fullscale, quality
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree
from usip_tpu_torch.eval import export_runner
from usip_tpu_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from usip_tpu_torch.train.descriptor_loop import init_descriptor_state
from usip_tpu_torch.train.loop import init_detector_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, RATIO, BATCH, DESIRED = 512, 128, 2, 8, 128
OVERRIDES = [f"data.input_pc_num={N}", f"data.node_num={M}",
             f"data.fps_subsample_ratio={RATIO}", "data.parent_pc_num=640",
             "detector.c1=16", "detector.c2=64", "detector.node_knn_k=4",
             "detector.compute_dtype=float32",
             "detector.fusion_backend=pallas",
             "descriptor.ball_nsamples=16", "descriptor.descriptor_len=32",
             "descriptor.compute_dtype=float32"]
# a trained arm's repeatability, port against usip_tpu: one keypoint a pair;
# an exported keypoint against usip_tpu's (tests/test_torch_parity.py:151-153)
REP_TOL = 1.0 / DESIRED
KP_TOL = 2e-3


def _script():
    spec = importlib.util.spec_from_file_location(
        "fullscale_quality_script",
        os.path.join(REPO, "scripts", "fullscale_quality.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(root, **kw):
    return argparse.Namespace(root=root, override=list(OVERRIDES),
                              platform=None, **kw)


def _overrides():
    return {k: json.loads(v) if v[0].isdigit() else v for k, v in
            (kv.split("=", 1) for kv in OVERRIDES)}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The tree (10 test frames a sequence: two batches of 8, the second
    ragged), usip_tpu's seeded detector and descriptor as ``.msgpack`` and
    the same weights as the port's ``best.pt``."""
    root = str(tmp_path_factory.mktemp("fullscale"))
    build_synthetic_kitti_tree(root, train_seqs=range(9), test_seqs=(9, 10),
                               frames_per_seq=2, test_frames_per_seq=10,
                               target_points=800, seed=0)
    over = {**_overrides(), "data.dataroot": root}
    jcfg = jax_get_config("kitti", **over)
    cfg = get_config("kitti", **over)
    det_dir = os.path.join(root, "ckpt", "fullscale")
    desc_dir = os.path.join(root, "ckpt", "fullscale_descriptor")
    _, jdet = jax_init_detector_state(jcfg, seed=5)
    jdesc = jax_init_descriptor_state(jcfg, seed=6)[1]
    for folder, jstate, init in ((det_dir, jdet, init_detector_state),
                                 (desc_dir, jdesc, init_descriptor_state)):
        os.makedirs(folder)
        msgpack = os.path.join(folder, "best.msgpack")
        jax_save_checkpoint(msgpack, jstate)
        state = init(cfg)
        restore_checkpoint(msgpack, state)
        save_checkpoint(os.path.join(folder, "best.pt"), state)
    return root


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


@pytest.fixture
def one_loader_thread(monkeypatch):
    """Both packages' loaders on their numpy path and usip_tpu's on one
    fetch thread: its test frames share one rng, which a pool of threads
    would draw from in a run-dependent order (the port's loader fetches such
    items in order on one thread)."""
    monkeypatch.setattr(usip_tpu.native, "available", lambda: False)
    monkeypatch.setattr(usip_tpu_torch.native, "available", lambda: False)
    init = jax_pipeline.BatchLoader.__init__

    def single(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.num_workers = 1

    monkeypatch.setattr(jax_pipeline.BatchLoader, "__init__", single)


def _keys(result):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in result.items()}


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _unmatched(got, want):
    """Rows of ``got`` with no row of ``want`` within ``KP_TOL``."""
    d = np.abs(got[:, None, :] - want[None, :, :]).max(-1)
    return int((d.min(1) > KP_TOL).sum())


def test_eval_matches_script(tree, capsys, monkeypatch, one_loader_thread):
    script = _script()
    ref_root = tree + "_eval_script"
    shutil.copytree(tree, ref_root)
    script.phase_eval(_args(ref_root))
    ref = _last_json(capsys)

    run_export = export_runner.run_export

    def with_jax_draws(cfg, checkpoint, out_dir, **kw):
        if checkpoint is not None:
            kw["node_draws"] = _jax_node_draws
        return run_export(cfg, checkpoint, out_dir, **kw)

    monkeypatch.setattr(export_runner, "run_export", with_jax_draws)
    ours = fullscale.main(["eval", "--root", tree, "--device", "cpu"]
                          + [a for kv in OVERRIDES
                             for a in ("--override", kv)])
    assert _last_json(capsys) == json.loads(json.dumps(ours))
    assert _keys(ours) == _keys(ref)
    assert ours["pairs"] == ref["pairs"] > 0
    assert ours["random_keypoints"] == ref["random_keypoints"]
    frames = ref["random_keypoints"]["frames"]
    assert frames > 8, "the second batch must be there, and ragged"
    for arm in ("trained_defaults", "trained_fp32_exact"):
        assert ours[arm]["frames"] == ref[arm]["frames"] == frames
        assert abs(ours[arm]["repeatability"]
                   - ref[arm]["repeatability"]) <= REP_TOL, arm
        # the model's keypoints, frame by frame: all but one within KP_TOL
        out, ref_out = (os.path.join(r, "kp_default" if arm.endswith(
            "defaults") else "kp_exact") for r in (tree, ref_root))
        for seq in ("09", "10"):
            for fn in sorted(os.listdir(os.path.join(ref_out, seq))):
                got, want = (np.fromfile(os.path.join(d, seq, fn),
                                         np.float32).reshape(-1, 3)
                             for d in (out, ref_out))
                assert got.shape == want.shape == (DESIRED, 3)
                assert _unmatched(got, want) <= 1, (arm, seq, fn)
    assert ours["untrained_defaults"]["frames"] == frames
    assert 0.0 <= ours["untrained_defaults"]["repeatability"] <= 1.0
    assert ours["default_vs_exact_delta"] == pytest.approx(
        ours["trained_defaults"]["repeatability"]
        - ours["trained_fp32_exact"]["repeatability"])


def test_eval_reg_matches_script(tree, capsys, one_loader_thread):
    script = _script()
    ref_root = tree + "_script"
    shutil.copytree(tree, ref_root)
    # the script's aligned arms; its yaw arms are its trained arm's call
    # with a yaw seed (the port's yaw arms are held to that arm's keys)
    script.phase_eval_reg(_args(ref_root, yaw=False, desc_name="fullscale"))
    ref = _last_json(capsys)
    ours = fullscale.main(["eval-reg", "--yaw", "--root", tree, "--device",
                           "cpu"] + [a for kv in OVERRIDES
                                     for a in ("--override", kv)])
    yaw = {"trained_desc_yaw": "trained_desc",
           "untrained_desc_yaw": "untrained_desc"}
    assert _keys(ours) == {**_keys(ref), **{k: _keys(ref)[v]
                                            for k, v in yaw.items()}}
    assert ours["pairs"] == ref["pairs"] > 0
    assert ours["desc_name"] == ref["desc_name"] == "fullscale"
    for arm in ("trained_desc", "untrained_desc", "trained_desc_yaw",
                "untrained_desc_yaw", "random_desc_floor"):
        want = ref[yaw.get(arm, arm)]
        assert ours[arm]["frames"] == want["frames"] > 8, arm
        assert ours[arm]["total"] == want["total"] == ref["pairs"], arm
    # the floor: the script's arm on the port's trained keypoints
    kp_dir = os.path.join(tree, "reg_trained", "keypoints")
    cfg = jax_get_config("kitti", **{**_overrides(), "data.dataroot": tree})
    gt, calib = fullscale._gt_and_calib(tree)
    floor = script._random_desc_arm(_args(ref_root), cfg, gt, calib,
                                    kp_dir=kp_dir)
    assert json.dumps(ours["random_desc_floor"]) == json.dumps(floor)
    # the yaw arms wrote the keypoints back in the frames' own coordinates
    for arm in ("reg_trained", "reg_trained_yaw"):
        rows = np.fromfile(os.path.join(tree, arm, "keypoints", "09", "9.bin"),
                           np.float32)
        assert rows.shape == (DESIRED * 3,) and np.isfinite(rows).all()


def test_train_loaders_equal_usip_tpu_with_both_defaults(tree):
    """The train phase's loaders (``cli._make_loaders``: parent clouds of
    the KITTI tree on the fp16 wire) of both packages on their default
    paths, the native batch loaders on: two epochs of train and test
    batches equal batch for batch, every port batch through ``get_batch``."""
    from types import SimpleNamespace

    from usip_tpu import cli as jax_cli
    from usip_tpu_torch import cli
    assert usip_tpu.native.available() and usip_tpu_torch.native.available()
    over = {**_overrides(), "data.dataroot": tree}
    cfg, jcfg = get_config("kitti", **over), jax_get_config("kitti", **over)
    args = SimpleNamespace(synthetic=False)
    ours = cli._make_loaders(cfg, args, cfg.detector.surface_normal_len)
    ref = jax_cli._make_loaders(jcfg, args, jcfg.detector.surface_normal_len)
    for la, lb in zip(ours, ref):
        for _ in range(2):
            for a, b in zip(list(la), list(lb), strict=True):
                assert sorted(a) == sorted(b) == ["pc", "sn"]
                for k in a:
                    assert a[k].dtype == b[k].dtype == np.float16
                    assert np.array_equal(a[k], b[k]), k
        assert la.served == {"get_batch": 2 * len(la), "items": 0}


def test_train_phases_and_gen(tmp_path, capsys):
    """``gen`` writes the script's tree; ``train`` and ``train-desc`` run
    one epoch each through the CLI and leave the checkpoints ``eval`` and
    ``eval-reg`` read."""
    root = str(tmp_path / "t")
    ov = [a for kv in OVERRIDES for a in ("--override", kv)]
    fullscale.main(["gen", "--root", root, "--frames", "2",
                    "--test-frames", "3"])
    gen = _last_json(capsys)
    assert gen["phase"] == "gen" and gen["root"] == root
    assert set(map(int, gen["counts"])) == set(range(11))
    fullscale.main(["train", "--root", root, "--epochs", "1", "--device",
                    "cpu"] + ov)
    det = fullscale._detector_ckpt(root)
    assert os.path.exists(det)
    fullscale.main(["train-desc", "--root", root, "--epochs", "1",
                    "--device", "cpu", "--desc-name", "cgf",
                    "--override", "descriptor.use_cgf_loss=true"] + ov)
    assert os.path.exists(fullscale._best_or_last(
        os.path.join(root, "ckpt", "cgf_descriptor")))


def test_smoke_is_the_quality_gate(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(quality, "main", lambda argv: seen.append(argv))
    fullscale.main(["smoke", "--root", str(tmp_path), "--epochs", "3",
                    "--factor", "1.5", "--device", "cpu", "--cleanup",
                    "--override", "data.node_num=32"])
    assert seen == [["--factor", "1.5", "--device", "cpu", "--root",
                     str(tmp_path), "--epochs", "3", "--cleanup",
                     "--override", "data.node_num=32"]]


def test_cuda_device_raises_without_cuda(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fullscale.main(["eval", "--root", tree])


# validate_synthetic.py's JSON line (its keys; the port adds its own)
OBJECT_KEYS = {"repeatability_model", "repeatability_random", "gain",
               "epochs", "inlier_radius", "keypoints", "fps_parallel"}


def test_quality_object_gate_tiny(monkeypatch, tmp_path, capsys):
    """``python -m usip_tpu_torch.quality --object`` end to end at a tiny
    size on the CPU: one JSON line with validate_synthetic.py's keys, and
    the exit below ``--factor``."""
    monkeypatch.setattr(quality, "OBJECT_GATE", dict(
        points=256, nodes=16, keypoints=8, radius=0.25, train_size=32,
        test_size=16, pairs=4, workers=1))
    argv = ["--object", "--epochs", "1", "--device", "cpu", "--root",
            str(tmp_path), "--override", "detector.c1=16", "--override",
            "detector.c2=32", "--override", "detector.node_knn_k=4"]
    with pytest.raises(SystemExit, match="quality gate FAILED"):
        quality.main(argv + ["--factor", "1e9"])
    res = _last_json(capsys)
    assert OBJECT_KEYS <= set(res) and res["phase"] == "object"
    assert res["epochs"] == 1 and res["keypoints"] == 8
    assert not res["passed"] and res["factor"] == 1e9
    assert 0.0 < res["repeatability_random"] <= 1.0
    assert res["ratio"] == res["gain"] == pytest.approx(
        res["repeatability_model"] / res["repeatability_random"])
