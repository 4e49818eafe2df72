"""The port's descriptor commands end to end on the CPU (``--device cpu``)
at a small width, on a small synthetic KITTI tree: ``train-descriptor`` and
its ``--resume auto``, ``export-descriptors``, ``eval-registration`` (one
budget and ``--sweep-trials``), and ``detect``/``serve`` with
``--descriptor-checkpoint``."""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from usip_tpu_torch import cli
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree
from usip_tpu_torch.eval.export import read_keypoints_bin
from usip_tpu_torch.train.checkpoint import save_checkpoint
from usip_tpu_torch.train.loop import init_detector_state

torch.set_num_threads(1)

SMALL = {"data.input_pc_num": 256, "data.node_num": 16,
         "detector.c1": 16, "detector.c2": 32, "detector.node_knn_k": 4,
         "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 8,
         "train.batch_size": 2, "train.log_every": 1000,
         "data.num_workers": 1}


def _overrides():
    out = []
    for k, v in SMALL.items():
        out += ["--override", f"{k}={json.dumps(v)}"]
    return out


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A synthetic KITTI tree, a detector checkpoint at the small width,
    and a descriptor trained on them for one epoch, then resumed for a
    second."""
    root = tmp_path_factory.mktemp("kitti")
    build_synthetic_kitti_tree(str(root), frames_per_seq=2,
                               test_frames_per_seq=8, target_points=600,
                               seed=3)
    cfg = get_config("kitti", role="descriptor", **SMALL)
    det = str(root / "det.pt")
    save_checkpoint(det, init_detector_state(cfg, 0))
    base = ["train-descriptor", "--dataset", "kitti", "--dataroot",
            str(root), "--detector-checkpoint", det, "--name", "d",
            "--checkpoints-dir", str(root / "ckpt"), "--device", "cpu",
            *_overrides()]
    _run(base + ["--epochs", "1"])
    out = _run(base + ["--epochs", "2", "--resume", "auto"])
    return root, det, out


def test_train_descriptor_and_resume(trained):
    """train-descriptor writes its checkpoints and metrics under
    ``<checkpoints-dir>/<name>_descriptor``; ``--resume auto`` starts at
    epoch 1 and trains it; every loss is finite."""
    root, _, out = trained
    out_dir = root / "ckpt" / "d_descriptor"
    assert any("at epoch 1" in line for line in out)
    assert {"best.pt", "last.pt", "last.pt.json",
            "d_desc_metrics.jsonl"} <= set(os.listdir(out_dir))
    recs = [json.loads(line) for line in
            open(out_dir / "d_desc_metrics.jsonl")]
    epochs = [r["epoch"] for r in recs if r["prefix"] == "desc_epoch"]
    assert epochs == [0, 1]
    tests = [r for r in recs if r["prefix"] == "desc_test"]
    assert tests and all(np.isfinite(r["loss"]) for r in recs
                         if "loss" in r)
    assert json.load(open(out_dir / "last.pt.json"))["epoch"] == 1


def test_export_descriptors_and_registration(trained, tmp_path):
    """export-descriptors writes a keypoint and a descriptor .bin for each
    test frame (unit-length descriptors, the keypoints finite), and
    eval-registration scores them against the tree's groundtruths, once and
    as a RANSAC-budget sweep."""
    root, det, _ = trained
    desc = str(root / "ckpt" / "d_descriptor" / "best.pt")
    out = tmp_path / "feats"
    stats = json.loads(_run([
        "export-descriptors", "--dataset", "kitti", "--dataroot", str(root),
        "--checkpoint", det, "--descriptor-checkpoint", desc, "--out",
        str(out), "--num-keypoints", "24", "--device", "cpu",
        *_overrides()])[-1])
    kp_files = sorted((out / "keypoints").rglob("*.bin"))
    assert stats["frames"] == len(kp_files) > 0  # the frames of the GT pairs
    for f in kp_files:
        rel = f.relative_to(out / "keypoints")
        kp = read_keypoints_bin(str(f), 3)
        d = read_keypoints_bin(str(out / "descriptors" / rel), 16)
        assert kp.shape == (24, 3) and np.isfinite(kp).all()
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0,
                                   atol=1e-3)
    gt = ["--kitti-gt", str(root / "kitti-reg-test"), "--coord-fix",
          "kitti", "--calib-root", str(root / "calib"), "--desc-dim", "16"]
    feats = ["eval-registration", "--kp-dir", str(out / "keypoints"),
             "--desc-dir", str(out / "descriptors")]
    one = json.loads(_run(feats + gt + ["--max-trials", "200"])[-1])
    assert one["total"] > 0 and 0.0 <= one["success_rate"] <= 1.0
    sweep = [json.loads(line) for line in
             _run(feats + gt + ["--sweep-trials", "50,100"])]
    assert [s["max_trials"] for s in sweep] == [50, 100]
    assert all(s["total"] == one["total"] for s in sweep)


def test_detect_and_serve_with_descriptors(trained, tmp_path, monkeypatch):
    """detect and serve with --descriptor-checkpoint: 20 keypoints (two
    chunks of node_num 16, the second padded) and their unit-length
    descriptors per cloud; serve's ready line says ``descriptors: true``
    and each reply names the .desc.bin."""
    root, det, _ = trained
    desc = str(root / "ckpt" / "d_descriptor" / "best.pt")
    rng = np.random.default_rng(0)
    clouds = tmp_path / "clouds"
    clouds.mkdir()
    for i in range(2):
        np.save(clouds / f"c{i}.npy", rng.normal(
            0, 5, size=(700, 7)).astype(np.float32))
    common = ["--dataset", "kitti", "--checkpoint", det,
              "--descriptor-checkpoint", desc, "--num-keypoints", "20",
              "--device", "cpu", *_overrides()]
    served = tmp_path / "served"
    _run(["detect", "--input", str(clouds), "--out", str(served), *common])
    for i in range(2):
        kp = np.fromfile(served / f"c{i}.keypoints.bin",
                         np.float32).reshape(-1, 3)
        d = np.fromfile(served / f"c{i}.desc.bin", np.float32).reshape(-1, 16)
        assert kp.shape == (20, 3) and d.shape == (20, 16)
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0,
                                   atol=1e-3)
    reqs = [{"id": 7, "input": str(clouds / "c0.npy"),
             "out": str(tmp_path / "s")}, {"cmd": "shutdown"}]
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        "".join(json.dumps(r) + "\n" for r in reqs)))
    lines = [json.loads(x) for x in _run(["serve", *common])]
    assert lines[0] == {"status": "ready", "descriptors": True}
    assert lines[1]["id"] == 7 and lines[1]["n"] == 20
    assert lines[1]["descriptors"].endswith("c0.desc.bin")
    assert os.path.exists(lines[1]["descriptors"])
    assert lines[-1] == {"status": "bye"}


def test_export_descriptors_with_frame_yaw(trained, tmp_path):
    """``frame_yaw_seed``: each frame is rotated by its own yaw before
    detection and description and its keypoints rotated back: they lie on
    the frame's own cloud, and the descriptors differ from the unrotated
    export's."""
    from usip_tpu_torch.eval.export_runner import (
        _frame_yaw_matrix, make_eval_dataset, run_export_with_descriptors)
    root, det, _ = trained
    desc = str(root / "ckpt" / "d_descriptor" / "best.pt")
    cfg = get_config("kitti", role="descriptor",
                     **{**SMALL, "data.dataroot": str(root)})
    ds = make_eval_dataset(cfg)
    outs = {}
    for yaw in (None, 5):
        out = tmp_path / f"yaw{yaw}"
        run_export_with_descriptors(
            cfg, det, desc, str(out / "kp"), str(out / "desc"),
            desired_num=24, dataset=ds, frame_yaw_seed=yaw, device="cpu")
        outs[yaw] = out
    item = ds[0]
    rel = os.path.join(f"{int(item['seq']):02d}", f"{int(item['frame'])}.bin")
    kp = read_keypoints_bin(str(outs[5] / "kp" / rel), 3)
    R = _frame_yaw_matrix(5, int(item["seq"]), int(item["frame"]))
    near = lambda k: np.linalg.norm(  # noqa: E731
        k[:, None] - item["pc"][None], axis=-1).min(1).mean()
    assert near(kp) < 0.5 * near(kp @ R.T)
    assert not np.allclose(read_keypoints_bin(str(outs[5] / "desc" / rel), 16),
                           read_keypoints_bin(str(outs[None] / "desc" / rel),
                                              16))
