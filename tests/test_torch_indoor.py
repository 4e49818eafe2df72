"""The indoor pipeline through the port, on the CPU (``--device cpu``) at a
small width, on small synthetic SceneNN and 3DMatch trees:

* ``run_export_fragments`` from usip_tpu ``.msgpack`` checkpoints against
  usip_tpu's, JAX's node draws and ball priorities handed to the port: the
  same ``<scene>/<i>.bin`` rows;
* ``eval-indoor`` (RANSAC over the gt pairs, and FGR) on one feature tree
  through both packages' command lines: the same ``.log`` bytes and the same
  JSON lines;
* the port's own commands: ``train-detector --dataset scenenn --lite``,
  ``train-descriptor --dataset scenenn`` and its ``--resume auto``,
  ``python -m usip_tpu_torch.indoor``'s four phases, and ``export-keypoints``
  / ``export-descriptors`` / ``eval-repeatability`` over the new eval
  frames (scenenn, match3d, rotated modelnet).
"""

import contextlib
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from usip_tpu import cli as jax_cli
from usip_tpu.config import get_config as jax_get_config
from usip_tpu.eval import export_runner as jax_export_runner
from usip_tpu.models import Descriptor as JaxDescriptor
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu.train.torch_import import (convert_descriptor_state_dict,
                                         convert_detector_state_dict)
from usip_tpu_torch import cli, indoor
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data.preprocess import build_modelnet_rotated
from usip_tpu_torch.data.synthetic import (build_synthetic_match3d_fragments,
                                           build_synthetic_scenenn_tree)
from usip_tpu_torch.eval import export_runner
from usip_tpu_torch.weights import (seeded_descriptor_state_dict,
                                    seeded_state_dict)

torch.set_num_threads(1)

N, M, BATCH = 256, 16, 3
# the scenenn descriptor preset at a small width: the lite detector's fused
# eval forward (fp32 trunk, the fusion chain's bf16 operands on both sides:
# usip_tpu's Pallas kernel in interpret mode, the port's plain version of
# its kernel), an fp32 descriptor; balls of 64 in a radius of 20 m, which
# hold the whole fragment (a room of at most 7.6 m), so that the two
# packages' keypoints, which differ by fp32 rounding (~1e-7), move no point
# across a ball's boundary (the boundary itself is held exactly by
# tests/test_torch_indoor_train.py)
EXPORT = {"data.input_pc_num": N, "data.node_num": M,
          "data.fps_subsample_ratio": 2, "detector.c1": 32,
          "detector.c2": 64, "detector.compute_dtype": "float32",
          "detector.fusion_backend": "pallas",
          "descriptor.ball_nsamples": 64, "descriptor.ball_radius": 20.0,
          "descriptor.compute_dtype": "float32"}
# the port's commands at a tiny width
TINY = {"data.input_pc_num": 256, "data.parent_pc_num": 320,
        "data.node_num": 16, "data.fps_subsample_ratio": 2,
        "detector.c1": 16, "detector.c2": 32, "detector.node_knn_k": 4,
        "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 16,
        "train.batch_size": 2, "train.log_every": 1000,
        "data.num_workers": 1}


def _flags(over):
    out = []
    for k, v in over.items():
        out += ["--override", f"{k}={json.dumps(v)}"]
    return out


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().strip().splitlines()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic SceneNN tree (6 train and 8 test frames of 1200 points)
    and one 3DMatch scene of 5 fragments of 1500 points, in the layout of
    ``python -m usip_tpu_torch.indoor gen``."""
    root = tmp_path_factory.mktemp("indoor")
    build_synthetic_scenenn_tree(str(root / "scenenn"), train_frames=6,
                                 test_frames=8, target_points=1200, seed=0)
    build_synthetic_match3d_fragments(str(root / "match3d"), scenes=1,
                                      fragments_per_scene=5,
                                      target_points=1500, seed=1)
    return root


class _OneWorker:
    """``BatchLoader`` with one fetch thread: the fragments' subsample
    draws then go to the frames in order in both packages."""

    def __init__(self, cls):
        self.cls = cls

    def __call__(self, *args, **kw):
        return self.cls(*args, **{**kw, "num_workers": 1})


def _jax_draws(i):
    """usip_tpu's fragment export draws batch i's nodes from fold_in(key(321),
    2 i) (sample_nodes: subset rows, then FPS seed rows) and its ball
    priorities from fold_in(key(321), 2 i + 1)."""
    key = jax.random.fold_in(jax.random.PRNGKey(321), 2 * i)
    k1, k2 = jax.random.split(key)
    sub = N // 2
    subset = np.stack([np.asarray(jax.random.choice(kb, N, shape=(sub,),
                                                    replace=False))
                       for kb in jax.random.split(k1, BATCH)])
    first = np.array(jax.random.randint(k2, (BATCH,), 0, sub))
    prio = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(321),
                                                 2 * i + 1), (BATCH, N))
    return ((torch.from_numpy(subset), torch.from_numpy(first)),
            torch.from_numpy(np.array(prio)))


def test_fragment_export_matches_usip_tpu(tree, tmp_path, monkeypatch):
    """The fragment export from the same usip_tpu ``.msgpack`` detector and
    descriptor, on the same frames in the same order, JAX's draws handed to
    the port: the same files, each ``(16, 131)`` rows ``[x y z d_0..d_127]``
    within 1e-5, the ragged last batch (5 fragments, batch 3) written
    whole."""
    over = {**EXPORT, "data.dataroot": str(tree / "scenenn"),
            "train.batch_size": BATCH}
    cfg = get_config("scenenn", role="descriptor", **over)
    jcfg = jax_get_config("scenenn", role="descriptor", **over)
    rng = np.random.default_rng(2)
    pc = rng.normal(size=(1, N, 3)).astype(np.float32)
    sn = rng.normal(size=(1, N, 4)).astype(np.float32)
    jdet, jdesc = JaxDetector(jcfg.detector), JaxDescriptor(jcfg.descriptor)
    # the variables' structure and shapes, traced (not run)
    det_vars = convert_detector_state_dict(
        seeded_state_dict(cfg.detector, 4), jax.eval_shape(
            lambda: jdet.init(jax.random.PRNGKey(0), pc, sn, pc[:, :M],
                              train=False)))
    desc_vars = convert_descriptor_state_dict(
        seeded_descriptor_state_dict(cfg.descriptor, 5), jax.eval_shape(
            lambda: jdesc.init(jax.random.PRNGKey(0), pc, sn, pc[:, :M],
                               key=jax.random.PRNGKey(1), train=False)))
    ckpts = []
    for name, v in (("det", det_vars), ("desc", desc_vars)):
        path = str(tmp_path / f"{name}.msgpack")
        jax_save_checkpoint(path, JaxTrainState.create(
            v, jax_make_adam(jcfg.train.lr)))
        ckpts.append(path)
    monkeypatch.setattr(jax_export_runner, "BatchLoader",
                        _OneWorker(jax_export_runner.BatchLoader))
    monkeypatch.setattr(export_runner, "BatchLoader",
                        _OneWorker(export_runner.BatchLoader))
    pc_root = str(tree / "match3d" / "fragments")
    scenes = sorted(os.listdir(pc_root))
    ref = jax_export_runner.run_export_fragments(
        jcfg, *ckpts, pc_root, str(tmp_path / "ref"), scenes, desired_num=M)
    ours = export_runner.run_export_fragments(
        cfg, *ckpts, pc_root, str(tmp_path / "port"), scenes, desired_num=M,
        device="cpu", node_draws=lambda i: _jax_draws(i)[0],
        ball_priorities=lambda i: _jax_draws(i)[1])
    assert ours == ref == {"frames": 5, "scenes": 1}
    for i in range(5):
        rel = os.path.join(scenes[0], f"{i}.bin")
        a = np.fromfile(tmp_path / "port" / rel, np.float32).reshape(M, -1)
        b = np.fromfile(tmp_path / "ref" / rel, np.float32).reshape(M, -1)
        assert a.shape == (M, 3 + 128)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=rel)


def _feature_tree(root, out):
    """Keypoints and descriptors for each fragment: 40 points of the
    fragment with unit descriptors that repeat across fragments (by the
    point's position in the room, up to noise), the rows
    ``run_export_fragments`` writes."""
    pc_root = os.path.join(root, "match3d", "fragments")
    scene = sorted(os.listdir(pc_root))[0]
    rng = np.random.default_rng(3)
    proj = rng.normal(size=(3, 32))
    for i in range(5):
        pc = np.load(os.path.join(pc_root, scene, f"{i}.npy"))[:, :3]
        kp = pc[rng.choice(len(pc), 40, replace=False)]
        desc = np.sin(kp @ proj * 2.0) + rng.normal(0, 0.05, (40, 32))
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        os.makedirs(os.path.join(out, scene), exist_ok=True)
        np.concatenate([kp, desc], 1).astype(np.float32).tofile(
            os.path.join(out, scene, f"{i}.bin"))
    return scene


@pytest.mark.parametrize("extra", [["--overlapped-only"],
                                   ["--estimator", "fgr"]])
def test_eval_indoor_matches_usip_tpu(tree, tmp_path, extra):
    """``eval-indoor`` through both command lines on one feature tree: the
    same ``<scene>.log`` bytes and the same JSON lines (a scene, then the
    mean); ``--logs-only`` re-reads the port's log to the same lines."""
    scene = _feature_tree(str(tree), str(tmp_path / "feats"))
    base = ["eval-indoor", "--gt-root", str(tree / "match3d" / "gt"),
            "--pc-root", str(tree / "match3d" / "fragments"),
            "--result-root", str(tmp_path / "feats"), "--scenes", scene,
            "--desc-dim", "32", "--max-trials", "300"] + extra
    ours = _run(cli.main, base + ["--out", str(tmp_path / "port")])
    ref = _run(jax_cli.main, base + ["--out", str(tmp_path / "ref")])
    assert ours == ref and len(ours) == 2
    log = f"{scene}.log"
    assert ((tmp_path / "port" / log).read_bytes()
            == (tmp_path / "ref" / log).read_bytes())
    assert json.loads(ours[0])["scene"] == scene
    again = _run(cli.main, ["eval-indoor", "--gt-root",
                            str(tree / "match3d" / "gt"), "--scenes", scene,
                            "--logs-only", "--log-dir",
                            str(tmp_path / "port")])
    assert again == ours


def test_indoor_protocol_phases(tree, tmp_path):
    """``python -m usip_tpu_torch.indoor`` at a tiny width: gen, train-det
    (the lite detector, detector role), train-desc (scenenn pairs, the CGF
    objective on the frozen detector), eval (both arms): the checkpoints,
    the features and logs of both arms, one JSON line with each arm's
    recall and precision."""
    root = str(tmp_path / "proto")
    flags = ["--root", root, "--device", "cpu"] + _flags(TINY)
    _run(indoor.main, ["gen", "--root", root, "--frames", "8",
                       "--fragments", "4"])
    _run(indoor.main, ["train-det", "--epochs", "1"] + flags)
    assert os.path.exists(os.path.join(root, "ckpt", "indoor", "last.pt"))
    _run(indoor.main, ["train-desc", "--epochs", "1"] + flags)
    out = _run(indoor.main, ["eval", "--num-keypoints", "16",
                             "--max-trials", "100"] + flags)
    res = json.loads(out[-1])
    assert res["phase"] == "eval" and len(res["scenes"]) == 2
    for arm in ("trained_desc", "untrained_desc"):
        assert res[arm]["frames"] == 8
        assert 0.0 <= res[arm]["mean_precision"] <= 1.0
        assert set(res[arm]["per_scene"]) == set(res["scenes"])
    for d in ("features_trained", "logs_untrained"):
        assert os.listdir(os.path.join(root, d))
    assert os.path.exists(os.path.join(root, "ckpt", "untrained_desc.pt"))


def test_scenenn_commands(tree, tmp_path):
    """``train-detector --dataset scenenn --lite`` (the detector role's
    node kNN), ``train-descriptor --dataset scenenn`` for one epoch and
    ``--resume auto`` for a second (SceneNN pairs, no miner: the CGF
    objective mines on the device), then ``export-keypoints`` and
    ``export-descriptors`` over the Redwood-layout frames of the fragment
    tree and the 3DMatch layout (``cloud_bin_<i>.npy``)."""
    sroot = str(tree / "scenenn")
    ck = str(tmp_path / "ck")
    common = ["--dataroot", sroot, "--checkpoints-dir", ck, "--device",
              "cpu", "--name", "s"] + _flags(TINY)
    _run(cli.main, ["train-detector", "--dataset", "scenenn", "--lite",
                    "--epochs", "1"] + common)
    det = os.path.join(ck, "s", "last.pt")
    meta = json.load(open(os.path.join(ck, "s", "config.json")))
    assert meta["detector"]["c1"] == 16  # the override keeps precedence
    base = ["train-descriptor", "--dataset", "scenenn",
            "--detector-checkpoint", det] + common
    _run(cli.main, base + ["--epochs", "1"])
    out = _run(cli.main, base + ["--epochs", "2", "--resume", "auto"])
    assert any("at epoch 1" in line for line in out)
    recs = [json.loads(line) for line in open(
        os.path.join(ck, "s_descriptor", "s_desc_metrics.jsonl"))]
    assert {r["epoch"] for r in recs if r["prefix"] == "desc_epoch"} == {0, 1}
    assert any(r["prefix"] == "desc_test" for r in recs)
    assert all(np.isfinite(r["loss"]) for r in recs if "loss" in r)
    assert "match_acc" in recs[-1]
    desc = os.path.join(ck, "s_descriptor", "last.pt")

    frag = tree / "match3d" / "fragments"
    scene = sorted(os.listdir(frag))[0]
    m3d = tmp_path / "m3d" / "7-scenes-redkitchen"
    m3d.mkdir(parents=True)
    for f in os.listdir(frag / scene):
        (m3d / f"cloud_bin_{f}").write_bytes((frag / scene / f).read_bytes())
    for dataset, root in (("scenenn", tmp_path / "redwood"),
                          ("match3d", tmp_path / "m3d")):
        if dataset == "scenenn":  # the Redwood layout: <root>/<scene>/
            (root / "office1").mkdir(parents=True)
            for f in os.listdir(frag / scene):
                (root / "office1" / f).write_bytes(
                    (frag / scene / f).read_bytes())
        # the match3d preset has no descriptor of its own: the scenenn
        # one's global-context head is named
        extra = ({} if dataset == "scenenn"
                 else {"descriptor.use_global_context": True})
        flags = ["--dataset", dataset, "--dataroot", str(root), "--device",
                 "cpu"] + _flags({**TINY, **extra})
        stats = json.loads(_run(cli.main, [
            "export-keypoints", "--checkpoint", det, "--out",
            str(tmp_path / f"kp_{dataset}"), "--num-keypoints", "16"]
            + flags)[-1])
        assert stats["frames"] == 5
        stats = json.loads(_run(cli.main, [
            "export-descriptors", "--checkpoint", det,
            "--descriptor-checkpoint", desc, "--out",
            str(tmp_path / f"feats_{dataset}"), "--num-keypoints", "16"]
            + flags)[-1])
        assert stats["frames"] == 5
        # the scene's index in the dataset's scene list names the folder
        seq = "02" if dataset == "scenenn" else "00"
        d = np.fromfile(tmp_path / f"feats_{dataset}" / "descriptors" /
                        seq / "0.bin", np.float32).reshape(16, 16)
        np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0,
                                   atol=1e-4)


def test_rotated_modelnet_repeatability(tmp_path):
    """``build_modelnet_rotated`` over synthetic shapes, ``export-keypoints
    --subset original`` and ``--subset rotated`` at the modelnet preset,
    then ``eval-repeatability`` against the tree's ``<i>_gt.npy``."""
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    shapes = SyntheticDataset(size=4, input_pc_num=300, surface_normal_len=3,
                              seed=1)
    src = []
    for i in range(4):
        item = shapes[i]
        path = tmp_path / f"shape{i}.npy"
        np.save(path, np.concatenate([item["src_pc"], item["src_sn"]], 1))
        src.append(str(path))
    root = tmp_path / "rot"
    assert build_modelnet_rotated(src, str(root), seed=0) == 4
    over = {"data.input_pc_num": 256, "data.node_num": 16,
            "detector.c1": 16, "detector.c2": 32, "detector.node_knn_k": 4,
            "train.batch_size": 2}
    cfg = get_config("modelnet", **over)
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.loop import init_detector_state
    det = str(tmp_path / "det.pt")
    save_checkpoint(det, init_detector_state(cfg, 0))
    for sub in ("original", "rotated"):
        stats = json.loads(_run(cli.main, [
            "export-keypoints", "--dataset", "modelnet", "--dataroot",
            str(root), "--checkpoint", det, "--out", str(tmp_path / sub),
            "--subset", sub, "--num-keypoints", "16", "--device", "cpu"]
            + _flags(over))[-1])
        assert stats["frames"] == 4
    rep = json.loads(_run(cli.main, [
        "eval-repeatability", "--anc-dir", str(tmp_path / "original"),
        "--pos-dir", str(tmp_path / "rotated"), "--gt-dir",
        str(root / "rotated"), "--inlier-radius", "0.5"])[-1])
    assert rep["pairs"] == 4 and 0.0 <= rep["repeatability"] <= 1.0
