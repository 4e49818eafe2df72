"""The indoor diagnostics through the port (``python -m usip_tpu_torch.indoor
diag|eval-arm|probe-selection``) against ``scripts/diag_indoor.py``,
``scripts/eval_indoor_arm.py`` and ``scripts/probe_desc_selection.py``, on
the CPU at a tiny size.

* ``diag`` (host numpy only) prints the script's JSON line exactly, on one
  exported feature tree of a small synthetic 3DMatch scene;
* ``eval-arm --device cpu`` prints the script's keys and values from the
  same weights (usip_tpu ``.msgpack`` detector and descriptor; the port's
  ``best.pt`` restored from them), JAX's node draws and ball priorities
  handed to the port's fragment export and one fetch thread on both sides,
  as ``tests/test_torch_indoor.py``'s fragment export does: the frames,
  each scene's recall and precision and their means equal;
* ``probe-selection`` runs at toy size and prints the script's JSON keys.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from usip_tpu.config import get_config as jax_get_config
from usip_tpu.eval import export_runner as jax_export_runner
from usip_tpu.models import Descriptor as JaxDescriptor
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu.train.torch_import import (convert_descriptor_state_dict,
                                         convert_detector_state_dict)
from usip_tpu_torch import indoor
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data.synthetic import (build_synthetic_match3d_fragments,
                                           build_synthetic_scenenn_tree)
from usip_tpu_torch.eval import export_runner
from usip_tpu_torch.train.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from usip_tpu_torch.train.descriptor_loop import init_descriptor_state
from usip_tpu_torch.train.loop import init_detector_state
from usip_tpu_torch.weights import (seeded_descriptor_state_dict,
                                    seeded_state_dict)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
N, M, BATCH = 256, 16, 3
# tests/test_torch_indoor.py's export width (fp32; balls of 64 in 20 m hold
# the whole fragment, so the packages' fp32 keypoints move no point across
# a ball's boundary)
EXPORT = {"data.input_pc_num": N, "data.node_num": M,
          "data.fps_subsample_ratio": 2, "detector.c1": 32,
          "detector.c2": 64, "detector.compute_dtype": "float32",
          "detector.fusion_backend": "pallas",
          "descriptor.ball_nsamples": 64, "descriptor.ball_radius": 20.0,
          "descriptor.compute_dtype": "float32", "train.batch_size": BATCH}


def _script(name, monkeypatch):
    monkeypatch.syspath_prepend(SCRIPTS)
    spec = importlib.util.spec_from_file_location(
        f"{name}_script", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``indoor gen``'s layout, small: a SceneNN tree (for the config's
    dataroot) and one 3DMatch scene of 5 fragments of 1500 points."""
    root = tmp_path_factory.mktemp("indoor_drivers")
    build_synthetic_scenenn_tree(str(root / "scenenn"), train_frames=4,
                                 test_frames=4, target_points=600, seed=0)
    build_synthetic_match3d_fragments(str(root / "match3d"), scenes=1,
                                      fragments_per_scene=5,
                                      target_points=1500, seed=1)
    return root


def _features(root, tag, dim):
    """A feature tree: 40 points of each fragment, unit descriptors that
    repeat across fragments by room position (up to noise)."""
    pc_root = os.path.join(root, "match3d", "fragments")
    rng = np.random.default_rng(3)
    proj = rng.normal(size=(3, dim))
    for scene in sorted(os.listdir(pc_root)):
        n = len([f for f in os.listdir(os.path.join(pc_root, scene))
                 if f.endswith(".npy")])
        for i in range(n):
            pc = np.load(os.path.join(pc_root, scene, f"{i}.npy"))[:, :3]
            kp = pc[rng.choice(len(pc), 40, replace=False)]
            desc = np.sin(kp @ proj * 2.0) + rng.normal(0, 0.05, (40, dim))
            desc /= np.linalg.norm(desc, axis=1, keepdims=True)
            out = os.path.join(root, f"features_{tag}", scene)
            os.makedirs(out, exist_ok=True)
            np.concatenate([kp, desc], 1).astype(np.float32).tofile(
                os.path.join(out, f"{i}.bin"))


def test_diag_prints_the_scripts_line(tree, monkeypatch):
    _features(str(tree), "probe", 32)
    args = ["--root", str(tree), "--tag", "probe", "--desc-len", "32",
            "--max-trials", "200"]
    script = _script("diag_indoor", monkeypatch)
    monkeypatch.setattr(sys, "argv", ["diag_indoor.py", *args])
    ref = _last_json(script.main)
    ours = _last_json(indoor.main, ["diag", *args])
    assert ours == ref
    scene = next(iter(ours["scenes"].values()))
    assert scene["gt_pairs"] > 0
    assert {"recall", "precision"} <= set(scene["oracle"])


def _jax_draws(i):
    """usip_tpu's fragment export draws (tests/test_torch_indoor.py)."""
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


class _OneWorker:
    def __init__(self, cls):
        self.cls = cls

    def __call__(self, *args, **kw):
        return self.cls(*args, **{**kw, "num_workers": 1})


def test_eval_arm_matches_the_script(tree, tmp_path, monkeypatch):
    root = tmp_path / "root"
    root.mkdir()
    for sub in ("scenenn", "match3d"):
        os.symlink(tree / sub, root / sub)
    over = {**EXPORT, "data.dataroot": str(root / "scenenn")}
    cfg = get_config("scenenn", role="descriptor", **over)
    jcfg = jax_get_config("scenenn", role="descriptor", **over)
    rng = np.random.default_rng(2)
    pc = rng.normal(size=(1, N, 3)).astype(np.float32)
    sn = rng.normal(size=(1, N, 4)).astype(np.float32)
    jdet, jdesc = JaxDetector(jcfg.detector), JaxDescriptor(jcfg.descriptor)
    det_vars = convert_detector_state_dict(
        seeded_state_dict(cfg.detector, 4), jax.eval_shape(
            lambda: jdet.init(jax.random.PRNGKey(0), pc, sn, pc[:, :M],
                              train=False)))
    desc_vars = convert_descriptor_state_dict(
        seeded_descriptor_state_dict(cfg.descriptor, 5), jax.eval_shape(
            lambda: jdesc.init(jax.random.PRNGKey(0), pc, sn, pc[:, :M],
                               key=jax.random.PRNGKey(1), train=False)))
    det_dir = root / "ckpt" / "indoor"
    det_dir.mkdir(parents=True)
    paths = {}
    for name, v, folder, init in (
            ("det", det_vars, det_dir, init_detector_state),
            ("desc", desc_vars, root, init_descriptor_state)):
        msgpack = str(folder / ("best.msgpack" if name == "det"
                                else "desc.msgpack"))
        jax_save_checkpoint(msgpack, JaxTrainState.create(
            v, jax_make_adam(jcfg.train.lr)))
        state = init(cfg)
        restore_checkpoint(msgpack, state)
        pt = msgpack.replace(".msgpack", ".pt")
        save_checkpoint(pt, state)
        paths[name] = (msgpack, pt)
    monkeypatch.setattr(jax_export_runner, "BatchLoader",
                        _OneWorker(jax_export_runner.BatchLoader))
    monkeypatch.setattr(export_runner, "BatchLoader",
                        _OneWorker(export_runner.BatchLoader))
    run = export_runner.run_export_fragments

    def with_jax_draws(*a, **kw):
        return run(*a, **kw, node_draws=lambda i: _jax_draws(i)[0],
                   ball_priorities=lambda i: _jax_draws(i)[1])

    monkeypatch.setattr(export_runner, "run_export_fragments", with_jax_draws)
    flags = [a for k, v in over.items() if k != "data.dataroot"
             for a in ("--override", f"{k}={json.dumps(v)}")]
    common = ["--root", str(root), "--max-trials", "300",
              "--num-keypoints", str(M)] + flags
    script = _script("eval_indoor_arm", monkeypatch)
    monkeypatch.setattr(sys, "argv", [
        "eval_indoor_arm.py", *common, "--desc-ckpt", paths["desc"][0],
        "--tag", "ref", "--platform", "cpu"])
    ref = _last_json(script.main)
    ours = _last_json(indoor.main, ["eval-arm", *common, "--desc-ckpt",
                                    paths["desc"][1], "--tag", "port",
                                    "--device", "cpu"])
    assert sorted(ours) == sorted(ref)
    assert (ours["phase"], ours["tag"], ours["desc_ckpt"]) == (
        "eval_arm", "port", paths["desc"][1])
    assert ours["frames"] == ref["frames"] == 5
    for k in ref:
        if k not in ("tag", "desc_ckpt", "per_scene"):
            assert ours[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-9), k
    assert ours["per_scene"] == ref["per_scene"]
    for i in range(5):
        scene = sorted(ours["per_scene"])[0]
        a = np.fromfile(root / "features_port" / scene / f"{i}.bin",
                        np.float32)
        b = np.fromfile(root / "features_ref" / scene / f"{i}.bin",
                        np.float32)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_probe_selection_toy(tmp_path):
    out = _last_json(indoor.main, [
        "probe-selection", "--epochs", "2", "--det-epochs", "1", "--size",
        "32", "--out", str(tmp_path / "probe"), "--device", "cpu"])
    assert sorted(out) == ["curve", "epochs", "probe", "selected"]
    assert out["probe"] == "desc_selection" and out["epochs"] == 2
    assert [sorted(c) for c in out["curve"]] == [
        ["epoch", "loss", "match_acc"]] * 2
    assert sorted(out["selected"]) == ["by_loss", "by_match_acc"]
    for sel in out["selected"].values():
        assert sorted(sel) == ["epoch", "external_yaw_acc", "test_loss",
                               "test_match_acc"]
        assert 0.0 <= sel["external_yaw_acc"] <= 1.0
    assert os.path.exists(tmp_path / "probe" / "desc" / "epoch_1.pt")
