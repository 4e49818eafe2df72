"""The port's own host code against usip_tpu's, on the CPU.

usip_tpu_torch imports nothing of usip_tpu: it keeps its own copies of the
config presets, ``data/{common,preprocess,synthetic,loaders,pipeline,
eval_loaders,descriptor_loaders}`` (the indoor tree builders, the
SceneNN pair loader and the Redwood, 3DMatch and rotated-ModelNet frames
among them), the host coordinate flip, ``utils/logging``,
``eval/{export,repeatability,eval_runner,registration,indoor,fgr,baselines}``
(the ISS, Harris-3D and SIFT-3D baselines among them), the rendering
helpers ``utils/{vis,html}`` and the CLI's ``_sn_columns``.
These tests hold each copy equal to usip_tpu's bit for bit on the same
inputs and seeds (the loaders on their numpy path: both packages' native
batch loaders switched off; ``tests/test_torch_native_loaders.py`` holds
the default native path), and show in a fresh interpreter that importing
the port loads no ``usip_tpu``, jax, flax or msgpack module and that its
host library is the one it built under ``build/``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import usip_tpu.native
import usip_tpu_torch.native
from usip_tpu import cli as jax_cli
from usip_tpu import config as jax_config
from usip_tpu.data import augment as jax_augment
from usip_tpu.data import common as jax_common
from usip_tpu.data import descriptor_loaders as jax_desc_loaders
from usip_tpu.data import eval_loaders as jax_eval_loaders
from usip_tpu.data import loaders as jax_loaders
from usip_tpu.data import pipeline as jax_pipeline
from usip_tpu.data import preprocess as jax_preprocess
from usip_tpu.data import synthetic as jax_synthetic
from usip_tpu.data.common import subsample_fixed as jax_subsample_fixed
from usip_tpu.eval import baselines as jax_baselines
from usip_tpu.eval import eval_runner as jax_eval_runner
from usip_tpu.eval import export as jax_export
from usip_tpu.eval import indoor as jax_indoor
from usip_tpu.eval import registration as jax_registration
from usip_tpu.eval import repeatability as jax_repeatability
from usip_tpu.utils import logging as jax_logging
from usip_tpu_torch import cli as torch_cli
from usip_tpu_torch import config as torch_config
from usip_tpu_torch.data import augment as torch_augment
from usip_tpu_torch.data import common as torch_common
from usip_tpu_torch.data import descriptor_loaders as torch_desc_loaders
from usip_tpu_torch.data import eval_loaders as torch_eval_loaders
from usip_tpu_torch.data import loaders as torch_loaders
from usip_tpu_torch.data import pipeline as torch_pipeline
from usip_tpu_torch.data import preprocess as torch_preprocess
from usip_tpu_torch.data import synthetic as torch_synthetic
from usip_tpu_torch.data.common import subsample_fixed
from usip_tpu_torch.eval import baselines as torch_baselines
from usip_tpu_torch.eval import eval_runner as torch_eval_runner
from usip_tpu_torch.eval import export as torch_export
from usip_tpu_torch.eval import indoor as torch_indoor
from usip_tpu_torch.eval import registration as torch_registration
from usip_tpu_torch.eval import repeatability as torch_repeatability
from usip_tpu_torch.utils import logging as torch_logging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASETS = sorted(jax_config.PRESETS)
OVERRIDES = {"data.input_pc_num": 4096, "detector.grouping": "ball",
             "train.epochs": 3}


@pytest.mark.parametrize("role", ["detector", "descriptor"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_config_presets_equal_usip_tpu(dataset, role):
    """Every preset and role, with and without dotted overrides."""
    assert sorted(torch_config.PRESETS) == DATASETS
    for overrides in ({}, OVERRIDES):
        ours = torch_config.get_config(dataset, role, **overrides)
        ref = jax_config.get_config(dataset, role, **overrides)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert json.loads(ours.to_json()) == json.loads(ref.to_json())
    assert (dataclasses.asdict(torch_config.lite_detector(ours.detector))
            == dataclasses.asdict(jax_config.lite_detector(ref.detector)))


def test_config_rejects_what_usip_tpu_rejects():
    for fn in (torch_config.get_config, jax_config.get_config):
        with pytest.raises(KeyError):
            fn("nowhere")
        with pytest.raises(ValueError):
            fn("kitti", role="trainer")


@pytest.mark.parametrize("m,n", [(5000, 4096), (4096, 4096), (1500, 4096),
                                 (7, 100)])
def test_subsample_fixed_equals_usip_tpu(m, n):
    """Same seed, same rows (longer and shorter clouds than n)."""
    data = np.random.default_rng(m).normal(size=(m, 7)).astype(np.float32)
    ours = subsample_fixed(np.random.default_rng(3), data, n)
    ref = jax_subsample_fixed(np.random.default_rng(3), data, n)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("nms_radius", [0.0, 0.5])
@pytest.mark.parametrize("desired", [16, 64, 300])
@pytest.mark.parametrize("return_sigmas", [False, True])
def test_select_keypoints_equals_usip_tpu(nms_radius, desired,
                                          return_sigmas):
    """NMS on and off, desired_num above and below M=128 proposals."""
    rng = np.random.default_rng(desired)
    kp = rng.uniform(-3, 3, size=(128, 3)).astype(np.float32)
    sig = rng.uniform(0, 1, size=128).astype(np.float32)
    pc = rng.normal(size=(2000, 3)).astype(np.float32)
    kw = dict(nms_radius=nms_radius, desired_num=desired,
              return_sigmas=return_sigmas)
    ours = torch_export.select_keypoints(kp, sig, pc,
                                         rng=np.random.default_rng(9), **kw)
    ref = jax_export.select_keypoints(kp, sig, pc,
                                      rng=np.random.default_rng(9), **kw)
    for a, b in zip(ours if return_sigmas else [ours],
                    ref if return_sigmas else [ref]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        torch_export.select_keypoint_indices(kp, sig, nms_radius=nms_radius,
                                             desired_num=desired),
        jax_export.select_keypoint_indices(kp, sig, nms_radius=nms_radius,
                                           desired_num=desired))
    for got, want in zip(torch_export.nms(kp, sig, nms_radius),
                         jax_export.nms(kp, sig, nms_radius)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [50, 128, 200])
def test_ensure_keypoint_number_equals_usip_tpu(num):
    rng = np.random.default_rng(num)
    kp = rng.normal(size=(128, 3)).astype(np.float32)
    pc = rng.normal(size=(1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        torch_export.ensure_keypoint_number(kp, pc, num,
                                            np.random.default_rng(1)),
        jax_export.ensure_keypoint_number(kp, pc, num,
                                          np.random.default_rng(1)))


@pytest.mark.parametrize("cols,s", [(3, 4), (5, 4), (7, 4), (9, 4), (4, 1)])
def test_sn_columns_equals_usip_tpu(cols, s):
    """No normals, fewer channels than the model wants (zero-padded),
    exactly as many, and more (cut)."""
    data = np.random.default_rng(cols).normal(size=(50, cols))
    ours = torch_cli._sn_columns(data, s)
    ref = jax_cli._sn_columns(data, s)
    if ref is None:
        assert ours is None
    else:
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)


PORT_MODULES = (
    "cli", "inference", "models", "ops", "weights", "ablate", "train",
    "losses", "bench", "quality", "data.augment", "data.common",
    "data.preprocess", "data.synthetic", "data.loaders", "data.pipeline",
    "data.eval_loaders", "utils.logging", "train.checkpoint", "train.loop",
    "eval.export", "eval.repeatability", "eval.eval_runner",
    "eval.export_runner", "eval.baselines", "eval.registration",
    "data.descriptor_loaders", "models.descriptor", "train.descriptor_loop",
    "eval.indoor", "eval.fgr", "indoor", "parallel", "parallel.mesh",
    "parallel.collectives", "parallel.sharded_ops",
    "parallel.sharded_detector", "parallel.sharded_train",
    "parallel.sharded_descriptor", "parallel.tensor_parallel",
    "parallel.pipeline_parallel", "model_artifact", "fullscale", "ops.som",
    "eval.render", "utils.vis", "utils.html", "native", "prepare_kitti",
    "train.reference_runtime", "device")


def test_port_imports_nothing_of_usip_tpu():
    """A fresh interpreter imports every module of the port and finds
    neither ``usip_tpu`` nor any ``usip_tpu.*`` module loaded
    (``usip_tpu_torch`` shares the prefix, so the match is exact), nor jax,
    flax or msgpack; the host library it loads is its own build under
    ``build/``, not usip_tpu's ``native/``."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module('usip_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('usip_tpu', 'jax', 'flax', 'msgpack')]\n"
        "assert 'usip_tpu_torch.inference' in sys.modules\n"
        "assert 'usip_tpu_torch.train.loop' in sys.modules\n"
        "assert 'usip_tpu_torch.train.descriptor_loop' in sys.modules\n"
        "assert 'usip_tpu_torch.eval.fgr' in sys.modules\n"
        "from usip_tpu_torch import native\n"
        "assert native.available(), 'the host library did not load'\n"
        "lib = native.library_path().split('/')\n"
        "assert lib[-3:-1] == ['build', 'usip_tpu_torch'], lib\n"
        "assert 'native' not in lib and lib[-1].startswith('usip_native-')\n"
        "bad += [m for m in sys.modules\n"
        "        if m.split('.')[0] in ('usip_tpu', 'jax', 'flax', 'msgpack')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["train.steps", "train.loop",
                                    "train.descriptor_loop", "ops.som"])
def test_training_and_ops_do_not_load_serving(module):
    """Training and the ops sit below serving: a fresh interpreter that
    imports ``module`` has not loaded ``usip_tpu_torch.inference`` (the
    CUDA graphs and ``resolve_device`` live in ``usip_tpu_torch.device``)."""
    code = ("import importlib, sys\n"
            f"importlib.import_module('usip_tpu_torch.{module}')\n"
            "assert 'usip_tpu_torch.device' in sys.modules\n"
            "sys.exit(int('usip_tpu_torch.inference' in sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------ data and eval host code ----

def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _build_tree(builder, root):
    """A small synthetic KITTI tree: 2 frames of each train sequence, 8 of
    each test sequence, 600-point scans."""
    return builder(str(root), frames_per_seq=2, test_frames_per_seq=8,
                   target_points=600, seed=3)


@pytest.fixture(scope="module")
def kitti_trees(tmp_path_factory):
    """The same synthetic KITTI tree written by the port and by usip_tpu."""
    roots = {k: tmp_path_factory.mktemp(k) for k in ("port", "ref")}
    counts = (_build_tree(torch_synthetic.build_synthetic_kitti_tree,
                          roots["port"]),
              _build_tree(jax_synthetic.build_synthetic_kitti_tree,
                          roots["ref"]))
    assert counts[0] == counts[1]
    return roots


def test_synthetic_kitti_tree_equals_usip_tpu(kitti_trees):
    """Same files; .npy, calib and groundtruths bytes identical; pose .npz
    (zip members carry a time stamp) holds identical arrays."""
    port, ref = kitti_trees["port"], kitti_trees["ref"]
    files = _tree_files(port)
    assert files == _tree_files(ref) and len(files) > 40
    assert any(f.endswith("groundtruths.txt") for f in files)
    for f in files:
        a, b = os.path.join(port, f), os.path.join(ref, f)
        if f.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert np.array_equal(za[k], zb[k]), f
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f


@pytest.mark.parametrize("sn_len", [0, 3, 4])
def test_synthetic_dataset_equals_usip_tpu(sn_len):
    ours = torch_synthetic.SyntheticDataset(size=5, input_pc_num=128,
                                            surface_normal_len=sn_len, seed=2)
    ref = jax_synthetic.SyntheticDataset(size=5, input_pc_num=128,
                                         surface_normal_len=sn_len, seed=2)
    for i in range(5):
        a, b = ours[i], ref[i]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_common_and_preprocess_equal_usip_tpu(tmp_path):
    rng = np.random.default_rng(4)
    data = rng.normal(0, 50, size=(300, 8)).astype(np.float32)
    for sn_len in (0, 1, 3, 4):
        for a, b in zip(torch_common.split_pc_sn(data, sn_len),
                        jax_common.split_pc_sn(data, sn_len)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(torch_common.radius_crop(data, 40.0),
                          jax_common.radius_crop(data, 40.0))
    poses = np.tile(np.eye(4), (12, 1, 1))
    poses[:, :3, 3] = np.cumsum(rng.uniform(0, 3, size=(12, 3)), 0)
    for i in range(11):
        assert (torch_common.relative_translation_norm(poses[i], poses[i + 1])
                == jax_common.relative_translation_norm(poses[i],
                                                        poses[i + 1]))
    pairs = torch_preprocess.build_test_pairs(poses, 4.0)
    assert pairs and pairs == jax_preprocess.build_test_pairs(poses, 4.0)
    # rotations with w > 1e-8 and half-turns (the largest-diagonal branch)
    rots = [jax_synthetic._rand_rotation(rng) for _ in range(4)] + [
        np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])]
    for R in rots:
        assert np.array_equal(torch_preprocess.rotm_to_quat(R),
                              jax_preprocess.rotm_to_quat(R))
    for mod, name in ((torch_preprocess, "port"), (jax_preprocess, "ref")):
        mod.write_groundtruths_txt(str(tmp_path / name / "gt.txt"), poses,
                                   pairs)
    assert ((tmp_path / "port" / "gt.txt").read_bytes()
            == (tmp_path / "ref" / "gt.txt").read_bytes())
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    assert np.array_equal(torch_augment.coordinate_enu_to_cam(pts),
                          jax_augment.coordinate_enu_to_cam(pts))


def _kitti_cfgs(root, **extra):
    over = {"data.dataroot": str(root), "data.input_pc_num": 256,
            "data.parent_pc_num": 500, **extra}
    return (torch_config.get_config("kitti", **over).data,
            jax_config.get_config("kitti", **over).data)


def _assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("crop", [None, 30.0])
@pytest.mark.parametrize("mode", ["train", "test"])
def test_kitti_loaders_equal_usip_tpu(kitti_trees, monkeypatch, mode, crop):
    """KittiDataset and ParentCloudDataset items and their BatchLoader
    batches (shuffle order included), usip_tpu on its numpy path."""
    monkeypatch.setattr(usip_tpu.native, "available", lambda: False)
    monkeypatch.setattr(usip_tpu_torch.native, "available", lambda: False)
    ours_cfg, ref_cfg = _kitti_cfgs(kitti_trees["port"],
                                    **{"data.crop_radius": crop})
    ours = torch_loaders.make_detector_dataset("kitti", ours_cfg, mode, 4,
                                               seed=5)
    ref = jax_loaders.make_detector_dataset("kitti", ref_cfg, mode, 4, seed=5)
    assert len(ours) == len(ref) and len(ours) in (16, 18)
    assert ours.locate(len(ours) - 1) == ref.locate(len(ref) - 1)
    for i in (0, 3, len(ours) - 1):
        _assert_items_equal(ours[i], ref[i])
    for wrap_a, wrap_b in ((ours, ref),
                           (torch_loaders.ParentCloudDataset(ours),
                            jax_loaders.ParentCloudDataset(ref))):
        la = torch_pipeline.BatchLoader(wrap_a, 4, shuffle=True,
                                        num_workers=1, seed=7)
        lb = jax_pipeline.BatchLoader(wrap_b, 4, shuffle=True,
                                      num_workers=1, seed=7)
        assert len(la) == len(lb)
        for _ in range(2):  # two epochs: the shuffle RNG carries over
            batches_a, batches_b = list(la), list(lb)
            assert len(batches_a) == len(batches_b) == len(la)
            for a, b in zip(batches_a, batches_b):
                _assert_items_equal(a, b)


def test_modelnet_and_concat_loaders_equal_usip_tpu(tmp_path, monkeypatch):
    """The modelnet tree layout, ConcatSiameseDataset over two of them, and
    a cloud shorter than input_pc_num (padding by repetition)."""
    monkeypatch.setattr(usip_tpu.native, "available", lambda: False)
    monkeypatch.setattr(usip_tpu_torch.native, "available", lambda: False)
    rng = np.random.default_rng(8)
    (tmp_path / "modelnet40_shape_names.txt").write_text("chair\ndesk\n")
    names = {"train": ["chair_0001", "desk_0002", "chair_0003"],
             "test": ["desk_0004"]}
    for mode, items in names.items():
        (tmp_path / f"modelnet40_{mode}.txt").write_text(
            "\n".join(items) + "\n")
        for name in items:
            folder = tmp_path / name[:-5]
            folder.mkdir(exist_ok=True)
            n = 100 if name.endswith("3") else 400
            np.save(folder / f"{name}.npy",
                    rng.normal(size=(n, 6)).astype(np.float32))
    over = {"data.dataroot": str(tmp_path), "data.input_pc_num": 256}
    ours_cfg = torch_config.get_config("modelnet", **over).data
    ref_cfg = jax_config.get_config("modelnet", **over).data
    ours = [torch_loaders.make_detector_dataset("modelnet", ours_cfg, m, 3,
                                                seed=1) for m in names]
    ref = [jax_loaders.make_detector_dataset("modelnet", ref_cfg, m, 3,
                                             seed=1) for m in names]
    for a, b in zip(ours, ref):
        for i in range(len(a)):
            _assert_items_equal(a[i], b[i])
    ca = torch_loaders.ConcatSiameseDataset(ours)
    cb = jax_loaders.ConcatSiameseDataset(ref)
    assert len(ca) == len(cb) == 4
    for i in range(4):
        _assert_items_equal(ca[i], cb[i])


def test_batch_loader_order_equals_usip_tpu():
    """Shuffle order, drop_last on and off, post_collate, over epochs."""

    class Items:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

        def __getitem__(self, i):
            return {"x": np.full((2,), i, np.int64)}

    for drop_last in (True, False):
        kw = dict(batch_size=4, shuffle=True, num_workers=3, seed=11,
                  drop_last=drop_last,
                  post_collate=lambda b, row: {**b, "row": np.asarray(row)})
        la = torch_pipeline.BatchLoader(Items(10), **kw)
        lb = jax_pipeline.BatchLoader(Items(10), **kw)
        assert len(la) == len(lb) == (2 if drop_last else 3)
        for _ in range(3):
            for a, b in zip(list(la), list(lb), strict=True):
                _assert_items_equal(a, b)


def test_logging_equals_usip_tpu(tmp_path):
    """RunningAverages' weighted means; MetricsLogger's records (but the
    wall clock) and snapshot payloads."""
    ra, rb = torch_logging.RunningAverages(), jax_logging.RunningAverages()
    for i in range(5):
        m = {"loss": 0.1 * i + 0.3, "chamfer": -i / 7}
        ra.update(m, weight=i + 1)
        rb.update(m, weight=i + 1)
    assert ra.averages() == rb.averages()
    assert torch_logging.RunningAverages().averages() == {}
    records = []
    for mod, name in ((torch_logging, "port"), (jax_logging, "ref")):
        log = mod.MetricsLogger(str(tmp_path / name), "t")
        log.log(3, 1, {"loss": np.float32(0.25), "lr": 1e-3},
                prefix="test")
        path = log.snapshot_clouds("scene", 3, pc=np.ones((4, 3)))
        log.close()
        with open(log.path) as f:
            rec = json.loads(f.read())
        rec.pop("wall")
        records.append((rec, os.path.relpath(path, tmp_path / name),
                        dict(np.load(path))))
    assert records[0][:2] == records[1][:2]
    assert np.array_equal(records[0][2]["pc"], records[1][2]["pc"])
    ta, tb = torch_logging.Throughput(), jax_logging.Throughput(1)
    for t in (ta, tb):
        t.add(16)
        assert t._clouds == 16 and t.rate() > 0.0


def _write_bins(root, rng, frames, rows=20):
    for seq, frame in frames:
        torch_export.write_keypoints_bin(
            os.path.join(root, f"{seq:02d}", f"{frame}.bin"),
            rng.normal(0, 4, size=(rows, 3)))


def test_eval_runner_and_repeatability_equal_usip_tpu(kitti_trees, tmp_path):
    """GT tables, calib reads, the coordinate fixes and repeatability on
    the same .bin trees; the bin writer and reader against usip_tpu's."""
    root = str(kitti_trees["port"])
    gt_root = os.path.join(root, "kitti-reg-test")
    gts = []
    for mod in (torch_eval_runner, jax_eval_runner):
        gt = []
        for seq in (9, 10):
            gt.extend(mod.load_kitti_gt_table(gt_root, seq))
        gts.append(gt)
    assert len(gts[0]) == len(gts[1]) > 0
    for a, b in zip(*gts):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)
    calib = os.path.join(root, "calib", "09", "calib.txt")
    ca, cb = (mod.read_kitti_calib(calib)
              for mod in (torch_eval_runner, jax_eval_runner))
    assert ca.keys() == cb.keys() and all(np.array_equal(ca[k], cb[k])
                                          for k in ca)
    rng = np.random.default_rng(12)
    q = rng.normal(size=4)
    assert np.array_equal(torch_eval_runner.quat_to_rotm(q),
                          jax_eval_runner.quat_to_rotm(q))
    pts = rng.normal(0, 10, size=(40, 3))
    assert np.array_equal(torch_eval_runner.cam_to_enu(pts),
                          jax_eval_runner.cam_to_enu(pts))
    assert np.array_equal(torch_eval_runner.cam_to_velodyne(pts, ca["Tr"]),
                          jax_eval_runner.cam_to_velodyne(pts, cb["Tr"]))
    frames = {(r["seq"], r[k]) for r in gts[0] for k in ("anc_idx", "pos_idx")}
    kp_a, kp_b = str(tmp_path / "a"), str(tmp_path / "b")
    _write_bins(kp_a, np.random.default_rng(1), sorted(frames))
    _write_bins(kp_b, np.random.default_rng(2), sorted(frames))
    f = os.path.join(kp_a, "09", f"{gts[0][0]['anc_idx']}.bin")
    jax_export.write_keypoints_bin(str(tmp_path / "ref.bin"),
                                   torch_export.read_keypoints_bin(f))
    assert (tmp_path / "ref.bin").read_bytes() == open(f, "rb").read()
    calib_root = os.path.join(root, "calib")
    for kind in ("none", "kitti", "oxford"):
        fa = torch_eval_runner.make_coord_fix(kind, calib_root)
        fb = jax_eval_runner.make_coord_fix(kind, calib_root)
        assert (fa is None) == (fb is None)
        if fa is not None:
            assert np.array_equal(fa(pts, 9), fb(pts, 9))
        for anc, pos in ((kp_a, kp_a), (kp_a, kp_b)):
            for radius in (0.5, 2.0):
                ma, arr_a = torch_eval_runner.run_repeatability(
                    anc, pos, gts[0], inlier_radius=radius, coord_fix=fa)
                mb, arr_b = jax_eval_runner.run_repeatability(
                    anc, pos, gts[1], inlier_radius=radius, coord_fix=fb)
                assert ma == mb and np.array_equal(arr_a, arr_b)
    pairs = [(rng.normal(size=(30, 3)), rng.normal(size=(25, 3)),
              np.eye(4)) for _ in range(3)]
    assert (torch_repeatability.dataset_repeatability(pairs, 1.0)[0]
            == jax_repeatability.dataset_repeatability(pairs, 1.0)[0])


def test_oxford_gt_and_frames_equal_usip_tpu(tmp_path, monkeypatch):
    """Oxford's groundtruths.pkl table and test frames (ENU -> camera)."""
    import pickle
    folder = tmp_path / "test_models_20k_np_nofilter"
    folder.mkdir()
    rng = np.random.default_rng(13)
    entries = [{"anc_idx": i, "pos_idx": i + 1, "t": rng.normal(size=3),
                "q": rng.normal(size=4)} for i in range(3)]
    with open(folder / "groundtruths.pkl", "wb") as f:
        pickle.dump(entries, f)
    for i in range(4):
        np.save(folder / f"{i}.npy",
                rng.normal(size=(300, 8)).astype(np.float32))
    ga = torch_eval_runner.load_oxford_gt_pkl(str(tmp_path))
    gb = jax_eval_runner.load_oxford_gt_pkl(str(tmp_path))
    for a, b in zip(ga, gb, strict=True):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    over = {"data.dataroot": str(tmp_path), "data.input_pc_num": 256}
    fa = torch_eval_loaders.OxfordTestFrames(
        torch_config.get_config("oxford", **over).data, seed=2, count=4)
    fb = jax_eval_loaders.OxfordTestFrames(
        jax_config.get_config("oxford", **over).data, seed=2, count=4)
    for i in range(4):
        _assert_items_equal(fa[i], fb[i])
    monkeypatch.setattr(usip_tpu.native, "available", lambda: False)
    monkeypatch.setattr(usip_tpu_torch.native, "available", lambda: False)
    over["data.crop_radius"] = None
    da = torch_loaders.make_detector_dataset(
        "oxford", torch_config.get_config("oxford", **over).data, "test", 4,
        seed=3)
    db = jax_loaders.make_detector_dataset(
        "oxford", jax_config.get_config("oxford", **over).data, "test", 4,
        seed=3)
    for i in range(3):
        _assert_items_equal(da[i], db[i])


def test_kitti_test_frames_equal_usip_tpu(kitti_trees):
    root = str(kitti_trees["port"])
    args = dict(txt_root=os.path.join(root, "kitti-reg-test"),
                numpy_root=os.path.join(root, "data_odometry_velodyne",
                                        "numpy"), seed=4)
    cfg_a, cfg_b = _kitti_cfgs(root)
    pa = torch_eval_loaders.load_kitti_test_pairs(args["txt_root"], 9)
    assert pa == jax_eval_loaders.load_kitti_test_pairs(args["txt_root"], 9)
    fa = torch_eval_loaders.KittiTestFrames(cfg_a, **args)
    fb = jax_eval_loaders.KittiTestFrames(cfg_b, **args)
    assert len(fa) == len(fb) >= 4
    for i in range(len(fa)):
        _assert_items_equal(fa[i], fb[i])


@pytest.mark.parametrize("mode", ["train", "test"])
def test_kitti_descriptor_loader_equals_usip_tpu(kitti_trees, monkeypatch,
                                                 mode):
    """KittiDescriptorDataset item for item (the bounded positive search,
    the poses), its pose-distance negative mining, and the pair batches of
    a BatchLoader; usip_tpu on its numpy path."""
    monkeypatch.setattr(usip_tpu.native, "available", lambda: False)
    monkeypatch.setattr(usip_tpu_torch.native, "available", lambda: False)
    over = {"data.positive_radius": 6.0, "data.negative_radius": 8.0}
    ours_cfg, ref_cfg = _kitti_cfgs(kitti_trees["port"], **over)
    ours = torch_desc_loaders.KittiDescriptorDataset(ours_cfg, mode, seed=5)
    ref = jax_desc_loaders.KittiDescriptorDataset(ref_cfg, mode, seed=5)
    assert len(ours) == len(ref) > 0
    for i in range(len(ours)):
        _assert_items_equal(ours[i], ref[i])
    for i in (0, len(ours) - 1):
        a, b = ours.base.load_pose(i), ref.base.load_pose(i)
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
    la = torch_pipeline.BatchLoader(ours, 4, shuffle=True, num_workers=1,
                                    seed=7)
    lb = jax_pipeline.BatchLoader(ref, 4, shuffle=True, num_workers=1, seed=7)
    for a, b in zip(list(la), list(lb), strict=True):
        _assert_items_equal(a, b)
        np.testing.assert_array_equal(
            ours.mine_negative_indices(a["seq"], a["pose"],
                                       np.random.default_rng(1)),
            ref.mine_negative_indices(b["seq"], b["pose"],
                                      np.random.default_rng(1)))


def test_oxford_descriptor_loader_equals_usip_tpu(tmp_path):
    """OxfordDescriptorDataset on a small Oxford tree (train_relative.txt
    with positive and non-negative lists, the test groundtruths.pkl), and
    its list-based negative mining."""
    import pickle
    rng = np.random.default_rng(14)
    train = tmp_path / "train_np_nofilter"
    test = tmp_path / "test_models_20k_np_nofilter"
    train.mkdir()
    test.mkdir()
    lines = []
    for i in range(6):
        np.save(train / f"{i}.npy", rng.normal(
            0, 10, size=(400, 8)).astype(np.float32))
        pos = [j for j in (i - 1, i + 1) if 0 <= j < 6]
        lines.append(f"{i}.bin | {' '.join(map(str, pos))} | "
                     f"{' '.join(map(str, pos + [i]))}")
    (tmp_path / "train_relative.txt").write_text("\n".join(lines) + "\n")
    for i in range(4):
        np.save(test / f"{i}.npy", rng.normal(
            0, 10, size=(400, 8)).astype(np.float32))
    with open(test / "groundtruths.pkl", "wb") as f:
        pickle.dump([{"anc_idx": i, "pos_idx": i + 1} for i in range(3)], f)
    over = {"data.dataroot": str(tmp_path), "data.input_pc_num": 256}
    sets = {}
    for mode in ("train", "test"):
        ours = torch_desc_loaders.OxfordDescriptorDataset(
            torch_config.get_config("oxford", **over).data, mode, seed=2)
        ref = jax_desc_loaders.OxfordDescriptorDataset(
            jax_config.get_config("oxford", **over).data, mode, seed=2)
        assert len(ours) == len(ref) > 0
        for i in range(len(ours)):
            _assert_items_equal(ours[i], ref[i])
        sets[mode] = ours, ref
    ours, ref = sets["train"]
    idx = np.array([0, 1, 3, 5])
    np.testing.assert_array_equal(
        ours.mine_negative_indices(idx, np.random.default_rng(3)),
        ref.mine_negative_indices(idx, np.random.default_rng(3)))
    T = np.eye(4)
    T[:3, 3] = [1.0, -2.0, 0.5]
    pts = rng.normal(size=(20, 3))
    assert np.array_equal(torch_desc_loaders.cart_to_hom_apply(T, pts),
                          jax_desc_loaders.cart_to_hom_apply(T, pts))


def test_frame_yaw_matrix_equals_usip_tpu():
    """The descriptor export's per-frame yaw (``frame_yaw_seed``)."""
    from usip_tpu.eval import export_runner as jax_export_runner
    from usip_tpu_torch.eval import export_runner as torch_export_runner
    for seed, seq, frame in ((0, 9, 0), (5, 10, 17), (123, 0, 4)):
        assert np.array_equal(
            torch_export_runner._frame_yaw_matrix(seed, seq, frame),
            jax_export_runner._frame_yaw_matrix(seed, seq, frame))


def _registration_pairs(rng, n_pairs=3, m=40, dim=16):
    """Keypoint sets with descriptors, the positive a rigidly moved copy
    of the anchor with a few outliers, and its GT transform."""
    pairs = []
    for _ in range(n_pairs):
        kp = rng.uniform(-20, 20, size=(m, 3))
        desc = rng.normal(size=(m, dim))
        yaw = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                      [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        t = rng.normal(0, 3, size=3)
        pos = (kp - t) @ R  # anc = R pos + t
        pos[:5] += rng.normal(0, 5, size=(5, 3))
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        pairs.append((kp, desc, pos, desc + rng.normal(0, 0.05, desc.shape),
                      T))
    return pairs


def test_registration_equals_usip_tpu(kitti_trees, tmp_path):
    """1-NN matching, Kabsch, RANSAC, transform_error and
    evaluate_registration on the same pairs and seeds, and run_registration
    over .bin trees (keypoints and descriptors) with and without the kitti
    coordinate fix: the same numbers."""
    rng = np.random.default_rng(15)
    pairs = _registration_pairs(rng)
    a = torch_registration.evaluate_registration(pairs, max_trials=500)
    b = jax_registration.evaluate_registration(pairs, max_trials=500)
    assert a == b and a.success_rate > 0
    x1, x2 = pairs[0][0], pairs[0][2]
    for f in ("kabsch",):
        for u, v in zip(getattr(torch_registration, f)(x1[:8], x2[:8]),
                        getattr(jax_registration, f)(x1[:8], x2[:8])):
            assert np.array_equal(u, v)
    ra = torch_registration.ransac_rigid(x1, x2, max_trials=300, seed=4)
    rb = jax_registration.ransac_rigid(x1, x2, max_trials=300, seed=4)
    assert ra.trials == rb.trials and np.array_equal(ra.inliers, rb.inliers)
    assert np.array_equal(ra.R, rb.R) and np.array_equal(ra.t, rb.t)
    assert (torch_registration.transform_error(pairs[0][4], ra.R, ra.t)
            == jax_registration.transform_error(pairs[0][4], rb.R, rb.t))
    assert np.array_equal(
        torch_registration.match_descriptors_1nn(pairs[0][1], pairs[0][3]),
        jax_registration.match_descriptors_1nn(pairs[0][1], pairs[0][3]))

    root = str(kitti_trees["port"])
    gt = []
    for seq in (9, 10):
        gt.extend(jax_eval_runner.load_kitti_gt_table(
            os.path.join(root, "kitti-reg-test"), seq))
    frames = sorted({(r["seq"], r[k]) for r in gt
                     for k in ("anc_idx", "pos_idx")})
    kp_dir, desc_dir = str(tmp_path / "kp"), str(tmp_path / "desc")
    _write_bins(kp_dir, np.random.default_rng(1), frames, rows=30)
    for seq, frame in frames:
        torch_export.write_keypoints_bin(
            os.path.join(desc_dir, f"{seq:02d}", f"{frame}.bin"),
            np.random.default_rng(frame).normal(size=(30, 16)))
    calib_root = os.path.join(root, "calib")
    for kind in ("none", "kitti"):
        got = torch_eval_runner.run_registration(
            kp_dir, desc_dir, gt, desc_dim=16, max_trials=200,
            coord_fix=torch_eval_runner.make_coord_fix(kind, calib_root))
        want = jax_eval_runner.run_registration(
            kp_dir, desc_dir, gt, desc_dim=16, max_trials=200,
            coord_fix=jax_eval_runner.make_coord_fix(kind, calib_root))
        assert got._asdict().keys() == want._asdict().keys()
        for k, v in got._asdict().items():
            w = want._asdict()[k]
            assert v == w or (np.isnan(v) and np.isnan(w)), k


# ------------------------------------------------------------- indoor ----

@pytest.fixture(scope="module")
def indoor_trees(tmp_path_factory):
    """The same small synthetic SceneNN tree (6 train frames, 8 test
    frames of 700 points) and 3DMatch fragment tree (one scene of 5
    fragments of 900 points) written by the port and by usip_tpu."""
    roots = {k: tmp_path_factory.mktemp(f"indoor_{k}") for k in ("port",
                                                                  "ref")}
    for mod, key in ((torch_synthetic, "port"), (jax_synthetic, "ref")):
        root = roots[key]
        counts = mod.build_synthetic_scenenn_tree(
            str(root / "scenenn"), train_frames=6, test_frames=8,
            target_points=700, seed=2)
        frags = mod.build_synthetic_match3d_fragments(
            str(root / "match3d"), scenes=1, fragments_per_scene=5,
            target_points=900, seed=3)
        roots[key + "_counts"] = (counts, frags)
    assert roots["port_counts"] == roots["ref_counts"]
    return roots


def test_indoor_trees_equal_usip_tpu(indoor_trees):
    """Same files, every byte identical: frames, ``info_<mode>.pkl``,
    fragments, ``gt.log`` and ``gt.info``."""
    port, ref = indoor_trees["port"], indoor_trees["ref"]
    files = _tree_files(port)
    assert files == _tree_files(ref) and len(files) > 20
    for name in ("info_train.pkl", "gt.log", "gt.info"):
        assert any(f.endswith(name) for f in files), name
    for f in files:
        with open(os.path.join(port, f), "rb") as fa, \
                open(os.path.join(ref, f), "rb") as fb:
            assert fa.read() == fb.read(), f


@pytest.mark.parametrize("mode", ["train", "test"])
def test_scenenn_descriptor_loader_equals_usip_tpu(indoor_trees, mode):
    """SceneNNDescriptorDataset: the anchor ICP-aligned onto its positive,
    the test split subsampled by 3."""
    over = {"data.dataroot": str(indoor_trees["port"] / "scenenn"),
            "data.input_pc_num": 512}
    ours = torch_desc_loaders.SceneNNDescriptorDataset(
        torch_config.get_config("scenenn", "descriptor", **over).data, mode,
        seed=5)
    ref = jax_desc_loaders.SceneNNDescriptorDataset(
        jax_config.get_config("scenenn", "descriptor", **over).data, mode,
        seed=5)
    assert len(ours) == len(ref) > 0
    for i in range(len(ours)):
        _assert_items_equal(ours[i], ref[i])


def test_indoor_eval_frames_equal_usip_tpu(indoor_trees, tmp_path):
    """RedwoodFrames and Match3DEvalFrames over the fragment tree (its
    files renamed ``cloud_bin_<i>.npy`` for the latter), and
    ModelNetRotatedFrames over ``build_modelnet_rotated``'s tree, which
    both packages write byte for byte alike; ``make_eval_dataset`` picks
    the same classes."""
    from usip_tpu.eval import export_runner as jax_export_runner
    from usip_tpu_torch.eval import export_runner as torch_export_runner
    frag = indoor_trees["port"] / "match3d" / "fragments"
    scenes = sorted(os.listdir(frag))
    m3d = tmp_path / "m3d"
    for scene in scenes:
        (m3d / scene).mkdir(parents=True)
        for f in os.listdir(frag / scene):
            (m3d / scene / f"cloud_bin_{f}").write_bytes(
                (frag / scene / f).read_bytes())
    rng = np.random.default_rng(6)
    src = []
    for i in range(3):
        path = tmp_path / f"shape{i}.npy"
        np.save(path, rng.normal(size=(300, 6)).astype(np.float32))
        src.append(str(path))
    for mod, key in ((torch_preprocess, "port"), (jax_preprocess, "ref")):
        assert mod.build_modelnet_rotated(src, str(tmp_path / key), seed=1) \
            == 3
    assert _tree_files(tmp_path / "port") == _tree_files(tmp_path / "ref")
    for f in _tree_files(tmp_path / "port"):
        assert ((tmp_path / "port" / f).read_bytes()
                == (tmp_path / "ref" / f).read_bytes()), f
    cases = [("scenenn", str(frag), "RedwoodFrames", {"scenes": scenes}),
             ("match3d", str(m3d), "Match3DEvalFrames", {"scenes": scenes})]
    cases += [("modelnet", str(tmp_path / "port"), "ModelNetRotatedFrames",
               {"subset": sub}) for sub in ("original", "rotated")]
    for dataset, root, cls, kw in cases:
        over = {"data.dataroot": root, "data.input_pc_num": 256}
        cfg = torch_config.get_config(dataset, **over)
        jcfg = jax_config.get_config(dataset, **over)
        sn = cfg.detector.surface_normal_len
        ours = getattr(torch_eval_loaders, cls)(cfg.data, sn_len=sn, seed=4,
                                                **kw)
        ref = getattr(jax_eval_loaders, cls)(jcfg.data, sn_len=sn, seed=4,
                                             **kw)
        assert len(ours) == len(ref) > 0
        for i in range(len(ours)):
            _assert_items_equal(ours[i], ref[i])
        sub = kw.get("subset", "original")
        got = torch_export_runner.make_eval_dataset(cfg, subset=sub)
        want = jax_export_runner.make_eval_dataset(jcfg, subset=sub)
        assert type(got).__name__ == type(want).__name__ == cls
        if cls != "ModelNetRotatedFrames":
            continue  # the default scene lists are not in this tree
        for i in range(len(got)):
            _assert_items_equal(got[i], want[i])


def test_normals_and_voxels_equal_usip_tpu():
    """``estimate_normals`` (oriented to the origin and to a point) and
    ``voxel_downsample``."""
    rng = np.random.default_rng(7)
    pts = rng.normal(0, 2, size=(400, 3)).astype(np.float32)
    for k, toward in ((16, None), (7, np.array([1.0, 2.0, 3.0]))):
        for a, b in zip(torch_preprocess.estimate_normals(pts, k, toward),
                        jax_preprocess.estimate_normals(pts, k, toward)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    feats = np.concatenate([pts, rng.normal(size=(400, 2))], 1)
    for size in (0.3, 1.0):
        assert np.array_equal(torch_preprocess.voxel_downsample(feats, size),
                              jax_preprocess.voxel_downsample(feats, size))


def _fragments(rng, n_frag=4, n_pc=600, m=60, dim=16):
    """Fragments of one scene: a shared point set seen from moved frames,
    keypoints on the same points but 10 (drawn anew a fragment), with
    descriptors that match across fragments up to noise, and 5 outlier
    keypoints; the gt poses."""
    world = rng.uniform(-3, 3, size=(n_pc, 3))
    base_desc = rng.normal(size=(n_pc, dim))
    frags, poses = [], []
    for _ in range(n_frag):
        sel = np.concatenate([np.arange(m - 10), rng.choice(
            np.arange(m - 10, n_pc), 10, replace=False)])
        yaw = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                      [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, rng.normal(0, 1, size=3)
        local = (world - T[:3, 3]) @ R
        kp = local[sel] + rng.normal(0, 0.01, size=(m, 3))
        kp[:5] += rng.normal(0, 2, size=(5, 3))
        desc = base_desc[sel] + rng.normal(0, 0.05, size=(m, dim))
        frags.append((local, kp, desc))
        poses.append(T)
    return frags, poses


def test_indoor_registration_equals_usip_tpu(tmp_path):
    """``knn_union_matches``, ``information_matrix``, ``register_fragments``
    with RANSAC and with FGR, ``run_scene_registration``, the ``.log``
    writers and readers (the same bytes), ``transformation_error``,
    ``evaluate_scene(s)`` and ``summarize``: the same numbers."""
    rng = np.random.default_rng(8)
    frags, poses = _fragments(rng)
    (pc1, kp1, d1), (pc2, kp2, d2) = frags[0], frags[1]
    for k in (1, 5):
        assert np.array_equal(torch_indoor.knn_union_matches(d1, d2, k),
                              jax_indoor.knn_union_matches(d1, d2, k))
    assert np.array_equal(torch_indoor.information_matrix(kp1),
                          jax_indoor.information_matrix(kp1))
    for est in ("ransac", "fgr"):
        a = torch_indoor.register_fragments(pc1, pc2, kp1, d1, kp2, d2,
                                            max_trials=3000, seed=2,
                                            estimator=est)
        b = jax_indoor.register_fragments(pc1, pc2, kp1, d1, kp2, d2,
                                          max_trials=3000, seed=2,
                                          estimator=est)
        assert a.num_inliers == b.num_inliers > 0, est
        assert a.inlier_ratio == b.inlier_ratio, est
        assert a.ratio_aligned == b.ratio_aligned, est
        assert np.array_equal(a.trans, b.trans), est
        assert np.array_equal(a.information, b.information), est
    n = len(frags)
    gt = [jax_indoor.LogEntry(i, j, n, np.linalg.inv(poses[i]) @ poses[j])
          for i in range(n) for j in range(i + 1, n)]
    info = [jax_indoor.LogEntry(e.i, e.j, n, np.eye(4),
                                information=jax_indoor.information_matrix(
                                    frags[e.i][1]))
            for e in gt]
    gt_dir = tmp_path / "gt" / "s0-evaluation"
    gt_dir.mkdir(parents=True)
    with open(gt_dir / "gt.log", "w") as f:
        for e in gt:
            f.write(f"{e.i}\t{e.j}\t{e.n}\n")
            for row in e.trans:
                f.write("\t".join(f"{v:.10f}" for v in row) + "\n")
    with open(gt_dir / "gt.info", "w") as f:
        for e in info:
            f.write(f"{e.i}\t{e.j}\t{e.n}\n")
            for row in e.information:
                f.write("\t".join(f"{v:.8f}" for v in row) + "\n")
    logs = {}
    for mod, key in ((torch_indoor, "port"), (jax_indoor, "ref")):
        for est in ("ransac", "fgr"):
            entries = mod.run_scene_registration(frags, max_trials=3000,
                                                 seed=3, estimator=est)
            path = tmp_path / f"{key}_{est}.log"
            mod.write_log_my(str(path), entries)
            logs[key, est] = str(path)
    for est in ("ransac", "fgr"):
        assert (open(logs["port", est], "rb").read()
                == open(logs["ref", est], "rb").read()), est
        assert torch_indoor.load_result_log(logs["port", est])
    for loader in ("load_log", "load_info", "load_log_my"):
        path = str(gt_dir / ("gt.info" if loader == "load_info" else
                             "gt.log")) if loader != "load_log_my" \
            else logs["port", "ransac"]
        for e, f in zip(getattr(torch_indoor, loader)(path),
                        getattr(jax_indoor, loader)(path)):
            assert (e.i, e.j, e.n) == (f.i, f.j, f.n)
            assert np.array_equal(e.trans, f.trans)
    delta = np.linalg.inv(gt[1].trans) @ poses[2]
    assert (torch_indoor.transformation_error(delta, info[1].information)
            == jax_indoor.transformation_error(delta, info[1].information))
    for est in ("ransac", "fgr"):
        got = torch_indoor.evaluate_scenes({"s0": logs["port", est]},
                                           str(tmp_path / "gt"))
        want = jax_indoor.evaluate_scenes({"s0": logs["port", est]},
                                          str(tmp_path / "gt"))
        assert json.dumps({k: v._asdict() for k, v in got.items()}) == \
            json.dumps({k: v._asdict() for k, v in want.items()})
        assert torch_indoor.summarize(got) == jax_indoor.summarize(want)
        assert got["s0"].rs_num > 0


# ------------------------------------------------- classical baselines ----

def _world_scan(seed, n):
    """n points of a synthetic street (ground, boxes, poles) within 12 m of
    its start, float32 as the loaders give them."""
    rng = np.random.default_rng(seed)
    pts, _, _ = torch_synthetic._make_world(rng, 20.0)
    near = pts[np.linalg.norm(pts[:, :2] - [5.0, 0.0], axis=1) < 12.0]
    return near[rng.choice(near.shape[0], n, replace=False)]


@pytest.mark.parametrize("method,kwargs", [
    ("iss", {}), ("iss", {"salient_radius": 1.0, "non_max_radius": 0.5,
                          "max_keypoints": 20}),
    ("harris", {}), ("harris", {"radius": 0.6, "nms_radius": 0.4,
                                "threshold": -1e-4, "max_keypoints": 16}),
    ("sift", {"n_octaves": 2, "n_scales_per_octave": 3}),
    ("sift", {"min_scale": 0.3, "n_octaves": 1, "max_keypoints": 12}),
    ("random", {"num": 50})])
def test_baselines_equal_usip_tpu(method, kwargs):
    """ISS, Harris-3D, SIFT-3D and random keypoints through
    ``baseline_keypoints``, bit for bit on the same scan and seed."""
    pc = _world_scan(5, 600)
    ours = torch_baselines.baseline_keypoints(
        method, pc, np.random.default_rng(1), **kwargs)
    ref = jax_baselines.baseline_keypoints(
        method, pc, np.random.default_rng(1), **kwargs)
    assert ours.dtype == ref.dtype and ours.shape[0] > 0
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("rng_seed", [None, 3])
def test_sift_subsampling_equals_usip_tpu(monkeypatch, rng_seed):
    """Past ``SIFT_MAX_POINTS`` (the same constant) SIFT runs on a random
    subset of the cloud, drawn from the caller's generator or from seed 0:
    the same subset in both packages (the detector itself replaced by the
    identity, as it takes minutes at that size); below it, and with
    ``sift_max_points`` lowered, the real detector on the same subset."""
    assert torch_baselines.SIFT_MAX_POINTS == jax_baselines.SIFT_MAX_POINTS
    rng = (lambda: None) if rng_seed is None else (
        lambda: np.random.default_rng(rng_seed))
    big = np.random.default_rng(7).normal(
        0, 5, (jax_baselines.SIFT_MAX_POINTS + 300, 3)).astype(np.float32)
    for mod in (torch_baselines, jax_baselines):
        monkeypatch.setattr(mod, "sift3d_keypoints", lambda pc, **kw: pc)
    ours = torch_baselines.baseline_keypoints("sift", big, rng())
    assert ours.shape == (jax_baselines.SIFT_MAX_POINTS, 3)
    np.testing.assert_array_equal(
        ours, jax_baselines.baseline_keypoints("sift", big, rng()))
    monkeypatch.undo()
    pc = _world_scan(6, 400)
    kw = {"sift_max_points": 250, "n_octaves": 1, "n_scales_per_octave": 3}
    np.testing.assert_array_equal(
        torch_baselines.baseline_keypoints("sift", pc, rng(), **kw),
        jax_baselines.baseline_keypoints("sift", pc, rng(), **kw))


# ----------------------------------------------------- rendering helpers ----

@pytest.mark.parametrize("image_dir", ["images", ""])
def test_html_gallery_equals_usip_tpu(tmp_path, image_dir):
    """The same sections give the same ``index.html`` bytes (titles and
    captions escaped, links under ``image_dir`` or beside the page)."""
    from usip_tpu.utils.html import HTMLGallery as JaxGallery
    from usip_tpu_torch.utils.html import HTMLGallery
    pages = []
    for cls, name in ((HTMLGallery, "port"), (JaxGallery, "ref")):
        g = cls(str(tmp_path / name), title="a <b> & 'c'",
                image_dir=image_dir)
        assert g.image_path("x.png") == os.path.join(
            str(tmp_path / name), image_dir, "x.png")
        g.add_section("3 frames", [("00_1.png", "seq 0 frame 1: 4/8 <x>"),
                                   ("a&b.png", "")])
        g.add_section("empty", [])
        with open(g.save()) as f:
            pages.append(f.read())
    assert pages[0] == pages[1]


def _png(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", ["full", "no_nodes_no_sigmas",
                                  "empty_sigmas", "inf_sigmas"])
def test_vis_scene_equals_usip_tpu(tmp_path, case):
    """``save_keypoint_scene`` writes usip_tpu's PNG bytes for the same
    cloud, nodes, keypoints, sigmas and partner keypoints (and the edge
    cases its guard is for: no keypoint left, sigmas all inf)."""
    from usip_tpu.utils import vis as jax_vis
    from usip_tpu_torch.utils import vis
    rng = np.random.default_rng(5)
    pc = rng.normal(size=(300, 3)).astype(np.float32)
    kp = rng.normal(size=(12, 3)).astype(np.float32)
    args = {"full": (rng.normal(size=(16, 3)), kp,
                     rng.uniform(0.01, 0.5, 12), kp + 0.1),
            "no_nodes_no_sigmas": (None, kp, None, None),
            "empty_sigmas": (None, kp[:0], np.zeros(0), None),
            "inf_sigmas": (None, kp, np.full(12, np.inf), None)}[case]
    paths = [str(tmp_path / f"{n}.png") for n in ("port", "ref")]
    for mod, path in zip((vis, jax_vis), paths):
        nodes, k, sig, other = args
        assert mod.save_keypoint_scene(path, pc, nodes, keypoints=k,
                                       sigmas=sig,
                                       keypoints_other=other) == path
    assert _png(paths[0]) == _png(paths[1])


def test_vis_plot_helpers_equal_usip_tpu(tmp_path):
    """``plot_pc`` (with its z cut-off) and ``axis_equal_3d`` give the same
    axes and the same PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from usip_tpu.utils import vis as jax_vis
    from usip_tpu_torch.utils import vis
    pc = np.random.default_rng(6).normal(size=(200, 3)) * [1, 3, 2]
    out = []
    for mod, name in ((vis, "port"), (jax_vis, "ref")):
        ax = mod.axis_equal_3d(mod.plot_pc(pc, color="g", size=2.0,
                                           z_cutoff=1.5))
        limits = [getattr(ax, f"get_{d}lim")() for d in "xyz"]
        path = str(tmp_path / f"{name}.png")
        ax.figure.savefig(path, dpi=50)
        plt.close(ax.figure)
        out.append((limits, _png(path)))
    assert out[0] == out[1]
