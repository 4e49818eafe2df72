"""The port's own host code against usip_tpu's, on the CPU.

usip_tpu_torch imports nothing of usip_tpu: it keeps its own copies of the
config presets, ``data/{common,preprocess,synthetic,loaders,pipeline,
eval_loaders}``, the host coordinate flip, ``utils/logging``,
``eval/{export,repeatability,eval_runner}`` and the CLI's ``_sn_columns``.
These tests hold each copy equal to usip_tpu's bit for bit on the same
inputs and seeds (usip_tpu's loaders on their numpy path, its native batch
loader switched off), and show in a fresh interpreter that importing the
port loads no ``usip_tpu``, jax, flax or msgpack module.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import usip_tpu.native
from usip_tpu import cli as jax_cli
from usip_tpu import config as jax_config
from usip_tpu.data import augment as jax_augment
from usip_tpu.data import common as jax_common
from usip_tpu.data import eval_loaders as jax_eval_loaders
from usip_tpu.data import loaders as jax_loaders
from usip_tpu.data import pipeline as jax_pipeline
from usip_tpu.data import preprocess as jax_preprocess
from usip_tpu.data import synthetic as jax_synthetic
from usip_tpu.data.common import subsample_fixed as jax_subsample_fixed
from usip_tpu.eval import eval_runner as jax_eval_runner
from usip_tpu.eval import export as jax_export
from usip_tpu.eval import repeatability as jax_repeatability
from usip_tpu.utils import logging as jax_logging
from usip_tpu_torch import cli as torch_cli
from usip_tpu_torch import config as torch_config
from usip_tpu_torch.data import augment as torch_augment
from usip_tpu_torch.data import common as torch_common
from usip_tpu_torch.data import eval_loaders as torch_eval_loaders
from usip_tpu_torch.data import loaders as torch_loaders
from usip_tpu_torch.data import pipeline as torch_pipeline
from usip_tpu_torch.data import preprocess as torch_preprocess
from usip_tpu_torch.data import synthetic as torch_synthetic
from usip_tpu_torch.data.common import subsample_fixed
from usip_tpu_torch.eval import eval_runner as torch_eval_runner
from usip_tpu_torch.eval import export as torch_export
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
    "eval.export_runner", "eval.baselines")


def test_port_imports_nothing_of_usip_tpu():
    """A fresh interpreter imports every module of the port and finds
    neither ``usip_tpu`` nor any ``usip_tpu.*`` module loaded
    (``usip_tpu_torch`` shares the prefix, so the match is exact), nor jax,
    flax or msgpack."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module('usip_tpu_torch.' + m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('usip_tpu', 'jax', 'flax', 'msgpack')]\n"
        "assert 'usip_tpu_torch.inference' in sys.modules\n"
        "assert 'usip_tpu_torch.train.loop' in sys.modules\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
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
