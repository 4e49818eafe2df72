"""KITTI raw preparation through the port (``python -m
usip_tpu_torch.prepare_kitti``, ``data/preprocess.py``) against
``scripts/prepare_kitti.py``, on the CPU.

A few synthetic velodyne ``.bin`` scans (a ground plane, walls and poles
in the sensor frame, reflectance in the fourth column, some points past
the 90 m cut), odometry poses 6 m apart and a calib.txt with its Tr row go
through both commands, the script's in process: the trees hold the same
file names and ``np.array_equal`` contents (the prepared scans, the pose
``.npz`` files) and the same ground-truth bytes, with and without the
calibration and under ``--pairs-only``. Both run the same numpy and cKDTree
code on one machine, so the scans agree exactly; ``prepare_lidar_scan``
is also held directly, its normals and curvature within 1e-6 (the fp32
noise of cKDTree neighbourhoods and ``eigh``), the rest exactly.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from usip_tpu.data import augment as jax_augment
from usip_tpu.data import preprocess as jax_preprocess
from usip_tpu_torch import prepare_kitti
from usip_tpu_torch.data import augment as torch_augment
from usip_tpu_torch.data import preprocess as torch_preprocess

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scan(rng, n=4000):
    """A LiDAR-like scan in the sensor frame (x forward, z up)."""
    ground = np.c_[rng.uniform(-40, 40, (n // 2, 2)),
                   rng.normal(-1.7, 0.02, n // 2)]
    wall = np.c_[rng.uniform(5, 30, n // 4), np.full(n // 4, 8.0)
                 + rng.normal(0, 0.02, n // 4), rng.uniform(-1.7, 2, n // 4)]
    pole = np.c_[rng.normal(12, 0.1, n // 8), rng.normal(-6, 0.1, n // 8),
                 rng.uniform(-1.7, 3, n // 8)]
    far = np.c_[rng.uniform(95, 120, n - n // 2 - n // 4 - n // 8),
                rng.uniform(-5, 5, n - n // 2 - n // 4 - n // 8),
                np.zeros(n - n // 2 - n // 4 - n // 8)]
    xyz = np.concatenate([ground, wall, pole, far])
    refl = rng.uniform(0, 1, (len(xyz), 1))
    return np.c_[xyz, refl].astype(np.float32)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_raw")
    rng = np.random.default_rng(0)
    velo = root / "velodyne"
    velo.mkdir()
    for i in range(4):
        _scan(rng).tofile(velo / f"{i:06d}.bin")
    poses = np.zeros((4, 3, 4))
    poses[:, :3, :3] = np.eye(3)
    poses[:, 2, 3] = np.arange(4) * 6.0
    np.savetxt(root / "poses.txt", poses.reshape(4, 12))
    tr = np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.2], [1, 0, 0, -0.3]],
                  np.float64)
    with open(root / "calib.txt", "w") as f:
        f.write("P0: " + " ".join(["0"] * 12) + "\n")
        f.write("Tr: " + " ".join(f"{v:.6e}" for v in tr.ravel()) + "\n")
    return root


def _script():
    spec = importlib.util.spec_from_file_location(
        "prepare_kitti_script", os.path.join(REPO, "scripts",
                                             "prepare_kitti.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_trees_equal(a, b):
    files = _tree(a)
    assert files == _tree(b) and files
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npy"):
            x, y = np.load(pa), np.load(pb)
            assert x.dtype == y.dtype and np.array_equal(x, y), rel
        elif rel.endswith(".npz"):
            x, y = np.load(pa), np.load(pb)
            assert sorted(x.files) == sorted(y.files) == ["pose"]
            assert np.array_equal(x["pose"], y["pose"]), rel
        else:
            with open(pa, "rb") as f, open(pb, "rb") as g:
                assert f.read() == g.read(), rel


@pytest.mark.parametrize("calib", [True, False])
def test_prepare_kitti_writes_the_scripts_files(raw, tmp_path, monkeypatch,
                                                capsys, calib):
    args = ["--velodyne", str(raw / "velodyne"), "--poses",
            str(raw / "poses.txt"), "--seq", "3", "--points", "1500",
            "--limit", "3"] + (["--calib", str(raw / "calib.txt")]
                               if calib else [])
    monkeypatch.setattr(sys, "argv", ["prepare_kitti.py", *args, "--out",
                                      str(tmp_path / "ref")])
    _script().main()
    ref_out = capsys.readouterr().out
    prepare_kitti.main([*args, "--out", str(tmp_path / "port")])
    assert capsys.readouterr().out == ref_out.replace(
        str(tmp_path / "ref"), str(tmp_path / "port"))
    _assert_trees_equal(tmp_path / "port", tmp_path / "ref")
    scans = sorted((tmp_path / "port").rglob("*.npy"))
    assert len(scans) == 3
    data = np.load(scans[0])
    assert data.shape == (1500, 8) and data.dtype == np.float32
    assert np.linalg.norm(data[:, :3], axis=1).max() <= 90.5
    assert "wrote 3 frames for seq 03" in ref_out


def test_pairs_only_as_a_module(raw, tmp_path, monkeypatch, capsys):
    """``python -m usip_tpu_torch.prepare_kitti --pairs-only`` in a fresh
    process writes the script's ground truth; without ``--velodyne`` (and
    without ``--pairs-only``) both refuse."""
    args = ["--poses", str(raw / "poses.txt"), "--seq", "9",
            "--pair-spacing", "10", "--pairs-only"]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "usip_tpu_torch.prepare_kitti",
                           *args, "--out", str(tmp_path / "port")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    monkeypatch.setattr(sys, "argv", ["prepare_kitti.py", *args, "--out",
                                      str(tmp_path / "ref")])
    _script().main()
    _assert_trees_equal(tmp_path / "port", tmp_path / "ref")
    gt = (tmp_path / "port" / "kitti-reg-test" / "09" /
          "groundtruths.txt").read_text().splitlines()
    assert len(gt) == 1 + 2  # header; (0, 2) and (1, 3) are 12 m apart
    with pytest.raises(SystemExit, match="--velodyne"):
        prepare_kitti.main(["--poses", str(raw / "poses.txt"), "--seq", "0",
                            "--out", str(tmp_path / "x")])
    assert prepare_kitti.read_calib_tr(str(raw / "calib.txt")).shape == (3, 4)
    np.testing.assert_array_equal(
        prepare_kitti.read_calib_tr(str(raw / "calib.txt")),
        _script().read_calib_tr(str(raw / "calib.txt")))


def test_prepare_lidar_scan_and_helpers_equal_usip_tpu(raw):
    scan = torch_preprocess.read_velodyne_bin(str(raw / "velodyne" /
                                                  "000001.bin"))
    np.testing.assert_array_equal(scan, jax_preprocess.read_velodyne_bin(
        str(raw / "velodyne" / "000001.bin")))
    for target in (800, 20480):
        ours = torch_preprocess.prepare_lidar_scan(scan, target_points=target)
        ref = jax_preprocess.prepare_lidar_scan(scan, target_points=target)
        assert ours.shape == ref.shape and ours.dtype == ref.dtype
        for cols in (slice(0, 3), slice(7, 8)):
            np.testing.assert_array_equal(ours[:, cols], ref[:, cols])
        np.testing.assert_allclose(ours[:, 3:7], ref[:, 3:7], rtol=0,
                                   atol=1e-6)
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(torch_augment.coordinate_nwu_to_cam(pts),
                                  jax_augment.coordinate_nwu_to_cam(pts))
