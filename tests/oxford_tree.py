"""A synthetic Oxford RobotCar tree, for the port's tests and
``chip_smoke.py``: scans of one synthetic world (the ground, boxes and poles
of ``usip_tpu_torch.data.synthetic``) taken from poses along a recorded
trajectory, written in the layout the Oxford loaders read
(oxford_detector_loader.py:43-76, oxford_test_loader.py:43-88):

* ``train_relative.txt``: ``<i>.bin | pos_list | nonneg_list`` a line (the
  scans within ``pos_radius`` and ``nonneg_radius`` of scan i);
* ``train_np_nofilter/<i>.npy``: N x 8 float32 in the scan's ENU frame
  (xyz, normal, curvature, reflectance);
* ``test_models_20k_np_nofilter/<i>.npy``, the same from a second stretch of
  the world, and ``groundtruths.pkl``: one entry per pair of neighbouring
  test scans, ``{anc_idx, pos_idx, t, q}`` with the transform that maps the
  pos scan into the anc scan's frame (q w-x-y-z).

All scans share one world, so the ground-truth pairs are consistent and
repeatability can be scored. usip_tpu writes no such tree (its Oxford path
needs the real one); this module lives beside the tests.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from usip_tpu_torch.data.synthetic import _make_world, _trajectory


def rotm_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> w-x-y-z unit quaternion (the inverse of
    ``eval_runner.quat_to_rotm``), by the largest of the four squares."""
    tr = np.trace(R)
    if tr > 0:
        s = 2.0 * np.sqrt(tr + 1.0)
        q = [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k])
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = np.asarray(q, np.float64)
    return q / np.linalg.norm(q)


def _scans(rng, n_frames, points, spacing, scan_radius):
    """``n_frames`` scans of one fresh world along its trajectory: the
    (N, 8) ENU rows of each scan and the scans' (n, 4, 4) poses."""
    w_pts, w_nrm, w_curv = _make_world(rng, n_frames * spacing)
    poses = _trajectory(rng, n_frames, spacing)
    scans = []
    for pose in poses:
        R, t = pose[:3, :3], pose[:3, 3]
        inside = np.sum((w_pts - t) ** 2, axis=1) <= scan_radius ** 2
        idx = np.nonzero(inside)[0]
        sel = rng.choice(idx, points, replace=idx.size < points)
        refl = rng.uniform(0, 0.99, size=(points, 1))
        scans.append(np.concatenate(
            [(w_pts[sel] - t) @ R, w_nrm[sel] @ R, w_curv[sel, None], refl],
            axis=1).astype(np.float32))
    return scans, poses


def build_oxford_tree(root: str, train_scans: int = 24, test_scans: int = 9,
                      points: int = 20480, spacing: float = 3.0,
                      scan_radius: float = 30.0, pos_radius: float = 10.0,
                      nonneg_radius: float = 50.0, seed: int = 0) -> dict:
    """Write the tree under ``root``; returns ``{"train": scans, "test":
    test scans, "pairs": ground-truth pairs}``."""
    rng = np.random.default_rng(seed)
    train_dir = os.path.join(root, "train_np_nofilter")
    test_dir = os.path.join(root, "test_models_20k_np_nofilter")
    for d in (train_dir, test_dir):
        os.makedirs(d, exist_ok=True)

    scans, poses = _scans(rng, train_scans, points, spacing, scan_radius)
    centres = poses[:, :3, 3]
    dist = np.linalg.norm(centres[:, None] - centres[None], axis=-1)
    with open(os.path.join(root, "train_relative.txt"), "w") as f:
        for i, scan in enumerate(scans):
            np.save(os.path.join(train_dir, f"{i}.npy"), scan)
            pos = [j for j in range(train_scans)
                   if j != i and dist[i, j] <= pos_radius]
            nonneg = [j for j in range(train_scans)
                      if dist[i, j] <= nonneg_radius]
            f.write(f"{i}.bin | {' '.join(map(str, pos))} | "
                    f"{' '.join(map(str, nonneg))}\n")

    scans, poses = _scans(rng, test_scans, points, spacing, scan_radius)
    gts = []
    for i, scan in enumerate(scans):
        np.save(os.path.join(test_dir, f"{i}.npy"), scan)
        if i + 1 < test_scans:
            # the pos scan (i + 1) into the anc scan's (i) frame
            T = np.linalg.inv(poses[i]) @ poses[i + 1]
            gts.append({"anc_idx": i, "pos_idx": i + 1,
                        "t": T[:3, 3].copy(), "q": rotm_to_quat(T[:3, :3])})
    with open(os.path.join(test_dir, "groundtruths.pkl"), "wb") as f:
        pickle.dump(gts, f)
    return {"train": train_scans, "test": test_scans, "pairs": len(gts)}
