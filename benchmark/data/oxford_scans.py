"""LiDAR-like Oxford RobotCar submaps from a seed, in the layout the
Oxford detector loader reads (``oxford/oxford_detector_loader.py``; the
port's ``data/loaders.py OxfordDataset``):

* ``train_relative.txt``: ``<i>.bin | pos_list | nonneg_list`` a line (the
  submaps within 10 m and 50 m of submap i);
* ``train_np_nofilter/<i>.npy``: N x 8 float32 in the submap's ENU frame
  (x forward, y left, z up: xyz, normal, curvature, reflectance).

One world of ground, boxes and poles (``kitti_scans.make_world``) is driven
along one route several times, as RobotCar's traversals repeat one route:
each traversal takes its submaps at its own lateral offset and along-track
phase, the sensor 1.7 m above the ground.
"""

from __future__ import annotations

import os
import shutil

import numpy as np

from benchmark.data.kitti_scans import make_world, trajectory


def write_tree(root: str, seed: int, traversals: int, submaps: int,
               points: int, scan_radius: float = 45.0, spacing: float = 3.0,
               pos_radius: float = 10.0, nonneg_radius: float = 50.0) -> int:
    """Write ``traversals x submaps`` submaps of ``points`` rows under
    ``root`` (emptied first); returns the bytes written."""
    if os.path.isdir(root):
        shutil.rmtree(root)
    folder = os.path.join(root, "train_np_nofilter")
    os.makedirs(folder)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 22]))
    w_pts, w_nrm, w_curv = make_world(rng, submaps * spacing)
    written, centres = 0, []
    for _ in range(traversals):
        poses = trajectory(rng, submaps, spacing)
        poses[:, 0, 3] += rng.uniform(0.0, spacing)
        poses[:, 1, 3] += rng.uniform(-1.5, 1.5)
        for pose in poses:
            R, t = pose[:3, :3], pose[:3, 3]
            inside = np.nonzero(np.sum((w_pts - t) ** 2, axis=1)
                                <= scan_radius * scan_radius)[0]
            sel = rng.choice(inside, points, replace=inside.size < points)
            refl = rng.uniform(0, 0.99, size=(points, 1))
            submap = np.concatenate([(w_pts[sel] - t) @ R, w_nrm[sel] @ R,
                                     w_curv[sel, None], refl], axis=1)
            np.save(os.path.join(folder, f"{len(centres)}.npy"),
                    submap.astype(np.float32))
            written += points * 8 * 4
            centres.append(t)
    centres = np.asarray(centres)
    dist = np.linalg.norm(centres[:, None] - centres[None], axis=-1)
    with open(os.path.join(root, "train_relative.txt"), "w") as f:
        for i in range(len(centres)):
            pos = np.nonzero((dist[i] <= pos_radius)
                             & (np.arange(len(centres)) != i))[0]
            nonneg = np.nonzero(dist[i] <= nonneg_radius)[0]
            f.write(f"{i}.bin | {' '.join(map(str, pos))} | "
                    f"{' '.join(map(str, nonneg))}\n")
    return written
