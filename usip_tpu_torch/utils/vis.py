"""Matplotlib 3D visualization helpers (reference util/vis_tools.py:24-75) and
the keypoint-scene composer used by the training visuals
(keypoint_detector.py:259-334), visdom-free (counterpart of
``usip_tpu/utils/vis.py``; the port keeps its own copy). matplotlib is
imported inside each function, so importing this module needs none."""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_pc(pc: np.ndarray, color="b", size: float = 1.0, ax=None,
            z_cutoff: Optional[float] = None):
    """Scatter an (N, 3) cloud on a 3D axis; returns the axis."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
    if z_cutoff is not None:
        pc = pc[np.abs(pc[:, 2]) < z_cutoff]
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=size, c=color)
    return ax


def axis_equal_3d(ax):
    """Equalize the 3D axis extents (vis_tools.axisEqual3D)."""
    extents = np.array([getattr(ax, f"get_{dim}lim")() for dim in "xyz"])
    sz = extents[:, 1] - extents[:, 0]
    centers = np.mean(extents, axis=1)
    maxsize = max(abs(sz))
    r = maxsize / 2
    for ctr, dim in zip(centers, "xyz"):
        getattr(ax, f"set_{dim}lim")(ctr - r, ctr + r)
    return ax


def save_keypoint_scene(path: str, pc: np.ndarray, nodes: Optional[np.ndarray],
                        keypoints: Optional[np.ndarray] = None,
                        sigmas: Optional[np.ndarray] = None,
                        keypoints_other: Optional[np.ndarray] = None) -> str:
    """Render cloud (grey) + nodes (green) + keypoints (red, brightness by 1/sigma)
    + optional partner keypoints (blue) to a PNG — the offline replacement of the
    visdom scatter payloads."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(pc[:, 0], pc[:, 1], pc[:, 2], s=1, c="#bbbbbb")
    if nodes is not None:
        ax.scatter(nodes[:, 0], nodes[:, 1], nodes[:, 2], s=6, c="#33cc33")
    if keypoints is not None:
        if sigmas is not None:
            w = (1.0 / np.maximum(sigmas, 1e-6))
            # empty or all-inf sigmas (e.g. every keypoint filtered away, or
            # pure pad-from-cloud rows) must not divide 0/0 into NaN colors
            wmax = float(w.max()) if w.size else 0.0
            w = w / max(wmax, 1e-12)
            colors = np.stack([w, np.zeros_like(w), np.zeros_like(w)], 1)
        else:
            colors = "r"
        ax.scatter(keypoints[:, 0], keypoints[:, 1], keypoints[:, 2], s=20,
                   c=colors)
    if keypoints_other is not None:
        ax.scatter(keypoints_other[:, 0], keypoints_other[:, 1],
                   keypoints_other[:, 2], s=20, c="b")
    axis_equal_3d(ax)
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path
