"""Render exported keypoint ``.bin`` trees over their source clouds — the
reference's ``evaluation/visualize_keypoints`` MATLAB viewer
(``visualize_features.m`` / ``save_features_png.m``) as a CLI command.

The reference viewer loads 4-column (xyz, sigma) keypoint bins
(``tools/load_keypoint.m`` reads Nx4), drops rows whose sigma is at or above a
per-dataset threshold (``visualize_features.m:4-22``), and scatters the
survivors over the frame's cloud in a random frame order. Same protocol here,
driven by the trees ``export-keypoints`` writes (``--with-sigmas`` for the
4-column form; plain 3-column trees render unfiltered).

One deliberate difference: no cam->velodyne / cam->ENU coordinate fix. The
MATLAB viewer overlays keypoints on the *raw sensor* scans, so it must move
the camera-frame keypoints into the sensor frame (``load_keypoint.m``). Here
the cloud comes from the same numpy tree the detector consumed, so cloud and
keypoints already share a frame.

Counterpart of ``usip_tpu/eval/render.py``: the same frames, captions, gallery
and PNGs from the same bins. Host code only (numpy and matplotlib); without
matplotlib a render raises its ``ImportError``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from usip_tpu_torch.config import Config

# per-dataset sigma cutoffs, visualize_features.m:4-22 (scenenn routes to the
# redwood eval frames, eval/export_runner.make_eval_dataset)
SIGMA_THRESHOLDS = {"modelnet": 0.04, "shrec": 0.04, "oxford": 0.25,
                    "kitti": 0.3, "scenenn": 0.08}


def run_render(cfg: Config, kp_dir: str, out_dir: str, kp_dim: int = 3,
               sigma_threshold: Optional[float] = None, max_frames: int = 16,
               html: bool = True, seed: int = 0, synthetic: bool = False,
               subset: str = "original", dataset=None) -> dict:
    """Render up to ``max_frames`` randomly chosen frames (the MATLAB viewer's
    ``randperm`` loop) whose exported bin exists under ``kp_dir``.

    ``kp_dim``: columns per keypoint row in the bins (3, or 4 when exported
    with ``--with-sigmas`` — the count is not recoverable from the file size,
    so it must be stated). ``sigma_threshold``: keep keypoints with
    sigma < threshold; defaults to the reference's per-dataset value for
    4-column bins and to no filtering for 3-column ones.

    Returns ``{"rendered", "skipped", "html"}``.
    """
    from usip_tpu_torch.eval.export import read_keypoints_bin
    from usip_tpu_torch.eval.export_runner import make_eval_dataset
    from usip_tpu_torch.utils.vis import save_keypoint_scene

    if kp_dim not in (3, 4):
        raise ValueError(f"kp_dim must be 3 or 4, got {kp_dim}")
    if sigma_threshold is not None and kp_dim != 4:
        raise ValueError("sigma filtering needs 4-column bins — export with "
                         "--with-sigmas and pass --kp-dim 4")
    if kp_dim == 4 and sigma_threshold is None:
        sigma_threshold = SIGMA_THRESHOLDS.get(cfg.data.dataset)

    ds = dataset if dataset is not None \
        else make_eval_dataset(cfg, synthetic, subset=subset)
    order = np.random.default_rng(seed).permutation(len(ds))

    gallery = None
    if html:
        from usip_tpu_torch.utils.html import HTMLGallery
        gallery = HTMLGallery(out_dir, title=f"keypoints: {kp_dir}")
    else:
        os.makedirs(out_dir, exist_ok=True)

    rendered, skipped, images = 0, 0, []
    for i in order:
        if rendered >= max_frames:
            break
        item = ds[int(i)]
        seq, frame = int(item["seq"]), int(item["frame"])
        bin_path = os.path.join(kp_dir, f"{seq:02d}", f"{frame}.bin")
        if not os.path.exists(bin_path):
            skipped += 1
            continue
        rows = read_keypoints_bin(bin_path, dim=kp_dim)
        kp, sig = rows[:, :3], (rows[:, 3] if kp_dim == 4 else None)
        total = kp.shape[0]
        if sigma_threshold is not None:
            keep = sig < sigma_threshold
            kp, sig = kp[keep], sig[keep]
        name = f"{seq:02d}_{frame}.png"
        png = gallery.image_path(name) if gallery \
            else os.path.join(out_dir, name)
        save_keypoint_scene(png, np.asarray(item["pc"]), None,
                            keypoints=kp, sigmas=sig)
        caption = f"seq {seq} frame {frame}: {kp.shape[0]}/{total} keypoints"
        if sigma_threshold is not None:
            caption += f" (sigma < {sigma_threshold})"
        images.append((name, caption))
        rendered += 1

    html_path = None
    if gallery is not None:
        gallery.add_section(f"{rendered} frames", images)
        html_path = gallery.save()
    return {"rendered": rendered, "skipped": skipped, "html": html_path}
