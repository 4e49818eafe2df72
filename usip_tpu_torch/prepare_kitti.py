"""KITTI dataset preparation through the port (counterpart of
``scripts/prepare_kitti.py``: the same flags, outputs and file names): raw
odometry data -> the numpy trees and registration ground truth the loaders
(and the reference) consume. Host code; it takes no ``--device``.

Replaces the reference's MATLAB kitti_test_prepare.m pipeline end to end:

  python -m usip_tpu_torch.prepare_kitti \\
      --velodyne /kitti/sequences/00/velodyne --poses /kitti/poses/00.txt \\
      --calib /kitti/sequences/00/calib.txt --out /data/kitti --seq 0

  # registration test pairs for the eval sequences
  python -m usip_tpu_torch.prepare_kitti --poses /kitti/poses/09.txt \\
      --seq 9 --out /data/kitti --pairs-only
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from usip_tpu_torch.data.preprocess import (build_kitti_numpy_tree,
                                            build_test_pairs,
                                            write_groundtruths_txt)


def read_calib_tr(calib_path: str) -> np.ndarray:
    """Tr (velodyne->cam) row from a KITTI calib.txt, as 3x4."""
    with open(calib_path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = list(map(float, line.split(":")[1].split()))
                return np.asarray(vals, np.float64).reshape(3, 4)
    raise ValueError(f"no Tr line in {calib_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="usip_tpu_torch.prepare_kitti")
    ap.add_argument("--velodyne", help="dir of raw velodyne .bin scans")
    ap.add_argument("--poses", required=True, help="odometry poses txt")
    ap.add_argument("--calib", help="calib.txt with the Tr velodyne->cam row")
    ap.add_argument("--out", required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--voxel", type=float, default=0.2)
    ap.add_argument("--points", type=int, default=20480)
    ap.add_argument("--radius", type=float, default=90.0)
    ap.add_argument("--pair-spacing", type=float, default=10.0)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--pairs-only", action="store_true",
                    help="only write the registration test-pair ground truth")
    args = ap.parse_args(argv)

    poses34 = np.loadtxt(args.poses).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(poses34), 1, 1))
    poses[:, :3, :4] = poses34

    if not args.pairs_only:
        if not args.velodyne:
            raise SystemExit("--velodyne required unless --pairs-only")
        calib_tr = read_calib_tr(args.calib) if args.calib else None
        n = build_kitti_numpy_tree(
            args.velodyne, args.poses, args.out, args.seq, calib_tr=calib_tr,
            voxel_size=args.voxel, target_points=args.points,
            max_radius=args.radius, limit=args.limit)
        print(f"wrote {n} frames for seq {args.seq:02d}")

    pairs = build_test_pairs(poses, min_spacing=args.pair_spacing)
    gt_path = os.path.join(args.out, "kitti-reg-test", f"{args.seq:02d}",
                           "groundtruths.txt")
    write_groundtruths_txt(gt_path, poses, pairs)
    print(f"wrote {len(pairs)} registration pairs to {gt_path}")


if __name__ == "__main__":
    main()
