"""The training-quality gates through the port.

The detector's (counterpart of ``scripts/fullscale_quality.py
phase_smoke``):

    python -m usip_tpu_torch.quality [--root DIR] [--epochs 16] \
        [--factor 2] [--device cuda] [--override data.node_num=64 ...]

At the KITTI preset's semantics (device sampling of fp16 parent clouds, bf16
trunk, exact FPS) and phase_smoke's reduced sizes (input 2048 points,
parent 2560, 64 nodes, c1 32, c2 128, batch 4; a synthetic KITTI tree of
4096-point scans, 9 train sequences of 6 frames and 2 test sequences of
10), it builds the tree, trains ``--epochs`` epochs through ``python -m
usip_tpu_torch.cli train-detector``, exports 64 keypoints a test frame with
the trained detector and with random keypoints, scores both with the KITTI
repeatability protocol (``--coord-fix kitti``, inlier radius 0.5 m), prints
one JSON line, and exits nonzero unless trained/random >= ``--factor``.
``--override``s come after the reduced sizes, so they win.

The descriptor's (counterpart of ``scripts/validate_descriptor.py
--use-cgf --rot 2d --test-yaw``):

    python -m usip_tpu_torch.quality --descriptor [--factor 2] \
        [--device cuda] [--override train.seed=1 ...]

On synthetic shapes at the modelnet preset (512 shapes of 1024 points, 64
nodes, c1 64, c2 128, descriptor length 64, balls of 32 points in radius
0.4, batch 16; ``--override``s after these, as above): it trains the
detector 20 epochs, freezes it, trains the descriptor 60 epochs with the
CGF objective under yaw (GT rotations about the vertical axis only, no
scale or shift), then matches 12 test shapes against a yaw-rotated
resampling of themselves (``yaw_matching``): the share of keypoints whose
descriptor's nearest neighbour in the partner lies within 0.2 of the right
place, for the trained descriptor, the untrained one and random vectors.
It prints one JSON line and exits nonzero unless trained /
untrained >= ``--factor``. Every seed is fixed, and it runs under
deterministic algorithms, so that a run on one card repeats.

The object recipe's (counterpart of ``scripts/validate_synthetic.py``):

    python -m usip_tpu_torch.quality --object [--epochs 30] [--factor 2] \
        [--device cuda] [--override data.fps_parallel=2 ...]

At the modelnet preset on synthetic shapes (256 training shapes of 1024
points, 64 nodes, c1 64, c2 128, node kNN 8, batch 16; the rest of the
modelnet recipe, rot_3d among it, as it is; ``--override``s after these):
it trains ``--epochs`` epochs, then detects 32 keypoints on 24 test shapes
(seed 1) and on a copy of each under a random 3D rotation (numpy seed 7),
and scores the pairs' repeatability within 0.25, and that of random
keypoints; it prints one JSON line and exits nonzero unless model / random
>= ``--factor``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

# phase_smoke's reduced sizes (scripts/fullscale_quality.py:305-316); every
# semantic lever (device sampling, fp16 wire, bf16 trunk, FPS) stays at the
# preset's value
SMOKE_OVERRIDES = [
    "data.input_pc_num=2048", "data.parent_pc_num=2560",
    "data.node_num=64", "detector.c1=32", "detector.c2=128",
    "train.batch_size=4", "train.log_every=50",
]
NAME = "fullscale"


def _overrides(items):
    from usip_tpu_torch.cli import _parse_overrides
    return _parse_overrides(items)


def export_and_repeatability(cfg, checkpoint, out_dir, gt, calib_root,
                             device, desired=64, inlier_radius=0.5):
    """Export the test frames (the trained detector, or random keypoints
    when ``checkpoint`` is None) and score their repeatability."""
    from usip_tpu_torch.data.eval_loaders import KittiTestFrames
    from usip_tpu_torch.eval.eval_runner import (make_coord_fix,
                                                 run_repeatability)
    from usip_tpu_torch.eval.export_runner import run_export
    ds = KittiTestFrames(
        cfg.data, txt_root=os.path.join(cfg.data.dataroot, "kitti-reg-test"),
        numpy_root=os.path.join(cfg.data.dataroot, "data_odometry_velodyne",
                                "numpy"), seqs=(9, 10),
        sn_len=cfg.detector.surface_normal_len, seed=0)
    stats = run_export(cfg, checkpoint, out_dir, desired_num=desired,
                       dataset=ds, device=device,
                       method="model" if checkpoint else "random")
    mean, arr = run_repeatability(out_dir, out_dir, gt,
                                  inlier_radius=inlier_radius,
                                  coord_fix=make_coord_fix("kitti", calib_root))
    return {"frames": stats["frames"], "repeatability": float(mean),
            "pairs": len(arr)}


# scripts/validate_descriptor.py's protocol at the size usip_tpu's 2x
# verdict was recorded at (``--train-size 512 --desc-epochs 60``,
# PERFORMANCE.md "yaw-matching accuracy"; the detector keeps its 20 epochs:
# at 60 its keypoints bunch within the match radius and random vectors
# match best, in both packages). At the script's defaults (256 shapes, 20
# descriptor epochs) both packages' expected ratio is the factor itself
# (ROADMAP Queue C). And usip_tpu's tests/test_descriptor_learning.py
# sizes (the CPU test's gate, 1.3x)
DESCRIPTOR_GATE = dict(points=1024, nodes=64, c1=64, c2=128, node_knn_k=8,
                       descriptor_len=64, nsamples=32, ball_radius=0.4,
                       cgf_radius=0.2, match_radius=0.2, train_size=512,
                       det_epochs=20, desc_epochs=60, test_items=12,
                       workers=4)
LEARNING_TEST = dict(points=256, nodes=32, c1=32, c2=64, node_knn_k=4,
                     descriptor_len=32, nsamples=16, ball_radius=0.5,
                     cgf_radius=0.3, match_radius=0.3, train_size=128,
                     det_epochs=8, desc_epochs=30, test_items=16, workers=2)


def match_accuracy(kp_a, desc_a, kp_p, desc_p, R, radius):
    """The share of anchor keypoints whose descriptor's 1-NN in the partner
    lies within ``radius`` of it once rotated back: ``|R^T kp_p[nn] - kp_a|
    < radius``."""
    import numpy as np
    d2 = (np.sum(desc_a ** 2, 1)[:, None] + np.sum(desc_p ** 2, 1)[None]
          - 2 * desc_a @ desc_p.T)
    nn = np.argmin(d2, axis=1)
    err = np.linalg.norm(kp_p[nn] @ R - kp_a, axis=1)
    return float((err < radius).mean())


def run_descriptor(root: str, device="cuda", *, points, nodes, c1, c2,
                   node_knn_k, descriptor_len, nsamples, ball_radius,
                   cgf_radius, match_radius, train_size, det_epochs,
                   desc_epochs, test_items, workers, overrides=()) -> dict:
    """The descriptor gate's phases (``scripts/validate_descriptor.py
    --use-cgf --rot 2d --test-yaw`` at the given sizes, then the dotted
    ``overrides``), under deterministic algorithms; returns the three
    matching accuracies and the phases' seconds."""
    import torch

    from usip_tpu_torch.inference import resolve_device

    dev = resolve_device(device)
    # fixed seeds give one answer only with deterministic algorithms: on the
    # card the backward's atomic accumulations (index_add, scatter_add) and
    # cuBLAS's split reductions otherwise sum in a run-dependent order, and
    # the ratio moves between runs
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        return _run_descriptor(root, dev, points, nodes, c1, c2, node_knn_k,
                               descriptor_len, nsamples, ball_radius,
                               cgf_radius, match_radius, train_size,
                               det_epochs, desc_epochs, test_items, workers,
                               overrides)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)


def _run_descriptor(root, dev, points, nodes, c1, c2, node_knn_k,
                    descriptor_len, nsamples, ball_radius, cgf_radius,
                    match_radius, train_size, det_epochs, desc_epochs,
                    test_items, workers, overrides) -> dict:
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    from usip_tpu_torch.models import Descriptor
    from usip_tpu_torch.train.checkpoint import save_checkpoint
    from usip_tpu_torch.train.descriptor_loop import (DescriptorEngine,
                                                      _SyntheticPairDataset)
    from usip_tpu_torch.train.loop import DetectorEngine

    seconds = {}
    cfg = get_config("modelnet", **{
        "data.input_pc_num": points, "data.node_num": nodes,
        "detector.c1": c1, "detector.c2": c2,
        "detector.node_knn_k": node_knn_k,
        "descriptor.descriptor_len": descriptor_len,
        "descriptor.ball_nsamples": nsamples,
        "descriptor.ball_radius": ball_radius,
        "descriptor.surface_normal_len": 3, "train.batch_size": 16,
        "train.log_every": 1000, **_overrides(overrides)})
    # the detector trains under modelnet's full augmentation; the
    # descriptor's CGF GT transform is a yaw, with no scale or shift
    cfg_desc = cfg.with_overrides(**{
        "loss.cgf_radius": cgf_radius, "augment.rot_3d": False,
        "augment.rot_horizontal": True, "augment.gt_scale_thre": 0.0,
        "augment.gt_shift_thre": 0.0})
    sn_len = cfg.detector.surface_normal_len

    t0 = time.perf_counter()
    train = BatchLoader(SyntheticDataset(size=train_size, input_pc_num=points,
                                         surface_normal_len=sn_len, seed=0),
                        16, num_workers=workers, seed=0)
    det_engine = DetectorEngine(cfg, train, None,
                                out_dir=os.path.join(root, "det"),
                                device=dev)
    for epoch in range(det_epochs):
        det_engine.train_epoch(epoch)
    det_ckpt = os.path.join(root, "det", "final.pt")
    save_checkpoint(det_ckpt, det_engine.state,
                    metadata={"epoch": det_epochs})
    seconds["detector"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    desc_loader = BatchLoader(_SyntheticPairDataset(cfg_desc, size=train_size,
                                                    seed=0),
                              16, num_workers=workers, seed=0)
    engine = DescriptorEngine(cfg_desc, det_ckpt, train_loader=desc_loader,
                              use_cgf=True, out_dir=os.path.join(root, "desc"),
                              device=dev)
    untrained = Descriptor(cfg_desc.descriptor).to(dev).eval()
    untrained.load_state_dict(engine.state.model.state_dict())
    for epoch in range(desc_epochs):
        avg = engine.train_epoch(epoch)
    seconds["descriptor"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = yaw_matching(cfg, det_engine.state.model,
                       {"trained": engine.state.model,
                        "untrained": untrained}, test_items, match_radius)
    seconds["eval"] = time.perf_counter() - t0
    return {**out, "ratio": out["trained"] / max(out["untrained"], 1e-9),
            "final_loss": avg.get("loss"),
            "final_match_acc": avg.get("match_acc"), "seconds": seconds}


def yaw_matching(cfg, det, models, test_items, match_radius) -> dict:
    """The descriptor gate's test: ``test_items`` synthetic shapes (seed 1)
    each against a yaw-rotated resampling of itself (numpy seed 3), the
    keypoints of the frozen detector ``det`` on both (node draws seeded
    ``2i``, ``2i + 1``), each descriptor of ``models`` (name -> module, ball
    draws seeded ``100 + i``, ``200 + i``) and random vectors: the mean
    share of anchor keypoints whose descriptor's 1-NN in the partner lies
    within ``match_radius`` of the right place, by name (and
    ``'random'``)."""
    import numpy as np
    import torch

    from usip_tpu_torch.data.augment import rotation_matrix
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    from usip_tpu_torch.ops import sample_nodes

    det = det.eval()
    models = {k: m.eval() for k, m in models.items()}
    dev = next(det.parameters()).device
    ratio = (cfg.data.eval_fps_subsample_ratio
             or cfg.data.fps_subsample_ratio)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a[None], np.float32)).to(dev)
    test_ds = SyntheticDataset(size=16, input_pc_num=cfg.data.input_pc_num,
                               surface_normal_len=cfg.detector
                               .surface_normal_len, seed=1)
    rng = np.random.default_rng(3)
    accs = {name: [] for name in (*models, "random")}
    with torch.no_grad():
        for i in range(test_items):
            item = test_ds[i % len(test_ds)]
            pc, sn = item["src_pc"], item["src_sn"]
            ang = rng.uniform(0, 2 * np.pi)
            R = rotation_matrix(torch.tensor([0.0, ang, 0.0])).numpy()
            pc_r = item["dst_pc"] @ R.T
            sn_r = np.concatenate([item["dst_sn"][:, :3] @ R.T,
                                   item["dst_sn"][:, 3:]], axis=1)
            kps = []
            for j, (p, s) in enumerate(((pc, sn), (pc_r, sn_r))):
                node = sample_nodes(to(p), cfg.data.node_num, ratio,
                                    cfg.data.fps_parallel,
                                    generator=gen(2 * i + j))
                kps.append(det(to(p), to(s), node)[1])
            descs = {
                name: [model(to(p), to(s), kp, generator=gen(seed))[0]
                       [0].cpu().numpy()
                       for p, s, kp, seed in ((pc, sn, kps[0], 100 + i),
                                              (pc_r, sn_r, kps[1], 200 + i))]
                for name, model in models.items()}
            ka, kp_ = (k[0].cpu().numpy() for k in kps)
            descs["random"] = [rng.normal(size=d.shape).astype(np.float32)
                               for d in next(iter(descs.values()))]
            for name, (da, dp) in descs.items():
                accs[name].append(match_accuracy(ka, da, kp_, dp, R,
                                                 match_radius))
    return {k: float(np.mean(v)) for k, v in accs.items()}


# scripts/validate_synthetic.py's defaults (its --pc, --nodes, --keypoints,
# --radius and the widths it sets)
OBJECT_GATE = dict(points=1024, nodes=64, keypoints=32, radius=0.25,
                   train_size=256, test_size=32, pairs=24, workers=4)


def run_object(root: str, device="cuda", epochs: int = 30, *, points, nodes,
               keypoints, radius, train_size, test_size, pairs, workers,
               overrides=()) -> dict:
    """The object recipe's learning check (``scripts/validate_synthetic.py``
    at the given sizes, then the dotted ``overrides``): rotated-pair
    repeatability of the trained detector and of random keypoints."""
    import numpy as np
    import torch

    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.data.augment import rotation_matrix
    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    from usip_tpu_torch.eval.export import select_keypoints
    from usip_tpu_torch.eval.repeatability import pair_repeatability
    from usip_tpu_torch.inference import resolve_device
    from usip_tpu_torch.ops import sample_nodes
    from usip_tpu_torch.train.loop import DetectorEngine

    dev = resolve_device(device)
    cfg = get_config("modelnet", **{
        "data.input_pc_num": points, "data.node_num": nodes,
        "detector.c1": 64, "detector.c2": 128, "detector.node_knn_k": 8,
        "train.batch_size": 16, "train.log_every": 50,
        **_overrides(overrides)})
    sn_len = cfg.detector.surface_normal_len
    train_ds = SyntheticDataset(size=train_size, input_pc_num=points,
                                surface_normal_len=sn_len, seed=0)
    test_ds = SyntheticDataset(size=test_size, input_pc_num=points,
                               surface_normal_len=sn_len, seed=1)
    bs = cfg.train.batch_size
    train = BatchLoader(train_ds, bs, num_workers=workers, seed=0)
    test = BatchLoader(test_ds, bs, shuffle=False, num_workers=workers,
                       seed=0)
    t0 = time.perf_counter()
    engine = DetectorEngine(cfg, train, test, out_dir=root, device=dev)
    avg = {}
    for epoch in range(epochs):
        avg = engine.train_epoch(epoch)
        if epoch % 5 == 0 or epoch == epochs - 1:
            t = engine.test_epoch(epoch)
            print(f"epoch {epoch}: train {avg['loss']:.4f} "
                  f"test {t.get('loss', float('nan')):.4f} "
                  f"chamfer_pure {t.get('chamfer_pure', float('nan')):.4f}",
                  flush=True)
    seconds = {"train": time.perf_counter() - t0}

    t0 = time.perf_counter()
    model = engine.state.model.eval()
    ratio = (cfg.data.eval_fps_subsample_ratio
             or cfg.data.fps_subsample_ratio)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a[None], np.float32)).to(dev)

    def detect(pc, sn, seed):
        node = sample_nodes(to(pc), cfg.data.node_num, ratio,
                            cfg.data.fps_parallel,
                            generator=torch.Generator(device=dev)
                            .manual_seed(seed))
        _, kp, sig = model(to(pc), to(sn), node)
        return kp[0].cpu().numpy(), sig[0].cpu().numpy()

    rng = np.random.default_rng(7)
    reps_model, reps_random = [], []
    with torch.no_grad():
        for i in range(pairs):
            item = test_ds[i % len(test_ds)]
            pc, sn = item["src_pc"], item["src_sn"]
            theta = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
            R = rotation_matrix(torch.from_numpy(theta)).numpy()
            pc_rot = (pc @ R.T).astype(np.float32)
            sn_rot = sn.copy()
            sn_rot[:, :3] = sn[:, :3] @ R.T
            kp_a, sig_a = detect(pc, sn, 2 * i)
            kp_p, sig_p = detect(pc_rot, sn_rot, 2 * i + 1)
            sel_a = select_keypoints(kp_a, sig_a, pc, desired_num=keypoints,
                                     rng=rng)
            sel_p = select_keypoints(kp_p, sig_p, pc_rot,
                                     desired_num=keypoints, rng=rng)
            T = np.eye(4)
            T[:3, :3] = R.T
            reps_model.append(pair_repeatability(sel_a, sel_p, T, radius))
            rand_a = pc[rng.choice(len(pc), keypoints, replace=False)]
            rand_p = pc_rot[rng.choice(len(pc_rot), keypoints,
                                       replace=False)]
            reps_random.append(pair_repeatability(rand_a, rand_p, T, radius))
    seconds["eval"] = time.perf_counter() - t0
    model_rep, random_rep = float(np.mean(reps_model)), float(
        np.mean(reps_random))
    return {"repeatability_model": model_rep,
            "repeatability_random": random_rep,
            "gain": model_rep / max(random_rep, 1e-9), "epochs": epochs,
            "inlier_radius": radius, "keypoints": keypoints,
            "fps_parallel": cfg.data.fps_parallel,
            "final_loss": avg.get("loss"), "seconds": seconds}


def run(root: str, epochs: int = 16, factor: float = 2.0, device="cuda",
        overrides=(), frames: int = 6, test_frames: int = 10,
        points: int = 4096) -> dict:
    """The gate's phases in order; returns its result (``passed`` among
    them) without raising on a low ratio."""
    from usip_tpu_torch.cli import main as cli_main
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree
    from usip_tpu_torch.eval.eval_runner import load_kitti_gt_table
    from usip_tpu_torch.inference import resolve_device
    from usip_tpu_torch.train.checkpoint import find_checkpoint

    resolve_device(device)  # fail before the tree is built
    seconds = {}
    t0 = time.perf_counter()
    # all 9 train seqs (the kitti loader's fixed seq contract), few frames each
    build_synthetic_kitti_tree(root, train_seqs=range(9), test_seqs=(9, 10),
                               frames_per_seq=frames,
                               test_frames_per_seq=test_frames,
                               target_points=points, seed=0)
    seconds["gen"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ckpt_dir = os.path.join(root, "ckpt")
    argv = ["train-detector", "--dataset", "kitti", "--dataroot", root,
            "--name", NAME, "--epochs", str(epochs),
            "--checkpoints-dir", ckpt_dir, "--device", str(device)]
    for kv in list(SMOKE_OVERRIDES) + list(overrides):
        argv += ["--override", kv]
    cli_main(argv)
    seconds["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    gt = []
    for seq in (9, 10):
        gt.extend(load_kitti_gt_table(os.path.join(root, "kitti-reg-test"),
                                      seq))
    calib_root = os.path.join(root, "calib")
    cfg = get_config("kitti", **{
        "data.dataroot": root, "train.checkpoint_dir": ckpt_dir,
        "train.name": NAME,
        **_overrides(list(SMOKE_OVERRIDES) + list(overrides))})
    ckpt = find_checkpoint(os.path.join(ckpt_dir, NAME))
    trained = export_and_repeatability(
        cfg, ckpt, os.path.join(root, "kp_smoke"), gt, calib_root, device)
    random_kp = export_and_repeatability(
        cfg, None, os.path.join(root, "kp_smoke_rand"), gt, calib_root,
        device)
    seconds["eval"] = time.perf_counter() - t0
    ratio = trained["repeatability"] / max(random_kp["repeatability"], 1e-9)
    return {"phase": "smoke", "pairs": len(gt), "checkpoint": ckpt,
            "trained": trained, "random": random_kp, "ratio": ratio,
            "factor": factor, "passed": bool(ratio >= factor),
            "seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="usip_tpu_torch.quality")
    ap.add_argument("--root", default=None,
                    help="working dir (default: a fresh temp dir)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="training epochs (default: 16; --object 30)")
    ap.add_argument("--factor", type=float, default=2.0,
                    help="required trained/random repeatability ratio")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when CUDA is absent")
    ap.add_argument("--cleanup", action="store_true",
                    help="remove the working dir on success")
    ap.add_argument("--override", action="append", default=[],
                    help="dotted config override, after the reduced sizes "
                         "(either gate)")
    gate = ap.add_mutually_exclusive_group()
    gate.add_argument("--descriptor", action="store_true",
                      help="the descriptor's gate (yaw-matching accuracy, "
                           "trained over untrained) instead of the "
                           "detector's")
    gate.add_argument("--object", action="store_true",
                      help="the object recipe's gate (rotated-pair "
                           "repeatability on synthetic shapes, model over "
                           "random keypoints)")
    args = ap.parse_args(argv)
    root = args.root or tempfile.mkdtemp(prefix="usip_smoke_")
    if args.object:
        result = run_object(root, args.device, args.epochs or 30,
                            overrides=args.override, **OBJECT_GATE)
        result.update(phase="object", factor=args.factor,
                      ratio=result["gain"],
                      passed=bool(result["gain"] >= args.factor))
        what = "model/random rotated-pair repeatability"
    elif args.descriptor:
        result = run_descriptor(root, args.device, overrides=args.override,
                                **DESCRIPTOR_GATE)
        result.update(phase="descriptor", factor=args.factor,
                      passed=bool(result["ratio"] >= args.factor))
        what = "trained/untrained yaw-matching accuracy"
    else:
        result = run(root, args.epochs or 16, args.factor, args.device,
                     args.override)
        what = "trained/random repeatability"
    print(json.dumps(result), flush=True)
    if args.cleanup and result["passed"]:
        shutil.rmtree(root, ignore_errors=True)
    if not result["passed"]:
        raise SystemExit(f"quality gate FAILED: {what} "
                         f"{result['ratio']:.2f} < required {args.factor}")
    return result


if __name__ == "__main__":
    main()
