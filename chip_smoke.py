"""On-card smoke run of the PyTorch/CUDA port (usip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line or more each, in order; any failed check raises and the
script exits nonzero without the final ``ok`` line:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   refuses to run without CUDA;
1. builds the five CUDA kernels from ``usip_tpu_torch/csrc`` into a clean
   build directory, one nvcc each, side by side;
2. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (FPS, min/argmin, smallest-k and scatter-max
   exactly, the fused chain within a stated tolerance): FPS on LiDAR-like
   clouds, an urban-like subset and duplicated points, min/argmin at the
   serve and train assignments and the train step's keypoint -> cloud and
   keypoint chamfer in both modes, smallest-k also on the descriptor's
   ball scores (8, 256, 16384) k=64 over random fp32 priorities and over
   the bf16 mode's rounded priorities and distances (ties), scatter-max on
   uniform ids and on the SOM trunk's own assignment ids;
3. runs the whole fp32 forward at full width (B=2) on the card and on the
   CPU with the same seeded weights, draws and input, and compares: the
   KITTI SOM detector, the Oxford ball detector and its knn twin, and the
   KITTI descriptor (the same balls; descriptors within 1e-4);
4. serves 3 requests through ``python -m usip_tpu_torch.cli serve --device
   cuda`` for the KITTI SOM detector and for the Oxford ball detector, then
   drives ``KeypointPipeline.detect`` in process on each path (SOM, ball,
   knn), with the kernel launch counts reset before and read after each, and
   checks the kernels each path must launch;
5. times each kernel against its plain version and, where one PyTorch call
   computes the same function, that call (``torch.topk`` for smallest-k,
   ``scatter_reduce`` for scatter-max: yardsticks the port never calls;
   scatter-max also on assignment ids; min/argmin at each of its four
   shapes, beside its bound and its instruction floor; smallest-k also at
   the descriptor's ball query, beside the whole ball query's time),
   computes each kernel's bound from its shapes and the card's published
   peaks, times the stages of the batch-8 forwards, detect clouds/s with
   the bench protocol (bf16 presets) and the ball path's peak memory;
6. trains the KITTI SOM detector at full width (batch 8: 16 clouds of
   16384 points, bf16 trunk): five steps of
   ``usip_tpu_torch.train.make_detector_train_step`` on seeded synthetic
   parent clouds with the launch counts reset before and read after (the
   train path must launch FPS, min/argmin, smallest-k and scatter-max),
   every loss and gradient norm finite; one fp32 step (batch 2) on the
   card against the same step on the CPU (loss within 1e-4, gradient norm
   within 1e-3, relative; each parameter's gradient within ``GRAD_TOL``);
   then the step time, train clouds/s and the step's split into data prep,
   forward, losses, backward and optimizer (the parts run one by one);
7. trains at full KITTI width through the entry points: builds a synthetic
   KITTI tree of 20480-point scans (``build_synthetic_kitti_tree``), runs
   ``python -m usip_tpu_torch.cli train-detector --device cuda`` for 2
   epochs and then ``--resume auto`` for a third, and checks its files,
   finite losses and the resumed epoch; then one epoch of
   ``DetectorEngine`` in process with the launch counts reset before and
   read after (FPS, min/argmin, smallest-k and scatter-max must launch),
   its train clouds/s beside the bare step's (phase 6) and the device's
   idle share over the epoch (torch.profiler over the next epoch); then
   ``python -m usip_tpu_torch.cli bench --device cuda`` and its JSON line;
8. exports keypoints from phase 7's checkpoint through ``cli.main(
   ["export-keypoints", ...])`` in process with the counts reset and read
   (all five kernels must launch), scores them with ``eval-repeatability``,
   then runs the training-quality gate ``python -m usip_tpu_torch.quality
   --device cuda`` (scripts/fullscale_quality.py phase_smoke's sizes) and
   fails unless trained/random repeatability >= 2;
9. the descriptor at the KITTI descriptor preset's full width (8 pairs of
   16384-point clouds, 256 keypoints a cloud, balls of 64 in radius 2, bf16
   trunk and balls, a frozen seeded KITTI SOM detector): five steps of
   ``make_descriptor_train_step`` with the launch counts reset before and
   read after (FPS, min/argmin, smallest-k and scatter-max must launch),
   every loss and gradient norm finite; one fp32 step (batch 2) on the card
   against the CPU under deterministic algorithms, both describing the CPU
   detector's keypoints (``KeypointsFrom``); the step's time, clouds/s,
   split and device busy time; then on phase 7's tree and detector
   ``python -m usip_tpu_torch.cli train-descriptor --device cuda`` for 2
   epochs and ``--resume auto`` for a third, one ``DescriptorEngine`` epoch
   in process (launch counts, clouds/s, idle share), ``export-descriptors``
   with the counts reset and read (all five kernels must launch),
   ``eval-registration`` (RTE, RRE, success), ``detect
   --descriptor-checkpoint``, and the descriptor quality gate ``python -m
   usip_tpu_torch.quality --descriptor --device cuda``, which fails the
   run unless trained/untrained yaw-matching accuracy >= 2.

The second-to-last line is a JSON object with one entry per kernel (time,
plain and library times, bound, launches); the last is ``{"ok": true,
"device": {...}}``. The script imports nothing of JAX or of ``usip_tpu`` and
checks that at its end.
"""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from usip_tpu_torch import _build  # noqa: E402
from usip_tpu_torch import cli  # noqa: E402
from usip_tpu_torch.bench import bench_rate  # noqa: E402
from usip_tpu_torch.config import get_config  # noqa: E402
from usip_tpu_torch.inference import KeypointPipeline  # noqa: E402
from usip_tpu_torch.models import Descriptor, Detector  # noqa: E402
from usip_tpu_torch.models.detector import knn_group  # noqa: E402
from usip_tpu_torch.models.fused_infer import detector_infer_fused  # noqa: E402
from usip_tpu_torch.ops import kernels, pairwise_sqdist, sample_nodes  # noqa: E402
from usip_tpu_torch.ops.grouping import ball_scores, ball_select  # noqa: E402
from usip_tpu_torch.quality import DESCRIPTOR_GATE  # noqa: E402
from usip_tpu_torch.data.descriptor_loaders import (  # noqa: E402
    KittiDescriptorDataset)
from usip_tpu_torch.data.pipeline import BatchLoader  # noqa: E402
from usip_tpu_torch.train import (PackedPairBatch, ParentBatch,  # noqa: E402
                                  TrainState, make_descriptor_train_step,
                                  make_detector_train_step, pack_pair_batch)
from usip_tpu_torch.train.descriptor_loop import DescriptorEngine  # noqa: E402
from usip_tpu_torch.train import steps as train_steps  # noqa: E402
from usip_tpu_torch.train.checkpoint import find_checkpoint  # noqa: E402
from usip_tpu_torch.train.loop import DetectorEngine  # noqa: E402
from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree  # noqa: E402
from usip_tpu_torch.weights import (seeded_descriptor_state_dict,  # noqa: E402
                                    seeded_state_dict)

B_BENCH = 8
SEED = 0
# published peaks of an H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# device memory bytes/s, bf16 tensor-core and fp32 FLOP/s; its SMs, fp32
# lanes an SM and boost clock, for an issue-slot floor
HBM_BPS, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
SMS, FP32_LANES, CLOCK_HZ = 132, 128, 1.98e9
# min/argmin's instructions a (query, candidate) pair: 8 for the distance
# (no FMA: three products, two sums, the doubling, a difference and a sum),
# then in bf16 half a packed round-and-clamp, half an AND, a key and a min;
# in fp32 a clamp, a compare and two selects
K2_INSTR = {True: 11.0, False: 12.0}
# min/argmin's four main-path shapes (B, N, M, bf16): the serve assignment
# (the JSON line's time), the train step's assignment, keypoint -> cloud and
# keypoint chamfer
K2_SHAPES = {"serve (8, 16384) x 512 bf16": (8, 16384, 512, True),
             "train (16, 16384) x 512 bf16": (16, 16384, 512, True),
             "keypoint->cloud (8, 512) x 16384 fp32": (8, 512, 16384, False),
             "chamfer (8, 512) x 512 fp32": (8, 512, 512, False),
             # the serve shape in the fp32 mode, for comparison
             "(8, 16384) x 512 fp32": (8, 16384, 512, False)}


def bound(nbytes, flops, peak):
    """The least time in ms the card could take: the larger of the bytes
    moved (each input read once, each output written once) over the memory
    rate and the operations over their peak; and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def min_argmin_bound(b, n, m):
    """K2's bound: points and candidates read, a min and an index written;
    p.n (5), p^2 - 2 p.n + n^2 (2 more) and the compare, 8 FLOP a pair."""
    return bound(b * n * 12 + b * m * 12 + b * n * 8, 8 * b * n * m,
                 FP32_FLOPS)


def min_argmin_floor(b, n, m, bf16):
    """K2's issue-slot floor in ms: its instructions a pair (``K2_INSTR``,
    no FMA allowed by the bit-identical contract) over every fp32 lane of
    the card at its boost clock."""
    return b * n * m * K2_INSTR[bf16] / (SMS * FP32_LANES * CLOCK_HZ) * 1e3


def kernel_bounds(c1, c2, k_node):
    """Each kernel's bound at the shapes phase 5 times (batch 8)."""
    b, s, kf, n, m = B_BENCH, 2048, 512, 16384, 512
    c, cin = c2 // 2, 3 + c1
    rows = b * m * k_node
    chain_flops = 2 * rows * (cin * c + 2 * c * c + c * c2 + c2 * c2) \
        + 2 * b * m * c * c2  # the per-node side term of after0
    chain_bytes = rows * cin * 4 + b * m * c2 * 4 + 2 * (
        cin * c + 2 * c * c + 2 * c * c2 + c2 * c2)
    return {
        # 8 FLOP per point and step (3 differences, 3 squares, 2 sums)
        "fps": bound(b * s * 12 + b * 4 + b * kf * 4,
                     8 * b * (kf - 1) * s, FP32_FLOPS),
        "min_argmin": min_argmin_bound(b, n, m),
        "fusion_chain": bound(chain_bytes, chain_flops, BF16_FLOPS),
        # the (8, 512, 16384) scores read once, k=64 values and indices
        "smallest_k": bound(b * m * n * 4 + b * m * 64 * 8, 0, FP32_FLOPS),
        # both calls of a SOM forward, C=64 and C=128, onto 512 nodes
        "scatter_max": bound(sum(b * n * cc * 4 + b * n * 8 + b * m * cc * 4
                                 for cc in (64, 128)), 0, FP32_FLOPS),
    }


# K4 at the node kNN's (8, 512, 512) k=16, and at the descriptor's ball
# query (8, 256, 16384) k=64: the scores read once, values and indices
# written
KNN_BOUND = bound(B_BENCH * 512 * 512 * 4 + B_BENCH * 512 * 16 * 8, 0,
                  FP32_FLOPS)
DESC_BALL_BOUND = bound(B_BENCH * 256 * 16384 * 4 + B_BENCH * 256 * 64 * 8,
                        0, FP32_FLOPS)
# the kernels each main path must launch
PATH_KERNELS = {
    "som": ("fps", "min_argmin", "scatter_max", "fusion_chain", "smallest_k"),
    "ball": ("fps", "smallest_k", "fusion_chain"),
    "knn": ("fps", "smallest_k", "fusion_chain"),
    "train": ("fps", "min_argmin", "scatter_max", "smallest_k"),
    "engine": ("fps", "min_argmin", "scatter_max", "smallest_k"),
    "export": ("fps", "min_argmin", "scatter_max", "fusion_chain",
               "smallest_k"),
    "descriptor": ("fps", "min_argmin", "scatter_max", "smallest_k"),
    "descriptor_engine": ("fps", "min_argmin", "scatter_max", "smallest_k"),
    "descriptor_export": ("fps", "min_argmin", "scatter_max", "fusion_chain",
                          "smallest_k"),
}
# train steps in the train path's counted run
TRAIN_STEPS = 5
# the fp32 train step's gradients, card against CPU, parameter by parameter:
# the floor (a fraction of the largest gradient) under which a gradient is
# rounding noise, max|diff| over max(max|g|, floor), the least cosine. On an
# H100 the 12 noise gradients lay at or below 8e-8 of the largest, the 34
# others at or above 1.4e-3; the worst error was 1.7e-2 in two runs and
# 4.8e-2 in a third, on a gradient at 1.4e-3 of the largest, before the
# card's step ran with deterministic algorithms (the fp32 forward itself
# differs by up to 9e-4 of max|keypoint|, phase 3, and a train-mode
# BatchNorm backward amplifies that); the lowest cosine 0.999962
GRAD_TOL = (1e-4, 5e-2, 0.9999)
# phases 7 and 8's synthetic KITTI tree: full-size 20480-point scans, 10 a
# train sequence (90: 11 steps of batch 8 an epoch), 8 a test sequence (16
# for the test sweep; one registration pair >= 10 m apart in each sequence,
# so 4 frames to export)
TREE = {"frames_per_seq": 10, "test_frames_per_seq": 8,
        "target_points": 20480, "seed": 0}
# the quality gate: trained over random repeatability (phase_smoke --factor)
QUALITY_FACTOR = 2.0
# the descriptor's gate: trained over untrained yaw-matching accuracy
# (validate_descriptor.py --min-ratio)
DESC_QUALITY_FACTOR = 2.0
# the KITTI descriptor preset with an fp32 trunk and fp32 balls (and an fp32
# frozen detector), for the card-against-CPU checks
DESC_FP32 = {"detector.compute_dtype": "float32",
             "descriptor.compute_dtype": "float32",
             "descriptor.ball_compute_dtype": "float32"}
# descriptor train steps in the descriptor path's counted run
DESC_STEPS = 5


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def sync():
    torch.cuda.synchronize()


def time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters, replays=5):
    """Mean device time of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. Without the
    host's launch cost, which back-to-back timing of a short kernel
    (``time_ms``) measures instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    sync()
    return start.elapsed_time(end) / (replays * iters)


def kitti_cloud(rng, b, n):
    """LiDAR-like clouds: xy over a 40 m disc, z near the ground, unit
    normals and a reflectance column."""
    r = 40.0 * np.sqrt(rng.uniform(size=(b, n)))
    t = rng.uniform(0, 2 * np.pi, size=(b, n))
    pc = np.stack([r * np.cos(t), r * np.sin(t),
                   rng.normal(0, 1.5, size=(b, n))], -1).astype(np.float32)
    nrm = rng.normal(size=(b, n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    sn = np.concatenate([nrm, rng.uniform(size=(b, n, 1))], -1)
    return pc, sn.astype(np.float32)


def oxford_cloud(rng, b, n):
    """Dense urban-like clouds: 60% ground over a 25 m disc whose density
    falls with range (r uniform, as a LiDAR's rings), 40% in 40 poles of
    radius 0.5 m and height 4 m. Near the centre and at the poles a 2 m
    ball holds more than 64 points, far out on the ground fewer."""
    ng = int(n * 0.6)
    r = 25.0 * rng.uniform(size=(b, ng))
    t = rng.uniform(0, 2 * np.pi, size=(b, ng))
    ground = np.stack([r * np.cos(t), r * np.sin(t),
                       rng.normal(0, 0.1, size=(b, ng))], -1)
    centres = rng.uniform(-18, 18, size=(b, 40, 2))
    pole = rng.integers(0, 40, size=(b, n - ng))
    cxy = np.take_along_axis(centres, pole[..., None], axis=1)
    pr = 0.5 * np.sqrt(rng.uniform(size=(b, n - ng)))
    pt = rng.uniform(0, 2 * np.pi, size=(b, n - ng))
    poles = np.stack([cxy[..., 0] + pr * np.cos(pt),
                      cxy[..., 1] + pr * np.sin(pt),
                      rng.uniform(0, 4, size=(b, n - ng))], -1)
    pc = rng.permuted(np.concatenate([ground, poles], 1), axis=1)
    nrm = rng.normal(size=(b, n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    sn = np.concatenate([nrm, rng.uniform(size=(b, n, 1))], -1)
    return pc.astype(np.float32), sn.astype(np.float32)


def oxford_config(grouping, **overrides):
    return get_config("oxford", **{"detector.grouping": grouping,
                                   **overrides})


def seeded_detector(cfg, device, head_init=False):
    """The detector with ``seeded_state_dict``'s weights; ``head_init``
    puts its last layer (mlp3) back to the training init's scale (N(0,
    1e-4^2), no bias): keypoints near the anchors and sigmas near
    softplus(0), as a detector's are early in training and unlike the seeded
    head's (offsets of metres, sigmas above the descriptor loss's sigma_max
    of 3, which zero its weights)."""
    sd = {k: torch.tensor(v) for k, v in
          seeded_state_dict(cfg.detector, SEED).items()}
    if head_init:
        sd["mlp3.conv.weight"] *= 1e-4 / 0.05
        sd["mlp3.conv.bias"].zero_()
    det = Detector(cfg.detector)
    det.load_state_dict(sd, strict=True)
    return det.to(device).eval()


def phase0():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script runs only "
                 "on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    print(f"[0] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    # full fp32 products for the plain versions and the fp32 slice check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase1():
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.KERNELS:
        _build.load(name)
    print(f"[1] built {', '.join(_build.KERNELS)} into {_build.BUILD_DIR} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase2(cfg):
    """Kernel against plain version on the card, main-path shapes."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    errs = {}

    # K1: (8, 2048) -> 512 picks: LiDAR-like clouds, the 1/8 subset of an
    # urban-like (Oxford-style) cloud as sample_nodes draws it, and a cloud
    # whose points all appear twice
    pts, _ = kitti_cloud(rng, B_BENCH, 2048)
    opc, _ = oxford_cloud(rng, B_BENCH, 16384)
    sub = np.stack([rng.permutation(16384)[:2048] for _ in range(B_BENCH)])
    osub = np.take_along_axis(opc, sub[..., None], axis=1)
    dup = np.concatenate([pts[:, :1024], pts[:, :1024]], axis=1)
    worst = 0
    for name, p in (("kitti-like", pts), ("oxford-like subset", osub),
                    ("duplicated", dup)):
        p = torch.from_numpy(p).to(dev)
        first = torch.from_numpy(rng.integers(0, 2048, B_BENCH).astype(
            np.int32)).to(dev)
        got = kernels.fps(p, first, 512)
        ref = kernels.fps_plain(p, first, 512)
        sync()
        mism = int((got != ref).sum())
        print(f"[2] K1 fps {name}: (8, 2048) -> 512, {mism} picks differ",
              flush=True)
        check(mism == 0, f"fps {name} picks identical")
        worst = max(worst, int((got - ref).abs().max()))
    errs["fps"] = float(worst)

    # K2 at its four shapes, each in both modes: LiDAR-like clouds against
    # 512 nodes taken from them (the serve and train assignments), keypoints
    # near the nodes against the cloud and against other keypoints
    worst = 0.0
    for label, (b, n, m, _) in K2_SHAPES.items():
        pts, cand = k2_inputs(rng, b, n, m, dev)
        for bf16 in (False, True):
            mins, idx = kernels.min_argmin(pts, cand, bf16)
            rmins, ridx = kernels.min_argmin_plain(pts, cand, bf16)
            sync()
            mism = int((idx != ridx).sum())
            err = float((mins - rmins).abs().max())
            print(f"[2] K2 min_argmin {label}, round_bf16={bf16}: {mism} "
                  f"argmins differ, max |min diff| {err}", flush=True)
            check(mism == 0, f"min_argmin {label} round_bf16={bf16} argmin "
                  "identical")
            check(torch.equal(mins, rmins), f"min_argmin {label} "
                  f"round_bf16={bf16} mins identical")
            worst = max(worst, err)
        del pts, cand
    errs["min_argmin"] = worst

    # K3: (8, 512, 16, 131) with the seeded detector's folded weights
    det = seeded_detector(cfg, dev)
    ws, bs = kernels.fusion_chain_params(det.knnlayer_1)
    chain = kernels.prepare_chain(ws, bs)
    c1 = cfg.detector.c1
    grouped = np.concatenate(
        [rng.normal(0, 5, size=(B_BENCH, 512, 16, 3)),
         np.abs(rng.normal(size=(B_BENCH, 512, 16, c1)))], -1)
    grouped = torch.from_numpy(grouped.astype(np.float32)).to(dev)
    got = kernels.fusion_chain(grouped, chain)
    ref = kernels.fusion_chain_plain(grouped, ws, bs)
    sync()
    for w, u in zip(ws, kernels.unpack_chain(chain)):
        check(torch.equal(u, w.to(torch.bfloat16)), "packed chain weights "
              "read back as the folded bf16 weights")
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    print(f"[2] K3 fusion_chain: (8, 512, 16, {3 + c1}) -> (8, 512, "
          f"{ws[5].shape[1]}), max|plain| {scale}, max |diff| "
          f"{float(err.max())}, median |diff| {float(err.median())}",
          flush=True)
    check(scale > 0, "fusion chain output nonzero")
    check(float(err.max()) <= 1e-2 * scale, "fusion_chain max |diff| <= "
          "1e-2 max|plain|")
    check(float(err.median()) <= 1e-3 * scale, "fusion_chain median |diff| "
          "<= 1e-3 max|plain|")
    errs["fusion_chain"] = float(err.max())

    # K4: (8, 512, 16384) k=64 on knn distances of a cloud whose points all
    # appear twice, on ball scores (mostly +inf), on integer rows full of
    # ties; and the node kNN's (8, 512, 512) k=16
    half, _ = kitti_cloud(rng, B_BENCH, 8192)
    dup = torch.from_numpy(np.concatenate([half, half], 1)).to(dev)
    opc = torch.from_numpy(oxford_cloud(rng, B_BENCH, 16384)[0]).to(dev)
    onodes = opc[:, :512].contiguous()
    # the descriptor's ball query (8, 256, 16384) k=64: keypoints near the
    # urban-like cloud's points, random fp32 priorities, and the preset's
    # bf16 mode (distances and priorities rounded to bf16: ties)
    dkp, prio = descriptor_ball_inputs(rng, opc)
    cases = {
        "knn distances, duplicated points": (
            pairwise_sqdist(dup[:, :512], dup), 64),
        "ball scores r=2": (ball_scores(opc, onodes, 2.0), 64),
        "integer rows with ties": (torch.from_numpy(rng.integers(
            0, 50, size=(B_BENCH, 512, 16384)).astype(np.float32)).to(dev),
            64),
        "node knn distances": (pairwise_sqdist(onodes, onodes), 16),
        "descriptor ball scores, random fp32 priorities": (
            ball_scores(opc, dkp, 2.0, prio), 64),
        "descriptor ball scores, bf16 priorities and distances": (
            ball_scores(opc, dkp, 2.0, prio, round_bf16=True), 64),
    }
    worst = 0.0
    for name, (scores, k) in cases.items():
        vals, idx = kernels.smallest_k(scores, k)
        rvals, ridx = kernels.smallest_k_plain(scores, k)
        sync()
        mism = int((idx != ridx).sum())
        fin = torch.isfinite(rvals)
        err = float((vals[fin] - rvals[fin]).abs().max()) if fin.any() else 0.0
        inside = torch.isfinite(scores).sum(-1)
        finite = scores[torch.isfinite(scores)]
        print(f"[2] K4 smallest_k {name}: {tuple(scores.shape)} k={k}, "
              f"{mism} indices differ, max |value diff| {err}, "
              f"{float((~fin).float().mean()):.4f} of picks +inf; rows with "
              f"more than k finite {float((inside > k).float().mean()):.4f}, "
              f"fewer {float((inside < k).float().mean()):.4f}; distinct "
              f"finite values {finite.unique().numel()} of {finite.numel()}",
              flush=True)
        check(torch.equal(idx, ridx) and torch.equal(vals, rvals),
              f"smallest_k {name}: values and indices identical")
        worst = max(worst, err)
    errs["smallest_k"] = worst
    del cases, scores

    # K5: (8, 16384, C) onto 512 nodes: uniform ids with the last 12 nodes
    # empty, and the SOM trunk's own ids (K2 against 512 FPS nodes of a
    # LiDAR-like cloud: skewed; each node holds at least its own point)
    uniform = torch.from_numpy(rng.integers(0, 500, size=(B_BENCH, 16384)))
    worst = 0.0
    for name, ids in (("uniform ids", uniform.to(dev)),
                      ("assignment ids", assignment_ids(rng, dev))):
        counts = torch.zeros((B_BENCH, 512), dtype=torch.int64, device=dev)
        counts.scatter_add_(1, ids, torch.ones_like(ids))
        for c in (64, 128):
            f = torch.from_numpy(rng.normal(size=(B_BENCH, 16384, c)).astype(
                np.float32)).to(dev)
            got = kernels.scatter_max(f, ids, 512)
            ref = kernels.scatter_max_plain(f, ids, 512)
            sync()
            err = float((got - ref).abs().max())
            empty = counts == 0
            print(f"[2] K5 scatter_max {name} C={c}: (8, 16384, {c}) -> "
                  f"(8, 512, {c}), max |diff| {err}, "
                  f"{int(empty.sum())} empty nodes (all 0: "
                  f"{bool((got[empty] == 0).all())}), at most "
                  f"{int(counts.max())} points on a node", flush=True)
            check(torch.equal(got, ref), f"scatter_max {name} C={c} equals "
                  "scatter_reduce amax")
            check(bool((got[empty] == 0).all()),
                  f"scatter_max {name}: empty nodes are 0")
            worst = max(worst, err)
    errs["scatter_max"] = worst
    return errs


def k2_inputs(rng, b, n, m, dev):
    """K2's queries and candidates at ``(b, n) x m``: where the queries are
    LiDAR-like clouds (n > m), 512 nodes drawn from them; where they are
    512 keypoints, nodes of a cloud moved by N(0, 0.3^2), against the cloud
    (m = 16384) or against another such set of keypoints (m = 512)."""
    if n > m:
        pc = torch.from_numpy(kitti_cloud(rng, b, n)[0]).to(dev)
        sel = torch.from_numpy(np.stack([rng.choice(n, m, replace=False)
                                         for _ in range(b)])).to(dev)
        return pc, torch.gather(pc, 1, sel[..., None].expand(-1, -1, 3)
                                ).contiguous()
    pc = torch.from_numpy(kitti_cloud(rng, b, 16384)[0]).to(dev)

    def keypoints():
        sel = torch.from_numpy(np.stack([rng.choice(16384, n, replace=False)
                                         for _ in range(b)])).to(dev)
        near = torch.gather(pc, 1, sel[..., None].expand(-1, -1, 3))
        return (near + torch.from_numpy(rng.normal(0, 0.3, (b, n, 3)).astype(
            np.float32)).to(dev)).contiguous()

    return keypoints(), (pc if m == 16384 else keypoints())


def descriptor_ball_inputs(rng, pc):
    """The descriptor's ball query inputs on ``pc (8, 16384, 3)``: 256
    keypoints, points of the cloud moved by N(0, 0.3^2), and one uniform
    priority a point (fp32, seeded)."""
    b, n, _ = pc.shape
    sel = torch.from_numpy(np.stack([rng.choice(n, 256, replace=False)
                                     for _ in range(b)])).to(pc.device)
    kp = torch.gather(pc, 1, sel[..., None].expand(-1, -1, 3))
    kp = (kp + torch.from_numpy(rng.normal(0, 0.3, (b, 256, 3)).astype(
        np.float32)).to(pc.device)).contiguous()
    prio = torch.from_numpy(rng.uniform(size=(b, n)).astype(
        np.float32)).to(pc.device)
    return kp, prio


def assignment_ids(rng, dev):
    """The SOM trunk's node ids of 8 LiDAR-like clouds of 16384 points: 512
    FPS nodes of a random 1/8 subset, each point's nearest node by K2 with
    the preset's bf16 distances, as int64."""
    pc = torch.from_numpy(kitti_cloud(rng, B_BENCH, 16384)[0]).to(dev)
    subset = torch.from_numpy(np.stack([rng.permutation(16384)[:2048]
                                        for _ in range(B_BENCH)])).to(dev)
    first = torch.from_numpy(rng.integers(0, 2048, B_BENCH).astype(
        np.int32)).to(dev)
    nodes = sample_nodes(pc, 512, 8, subset_idx=subset, first=first)
    return kernels.min_argmin(pc, nodes, True)[1].long()


def compare_slice(label, cfg, cloud_fn, rng):
    """One full-width fp32 forward (B=2) on the card and on the CPU with the
    same seeded weights, draws and input; nodes (and for the grouped trunks
    the group indices) identical, keypoints and sigmas within 2e-2 x
    max|ref| at the maximum and 2e-3 x max|ref| at the median."""
    b, n = 2, cfg.data.input_pc_num
    sub = n // cfg.data.fps_subsample_ratio
    pc, sn = cloud_fn(rng, b, n)
    subset = np.stack([rng.permutation(n)[:sub] for _ in range(b)])
    first = rng.integers(0, sub, b).astype(np.int32)
    grouped = cfg.detector.grouping != "som"
    outs = []
    for device in ("cuda", "cpu"):
        det = seeded_detector(cfg, device)
        to = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
        with torch.inference_mode():
            node = sample_nodes(to(pc), cfg.data.node_num,
                                cfg.data.fps_subsample_ratio,
                                subset_idx=to(subset), first=to(first))
            res = detector_infer_fused(det, to(pc), to(sn), node)
            extra = (det.group_indices(to(pc), node),) if grouped else ()
            if device == "cuda" and cfg.detector.grouping == "ball":
                r, k = cfg.detector.group_radius, cfg.detector.group_k
                inside = (pairwise_sqdist(node, to(pc)) <= r * r).sum(-1)
                print(f"[3] {label}: balls holding more than {k} points "
                      f"{float((inside > k).float().mean()):.4f}, fewer "
                      f"(padded) {float((inside < k).float().mean()):.4f}, "
                      f"empty {float((inside == 0).float().mean()):.4f}",
                      flush=True)
                check(bool((inside > k).any() and (inside < k).any()),
                      "some balls overflow K and some do not")
        outs.append([t.cpu() for t in (node,) + tuple(res) + extra])
    gpu, cpu = outs
    check(torch.equal(gpu[0], cpu[0]), f"{label}: nodes identical on card "
          "and CPU")
    anc_err = float((gpu[1] - cpu[1]).abs().max())
    if grouped:
        check(torch.equal(gpu[4], cpu[4]), f"{label}: group indices "
              "identical on card and CPU")
    print(f"[3] {label} fp32 (2, {n}) -> {cfg.data.node_num}: nodes "
          f"identical{', group indices identical' if grouped else ''}, "
          f"anchors max |diff| {anc_err}", flush=True)
    check(anc_err <= 1e-4, f"{label}: anchors within 1e-4")
    for name, g, c in (("keypoints", gpu[2], cpu[2]),
                       ("sigmas", gpu[3], cpu[3])):
        check(bool(torch.isfinite(g).all()), f"{label}: {name} finite")
        scale = float(c.abs().max())
        err = (g - c).abs()
        print(f"[3] {label} {name}: max|ref| {scale}, max |diff| "
              f"{float(err.max())}, median |diff| {float(err.median())}",
              flush=True)
        check(float(err.max()) <= 2e-2 * scale, f"{label}: {name} max "
              "within 2e-2")
        check(float(err.median()) <= 2e-3 * scale, f"{label}: {name} median "
              "within 2e-3")
    # the offsets depend on the trunk: keypoints are not just the anchors
    off = float((cpu[2] - cpu[1]).abs().max())
    check(off > 1e-2, f"{label}: keypoint offsets nontrivial")
    print(f"[3] {label}: max |keypoint - anchor| {off}", flush=True)


def seeded_descriptor(cfg, device):
    desc = Descriptor(cfg.descriptor)
    desc.load_state_dict({k: torch.tensor(v) for k, v in
                          seeded_descriptor_state_dict(cfg.descriptor,
                                                       SEED).items()},
                         strict=True)
    return desc.to(device)


def compare_descriptor(rng):
    """The KITTI descriptor preset's eval forward in fp32 (trunk and balls)
    at full width, B=2: on the card and on the CPU with the same seeded
    weights, cloud, keypoints and priorities. The balls (ball features)
    identical; the descriptors within 1e-4 at the maximum and 1e-6 at the
    median (unit vectors)."""
    cfg = get_config("kitti", role="descriptor", **DESC_FP32)
    pc, sn = oxford_cloud(rng, 2, cfg.data.input_pc_num)
    kp, prio = descriptor_ball_inputs(rng, torch.from_numpy(pc))
    outs = []
    for device in ("cuda", "cpu"):
        desc = seeded_descriptor(cfg, device).eval()
        to = lambda x: torch.as_tensor(x).to(device)  # noqa: E731
        with torch.inference_mode():
            d, feats = desc(to(pc), to(sn), to(kp), to(prio))
        outs.append((d.cpu(), feats.cpu()))
    (gd, gf), (cd, cf) = outs
    check(torch.equal(gf, cf), "descriptor ball features identical on card "
          "and CPU")
    err = (gd - cd).abs()
    norms = cd.norm(dim=-1)
    print(f"[3] kitti descriptor fp32 (2, {cfg.data.input_pc_num}) x "
          f"{kp.shape[1]} keypoints -> {cfg.descriptor.descriptor_len}: ball "
          f"features identical, descriptors max |diff| {float(err.max())}, "
          f"median |diff| {float(err.median())}, norms "
          f"{float(norms.min())}-{float(norms.max())}", flush=True)
    check(bool(torch.isfinite(gd).all()), "descriptors finite")
    check(float(err.max()) <= 1e-4 and float(err.median()) <= 1e-6,
          "descriptor fp32 forward on the card within 1e-4 (max) and 1e-6 "
          "(median) of the CPU's")


def phase3():
    """Full-width fp32 forwards, card (kernels) against CPU (plain)."""
    fp32 = {"detector.compute_dtype": "float32"}
    rng = np.random.default_rng(2)
    compare_slice("kitti som", get_config("kitti", **fp32), kitti_cloud, rng)
    for grouping in ("ball", "knn"):
        compare_slice(f"oxford {grouping}", oxford_config(grouping, **fp32),
                      oxford_cloud, rng)
    compare_descriptor(rng)


def serve_cli(tag, tmp, ckpt, clouds, cli_args):
    """Serve 3 requests through ``python -m usip_tpu_torch.cli serve
    --device cuda`` and check every reply's .bin file."""
    nk = 128
    out_dir = os.path.join(tmp, f"served_{tag}")
    reqs = [{"id": i, "input": c, "out": out_dir, "num_keypoints": nk}
            for i, c in enumerate(clouds)] + [{"cmd": "shutdown"}]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "usip_tpu_torch.cli", "serve", "--device",
         "cuda", *cli_args, "--checkpoint", ckpt],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env=env)
    try:
        stdout, stderr = proc.communicate(
            "".join(json.dumps(r) + "\n" for r in reqs), timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"serve {tag} exited {proc.returncode}: "
          f"{stderr[-2000:]}")
    replies = [json.loads(s) for s in stdout.splitlines()]
    check(replies[0].get("status") == "ready", f"serve ready: {replies[:1]}")
    check(replies[-1] == {"status": "bye"}, "serve said bye")
    for i, rep in enumerate(replies[1:-1]):
        check(rep.get("id") == i and rep.get("n") == nk, f"reply {rep}")
        kp = np.fromfile(rep["keypoints"], np.float32).reshape(-1, 3)
        check(kp.shape == (nk, 3) and np.isfinite(kp).all(),
              f"{rep['keypoints']} holds {nk} finite rows")
    check(len(replies) == 5, f"3 replies, got {replies}")
    print(f"[4] serve {' '.join(cli_args)} --device cuda: 3 requests "
          f"answered, {nk} keypoints each, .bin files written "
          f"({time.perf_counter() - t0:.1f} s with start-up)", flush=True)


def phase4(tmp):
    """Per main path: a seeded checkpoint and 3 clouds, 3 requests over the
    CLI (SOM and ball), then ``KeypointPipeline.detect`` x3 in process with
    the launch counts reset just before and read just after; each path must
    have launched its kernels."""
    rng = np.random.default_rng(3)
    paths = {
        "som": (get_config("kitti"), kitti_cloud, ["--dataset", "kitti"]),
        "ball": (oxford_config("ball"), oxford_cloud,
                 ["--dataset", "oxford", "--override",
                  "detector.grouping=ball"]),
        "knn": (oxford_config("knn"), oxford_cloud, None),
    }
    pipes, launches = {}, {}
    for tag, (cfg, cloud_fn, cli_args) in paths.items():
        ckpt = os.path.join(tmp, f"detector_{tag}.pth")
        torch.save({k: torch.tensor(v) for k, v in
                    seeded_state_dict(cfg.detector, SEED).items()}, ckpt)
        clouds = []
        for i in range(3):
            pc, sn = cloud_fn(rng, 1, 20000)
            path = os.path.join(tmp, f"{tag}_cloud{i}.npy")
            np.save(path, np.concatenate([pc[0], sn[0]], -1))
            clouds.append(path)
        if cli_args:
            serve_cli(tag, tmp, ckpt, clouds, cli_args)
        pipe = KeypointPipeline(cfg, ckpt, "cuda")
        kernels.reset_launch_counts()
        for c in clouds:
            data = np.load(c)
            kp, _ = pipe.detect(data[:, :3], data[:, 3:], num_keypoints=128)
            check(kp.shape == (128, 3) and np.isfinite(kp).all(),
                  f"{tag} detect output")
        sync()
        launches[tag] = dict(kernels.LAUNCHES)
        print(f"[4] {tag} path, KeypointPipeline.detect x3 in process: "
              f"launches {launches[tag]}", flush=True)
        for name in PATH_KERNELS[tag]:
            check(launches[tag][name] > 0,
                  f"kernel {name} launched on the {tag} path")
        pipes[tag] = pipe
    return pipes, launches


def phase5(pipes, card):
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    times = {}
    kitti = get_config("kitti")
    bounds = kernel_bounds(kitti.detector.c1, kitti.detector.c2,
                           kitti.detector.node_knn_k)

    pts = torch.from_numpy(kitti_cloud(rng, B_BENCH, 2048)[0]).to(dev)
    first = torch.from_numpy(rng.integers(0, 2048, B_BENCH).astype(
        np.int32)).to(dev)
    # kernels and library calls: CUDA-graph replay (device time), with the
    # back-to-back event time beside it in `events`; plain versions:
    # back-to-back events
    events = {}
    times["fps"] = (graph_ms(lambda: kernels.fps(pts, first, 512), 20),
                    time_ms(lambda: kernels.fps_plain(pts, first, 512), 3))
    events["fps"] = time_ms(lambda: kernels.fps(pts, first, 512), 50)

    pc = torch.from_numpy(kitti_cloud(rng, B_BENCH, 16384)[0]).to(dev)
    nodes = pc[:, :512].contiguous()
    times["min_argmin"] = (
        graph_ms(lambda: kernels.min_argmin(pc, nodes, True), 50),
        time_ms(lambda: kernels.min_argmin_plain(pc, nodes, True), 10))
    events["min_argmin"] = time_ms(
        lambda: kernels.min_argmin(pc, nodes, True), 50)
    # K2 at each of its shapes, beside its bound and issue-slot floor
    k2 = {}
    for label, (b, n, m, bf16) in K2_SHAPES.items():
        pts, cand = k2_inputs(rng, b, n, m, dev)
        run = lambda p=pts, c=cand, f=bf16: kernels.min_argmin(p, c, f)  # noqa: E731
        plain = lambda p=pts, c=cand, f=bf16: kernels.min_argmin_plain(  # noqa: E731
            p, c, f)
        bnd = min_argmin_bound(b, n, m)
        # measured times and the bound only: the issue-slot floor (a count
        # of instructions, not a measurement) and the host's form are printed
        k2[label] = {"ms": graph_ms(run, 50), "plain_ms": time_ms(plain, 5),
                     "events_ms": time_ms(run, 50), "bound_ms": bnd[0],
                     "bound_by": bnd[1]}
        print(f"[5] {card} | min_argmin {label}: kernel "
              f"{k2[label]['ms']:.4f} ms (back-to-back events "
              f"{k2[label]['events_ms']:.4f} ms), plain "
              f"{k2[label]['plain_ms']:.4f} ms, bound {bnd[0]:.4f} ms by "
              f"{bnd[1]}, issue-slot floor "
              f"{min_argmin_floor(b, n, m, bf16):.4f} ms "
              f"({K2_INSTR[bf16]:g} instructions a pair), form "
              f"{list(kernels.min_argmin_form(b, n, m))}", flush=True)
        del pts, cand

    chain = pipes["som"]._chain
    grouped = torch.from_numpy(np.abs(rng.normal(
        size=(B_BENCH, 512, 16, 3 + kitti.detector.c1))).astype(
            np.float32)).to(dev)
    times["fusion_chain"] = (
        graph_ms(lambda: kernels.fusion_chain(grouped, chain), 20),
        time_ms(lambda: kernels.fusion_chain_plain(grouped, *chain[:2]), 5))
    events["fusion_chain"] = time_ms(
        lambda: kernels.fusion_chain(grouped, chain), 50)

    # K4 at the ball selection's shape (the JSON line's time) and at the
    # node kNN's
    opc = torch.from_numpy(oxford_cloud(rng, B_BENCH, 16384)[0]).to(dev)
    # torch.topk is the one PyTorch call for the same selection: a
    # yardstick only (the port never calls it; it documents no tie order)
    scores = ball_scores(opc, opc[:, :512].contiguous(), 2.0)
    times["smallest_k"] = (
        graph_ms(lambda: kernels.smallest_k(scores, 64), 20),
        time_ms(lambda: kernels.smallest_k_plain(scores, 64), 3))
    events["smallest_k"] = time_ms(lambda: kernels.smallest_k(scores, 64),
                                   50)
    library = {"smallest_k": graph_ms(lambda: torch.topk(
        scores, 64, dim=-1, largest=False, sorted=True), 20)}
    del scores
    # K4 at the descriptor's ball query (8, 256, 16384) k=64 in the preset's
    # bf16 mode; and the whole ball query (distances, scores, selection)
    dkp, prio = descriptor_ball_inputs(rng, opc)
    dscores = ball_scores(opc, dkp, 2.0, prio, round_bf16=True)
    desc_ball = {
        "ms": graph_ms(lambda: kernels.smallest_k(dscores, 64), 20),
        "plain_ms": time_ms(lambda: kernels.smallest_k_plain(dscores, 64),
                            3),
        "library_ms": graph_ms(lambda: torch.topk(
            dscores, 64, dim=-1, largest=False, sorted=True), 20),
        "events_ms": time_ms(lambda: kernels.smallest_k(dscores, 64), 50),
        "bound_ms": DESC_BALL_BOUND[0], "bound_by": DESC_BALL_BOUND[1],
        "ball_scores_ms": time_ms(lambda: ball_scores(
            opc, dkp, 2.0, prio, round_bf16=True), 10),
        "ball_query_ms": time_ms(lambda: ball_select(ball_scores(
            opc, dkp, 2.0, prio, round_bf16=True), 64), 10)}
    print(f"[5] {card} | smallest_k descriptor ball (8, 256, 16384) k=64, "
          f"bf16 priorities: kernel {desc_ball['ms']:.4f} ms (back-to-back "
          f"events {desc_ball['events_ms']:.4f} ms), plain "
          f"{desc_ball['plain_ms']:.4f} ms, torch.topk "
          f"{desc_ball['library_ms']:.4f} ms, bound "
          f"{DESC_BALL_BOUND[0]:.4f} ms by {DESC_BALL_BOUND[1]}; the whole "
          f"ball query {desc_ball['ball_query_ms']:.4f} ms, of which the "
          f"scores (distances, compare, priorities) "
          f"{desc_ball['ball_scores_ms']:.4f} ms", flush=True)
    del dscores
    nd = pairwise_sqdist(opc[:, :512], opc[:, :512])
    knn_ms = (graph_ms(lambda: kernels.smallest_k(nd, 16), 50),
              time_ms(lambda: kernels.smallest_k_plain(nd, 16), 20),
              graph_ms(lambda: torch.topk(nd, 16, dim=-1, largest=False,
                                          sorted=True), 50),
              time_ms(lambda: kernels.smallest_k(nd, 16), 200))
    # K5 at both calls of one SOM forward, C=64 and C=128 (the JSON line
    # gives their sum, on uniform ids), and on the trunk's own assignment ids
    ids = torch.from_numpy(rng.integers(0, 512, size=(B_BENCH, 16384))).to(dev)
    aids = assignment_ids(rng, dev)
    k5, k5_assign = {}, {}
    for c in (64, 128):
        f = torch.from_numpy(rng.normal(size=(B_BENCH, 16384, c)).astype(
            np.float32)).to(dev)
        k5[c] = (graph_ms(lambda: kernels.scatter_max(f, ids, 512), 50),
                 time_ms(lambda: kernels.scatter_max_plain(f, ids, 512), 20),
                 graph_ms(lambda: kernels.scatter_max_plain(f, ids, 512), 20),
                 time_ms(lambda: kernels.scatter_max(f, ids, 512), 50))
        k5_assign[c] = (
            graph_ms(lambda: kernels.scatter_max(f, aids, 512), 50),
            graph_ms(lambda: kernels.scatter_max_plain(f, aids, 512), 20))
    times["scatter_max"] = (k5[64][0] + k5[128][0], k5[64][1] + k5[128][1])
    events["scatter_max"] = k5[64][3] + k5[128][3]
    # scatter_reduce('amax') is both K5's plain version and its library call
    library["scatter_max"] = k5[64][2] + k5[128][2]
    for name, (k_ms, p_ms) in times.items():
        lib = library.get(name)
        print(f"[5] {card} | {name}: kernel {k_ms:.4f} ms (back-to-back "
              f"events {events[name]:.4f} ms), plain "
              f"{p_ms:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bounds[name][0]:.4f} ms by {bounds[name][1]} (batch 8, "
              "main-path shapes)", flush=True)
    print(f"[5] {card} | smallest_k node kNN (8, 512, 512) k=16: kernel "
          f"{knn_ms[0]:.4f} ms (back-to-back events {knn_ms[3]:.4f} ms), "
          f"plain {knn_ms[1]:.4f} ms, torch.topk "
          f"{knn_ms[2]:.4f} ms, bound {KNN_BOUND[0]:.4f} ms; scatter_max "
          f"C=64 kernel {k5[64][0]:.4f} ms, plain {k5[64][1]:.4f} ms; C=128 "
          f"kernel {k5[128][0]:.4f} ms, plain {k5[128][1]:.4f} ms",
          flush=True)
    print(f"[5] {card} | scatter_max on assignment ids (K2 against 512 FPS "
          f"nodes): C=64 kernel {k5_assign[64][0]:.4f} ms, scatter_reduce "
          f"{k5_assign[64][1]:.4f} ms; C=128 kernel {k5_assign[128][0]:.4f} "
          f"ms, scatter_reduce {k5_assign[128][1]:.4f} ms; both calls "
          f"{k5_assign[64][0] + k5_assign[128][0]:.4f} ms (uniform ids "
          f"{times['scatter_max'][0]:.4f} ms)", flush=True)

    # stages of the batch-8 bf16 SOM forward, each timed alone
    pipe = pipes["som"]
    pc8_np, sn8_np = kitti_cloud(rng, B_BENCH, kitti.data.input_pc_num)
    pc8 = torch.from_numpy(pc8_np).to(dev)
    sn8 = torch.from_numpy(sn8_np).to(dev)
    det = pipe.detector
    with torch.inference_mode():
        node = sample_nodes(pc8, kitti.data.node_num,
                            kitti.data.fps_subsample_ratio,
                            generator=pipe._gen)
        anchors, feat = det.som_trunk(pc8, sn8, node)
        grouped8 = knn_group(anchors, anchors, feat,
                             kitti.detector.node_knn_k)
        knn_feat = kernels.fusion_chain(grouped8, chain)
        agg = torch.cat([feat, knn_feat], -1)
        stages = {
            "sample_nodes": lambda: sample_nodes(
                pc8, kitti.data.node_num, kitti.data.fps_subsample_ratio,
                generator=pipe._gen),
            "som_trunk": lambda: det.som_trunk(pc8, sn8, node),
            "knn_group": lambda: knn_group(anchors, anchors, feat,
                                           kitti.detector.node_knn_k),
            "fusion_chain": lambda: kernels.fusion_chain(grouped8, chain),
            "head": lambda: det.keypoint_head(agg, anchors),
        }
        parts = {k: time_ms(f, 20) for k, f in stages.items()}
    print(f"[5] {card} | stages of the batch-8 bf16 SOM forward (ms): "
          + json.dumps({k: round(v, 4) for k, v in parts.items()}),
          flush=True)

    # one request's latency: a 20,000-point cloud through detect, host
    # subsampling and keypoint selection included (the result is on the host)
    one_pc, one_sn = kitti_cloud(rng, 1, 20000)
    lat = []
    for i in range(22):
        t0 = time.perf_counter()
        pipe.detect(one_pc[0], one_sn[0], num_keypoints=128)
        lat.append((time.perf_counter() - t0) * 1e3)
    lat = np.sort(lat[2:])
    print(f"[5] {card} | SOM detect latency, one 20000-point cloud, 128 "
          f"keypoints: median {np.median(lat):.3f} ms, max {lat[-1]:.3f} ms "
          f"over {lat.size} requests", flush=True)
    rate, ms, peak = bench_rate(pipe, pc8, sn8)
    print(f"[5] {card} | detect SOM (kitti) bf16 batch 8: {rate:.2f} "
          f"clouds/s ({ms:.3f} ms per batch, best of 3 x 50); peak memory "
          f"{peak:.0f} MiB", flush=True)

    # the ball path: stages of its batch-8 bf16 forward, then its rate
    pipe = pipes["ball"]
    ox = pipe.cfg
    r, gk = ox.detector.group_radius, ox.detector.group_k
    pc8_np, sn8_np = oxford_cloud(rng, B_BENCH, ox.data.input_pc_num)
    pc8 = torch.from_numpy(pc8_np).to(dev)
    sn8 = torch.from_numpy(sn8_np).to(dev)
    det = pipe.detector
    chain = pipe._chain
    with torch.inference_mode():
        node = sample_nodes(pc8, ox.data.node_num,
                            ox.data.fps_subsample_ratio, generator=pipe._gen)
        scores = ball_scores(pc8, node, r)
        idx = ball_select(scores, gk).idx
        feat = det.group_features(pc8, sn8, node, idx)
        grouped8 = knn_group(node, node, feat, ox.detector.node_knn_k)
        knn_feat = kernels.fusion_chain(grouped8, chain)
        agg = torch.cat([feat, knn_feat], -1)
        stages = {
            "sample_nodes": lambda: sample_nodes(
                pc8, ox.data.node_num, ox.data.fps_subsample_ratio,
                generator=pipe._gen),
            "ball_distances": lambda: ball_scores(pc8, node, r),
            "selection": lambda: ball_select(scores, gk),
            "gather_conv1_5": lambda: det.group_features(pc8, sn8, node, idx),
            "knn_group": lambda: knn_group(node, node, feat,
                                           ox.detector.node_knn_k),
            "fusion_chain": lambda: kernels.fusion_chain(grouped8, chain),
            "head": lambda: det.keypoint_head(agg, node),
        }
        parts = {k: time_ms(f, 20) for k, f in stages.items()}
        del scores
    print(f"[5] {card} | stages of the batch-8 bf16 ball forward (ms): "
          + json.dumps({k: round(v, 4) for k, v in parts.items()}),
          flush=True)
    for tag in ("ball", "knn"):
        rate, ms, peak = bench_rate(pipes[tag], pc8, sn8)
        print(f"[5] {card} | detect {tag} (oxford) bf16 batch 8: {rate:.2f} "
              f"clouds/s ({ms:.3f} ms per batch, best of 3 x 50); peak "
              f"memory {peak:.0f} MiB", flush=True)
    return times, library, bounds, knn_ms, events, k2, desc_ball


def train_state(cfg, device):
    return TrainState.create(seeded_detector(cfg, device), cfg.train.lr)


def parent_batch(rng, cfg, b, device):
    pc, sn = kitti_cloud(rng, b, cfg.data.parent_pc_num)
    return ParentBatch(torch.from_numpy(pc).to(device),
                       torch.from_numpy(sn).to(device))


def event_split(run, names, iters):
    """The mean time (ms) of each part of a step, over ``iters`` steps:
    ``run(mark)`` runs one step, which calls ``mark`` after each of its
    parts; a CUDA event is recorded before the step and at each mark
    (timing only)."""
    marks = []
    for _ in range(iters):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()

        def mark(ev=ev):
            ev.append(torch.cuda.Event(enable_timing=True))
            ev[-1].record()

        run(mark)
        marks.append(ev)
    sync()
    check(all(len(ev) == len(names) + 1 for ev in marks),
          f"one mark a part of the step ({names})")
    return {n: float(np.mean([ev[i].elapsed_time(ev[i + 1])
                              for ev in marks]))
            for i, n in enumerate(names)}


def profile_busy(fn, calls):
    """Over ``calls`` calls of ``fn`` under torch.profiler: the device's
    busy time a call (ms, the kernels' self device time), the operators by
    their self device time a call ``[(ms, calls, name)]``, largest first,
    and the profiled wall time a call (s)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        wall = (time.perf_counter() - t0) / calls
    events = prof.key_averages()
    device = torch.autograd.DeviceType.CUDA
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == device) / (1e3 * calls)
    ops = sorted(((e.self_device_time_total / (1e3 * calls),
                   e.count // calls, e.key)
                  for e in events if e.device_type != device
                  and e.self_device_time_total > 0), reverse=True)
    return busy, ops, wall


def phase6(card):
    """The train path: five full-width steps with the launch counts reset
    before and read after; one fp32 step on the card against the CPU; the
    step's time and split."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    # the KITTI preset as it trains: batch 8 parents of 20480 points, two
    # 16384-point siamese copies each, bf16 trunk
    cfg = get_config("kitti")
    b = cfg.train.batch_size
    batch = parent_batch(rng, cfg, b, dev)
    state = train_state(cfg, dev)
    step = make_detector_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels.reset_launch_counts()
    history = [step(state, batch, 0, generator=gen)
               for _ in range(TRAIN_STEPS)]
    sync()
    launches = dict(kernels.LAUNCHES)
    losses = [float(h["loss"]) for h in history]
    norms = [float(h["grad_norm"]) for h in history]
    print(f"[6] train kitti bf16 batch {b} ({2 * b} clouds of "
          f"{cfg.data.input_pc_num} points), {TRAIN_STEPS} steps: losses "
          f"{losses}, grad norms {norms}; launches {launches}", flush=True)
    check(all(np.isfinite(losses + norms)), "train losses and gradient "
          "norms finite")
    check(all(all(bool(torch.isfinite(v)) for v in h.values())
              for h in history), "every train metric finite")
    for name in PATH_KERNELS["train"]:
        check(launches[name] > 0, f"kernel {name} launched on the train "
              "path")

    # one fp32 step, batch 2, on the card and on the CPU (plain versions)
    # from the same weights, parents and draws (a CPU generator on both):
    # the metrics, and every parameter's gradient
    cfg32 = get_config("kitti", **{"detector.compute_dtype": "float32"})
    batch2 = parent_batch(rng, cfg32, 2, "cpu")
    res, grads = {}, {}
    for device in ("cuda", "cpu"):
        st = train_state(cfg32, device)
        # the card's atomic accumulations (index_add, scatter_add in the
        # backward) sum in an order that changes from run to run, and a
        # ReLU input within that noise of 0 moves the gradients below it:
        # the deterministic algorithms make the card's step repeatable
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            res[device] = make_detector_train_step(cfg32)(
                st, ParentBatch(*(t.to(device) for t in batch2)), 0,
                generator=torch.Generator().manual_seed(SEED + 1))
        finally:
            torch.use_deterministic_algorithms(False)
        grads[device] = {n: p.grad.detach().double().cpu() for n, p in
                         st.model.named_parameters() if p.grad is not None}
    gpu, cpu = ({k: float(v) for k, v in res[d].items()}
                for d in ("cuda", "cpu"))
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu}
    print(f"[6] train kitti fp32 batch 2, one step on the card and on the "
          f"CPU: card {json.dumps(gpu)}, CPU {json.dumps(cpu)}, relative "
          f"differences {json.dumps(rel)} (tolerance: loss and its parts "
          "1e-4, grad_norm 1e-3)", flush=True)
    # per parameter: max|card - CPU| over its max|CPU gradient|, that max
    # floored at GRAD_TOL[0] of the largest gradient (a gradient below it is
    # rounding noise: a conv bias ahead of a train-mode BatchNorm, whose
    # gradient is 0, or one whose shift BatchNorm all but removes), and the
    # cosine where the gradient is above the floor
    check(set(grads["cuda"]) == set(grads["cpu"]), "the same parameters "
          "have gradients on the card and on the CPU")
    gmax = max(float(g.abs().max()) for g in grads["cpu"].values())
    leaf = {}
    for n, ref in grads["cpu"].items():
        scale = float(ref.abs().max()) / gmax
        err = float((grads["cuda"][n] - ref).abs().max()) / (
            max(scale, GRAD_TOL[0]) * gmax)
        cos = float(torch.nn.functional.cosine_similarity(
            grads["cuda"][n].flatten(), ref.flatten(), 0)) \
            if scale >= GRAD_TOL[0] else None
        leaf[n] = (scale, err, cos)
    worst = max((e, n) for n, (_, e, _) in leaf.items())
    low = min((c, n) for n, (_, _, c) in leaf.items() if c is not None)
    noise = sum(c is None for *_, c in leaf.values())
    print(f"[6] train kitti fp32 batch 2, gradients card against CPU, "
          f"{len(leaf)} parameters ({noise} below {GRAD_TOL[0]:g} of the "
          f"largest): worst max|diff| over "
          f"max(max|g|, the floor) {worst[0]:.3e} ({worst[1]}), lowest cosine "
          f"{low[0]:.9f} ({low[1]}) (tolerance: {GRAD_TOL[1]:g}, cosine >= "
          f"{GRAD_TOL[2]}); by parameter [name, max|g| / largest, error, "
          "cosine]: " + json.dumps([[n, round(a, 8), round(e, 8),
                                     None if c is None else round(c, 10)]
                                    for n, (a, e, c) in leaf.items()]),
          flush=True)
    for k, r in rel.items():
        check(r <= (1e-3 if k == "grad_norm" else 1e-4),
              f"fp32 train step {k} on the card within tolerance of the CPU")
    check(worst[0] <= GRAD_TOL[1] and low[0] >= GRAD_TOL[2], "fp32 train "
          "step gradients on the card within tolerance of the CPU, parameter "
          "by parameter")

    # the step's time (host clock over pipelined steps, one synchronize)
    for _ in range(2):
        step(state, batch, 0, generator=gen)
    sync()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, batch, 0, generator=gen)
    sync()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    # its split: CUDA events queued between the step's parts
    split = event_split(
        lambda mark: step(state, batch, 0, generator=gen, mark=mark),
        ("prep", "forward", "losses", "backward", "optimizer"), iters)
    step_rate = 2 * b * 1e3 / step_ms
    print(f"[6] {card} | train step kitti bf16 batch {b}: {step_ms:.3f} ms "
          f"a step (mean of {iters}, pipelined), {2 * b * 1e3 / step_ms:.2f} "
          f"clouds/s ({b * 1e3 / step_ms:.2f} parent samples/s); split (ms, "
          f"CUDA events between the parts): "
          + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f"; peak memory {peak:.0f} MiB", flush=True)

    # where the step's device time goes: torch.profiler over 2 steps; the
    # kernels' device time a step in all, and by the operator that launched
    # them (its self device time), the 15 largest
    busy, ops, _ = profile_busy(lambda: step(state, batch, 0,
                                             generator=gen), 2)
    print(f"[6] {card} | train step kitti bf16 batch {b}, torch.profiler "
          f"over 2 steps: kernels {busy:.3f} ms a step on the device "
          f"({busy / step_ms:.4f} of the unprofiled step); by operator "
          "[name, ms a step, calls a step]: "
          + json.dumps([[k, round(t, 4), c] for t, c, k in ops[:15]]),
          flush=True)
    return launches, step_rate


def run_module(tag, args, timeout=900):
    """``python -m <args>`` from the repo, to its end: its stdout (the
    command fails the script on a nonzero exit) and its wall time."""
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=timeout)
    check(proc.returncode == 0, f"{tag} exited {proc.returncode}: "
          f"{proc.stderr[-3000:]} {proc.stdout[-2000:]}")
    return proc.stdout, time.perf_counter() - t0


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase7(card, tmp, step_rate):
    """The engine at full KITTI width: train through the CLI and resume,
    one epoch in process with its launches, rate and idle share, bench."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "kitti_tree")
    counts = build_synthetic_kitti_tree(root, **TREE)
    print(f"[7] synthetic KITTI tree: {sum(counts.values())} scans of "
          f"{TREE['target_points']} points {counts} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ckpt_dir = os.path.join(tmp, "ckpt")
    out_dir = os.path.join(ckpt_dir, "kitti")
    base = ["usip_tpu_torch.cli", "train-detector", "--dataset", "kitti",
            "--dataroot", root, "--name", "kitti", "--checkpoints-dir",
            ckpt_dir, "--device", "cuda", "--override", "train.log_every=5"]
    _, t_first = run_module("train-detector", base + ["--epochs", "2"])
    for name in ("config.json", "kitti_metrics.jsonl", "last.pt",
                 "last.pt.json"):
        check(os.path.exists(os.path.join(out_dir, name)),
              f"train-detector wrote {name}")
    with open(os.path.join(out_dir, "config.json")) as f:
        saved = json.load(f)
    check((saved["data"]["input_pc_num"], saved["data"]["parent_pc_num"],
           saved["data"]["node_num"], saved["detector"]["c1"],
           saved["detector"]["c2"], saved["data"]["wire_dtype"],
           saved["detector"]["compute_dtype"])
          == (16384, 20480, 512, 128, 512, "float16", "bfloat16"),
          "train-detector ran the KITTI preset at full width")
    first = read_jsonl(os.path.join(out_dir, "kitti_metrics.jsonl"))
    out, t_resume = run_module("train-detector --resume auto",
                               base + ["--epochs", "3", "--resume", "auto"])
    check("at epoch 2" in out, "the resumed run starts at epoch 2")
    recs = read_jsonl(os.path.join(out_dir, "kitti_metrics.jsonl"))
    resumed = recs[len(first):]
    check(bool(resumed) and {r["epoch"] for r in resumed} == {2},
          "the resumed run trains epoch 2 only")
    losses = [r["loss"] for r in recs if "loss" in r]
    check(bool(losses) and all(np.isfinite(losses)), "every loss finite")
    ckpt = find_checkpoint(out_dir)
    check(ckpt is not None, "a best or last checkpoint")
    epochs = [(r["epoch"], round(r["loss"], 4), round(r["sigma_mean"], 4))
              for r in recs if r["prefix"] == "train_epoch"]
    tests = [(r["epoch"], round(r["loss"], 4)) for r in recs
             if r["prefix"] == "test"]
    print(f"[7] train-detector --dataset kitti --device cuda: 2 epochs in "
          f"{t_first:.1f} s, --resume auto to epoch 3 in {t_resume:.1f} s "
          f"(process start-up included); [epoch, train loss, sigma_mean] "
          f"{epochs}, [epoch, test loss] {tests}; checkpoint {ckpt}",
          flush=True)

    # one epoch of the engine in process, counts reset before and read after
    cfg = get_config("kitti", **{"data.dataroot": root,
                                 "train.log_every": 100})
    train, test = cli._make_loaders(
        cfg, types.SimpleNamespace(synthetic=False),
        cfg.detector.surface_normal_len)
    engine = DetectorEngine(cfg, train, test,
                            out_dir=os.path.join(tmp, "engine"),
                            device="cuda")
    engine.train_epoch(0)  # warm-up
    sync()
    steps = len(train)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    avg = engine.train_epoch(1)  # ends with one fetch of the epoch's metrics
    sync()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(all(np.isfinite(list(avg.values()))), "engine epoch metrics finite")
    for name in PATH_KERNELS["engine"]:
        check(launches[name] > 0, f"kernel {name} launched on the engine "
              "path")
    rate = 2 * cfg.train.batch_size * steps / wall
    # the device's busy time over the next epoch (torch.profiler), against
    # the unprofiled epoch's wall time
    busy, _, pwall = profile_busy(lambda: engine.train_epoch(2), 1)
    idle = 1.0 - busy / (wall * 1e3)
    print(f"[7] {card} | engine train kitti bf16 batch "
          f"{cfg.train.batch_size}, one epoch of {steps} steps in process: "
          f"{rate:.2f} clouds/s ({wall / steps * 1e3:.3f} ms a step, both "
          f"siamese copies counted, one fetch at the epoch's end); the bare "
          f"step (phase 6) {step_rate:.2f} clouds/s; device busy "
          f"{busy:.3f} ms over the profiled epoch ({pwall * 1e3:.3f} ms "
          f"profiled), idle share {idle:.4f} of the unprofiled epoch's "
          f"{wall * 1e3:.3f} ms; launches {launches}; epoch metrics "
          + json.dumps({k: round(v, 4) for k, v in avg.items()}), flush=True)

    # the same epoch with its batches assembled on the host beforehand (the
    # prefetch thread still pins and copies them): what the loader's
    # threads cost the engine
    engine.train_loader = list(train)
    t1 = time.perf_counter()
    engine.train_epoch(1)
    sync()
    pre = time.perf_counter() - t1
    print(f"[7] {card} | the same epoch with its {steps} batches assembled "
          f"beforehand: {2 * cfg.train.batch_size * steps / pre:.2f} "
          f"clouds/s ({pre / steps * 1e3:.3f} ms a step)", flush=True)

    out, t_bench = run_module("bench", ["usip_tpu_torch.cli", "bench",
                                        "--device", "cuda"])
    line = json.loads(out.strip().splitlines()[-1])
    check(line.get("metric") == "kitti_16k_detection_clouds_per_sec_per_chip"
          and line.get("value", 0) > 0 and line.get("batch") == B_BENCH,
          f"bench line {line}")
    print(f"[7] {card} | python -m usip_tpu_torch.cli bench --device cuda "
          f"({t_bench:.1f} s): {json.dumps(line)}", flush=True)
    return launches, root, ckpt


def phase8(card, tmp, root, ckpt):
    """Export with the launch counts of the export path, repeatability, and
    the training-quality gate."""
    kp_dir = os.path.join(tmp, "kp_model")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["export-keypoints", "--dataset", "kitti", "--dataroot",
                  root, "--checkpoint", ckpt, "--out", kp_dir, "--device",
                  "cuda"])
    sync()
    launches = dict(kernels.LAUNCHES)
    t_export = time.perf_counter() - t0
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(stats["frames"] > 0 and stats["mean_keypoints"] == 128,
          f"export stats {stats}")
    for name in PATH_KERNELS["export"]:
        check(launches[name] > 0, f"kernel {name} launched on the export "
              "path")
    bins = [os.path.join(d, f) for d, _, fs in os.walk(kp_dir) for f in fs]
    check(len(bins) == stats["frames"], "a .bin for every exported frame")
    for path in bins:
        kp = np.fromfile(path, np.float32).reshape(-1, 3)
        check(kp.shape == (128, 3) and np.isfinite(kp).all(),
              f"{path} holds 128 finite keypoints")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval-repeatability", "--anc-dir", kp_dir, "--pos-dir",
                  kp_dir, "--kitti-gt", os.path.join(root, "kitti-reg-test"),
                  "--coord-fix", "kitti", "--calib-root",
                  os.path.join(root, "calib")])
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rep["pairs"] > 0 and 0.0 <= rep["repeatability"] <= 1.0,
          f"repeatability {rep}")
    print(f"[8] {card} | export-keypoints --method model (phase 7's "
          f"checkpoint, kitti test frames, batch 8 with the ragged tail "
          f"padded): {json.dumps(stats)} in {t_export:.1f} s; launches "
          f"{launches}; eval-repeatability --coord-fix kitti: "
          f"{json.dumps(rep)}", flush=True)

    out, t_gate = run_module("quality", [
        "usip_tpu_torch.quality", "--root", os.path.join(tmp, "quality"),
        "--device", "cuda", "--factor", str(QUALITY_FACTOR)])
    res = json.loads(out.strip().splitlines()[-1])
    print(f"[8] {card} | quality gate (phase_smoke sizes: input 2048, parent "
          f"2560, M 64, c1 32, c2 128, batch 4, 4096-point scans, 16 "
          f"epochs) in {t_gate:.1f} s: trained repeatability "
          f"{res['trained']['repeatability']}, random "
          f"{res['random']['repeatability']} over {res['pairs']} pairs, "
          f"ratio {res['ratio']} (required >= {QUALITY_FACTOR}); phases (s) "
          f"{json.dumps(res['seconds'])}", flush=True)
    check(res["passed"] and res["ratio"] >= QUALITY_FACTOR,
          "trained/random repeatability >= 2")
    return launches


class KeypointsFrom:
    """A frozen detector that runs on the CPU whatever device its inputs
    are on, its outputs moved back to theirs: the card's descriptor step
    then describes the CPU's keypoints, so the card-against-CPU check of
    the descriptor step compares the descriptor's part alone (the fp32
    detector forward differs between them by up to 9e-4 of max|keypoint|,
    phase 3, enough to move points across a ball's boundary)."""

    def __init__(self, det):
        self.det = det

    def eval(self):
        self.det.eval()
        return self

    def __call__(self, pc, sn, node):
        out = self.det(pc.cpu(), sn.cpu(), node.cpu())
        return tuple(t.to(pc.device) for t in out)


def pair_batch(rng, b, n, device, wire="float16"):
    """B anchor/positive pairs in the packed wire: urban-like clouds, the
    positive a reordered copy of the anchor's cloud moved by N(0, 0.05^2)
    (a nearby scan), negatives a shifted permutation."""
    pc, sn = oxford_cloud(rng, b, n)
    perm = np.stack([rng.permutation(n) for _ in range(b)])
    pos = np.take_along_axis(pc, perm[..., None], 1) + rng.normal(
        0, 0.05, pc.shape).astype(np.float32)
    pos_sn = np.take_along_axis(sn, perm[..., None], 1)
    packed = pack_pair_batch(pc, sn, pos, pos_sn, (np.arange(b) + 1) % b,
                             wire=wire)
    return PackedPairBatch(torch.from_numpy(packed.x).to(device),
                           torch.from_numpy(packed.neg_idx).long().to(device))


def phase9_step(card):
    """The descriptor's train step at full width: five steps with the
    launch counts reset before and read after; one fp32 step on the card
    against the CPU; the step's time, clouds/s and split."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    # the KITTI descriptor preset as it trains: 8 pairs of 16384-point
    # clouds, 256 keypoints a cloud, bf16 trunk and balls, a frozen bf16
    # KITTI SOM detector
    cfg = get_config("kitti", role="descriptor")
    b, n = cfg.train.batch_size, cfg.data.input_pc_num
    batch = pair_batch(rng, b, n, dev, cfg.data.wire_dtype)
    det = seeded_detector(cfg, dev, head_init=True).requires_grad_(False)
    state = TrainState.create(seeded_descriptor(cfg, dev), cfg.train.lr)
    step = make_descriptor_train_step(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels.reset_launch_counts()
    history = [step(state, det, batch, 0, generator=gen)
               for _ in range(DESC_STEPS)]
    sync()
    launches = dict(kernels.LAUNCHES)
    losses = [float(h["loss"]) for h in history]
    norms = [float(h["grad_norm"]) for h in history]
    with torch.no_grad():
        anc = train_steps._as_pair(batch)
        node = sample_nodes(anc[0], cfg.data.node_num,
                            cfg.data.fps_subsample_ratio, generator=gen)
        kp = det(anc[0], anc[1], node)[1]
        counts = ball_select(ball_scores(
            anc[0], kp, cfg.descriptor.ball_radius,
            torch.rand(anc[0].shape[:2], generator=gen, device=dev),
            round_bf16=True), cfg.descriptor.ball_nsamples).counts
    k = cfg.descriptor.ball_nsamples
    print(f"[9] train descriptor kitti bf16 batch {b} ({b} pairs of {n} "
          f"points, {cfg.data.node_num} keypoints a cloud, balls r="
          f"{cfg.descriptor.ball_radius} k={k}), {DESC_STEPS} steps: losses "
          f"{losses}, grad norms {norms}; launches {launches}; the anchors' "
          f"balls: full {float((counts == k).float().mean()):.4f}, padded "
          f"{float(((counts > 0) & (counts < k)).float().mean()):.4f}, empty "
          f"{float((counts == 0).float().mean()):.4f}", flush=True)
    check(all(np.isfinite(losses + norms)), "descriptor losses and gradient "
          "norms finite")
    check(all(all(bool(torch.isfinite(v)) for v in h.values())
              for h in history), "every descriptor metric finite")
    for name in PATH_KERNELS["descriptor"]:
        check(launches[name] > 0, f"kernel {name} launched on the "
              "descriptor train path")

    # one fp32 step, batch 2, on the card and on the CPU from the same
    # weights, pairs and draws (a CPU generator on both), the CPU detector's
    # keypoints on both (KeypointsFrom): the metrics, every gradient
    cfg32 = get_config("kitti", role="descriptor", **DESC_FP32)
    batch2 = pair_batch(rng, 2, n, "cpu", "float32")
    cpu_det = seeded_detector(cfg32, "cpu", True).requires_grad_(False)
    res, grads = {}, {}
    for device in ("cuda", "cpu"):
        st = TrainState.create(seeded_descriptor(cfg32, device),
                               cfg32.train.lr)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            res[device] = make_descriptor_train_step(cfg32)(
                st, KeypointsFrom(cpu_det),
                PackedPairBatch(*(t.to(device) for t in batch2)), 0,
                generator=torch.Generator().manual_seed(SEED + 1))
        finally:
            torch.use_deterministic_algorithms(False)
        grads[device] = {nm: p.grad.detach().double().cpu() for nm, p in
                         st.model.named_parameters() if p.grad is not None}
    gpu, cpu = ({k: float(v) for k, v in res[d].items()}
                for d in ("cuda", "cpu"))
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu}
    check(set(grads["cuda"]) == set(grads["cpu"]), "the same descriptor "
          "parameters have gradients on the card and on the CPU")
    gmax = max(float(g.abs().max()) for g in grads["cpu"].values())
    leaf = {}
    for nm, ref in grads["cpu"].items():
        scale = float(ref.abs().max()) / gmax
        err = float((grads["cuda"][nm] - ref).abs().max()) / (
            max(scale, GRAD_TOL[0]) * gmax)
        cos = float(torch.nn.functional.cosine_similarity(
            grads["cuda"][nm].flatten(), ref.flatten(), 0)) \
            if scale >= GRAD_TOL[0] else None
        leaf[nm] = (scale, err, cos)
    worst = max((e, nm) for nm, (_, e, _) in leaf.items())
    low = min((c, nm) for nm, (_, _, c) in leaf.items() if c is not None)
    print(f"[9] train descriptor kitti fp32 batch 2, one step on the card "
          f"and on the CPU (the CPU detector's keypoints on both): card "
          f"{json.dumps(gpu)}, CPU {json.dumps(cpu)}, relative differences "
          f"{json.dumps(rel)} (tolerance: loss and metrics 1e-4, grad_norm "
          f"1e-3); gradients of {len(leaf)} parameters: worst max|diff| "
          f"over max(max|g|, {GRAD_TOL[0]:g} of the largest) {worst[0]:.3e} "
          f"({worst[1]}), lowest cosine {low[0]:.9f} ({low[1]}) (tolerance "
          f"{GRAD_TOL[1]:g}, cosine >= {GRAD_TOL[2]})", flush=True)
    for key, r in rel.items():
        check(r <= (1e-3 if key == "grad_norm" else 1e-4),
              f"fp32 descriptor step {key} on the card within tolerance of "
              "the CPU")
    check(worst[0] <= GRAD_TOL[1] and low[0] >= GRAD_TOL[2], "fp32 "
          "descriptor step gradients on the card within tolerance of the "
          "CPU, parameter by parameter")

    # the step's time (host clock over pipelined steps, one synchronize),
    # its split (the parts one by one, CUDA events between them) and the
    # device's busy time (torch.profiler)
    for _ in range(2):
        step(state, det, batch, 0, generator=gen)
    sync()
    torch.cuda.reset_peak_memory_stats()
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, det, batch, 0, generator=gen)
    sync()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    split = event_split(
        lambda mark: step(state, det, batch, 0, generator=gen, mark=mark),
        ("prep (node sampling)", "frozen detector", "ball query",
         "descriptor forward", "losses", "backward", "optimizer"), iters)
    busy, ops, _ = profile_busy(lambda: step(state, det, batch, 0,
                                             generator=gen), 2)
    rate = 2 * b * 1e3 / step_ms
    print(f"[9] {card} | train step descriptor kitti bf16 batch {b}: "
          f"{step_ms:.3f} ms a step (mean of {iters}, pipelined), "
          f"{rate:.2f} clouds/s ({b * 1e3 / step_ms:.2f} pairs/s); split "
          "(ms, CUDA events between the parts): "
          + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f"; peak memory {peak:.0f} MiB; torch.profiler over 2 steps: "
          f"kernels {busy:.3f} ms a step on the device ({busy / step_ms:.4f}"
          " of the unprofiled step); by operator [name, ms a step, calls a "
          "step]: " + json.dumps([[k, round(t, 4), c] for t, c, k in ops[:15]]),
          flush=True)
    return launches, rate


def phase9_engine(card, tmp, root, ckpt, step_rate):
    """The descriptor through the entry points on phase 7's tree and
    detector: train-descriptor and its resume, the engine in process,
    export-descriptors, eval-registration, detect --descriptor-checkpoint,
    and the descriptor quality gate."""
    launches = {}
    ckpt_dir = os.path.join(tmp, "ckpt_desc")
    out_dir = os.path.join(ckpt_dir, "kitti_descriptor")
    base = ["usip_tpu_torch.cli", "train-descriptor", "--dataset", "kitti",
            "--dataroot", root, "--detector-checkpoint", ckpt, "--name",
            "kitti", "--checkpoints-dir", ckpt_dir, "--device", "cuda",
            "--override", "train.log_every=5"]
    _, t_first = run_module("train-descriptor", base + ["--epochs", "2"])
    for name in ("kitti_desc_metrics.jsonl", "last.pt", "last.pt.json",
                 "best.pt"):
        check(os.path.exists(os.path.join(out_dir, name)),
              f"train-descriptor wrote {name}")
    first = read_jsonl(os.path.join(out_dir, "kitti_desc_metrics.jsonl"))
    out, t_resume = run_module("train-descriptor --resume auto",
                               base + ["--epochs", "3", "--resume", "auto"])
    check("at epoch 2" in out, "the resumed descriptor run starts at epoch 2")
    recs = read_jsonl(os.path.join(out_dir, "kitti_desc_metrics.jsonl"))
    resumed = recs[len(first):]
    check(bool(resumed) and {r["epoch"] for r in resumed} == {2},
          "the resumed descriptor run trains epoch 2 only")
    losses = [r["loss"] for r in recs if "loss" in r]
    check(bool(losses) and all(np.isfinite(losses)),
          "every descriptor loss finite")
    desc_ckpt = os.path.join(out_dir, "best.pt")
    epochs = [(r["epoch"], round(r["loss"], 4),
               round(r["active_percentage"], 4))
              for r in recs if r["prefix"] == "desc_epoch"]
    tests = [(r["epoch"], round(r["loss"], 4)) for r in recs
             if r["prefix"] == "desc_test"]
    print(f"[9] train-descriptor --dataset kitti --device cuda (phase 7's "
          f"tree and detector): 2 epochs in {t_first:.1f} s, --resume auto "
          f"to epoch 3 in {t_resume:.1f} s (process start-up included); "
          f"[epoch, train loss, active share] {epochs}, [epoch, test loss] "
          f"{tests}", flush=True)

    # the engine in process: a warm-up epoch, a timed one with the launch
    # counts reset before and read after, a profiled one
    cfg = get_config("kitti", role="descriptor",
                     **{"data.dataroot": root, "train.log_every": 100})
    ds = KittiDescriptorDataset(cfg.data, "train",
                                sn_len=cfg.descriptor.surface_normal_len)
    loader = BatchLoader(ds, cfg.train.batch_size, shuffle=True,
                         num_workers=cfg.data.num_workers)
    engine = DescriptorEngine(
        cfg, ckpt, train_loader=loader, device="cuda",
        out_dir=os.path.join(tmp, "desc_engine"),
        mine_negatives=lambda raw: ds.mine_negative_indices(
            np.asarray(raw["seq"]), np.asarray(raw["pose"])))
    engine.train_epoch(0)
    sync()
    steps = len(loader)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    avg = engine.train_epoch(1)
    sync()
    wall = time.perf_counter() - t0
    launches["descriptor_engine"] = dict(kernels.LAUNCHES)
    check(all(np.isfinite(list(avg.values()))),
          "descriptor engine epoch metrics finite")
    for name in PATH_KERNELS["descriptor_engine"]:
        check(launches["descriptor_engine"][name] > 0,
              f"kernel {name} launched on the descriptor engine path")
    rate = 2 * cfg.train.batch_size * steps / wall
    busy, _, pwall = profile_busy(lambda: engine.train_epoch(2), 1)
    print(f"[9] {card} | descriptor engine kitti bf16 batch "
          f"{cfg.train.batch_size}, one epoch of {steps} steps in process: "
          f"{rate:.2f} clouds/s ({wall / steps * 1e3:.3f} ms a step, both "
          f"clouds of a pair counted); the bare step {step_rate:.2f} "
          f"clouds/s; device busy {busy:.3f} ms over the profiled epoch "
          f"({pwall * 1e3:.3f} ms profiled), idle share "
          f"{1.0 - busy / (wall * 1e3):.4f} of the unprofiled epoch's "
          f"{wall * 1e3:.3f} ms; launches {launches['descriptor_engine']}; "
          "epoch metrics "
          + json.dumps({k: round(v, 4) for k, v in avg.items()}), flush=True)

    # export-descriptors in process, with the counts of the export path
    feats = os.path.join(tmp, "feats")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["export-descriptors", "--dataset", "kitti", "--dataroot",
                  root, "--checkpoint", ckpt, "--descriptor-checkpoint",
                  desc_ckpt, "--out", feats, "--device", "cuda"])
    sync()
    launches["descriptor_export"] = dict(kernels.LAUNCHES)
    t_export = time.perf_counter() - t0
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    for name in PATH_KERNELS["descriptor_export"]:
        check(launches["descriptor_export"][name] > 0,
              f"kernel {name} launched on the descriptor export path")
    bins = sorted(os.path.relpath(os.path.join(d, f), feats + "/keypoints")
                  for d, _, fs in os.walk(os.path.join(feats, "keypoints"))
                  for f in fs)
    check(stats["frames"] > 0 and len(bins) == stats["frames"],
          f"export-descriptors stats {stats}")
    for rel in bins:
        kp = np.fromfile(os.path.join(feats, "keypoints", rel),
                         np.float32).reshape(-1, 3)
        d = np.fromfile(os.path.join(feats, "descriptors", rel),
                        np.float32).reshape(-1, 128)
        check(kp.shape == (128, 3) and d.shape == (128, 128)
              and np.isfinite(kp).all()
              and np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-3),
              f"{rel}: 128 keypoints and 128 unit descriptors")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval-registration", "--kp-dir",
                  os.path.join(feats, "keypoints"), "--desc-dir",
                  os.path.join(feats, "descriptors"), "--kitti-gt",
                  os.path.join(root, "kitti-reg-test"), "--coord-fix",
                  "kitti", "--calib-root", os.path.join(root, "calib")])
    reg = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(reg["total"] > 0 and 0.0 <= reg["success_rate"] <= 1.0,
          f"registration {reg}")
    print(f"[9] {card} | export-descriptors (kitti test frames, batch 8): "
          f"{json.dumps(stats)} in {t_export:.1f} s, launches "
          f"{launches['descriptor_export']}; eval-registration --coord-fix "
          f"kitti: success {reg['success_rate']} over {reg['total']} pairs, "
          f"RTE {reg['rte_mean']} +- {reg['rte_std']} m, RRE "
          f"{reg['rre_mean']} +- {reg['rre_std']} deg, inlier ratio "
          f"{reg['inlier_ratio_mean']}", flush=True)

    # detect --descriptor-checkpoint in process on two 20000-point clouds
    rng = np.random.default_rng(10)
    clouds = os.path.join(tmp, "desc_clouds")
    os.makedirs(clouds)
    for i in range(2):
        pc, sn = kitti_cloud(rng, 1, 20000)
        np.save(os.path.join(clouds, f"c{i}.npy"),
                np.concatenate([pc[0], sn[0]], -1))
    served = os.path.join(tmp, "desc_served")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["detect", "--input", clouds, "--out", served, "--dataset",
                  "kitti", "--checkpoint", ckpt, "--descriptor-checkpoint",
                  desc_ckpt, "--device", "cuda"])
    for i in range(2):
        kp = np.fromfile(os.path.join(served, f"c{i}.keypoints.bin"),
                         np.float32).reshape(-1, 3)
        d = np.fromfile(os.path.join(served, f"c{i}.desc.bin"),
                        np.float32).reshape(-1, 128)
        check(kp.shape == (128, 3) and d.shape == (128, 128)
              and np.isfinite(d).all(),
              f"detect --descriptor-checkpoint c{i}: 128 keypoints, 128 "
              "descriptors")
    print(f"[9] detect --descriptor-checkpoint --device cuda: 2 clouds, 128 "
          f"keypoints and descriptors each ({time.perf_counter() - t0:.1f} "
          "s)", flush=True)

    # the descriptor quality gate: it exits nonzero below the factor (the
    # command fails the script, its result line in the message)
    out, t_gate = run_module("descriptor quality gate", [
        "usip_tpu_torch.quality", "--descriptor", "--root",
        os.path.join(tmp, "desc_quality"), "--device", "cuda", "--factor",
        str(DESC_QUALITY_FACTOR)])
    res = json.loads(out.strip().splitlines()[-1])
    g = DESCRIPTOR_GATE
    print(f"[9] {card} | descriptor quality gate (validate_descriptor.py "
          f"--use-cgf --rot 2d --test-yaw: modelnet, {g['train_size']} "
          f"shapes of {g['points']} points, {g['nodes']} nodes, "
          f"{g['det_epochs']} detector + {g['desc_epochs']} descriptor "
          f"epochs, deterministic) in "
          f"{t_gate:.1f} s: yaw-matching accuracy trained {res['trained']}, "
          f"untrained {res['untrained']}, random {res['random']}, ratio "
          f"{res['ratio']} (required >= {DESC_QUALITY_FACTOR}); phases (s) "
          f"{json.dumps(res['seconds'])}", flush=True)
    check(res["passed"] and res["ratio"] >= DESC_QUALITY_FACTOR,
          "trained/untrained yaw-matching accuracy >= 2")
    return launches


def main():
    walls = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        sync()
        walls[name] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()

    card = phase0()
    phase1()
    lap("0-1 card, build")
    errs = phase2(get_config("kitti"))
    lap("2 kernels against plain")
    phase3()
    lap("3 fp32 forwards")
    tmp = tempfile.mkdtemp(prefix="usip_chip_smoke_")
    try:
        pipes, launches = phase4(tmp)
        lap("4 serve")
        times, library, bounds, knn_ms, events, k2, desc_ball = phase5(
            pipes, card)
        del pipes
        lap("5 timing")
        launches["train"], step_rate = phase6(card)
        lap("6 train step")
        launches["engine"], root, ckpt = phase7(card, tmp, step_rate)
        lap("7 engine")
        launches["export"] = phase8(card, tmp, root, ckpt)
        lap("8 export, quality gate")
        launches["descriptor"], desc_rate = phase9_step(card)
        lap("9 descriptor step")
        launches.update(phase9_engine(card, tmp, root, ckpt, desc_rate))
        lap("9 descriptor entry points, quality gate")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[t] wall time by phase (s): {json.dumps(walls)}", flush=True)
    check("jax" not in sys.modules and "flax" not in sys.modules,
          "no jax or flax imported")
    ref = [m for m in sys.modules
           if m == "usip_tpu" or m.startswith("usip_tpu.")]
    check(not ref, f"nothing of the JAX package usip_tpu imported: {ref}")
    meta = {
        "fps": ("usip_tpu_torch/csrc/fps.cu",
                "usip_tpu/ops/pallas_kernels.py:244"),
        "min_argmin": ("usip_tpu_torch/csrc/min_argmin.cu",
                       "usip_tpu/ops/pallas_kernels.py:56"),
        "fusion_chain": ("usip_tpu_torch/csrc/fusion_chain.cu",
                         "usip_tpu/ops/pallas_kernels.py:146"),
        "smallest_k": ("usip_tpu_torch/csrc/smallest_k.cu",
                       "usip_tpu/ops/pallas_kernels.py:327"),
        "scatter_max": ("usip_tpu_torch/csrc/scatter_max.cu",
                        "scripts/bench_scatter_pallas.py:69"),
    }
    # launches: the sum over the main paths' runs (each counted from 0);
    # launches_per_detect: per serving path, over its 3 detects;
    # launches_per_train_step: over the train path's steps; the engine's
    # epoch and the export run, as counted; the same for the descriptor's
    # step, engine epoch and export (keypoints and descriptors)
    line = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": sum(counts[name] for counts in launches.values()),
             "max_abs_err": errs[name], "ms": times[name][0],
             "plain_ms": times[name][1], "events_ms": events[name],
             "bound_ms": bounds[name][0],
             "bound_by": bounds[name][1],
             "library_ms": library.get(name),
             "launches_per_detect": {tag: launches[tag][name] / 3
                                     for tag in ("som", "ball", "knn")},
             "launches_per_train_step": launches["train"][name] / TRAIN_STEPS,
             "launches_engine_epoch": launches["engine"][name],
             "launches_export": launches["export"][name],
             "launches_per_descriptor_step": (launches["descriptor"][name]
                                              / DESC_STEPS),
             "launches_descriptor_engine_epoch":
                 launches["descriptor_engine"][name],
             "launches_descriptor_export":
                 launches["descriptor_export"][name]}
            for name, (src, rep) in meta.items()]
    # K2 at each of its four shapes (the entry's own time is the serve one)
    line[1]["shapes"] = k2
    # K4's second main-path shape, the node kNN's (8, 512, 512) k=16
    line[3]["node_knn"] = {"ms": knn_ms[0], "plain_ms": knn_ms[1],
                           "library_ms": knn_ms[2], "events_ms": knn_ms[3],
                           "bound_ms": KNN_BOUND[0],
                           "bound_by": KNN_BOUND[1]}
    # and its third, the descriptor's ball query (8, 256, 16384) k=64
    line[3]["descriptor_ball"] = desc_ball
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
