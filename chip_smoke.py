"""On-card smoke run of the PyTorch/CUDA port (usip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line or more each, in order; any failed check raises and the
script exits nonzero without the final ``ok`` line:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   refuses to run without CUDA;
1. builds the CUDA kernels from ``usip_tpu_torch/csrc`` (the five ported
   kernels and train-mode BatchNorm) into a clean build directory, one nvcc
   each, and the host data-path library (``csrc/host/usip_native.cpp``,
   g++), side by side;
2. holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (FPS, min/argmin, smallest-k and scatter-max
   exactly, the fused chain within a stated tolerance): FPS on LiDAR-like
   clouds, an urban-like subset and duplicated points, min/argmin at the
   serve and train assignments and the train step's keypoint -> cloud and
   keypoint chamfer in both modes, smallest-k also on the descriptor's
   ball scores (8, 256, 16384) k=64 over random fp32 priorities and over
   the bf16 mode's rounded priorities and distances (ties), scatter-max on
   uniform ids and on the SOM trunk's own assignment ids; and the indoor
   shapes on room frames: smallest-k at the ball selection (8, 512, 5000)
   k=448 (balls past 448 points and short of it) and the lite node kNN
   (16, 512, 512) k=32 and 4, the chain at the lite widths (K=4 and 32,
   Cin 67), scatter-max at C=32 and 64, FPS and min/argmin at the indoor
   sizes;
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
   ``usip_tpu_torch.train.make_detector_train_step`` on its eager route
   (``eager_detector``; the engine's step replays it) on seeded synthetic
   parent clouds with the launch counts reset before and read after (the
   train path must launch FPS, min/argmin, smallest-k and scatter-max),
   every loss and gradient norm finite, train-mode BatchNorm's kernels 7
   launches a layer a step; one fp32 step (batch 2) on the
   card against the same step on the CPU (loss within 1e-4, gradient norm
   within 1e-3, relative; each parameter's gradient within ``GRAD_TOL``);
   then the step time, train clouds/s and the step's split into its spans
   (``usip.step.inputs``, ``.forward``, ``.losses``, ``.backward``,
   ``.optimizer``; CUDA events around each), the replayed step's time and
   launches (the engine's route); then train-mode BatchNorm's kernels at
   the detector and descriptor steps' shapes against their plain stages,
   timed (CUDA-graph replay) beside their byte bound, the plain layer
   (PyTorch's passes, the CPU's path) and ``F.batch_norm`` (a yardstick the
   port never calls);
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
   ``make_descriptor_train_step`` on its eager route (``eager_descriptor``)
   with the launch counts reset before and read after (FPS, min/argmin,
   smallest-k and scatter-max must launch),
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
   run unless trained/untrained yaw-matching accuracy >= 2;
10. the indoor pipeline at the scenenn preset's full width (5000-point
   clouds, 512 keypoints, balls of 448 in radius 0.75, the lite detector,
   the global-context descriptor, the CGF objective) on synthetic trees
   (``python -m usip_tpu_torch.indoor gen``, cut to 16 SceneNN frames and
   one scene of 16 fragments): each kernel timed at the indoor shapes; the
   fp32 forward (B=2) and one fp32 CGF step on the card against the CPU
   (phase 9's tolerances); five bf16 steps at batch 8 with the launch
   counts, the step's time, split and peak memory; five lite detector steps
   (the detector role); ``train-detector --dataset scenenn --lite`` 2
   epochs, ``train-descriptor --dataset scenenn`` 2 epochs and ``--resume
   auto`` to 3, one ``DescriptorEngine`` epoch (clouds/s, idle share);
   ``python -m usip_tpu_torch.indoor eval`` in process (both arms; all five
   kernels must launch in the fragment export), ``eval-indoor --estimator
   fgr``; a rotated-ModelNet tree through ``export-keypoints --subset
   original|rotated`` and ``eval-repeatability``;
11. the grouped-trunk detectors in training at the Oxford preset's full
   width (the released Oxford ball model's trunk and its knn twin: batch 8
   parents of 20480 points, two 16384-point copies, 512 nodes, balls of 64
   in 2 m or 64 nearest neighbours, bf16 trunk) and SOM with k=2 nodes a
   point at the KITTI preset's: smallest-k at the steps' own shapes (the
   ball scores and knn distances (16, 512, 16384) k=64, the node kNN (16,
   512, 512) k=16, the SOM k=2 assignment (16, 16384, 512) k=2) identical
   to its plain version and timed beside its bound and ``torch.topk``;
   five ball and five knn steps with each kernel's launches a step checked
   (K1 2, K2 4, K3 0, K4 2, K5 0, BatchNorm 84), their time, split, peak
   memory and
   operators; one fp32 ball step (batch 2) card against CPU under
   ``GRAD_TOL`` (from the CPU's prepared clouds; each device's own prep
   printed beside it); usip_tpu's learning check (the fixed-draw eval loss
   of a fresh ball detector falls over 80 steps on one batch; a failure
   fails the script after phase 15, which still runs); three SOM
   k=2 steps with their launches (K1 2, K2 4, K4 2, K5 2, BatchNorm 70)
   and the fp32 SOM
   k=2 forward card against CPU; then on a synthetic Oxford tree
   (``tests/oxford_tree.py``: 24 train and 9 test scans of 20480 points)
   ``train-detector --dataset oxford --override detector.grouping=ball``
   2 epochs and ``--resume auto`` to 3, one ``DetectorEngine`` epoch
   (launches, clouds/s, idle share), ``export-keypoints`` with the trained
   checkpoint (K1, K3, K4 must launch), random keypoints and the ISS
   baseline, ``eval-repeatability --oxford-root --coord-fix oxford`` on
   each, and the quality gate with the ball trunk (its ratio reported, not
   held);
12. ranks (``usip_tpu_torch.parallel``): the kernels at the ranks' shapes
   against their plain versions (FPS (4, 2048) -> 512, min/argmin (16,
   8192) x 512, scatter-max (16, 8192), the chain at (4, 512, 16, 131);
   smallest-k at the sharded gathers' (8, 512, 8192) k=64, timed beside
   its bound and ``torch.topk``); then 2 gloo ranks sharing the card
   (NCCL refuses two ranks on one device), spawned by the script: the
   data-parallel KITTI detector and descriptor steps at full width,
   global batch 8 (3 fp32 steps each against the one-rank step from the
   same state and draws, under deterministic algorithms: metrics,
   gradients under ``GRAD_TOL``, running statistics within 2e-5,
   replicas bit-identical; the descriptor's frozen detector run cloud by
   cloud in both, and both steps held under ``GRAD_TOL`` against a
   float64 arbiter, with conv5's ball-max slots that differ between them
   printed; then 5 bf16 steps with each rank's launches, step time,
   clouds/s, peak memory), the data-parallel export byte-identical to one
   rank at the per-rank batch, the point-sharded chamfer, single-side
   chamfer, knn and ball gathers (indices equal to one rank's), detector
   forward, 2 train steps and ``sharded_describe`` against one rank, and
   tensor parallelism's forward and 2 train steps against one rank (then
   both timed); NCCL
   at world size 1 through torchrun's environment (over 2 cards where
   the host has them, else ``nccl_2card: not run``); ``train-detector
   --num-devices 2 --dist-backend gloo`` 2 epochs and ``--resume auto``
   (rank 0 alone writes), ``export-keypoints --num-devices 2``
   byte-identical to ``--num-devices 1`` at the per-rank batch,
   ``train-descriptor --num-devices 2`` one epoch, on phase 7's tree cut
   to 2 scans a train sequence; the detect -> describe pipeline over 4
   microbatches on two streams against the sequential path, both
   throughputs;
13. deployment (``usip_tpu_torch.model_artifact``, the kernels as
   ``usip::`` custom ops in ``torch.export`` programs): artifacts exported
   for the card from seeded weights at full width (the KITTI SOM detector,
   the Oxford ball detector, the KITTI pipeline in the descriptor role),
   their export seconds and file sizes; each called in fp32 at batch 2 with
   the in-process port's draws, launch counts reset before the call (SOM
   and the pipeline launch all five kernels, ball K1, K3 and K4), its
   outputs and every ``usip::`` op's outputs held equal to the in-process
   port's (indices identical; a float that differs is counted and held
   within 1e-5 of max|x|); ``python -m usip_tpu_torch.cli run-model
   --device cuda`` on 3 clouds at batch 2 (a ragged tail), its ``.bin``
   files byte-equal to ``run_detector_artifact`` in process with the same
   seed, and the pipeline artifact's paired rows; the bf16 SOM and pipeline
   artifacts (batch 8) timed with the bench protocol beside the in-process
   detect;
14. the last modules: each kernel at the object presets' shapes (FPS (8,
   1250) -> 512, min/argmin (16, 5000) x 512 and the losses' (8, 512) x
   5000 and x 512, the chain (8, 512, 32, 131) -> 512, the node kNN (16
   and 8, 512, 512) k=32, scatter-max (16, 5000) on assignment ids at C=64
   and 128) against its plain version and timed beside its bound and
   library call; the modelnet preset's train step at full width (batch 8
   pairs of 5000-point shapes, 512 nodes, c1 128, c2 512, k=32, bf16,
   rot_3d): five steps with each kernel's launches a step checked (K1 2,
   K2 5, K3 0, K4 1, K5 2, BatchNorm 70), one fp32 step (batch 2) card
   against CPU under
   deterministic algorithms (phase 6's tolerances), the step's time,
   split, peak memory and busy share; ``train-detector --dataset shrec
   --synthetic --epochs 1`` and ``--dataset modelnet`` in process with
   their launches; ``python -m usip_tpu_torch.fullscale eval`` and
   ``eval-reg --yaw`` in process on phase 7's tree, detector and phase 9's
   descriptor, each arm's launches (model arms all five kernels, random
   keypoints none); ``SOMTrainer`` on the card against the CPU on 8 object
   shapes (nodes within ``SOM_TOL``); ``export-keypoints --with-sigmas``
   (all five kernels), then ``render-keypoints --kp-dim 4`` and ``detect
   --render --html`` on two clouds, or, on a host without matplotlib, both
   raising its ImportError and the line ``[14] render: not run,
   matplotlib absent on this host``;
15. the host data path (``usip_tpu_torch.native``, the default batch
   loader of the engines): the host library loaded from ``build/`` (a
   missing library fails the run) and a fresh g++ build of it timed; one
   ``batch_load_subsample`` at KITTI's parent size (8 x 20480 points of 8
   columns, phase 7's tree) byte-identical at one thread and one a core,
   its fp16 wire ``astype(float16)`` of its fp32 output, every output row a
   row of its file (each once: the scans are 20480 rows); then one
   ``DetectorEngine`` epoch on phase 7's tree on the native path and one on
   the numpy path (``native.available`` off), each with its clouds/s, idle
   share (phase 7's method), launches a step (K1 2, K2 5, K3 0, K4 1, K5 2,
   BatchNorm 70)
   and how many batches ``get_batch`` served (all on the native epoch, none
   on the numpy one).

The second-to-last line is a JSON object with one entry per kernel (time,
plain and library times, bound, launches); the last is ``{"ok": true,
"device": {...}}``. The script imports nothing of JAX or of ``usip_tpu`` and
checks that at its end.
"""

import contextlib
import copy
import functools
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
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# the synthetic Oxford tree (tests/oxford_tree.py) is written by test code
sys.path.insert(1, os.path.join(REPO, "tests"))

from usip_tpu_torch import _build  # noqa: E402
from usip_tpu_torch import cli, fullscale, native, quality  # noqa: E402
from usip_tpu_torch.bench import bench_rate  # noqa: E402
from usip_tpu_torch.config import get_config  # noqa: E402
from usip_tpu_torch.inference import KeypointPipeline  # noqa: E402
from usip_tpu_torch.models import Descriptor, Detector  # noqa: E402
from usip_tpu_torch.models.detector import knn_group  # noqa: E402
from usip_tpu_torch.models.fused_infer import detector_infer_fused  # noqa: E402
from usip_tpu_torch.nn.layers import BatchNorm, batch_norm_plain  # noqa: E402
from usip_tpu_torch.ops import (assign_points_to_nodes, kernels,  # noqa: E402
                                pairwise_sqdist, sample_nodes)
from usip_tpu_torch.ops.grouping import (ball_query, ball_scores,  # noqa: E402
                                         ball_select)
from usip_tpu_torch.quality import DESCRIPTOR_GATE  # noqa: E402
from usip_tpu_torch import indoor as indoor_protocol  # noqa: E402
from usip_tpu_torch.data.descriptor_loaders import (  # noqa: E402
    KittiDescriptorDataset, SceneNNDescriptorDataset)
from usip_tpu_torch.data.preprocess import build_modelnet_rotated  # noqa: E402
from usip_tpu_torch.data.loaders import make_detector_dataset  # noqa: E402
from usip_tpu_torch.data.pipeline import BatchLoader  # noqa: E402
from usip_tpu_torch.train import (DetectorBatch,  # noqa: E402
                                  PackedPairBatch, ParentBatch, TrainState,
                                  make_descriptor_train_step,
                                  make_detector_train_step, pack_pair_batch)
from usip_tpu_torch.train.descriptor_loop import DescriptorEngine  # noqa: E402
from usip_tpu_torch.train import steps as train_steps  # noqa: E402
from usip_tpu_torch.train.checkpoint import (find_checkpoint,  # noqa: E402
                                             save_checkpoint)
from usip_tpu_torch.train.loop import (DetectorEngine,  # noqa: E402
                                       init_detector_state)
from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree  # noqa: E402
from usip_tpu_torch.utils.logging import recording, span  # noqa: E402
from usip_tpu_torch.weights import (seeded_descriptor_state_dict,  # noqa: E402
                                    seeded_state_dict)
from oxford_tree import build_oxford_tree  # noqa: E402

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
             # the KITTI descriptor step's frozen detector (256 nodes)
             "descriptor step (16, 16384) x 256 bf16": (16, 16384, 256, True),
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
    "train": ("fps", "min_argmin", "scatter_max", "smallest_k",
             "batch_norm"),
    "engine": ("fps", "min_argmin", "scatter_max", "smallest_k",
              "batch_norm"),
    "export": ("fps", "min_argmin", "scatter_max", "fusion_chain",
               "smallest_k"),
    "descriptor": ("fps", "min_argmin", "scatter_max", "smallest_k",
                  "batch_norm"),
    "descriptor_engine": ("fps", "min_argmin", "scatter_max", "smallest_k",
                         "batch_norm"),
    "descriptor_export": ("fps", "min_argmin", "scatter_max", "fusion_chain",
                          "smallest_k"),
    "indoor_detector": ("fps", "min_argmin", "scatter_max", "smallest_k",
                       "batch_norm"),
    "indoor_descriptor": ("fps", "min_argmin", "scatter_max", "smallest_k",
                         "batch_norm"),
    "indoor_engine": ("fps", "min_argmin", "scatter_max", "smallest_k",
                     "batch_norm"),
    "fragment_export": ("fps", "min_argmin", "scatter_max", "fusion_chain",
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
    pc = np.concatenate([ground, poles], 1)
    pc = np.stack([c[rng.permutation(n)] for c in pc])
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
    print(f"[1] built {', '.join(_build.KERNELS)} and the host library "
          f"{_build.host_library_path().name} into {_build.BUILD_DIR} in "
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
    # the indoor path's shapes (phase 10)
    for name, err in indoor_kernel_checks(rng, dev).items():
        errs[name] = max(errs[name], err)
    return errs


def k2_inputs(rng, b, n, m, dev):
    """K2's queries and candidates at ``(b, n) x m``: where the queries are
    LiDAR-like clouds (n > m), m nodes drawn from them; where they are
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


def compare_slice(label, cfg, cloud_fn, rng, tag="[3]"):
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
                print(f"{tag} {label}: balls holding more than {k} points "
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
    print(f"{tag} {label} fp32 (2, {n}) -> {cfg.data.node_num}: nodes "
          f"identical{', group indices identical' if grouped else ''}, "
          f"anchors max |diff| {anc_err}", flush=True)
    check(anc_err <= 1e-4, f"{label}: anchors within 1e-4")
    for name, g, c in (("keypoints", gpu[2], cpu[2]),
                       ("sigmas", gpu[3], cpu[3])):
        check(bool(torch.isfinite(g).all()), f"{label}: {name} finite")
        scale = float(c.abs().max())
        err = (g - c).abs()
        print(f"{tag} {label} {name}: max|ref| {scale}, max |diff| "
              f"{float(err.max())}, median |diff| {float(err.median())}",
              flush=True)
        check(float(err.max()) <= 2e-2 * scale, f"{label}: {name} max "
              "within 2e-2")
        check(float(err.median()) <= 2e-3 * scale, f"{label}: {name} median "
              "within 2e-3")
    # the offsets depend on the trunk: keypoints are not just the anchors
    off = float((cpu[2] - cpu[1]).abs().max())
    check(off > 1e-2, f"{label}: keypoint offsets nontrivial")
    print(f"{tag} {label}: max |keypoint - anchor| {off}", flush=True)


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
    CLI (SOM and ball), then ``KeypointPipeline.detect`` once (the capture
    of the forward's graph) and x3 in process (its replays) with the launch
    counts reset just before the 3 and read just after; each path must have
    launched its kernels, the 3 replays' counts 3 times the graph's."""
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
        # a first call captures the forward's graph after its eager warm-up
        # runs; the 3 counted calls are replays, counted as one forward each
        data = np.load(clouds[0])
        pipe.detect(data[:, :3], data[:, 3:], num_keypoints=128)
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
        (graph,) = pipe._graphs.values()
        check(pipe.graph_counts == {"captures": 1, "replays": 3, "eager": 0}
              and launches[tag] == {k: 3 * n for k, n in
                                    graph.launches.items()},
              f"{tag}: 3 replays of one graph, counted as 3 forwards: "
              f"{pipe.graph_counts}, graph {graph.launches}")
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


# the spans of the eager train steps' parts (``train/steps.py``), in
# order; a step on its eager route on the card (``eager_detector``,
# ``eager_descriptor``) opens ``usip.step.inputs`` twice: around the
# route's own draws, then the step's
DETECTOR_STEP_SPANS = tuple("usip.step." + p for p in (
    "inputs", "forward", "losses", "backward", "optimizer"))
DESCRIPTOR_STEP_SPANS = tuple("usip.step." + p for p in (
    "inputs", "detector", "group", "describe", "losses", "backward",
    "optimizer"))
EAGER_ROUTE_SPANS = ("usip.step.inputs",)


def eager_detector(step, cfg):
    """The one-rank detector train ``step`` on its eager route (on a CUDA
    batch the step otherwise replays its CUDA graph), called as the step
    is: the inputs prepared from ``draws`` completed from ``generator`` as
    the step prepares them, in a ``usip.step.inputs`` span, and handed in
    as ``_inputs``."""
    def run(state, batch, epoch, *, draws=None, generator=None):
        with span("usip.step.inputs", state.step):
            inputs = train_steps._prepare_detector_inputs(
                batch, cfg, True, draws, generator)
        return step(state, batch, epoch, _inputs=inputs)
    return run


def eager_descriptor(step, cfg):
    """The scan-triplet descriptor train ``step`` on its eager route,
    called as the step is: the draws ``descriptor_draws`` makes from
    ``generator``, made in a ``usip.step.inputs`` span and handed in."""
    def run(state, detector, batch, epoch, *, generator):
        b, _, n, _ = batch.x.shape
        with span("usip.step.inputs", state.step):
            draws = train_steps.descriptor_draws(cfg, b, n, generator)
        return step(state, detector, batch, epoch, draws=draws)
    return run


def event_split(run, names, iters):
    """The mean device time (ms) of each part of a step, by its span's
    name, over ``iters`` steps: ``run()`` runs one step, whose parts are
    the spans ``names`` (a name that comes twice adds up its times); under
    ``recording()`` each span records a CUDA event at its start and at its
    end (timing only)."""
    with recording() as rec:
        for _ in range(iters):
            run()
    ms = rec.device_ms()
    check(rec.names() == list(names) * iters,
          f"one span a part of the step, in order ({names})")
    return {n: float(np.sum(ms[n])) / iters for n in dict.fromkeys(names)}


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


def grad_errors(tag, grads):
    """Per parameter, card against CPU: max|card - CPU| over its max|CPU
    gradient|, that max floored at GRAD_TOL[0] of the largest gradient (a
    gradient below it is rounding noise: a conv bias ahead of a train-mode
    BatchNorm, whose gradient is 0, or one whose shift BatchNorm all but
    removes), and the cosine where the gradient is above the floor.
    Returns the worst error, the lowest cosine (each with its parameter)
    and ``{name: (max|g| / largest, error, cosine)}``."""
    check(set(grads["cuda"]) == set(grads["cpu"]), f"{tag}: the same "
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
    return worst, low, leaf


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
    step = eager_detector(make_detector_train_step(cfg), cfg)
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
    check(launches["batch_norm"] == bn_launches(state.model) * TRAIN_STEPS,
          "train-mode BatchNorm's kernels: 7 launches a layer a step")

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
            res[device] = eager_detector(
                make_detector_train_step(cfg32), cfg32)(
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
    worst, low, leaf = grad_errors("fp32 train step", grads)
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
    # its split: CUDA events around the spans of the step's parts
    split = event_split(
        lambda: step(state, batch, 0, generator=gen),
        EAGER_ROUTE_SPANS + DETECTOR_STEP_SPANS, iters)
    step_rate = 2 * b * 1e3 / step_ms
    print(f"[6] {card} | train step kitti bf16 batch {b}: {step_ms:.3f} ms "
          f"a step (mean of {iters}, pipelined), {2 * b * 1e3 / step_ms:.2f} "
          f"clouds/s ({b * 1e3 / step_ms:.2f} parent samples/s); split (ms, "
          f"CUDA events around the parts): "
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
    replayed_ms(card, "[6]", f"train step kitti bf16 batch {b}",
                make_detector_train_step(cfg),
                lambda run: run(state, batch, 0, generator=gen), 2 * b)
    return launches, step_rate


def bn_launches(model):
    """Train-mode BatchNorm's launches a step of ``model``: 7 a layer
    (statistics 2, finalise 1, apply 1; backward sums 2, dx 1)."""
    return 7 * sum(isinstance(m, BatchNorm) for m in model.modules())


def replayed_ms(card, tag, what, step, run, clouds, iters=10):
    """A train ``step`` on its replayed route (a CUDA graph a key after its
    first call, as the engines run it; ``run(step)`` calls it once): the
    time a step (host clock over pipelined steps, one synchronize), clouds/s
    and the launches a step, printed."""
    run(step)
    sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        run(step)
    sync()
    ms = (time.perf_counter() - t0) / iters * 1e3
    check(step.graph_counts["replays"] >= iters, f"{what}: replayed")
    print(f"{tag} {card} | {what}, replayed (CUDA graph): {ms:.3f} ms a "
          f"step (mean of {iters}, pipelined), {clouds * 1e3 / ms:.2f} "
          "clouds/s; launches a step "
          + json.dumps({k: v / iters for k, v in kernels.LAUNCHES.items()}),
          flush=True)
    return ms


# train-mode BatchNorm's shapes on the train steps' main paths: (rows, C,
# dtype, calls a step). The KITTI detector step (16 clouds of 16384
# points; 512 nodes of 16 neighbours; the head over 16 x 512 nodes in fp32)
# and the KITTI descriptor step (256 balls of 64 in each of 8 clouds, the
# anchors' and then the positives')
BN_SHAPES = {
    "detector first_pointnet (262144, 64) bf16":
        (262144, 64, torch.bfloat16, 2),
    "detector second_pointnet (262144, 128) bf16":
        (262144, 128, torch.bfloat16, 1),
    "detector fusion before (131072, 256) bf16":
        (131072, 256, torch.bfloat16, 3),
    "detector fusion after (131072, 512) bf16":
        (131072, 512, torch.bfloat16, 2),
    "detector head mlp1 (8192, 512) fp32": (8192, 512, torch.float32, 1),
    "detector head mlp2 (8192, 256) fp32": (8192, 256, torch.float32, 1),
    "descriptor conv1 (131072, 32) bf16": (131072, 32, torch.bfloat16, 2),
    "descriptor conv2 (131072, 64) bf16": (131072, 64, torch.bfloat16, 2),
    "descriptor conv3, conv4 (131072, 128) bf16":
        (131072, 128, torch.bfloat16, 4),
}
# bytes an element of each stage, in element sizes: statistics (read x),
# finalise (vectors only), apply (read x, write y), backward sums (read dy
# and x), dx (read dy and x, write dx)
BN_STAGE_PASSES = {"stats": 1, "finalise": 0, "apply": 2,
                   "backward_reduce": 2, "backward_apply": 3}


def batch_norm_kernels(card):
    """Train-mode BatchNorm's kernels at ``BN_SHAPES`` (ReLU fused, as the
    layers run them): against their plain stages on the card (the apply bit
    for bit from the same mean and 1/std; the sums and statistics, the
    finalise's mean, 1/std and running statistics from the same totals
    within 1e-5 of their largest; the batch count exactly; dx within one
    rounding of its dtype), then each
    stage's CUDA-graph time, the layer's forward and backward beside their
    byte bound (``BN_STAGE_PASSES`` at 3.35 TB/s), the plain layer
    (autograd of ``batch_norm_plain``, PyTorch's passes) and
    ``F.batch_norm`` with its backward (a yardstick the port never calls);
    each step's sum over its layers."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    out, steps = {}, {}
    for label, (rows, c, dtype, calls) in BN_SHAPES.items():
        x = (2 * torch.randn((rows, c), generator=gen, device=dev)
             + 0.5).to(dtype)
        dy = torch.randn((rows, c), generator=gen, device=dev).to(dtype)
        bn = BatchNorm(c).to(dev).train()
        with torch.no_grad():
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.1, generator=gen)
        w, b = bn.weight.detach(), bn.bias.detach()
        rm, rv = bn.running_mean.clone(), bn.running_var.clone()
        nb = bn.num_batches_tracked.clone()
        ref_run = (rm.clone(), rv.clone(), nb.clone())
        totals = kernels.batch_norm_stats(x)
        mean, rstd = kernels.batch_norm_finalise(totals, rm, rv, nb, 0.1,
                                                 1e-5)
        ref_mean, ref_rstd = kernels.batch_norm_finalise_plain(
            totals, *ref_run, 0.1, 1e-5)
        count = totals[-1:]
        y = kernels.batch_norm_apply(x, mean, rstd, w, b, True)
        sg, sgx = kernels.batch_norm_backward_reduce(dy, x, mean, rstd, w, b,
                                                     True)
        dx = kernels.batch_norm_backward_apply(dy, x, mean, rstd, w, b, sg,
                                               sgx, count, True)
        sync()
        ref_totals = kernels.batch_norm_stats_plain(x)
        ref_sg, ref_sgx = kernels.batch_norm_backward_reduce_plain(
            dy, x, mean, rstd, w, b, True)
        ref_dx = kernels.batch_norm_backward_apply_plain(
            dy, x, mean, rstd, w, b, sg, sgx, count, True)

        def gap(got, ref):
            return float((got.float() - ref.float()).abs().max()) / max(
                float(ref.float().abs().max()), 1e-30)

        errs = {"totals": gap(totals, ref_totals), "mean": gap(mean, ref_mean),
                "rstd": gap(rstd, ref_rstd),
                "running_mean": gap(rm, ref_run[0]),
                "running_var": gap(rv, ref_run[1]), "sum_g": gap(sg, ref_sg),
                "sum_gx": gap(sgx, ref_sgx), "dx": gap(dx, ref_dx)}
        check(torch.equal(y, kernels.batch_norm_apply_plain(
            x, mean, rstd, w, b, True)), f"BatchNorm {label}: apply equals "
            "its plain stage")
        check(torch.equal(nb, ref_run[2]) and int(nb) == 1,
              f"BatchNorm {label}: the finalise counts one batch")
        check(max(v for k, v in errs.items() if k != "dx") <= 1e-5
              and errs["dx"] <= (2.0 ** -8 if dtype == torch.bfloat16
                                 else 1e-6),
              f"BatchNorm {label}: stages within tolerance of plain {errs}")

        iters = 20
        stages = {
            "stats": lambda: kernels.batch_norm_stats(x),
            "finalise": lambda: kernels.batch_norm_finalise(
                totals, rm, rv, nb, 0.1, 1e-5),
            "apply": lambda: kernels.batch_norm_apply(x, mean, rstd, w, b,
                                                      True),
            "backward_reduce": lambda: kernels.batch_norm_backward_reduce(
                dy, x, mean, rstd, w, b, True),
            "backward_apply": lambda: kernels.batch_norm_backward_apply(
                dy, x, mean, rstd, w, b, sg, sgx, count, True)}
        stage_ms = {k: graph_ms(fn, iters) for k, fn in stages.items()}
        size = x.element_size()
        stage_bound = {k: BN_STAGE_PASSES[k] * rows * c * size / HBM_BPS
                       * 1e3 for k in stages}
        xg = x.clone().requires_grad_(True)

        def plain():
            torch.relu(batch_norm_plain(bn, xg)).backward(dy)

        def library():
            torch.relu(torch.nn.functional.batch_norm(
                xg, rm, rv, bn.weight, bn.bias, True, 0.1, 1e-5)
            ).backward(dy)

        plain_ms = graph_ms(plain, iters)
        try:
            library_ms = graph_ms(library, iters)
        except RuntimeError as err:  # a dtype mix the library refuses
            library_ms = f"not run: {str(err).splitlines()[0][:120]}"
        ms = sum(stage_ms.values())
        bound_ms = sum(stage_bound.values())
        out[label] = {"calls_a_step": calls, "ms": ms,
                      "stages_ms": stage_ms, "bound_ms": bound_ms,
                      "stages_bound_ms": stage_bound,
                      "roofline_share": bound_ms / ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "max_rel_err": errs}
        step = label.split()[0]
        tot = steps.setdefault(step, {"ms": 0.0, "bound_ms": 0.0,
                                      "plain_ms": 0.0})
        tot["ms"] += calls * ms
        tot["bound_ms"] += calls * bound_ms
        tot["plain_ms"] += calls * plain_ms
        print(f"[6] {card} | BatchNorm {label}, forward + backward "
              f"(CUDA-graph replay, ms): kernels {ms:.4f} (bound "
              f"{bound_ms:.4f}, bytes; share {bound_ms / ms:.3f}), plain "
              f"{plain_ms:.4f}, F.batch_norm {library_ms}; stages "
              + json.dumps({k: round(v, 4) for k, v in stage_ms.items()})
              + f"; gaps to plain {json.dumps(errs)}", flush=True)
        del x, dy, xg, y, dx
    print(json.dumps({"batch_norm": out, "batch_norm_steps": steps}),
          flush=True)
    return out


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


def run_cli(tag, args):
    """``run_module``'s ``python -m <args>`` in this process (the module's
    ``main``: ``usip_tpu_torch.cli`` or ``usip_tpu_torch.quality``), without
    a process's start-up, CUDA context and kernel load (~10 s each): its
    stdout (the command fails the script if it exits) and its wall time.
    ``run_module`` stays for the first run of each command, ``bench``, the
    multi-rank runs (their ranks print to their own stdout), the service,
    the artifact runner and the deterministic descriptor gate (its cuBLAS
    workspace is set before the process's first matmul)."""
    mains = {"usip_tpu_torch.cli": cli.main,
             "usip_tpu_torch.quality": quality.main}
    check(args[0] in mains, f"{tag}: {args[0]} runs in process")
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            mains[args[0]](args[1:])
    except SystemExit as e:
        check(False, f"{tag} exited: {e} {buf.getvalue()[-2000:]}")
    sync()
    return buf.getvalue(), time.perf_counter() - t0


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
    out, t_resume = run_cli("train-detector --resume auto",
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
          f"{t_first:.1f} s (a process, its start-up included), --resume "
          f"auto to epoch 3 in {t_resume:.1f} s (in process); [epoch, train "
          f"loss, sigma_mean] "
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

    # a process of its own, as a user runs it: the rate of a fresh process
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

    out, t_gate = run_cli("quality", [
        "usip_tpu_torch.quality", "--root", os.path.join(tmp, "quality"),
        "--device", "cuda", "--factor", str(QUALITY_FACTOR)])
    res = json.loads(out.strip().splitlines()[-1])
    print(f"[8] {card} | quality gate in process (phase_smoke sizes: input "
          f"2048, parent 2560, M 64, c1 32, c2 128, batch 4, 4096-point "
          f"scans, 16 epochs) in {t_gate:.1f} s: trained repeatability "
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


class PerCloud:
    """A frozen detector run one cloud at a time: a cloud's keypoints are
    then the same bits whatever batch it comes in (a rank's half or the
    whole), so the data-parallel descriptor check compares the
    descriptor's part alone (a keypoint moved by a reduction order can
    move a point across a ball's boundary, as ``KeypointsFrom`` notes)."""

    def __init__(self, det):
        self.det = det

    def eval(self):
        self.det.eval()
        return self

    def __call__(self, pc, sn, node):
        outs = [self.det(pc[i:i + 1], sn[i:i + 1], node[i:i + 1])
                for i in range(pc.shape[0])]
        return tuple(torch.cat(parts) for parts in zip(*outs))


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
    step = eager_descriptor(make_descriptor_train_step(cfg), cfg)
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
    # the step describes the anchors' balls, then the positives'
    check(launches["batch_norm"] == 2 * bn_launches(state.model)
          * DESC_STEPS, "train-mode BatchNorm's kernels: 7 launches a "
          "descriptor layer a describe, two describes a step")

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
    worst, low, leaf = grad_errors("fp32 descriptor step", grads)
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
    # its split (CUDA events around the spans of its parts) and the
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
        lambda: step(state, det, batch, 0, generator=gen),
        EAGER_ROUTE_SPANS + DESCRIPTOR_STEP_SPANS, iters)
    busy, ops, _ = profile_busy(lambda: step(state, det, batch, 0,
                                             generator=gen), 2)
    rate = 2 * b * 1e3 / step_ms
    print(f"[9] {card} | train step descriptor kitti bf16 batch {b}: "
          f"{step_ms:.3f} ms a step (mean of {iters}, pipelined), "
          f"{rate:.2f} clouds/s ({b * 1e3 / step_ms:.2f} pairs/s); split "
          "(ms, CUDA events around the parts): "
          + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f"; peak memory {peak:.0f} MiB; torch.profiler over 2 steps: "
          f"kernels {busy:.3f} ms a step on the device ({busy / step_ms:.4f}"
          " of the unprofiled step); by operator [name, ms a step, calls a "
          "step]: " + json.dumps([[k, round(t, 4), c] for t, c, k in ops[:15]]),
          flush=True)
    replayed_ms(card, "[9]", f"train step descriptor kitti bf16 batch {b}",
                make_descriptor_train_step(cfg),
                lambda run: run(state, det, batch, 0, generator=gen), 2 * b)
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
    out, t_resume = run_cli("train-descriptor --resume auto",
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
          f"tree and detector): 2 epochs in {t_first:.1f} s (a process), "
          f"--resume auto to epoch 3 in {t_resume:.1f} s (in process); "
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


# ------------------------------------------------------- indoor, phase 10 --

# the scenenn descriptor preset with an fp32 trunk and an fp32 frozen lite
# detector, for the card-against-CPU checks (its balls are fp32 already)
INDOOR_FP32 = {"detector.compute_dtype": "float32",
               "descriptor.compute_dtype": "float32"}
# train steps in each counted indoor run
INDOOR_STEPS = 5
# phase 10's synthetic indoor trees, in the layout of ``python -m
# usip_tpu_torch.indoor gen`` cut in depth (the script's defaults: 48 train
# frames, 2 scenes of 16 fragments): 16 SceneNN train frames of 15000
# points (2 detector steps of batch 8 an epoch), 8 test frames, 1 scene of
# 16 fragments of 20000 points (a ring of 16 views, so that non-adjacent
# pairs overlap and enter the recall)
INDOOR_SCENES, INDOOR_FRAGMENTS = 1, 16
INDOOR_GEN = ["--frames", "16", "--scenes", str(INDOOR_SCENES),
              "--fragments", str(INDOOR_FRAGMENTS)]


@functools.lru_cache(maxsize=None)
def _room(seed):
    from usip_tpu_torch.data import synthetic
    pts, _, _, (w, d, _) = synthetic._make_room(np.random.default_rng(seed))
    return pts, w, d


def room_frame(seed, n):
    """One synthetic SceneNN-style frame of ``n`` points: a view cone of
    one of 8 rooms of ``data/synthetic.py``, from a seeded viewpoint, in
    its camera frame."""
    from usip_tpu_torch.data import synthetic
    pts, w, d = _room(seed % 8)
    rng = np.random.default_rng(seed)
    cam = np.array([w / 2, d / 2, 1.4]) + rng.uniform(-0.5, 0.5, 3) * [
        1.0, 1.0, 0.2]
    yaw = rng.uniform(0, 2 * np.pi)
    pose = synthetic._camera_pose(
        cam, cam + 3.0 * np.array([np.cos(yaw), np.sin(yaw), -0.15]))
    mask = synthetic._view_points(pts, cam, pose[:3, 2], 6.0,
                                  np.cos(np.deg2rad(60.0)))
    (p,) = synthetic._fixed_count(rng, [pts[mask]], n)
    return ((p - cam) @ pose[:3, :3]).astype(np.float32)


def room_ball_scores(rng, b, dev):
    """The indoor ball selection's scores (b, 512, 5000): room frames, 512
    keypoints a frame (points moved by N(0, 0.05^2)), fp32 uniform
    priorities, radius 0.75."""
    pc = torch.from_numpy(np.stack([room_frame(100 + i, 5000)
                                    for i in range(b)])).to(dev)
    sel = torch.from_numpy(np.stack([rng.choice(5000, 512, replace=False)
                                     for _ in range(b)])).to(dev)
    kp = torch.gather(pc, 1, sel[..., None].expand(-1, -1, 3)) + \
        torch.from_numpy(rng.normal(0, 0.05, (b, 512, 3)).astype(
            np.float32)).to(dev)
    prio = torch.from_numpy(rng.uniform(size=(b, 5000)).astype(
        np.float32)).to(dev)
    return pc, ball_scores(pc, kp.contiguous(), 0.75, prio)


def chain_bound(b, m, k, cin, c, c2):
    """K3's bound at (b, m, k, cin) -> (b, m, c2): its bf16 products over
    the tensor cores' rate, or the input read, the output written and the
    weights read once over the memory rate."""
    rows = b * m * k
    flops = 2 * rows * (cin * c + 2 * c * c + c * c2 + c2 * c2) \
        + 2 * b * m * c * c2
    nbytes = rows * cin * 4 + b * m * c2 * 4 + 2 * (
        cin * c + 2 * c * c + 2 * c * c2 + c2 * c2)
    return bound(nbytes, flops, BF16_FLOPS)


# the indoor path's kernel shapes: label -> (kernel, its arguments). A
# lite detector step launches FPS on (8, 2560) twice, min/argmin on (16,
# 10240) x 512 once, the node kNN (16, 512, 512) k=32 once, scatter-max on
# (16, 10240) at C=32 and 64; a descriptor step FPS on (8, 1250) twice,
# min/argmin on (16, 5000) x 512, the node kNN at k=4, the ball selection
# twice, scatter-max at (16, 5000); the fragment export (batch 4) each
# once a batch and the chain at K=4 (K=32: a lite detector's own export)
INDOOR_SHAPES = {
    "fps (8, 2560) -> 512": ("fps", (8, 2560, 512)),
    "fps (8, 1250) -> 512": ("fps", (8, 1250, 512)),
    "min_argmin (16, 10240) x 512 bf16": ("min_argmin", (16, 10240, 512)),
    "min_argmin (16, 5000) x 512 bf16": ("min_argmin", (16, 5000, 512)),
    "fusion_chain (8, 512, 4, 67) -> 256": ("fusion_chain", 4),
    "fusion_chain (8, 512, 32, 67) -> 256": ("fusion_chain", 32),
    "smallest_k ball (8, 512, 5000) k=448": ("smallest_k", (5000, 448)),
    "smallest_k node kNN (16, 512, 512) k=32": ("smallest_k", (512, 32)),
    "smallest_k node kNN (16, 512, 512) k=4": ("smallest_k", (512, 4)),
    "scatter_max (16, 10240) C=32+64": ("scatter_max", 10240),
    "scatter_max (16, 5000) C=32+64": ("scatter_max", 5000),
}


def lite_chain(dev):
    """The folded, packed fusion chain of the seeded lite detector (scenenn
    descriptor role: c1 64, c2 256)."""
    det = seeded_detector(get_config("scenenn", role="descriptor"), dev)
    ws, bs = kernels.fusion_chain_params(det.knnlayer_1)
    return ws, bs, kernels.prepare_chain(ws, bs)


def indoor_kernel_checks(rng, dev):
    """Phase 2 at the indoor shapes: K4 at the ball selection (8, 512,
    5000) k=448 on room balls (some past k points, some fewer) and at the
    lite detector's node kNN (16, 512, 512) k=32 and 4, K3 at the lite
    widths, K5 at C=32 and 64, K1 and K2 at the indoor sizes. Returns the
    worst error of each kernel."""
    errs = {}
    _, scores = room_ball_scores(rng, B_BENCH, dev)
    inside = torch.isfinite(scores).sum(-1)
    nodes = torch.from_numpy(np.stack([room_frame(200 + i, 5000)[
        rng.choice(5000, 512, replace=False)] for i in range(16)])).to(dev)
    worst = 0.0
    nd = pairwise_sqdist(nodes, nodes)
    for name, (sc, k) in {"indoor ball scores r=0.75": (scores, 448),
                          "lite node knn distances": (nd, 32),
                          "descriptor-role node knn distances": (
                              nd, 4)}.items():
        vals, idx = kernels.smallest_k(sc, k)
        rvals, ridx = kernels.smallest_k_plain(sc, k)
        sync()
        mism = int((idx != ridx).sum())
        fin = torch.isfinite(rvals)
        print(f"[2] K4 smallest_k {name}: {tuple(sc.shape)} k={k}, {mism} "
              f"indices differ, {float((~fin).float().mean()):.4f} of picks "
              "+inf" + (f"; balls holding more than k points "
                        f"{float((inside > k).float().mean()):.4f}, fewer "
                        f"{float((inside < k).float().mean()):.4f}, in-ball "
                        f"counts {int(inside.min())}-{int(inside.max())}"
                        if k == 448 else ""), flush=True)
        check(torch.equal(idx, ridx) and torch.equal(vals, rvals),
              f"smallest_k {name}: values and indices identical")
        if k == 448:
            check(bool((inside > k).any() and (inside < k).any()),
                  "some room balls hold more than 448 points and some fewer")
        worst = max(worst, float((vals[fin] - rvals[fin]).abs().max()))
    errs["smallest_k"] = worst

    ws, bs, chain = lite_chain(dev)
    worst = 0.0
    for k in (4, 32):
        grouped = torch.from_numpy(np.concatenate(
            [rng.normal(0, 0.5, size=(B_BENCH, 512, k, 3)),
             np.abs(rng.normal(size=(B_BENCH, 512, k, 64)))], -1).astype(
                 np.float32)).to(dev)
        got = kernels.fusion_chain(grouped, chain)
        ref = kernels.fusion_chain_plain(grouped, ws, bs)
        sync()
        scale, err = float(ref.abs().max()), (got - ref).abs()
        print(f"[2] K3 fusion_chain lite: (8, 512, {k}, 67) -> (8, 512, "
              f"256), max|plain| {scale}, max |diff| {float(err.max())}, "
              f"median |diff| {float(err.median())}", flush=True)
        check(scale > 0 and float(err.max()) <= 1e-2 * scale
              and float(err.median()) <= 1e-3 * scale,
              f"fusion_chain lite K={k} within 1e-2 (max) and 1e-3 (median) "
              "of max|plain|")
        worst = max(worst, float(err.max()))
    errs["fusion_chain"] = worst

    worst = 0.0
    for n in (10240, 5000):
        ids = torch.from_numpy(rng.integers(0, 500, size=(16, n))).to(dev)
        for c in (32, 64):
            f = torch.from_numpy(rng.normal(size=(16, n, c)).astype(
                np.float32)).to(dev)
            got = kernels.scatter_max(f, ids, 512)
            ref = kernels.scatter_max_plain(f, ids, 512)
            sync()
            check(torch.equal(got, ref), f"scatter_max (16, {n}) C={c} "
                  "equals scatter_reduce amax")
            worst = max(worst, float((got - ref).abs().max()))
    print(f"[2] K5 scatter_max lite: (16, 10240) and (16, 5000), C=32 and "
          f"64 onto 512 nodes (the last 12 empty): identical", flush=True)
    errs["scatter_max"] = worst

    worst = 0.0
    for s_ in (2560, 1250):
        pts = torch.from_numpy(np.stack([room_frame(300 + i, s_)
                                         for i in range(8)])).to(dev)
        first = torch.from_numpy(rng.integers(0, s_, 8).astype(
            np.int32)).to(dev)
        got, ref = kernels.fps(pts, first, 512), kernels.fps_plain(
            pts, first, 512)
        sync()
        check(torch.equal(got, ref), f"fps room frames (8, {s_}) -> 512 "
              "picks identical")
        worst = max(worst, float((got - ref).abs().max()))
    errs["fps"] = worst
    worst = 0.0
    for n in (10240, 5000):
        pc = torch.from_numpy(np.stack([room_frame(400 + i, n)
                                        for i in range(16)])).to(dev)
        cand = pc[:, :512].contiguous()
        for bf16 in (False, True):
            mins, idx = kernels.min_argmin(pc, cand, bf16)
            rmins, ridx = kernels.min_argmin_plain(pc, cand, bf16)
            sync()
            check(torch.equal(idx, ridx) and torch.equal(mins, rmins),
                  f"min_argmin room frames (16, {n}) x 512 round_bf16="
                  f"{bf16} identical")
            worst = max(worst, float((mins - rmins).abs().max()))
    errs["min_argmin"] = worst
    print("[2] K1 fps room frames (8, 2560) and (8, 1250) -> 512, K2 "
          "min_argmin room frames (16, 10240) and (16, 5000) x 512 in both "
          "modes: identical", flush=True)
    return errs


def indoor_kernel_times(card, rng):
    """Each kernel at the indoor path's shapes: CUDA-graph time, the plain
    version's, the library call's (``torch.topk`` for K4,
    ``scatter_reduce('amax')`` for K5), back-to-back events, the bound."""
    dev = torch.device("cuda")
    out = {}
    for label, (name, arg) in INDOOR_SHAPES.items():
        lib = None
        if name == "fps":
            b, s_, k = arg
            pts = torch.from_numpy(np.stack([room_frame(500 + i, s_)
                                             for i in range(b)])).to(dev)
            first = torch.zeros(b, dtype=torch.int32, device=dev)
            run = lambda p=pts, f=first, k=k: kernels.fps(p, f, k)  # noqa: E731
            plain = lambda p=pts, f=first, k=k: kernels.fps_plain(p, f, k)  # noqa: E731
            bnd = bound(b * s_ * 12 + b * 4 + b * k * 4,
                        8 * b * (k - 1) * s_, FP32_FLOPS)
        elif name == "min_argmin":
            b, n, m = arg
            pc = torch.from_numpy(np.stack([room_frame(600 + i, n)
                                            for i in range(b)])).to(dev)
            cand = pc[:, :m].contiguous()
            run = lambda p=pc, c=cand: kernels.min_argmin(p, c, True)  # noqa: E731
            plain = lambda p=pc, c=cand: kernels.min_argmin_plain(  # noqa: E731
                p, c, True)
            bnd = min_argmin_bound(b, n, m)
        elif name == "fusion_chain":
            ws, bs, chain = lite_chain(dev)
            g = torch.from_numpy(np.abs(rng.normal(
                size=(B_BENCH, 512, arg, 67))).astype(np.float32)).to(dev)
            run = lambda g=g, c=chain: kernels.fusion_chain(g, c)  # noqa: E731
            plain = lambda g=g, w=ws, b_=bs: kernels.fusion_chain_plain(  # noqa: E731
                g, w, b_)
            bnd = chain_bound(B_BENCH, 512, arg, 67, 128, 256)
        elif name == "smallest_k":
            n, k = arg
            if n == 5000:
                _, sc = room_ball_scores(rng, B_BENCH, dev)
                rows = B_BENCH * 512
            else:
                nodes = torch.from_numpy(np.stack([room_frame(700 + i, 5000)[
                    :512] for i in range(16)])).to(dev)
                sc = pairwise_sqdist(nodes, nodes)
                rows = 16 * 512
            run = lambda s=sc, k=k: kernels.smallest_k(s, k)  # noqa: E731
            plain = lambda s=sc, k=k: kernels.smallest_k_plain(s, k)  # noqa: E731
            lib = graph_ms(lambda s=sc, k=k: torch.topk(
                s, k, dim=-1, largest=False, sorted=True), 20)
            bnd = bound(rows * n * 4 + rows * k * 8, 0, FP32_FLOPS)
        else:
            n = arg
            ids = torch.from_numpy(rng.integers(0, 512, size=(16, n))).to(dev)
            fs = [torch.from_numpy(rng.normal(size=(16, n, c)).astype(
                np.float32)).to(dev) for c in (32, 64)]
            run = lambda fs=fs, i=ids: [kernels.scatter_max(f, i, 512)  # noqa: E731
                                        for f in fs]
            plain = lambda fs=fs, i=ids: [  # noqa: E731
                kernels.scatter_max_plain(f, i, 512) for f in fs]
            lib = graph_ms(plain, 20)
            bnd = bound(sum(16 * n * c * 4 + 16 * n * 8 + 16 * 512 * c * 4
                            for c in (32, 64)), 0, FP32_FLOPS)
        out[label] = {"ms": graph_ms(run, 20), "plain_ms": time_ms(plain, 3),
                      "library_ms": lib, "events_ms": time_ms(run, 20),
                      "bound_ms": bnd[0], "bound_by": bnd[1]}
        r = out[label]
        print(f"[10] {card} | {label}: kernel {r['ms']:.4f} ms (back-to-back "
              f"events {r['events_ms']:.4f} ms), plain {r['plain_ms']:.4f} "
              f"ms, library {'none' if lib is None else f'{lib:.4f} ms'}, "
              f"bound {bnd[0]:.4f} ms by {bnd[1]}", flush=True)
    return out


def lite_detector(cfg, device):
    """The seeded lite detector, its head at the training init's scale
    (``seeded_detector(head_init=True)``) and the sigma channel's bias at
    -1.5: sigmas near softplus(-1.5) = 0.20, below the indoor descriptor
    loss's sigma_max of 0.5 (above it a keypoint's weight is 0), as a
    trained indoor detector's are."""
    det = seeded_detector(cfg, device, head_init=True)
    with torch.no_grad():
        det.mlp3.conv.bias[3] = -1.5
    return det


def indoor_pairs(root, b, cfg, wire):
    """``b`` anchor/positive pairs of the synthetic SceneNN tree through
    ``SceneNNDescriptorDataset`` (the anchor ICP-aligned onto its
    positive), packed in ``wire``; negatives a shifted permutation."""
    ds = SceneNNDescriptorDataset(cfg.data, "train",
                                  sn_len=cfg.descriptor.surface_normal_len)
    items = [ds[i] for i in range(b)]
    st = {k: np.stack([it[k] for it in items]) for k in items[0]}
    packed = pack_pair_batch(st["anc_pc"], st["anc_sn"], st["pos_pc"],
                             st["pos_sn"], (np.arange(b) + 1) % b, wire=wire)
    return packed


def phase10_numerics(card, root):
    """The scenenn descriptor preset at full width on the card: the fp32
    forward and one fp32 CGF step against the CPU; five bf16 steps at batch
    8 with the launch counts; the step's time, split and peak memory; five
    lite detector steps (the detector role) with their launches and time."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(10)
    over = {"data.dataroot": os.path.join(root, "scenenn")}
    cfg32 = get_config("scenenn", role="descriptor", **over, **INDOOR_FP32)
    k = cfg32.descriptor.ball_nsamples
    # the fp32 forward, B=2: the lite detector on both devices (nodes
    # identical, keypoints within compare_slice's tolerance), then the
    # global-context descriptor on the CPU detector's keypoints on both
    # (the same balls), seeded weights and priorities
    x = torch.from_numpy(indoor_pairs(root, 2, cfg32, "float32").x)
    pc, sn = x[:, 0, :, :3].contiguous(), x[:, 0, :, 3:].contiguous()
    n = pc.shape[1]
    sub = n // cfg32.data.fps_subsample_ratio
    subset = torch.from_numpy(np.stack([rng.permutation(n)[:sub]
                                        for _ in range(2)]))
    first = torch.from_numpy(rng.integers(0, sub, 2).astype(np.int32))
    prio = torch.from_numpy(rng.uniform(size=(2, n)).astype(np.float32))
    outs = {}
    for device in ("cuda", "cpu"):
        det = lite_detector(cfg32, device)
        with torch.inference_mode():
            node = sample_nodes(pc.to(device), cfg32.data.node_num,
                                cfg32.data.fps_subsample_ratio,
                                subset_idx=subset.to(device),
                                first=first.to(device))
            _, kp, sig = det(pc.to(device), sn.to(device), node)
        outs[device] = [t.cpu() for t in (node, kp, sig)]
    check(torch.equal(outs["cuda"][0], outs["cpu"][0]), "indoor nodes "
          "identical on card and CPU")
    kp_err = float((outs["cuda"][1] - outs["cpu"][1]).abs().max())
    kp_cpu = outs["cpu"][1]
    descs = {}
    for device in ("cuda", "cpu"):
        desc = seeded_descriptor(cfg32, device).eval()
        with torch.inference_mode():
            d, feats = desc(pc.to(device), sn.to(device), kp_cpu.to(device),
                            prio.to(device))
        descs[device] = (d.cpu(), feats.cpu())
    (gd, gf), (cd, cf) = descs["cuda"], descs["cpu"]
    inside = (pairwise_sqdist(kp_cpu, pc) <= 0.75 ** 2).sum(-1)
    err = (gd - cd).abs()
    print(f"[10] scenenn descriptor fp32 (2, {n}) x {kp_cpu.shape[1]} "
          f"keypoints, balls of {k} in 0.75 (past {k} points "
          f"{float((inside > k).float().mean()):.4f}, fewer "
          f"{float((inside < k).float().mean()):.4f}): lite detector nodes "
          f"identical, keypoints max |diff| {kp_err}; ball features "
          f"identical: {torch.equal(gf, cf)}; descriptors max |diff| "
          f"{float(err.max())}, median {float(err.median())}", flush=True)
    check(kp_err <= 2e-2 * float(kp_cpu.abs().max()), "indoor keypoints "
          "within 2e-2 of max|keypoint|")
    check(torch.equal(gf, cf), "indoor ball features identical on card and "
          "CPU")
    check(bool(torch.isfinite(gd).all()) and float(err.max()) <= 1e-4
          and float(err.median()) <= 1e-6, "indoor descriptor fp32 forward "
          "on the card within 1e-4 (max) and 1e-6 (median) of the CPU's")

    # one fp32 CGF step, batch 2, on the card and on the CPU from the same
    # weights, pairs and draws, the CPU detector's keypoints on both,
    # deterministic algorithms (phase 9's check and tolerances)
    batch2 = indoor_pairs(root, 2, cfg32, "float32")
    cpu_det = lite_detector(cfg32, "cpu").requires_grad_(False)
    res, grads = {}, {}
    for device in ("cuda", "cpu"):
        st = TrainState.create(seeded_descriptor(cfg32, device),
                               cfg32.train.lr)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            res[device] = make_descriptor_train_step(cfg32, True)(
                st, KeypointsFrom(cpu_det), PackedPairBatch(
                    torch.from_numpy(batch2.x).to(device),
                    torch.from_numpy(batch2.neg_idx).long().to(device)), 0,
                generator=torch.Generator().manual_seed(SEED + 1))
        finally:
            torch.use_deterministic_algorithms(False)
        grads[device] = {nm: p.grad.detach().double().cpu() for nm, p in
                         st.model.named_parameters() if p.grad is not None}
    gpu, cpu = ({kk: float(v) for kk, v in res[d].items()}
                for d in ("cuda", "cpu"))
    rel = {kk: abs(gpu[kk] - cpu[kk]) / max(abs(cpu[kk]), 1e-30)
           for kk in cpu}
    check(cpu["loss"] > 0, "the indoor fp32 step has a loss to compare")
    worst, low, leaf = grad_errors("fp32 indoor step", grads)
    print(f"[10] train descriptor scenenn fp32 batch 2 (CGF), one step on "
          f"the card and on the CPU: card {json.dumps(gpu)}, CPU "
          f"{json.dumps(cpu)}, relative differences {json.dumps(rel)}; "
          f"gradients of {len(leaf)} parameters: worst {worst[0]:.3e} "
          f"({worst[1]}), lowest cosine {low[0]:.9f} ({low[1]}) (tolerance "
          f"{GRAD_TOL[1]:g}, cosine >= {GRAD_TOL[2]})", flush=True)
    for kk, r in rel.items():
        check(r <= (1e-3 if kk == "grad_norm" else 1e-4), f"fp32 indoor "
              f"step {kk} on the card within tolerance of the CPU")
    check(worst[0] <= GRAD_TOL[1] and low[0] >= GRAD_TOL[2], "fp32 indoor "
          "step gradients on the card within tolerance of the CPU, "
          "parameter by parameter")

    # five bf16 steps at batch 8 with the counts; then time, split, memory
    cfg = get_config("scenenn", role="descriptor", **over)
    b = cfg.train.batch_size
    packed = indoor_pairs(root, b, cfg, cfg.data.wire_dtype)
    batch = PackedPairBatch(torch.from_numpy(packed.x).to(dev),
                            torch.from_numpy(packed.neg_idx).long().to(dev))
    det = lite_detector(cfg, dev).requires_grad_(False)
    state = TrainState.create(seeded_descriptor(cfg, dev), cfg.train.lr)
    step = make_descriptor_train_step(cfg, True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    history = [step(state, det, batch, 0, generator=gen)
               for _ in range(INDOOR_STEPS)]
    sync()
    launches = {"indoor_descriptor": dict(kernels.LAUNCHES)}
    peak = torch.cuda.max_memory_allocated() / 2**20
    losses = [float(h["loss"]) for h in history]
    norms = [float(h["grad_norm"]) for h in history]
    print(f"[10] train descriptor scenenn bf16 batch {b} ({b} pairs of "
          f"{cfg.data.input_pc_num} points, {cfg.data.node_num} keypoints, "
          f"balls of {k} in {cfg.descriptor.ball_radius}, CGF), "
          f"{INDOOR_STEPS} steps: losses {losses}, grad norms {norms}, "
          f"match_acc {[round(float(h['match_acc']), 4) for h in history]}; "
          f"launches {launches['indoor_descriptor']}; peak memory "
          f"{peak:.0f} MiB", flush=True)
    check(all(np.isfinite(losses + norms)), "indoor descriptor losses and "
          "gradient norms finite")
    for name in PATH_KERNELS["indoor_descriptor"]:
        check(launches["indoor_descriptor"][name] > 0, f"kernel {name} "
              "launched on the indoor descriptor path")
    iters = 5
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, det, batch, 0, generator=gen)
    sync()
    step_ms = (time.perf_counter() - t0) / iters * 1e3
    split = event_split(
        lambda: step(state, det, batch, 0, generator=gen),
        DESCRIPTOR_STEP_SPANS, iters)
    busy, ops, _ = profile_busy(lambda: step(state, det, batch, 0,
                                             generator=gen), 2)
    desc_rate = 2 * b * 1e3 / step_ms
    print(f"[10] {card} | train step descriptor scenenn bf16 batch {b}: "
          f"{step_ms:.3f} ms a step (mean of {iters}, pipelined), "
          f"{desc_rate:.2f} clouds/s; split (ms, CUDA events around the "
          "parts): " + json.dumps({kk: round(v, 4) for kk, v in split.items()})
          + f"; peak memory {peak:.0f} MiB; torch.profiler over 2 steps: "
          f"kernels {busy:.3f} ms a step ({busy / step_ms:.4f} of the "
          "unprofiled step); by operator [name, ms a step, calls a step]: "
          + json.dumps([[kk, round(t, 4), c] for t, c, kk in ops[:12]]),
          flush=True)
    del state, batch, history
    torch.cuda.empty_cache()

    # the lite detector's train step (the scenenn detector role, --lite):
    # batch 8 parents of 12288 points, two 10240-point copies each
    dcfg = get_config("scenenn", **over)
    dcfg = dcfg.with_overrides(**{"detector.c1": 64, "detector.c2": 256})
    parents = torch.from_numpy(np.stack([room_frame(800 + i, dcfg.data.
                                                    parent_pc_num)
                                         for i in range(b)])).to(dev)
    sn_p = torch.from_numpy(rng.normal(size=parents.shape[:2] + (4,)).astype(
        np.float32)).to(dev)
    pb = ParentBatch(parents, sn_p)
    dstate = TrainState.create(seeded_detector(dcfg, dev, head_init=True),
                               dcfg.train.lr)
    dstep = eager_detector(make_detector_train_step(dcfg), dcfg)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    hist = [dstep(dstate, pb, 0, generator=gen) for _ in range(INDOOR_STEPS)]
    sync()
    launches["indoor_detector"] = dict(kernels.LAUNCHES)
    check(all(np.isfinite([float(h["loss"]) for h in hist])),
          "lite detector losses finite")
    for name in PATH_KERNELS["indoor_detector"]:
        check(launches["indoor_detector"][name] > 0, f"kernel {name} "
              "launched on the lite detector's train path")
    t0 = time.perf_counter()
    for _ in range(iters):
        dstep(dstate, pb, 0, generator=gen)
    sync()
    dstep_ms = (time.perf_counter() - t0) / iters * 1e3
    dpeak = torch.cuda.max_memory_allocated() / 2**20
    dsplit = event_split(
        lambda: dstep(dstate, pb, 0, generator=gen),
        EAGER_ROUTE_SPANS + DETECTOR_STEP_SPANS, iters)
    print(f"[10] {card} | train step lite detector scenenn bf16 batch {b} "
          f"({2 * b} clouds of {dcfg.data.input_pc_num} points, node kNN "
          f"{dcfg.detector.node_knn_k}): {dstep_ms:.3f} ms a step, "
          f"{2 * b * 1e3 / dstep_ms:.2f} clouds/s, peak memory {dpeak:.0f} "
          "MiB; split (ms): "
          + json.dumps({kk: round(v, 4) for kk, v in dsplit.items()})
          + f"; losses {[round(float(h['loss']), 4) for h in hist]}; "
          f"launches {launches['indoor_detector']}", flush=True)
    return launches, desc_rate


def phase10_entry(card, root, desc_rate):
    """The indoor pipeline through its entry points on the synthetic trees:
    train-detector --lite and train-descriptor (and its resume) as
    subprocesses, the protocol's eval in process with the counts of the
    fragment export, eval-indoor --estimator fgr."""
    launches = {}
    ckpt_dir = os.path.join(root, "ckpt")
    sroot = os.path.join(root, "scenenn")
    common = ["--dataroot", sroot, "--name", "indoor", "--checkpoints-dir",
              ckpt_dir, "--device", "cuda", "--override", "train.log_every=5"]
    _, t_det = run_cli("train-detector --lite", [
        "usip_tpu_torch.cli", "train-detector", "--dataset", "scenenn",
        "--lite", "--epochs", "2"] + common)
    det_dir = os.path.join(ckpt_dir, "indoor")
    with open(os.path.join(det_dir, "config.json")) as f:
        saved = json.load(f)
    check((saved["data"]["input_pc_num"], saved["detector"]["c1"],
           saved["detector"]["c2"], saved["detector"]["node_knn_k"])
          == (10240, 64, 256, 32), "train-detector --lite ran the scenenn "
          "detector role at the lite widths")
    drecs = read_jsonl(os.path.join(det_dir, "indoor_metrics.jsonl"))
    check(all(np.isfinite([r["loss"] for r in drecs if "loss" in r])),
          "every lite detector loss finite")
    base = ["usip_tpu_torch.cli", "train-descriptor", "--dataset", "scenenn",
            "--detector-checkpoint", find_checkpoint(det_dir)] + common
    _, t_desc = run_cli("train-descriptor scenenn", base + ["--epochs",
                                                           "2"])
    out_dir = os.path.join(ckpt_dir, "indoor_descriptor")
    first = read_jsonl(os.path.join(out_dir, "indoor_desc_metrics.jsonl"))
    out, t_resume = run_cli("train-descriptor scenenn --resume auto",
                            base + ["--epochs", "3", "--resume", "auto"])
    check("at epoch 2" in out, "the resumed indoor descriptor run starts at "
          "epoch 2")
    recs = read_jsonl(os.path.join(out_dir, "indoor_desc_metrics.jsonl"))
    check({r["epoch"] for r in recs[len(first):]} == {2}, "the resumed "
          "indoor descriptor run trains epoch 2 only")
    check(all(np.isfinite([r["loss"] for r in recs if "loss" in r])),
          "every indoor descriptor loss finite")
    epochs = [(r["epoch"], round(r["loss"], 4), round(r["match_acc"], 4))
              for r in recs if r["prefix"] == "desc_epoch"]
    tests = [(r["epoch"], round(r["loss"], 4), round(r["match_acc"], 4))
             for r in recs if r["prefix"] == "desc_test"]
    # the descriptor engine in process: a warm-up epoch, a timed one with
    # the launch counts, a profiled one (idle share)
    cfg = get_config("scenenn", role="descriptor",
                     **{"data.dataroot": sroot, "train.log_every": 100})
    ds = SceneNNDescriptorDataset(cfg.data, "train",
                                  sn_len=cfg.descriptor.surface_normal_len)
    loader = BatchLoader(ds, cfg.train.batch_size, shuffle=True,
                         num_workers=cfg.data.num_workers)
    engine = DescriptorEngine(cfg, find_checkpoint(det_dir),
                              train_loader=loader, device="cuda",
                              out_dir=os.path.join(root, "desc_engine"))
    engine.train_epoch(0)
    sync()
    steps = len(loader)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    avg = engine.train_epoch(1)
    sync()
    wall = time.perf_counter() - t0
    launches["indoor_engine"] = dict(kernels.LAUNCHES)
    check(all(np.isfinite(list(avg.values()))), "indoor descriptor engine "
          "epoch metrics finite")
    for name in PATH_KERNELS["indoor_engine"]:
        check(launches["indoor_engine"][name] > 0, f"kernel {name} launched "
              "on the indoor descriptor engine path")
    busy, _, pwall = profile_busy(lambda: engine.train_epoch(2), 1)
    print(f"[10] {card} | descriptor engine scenenn bf16 batch "
          f"{cfg.train.batch_size}, one epoch of {steps} steps ({len(ds)} "
          f"pairs) in process: {2 * cfg.train.batch_size * steps / wall:.2f}"
          f" clouds/s ({wall / steps * 1e3:.3f} ms a step); the bare step "
          f"{desc_rate:.2f} clouds/s; device busy {busy:.3f} ms over the "
          f"profiled epoch ({pwall * 1e3:.3f} ms profiled), idle share "
          f"{1.0 - busy / (wall * 1e3):.4f} of the unprofiled epoch's "
          f"{wall * 1e3:.3f} ms; launches {launches['indoor_engine']}",
          flush=True)
    del engine

    print(f"[10] train-detector --dataset scenenn --lite --device cuda (in "
          f"process, as the two below): 2 epochs in {t_det:.1f} s; "
          f"train-descriptor --dataset scenenn: 2 epochs in {t_desc:.1f} s, "
          f"--resume auto to epoch 3 in {t_resume:.1f} s; [epoch, train "
          f"loss, match_acc] {epochs}, [epoch, test loss, match_acc] "
          f"{tests}; the bare descriptor step {desc_rate:.2f} clouds/s",
          flush=True)

    # the protocol's eval in process: both arms' fragment exports counted
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = indoor_protocol.main(["eval", "--root", root, "--device",
                                    "cuda"])
    sync()
    t_eval = time.perf_counter() - t0
    launches["fragment_export"] = dict(kernels.LAUNCHES)
    for name in PATH_KERNELS["fragment_export"]:
        check(launches["fragment_export"][name] > 0, f"kernel {name} "
              "launched on the fragment export path")
    n_frag = INDOOR_SCENES * INDOOR_FRAGMENTS
    for arm in ("trained_desc", "untrained_desc"):
        check(res[arm]["frames"] == n_frag and all(
            0.0 <= res[arm][kk] <= 1.0 for kk in ("mean_recall",
                                                  "mean_precision")),
              f"indoor eval {arm}: {n_frag} fragments, recall and "
              "precision")
    feats = os.path.join(root, "features_trained")
    for scene in res["scenes"]:
        for i in range(INDOOR_FRAGMENTS):
            rows = np.fromfile(os.path.join(feats, scene, f"{i}.bin"),
                               np.float32).reshape(-1, 131)
            check(rows.shape[0] == 512 and np.isfinite(rows).all()
                  and np.allclose(np.linalg.norm(rows[:, 3:], axis=1), 1.0,
                                  atol=1e-3),
                  f"{scene}/{i}.bin: 512 keypoints, 512 unit descriptors")
    arms = {arm: {kk: res[arm][kk] for kk in ("mean_recall",
                                             "mean_precision")}
            for arm in ("trained_desc", "untrained_desc")}
    per = {arm: {s: [res[arm]["per_scene"][s][kk] for kk in (
        "recall", "precision", "good", "gt_num", "rs_num")]
        for s in res["scenes"]} for arm in arms}
    print(f"[10] {card} | python -m usip_tpu_torch.indoor eval --device "
          f"cuda ({len(res['scenes'])} scene(s) of {INDOOR_FRAGMENTS} "
          f"fragments, 512 "
          f"keypoints, RANSAC 1000, both arms) in {t_eval:.1f} s: "
          f"{json.dumps(arms)}; per scene [recall, precision, good, gt, "
          f"proposed] {json.dumps(per)}; launches (two exports of {n_frag} "
          f"fragments, batch 4) {launches['fragment_export']}", flush=True)

    m3d = os.path.join(root, "match3d")
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval-indoor", "--gt-root", os.path.join(m3d, "gt"),
                  "--pc-root", os.path.join(m3d, "fragments"),
                  "--result-root", feats, "--scenes",
                  ",".join(res["scenes"]), "--out",
                  os.path.join(root, "logs_fgr"), "--estimator", "fgr",
                  "--overlapped-only"])
    lines = [json.loads(x) for x in buf.getvalue().strip().splitlines()]
    check(len(lines) == len(res["scenes"]) + 1
          and 0.0 <= lines[-1]["mean_recall"] <= 1.0,
          f"eval-indoor --estimator fgr lines {lines}")
    print(f"[10] eval-indoor --estimator fgr --overlapped-only (trained "
          f"features) in {time.perf_counter() - t0:.1f} s: "
          f"{json.dumps(lines[-1])}", flush=True)
    return launches


def phase10_modelnet(card, tmp):
    """A rotated-ModelNet tree (``build_modelnet_rotated`` over synthetic
    shapes), ``export-keypoints`` of its original and rotated halves at the
    modelnet preset on the card, and ``eval-repeatability``."""
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    cfg = get_config("modelnet")
    shapes = SyntheticDataset(size=8, input_pc_num=cfg.data.input_pc_num,
                              surface_normal_len=3, seed=3)
    src = []
    for i in range(8):
        item = shapes[i]
        path = os.path.join(tmp, f"shape{i}.npy")
        np.save(path, np.concatenate([item["src_pc"], item["src_sn"]], 1))
        src.append(path)
    root = os.path.join(tmp, "modelnet_rotated")
    check(build_modelnet_rotated(src, root, seed=0) == 8, "8 rotated shapes")
    det = os.path.join(tmp, "modelnet_det.pt")
    save_checkpoint(det, init_detector_state(cfg, 0))
    for sub in ("original", "rotated"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["export-keypoints", "--dataset", "modelnet",
                      "--dataroot", root, "--checkpoint", det, "--out",
                      os.path.join(tmp, f"kp_{sub}"), "--subset", sub,
                      "--device", "cuda"])
        stats = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(stats["frames"] == 8, f"export-keypoints --subset {sub}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["eval-repeatability", "--anc-dir",
                  os.path.join(tmp, "kp_original"), "--pos-dir",
                  os.path.join(tmp, "kp_rotated"), "--gt-dir",
                  os.path.join(root, "rotated")])
    rep = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rep["pairs"] == 8 and 0.0 <= rep["repeatability"] <= 1.0,
          f"rotated modelnet repeatability {rep}")
    print(f"[10] {card} | rotated ModelNet (8 synthetic shapes of "
          f"{cfg.data.input_pc_num} points, a seeded modelnet detector): "
          f"export-keypoints --subset original and rotated, "
          f"eval-repeatability {json.dumps(rep)}", flush=True)


def phase10(card, tmp):
    """The indoor pipeline at the scenenn preset's full width."""
    root = os.path.join(tmp, "indoor")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        indoor_protocol.main(["gen", "--root", root] + INDOOR_GEN)
    print(f"[10] python -m usip_tpu_torch.indoor gen {' '.join(INDOOR_GEN)}"
          f": {time.perf_counter() - t0:.1f} s", flush=True)
    times = indoor_kernel_times(card, np.random.default_rng(11))
    launches, desc_rate = phase10_numerics(card, root)
    launches.update(phase10_entry(card, root, desc_rate))
    phase10_modelnet(card, tmp)
    return launches, times


# --------------------------------------------------------------- phase 11 --
# the Oxford grouped detectors in training: steps a counted run, and the
# kernels each step launches (K1 the two node samplings, K2 the losses'
# keypoint -> cloud and chamfer, K4 the ball or knn grouping and the node
# kNN over both copies at once; the fusion runs layered in training and the
# grouped trunk does not scatter)
OX_STEPS = 5
OX_STEP_LAUNCHES = {"fps": 2, "min_argmin": 4, "fusion_chain": 0,
                    "smallest_k": 2, "scatter_max": 0,
                    "batch_norm": 7 * 12}
# the SOM trunk with k=2 nodes a point at the KITTI preset's width: the
# assignment selects on K4 (k > 1), both scatter-maxes run over 2N points
SOM_K = 2
SOM_K_STEPS = 3
SOM_K_LAUNCHES = {"fps": 2, "min_argmin": 4, "fusion_chain": 0,
                  "smallest_k": 2, "scatter_max": 2, "batch_norm": 7 * 10}
# the learning check: train steps on one fixed batch from a fresh init. At
# the Oxford preset's full width the fixed-draw eval loss (running
# BatchNorm statistics) first rises while the statistics catch up with the
# moving weights, then falls: on an H100 1.695 -> 1.855 at 20 steps, 1.491
# at 80, while the same draws' train-mode loss falls from the start (1.868,
# 1.760, 1.529)
LEARN_STEPS = 80
# checks that failed without stopping the phases after them (the learning
# check), raised at the end of ``main``
DEFERRED = []
# the synthetic Oxford tree of phase 11 (tests/oxford_tree.py): full-size
# 20480-point scans, 24 to train (3 steps of batch 8 an epoch), 9 test scans
# (8 ground-truth pairs: one test batch)
OX_TREE = {"train_scans": 24, "test_scans": 9, "points": 20480, "seed": 0}
# the grouped trunk as the released Oxford model and its knn twin
OX_GROUPED = ("ball", "knn")


def oxford_parents(rng, b, p, device):
    """Urban-like parents (``oxford_cloud``) in the camera frame the Oxford
    loaders give (ENU turned as ``coordinate_enu_to_cam`` turns it: the up
    axis is y, which the step's height scale stretches)."""
    pc, sn = oxford_cloud(rng, b, p)

    def cam(x):
        return np.stack([x[..., 0], -x[..., 2], x[..., 1]], -1)

    sn = np.concatenate([cam(sn[..., :3]), sn[..., 3:]], -1)
    return ParentBatch(*(torch.from_numpy(np.ascontiguousarray(
        x, np.float32)).to(device) for x in (cam(pc), sn)))


def k4_case(card, label, scores, k):
    """K4 against its plain version on ``scores`` (identical values and
    indices) and its times: the kernel (CUDA-graph replay), the plain
    version, ``torch.topk`` (the library call) and the bound (the scores
    read once, k values and indices written a row)."""
    vals, idx = kernels.smallest_k(scores, k)
    rvals, ridx = kernels.smallest_k_plain(scores, k)
    sync()
    mism = int((idx != ridx).sum())
    inside = torch.isfinite(scores).sum(-1)
    check(torch.equal(idx, ridx) and torch.equal(vals, rvals),
          f"smallest_k {label}: values and indices identical")
    rows, n = scores.numel() // scores.shape[-1], scores.shape[-1]
    bnd = bound(rows * n * 4 + rows * k * 8, 0, FP32_FLOPS)
    res = {"ms": graph_ms(lambda: kernels.smallest_k(scores, k), 10),
           "plain_ms": time_ms(lambda: kernels.smallest_k_plain(scores, k),
                               3),
           "library_ms": graph_ms(lambda: torch.topk(scores, k,
                                                     largest=False), 10),
           "bound_ms": bnd[0], "bound_by": bnd[1]}
    print(f"[11] {card} | K4 smallest_k {label}: {tuple(scores.shape)} "
          f"k={k}, {mism} indices differ, rows with more than k finite "
          f"{float((inside > k).float().mean()):.4f}, fewer "
          f"{float((inside < k).float().mean()):.4f}; "
          + json.dumps(res), flush=True)
    return res


def k5_som_k2_case(card, ids, gen):
    """K5 against its plain version at the SOM k=2 step's own shape: the
    stacked ids ``(16, 2 x 16384)`` (each point twice, k-major) onto 512
    nodes, fp32 features of C=64 and 128 (both masked scatter-maxes of one
    forward); identical, empty nodes 0. Times both calls: the kernel
    (CUDA-graph replay), the plain version, ``scatter_reduce('amax')`` (the
    plain version is that library call) and the bound (features and ids
    read once, the node features written)."""
    b, kn = ids.shape
    m = 512
    counts = torch.zeros((b, m), dtype=torch.int64, device=ids.device)
    counts.scatter_add_(1, ids, torch.ones_like(ids))
    empty = counts == 0
    fs = [torch.randn((b, kn, c), generator=gen, device=ids.device)
          for c in (64, 128)]
    for f in fs:
        got = kernels.scatter_max(f, ids, m)
        ref = kernels.scatter_max_plain(f, ids, m)
        sync()
        check(torch.equal(got, ref), f"scatter_max SOM k={SOM_K} stacked "
              f"ids ({b}, {kn}) C={f.shape[-1]} equals scatter_reduce amax")
        check(bool((got[empty] == 0).all()), f"scatter_max SOM k={SOM_K} "
              "stacked ids: empty nodes are 0")
    run = lambda: [kernels.scatter_max(f, ids, m) for f in fs]  # noqa: E731
    plain = lambda: [kernels.scatter_max_plain(f, ids, m)  # noqa: E731
                     for f in fs]
    bnd = bound(sum(b * kn * c * 4 + b * kn * 8 + b * m * c * 4
                    for c in (64, 128)), 0, FP32_FLOPS)
    res = {"ms": graph_ms(run, 10), "plain_ms": time_ms(plain, 3),
           "library_ms": graph_ms(plain, 10), "bound_ms": bnd[0],
           "bound_by": bnd[1]}
    print(f"[11] {card} | K5 scatter_max SOM k={SOM_K} stacked ids "
          f"({b}, {kn}) onto {m} nodes, C=64+128 (form "
          f"{kernels.scatter_max_form(kn, m)}): identical, "
          f"{int(empty.sum())} empty nodes, at most {int(counts.max())} "
          "stacked points on a node; " + json.dumps(res), flush=True)
    return res


def oxford_kernel_checks(card, rng):
    """K4 at the new shapes of this phase, from the steps' own inputs: the
    natural-order ball scores r=2 and the knn distances of both siamese
    copies of 8 Oxford parents (16, 512, 16384) k=64, the node kNN (16,
    512, 512) k=16, and the SOM k=2 assignment's bf16 distances (16, 16384,
    512) k=2 of 8 KITTI parents; K5 on that assignment's stacked ids (16,
    32768). Returns K4's and K5's results."""
    dev = torch.device("cuda")
    cfg = oxford_config("ball")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    with torch.no_grad():
        src, dst, _ = train_steps._prepare_detector_inputs(
            oxford_parents(rng, 8, cfg.data.parent_pc_num, dev), cfg, True,
            generator=gen)
        pc, node = torch.cat([src[0], dst[0]]), torch.cat([src[2], dst[2]])
        shapes = {"oxford_ball": ("Oxford ball scores r=2, natural order",
                                  ball_scores(pc, node, 2.0), 64)}
        shapes["oxford_knn"] = ("Oxford knn distances",
                                pairwise_sqdist(node, pc), 64)
        shapes["oxford_node_knn"] = ("Oxford node kNN distances",
                                     pairwise_sqdist(node, node), 16)
        kcfg = get_config("kitti", **{"detector.k": SOM_K})
        ksrc, kdst, _ = train_steps._prepare_detector_inputs(
            parent_batch(rng, kcfg, 8, dev), kcfg, True, generator=gen)
        kpc, knode = (torch.cat([ksrc[0], kdst[0]]),
                      torch.cat([ksrc[2], kdst[2]]))
        shapes["som_k2_assignment"] = (
            "SOM k=2 assignment bf16 distances",
            pairwise_sqdist(kpc, knode, round_bf16=True), SOM_K)
        ids = assign_points_to_nodes(kpc, knode, k=SOM_K,
                                     round_bf16=True).ids
    out = {}
    for key, (label, scores, k) in shapes.items():
        out[key] = k4_case(card, label, scores, k)
    del shapes
    k5 = k5_som_k2_case(card, ids, gen)
    return out, k5


def ox_step_run(cfg, tag, batch, state, steps, expected):
    """``steps`` train steps with the launch counts reset before and read
    after, each count checked against ``expected`` a step; every metric
    finite. Returns the launches (the eager route)."""
    step = eager_detector(make_detector_train_step(cfg), cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step(state, batch, 0, generator=gen)  # warm-up, not counted
    sync()
    kernels.reset_launch_counts()
    history = [step(state, batch, 0, generator=gen) for _ in range(steps)]
    sync()
    launches = dict(kernels.LAUNCHES)
    losses = [float(h["loss"]) for h in history]
    print(f"[11] train {tag} bf16 batch {cfg.train.batch_size}, {steps} "
          f"steps: losses {losses}, grad norms "
          f"{[float(h['grad_norm']) for h in history]}; launches {launches}",
          flush=True)
    check(all(all(bool(torch.isfinite(v)) for v in h.values())
              for h in history), f"{tag}: every train metric finite")
    for name, n in expected.items():
        check(launches[name] == n * steps, f"{tag}: kernel {name} launched "
              f"{n} times a step ({launches[name]} in {steps} steps)")
    return launches


def ox_step_time(card, cfg, tag, batch, state):
    """The step's time (pipelined), clouds/s, its split by its spans, its
    peak memory and the profiler's operators (the eager route)."""
    step = eager_detector(make_detector_train_step(cfg), cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    b = cfg.train.batch_size
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
    split = event_split(
        lambda: step(state, batch, 0, generator=gen),
        EAGER_ROUTE_SPANS + DETECTOR_STEP_SPANS, iters)
    busy, ops, _ = profile_busy(lambda: step(state, batch, 0,
                                             generator=gen), 2)
    print(f"[11] {card} | train step {tag} bf16 batch {b}: {step_ms:.3f} ms "
          f"a step (mean of {iters}, pipelined), {2 * b * 1e3 / step_ms:.2f} "
          f"clouds/s; split (ms, CUDA events around the parts): "
          + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f"; peak memory {peak:.0f} MiB; torch.profiler over 2 steps: "
          f"kernels {busy:.3f} ms a step ({busy / step_ms:.4f} of the "
          "step); by operator [name, ms a step, calls a step]: "
          + json.dumps([[k, round(t, 4), c] for t, c, k in ops[:12]]),
          flush=True)
    return 2 * b * 1e3 / step_ms


def ox_fp32_step(card, rng):
    """One fp32 ball step (batch 2, full width) on the card and on the CPU
    from the same weights and parents. Each device's own data prep (the
    draws from one CPU generator; the rotations' products round apart by an
    ulp or so) is compared with the CPU's, and the step from it is printed,
    not held: a point that the ulp moves across a ball's 2 m boundary
    changes which 64 points are the ball's first. Held: the step from the
    CPU's prepared clouds on both devices, the card under deterministic
    algorithms, metrics within 1e-4 (grad_norm 1e-3) and every parameter's
    gradient within ``GRAD_TOL``."""
    cfg32 = oxford_config("ball", **{"detector.compute_dtype": "float32"})
    batch2 = oxford_parents(rng, 2, cfg32.data.parent_pc_num, "cpu")
    r, k = cfg32.detector.group_radius, cfg32.detector.group_k

    def prep(device):
        with torch.no_grad():
            return train_steps._prepare_detector_inputs(
                ParentBatch(*(t.to(device) for t in batch2)), cfg32, True,
                generator=torch.Generator().manual_seed(SEED + 1))

    def run(device, inputs):
        st = train_state(cfg32, device)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            m = make_detector_train_step(cfg32)(st, None, 0,
                                                _inputs=inputs)
        finally:
            torch.use_deterministic_algorithms(False)
        return ({k: float(v) for k, v in m.items()},
                {n: p.grad.detach().double().cpu() for n, p in
                 st.model.named_parameters() if p.grad is not None})

    def to(inputs, device):
        src, dst, gt = inputs
        mv = lambda t: t.to(device)  # noqa: E731
        return (tuple(map(mv, src)), tuple(map(mv, dst)),
                type(gt)(*map(mv, gt)))

    cpu_in, card_in = prep("cpu"), prep("cuda")
    diffs, flips = [], 0
    for side in range(2):
        for a, b in zip(card_in[side], cpu_in[side]):
            diffs.append(float((a.cpu() - b).abs().max())
                         / float(b.abs().max()))
        flips += int((ball_query(card_in[side][0], card_in[side][2], r, k)
                      .idx.cpu() != ball_query(cpu_in[side][0],
                                               cpu_in[side][2], r, k).idx)
                     .any(-1).sum())
    cpu_res, cpu_grads = run("cpu", cpu_in)
    own_res, own_grads = run("cuda", card_in)
    rel = lambda a: {k: abs(a[k] - cpu_res[k]) / max(abs(cpu_res[k]),  # noqa: E731
                                                    1e-30) for k in cpu_res}
    own = grad_errors("own prep", {"cuda": own_grads, "cpu": cpu_grads})
    print(f"[11] {card} | train oxford ball fp32 batch 2, each device's own "
          f"data prep (printed, not held): the card's prepared clouds, "
          f"normals and nodes within {max(diffs):.3e} of max|x| of the "
          f"CPU's, {flips} of {2 * 2 * cfg32.data.node_num} balls hold "
          f"other points; the step's relative metric differences "
          f"{json.dumps(rel(own_res))}, gradients worst {own[0][0]:.3e} "
          f"({own[0][1]}), lowest cosine {own[1][0]:.9f}", flush=True)
    check(max(diffs) <= 1e-6, "the card's data prep within 1e-6 of max|x| "
          "of the CPU's")
    res, grads = run("cuda", to(cpu_in, "cuda"))
    diff = rel(res)
    worst, low, leaf = grad_errors("fp32 ball step",
                                   {"cuda": grads, "cpu": cpu_grads})
    print(f"[11] {card} | train oxford ball fp32 batch 2, one step from the "
          f"CPU's prepared clouds, card against CPU: relative metric "
          f"differences {json.dumps(diff)} (tolerance: 1e-4, grad_norm "
          f"1e-3); gradients of {len(leaf)} parameters: worst "
          f"{worst[0]:.3e} ({worst[1]}), lowest cosine {low[0]:.9f} "
          f"({low[1]}) (tolerance {GRAD_TOL[1]:g}, cosine >= {GRAD_TOL[2]}); "
          "by parameter [name, max|g| / largest, error, cosine]: "
          + json.dumps([[n, round(a, 8), round(e, 8),
                         None if c is None else round(c, 10)]
                        for n, (a, e, c) in leaf.items()]), flush=True)
    for key, v in diff.items():
        check(v <= (1e-3 if key == "grad_norm" else 1e-4),
              f"fp32 ball step {key} on the card within tolerance of the "
              "CPU")
    check(worst[0] <= GRAD_TOL[1] and low[0] >= GRAD_TOL[2], "fp32 ball "
          "step gradients on the card within tolerance of the CPU")


def ox_learns(card, rng):
    """usip_tpu's learning check at full width: the ball detector from a
    fresh init, one fixed batch; the mean eval loss over four fixed draws
    falls over ``LEARN_STEPS`` train steps. Printed beside it at 0, 20 and
    ``LEARN_STEPS`` steps: the same draws' loss in train mode (batch
    statistics, on a copy of the model). Under deterministic algorithms:
    the backward's atomic accumulations otherwise sum in a run-dependent
    order, and the bf16 run's eval loss after 80 steps moved from run to
    run (1.53851 and 1.69716 against 1.69502 at the start, on an H100
    80GB HBM3 at 700 W); deterministic, it is 1.67469 on every run
    there, and 1.69923 with train-mode BatchNorm's kernels. One trajectory
    is chance: over 21 batches the plain layer with its batch statistics
    taken in float64 moves the loss after 80 steps by as much as the
    kernels do (gaps to the plain layer up to 0.46 and 0.36, IQR 0.22 and
    0.23, each side of zero about as often), so a failure is kept in
    ``DEFERRED`` and fails the script after the last phase, which still
    runs."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _ox_learns(card, rng)
    except RuntimeError as err:
        print(f"[11] {card} | {err}; the script fails at its end", flush=True)
        DEFERRED.append(str(err).removeprefix("check failed: "))
    finally:
        torch.use_deterministic_algorithms(False)


def _ox_learns(card, rng):
    cfg = oxford_config("ball")
    dev = torch.device("cuda")
    state = init_detector_state(cfg, SEED, dev)
    batch = oxford_parents(rng, cfg.train.batch_size,
                           cfg.data.parent_pc_num, dev)
    step = eager_detector(make_detector_train_step(cfg), cfg)
    evaluate = train_steps.make_detector_eval_step(cfg)

    def draw(j):
        return torch.Generator(device=dev).manual_seed(100 + j)

    def fixed_losses():
        evals = [float(evaluate(state, batch, generator=draw(j))["loss"])
                 for j in range(4)]
        model, trains = copy.deepcopy(state.model), []
        with torch.no_grad():
            for j in range(4):
                src, dst, gt = train_steps._prepare_detector_inputs(
                    batch, cfg, True, generator=draw(j))
                out = train_steps._siamese_apply(model, src, dst, True,
                                                 cfg.train.bn_momentum)
                trains.append(float(train_steps._detector_losses(
                    cfg, *out, src[0], src[1], dst[0], dst[1], gt)[0]))
        return float(np.mean(evals)), float(np.mean(trains))

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    curve, losses = [(0, fixed_losses())], []
    for n in (20, LEARN_STEPS):
        while len(losses) < n:
            losses.append(float(step(state, batch, 0, generator=gen)["loss"]))
        curve.append((n, fixed_losses()))
    (_, (before, _)), (_, (after, _)) = curve[0], curve[-1]
    print(f"[11] {card} | learning check, oxford ball bf16 batch "
          f"{cfg.train.batch_size} from a "
          f"fresh init: fixed-draw eval loss {before:.5f} -> {after:.5f} "
          f"over {LEARN_STEPS} steps; [steps, eval-mode, train-mode "
          f"fixed-draw loss] "
          + json.dumps([[n, round(e, 5), round(t, 5)] for n, (e, t)
                        in curve]), flush=True)
    check(np.isfinite(losses).all() and after < before, "the ball detector's "
          "fixed-draw eval loss falls with training")


def phase11_steps(card):
    """The Oxford ball and knn steps at full width, the fp32 ball step card
    against CPU, the learning check, SOM with k=2 nodes a point."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    launches, rates = {}, {}
    for grouping in OX_GROUPED:
        cfg = oxford_config(grouping)
        batch = oxford_parents(rng, cfg.train.batch_size,
                               cfg.data.parent_pc_num, dev)
        state = train_state(cfg, dev)
        tag = f"oxford {grouping}"
        launches[f"oxford_{grouping}"] = ox_step_run(
            cfg, tag, batch, state, OX_STEPS, OX_STEP_LAUNCHES)
        rates[grouping] = ox_step_time(card, cfg, tag, batch, state)
        del state, batch
    ox_fp32_step(card, rng)
    ox_learns(card, rng)

    kcfg = get_config("kitti", **{"detector.k": SOM_K})
    batch = parent_batch(rng, kcfg, kcfg.train.batch_size, dev)
    state = train_state(kcfg, dev)
    launches["som_k2"] = ox_step_run(kcfg, f"kitti som k={SOM_K}", batch,
                                     state, SOM_K_STEPS, SOM_K_LAUNCHES)
    rates["som_k2"] = ox_step_time(card, kcfg, f"kitti som k={SOM_K}", batch,
                                   state)
    del state, batch
    compare_slice(f"KITTI SOM k={SOM_K}", get_config("kitti", **{
        "detector.k": SOM_K, "detector.compute_dtype": "float32"}),
        kitti_cloud, rng, tag="[11]")
    return launches, rates


def phase11_entry(card, tmp, rates):
    """The Oxford entry points on a synthetic Oxford tree: train-detector
    (ball) 2 epochs and --resume auto, one engine epoch, the model, random
    and ISS exports, eval-repeatability, the grouped quality gate."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "oxford_tree")
    counts = build_oxford_tree(root, **OX_TREE)
    print(f"[11] synthetic Oxford tree {counts} of {OX_TREE['points']} "
          f"points in {time.perf_counter() - t0:.1f} s", flush=True)
    ckpt_dir = os.path.join(tmp, "ckpt_oxford")
    out_dir = os.path.join(ckpt_dir, "oxford")
    base = ["usip_tpu_torch.cli", "train-detector", "--dataset", "oxford",
            "--dataroot", root, "--name", "oxford", "--checkpoints-dir",
            ckpt_dir, "--device", "cuda", "--override",
            "detector.grouping=ball", "--override", "train.log_every=1"]
    _, t_first = run_cli("train-detector oxford", base + ["--epochs", "2"])
    with open(os.path.join(out_dir, "config.json")) as f:
        saved = json.load(f)
    check((saved["data"]["input_pc_num"], saved["data"]["parent_pc_num"],
           saved["data"]["node_num"], saved["data"]["wire_dtype"],
           saved["detector"]["grouping"], saved["detector"]["group_k"],
           saved["detector"]["group_radius"], saved["detector"]["c1"],
           saved["detector"]["c2"], saved["augment"]["height_scale"],
           saved["loss"]["keypoint_on_pc_alpha"])
          == (16384, 20480, 512, "float32", "ball", 64, 2.0, 128, 512, True,
              1.0), "train-detector ran the Oxford preset's ball detector "
          "at full width")
    first = read_jsonl(os.path.join(out_dir, "oxford_metrics.jsonl"))
    out, t_resume = run_cli("train-detector oxford --resume auto",
                            base + ["--epochs", "3", "--resume", "auto"])
    check("at epoch 2" in out, "the resumed Oxford run starts at epoch 2")
    recs = read_jsonl(os.path.join(out_dir, "oxford_metrics.jsonl"))
    check({r["epoch"] for r in recs[len(first):]} == {2},
          "the resumed run trains epoch 2 only")
    check(all(np.isfinite(r["loss"]) for r in recs if "loss" in r),
          "every Oxford loss finite")
    check({r["epoch"] for r in recs if r["prefix"] == "test"} == {0, 1, 2},
          "a test sweep over the Oxford ground-truth pairs each epoch")
    ckpt = find_checkpoint(out_dir)
    check(ckpt is not None, "an Oxford checkpoint")
    print(f"[11] train-detector --dataset oxford --override "
          f"detector.grouping=ball --device cuda: 2 epochs in {t_first:.1f} "
          f"s, --resume auto to 3 in {t_resume:.1f} s (both in process); "
          f"[epoch, train loss, sigma_mean] "
          f"{[(r['epoch'], round(r['loss'], 4), round(r['sigma_mean'], 4)) for r in recs if r['prefix'] == 'train_epoch']}"
          f", [epoch, test loss] "
          f"{[(r['epoch'], round(r['loss'], 4)) for r in recs if r['prefix'] == 'test']}",
          flush=True)

    cfg = oxford_config("ball", **{"data.dataroot": root,
                                   "train.log_every": 100})
    train, test = cli._make_loaders(cfg, types.SimpleNamespace(
        synthetic=False), cfg.detector.surface_normal_len)
    engine = DetectorEngine(cfg, train, test,
                            out_dir=os.path.join(tmp, "engine_oxford"),
                            device="cuda")
    engine.train_epoch(0)
    sync()
    steps = len(train)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    avg = engine.train_epoch(1)
    sync()
    wall = time.perf_counter() - t0
    launches = {"oxford_engine": dict(kernels.LAUNCHES)}
    check(all(np.isfinite(list(avg.values()))), "Oxford engine metrics "
          "finite")
    for name, n in OX_STEP_LAUNCHES.items():
        check(launches["oxford_engine"][name] == n * steps, f"Oxford engine: "
              f"{name} launched {n} times a step")
    busy, _, _ = profile_busy(lambda: engine.train_epoch(2), 1)
    print(f"[11] {card} | engine train oxford ball bf16 batch "
          f"{cfg.train.batch_size}, one epoch of {steps} steps: "
          f"{2 * cfg.train.batch_size * steps / wall:.2f} clouds/s "
          f"({wall / steps * 1e3:.3f} ms a step); the bare step "
          f"{rates['ball']:.2f} clouds/s; idle share "
          f"{1.0 - busy / (wall * 1e3):.4f} of the epoch's "
          f"{wall * 1e3:.3f} ms; launches {launches['oxford_engine']}",
          flush=True)
    del engine

    scores = {}
    for method in ("model", "random", "iss"):
        kp_dir = os.path.join(tmp, f"kp_oxford_{method}")
        argv = ["export-keypoints", "--dataset", "oxford", "--dataroot",
                root, "--out", kp_dir, "--method", method, "--device",
                "cuda", "--override", "detector.grouping=ball"]
        if method == "model":
            argv += ["--checkpoint", ckpt]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        sync()
        t_export = time.perf_counter() - t0
        stats = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(stats["frames"] == OX_TREE["test_scans"]
              and stats["mean_keypoints"] == 128, f"export {method} {stats}")
        if method == "model":
            launches["oxford_export"] = dict(kernels.LAUNCHES)
            for name in PATH_KERNELS["ball"]:
                check(launches["oxford_export"][name] > 0, f"kernel {name} "
                      "launched on the Oxford export path")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["eval-repeatability", "--anc-dir", kp_dir, "--pos-dir",
                      kp_dir, "--oxford-root", root, "--coord-fix",
                      "oxford"])
        rep = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(rep["pairs"] == OX_TREE["test_scans"] - 1
              and 0.0 <= rep["repeatability"] <= 1.0, f"repeatability {rep}")
        scores[method] = rep["repeatability"]
        print(f"[11] {card} | export-keypoints --dataset oxford --method "
              f"{method}: {json.dumps(stats)} in {t_export:.1f} s"
              + (f"; launches {launches['oxford_export']}"
                 if method == "model" else "")
              + f"; eval-repeatability --coord-fix oxford: {json.dumps(rep)}",
              flush=True)

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        gate = quality.run(os.path.join(tmp, "quality_ball"), device="cuda",
                           overrides=["detector.grouping=ball"])
    print(f"[11] {card} | quality gate with --override detector.grouping="
          f"ball (reported, not held) in {time.perf_counter() - t0:.1f} s: "
          f"trained repeatability {gate['trained']['repeatability']}, random "
          f"{gate['random']['repeatability']} over {gate['pairs']} pairs, "
          f"ratio {gate['ratio']}", flush=True)
    return launches


def phase11(card, tmp):
    """The grouped-trunk detectors in training, and SOM with k=2."""
    k4, k5 = oxford_kernel_checks(card, np.random.default_rng(12))
    launches, rates = phase11_steps(card)
    launches.update(phase11_entry(card, tmp, rates))
    return launches, k4, k5


# --------------------------------------------------------------- phase 12 --
# ranks: two gloo ranks share the one card (NCCL refuses two ranks on one
# device); NCCL at world size 1; the 2-card NCCL run where there are 2 cards
RANKS = 2
DP_CHECK_STEPS = 3
DP_STEPS = 5
SP_STEPS = 2
TP_STEPS = 2
# the TP forwards and train steps timed after the checked ones
TP_TIMED = 3
PP_MICRO = 4
# the per-rank shapes phase 12 adds: K4 at the sharded knn and ball
# gathers' local select (8, 512, 8192) k=64, scores read once, values and
# indices written
SHARD_K4 = (8, 512, 8192, 64)
SHARD_K4_BOUND = bound(8 * 512 * 8192 * 4 + 8 * 512 * 64 * 8, 0, FP32_FLOPS)
# the kernels each rank's path must launch
# phase 12's tree: phase 7's, cut to 2 scans a train sequence
RANK_TREE = {**TREE, "frames_per_seq": 2}
# phase 12's counted runs (rank 0's counts) in the kernels line
RANK_LAUNCH_TAGS = ("dp_detector", "dp_descriptor", "dp_export",
                    "sharded_forward", "sharded_train", "sharded_gather",
                    "tp_train", "pipeline")
RANK_KERNELS = {
    "dp_detector": ("fps", "min_argmin", "scatter_max", "smallest_k"),
    "dp_descriptor": ("fps", "min_argmin", "scatter_max", "smallest_k"),
    "dp_export": ("fps", "min_argmin", "scatter_max", "fusion_chain",
                  "smallest_k"),
    "sharded_forward": ("min_argmin", "scatter_max", "fusion_chain",
                        "smallest_k"),
    "sharded_train": ("min_argmin", "scatter_max", "smallest_k"),
    "sharded_gather": ("smallest_k",),
    "tp_train": ("fps", "min_argmin", "scatter_max", "smallest_k"),
}


def _rank_entry(rank, world, init, out_dir, fn, arg, backend):
    """One rank of phase 12: join the group (a ``file://`` rendezvous), run
    ``fn(rank, world, arg)``, save its result."""
    import torch.distributed as dist

    from usip_tpu_torch.parallel import initialize_distributed
    os.environ["LOCAL_RANK"] = str(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(f"file://{init}", world, rank, backend=backend,
                           device="cuda", timeout=600)
    try:
        res = fn(rank, world, arg)
        dist.barrier()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, tmp, arg=None, world=RANKS, backend="gloo"):
    """``fn(rank, world, arg)`` in ``world`` rank processes (spawned; a
    rank that fails raises here); their results, rank by rank."""
    import torch.multiprocessing as mp
    d = tempfile.mkdtemp(dir=tmp)
    mp.start_processes(_rank_entry, args=(world, os.path.join(d, "rdzv"), d,
                                          fn, arg, backend),
                       nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _hash(module):
    import hashlib
    h = hashlib.sha256()
    for name, t in sorted(module.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _counted(fn):
    """``fn()`` with the launch counts set to 0 before and read after."""
    kernels.reset_launch_counts()
    out = fn()
    sync()
    return out, dict(kernels.LAUNCHES)


def _step_checks(tag, dp_res, one_res, dp_model, one_model):
    """A step against the one-rank step from the same state and draws:
    metrics (relative), gradients (``grad_errors``: the worst error over
    the floored scale, the lowest cosine), running statistics (the
    largest difference over the 2e-5 bound, 2e-5 + 2e-5 |ref|)."""
    rel = {k: abs(float(dp_res[k]) - float(one_res[k]))
           / max(abs(float(one_res[k])), 1e-30) for k in one_res}
    worst, low, _ = grad_errors(tag, {"cuda": _grads(dp_model),
                                      "cpu": _grads(one_model)})
    bn = max(float(((a - b).abs() / (2e-5 + 2e-5 * b.abs())).max())
             for (n, a), b in zip(dp_model.state_dict().items(),
                                  one_model.state_dict().values())
             if n.endswith(("running_mean", "running_var")))
    return {"rel": rel, "grad_worst": worst, "grad_cos": low,
            "bn_over_tol": bn}


def _reordered(batch, b):
    """The batch with its halves swapped (rank 1's rows first) and the
    index that does it: the same global batch, summed in another order."""
    perm = torch.cat([torch.arange(b // 2, b), torch.arange(b // 2)])
    if isinstance(batch, PackedPairBatch):
        inv = torch.argsort(perm).to(batch.neg_idx.device)
        return PackedPairBatch(batch.x[perm.to(batch.x.device)],
                               inv[batch.neg_idx[perm.to(
                                   batch.neg_idx.device)]]), perm
    return type(batch)(*(t[perm.to(t.device)] for t in batch)), perm


@contextlib.contextmanager
def _float64_casts():
    """The port's ``.float()`` and ``.to(float32)`` kept in float64, and
    float64 the default dtype, for the block: a float64 run of fp32 code
    (``tests/group_step_probe.py``'s arbiter). Train-mode BatchNorm runs
    ``batch_norm_plain`` there, its float64 math as on the CPU: the CUDA
    kernels take bf16 and fp32 rows only."""
    orig_float, orig_to = torch.Tensor.float, torch.Tensor.to
    orig_bn = BatchNorm.forward

    def to(self, *a, **k):
        a = tuple(torch.float64 if x is torch.float32 else x for x in a)
        if k.get("dtype") is torch.float32:
            k["dtype"] = torch.float64
        return orig_to(self, *a, **k)

    def plain_bn(self, x, relu=False):
        y = batch_norm_plain(self, x)
        return torch.relu(y) if relu else y

    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self: self.double()
    torch.Tensor.to = to
    BatchNorm.forward = plain_bn
    try:
        yield
    finally:
        torch.Tensor.float, torch.Tensor.to = orig_float, orig_to
        BatchNorm.forward = orig_bn
        torch.set_default_dtype(default)


def descriptor_grads_f64(cfg, model, det, batch, draws):
    """The arbiter of the scan-loss descriptor step's fp32 gradients: the
    step's nodes, frozen keypoints and ball features as the fp32 step makes
    them (selections, the same bits), then the descriptor network, the
    triplet loss and the backward in float64 on the card. Returns the
    float64 gradients by parameter name."""
    from usip_tpu_torch import losses as L
    check(not cfg.augment.height_scale, "the arbiter covers the KITTI "
          "descriptor preset (no height scale)")
    anc_pc, anc_sn, pos_pc, pos_sn, neg_idx = train_steps._as_pair(batch)
    b = anc_pc.shape[0]
    nodes = [train_steps._nodes(pc, cfg, d) for pc, d in
             ((anc_pc, draws.nodes_anc), (pos_pc, draws.nodes_pos))]
    with torch.no_grad():
        _, kp, sig = det(torch.cat([anc_pc, pos_pc]),
                         torch.cat([anc_sn, pos_sn]), torch.cat(nodes))
    model = copy.deepcopy(model).double().train()
    feats = [model.group(pc, sn, k, pri) for pc, sn, k, pri in (
        (anc_pc, anc_sn, kp[:b], draws.ball_anc),
        (pos_pc, pos_sn, kp[b:], draws.ball_pos))]
    with _float64_casts():
        anc, pos = (model.describe(f.double()) for f in feats)
        loss, _ = L.desc_pair_scan_loss(
            anc, pos, anc[neg_idx.to(anc.device).long()], sig[:b].double(),
            gamma=cfg.loss.triple_loss_gamma, sigma_max=cfg.loss.sigma_max)
        loss.mean().backward()
    return {n: p.grad.double().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


def _grads(model):
    return {n: p.grad.double().cpu() for n, p in model.named_parameters()
            if p.grad is not None}


@contextlib.contextmanager
def _ball_max_slots(model, mesh=None):
    """Records, for each ``describe`` call in the block, conv5's output
    ``(B, M, K, D)`` and the ball slot of each descriptor channel's max
    over the ball (its argmax over K), gathered over ``mesh``'s ranks in
    rank order: where two runs' slots differ, their descriptors took
    another point's value, and conv5's gradient another point's input."""
    import torch.distributed as dist
    rec = []

    def hook(mod, inp, out):
        y = out.detach()
        if mesh is not None:
            parts = [torch.empty_like(y) for _ in range(mesh.size)]
            dist.all_gather(parts, y.contiguous(), group=mesh.group)
            y = torch.cat(parts)
        rec.append(y)

    handle = model.conv5.register_forward_hook(hook)
    try:
        yield rec
    finally:
        handle.remove()


def _slot_flips(dp_rec, one_rec):
    """The (ball, channel) maxima whose slot differs between two runs'
    ``_ball_max_slots`` records, of how many, and the largest gap between
    the two slots' values in the second run, over its max|value|."""
    n, flips, gap = 0, 0, 0.0
    for a, b in zip(dp_rec, one_rec):
        sa, sb = a.argmax(dim=-2), b.argmax(dim=-2)
        diff = sa != sb
        n += diff.numel()
        flips += int(diff.sum())
        if bool(diff.any()):
            va = b.gather(-2, sa.unsqueeze(-2)).squeeze(-2)
            vb = b.gather(-2, sb.unsqueeze(-2)).squeeze(-2)
            gap = max(gap, float((vb - va).abs()[diff].max()
                                 / b.abs().max()))
    return flips, n, gap


def _dp_step_case(rank, world, mesh, make_step, state, local, full, draws_of,
                  steps_n, extra=(), arbiter=None):
    """``steps_n`` data-parallel steps from ``state``; before each, rank 0
    keeps two copies of the state and after it runs the one-rank step on
    the whole batch with the same draws from one copy, and from the other
    the one-rank step on the same batch with its halves swapped (the same
    function summed in another order: the reduction-order noise of the
    one-rank step itself), and compares the data-parallel step and the
    reordered step with the one-rank step. With ``arbiter(model, extra,
    batch, draws)`` (float64 gradients from the state before the step),
    both fp32 steps' gradients are also held against it, and the two
    steps' ball-max slots are compared (``_ball_max_slots``)."""
    from usip_tpu_torch.nn.layers import set_bn_process_group
    step, one = make_step(mesh), make_step(None)
    b = int(full[0].shape[0])
    out = []
    for i in range(steps_n):
        # the step sets its process group on every BatchNorm again; a
        # process group is not copied
        set_bn_process_group(state.model, None)
        before = copy.deepcopy(state) if rank == 0 else None
        again = copy.deepcopy(state) if rank == 0 else None
        draws = draws_of(i)
        g64 = (arbiter(before.model, extra, full, draws)
               if rank == 0 and arbiter is not None else None)
        slots = (_ball_max_slots(state.model, mesh) if arbiter is not None
                 else contextlib.nullcontext())
        with slots as dp_rec:
            m = step(state, *extra, local, 0, draws=draws)
        if rank == 0:
            slots = (_ball_max_slots(before.model) if arbiter is not None
                     else contextlib.nullcontext())
            with slots as one_rec:
                m1 = one(before, *extra, full, 0, draws=draws)
            swapped, perm = _reordered(full, b)
            m2 = one(again, *extra, swapped, 0,
                     draws=train_steps.draws_rows(
                         draws, perm.to(full[0].device), b))
            res = {"dp": _step_checks(f"dp step {i}", m, m1, state.model,
                                      before.model),
                   "order": _step_checks(f"reordered step {i}", m2, m1,
                                         again.model, before.model)}
            if g64 is not None:
                res["slot_flips"] = _slot_flips(dp_rec, one_rec)
                res["f64"] = {
                    tag: grad_errors(f"{tag} step {i} against float64", {
                        "cuda": _grads(model), "cpu": g64})[:2]
                    for tag, model in (("dp", state.model),
                                       ("one", before.model))}
            out.append(res)
    return out, _hash(state.model)


def _dp_timed(mesh, make_step, state, local, gen, extra=()):
    """``DP_STEPS`` bf16 steps with the counts read a rank, then the step
    time over 5 pipelined steps and the peak memory of this rank."""
    step = make_step(mesh)
    _, launches = _counted(lambda: [step(state, *extra, local, 0,
                                         generator=gen)
                                    for _ in range(DP_STEPS)])
    torch.cuda.reset_peak_memory_stats()
    import torch.distributed as dist
    dist.barrier()
    t0 = time.perf_counter()
    ms = [step(state, *extra, local, 0, generator=gen) for _ in range(5)]
    sync()
    dist.barrier()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    return {"launches": launches, "step_ms": wall,
            "loss": [float(m["loss"]) for m in ms],
            "peak_mib": torch.cuda.max_memory_allocated() / 2**20}


def ranks_work(rank, world, arg):
    """Phase 12's in-process work of one rank: the data-parallel detector
    and descriptor steps (fp32 checks against one rank, bf16 timing), the
    data-parallel export, the point-sharded ops, detector and trainer,
    ``sharded_describe``, and tensor parallelism."""
    from usip_tpu_torch.eval.export_runner import run_export
    from usip_tpu_torch.parallel import make_mesh, shard_batch
    dev = torch.device("cuda")
    mesh = make_mesh(world)
    out = {}

    # -- the data-parallel detector step: global batch 8, full width
    cfg32 = get_config("kitti", **{"detector.compute_dtype": "float32",
                                   "train.num_devices": world})
    rng = np.random.default_rng(120)
    b = cfg32.train.batch_size
    full = parent_batch(rng, cfg32, b, dev)
    local = shard_batch(mesh, full)
    state = train_state(cfg32, dev)
    p = cfg32.data.parent_pc_num

    def det_draws(i):
        return train_steps.detector_draws(
            cfg32, b, 4, torch.Generator(device=dev).manual_seed(100 + i),
            True, p)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out["dp_detector_checks"], h = _dp_step_case(
            rank, world, mesh,
            lambda m: (make_detector_train_step(cfg32, m) if m is not None
                       else eager_detector(make_detector_train_step(cfg32),
                                           cfg32)),
            state, local, full, det_draws, DP_CHECK_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
    out["dp_detector_hash"] = h
    cfg = get_config("kitti", **{"train.num_devices": world})
    state = train_state(cfg, dev)
    out["dp_detector"] = _dp_timed(
        mesh, lambda m: make_detector_train_step(cfg, m), state, local,
        torch.Generator(device=dev).manual_seed(SEED))

    # -- the data-parallel descriptor step: 8 pairs, full width
    dcfg32 = get_config("kitti", role="descriptor", **DESC_FP32,
                        **{"train.num_devices": world})
    full = pair_batch(np.random.default_rng(121), 8, 16384, dev,
                      dcfg32.data.wire_dtype)
    local = PackedPairBatch(shard_batch(mesh, full.x), full.neg_idx)
    det = seeded_detector(dcfg32, dev, head_init=True).requires_grad_(False)
    dstate = TrainState.create(seeded_descriptor(dcfg32, dev),
                               dcfg32.train.lr)

    def desc_draws(i):
        return train_steps.descriptor_draws(
            dcfg32, 8, 16384, torch.Generator(device=dev).manual_seed(200 + i))

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out["dp_descriptor_checks"], h = _dp_step_case(
            rank, world, mesh,
            lambda m: make_descriptor_train_step(dcfg32, mesh=m), dstate,
            local, full, desc_draws, DP_CHECK_STEPS, extra=(PerCloud(det),),
            arbiter=lambda model, extra, batch, draws: descriptor_grads_f64(
                dcfg32, model, extra[0], batch, draws))
    finally:
        torch.use_deterministic_algorithms(False)
    out["dp_descriptor_hash"] = h
    dcfg = get_config("kitti", role="descriptor",
                      **{"train.num_devices": world})
    det = seeded_detector(dcfg, dev, head_init=True).requires_grad_(False)
    dstate = TrainState.create(seeded_descriptor(dcfg, dev), dcfg.train.lr)
    out["dp_descriptor"] = _dp_timed(
        mesh, lambda m: make_descriptor_train_step(dcfg, mesh=m), dstate,
        local, torch.Generator(device=dev).manual_seed(SEED), extra=(det,))

    # -- the data-parallel export (global batch 8) of phase 7's checkpoint
    ecfg = get_config("kitti", **{"data.dataroot": arg["root"],
                                  "train.num_devices": world})
    out["dp_export"] = _counted(lambda: run_export(
        ecfg, arg["ckpt"], arg["export_dir"], device="cuda"))

    # the comparisons below run under deterministic algorithms: the sharded
    # trunk's cluster sums (scatter_add) otherwise add in a run-dependent
    # order on the card, and an anchor moved by that can swap a node's
    # 16th and 17th nearest neighbours between two calls of one forward
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out["sharded"], out["tp"] = ranks_numerics(rank, world)
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def ranks_numerics(rank, world):
    """The point-sharded ops, detector forward, train steps and describe,
    and tensor parallelism's forward and train steps, on this rank, with
    rank 0's one-rank references."""
    from usip_tpu_torch.parallel import sharded_ops as so
    from usip_tpu_torch.parallel import tensor_parallel as tpm
    from usip_tpu_torch.parallel.sharded_descriptor import sharded_describe
    from usip_tpu_torch.parallel.sharded_detector import (
        sharded_detector_forward)
    from usip_tpu_torch.parallel.sharded_train import (
        make_sharded_detector_train_step)
    from usip_tpu_torch import losses as L
    dev = torch.device("cuda")
    # -- point-sharded: the cloud's 16384 points over the ranks
    pmesh = so.make_point_mesh(world)
    sh = lambda x: so.shard_points(pmesh, x).contiguous()  # noqa: E731
    rng = np.random.default_rng(122)
    pc, sn = (torch.from_numpy(a).to(dev) for a in kitti_cloud(rng, 8, 16384))
    kp = pc[:, :512] + 0.1
    sig = torch.rand(8, 512, device=dev, generator=torch.Generator(
        device=dev).manual_seed(9)) + 0.5
    res = {}
    kp2 = kp + 0.05 * torch.randn(kp.shape, device=dev, generator=(
        torch.Generator(device=dev).manual_seed(8)))
    ch = so.sharded_chamfer_probabilistic(pmesh, sh(kp2), sh(kp), sh(sig),
                                          sh(sig.flip(1)))
    res["chamfer"] = [float(ch.loss), float(ch.chamfer_pure)]
    res["single"] = so.sharded_single_side_chamfer(pmesh, kp, sh(pc))
    (d, f, idx), res["knn_launches"] = _counted(
        lambda: so.sharded_knn_gather(pmesh, kp, sh(pc), sh(sn), 64,
                                      return_indices=True))
    res["knn_idx"] = idx
    pri = torch.rand(8, 16384, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    res["ball"] = so.sharded_ball_gather(pmesh, kp, sh(pc), sh(sn), 2.0, 64,
                                         sh(pri), return_indices=True)
    if rank == 0:
        res["one_chamfer"] = [float(t) for t in L.chamfer_probabilistic(
            kp2, kp, sig, sig.flip(1))[:2]]
        res["one_single"] = L.single_side_chamfer(kp, pc)
        res["one_knn_idx"] = knn_group_idx(kp, pc)
        res["one_ball"] = ball_query(pc, kp, 2.0, 64, pri).idx
    scfg = get_config("kitti", **{"detector.compute_dtype": "float32"})
    det = seeded_detector(scfg, dev)
    node = sample_nodes(pc, 512, 8, generator=torch.Generator(
        device=dev).manual_seed(6))
    res["forward"], res["forward_launches"] = _counted(
        lambda: sharded_detector_forward(pmesh, scfg, det, sh(pc), sh(sn),
                                         node))
    if rank == 0:
        res["one_forward"] = detector_infer_fused(det, pc, sn, node)
    st = TrainState.create(seeded_detector(scfg, dev), 1e-3)
    bb = 4
    R = torch.eye(3, device=dev).expand(bb, 3, 3).contiguous()
    args = (pc[:bb], sn[:bb], node[:bb], pc[bb:], sn[bb:], node[bb:], R,
            torch.ones(bb, device=dev), torch.zeros(bb, 3, device=dev))
    sp_args = [sh(a) if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    step = make_sharded_detector_train_step(scfg, pmesh)
    ms, res["train_launches"] = _counted(
        lambda: [step(st, *sp_args, 0) for _ in range(SP_STEPS)])
    res["train_losses"] = [float(m["loss"]) for m in ms]
    if rank == 0:
        one = seeded_detector(scfg, dev)
        res["one_train_loss"] = one_rank_sharded_loss(one, args, scfg)
    dcfg = get_config("kitti", role="descriptor", **DESC_FP32)
    desc = seeded_descriptor(dcfg, dev).eval()
    kp256 = kp[:, :256].contiguous()
    res["describe"] = sharded_describe(pmesh, dcfg, desc, sh(pc), sh(sn),
                                       kp256, sh(pri))
    if rank == 0:
        with torch.no_grad():
            res["one_describe"] = desc(pc, sn, kp256, pri)
    sharded = res

    # -- tensor parallel: the fusion block and head over the ranks, c2 512
    import torch.distributed as dist

    def wall_ms(fn, n):
        """``fn()`` ``n`` times between barriers: ms a call (the slower
        rank's time is the last to pass the barrier)."""
        sync()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        sync()
        dist.barrier()
        return (time.perf_counter() - t0) / n * 1e3

    cmesh = tpm.make_channel_mesh(world)
    det = seeded_detector(scfg, dev)
    res = {"forward": tpm.tensor_parallel_detector_forward(
        cmesh, scfg, det, pc, sn, node)}
    res["forward_ms"] = wall_ms(lambda: tpm.tensor_parallel_detector_forward(
        cmesh, scfg, det, pc, sn, node), TP_TIMED)
    if rank == 0:
        with torch.no_grad():
            res["one_forward"] = det.eval()(pc, sn, node)
    tcfg = get_config("kitti", **{"detector.compute_dtype": "float32"})
    tstate = tpm.shard_state_tp(cmesh, train_state(tcfg, dev))
    full = parent_batch(np.random.default_rng(123), tcfg, 8, dev)
    tstep = tpm.make_tp_train_step(tcfg)

    def tp_draws(i):
        return train_steps.detector_draws(
            tcfg, 8, 4, torch.Generator(device=dev).manual_seed(300 + i),
            True, tcfg.data.parent_pc_num)

    ms, res["train_launches"] = _counted(lambda: [
        tstep(tstate, full, 0, draws=tp_draws(i)) for i in range(TP_STEPS)])
    res["train"] = [{k: float(v) for k, v in m.items()} for m in ms]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res["train_ms"] = wall_ms(lambda: tstep(tstate, full, 0, generator=gen),
                              TP_TIMED)
    if rank == 0:
        one = train_state(tcfg, dev)
        res["one_train"] = {k: float(v) for k, v in make_detector_train_step(
            tcfg)(one, full, 0, draws=tp_draws(0)).items()}
    res["held"] = sum(q.numel() for n, q in tstate.model.named_parameters()
                      if n.startswith("tp."))
    # the whole (replicated) parameters, which every rank must hold alike
    import hashlib
    h = hashlib.sha256()
    for n, q in sorted(tstate.model.named_parameters()):
        if not tstate.model._is_cut(n):
            h.update(q.detach().cpu().numpy().tobytes())
    res["hash"] = h.hexdigest()
    return sharded, res


def knn_group_idx(query, database):
    """The one-rank kNN indices (64) of ``query`` in ``database``."""
    from usip_tpu_torch.ops import knn
    return knn(query, database, 64)[1]


def one_rank_sharded_loss(det, args, cfg):
    """The sharded train step's loss at one rank (same forward, losses)."""
    from usip_tpu_torch import losses as L
    from usip_tpu_torch.ops.geometry import apply_se3
    src_pc, src_sn, src_node, dst_pc, dst_sn, dst_node, R, sc, sh = args
    det.train()
    _, kp, sig = det(torch.cat([src_pc, dst_pc]), torch.cat([src_sn, dst_sn]),
                     torch.cat([src_node, dst_node]), bn_momentum=0.1)
    b = src_pc.shape[0]
    ch = L.chamfer_probabilistic(apply_se3(kp[:b], R, sc, sh), kp[b:],
                                 sig[:b], sig[b:])
    on = (L.single_side_chamfer(kp[:b], src_pc).mean()
          + L.single_side_chamfer(kp[b:], dst_pc).mean()) \
        * cfg.loss.keypoint_on_pc_alpha
    return float((ch.loss + on).detach())


def rank_kernel_checks(card, rng):
    """The kernels at the ranks' own shapes, against their plain versions:
    FPS at a rank's node sampling (4, 2048) -> 512, min/argmin at the
    sharded assignment (16, 8192) x 512, smallest-k at the sharded gathers'
    local select (8, 512, 8192) k=64 (also timed beside its bound and
    ``torch.topk``), scatter-max at (16, 8192) C=64 and 128, the fused
    chain at a rank's export batch (4, 512, 16, 131)."""
    dev = torch.device("cuda")
    pc = torch.from_numpy(kitti_cloud(rng, 16, 8192)[0]).to(dev)
    first = torch.randint(0, 2048, (4,), device=dev, dtype=torch.int32)
    pts = pc[:4, :2048].contiguous()
    check(torch.equal(kernels.fps(pts, first, 512),
                      kernels.fps_plain(pts, first, 512)),
          "FPS at (4, 2048) -> 512 equal to its plain version")
    nodes = pc[:, :512].contiguous()
    got, ref = kernels.min_argmin(pc, nodes), kernels.min_argmin_plain(
        pc, nodes)
    check(torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0]),
          "min/argmin at (16, 8192) x 512 equal to its plain version")
    b, m, n, k = SHARD_K4
    scores = pairwise_sqdist(pc[:b, :m], pc[:b]).contiguous()
    v, i = kernels.smallest_k(scores, k)
    pv, pi = kernels.smallest_k_plain(scores, k)
    check(torch.equal(v, pv) and torch.equal(i, pi),
          f"smallest-k at {SHARD_K4[:3]} k={k} equal to its plain version")
    ids = kernels.min_argmin(pc, nodes)[1].long()
    for c in (64, 128):
        f = torch.randn(16, 8192, c, device=dev)
        check(torch.equal(kernels.scatter_max(f, ids, 512),
                          kernels.scatter_max_plain(f, ids, 512)),
              f"scatter-max at (16, 8192) C={c} equal to its plain version")
    det = seeded_detector(get_config("kitti"), dev)
    ws, bs = kernels.fusion_chain_params(det.knnlayer_1)
    chain = kernels.prepare_chain(ws, bs)
    feat = torch.randn(4, 512, 128, device=dev).abs()
    grouped = knn_group(nodes[:4], nodes[:4], feat, 16).contiguous()
    ref = kernels.fusion_chain_plain(grouped, ws, bs)
    chain_err = float((kernels.fusion_chain(grouped, chain)
                       - ref).abs().max()) / float(ref.abs().max())
    # phase 2's bound: max|diff| within 1e-2 of max|plain|
    check(chain_err <= 1e-2, f"fusion chain at (4, 512, 16, 131) within "
          f"1e-2 of max|plain| ({chain_err:.3e})")
    k_ms = graph_ms(lambda: kernels.smallest_k(scores, k), 20)
    plain_ms = time_ms(lambda: kernels.smallest_k_plain(scores, k), 3)
    lib_ms = graph_ms(lambda: torch.topk(scores, k, largest=False), 20)
    print(f"[12] {card} | kernels at the ranks' shapes equal to their plain "
          f"versions (fused chain max|diff| {chain_err:.3e} of max|plain|); "
          f"smallest-k "
          f"{SHARD_K4[:3]} k={k}: {k_ms:.4f} ms (CUDA graph), plain "
          f"{plain_ms:.4f}, torch.topk {lib_ms:.4f}, bound "
          f"{SHARD_K4_BOUND[0]:.4f} ms ({SHARD_K4_BOUND[1]})", flush=True)
    return {"ms": k_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": SHARD_K4_BOUND[0], "bound_by": SHARD_K4_BOUND[1]}


def nccl_world_one(card):
    """NCCL at world size 1 through torchrun's environment: the init, the
    collectives, and a data-parallel detector step on the one-rank mesh."""
    import torch.distributed as dist

    from usip_tpu_torch.parallel import initialize_distributed, make_mesh
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(cli._free_port())}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        initialize_distributed(device="cuda")
        check(dist.get_backend() == "nccl", "NCCL is the default on CUDA")
        x = torch.arange(4.0, device="cuda")
        dist.all_reduce(x)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        dist.broadcast(x, 0)
        mesh = make_mesh(1)
        cfg = get_config("kitti")
        state = train_state(cfg, mesh.device)
        batch = parent_batch(np.random.default_rng(124), cfg, 8, mesh.device)
        m = make_detector_train_step(cfg, mesh)(
            state, batch, 0, generator=torch.Generator(
                device=mesh.device).manual_seed(SEED))
        check(bool(torch.isfinite(m["loss"])), "NCCL world-1 step finite")
        print(f"[12] {card} | NCCL at world size 1 (torchrun environment): "
              f"init, all_reduce, all_gather, broadcast, one step on the "
              f"one-rank mesh, loss {float(m['loss']):.5f}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def phase12_entry(card, tmp, root, ckpt):
    """The entry points over 2 gloo ranks on the card: train-detector (2
    epochs, then --resume auto), export-keypoints byte-identical to one
    rank at the per-rank batch, train-descriptor one epoch."""
    ckpt_dir = os.path.join(tmp, "ckpt_ranks")
    out_dir = os.path.join(ckpt_dir, "ranks")
    ranks = ["--num-devices", str(RANKS), "--dist-backend", "gloo"]
    base = ["usip_tpu_torch.cli", "train-detector", "--dataset", "kitti",
            "--dataroot", root, "--name", "ranks", "--checkpoints-dir",
            ckpt_dir, "--device", "cuda", "--override", "train.log_every=5"]
    _, t_first = run_module("train-detector --num-devices 2",
                            base + ranks + ["--epochs", "2"])
    first = read_jsonl(os.path.join(out_dir, "ranks_metrics.jsonl"))
    out, t_resume = run_module("train-detector --num-devices 2 --resume",
                               base + ranks + ["--epochs", "3", "--resume",
                                               "auto"])
    check("at epoch 2" in out, "the resumed 2-rank run starts at epoch 2")
    recs = read_jsonl(os.path.join(out_dir, "ranks_metrics.jsonl"))
    steps_logged = [r["step"] for r in recs if r["prefix"] == "train"]
    check(steps_logged == sorted(set(steps_logged)), "rank 0 alone writes "
          "the metrics: one record a logged step")
    check([r["epoch"] for r in recs if r["prefix"] == "train_epoch"]
          == [0, 1, 2], "three epochs logged once each")
    check(all(np.isfinite([r["loss"] for r in recs if "loss" in r])),
          "every 2-rank loss finite")
    exp = ["usip_tpu_torch.cli", "export-keypoints", "--dataset", "kitti",
           "--dataroot", root, "--checkpoint", ckpt, "--device", "cuda"]
    _, t_exp2 = run_module("export-keypoints --num-devices 2",
                           exp + ranks + ["--batch-size", "8", "--out",
                                          os.path.join(tmp, "kp_ranks")])
    _, t_exp1 = run_cli("export-keypoints --num-devices 1",
                        exp + ["--batch-size", "4", "--out",
                               os.path.join(tmp, "kp_one")])
    a, b = (_tree_bytes(os.path.join(tmp, d)) for d in ("kp_ranks",
                                                        "kp_one"))
    check(bool(a) and a == b, "export-keypoints over 2 ranks (batch 8) "
          "byte-identical to 1 rank at the per-rank batch 4")
    desc = ["usip_tpu_torch.cli", "train-descriptor", "--dataset", "kitti",
            "--dataroot", root, "--detector-checkpoint", ckpt, "--name",
            "ranks", "--checkpoints-dir", ckpt_dir, "--device", "cuda",
            "--epochs", "1"]
    _, t_desc = run_module("train-descriptor --num-devices 2", desc + ranks)
    drecs = read_jsonl(os.path.join(ckpt_dir, "ranks_descriptor",
                                    "ranks_desc_metrics.jsonl"))
    check(any(r["prefix"] == "desc_epoch" for r in drecs)
          and all(np.isfinite([r["loss"] for r in drecs if "loss" in r])),
          "train-descriptor over 2 ranks: an epoch, finite losses")
    print(f"[12] {card} | entry points over 2 gloo ranks on the card: "
          f"train-detector 2 epochs {t_first:.1f} s, --resume auto to 3 "
          f"{t_resume:.1f} s ([epoch, loss] "
          f"{[(r['epoch'], round(r['loss'], 4)) for r in recs if r['prefix'] == 'train_epoch']}"
          f"); export-keypoints 2 ranks {t_exp2:.1f} s, 1 rank (in process) "
          f"{t_exp1:.1f} s, {len(a)} frames byte-identical; train-descriptor"
          f" one epoch {t_desc:.1f} s", flush=True)


def phase12_pipeline(card):
    """detect -> describe over PP_MICRO microbatches on two streams of the
    card against the sequential path: equal outputs, both throughputs."""
    from usip_tpu_torch.parallel import pipeline_parallel as pp
    dev = torch.device("cuda")
    cfg = get_config("kitti", role="descriptor")
    det = seeded_detector(cfg, dev, head_init=True)
    desc = seeded_descriptor(cfg, dev).eval()
    rng = np.random.default_rng(125)
    gen = torch.Generator(device=dev).manual_seed(7)
    mbs, pris = [], []
    for _ in range(PP_MICRO):
        pc, sn = (torch.from_numpy(a).to(dev) for a in kitti_cloud(rng, 2,
                                                                   16384))
        node = sample_nodes(pc, cfg.data.node_num, 8, generator=gen)
        mbs.append((pc, sn, node))
        pris.append(torch.rand(2, 16384, generator=gen, device=dev))
    pipe = pp.DetectDescribePipeline(cfg, det, desc, devices=("cuda:0",
                                                              "cuda:0"))
    # compared under deterministic algorithms (any atomic scatter-add on
    # the path then sums in a fixed order), timed without
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (out, launches) = _counted(lambda: pipe(mbs, pris))
        seq = pp.sequential_detect_describe(cfg, det, desc, mbs, pris)
        sync()
    finally:
        torch.use_deterministic_algorithms(False)
    for got, ref in zip(out, seq):
        for a, b in zip(got, ref):
            check(torch.equal(a, b), "pipeline output equal to the "
                  "sequential path's")
    t_pipe = time_ms(lambda: pipe(mbs, pris), 5)
    t_seq = time_ms(lambda: pp.sequential_detect_describe(cfg, det, desc,
                                                          mbs, pris), 5)
    clouds = 2 * PP_MICRO
    print(f"[12] {card} | pipeline detect -> describe, {PP_MICRO} "
          f"microbatches of 2 clouds on two streams of one card: "
          f"{t_pipe:.3f} ms ({clouds * 1e3 / t_pipe:.2f} clouds/s) against "
          f"the sequential {t_seq:.3f} ms ({clouds * 1e3 / t_seq:.2f} "
          f"clouds/s); outputs equal; launches {launches}", flush=True)
    return launches


def phase12(card, tmp, ckpt):
    """Training and inference over ranks: the kernels at the ranks' shapes,
    2 gloo ranks sharing the card (data-parallel steps, export, the
    point-sharded and tensor-parallel modules), NCCL at world size 1 (and
    over 2 cards where there are 2), the entry points, the pipeline; on a
    synthetic KITTI tree of phase 7's scans cut to 2 a train sequence (2
    steps an epoch at batch 8), with phase 7's checkpoint."""
    root = os.path.join(tmp, "kitti_tree_ranks")
    build_synthetic_kitti_tree(root, **RANK_TREE)
    k4 = rank_kernel_checks(card, np.random.default_rng(126))
    export_dir = os.path.join(tmp, "kp_dp_inproc")
    t0 = time.perf_counter()
    res = run_ranks(ranks_work, tmp, {"root": root, "ckpt": ckpt,
                                      "export_dir": export_dir})
    t_ranks = time.perf_counter() - t0
    r0 = res[0]
    launches = {}
    for tag in ("dp_detector", "dp_descriptor"):
        checks = r0[f"{tag}_checks"]
        for i, c in enumerate(checks):
            dp, order = c["dp"], c["order"]
            print(f"[12] {tag} fp32 step {i}, 2 ranks against 1 (global batch"
                  f" 8, same state and draws): metrics relative "
                  f"{json.dumps({k: float(f'{v:.3e}') for k, v in dp['rel'].items()})}"
                  f", gradients worst {dp['grad_worst'][0]:.3e} "
                  f"({dp['grad_worst'][1]}), lowest cosine "
                  f"{dp['grad_cos'][0]:.9f} ({dp['grad_cos'][1]}), running "
                  f"statistics {dp['bn_over_tol']:.3f} of the 2e-5 bound; "
                  f"the one-rank step on the batch's halves swapped against "
                  f"it: worst {order['grad_worst'][0]:.3e} "
                  f"({order['grad_worst'][1]}), cosine "
                  f"{order['grad_cos'][0]:.9f}, statistics "
                  f"{order['bn_over_tol']:.3f}", flush=True)
            if "f64" in c:
                f64 = c["f64"]
                print(f"[12] {tag} fp32 step {i} against its float64 "
                      f"arbiter (descriptor network, loss and backward in "
                      f"float64 from the same ball features): 2 ranks worst "
                      f"{f64['dp'][0][0]:.3e} ({f64['dp'][0][1]}), cosine "
                      f"{f64['dp'][1][0]:.9f}; 1 rank worst "
                      f"{f64['one'][0][0]:.3e} ({f64['one'][0][1]}), cosine "
                      f"{f64['one'][1][0]:.9f}", flush=True)
                flips, n_max, gap = c["slot_flips"]
                print(f"[12] {tag} fp32 step {i}: conv5's ball-max slots "
                      f"that differ between 2 ranks and 1: {flips} of "
                      f"{n_max} (the largest gap between the two slots' "
                      f"values in the one-rank run {gap:.3e} of max|y|)",
                      flush=True)
            loss_keys = [k for k in dp["rel"] if k != "grad_norm"]
            check(all(dp["rel"][k] <= 1e-4 for k in loss_keys)
                  and dp["rel"].get("grad_norm", 0) <= 1e-3,
                  f"{tag} step {i}: metrics within tolerance of one rank")
            check(dp["grad_worst"][0] <= GRAD_TOL[1]
                  and dp["grad_cos"][0] >= GRAD_TOL[2],
                  f"{tag} step {i}: gradients within GRAD_TOL of one rank")
            check(dp["bn_over_tol"] <= 1.0, f"{tag} step {i}: running "
                  "statistics within 2e-5 of one rank")
            if "f64" in c:
                check(all(e[0][0] <= GRAD_TOL[1] and e[1][0] >= GRAD_TOL[2]
                          for e in c["f64"].values()),
                      f"{tag} step {i}: both fp32 steps' gradients within "
                      "GRAD_TOL of the float64 arbiter")
        check(res[0][f"{tag}_hash"] == res[1][f"{tag}_hash"],
              f"{tag}: the replicas bit-identical after the fp32 steps")
        timed = [r[tag] for r in res]
        for r in timed:
            check(all(np.isfinite(r["loss"])), f"{tag} bf16 losses finite")
            for name in RANK_KERNELS[tag]:
                check(r["launches"][name] > 0, f"kernel {name} launched in "
                      f"each rank's {tag} steps")
        step_ms = max(r["step_ms"] for r in timed)
        print(f"[12] {card} | {tag} bf16, global batch 8 over 2 gloo ranks "
              f"sharing the card: {step_ms:.3f} ms a step (pipelined, the "
              f"slower rank), {16e3 / step_ms:.2f} clouds/s; peak memory a "
              f"rank {[round(r['peak_mib']) for r in timed]} MiB; launches "
              f"a rank a step {[{k: v / DP_STEPS for k, v in r['launches'].items()} for r in timed]}",
              flush=True)
        launches[tag] = timed[0]["launches"]
    stats, exp_launches = r0["dp_export"]
    for name in RANK_KERNELS["dp_export"]:
        check(exp_launches[name] > 0, f"kernel {name} launched in the "
              "rank's export")
    launches["dp_export"] = exp_launches
    from usip_tpu_torch.eval.export_runner import run_export
    one_dir = os.path.join(tmp, "kp_one_inproc")
    run_export(get_config("kitti", **{"data.dataroot": root}), ckpt, one_dir,
               batch_size=4, device="cuda")
    a, b = _tree_bytes(export_dir), _tree_bytes(one_dir)
    check(bool(a) and a == b, "run_export over 2 ranks byte-identical to 1 "
          "rank at the per-rank batch")
    print(f"[12] run_export over 2 ranks: {json.dumps(stats)}, {len(a)} "
          f"frames byte-identical to 1 rank at batch 4; launches rank 0 "
          f"{exp_launches}", flush=True)

    s0, s1 = (r["sharded"] for r in res)
    tol = lambda a, b: float((a - b).abs().max())  # noqa: E731
    check(all(abs(x - y) <= 1e-5 * abs(y) for x, y in
              zip(s0["chamfer"], s0["one_chamfer"])),
          f"sharded chamfer {s0['chamfer']} against 1 rank "
          f"{s0['one_chamfer']}")
    check(tol(s0["single"], s0["one_single"]) <= 1e-5,
          "sharded single-side chamfer against 1 rank")
    check(torch.equal(s0["knn_idx"], s0["one_knn_idx"].long()),
          "sharded knn gather's merged indices equal to 1 rank's")
    counts, gidx = s0["ball"][2], s0["ball"][3]
    check(bool(((counts == 0)[..., None] | (gidx == s0["one_ball"].long())
                ).all()), "sharded ball gather's indices equal to 1 rank's "
          "(non-empty balls)")
    # anchors to 1e-4; keypoints and sigmas within 1e-2 of max|ref|: the
    # fused chain rounds its operands to bf16, where a reduction-order
    # difference of the trunk moves a value across a rounding boundary
    fwd = [tol(a, b) / (1.0 if i == 0 else float(b.abs().max()))
           for i, (a, b) in enumerate(zip(s0["forward"], s0["one_forward"]))]
    check(fwd[0] <= 1e-4 and max(fwd[1:]) <= 1e-2, f"sharded detector "
          f"forward against 1 rank's serving forward {fwd}")
    check(all(np.isfinite(s0["train_losses"])) and abs(
        s0["train_losses"][0] - s0["one_train_loss"]) <= 1e-4 * abs(
        s0["one_train_loss"]), f"sharded train step loss "
          f"{s0['train_losses']} against 1 rank {s0['one_train_loss']}")
    d, f = s0["describe"]
    d1, f1 = s0["one_describe"]
    # an empty ball's features are 0 here and point 0's at one rank
    live = (f != 0).flatten(2).any(-1)
    desc_err = float((d - d1).abs().amax(-1)[live].max())
    check(desc_err <= 1e-4, f"sharded_describe against 1 rank (non-empty "
          f"balls) {desc_err:.3e}")
    for tag, key in (("sharded_forward", "forward_launches"),
                     ("sharded_train", "train_launches"),
                     ("sharded_gather", "knn_launches")):
        for r in (s0, s1):
            for name in RANK_KERNELS[tag]:
                check(r[key][name] > 0, f"kernel {name} launched in each "
                      f"rank's {tag}")
        launches[tag] = s0[key]
    print(f"[12] {card} | point-sharded over 2 ranks (8192 points a rank): "
          f"chamfer {s0['chamfer']} (1 rank {s0['one_chamfer']}), knn and "
          f"ball gather indices equal to 1 rank's, detector forward max|diff|"
          f" {fwd}, train losses {s0['train_losses']} (1 rank "
          f"{s0['one_train_loss']:.6f}), describe {desc_err:.3e}; launches "
          f"a rank: forward {s0['forward_launches']}, {SP_STEPS} train steps "
          f"{s0['train_launches']}", flush=True)

    t0_, t1_ = (r["tp"] for r in res)
    fwd = [tol(a, b) for a, b in zip(t0_["forward"], t0_["one_forward"])]
    check(all(e <= 1e-4 for e in fwd), f"TP forward against 1 rank {fwd}")
    rel = {k: abs(t0_["train"][0][k] - v) / max(abs(v), 1e-30)
           for k, v in t0_["one_train"].items()}
    check(all(v <= (1e-3 if k == "grad_norm" else 1e-4)
              for k, v in rel.items()), f"TP train step against 1 rank {rel}")
    check(t0_["train"] == t1_["train"], "TP ranks' metrics identical")
    check(t0_["hash"] == t1_["hash"], "TP ranks' whole parameters identical")
    for name in RANK_KERNELS["tp_train"]:
        check(t0_["train_launches"][name] > 0, f"kernel {name} launched in "
              "the TP steps")
    launches["tp_train"] = t0_["train_launches"]
    tp_fwd_ms = max(r["tp"]["forward_ms"] for r in res)
    tp_step_ms = max(r["tp"]["train_ms"] for r in res)
    print(f"[12] {card} | tensor parallel over 2 gloo ranks sharing the card"
          f" (fp32, global batch 8, c2 512, fusion block and head cut): "
          f"forward {tp_fwd_ms:.3f} ms, train step {tp_step_ms:.3f} ms (wall "
          f"over {TP_TIMED} calls between barriers, the slower rank)", flush=True)
    print(f"[12] {card} | tensor parallel over 2 ranks (c2 512, fusion block "
          f"and head cut): forward max|diff| {fwd}; {TP_STEPS} train steps, "
          f"first step relative to 1 rank {json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})}"
          f"; {t0_['held']} cut parameters a rank; launches "
          f"{t0_['train_launches']}", flush=True)
    print(f"[12] the 2-rank in-process work in {t_ranks:.1f} s", flush=True)

    nccl_world_one(card)
    if torch.cuda.device_count() >= 2:
        r2 = run_ranks(nccl_two_card, tmp, None, backend="nccl")
        print(f"[12] nccl_2card: {r2}", flush=True)
    else:
        print("[12] nccl_2card: not run (1 device)", flush=True)
    phase12_entry(card, tmp, root, ckpt)
    launches["pipeline"] = phase12_pipeline(card)
    return launches, k4


# phase 13: the artifacts' fp32 batch (card against the in-process port),
# the clouds given to run-model (3 at batch 2: a ragged tail) and their
# points, and the kernels each artifact must launch
DEPLOY_B = 2
DEPLOY_CLOUDS = 3
DEPLOY_KERNELS = {
    "som": ("fps", "min_argmin", "smallest_k", "fusion_chain",
            "scatter_max"),
    "ball": ("fps", "smallest_k", "fusion_chain"),
    "pipeline": ("fps", "min_argmin", "smallest_k", "fusion_chain",
                 "scatter_max"),
}


class OpRecorder(TorchDispatchMode):
    """The outputs of every ``usip::`` op called inside the block, in
    order, as ``(op name, outputs)``: the artifact's and the in-process
    port's node and ball selections, read without changing either."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "usip":
            outs = out if isinstance(out, tuple) else (out,)
            self.calls.append((func.__name__.split(".")[0],
                               [t.clone() for t in outs]))
        return out


def _deploy_programs(cfg, kind, dev):
    """The in-process port's forward of one artifact kind, from the same
    seeded weights: ``detector_infer_fused`` (and ``Descriptor``) on the
    draws the artifact takes as inputs."""
    det = seeded_detector(cfg, dev)
    chain = kernels.prepare_chain(*kernels.fusion_chain_params(
        det.knnlayer_1))
    desc = seeded_descriptor(cfg, dev).eval() if kind == "pipeline" else None
    ratio = (cfg.data.eval_fps_subsample_ratio
             or cfg.data.fps_subsample_ratio)

    def run(pc, sn, subset, first, priority=None):
        node = sample_nodes(pc, cfg.data.node_num, ratio,
                            cfg.data.fps_parallel, subset_idx=subset,
                            first=first)
        _, kp, sig = detector_infer_fused(det, pc, sn, node, chain)
        if desc is None:
            return kp, sig
        return kp, sig, desc(pc, sn, kp, priority)[0]
    return run


def _export_artifact(kind, cfg, path, batch):
    """Export one artifact for the card from the seeded weights; its
    header, export seconds and file size."""
    from usip_tpu_torch import model_artifact as ma
    det_sd = {k: torch.tensor(v) for k, v in
              seeded_state_dict(cfg.detector, SEED).items()}
    t0 = time.perf_counter()
    if kind == "pipeline":
        desc_sd = {k: torch.tensor(v) for k, v in
                   seeded_descriptor_state_dict(cfg.descriptor,
                                                SEED).items()}
        hdr = ma.export_pipeline_artifact(cfg, det_sd, desc_sd, path,
                                          batch=batch, platforms=("cuda",))
    else:
        hdr = ma.export_detector_artifact(cfg, det_sd, path, batch=batch,
                                          platforms=("cuda",))
    return hdr, time.perf_counter() - t0, os.path.getsize(path)


def _gaps(label, got, ref):
    """Count and largest relative gap of the elements that differ."""
    diff = got != ref
    if not diff.any():
        return 0, 0.0
    scale = float(ref.float().abs().max())
    gap = float((got.float() - ref.float()).abs().max()) / max(scale, 1e-30)
    print(f"[13] {label}: {int(diff.sum())} of {ref.numel()} elements "
          f"differ, largest gap {gap} of max|x|", flush=True)
    return int(diff.sum()), gap


def artifact_rate(art, pc, sn, gen, iters=50, passes=3):
    """bench.py's protocol on an artifact's call, its draws made each
    iteration as ``KeypointPipeline.infer`` makes its own: two warm-up
    calls, the best of ``passes`` x ``iters`` pipelined calls, one
    synchronize a pass -> (clouds/s, ms a batch)."""
    from usip_tpu_torch.model_artifact import artifact_draws
    for _ in range(2):
        art(pc, sn, *artifact_draws(art.header, gen))
    sync()
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = art(pc, sn, *artifact_draws(art.header, gen))
        sync()
        best = min(best, time.perf_counter() - t0)
    check(bool(torch.isfinite(out[0]).all()), "artifact keypoints finite")
    return pc.shape[0] * iters / best, best / iters * 1e3


def phase13(card, tmp):
    """Deployment: artifacts exported for the card from seeded weights
    (the KITTI SOM detector, the Oxford ball detector, the KITTI pipeline
    in the descriptor role) at full width; each loaded and called in fp32
    at batch 2 with the in-process port's draws, launch counts reset
    before the call: its kernels launched, its outputs and every usip::
    op's outputs equal to the in-process port's; ``run-model --device
    cuda`` in a subprocess against ``run_detector_artifact`` in process;
    then the bf16 artifacts timed with the bench protocol beside the
    in-process detect."""
    from usip_tpu_torch.model_artifact import (artifact_draws, load_artifact,
                                               run_detector_artifact)
    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    fp32 = {"detector.compute_dtype": "float32"}
    cases = {
        "som": (get_config("kitti", **fp32), kitti_cloud),
        "ball": (oxford_config("ball", **fp32), oxford_cloud),
        "pipeline": (get_config("kitti", role="descriptor", **DESC_FP32),
                     kitti_cloud),
    }
    launches, paths, sizes = {}, {}, {}
    for tag, (cfg, cloud_fn) in cases.items():
        kind = "pipeline" if tag == "pipeline" else "detector"
        path = os.path.join(tmp, f"{tag}.usipart")
        hdr, secs, size = _export_artifact(kind, cfg, path, DEPLOY_B)
        paths[tag], sizes[tag] = path, size
        art = load_artifact(path, "cuda")
        run = _deploy_programs(cfg, kind, dev)
        pc, sn = (torch.from_numpy(a).to(dev) for a in
                  cloud_fn(rng, DEPLOY_B, cfg.data.input_pc_num))
        gen = torch.Generator(device=dev).manual_seed(SEED + 13)
        draws = artifact_draws(hdr, gen)
        kernels.reset_launch_counts()
        got = art(pc, sn, *draws)
        sync()
        launches[f"artifact_{tag}"] = dict(kernels.LAUNCHES)
        kernels.reset_launch_counts()
        with torch.inference_mode():
            ref = run(pc, sn, *draws)
        sync()
        in_process = dict(kernels.LAUNCHES)
        for name in DEPLOY_KERNELS[tag]:
            check(launches[f"artifact_{tag}"][name] > 0,
                  f"kernel {name} launched by the {tag} artifact")
        check(launches[f"artifact_{tag}"] == in_process,
              f"{tag}: the artifact launches what the in-process port does")
        # every usip:: op's outputs, artifact against in-process
        with OpRecorder() as rec_art:
            art(pc, sn, *draws)
        with OpRecorder() as rec_ref, torch.inference_mode():
            run(pc, sn, *draws)
        check([c[0] for c in rec_art.calls] == [c[0] for c in rec_ref.calls],
              f"{tag}: the same usip:: ops in the same order")
        for (op, a_outs), (_, r_outs) in zip(rec_art.calls, rec_ref.calls):
            for a, r in zip(a_outs, r_outs):
                if a.dtype in (torch.int32, torch.int64):
                    check(torch.equal(a, r), f"{tag}: {op} indices "
                          "identical")
                else:
                    _, gap = _gaps(f"{tag} {op}", a, r)
                    check(gap <= 1e-5, f"{tag}: {op} within 1e-5 of max|x|")
        for name, a, r in zip(hdr["outputs"], got, ref):
            check(bool(torch.isfinite(a).all()), f"{tag}: {name} finite")
            _, gap = _gaps(f"{tag} {name}", a, r)
            check(gap <= 1e-5, f"{tag}: {name} within 1e-5 of max|x|")
        print(f"[13] {tag} artifact fp32 ({DEPLOY_B}, "
              f"{cfg.data.input_pc_num}) -> {cfg.data.node_num}: exported in "
              f"{secs:.2f} s, {size} bytes; launches "
              f"{launches[f'artifact_{tag}']} (in process {in_process}); "
              f"{len(rec_art.calls)} usip:: op calls with identical indices; "
              "outputs "
              + ", ".join(f"{n} {'identical' if torch.equal(a, r) else 'differ'}"
                          for n, a, r in zip(hdr["outputs"], got, ref)),
              flush=True)

    # run-model in a subprocess against the loaded artifact in process
    cloud_dir = os.path.join(tmp, "deploy_clouds")
    os.makedirs(cloud_dir)
    clouds = []
    for i in range(DEPLOY_CLOUDS):
        pc, sn = kitti_cloud(rng, 1, 20000)
        clouds.append(os.path.join(cloud_dir, f"cloud{i}.npy"))
        np.save(clouds[-1], np.concatenate([pc[0], sn[0]], -1))
    out_cli = os.path.join(tmp, "deploy_cli")
    t0 = time.perf_counter()
    stdout, _ = run_module("run-model", [
        "usip_tpu_torch.cli", "run-model", "--artifact", paths["som"],
        "--input", cloud_dir, "--out", out_cli, "--device", "cuda",
        "--seed", "7"], timeout=300)
    cli_s = time.perf_counter() - t0
    check(json.loads(stdout.splitlines()[-1])["clouds"] == DEPLOY_CLOUDS,
          f"run-model served {DEPLOY_CLOUDS} clouds")
    out_in = os.path.join(tmp, "deploy_in_process")
    stats = run_detector_artifact(paths["som"], clouds, out_in, seed=7,
                                  device="cuda")
    check(stats["clouds"] == DEPLOY_CLOUDS, "in-process run served them")
    for c in clouds:
        name = os.path.splitext(os.path.basename(c))[0] + ".keypoints.bin"
        a = np.fromfile(os.path.join(out_cli, name), np.float32)
        b = np.fromfile(os.path.join(out_in, name), np.float32)
        check(a.shape == (128 * 3,) and np.isfinite(a).all(),
              f"{name}: 128 finite keypoints")
        check(np.array_equal(a, b), f"{name}: run-model equals the artifact "
              "in process, byte for byte")
    out_pipe = os.path.join(tmp, "deploy_pipeline")
    run_detector_artifact(paths["pipeline"], clouds, out_pipe, seed=7,
                          device="cuda")
    rows = min(128, cases["pipeline"][0].data.node_num)
    for c in clouds:
        name = os.path.splitext(os.path.basename(c))[0]
        kp = np.fromfile(os.path.join(out_pipe, f"{name}.keypoints.bin"),
                         np.float32).reshape(-1, 3)
        d = np.fromfile(os.path.join(out_pipe, f"{name}.desc.bin"),
                        np.float32).reshape(-1, 128)
        check(kp.shape[0] == d.shape[0] == rows and np.isfinite(d).all(),
              f"pipeline {name}: {rows} paired keypoint and descriptor rows")
    print(f"[13] run-model --device cuda ({DEPLOY_CLOUDS} clouds at batch "
          f"{DEPLOY_B}, a ragged tail): .bin files equal to the artifact "
          f"called in process with the same seed ({cli_s:.1f} s with "
          "start-up); the pipeline artifact's rows paired", flush=True)

    # bench.py's protocol: kitti, batch 8, bf16 presets
    bench = {"som": get_config("kitti"),
             "pipeline": get_config("kitti", role="descriptor")}
    kitti = bench["som"]
    pc8, sn8 = (torch.from_numpy(a).to(dev) for a in
                kitti_cloud(rng, B_BENCH, kitti.data.input_pc_num))
    rates = {}
    for tag, cfg in bench.items():
        kind = "pipeline" if tag == "pipeline" else "detector"
        path = os.path.join(tmp, f"{tag}_bench.usipart")
        _, secs, size = _export_artifact(kind, cfg, path, B_BENCH)
        art = load_artifact(path, "cuda")
        gen = torch.Generator(device=dev).manual_seed(SEED)
        rates[f"{tag} artifact"] = artifact_rate(art, pc8, sn8, gen)
        sizes[f"{tag} bf16 batch 8"] = size
        print(f"[13] {tag} artifact bf16 batch 8: exported in {secs:.2f} s, "
              f"{size} bytes", flush=True)
    sd = {k: torch.tensor(v) for k, v in
          seeded_state_dict(kitti.detector, SEED).items()}
    pipe = KeypointPipeline(kitti, sd, "cuda")
    rate, ms, _ = bench_rate(pipe, pc8, sn8)
    rates["in-process detect"] = (rate, ms)
    print(f"[13] {card} | bench protocol, kitti bf16 batch 8: "
          + "; ".join(f"{k} {r:.2f} clouds/s ({m:.3f} ms a batch)"
                      for k, (r, m) in rates.items())
          + f" (the pipeline in the descriptor role: "
          f"{bench['pipeline'].data.node_num} proposals described)",
          flush=True)
    return launches


# --------------------------------------------------------------- phase 14 --
# the object presets (modelnet, shrec: 5000-point shapes, 512 nodes, c1 128,
# c2 512, node kNN 32, rot_3d, batch 8) in training at full width: steps in
# the counted run, and the kernels' shapes there (a step: FPS on (8, 1250)
# twice, the assignment (16, 5000) x 512, the losses' keypoint -> shape (8,
# 512) x 5000 and chamfer (8, 512) x 512 twice each, the node kNN (16, 512,
# 512) k=32, scatter-max (16, 5000) at C=64 and 128; the export adds the
# chain at (8, 512, 32, 131) -> 512 and K1, K2, K4, K5 at batch 8)
OBJECT_STEPS = 5
OBJECT_STEP_LAUNCHES = {"fps": 2, "min_argmin": 5, "fusion_chain": 0,
                        "smallest_k": 1, "scatter_max": 2,
                        "batch_norm": 7 * 10}
OBJECT_SHAPES = {
    "fps (8, 1250) -> 512": ("fps", (8, 1250)),
    "min_argmin (16, 5000) x 512 bf16": ("min_argmin", (16, 5000, 512, True)),
    "min_argmin keypoint->shape (8, 512) x 5000 fp32": (
        "min_argmin", (8, 512, 5000, False)),
    "min_argmin chamfer (8, 512) x 512 fp32": (
        "min_argmin", (8, 512, 512, False)),
    "fusion_chain (8, 512, 32, 131) -> 512": ("fusion_chain", 32),
    "smallest_k node kNN (16, 512, 512) k=32": ("smallest_k", (16, 32)),
    "smallest_k node kNN (8, 512, 512) k=32": ("smallest_k", (8, 32)),
    "scatter_max (16, 5000) C=64+128": ("scatter_max", 16),
}
# the fp32 step card against CPU at the object width
OBJECT_FP32 = {"detector.compute_dtype": "float32"}
# SOMTrainer card against CPU (its defaults: an 8 x 8 grid, 20 + 60
# updates) on 8 object shapes: the points' final nodes the same but for a
# share SOM_FLIPS of them, and the nodes within SOM_TOL. A point within fp32
# noise of a tie that goes to the other node in one update moves both
# nodes' means by its offset over their ~78 points, a few 1e-3 on these
# shapes (one such flip: 1.763e-03 on an H100, the rest of the nodes at
# fp32 noise); the nodes beyond 1e-4 are counted and printed
SOM_TOL, SOM_FLIPS = 1e-2, 1e-3
# the full-scale protocol's arms on phase 7's tree, and the kernels each
# must launch (the model's keypoints, or keypoints and descriptors: all
# five; random keypoints and the random descriptors: none)
FULLSCALE_EVAL_ARMS = ("trained_defaults", "trained_fp32_exact",
                       "untrained_defaults", "random_keypoints")
FULLSCALE_REG_ARMS = ("trained_desc", "untrained_desc", "random_desc_floor",
                      "trained_desc_yaw", "untrained_desc_yaw")


def object_shapes(b, seed):
    """``b`` synthetic object shapes of 5000 points (SyntheticDataset, the
    modelnet preset's size) and their normals, (b, 5000, 3) each."""
    from usip_tpu_torch.data.synthetic import SyntheticDataset
    ds = SyntheticDataset(size=b, input_pc_num=5000, surface_normal_len=3,
                          seed=seed)
    items = [ds[i] for i in range(b)]
    return (np.stack([it["src_pc"] for it in items]),
            np.stack([it["src_sn"] for it in items]),
            np.stack([it["dst_pc"] for it in items]),
            np.stack([it["dst_sn"] for it in items]))


def object_chain(dev):
    """The folded, packed fusion chain of the seeded modelnet detector."""
    det = seeded_detector(get_config("modelnet"), dev)
    ws, bs = kernels.fusion_chain_params(det.knnlayer_1)
    return ws, bs, kernels.prepare_chain(ws, bs)


def object_kernels(card, rng):
    """Each kernel at the object shapes against its plain version (K1, K2,
    K4, K5 identical, K3 within 1e-2 of max|plain|, median 1e-3), then its
    CUDA-graph time beside the plain version's, the library call's and its
    bound (``kernel_bounds``' reckoning at these shapes). Returns the worst
    error of each kernel and the times by shape."""
    dev = torch.device("cuda")
    pc_np, _, _, _ = object_shapes(16, 30)
    pc = torch.from_numpy(pc_np).to(dev)
    nodes = torch.from_numpy(np.stack([p[rng.choice(5000, 512,
                                                    replace=False)]
                                       for p in pc_np])).to(dev)
    errs = {name: 0.0 for name, _ in OBJECT_SHAPES.values()}
    out = {}
    for label, (name, arg) in OBJECT_SHAPES.items():
        lib = None
        if name == "fps":
            b, s_ = arg
            pts = torch.from_numpy(np.stack([p[rng.choice(
                5000, s_, replace=False)] for p in pc_np[:b]])).to(dev)
            first = torch.from_numpy(rng.integers(0, s_, b).astype(
                np.int32)).to(dev)
            got, ref = kernels.fps(pts, first, 512), kernels.fps_plain(
                pts, first, 512)
            sync()
            check(torch.equal(got, ref), f"{label}: picks identical")
            run = lambda p=pts, f=first: kernels.fps(p, f, 512)  # noqa: E731
            plain = lambda p=pts, f=first: kernels.fps_plain(p, f, 512)  # noqa: E731
            bnd = bound(b * s_ * 12 + b * 4 + b * 512 * 4,
                        8 * b * 511 * s_, FP32_FLOPS)
        elif name == "min_argmin":
            b, n, m, bf16 = arg
            # the assignment (shapes onto their nodes), keypoints onto
            # shapes, and the chamfer between two copies' keypoints
            q = pc[:b] if n == 5000 else nodes[:b]
            c = pc[:b] if m == 5000 else nodes[b:2 * b] if n == 512 \
                else nodes[:b]
            for mode in (False, True):
                mins, idx = kernels.min_argmin(q, c, mode)
                rmins, ridx = kernels.min_argmin_plain(q, c, mode)
                sync()
                check(torch.equal(idx, ridx) and torch.equal(mins, rmins),
                      f"{label} round_bf16={mode}: identical")
                errs[name] = max(errs[name],
                                 float((mins - rmins).abs().max()))
            run = lambda q=q, c=c, f=bf16: kernels.min_argmin(q, c, f)  # noqa: E731
            plain = lambda q=q, c=c, f=bf16: kernels.min_argmin_plain(  # noqa: E731
                q, c, f)
            bnd = min_argmin_bound(b, n, m)
        elif name == "fusion_chain":
            ws, bs, chain = object_chain(dev)
            g = torch.from_numpy(np.concatenate(
                [rng.normal(0, 0.3, size=(B_BENCH, 512, arg, 3)),
                 np.abs(rng.normal(size=(B_BENCH, 512, arg, 128)))],
                -1).astype(np.float32)).to(dev)
            got = kernels.fusion_chain(g, chain)
            ref = kernels.fusion_chain_plain(g, ws, bs)
            sync()
            scale, err = float(ref.abs().max()), (got - ref).abs()
            check(scale > 0 and float(err.max()) <= 1e-2 * scale
                  and float(err.median()) <= 1e-3 * scale,
                  f"{label}: within 1e-2 (max) and 1e-3 (median) of "
                  f"max|plain| {scale}")
            errs[name] = max(errs[name], float(err.max()))
            run = lambda g=g, c=chain: kernels.fusion_chain(g, c)  # noqa: E731
            plain = lambda g=g, w=ws, b_=bs: kernels.fusion_chain_plain(  # noqa: E731
                g, w, b_)
            bnd = chain_bound(B_BENCH, 512, arg, 131, 256, 512)
        elif name == "smallest_k":
            b, k = arg
            sc = pairwise_sqdist(nodes[:b], nodes[:b])
            vals, idx = kernels.smallest_k(sc, k)
            rvals, ridx = kernels.smallest_k_plain(sc, k)
            sync()
            check(torch.equal(idx, ridx) and torch.equal(vals, rvals),
                  f"{label}: values and indices identical")
            run = lambda s=sc, k=k: kernels.smallest_k(s, k)  # noqa: E731
            plain = lambda s=sc, k=k: kernels.smallest_k_plain(s, k)  # noqa: E731
            lib = graph_ms(lambda s=sc, k=k: torch.topk(
                s, k, dim=-1, largest=False, sorted=True), 20)
            bnd = bound(b * 512 * 512 * 4 + b * 512 * k * 8, 0, FP32_FLOPS)
        else:
            b = arg
            # the assignment's own ids: each point's nearest node
            ids = kernels.min_argmin(pc[:b], nodes[:b], True)[1].long()
            fs = [torch.from_numpy(rng.normal(size=(b, 5000, c)).astype(
                np.float32)).to(dev) for c in (64, 128)]
            for f in fs:
                got = kernels.scatter_max(f, ids, 512)
                ref = kernels.scatter_max_plain(f, ids, 512)
                sync()
                check(torch.equal(got, ref), f"{label} C={f.shape[-1]}: "
                      "equals scatter_reduce amax")
            run = lambda fs=fs, i=ids: [kernels.scatter_max(f, i, 512)  # noqa: E731
                                        for f in fs]
            plain = lambda fs=fs, i=ids: [  # noqa: E731
                kernels.scatter_max_plain(f, i, 512) for f in fs]
            lib = graph_ms(plain, 20)
            bnd = bound(sum(b * 5000 * c * 4 + b * 5000 * 8 + b * 512 * c * 4
                            for c in (64, 128)), 0, FP32_FLOPS)
        out[label] = {"ms": graph_ms(run, 20), "plain_ms": time_ms(plain, 3),
                      "library_ms": lib, "events_ms": time_ms(run, 20),
                      "bound_ms": bnd[0], "bound_by": bnd[1]}
        r = out[label]
        print(f"[14] {card} | {label}: identical to plain"
              f"{' (K3 within its bound)' if name == 'fusion_chain' else ''}"
              f"; kernel {r['ms']:.4f} ms (back-to-back events "
              f"{r['events_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"library {'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bnd[0]:.4f} ms by {bnd[1]}", flush=True)
    return errs, out


def object_batch(cfg, b, dev, seed):
    src_pc, src_sn, dst_pc, dst_sn = object_shapes(b, seed)
    return DetectorBatch(*(torch.from_numpy(a).to(dev)
                           for a in (src_pc, src_sn, dst_pc, dst_sn)))


def object_step(card):
    """The modelnet preset's train step at full width: five bf16 steps with
    each kernel's launches a step checked, one fp32 step (batch 2) on the
    card against the CPU under deterministic algorithms, the step's time,
    split, peak memory and device busy share."""
    dev = torch.device("cuda")
    cfg = get_config("modelnet")
    b = cfg.train.batch_size
    check((cfg.data.input_pc_num, cfg.data.node_num, cfg.detector.c1,
           cfg.detector.c2, cfg.detector.node_knn_k, b,
           cfg.detector.compute_dtype, cfg.augment.rot_3d)
          == (5000, 512, 128, 512, 32, 8, "bfloat16", True),
          "the modelnet preset at full width")
    batch = object_batch(cfg, b, dev, 31)
    state = train_state(cfg, dev)
    step = eager_detector(make_detector_train_step(cfg), cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels.reset_launch_counts()
    history = [step(state, batch, 0, generator=gen)
               for _ in range(OBJECT_STEPS)]
    sync()
    launches = dict(kernels.LAUNCHES)
    losses = [float(h["loss"]) for h in history]
    print(f"[14] train modelnet bf16 batch {b} ({2 * b} shapes of 5000 "
          f"points, rot_3d), {OBJECT_STEPS} steps: losses {losses}; "
          f"launches {launches} ({OBJECT_STEP_LAUNCHES} a step expected)",
          flush=True)
    check(all(all(bool(torch.isfinite(v)) for v in h.values())
              for h in history), "every object train metric finite")
    check(launches == {k: n * OBJECT_STEPS
                       for k, n in OBJECT_STEP_LAUNCHES.items()},
          "the object step's launches a step")

    cfg32 = get_config("modelnet", **OBJECT_FP32)
    batch2 = object_batch(cfg32, 2, "cpu", 32)
    res, grads = {}, {}
    for device in ("cuda", "cpu"):
        st = train_state(cfg32, device)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            res[device] = eager_detector(
                make_detector_train_step(cfg32), cfg32)(
                st, DetectorBatch(*(t.to(device) for t in batch2)), 0,
                generator=torch.Generator().manual_seed(SEED + 1))
        finally:
            torch.use_deterministic_algorithms(False)
        grads[device] = {n: p.grad.detach().double().cpu() for n, p in
                         st.model.named_parameters() if p.grad is not None}
    gpu, cpu = ({k: float(v) for k, v in res[d].items()}
                for d in ("cuda", "cpu"))
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-30) for k in cpu}
    worst, low, leaf = grad_errors("fp32 object step", grads)
    print(f"[14] train modelnet fp32 batch 2, one step on the card and on "
          f"the CPU (deterministic algorithms): card {json.dumps(gpu)}, CPU "
          f"{json.dumps(cpu)}, relative differences {json.dumps(rel)} "
          f"(tolerance: loss and its parts 1e-4, grad_norm 1e-3); gradients "
          f"of {len(leaf)} parameters: worst {worst[0]:.3e} ({worst[1]}), "
          f"lowest cosine {low[0]:.9f} ({low[1]}) (tolerance "
          f"{GRAD_TOL[1]:g}, cosine >= {GRAD_TOL[2]})", flush=True)
    for k, r in rel.items():
        check(r <= (1e-3 if k == "grad_norm" else 1e-4),
              f"fp32 object step {k} on the card within tolerance of the CPU")
    check(worst[0] <= GRAD_TOL[1] and low[0] >= GRAD_TOL[2], "fp32 object "
          "step gradients on the card within tolerance of the CPU")

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
    split = event_split(
        lambda: step(state, batch, 0, generator=gen),
        EAGER_ROUTE_SPANS + DETECTOR_STEP_SPANS, iters)
    busy, ops, _ = profile_busy(lambda: step(state, batch, 0,
                                             generator=gen), 2)
    print(f"[14] {card} | train step modelnet bf16 batch {b}: {step_ms:.3f} "
          f"ms a step (mean of {iters}, pipelined), "
          f"{2 * b * 1e3 / step_ms:.2f} clouds/s; split (ms): "
          + json.dumps({k: round(v, 4) for k, v in split.items()})
          + f"; peak memory {peak:.0f} MiB; kernels {busy:.3f} ms a step on "
          f"the device ({busy / step_ms:.4f} of the step); by operator: "
          + json.dumps([[k, round(t, 4), c] for t, c, k in ops[:8]]),
          flush=True)
    return launches


def object_entry(card, tmp):
    """``train-detector --dataset shrec|modelnet --synthetic --epochs 1``
    through ``cli.main`` in process, each with its launch counts."""
    launches = {}
    for name in ("shrec", "modelnet"):
        ckpt_dir = os.path.join(tmp, "ckpt_object")
        out_dir = os.path.join(ckpt_dir, name)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["train-detector", "--dataset", name, "--synthetic",
                      "--epochs", "1", "--name", name, "--checkpoints-dir",
                      ckpt_dir, "--device", "cuda", "--override",
                      "train.log_every=4"])
        sync()
        wall = time.perf_counter() - t0
        launches[f"object_{name}"] = dict(kernels.LAUNCHES)
        with open(os.path.join(out_dir, "config.json")) as f:
            saved = json.load(f)
        # shrec trains under the object preset, the modelnet recipe
        check((saved["data"]["input_pc_num"], saved["data"]["node_num"],
               saved["detector"]["c1"], saved["detector"]["c2"],
               saved["detector"]["node_knn_k"], saved["augment"]["rot_3d"])
              == (5000, 512, 128, 512, 32, True),
              f"train-detector --dataset {name} at full width")
        recs = read_jsonl(os.path.join(out_dir, f"{name}_metrics.jsonl"))
        losses = [r["loss"] for r in recs if "loss" in r]
        check(bool(losses) and all(np.isfinite(losses)),
              f"train-detector --dataset {name}: every loss finite")
        check(find_checkpoint(out_dir) is not None,
              f"train-detector --dataset {name} wrote a checkpoint")
        for k in PATH_KERNELS["engine"]:
            check(launches[f"object_{name}"][k] > 0,
                  f"{k} launched by train-detector --dataset {name}")
        print(f"[14] {card} | train-detector --dataset {name} --synthetic "
              f"--epochs 1 --device cuda (in process): {wall:.1f} s, "
              f"losses {[round(x, 4) for x in losses]}, launches "
              f"{launches[f'object_{name}']}", flush=True)
    return launches


def fullscale_arms(card, tmp, root, ckpt):
    """``python -m usip_tpu_torch.fullscale eval`` and ``eval-reg --yaw``
    in process on phase 7's tree, detector and phase 9's descriptor (in the
    protocol's checkpoint layout), each arm's launches counted."""
    for sub, src in (("fullscale", ckpt), ("fullscale_descriptor", os.path.join(
            tmp, "ckpt_desc", "kitti_descriptor", "best.pt"))):
        os.makedirs(os.path.join(root, "ckpt", sub), exist_ok=True)
        shutil.copy(src, os.path.join(root, "ckpt", sub, "best.pt"))
    launches = {}

    def counted(fn, at):
        """``fn`` with the launches of each call kept under the basename of
        its output directory, its positional argument ``at``."""
        def run(*args, **kw):
            kernels.reset_launch_counts()
            out = fn(*args, **kw)
            sync()
            launches[os.path.basename(args[at])] = dict(kernels.LAUNCHES)
            return out
        return run

    # the output directory: _export_and_rep(cfg, checkpoint, out_dir, ...),
    # _export_and_reg(cfg, det_ckpt, desc_ckpt, out_root, ...)
    saved = {"_export_and_rep": 2, "_export_and_reg": 3}
    saved = {k: (getattr(fullscale, k), at) for k, at in saved.items()}
    try:
        for k, (fn, at) in saved.items():
            setattr(fullscale, k, counted(fn, at))
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            ev = fullscale.main(["eval", "--root", root, "--device", "cuda"])
        t_eval = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            reg = fullscale.main(["eval-reg", "--yaw", "--root", root,
                                  "--device", "cuda"])
        t_reg = time.perf_counter() - t0
    finally:
        for k, (fn, _) in saved.items():
            setattr(fullscale, k, fn)
    dirs = {"trained_defaults": "kp_default", "trained_fp32_exact": "kp_exact",
            "untrained_defaults": "kp_untrained",
            "random_keypoints": "kp_random", "trained_desc": "reg_trained",
            "untrained_desc": "reg_untrained",
            "trained_desc_yaw": "reg_trained_yaw",
            "untrained_desc_yaw": "reg_untrained_yaw"}
    arm_launches = {arm: launches[d] for arm, d in dirs.items()}
    check(set(ev) == {"phase", "pairs", *FULLSCALE_EVAL_ARMS,
                      "default_vs_exact_delta"}
          and all(ev[a]["pairs"] == ev["pairs"] > 0
                  and 0.0 <= ev[a]["repeatability"] <= 1.0
                  for a in FULLSCALE_EVAL_ARMS),
          f"fullscale eval's arms {ev}")
    check(set(reg) == {"phase", "pairs", "desc_name", *FULLSCALE_REG_ARMS}
          and all(reg[a]["total"] == reg["pairs"] > 0
                  and 0.0 <= reg[a]["success_rate"] <= 1.0
                  for a in FULLSCALE_REG_ARMS),
          f"fullscale eval-reg's arms {reg}")
    for arm, counts in arm_launches.items():
        want = PATH_KERNELS["export"] if arm != "random_keypoints" else ()
        check(all(counts[k] > 0 for k in want)
              and (want or not any(counts.values())),
              f"fullscale arm {arm} launches {counts}")
    print(f"[14] {card} | python -m usip_tpu_torch.fullscale eval (in "
          f"process, phase 7's tree and detector, {ev['pairs']} pairs) in "
          f"{t_eval:.1f} s: " + json.dumps({a: ev[a]["repeatability"]
                                          for a in FULLSCALE_EVAL_ARMS}),
          flush=True)
    print(f"[14] {card} | python -m usip_tpu_torch.fullscale eval-reg --yaw "
          f"(phase 9's descriptor) in {t_reg:.1f} s: "
          + json.dumps({a: [reg[a]["success_rate"],
                            reg[a]["inlier_ratio_mean"]]
                        for a in FULLSCALE_REG_ARMS})
          + " (success, inlier ratio)", flush=True)
    print(f"[14] fullscale launches by arm: {json.dumps(arm_launches)}",
          flush=True)
    return {f"fullscale_{a}": c for a, c in arm_launches.items()}


def som_check(card):
    """``SOMTrainer`` (its defaults) on the card against the CPU on the same
    8 object shapes, fp32, the card under deterministic algorithms."""
    from usip_tpu_torch.ops.som import SOMTrainer
    x = object_shapes(8, 33)[0]
    nodes = {}
    for device in ("cuda", "cpu"):
        trainer = SOMTrainer(device=device)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            t0 = time.perf_counter()
            nodes[device] = trainer.optimize(x)
            if device == "cuda":
                sync()
            wall = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
        nodes[device] = nodes[device].cpu().double().numpy()
        print(f"[14] SOMTrainer on {device}: (8, 5000, 3) -> "
              f"{nodes[device].shape}, {trainer.max_iteration // 3} + "
              f"{trainer.max_iteration} updates in {wall:.2f} s", flush=True)
    diff = np.abs(nodes["cuda"] - nodes["cpu"]).max(-1)
    gap = float(diff.max())
    ids = {d: np.argmin(((x[:, :, None] - n[:, None]) ** 2).sum(-1), -1)
           for d, n in nodes.items()}
    flips = float((ids["cuda"] != ids["cpu"]).mean())
    print(f"[14] SOMTrainer card against CPU: max |nodes diff| {gap:.3e} "
          f"(tolerance {SOM_TOL:g}), nodes beyond 1e-4 "
          f"{int((diff > 1e-4).sum())} of {diff.size}, points whose final "
          f"node differs {flips:.6f} (tolerance {SOM_FLIPS:g})", flush=True)
    check(np.isfinite(nodes["cuda"]).all() and gap <= SOM_TOL
          and flips <= SOM_FLIPS, "SOMTrainer on the card matches the CPU")


def render_contract(card, tmp, root, ckpt):
    """``export-keypoints --with-sigmas``, ``render-keypoints --kp-dim 4``
    and ``detect --render --html`` on two clouds; where matplotlib is
    absent, both renders must raise its ImportError."""
    import importlib.util
    kp4 = os.path.join(tmp, "kp_sigmas")
    kernels.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["export-keypoints", "--dataset", "kitti", "--dataroot",
                  root, "--checkpoint", ckpt, "--out", kp4,
                  "--with-sigmas", "--device", "cuda"])
    sync()
    launches = {"sigma_export": dict(kernels.LAUNCHES)}
    stats = json.loads(buf.getvalue().strip().splitlines()[-1])
    rows = [np.fromfile(os.path.join(d, f), np.float32).reshape(-1, 4)
            for d, _, fs in os.walk(kp4) for f in fs]
    # the detector's keypoints by ascending sigma, then any rows padded from
    # the cloud (sigma inf)
    fin = [r[np.isfinite(r[:, 3]), 3] for r in rows]
    check(stats["frames"] == len(rows) > 0
          and all(r.shape == (128, 4) and np.all(np.diff(f) >= 0)
                  and np.isfinite(r[:len(f), 3]).all()
                  for r, f in zip(rows, fin)),
          "export-keypoints --with-sigmas: 128 rows of (xyz, sigma) a "
          "frame, sigmas ascending")
    for name in PATH_KERNELS["export"]:
        check(launches["sigma_export"][name] > 0,
              f"{name} launched by export-keypoints --with-sigmas")
    clouds = os.path.join(tmp, "render_clouds")
    os.makedirs(clouds)
    rng = np.random.default_rng(14)
    for i in range(2):
        pc, sn = kitti_cloud(rng, 1, 20000)
        np.save(os.path.join(clouds, f"c{i}.npy"),
                np.concatenate([pc[0], sn[0]], -1))
    render = ["render-keypoints", "--dataset", "kitti", "--dataroot", root,
              "--kp-dir", kp4, "--kp-dim", "4", "--out",
              os.path.join(tmp, "gallery")]
    detect = ["detect", "--input", clouds, "--out",
              os.path.join(tmp, "rendered"), "--dataset", "kitti",
              "--checkpoint", ckpt, "--render", "--html", "--device", "cuda"]
    print(f"[14] export-keypoints --with-sigmas: {json.dumps(stats)}, "
          f"launches {launches['sigma_export']}", flush=True)
    if importlib.util.find_spec("matplotlib") is None:
        for argv in (render, detect):
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    cli.main(argv)
            except ImportError as e:
                check("matplotlib" in str(e), f"{argv[0]} raised {e!r}")
            else:
                check(False, f"{argv[0]} without matplotlib must raise")
        print("[14] render: not run, matplotlib absent on this host",
              flush=True)
        return launches
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(render)
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(res["rendered"] == len(rows) and os.path.exists(res["html"]),
          f"render-keypoints {res}")
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(detect)
    files = sorted(os.listdir(os.path.join(tmp, "rendered")))
    check(files == ["c0.keypoints.bin", "c0.png", "c1.keypoints.bin",
                    "c1.png", "index.html"], f"detect --render --html {files}")
    print(f"[14] render-keypoints --kp-dim 4: {json.dumps(res)}; detect "
          f"--render --html: {files}", flush=True)
    return launches


def phase14(card, tmp, root, ckpt):
    """The full-scale protocol's eval arms on phase 7's tree, the object
    presets in training, SOMTrainer and the render contract."""
    errs, times = object_kernels(card, np.random.default_rng(14))
    launches = {"object_step": object_step(card)}
    launches.update(object_entry(card, tmp))
    launches.update(fullscale_arms(card, tmp, root, ckpt))
    som_check(card)
    launches.update(render_contract(card, tmp, root, ckpt))
    return launches, errs, times


# --------------------------------------------------------------- phase 15 --
# the host data path: the native batch loader's checks at KITTI's parent
# size (a batch of 8 parents of 20480 points, 8 columns on disk, sn 4), and
# the kernels a KITTI engine step launches
NATIVE_BATCH = 8
ENGINE_STEP_LAUNCHES = {"fps": 2, "min_argmin": 5, "fusion_chain": 0,
                        "smallest_k": 1, "scatter_max": 2,
                        "batch_norm": 7 * 10}


@contextlib.contextmanager
def numpy_loader():
    """The loaders' numpy path: ``native.available`` off for the block."""
    saved = native.available
    native.available = lambda: False
    try:
        yield
    finally:
        native.available = saved


def native_checks(card, tmp, root):
    """The host library loaded from ``build/``, a fresh build of it timed,
    and its checks at KITTI's parent size; its call's host ms."""
    check(native.available(), "the host library loads (native.available())")
    lib = native.library_path()
    check(os.path.dirname(lib) == str(_build.BUILD_DIR),
          f"the host library is the port's build under build/: {lib}")
    t0 = time.perf_counter()
    fresh = _build.build_host(os.path.join(tmp, "host_build"))
    built = time.perf_counter() - t0
    print(f"[15] host library {lib} loaded (built in phase 1); a fresh g++ "
          f"build of csrc/host/usip_native.cpp ({fresh.name}): {built:.2f} s",
          flush=True)
    cfg = get_config("kitti", **{"data.dataroot": root})
    ds = make_detector_dataset("kitti", cfg.data, "train",
                               cfg.detector.surface_normal_len)
    paths = [ds.item_path(i) for i in range(NATIVE_BATCH)]
    p, sn_len = cfg.data.parent_pc_num, cfg.detector.surface_normal_len
    seed = 2 ** 62 + 2026
    times = {}
    out = {}
    for threads in (1, 0):
        t0 = time.perf_counter()
        out[threads] = native.batch_load_subsample(paths, p, sn_len,
                                                   seed=seed, threads=threads)
        times[threads] = (time.perf_counter() - t0) * 1e3
    check(all(a.tobytes() == b.tobytes() for a, b in zip(out[1], out[0])),
          "batch_load_subsample: threads=1 and threads=0 byte-identical")
    t0 = time.perf_counter()
    half = native.batch_load_subsample(paths, p, sn_len, seed=seed,
                                       dtype=np.float16)
    times["f16"] = (time.perf_counter() - t0) * 1e3
    check(all(h.dtype == np.float16 and h.tobytes()
              == f.astype(np.float16).tobytes()
              for h, f in zip(half, out[0])),
          "the fp16 wire is astype(float16) of the fp32 output")
    for b, path in enumerate(paths):
        data = np.load(path).astype(np.float32)[:, :3 + sn_len]
        rows = np.concatenate([out[0][0][b], out[0][1][b]], axis=1)
        have = {}
        for r in data:
            have[r.tobytes()] = have.get(r.tobytes(), 0) + 1
        seen = {}
        for r in rows:
            k = r.tobytes()
            check(k in have, f"row of {path} not in its file")
            seen[k] = seen.get(k, 0) + 1
        short = len(data) < p
        check(short or all(seen[k] <= have[k] for k in seen),
              f"{path}: a row repeated though the file holds {len(data)} "
              f"rows")
    print(f"[15] batch_load_subsample {NATIVE_BATCH} x {p} points, sn "
          f"{sn_len}: threads=1 {times[1]:.1f} ms, one a core "
          f"{times[0]:.1f} ms, fp16 wire {times['f16']:.1f} ms (host); "
          "byte-identical over threads, fp16 = astype(float16) of fp32, "
          "every row a row of its file", flush=True)


def loader_epochs(card, tmp, root, step_rate):
    """One KITTI ``DetectorEngine`` epoch on each host path: clouds/s, idle
    share (phase 7's method), launches a step, batches ``get_batch``
    served."""
    cfg = get_config("kitti", **{"data.dataroot": root,
                                 "train.log_every": 100})
    train, test = cli._make_loaders(
        cfg, types.SimpleNamespace(synthetic=False),
        cfg.detector.surface_normal_len)
    engine = DetectorEngine(cfg, train, test,
                            out_dir=os.path.join(tmp, "engine15"),
                            device="cuda")
    engine.train_epoch(0)  # warm-up
    sync()
    steps = len(train)
    rates = {}
    for label in ("native", "numpy"):
        with (numpy_loader() if label == "numpy"
              else contextlib.nullcontext()):
            train.served = {"get_batch": 0, "items": 0}
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            avg = engine.train_epoch(1)
            sync()
            wall = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            served = dict(train.served)
            busy, _, pwall = profile_busy(lambda: engine.train_epoch(2), 1)
        check(all(np.isfinite(list(avg.values()))),
              f"{label} epoch metrics finite")
        want = ({"get_batch": steps, "items": 0} if label == "native"
                else {"get_batch": 0, "items": steps})
        check(served == want, f"{label} epoch: batches served {served}, "
              f"expected {want}")
        for name, per in ENGINE_STEP_LAUNCHES.items():
            check(launches[name] == per * steps,
                  f"{label} epoch: {name} launched {launches[name]} times "
                  f"in {steps} steps, expected {per} a step")
        rate = 2 * cfg.train.batch_size * steps / wall
        idle = 1.0 - busy / (wall * 1e3)
        rates[label] = rate
        print(f"[15] {card} | engine epoch on the {label} host path, "
              f"{steps} steps: {rate:.2f} clouds/s ({wall / steps * 1e3:.3f}"
              f" ms a step; bare step {step_rate:.2f}); device busy "
              f"{busy:.3f} ms ({pwall * 1e3:.3f} ms profiled), idle share "
              f"{idle:.4f} of {wall * 1e3:.3f} ms; launches a step "
              + json.dumps({k: v / steps for k, v in launches.items()})
              + f"; batches served {json.dumps(served)}", flush=True)
    return rates


def phase15(card, tmp, root, step_rate):
    """The host data path: the native batch loader's build and checks, and
    the KITTI engine on it and on the numpy path."""
    native_checks(card, tmp, root)
    return loader_epochs(card, tmp, root, step_rate)


def nccl_two_card(rank, world, arg):
    """The data-parallel detector step over 2 cards under NCCL (where the
    host has them): its losses."""
    from usip_tpu_torch.parallel import make_mesh, shard_batch
    mesh = make_mesh(world)
    cfg = get_config("kitti", **{"train.num_devices": world})
    full = parent_batch(np.random.default_rng(127), cfg, 8, mesh.device)
    state = train_state(cfg, mesh.device)
    step = make_detector_train_step(cfg, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(SEED)
    return [float(step(state, shard_batch(mesh, full), 0,
                       generator=gen)["loss"]) for _ in range(3)]


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
        batch_norm_kernels(card)
        lap("6 BatchNorm kernels")
        launches["engine"], root, ckpt = phase7(card, tmp, step_rate)
        lap("7 engine")
        launches["export"] = phase8(card, tmp, root, ckpt)
        lap("8 export, quality gate")
        launches["descriptor"], desc_rate = phase9_step(card)
        lap("9 descriptor step")
        launches.update(phase9_engine(card, tmp, root, ckpt, desc_rate))
        lap("9 descriptor entry points, quality gate")
        indoor_launches, indoor_times = phase10(card, tmp)
        launches.update(indoor_launches)
        lap("10 indoor pipeline")
        ox_launches, ox_k4, ox_k5 = phase11(card, tmp)
        launches.update(ox_launches)
        lap("11 Oxford grouped training, SOM k=2")
        rank_launches, shard_k4 = phase12(card, tmp, ckpt)
        launches.update(rank_launches)
        lap("12 ranks")
        launches.update(phase13(card, tmp))
        lap("13 deployment")
        object_launches, object_errs, object_times = phase14(
            card, tmp, root, ckpt)
        launches.update(object_launches)
        for name, err in object_errs.items():
            errs[name] = max(errs[name], err)
        lap("14 full-scale arms, object presets, SOM, render")
        phase15(card, tmp, root, step_rate)
        lap("15 host data path")
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
                 launches["descriptor_export"][name],
             "launches_per_indoor_detector_step": (
                 launches["indoor_detector"][name] / INDOOR_STEPS),
             "launches_per_indoor_descriptor_step": (
                 launches["indoor_descriptor"][name] / INDOOR_STEPS),
             "launches_indoor_engine_epoch": launches["indoor_engine"][name],
             "launches_fragment_export": launches["fragment_export"][name],
             "launches_per_oxford_step": {
                 g: launches[f"oxford_{g}"][name] / OX_STEPS
                 for g in OX_GROUPED},
             "launches_per_som_k2_step": (launches["som_k2"][name]
                                          / SOM_K_STEPS),
             "launches_oxford_engine_epoch": launches["oxford_engine"][name],
             "launches_oxford_export": launches["oxford_export"][name],
             "indoor_shapes": {label: t for label, t in indoor_times.items()
                               if INDOOR_SHAPES[label][0] == name},
             "launches_rank0": {tag: launches[tag][name]
                                for tag in RANK_LAUNCH_TAGS},
             "launches_per_artifact_call": {
                 tag: launches[f"artifact_{tag}"][name]
                 for tag in DEPLOY_KERNELS},
             "object_shapes": {label: t for label, t in object_times.items()
                               if OBJECT_SHAPES[label][0] == name},
             "launches_per_object_step": (launches["object_step"][name]
                                          / OBJECT_STEPS),
             "launches_object_train_detector": {
                 d: launches[f"object_{d}"][name]
                 for d in ("shrec", "modelnet")},
             "launches_fullscale": {
                 arm: launches[f"fullscale_{arm}"][name]
                 for arm in (*FULLSCALE_EVAL_ARMS, *FULLSCALE_REG_ARMS)
                 if f"fullscale_{arm}" in launches},
             "launches_sigma_export": launches["sigma_export"][name]}
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
    # the grouped train steps' shapes: ball and knn grouping (16, 512,
    # 16384) k=64, the node kNN (16, 512, 512) k=16, SOM k=2's assignment
    # (16, 16384, 512) k=2
    line[3]["oxford_train_shapes"] = ox_k4
    # K5 at the SOM k=2 step's stacked ids (16, 32768), C=64 + 128
    line[4]["som_k2_stacked"] = ox_k5
    # K4 at the sharded gathers' local select (8, 512, 8192) k=64
    line[3]["sharded_gather"] = shard_k4
    print(json.dumps({"kernels": line}), flush=True)
    check(not DEFERRED, "; ".join(DEFERRED))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
