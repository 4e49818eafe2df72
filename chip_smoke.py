"""On-card smoke run of the PyTorch/CUDA port (usip_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line or more each, in order; any failed check raises and the
script exits nonzero without the final ``ok`` line:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   refuses to run without CUDA;
1. builds the three CUDA kernels from ``usip_tpu_torch/csrc`` into a clean
   build directory;
2. holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes (FPS and min/argmin exactly, the fused chain within
   a stated tolerance);
3. runs the whole fp32 forward at full KITTI width (B=2) on the card and on
   the CPU with the same seeded weights, draws and input, and compares;
4. serves 3 requests through ``python -m usip_tpu_torch.cli serve --device
   cuda`` and drives ``KeypointPipeline.detect`` in process, with the kernel
   launch counts reset before and read after;
5. times each kernel against its plain version, the stages of the batch-8
   forward, and detect clouds/s with the bench protocol (bf16 preset).

The second-to-last line is a JSON object with one entry per kernel; the last
is ``{"ok": true, "device": {...}}``.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from usip_tpu_torch import _build  # noqa: E402
from usip_tpu_torch.config import get_config  # noqa: E402
from usip_tpu_torch.inference import KeypointPipeline  # noqa: E402
from usip_tpu_torch.models import Detector  # noqa: E402
from usip_tpu_torch.models.detector import knn_group  # noqa: E402
from usip_tpu_torch.models.fused_infer import detector_infer_fused  # noqa: E402
from usip_tpu_torch.ops import kernels, sample_nodes  # noqa: E402
from usip_tpu_torch.weights import seeded_state_dict  # noqa: E402

B_BENCH = 8
SEED = 0


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


def seeded_detector(cfg, device):
    det = Detector(cfg.detector)
    det.load_state_dict({k: torch.tensor(v) for k, v in
                         seeded_state_dict(cfg.detector, SEED).items()},
                        strict=True)
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

    # K1: (8, 2048) -> 512 picks, random clouds and duplicated points
    pts, _ = kitti_cloud(rng, B_BENCH, 2048)
    dup = np.concatenate([pts[:, :1024], pts[:, :1024]], axis=1)
    worst = 0
    for name, p in (("random", pts), ("duplicated", dup)):
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

    # K2: (8, 16384) points x (8, 512) nodes taken from them
    pc, _ = kitti_cloud(rng, B_BENCH, 16384)
    pc = torch.from_numpy(pc).to(dev)
    sel = torch.from_numpy(np.stack([rng.choice(16384, 512, replace=False)
                                     for _ in range(B_BENCH)])).to(dev)
    nodes = torch.gather(pc, 1, sel[..., None].expand(-1, -1, 3)).contiguous()
    worst = 0.0
    for bf16 in (False, True):
        mins, idx = kernels.min_argmin(pc, nodes, bf16)
        rmins, ridx = kernels.min_argmin_plain(pc, nodes, bf16)
        sync()
        mism = int((idx != ridx).sum())
        err = float((mins - rmins).abs().max())
        print(f"[2] K2 min_argmin round_bf16={bf16}: (8, 16384) x 512, "
              f"{mism} argmins differ, max |min diff| {err}", flush=True)
        check(mism == 0, f"min_argmin round_bf16={bf16} argmin identical")
        check(torch.equal(mins, rmins), f"min_argmin round_bf16={bf16} "
              "mins bit-identical")
        worst = max(worst, err)
    errs["min_argmin"] = worst

    # K3: (8, 512, 16, 131) with the seeded detector's folded weights
    det = seeded_detector(cfg, dev)
    ws, bs = kernels.fusion_chain_params(det.knnlayer_1)
    c1 = cfg.detector.c1
    grouped = np.concatenate(
        [rng.normal(0, 5, size=(B_BENCH, 512, 16, 3)),
         np.abs(rng.normal(size=(B_BENCH, 512, 16, c1)))], -1)
    grouped = torch.from_numpy(grouped.astype(np.float32)).to(dev)
    got = kernels.fusion_chain(grouped, ws, bs)
    ref = kernels.fusion_chain_plain(grouped, ws, bs)
    sync()
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
    return errs


def phase3():
    """Full-width fp32 forward, card (kernels) against CPU (plain)."""
    cfg = get_config("kitti", **{"detector.compute_dtype": "float32"})
    rng = np.random.default_rng(2)
    b, n = 2, cfg.data.input_pc_num
    sub = n // cfg.data.fps_subsample_ratio
    pc, sn = kitti_cloud(rng, b, n)
    subset = np.stack([rng.permutation(n)[:sub] for _ in range(b)])
    first = rng.integers(0, sub, b).astype(np.int32)
    outs = []
    for device in ("cuda", "cpu"):
        det = seeded_detector(cfg, device)
        to = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
        with torch.inference_mode():
            node = sample_nodes(to(pc), cfg.data.node_num,
                                cfg.data.fps_subsample_ratio,
                                subset_idx=to(subset), first=to(first))
            res = detector_infer_fused(det, to(pc), to(sn), node)
        outs.append([t.cpu() for t in (node,) + tuple(res)])
    (node_g, anc_g, kp_g, sig_g), (node_c, anc_c, kp_c, sig_c) = outs
    check(torch.equal(node_g, node_c), "nodes identical on card and CPU")
    anc_err = float((anc_g - anc_c).abs().max())
    print(f"[3] slice fp32 (2, 16384) -> 512: nodes identical, anchors max "
          f"|diff| {anc_err}", flush=True)
    check(anc_err <= 1e-4, "anchors within 1e-4")
    for name, g, c in (("keypoints", kp_g, kp_c), ("sigmas", sig_g, sig_c)):
        check(bool(torch.isfinite(g).all()), f"{name} finite")
        scale = float(c.abs().max())
        err = (g - c).abs()
        print(f"[3] {name}: max|ref| {scale}, max |diff| {float(err.max())},"
              f" median |diff| {float(err.median())}", flush=True)
        check(float(err.max()) <= 2e-2 * scale, f"{name} max within 2e-2")
        check(float(err.median()) <= 2e-3 * scale, f"{name} median within "
              "2e-3")
    # the offsets depend on the trunk: keypoints are not just the anchors
    off = float((kp_c - anc_c).abs().max())
    check(off > 1e-2, "keypoint offsets nontrivial")
    print(f"[3] max |keypoint - anchor| {off}", flush=True)


def phase4(cfg, tmp):
    """Serve 3 requests over the CLI, then the in-process main path with the
    launch counts reset before and read after."""
    ckpt = os.path.join(tmp, "detector.pth")
    torch.save({k: torch.tensor(v) for k, v in
                seeded_state_dict(cfg.detector, SEED).items()}, ckpt)
    rng = np.random.default_rng(3)
    clouds = []
    for i in range(3):
        pc, sn = kitti_cloud(rng, 1, 20000)
        path = os.path.join(tmp, f"cloud{i}.npy")
        np.save(path, np.concatenate([pc[0], sn[0]], -1))
        clouds.append(path)
    nk = 128
    out_dir = os.path.join(tmp, "served")
    reqs = [{"id": i, "input": c, "out": out_dir, "num_keypoints": nk}
            for i, c in enumerate(clouds)] + [{"cmd": "shutdown"}]
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "usip_tpu_torch.cli", "serve", "--device",
         "cuda", "--dataset", "kitti", "--checkpoint", ckpt],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO, env=env)
    try:
        stdout, stderr = proc.communicate(
            "".join(json.dumps(r) + "\n" for r in reqs), timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"serve exited {proc.returncode}: "
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
    print(f"[4] serve --device cuda: 3 requests answered, {nk} keypoints "
          f"each, .bin files written ({time.perf_counter() - t0:.1f} s with "
          "start-up)", flush=True)

    pipe = KeypointPipeline(cfg, ckpt, "cuda")
    kernels.reset_launch_counts()
    for c in clouds:
        data = np.load(c)
        kp, sig = pipe.detect(data[:, :3], data[:, 3:], num_keypoints=nk)
        check(kp.shape == (nk, 3) and np.isfinite(kp).all(), "detect output")
    sync()
    launches = dict(kernels.LAUNCHES)
    print(f"[4] KeypointPipeline.detect x3 in process: launches {launches}",
          flush=True)
    for name, count in launches.items():
        check(count > 0, f"kernel {name} launched on the main path")
    return pipe, launches


def phase5(cfg, pipe, card):
    dev = torch.device("cuda")
    rng = np.random.default_rng(4)
    times = {}

    pts = torch.from_numpy(kitti_cloud(rng, B_BENCH, 2048)[0]).to(dev)
    first = torch.from_numpy(rng.integers(0, 2048, B_BENCH).astype(
        np.int32)).to(dev)
    times["fps"] = (time_ms(lambda: kernels.fps(pts, first, 512), 50),
                    time_ms(lambda: kernels.fps_plain(pts, first, 512), 3))

    pc = torch.from_numpy(kitti_cloud(rng, B_BENCH, 16384)[0]).to(dev)
    nodes = pc[:, :512].contiguous()
    times["min_argmin"] = (
        time_ms(lambda: kernels.min_argmin(pc, nodes, True), 50),
        time_ms(lambda: kernels.min_argmin_plain(pc, nodes, True), 10))

    ws, bs = pipe._chain
    grouped = torch.from_numpy(np.abs(rng.normal(
        size=(B_BENCH, 512, 16, 3 + cfg.detector.c1))).astype(
            np.float32)).to(dev)
    times["fusion_chain"] = (
        time_ms(lambda: kernels.fusion_chain(grouped, ws, bs), 20),
        time_ms(lambda: kernels.fusion_chain_plain(grouped, ws, bs), 5))
    for name, (k_ms, p_ms) in times.items():
        print(f"[5] {card} | {name}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms (batch 8, main-path shapes)", flush=True)

    # stages of the batch-8 bf16 forward, each timed alone
    pc8_np, sn8_np = kitti_cloud(rng, B_BENCH, cfg.data.input_pc_num)
    pc8 = torch.from_numpy(pc8_np).to(dev)
    sn8 = torch.from_numpy(sn8_np).to(dev)
    det = pipe.detector
    with torch.inference_mode():
        node = sample_nodes(pc8, cfg.data.node_num,
                            cfg.data.fps_subsample_ratio,
                            generator=pipe._gen)
        anchors, feat = det.som_trunk(pc8, sn8, node)
        grouped8 = knn_group(anchors, anchors, feat, cfg.detector.node_knn_k)
        knn_feat = kernels.fusion_chain(grouped8, ws, bs)
        agg = torch.cat([feat, knn_feat], -1)
        stages = {
            "sample_nodes": lambda: sample_nodes(
                pc8, cfg.data.node_num, cfg.data.fps_subsample_ratio,
                generator=pipe._gen),
            "som_trunk": lambda: det.som_trunk(pc8, sn8, node),
            "knn_group": lambda: knn_group(anchors, anchors, feat,
                                           cfg.detector.node_knn_k),
            "fusion_chain": lambda: kernels.fusion_chain(grouped8, ws, bs),
            "head": lambda: det.keypoint_head(agg, anchors),
        }
        parts = {k: time_ms(f, 20) for k, f in stages.items()}
    print(f"[5] {card} | stages of the batch-8 bf16 forward (ms): "
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
    print(f"[5] {card} | detect latency, one 20000-point cloud, 128 "
          f"keypoints: median {np.median(lat):.3f} ms, max {lat[-1]:.3f} ms "
          f"over {lat.size} requests", flush=True)

    # bench.py protocol: batch 8, FPS + detect, best of 3 x 50, one
    # synchronize per pass
    for w in range(2):
        pipe.infer(pc8, sn8)
    sync()
    iters, best = 50, float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = pipe.infer(pc8, sn8)
        sync()
        best = min(best, time.perf_counter() - t0)
    check(bool(torch.isfinite(out[0]).all()), "bench output finite")
    rate = B_BENCH * iters / best
    print(f"[5] {card} | detect bf16 batch 8: {rate:.2f} clouds/s "
          f"({best / iters * 1e3:.3f} ms per batch, best of 3 x {iters}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB",
          flush=True)
    return times


def main():
    card = phase0()
    phase1()
    cfg = get_config("kitti")
    errs = phase2(cfg)
    sync()
    phase3()
    sync()
    tmp = tempfile.mkdtemp(prefix="usip_chip_smoke_")
    try:
        pipe, launches = phase4(cfg, tmp)
        sync()
        times = phase5(cfg, pipe, card)
        sync()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check("jax" not in sys.modules and "flax" not in sys.modules,
          "no jax or flax imported")
    meta = {
        "fps": ("usip_tpu_torch/csrc/fps.cu",
                "usip_tpu/ops/pallas_kernels.py:244"),
        "min_argmin": ("usip_tpu_torch/csrc/min_argmin.cu",
                       "usip_tpu/ops/pallas_kernels.py:56"),
        "fusion_chain": ("usip_tpu_torch/csrc/fusion_chain.cu",
                         "usip_tpu/ops/pallas_kernels.py:146"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in meta.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
