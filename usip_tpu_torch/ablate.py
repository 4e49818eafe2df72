"""Ablations of the FPS (K1), min/argmin (K2), fusion-chain (K3),
smallest-k (K4) and scatter-max (K5) kernels on the card.

    python -m usip_tpu_torch.ablate [--out FILE]

Builds variant copies of ``csrc/*.cu`` (each a set of text patches on the
shipped source, into
``build/usip_tpu_torch/ablate/``), binds each through the same ctypes entry
point as the shipped kernel, and times it with CUDA-graph replay at the
main paths' shapes: K1 at (8, 2048) -> 512 picks on LiDAR-like clouds; K2
at each of its four (the serve assignment (8, 16384) x 512 bf16, the train
step's (16, 16384) x 512 bf16, its keypoint -> cloud (8, 512) x 16384 fp32
and its keypoint chamfer (8, 512) x 512 fp32); K3
at (8, 512, 16, 131) -> (8, 512, 512) with the KITTI widths, K4 at
(8, 512, 16384) k=64 on ball scores of an urban-like cloud, K5 at both calls
of a SOM forward, (8, 16384, 64) and (8, 16384, 128) onto 512 nodes. A
variant may also force the kernel's form (K1's block size and points a
thread, K2's queries a thread and split, K5's cluster size) in place of
``kernels.fps_form``, ``kernels.min_argmin_form`` or
``kernels.scatter_max_form``. Variants that compute the function keep it
(the result is checked against the shipped kernel's: within 1e-2 x max|out|
for K3, identical for K1, K2, K4 and K5); variants that drop a part of the
work (marked "timing only") show what that part costs. Prints one line per
variant and, last, a JSON object of them all; exits nonzero without CUDA or
if a variant's patch no longer applies.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from usip_tpu_torch import _build
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.ops.grouping import ball_scores

OUT_DIR = _build.BUILD_DIR / "ablate"


class Variant(NamedTuple):
    """One build of a kernel: its label, whether it drops part of the work
    (timed, not checked), its text patches ``(old, new)`` on the shipped
    source, and the form it is launched with (None: the wrapper's own)."""
    label: str
    timing_only: bool
    patches: Tuple[Tuple[str, str], ...] = ()
    form: Optional[object] = None


# the step with no per-point work: the chain of reductions, barrier and
# pick loads alone
_FPS_CHAIN = (("    for (int j = 0; j < P; ++j) {\n      float x, y, z;",
               "    for (int j = 0; j < (k < 0 ? P : 0); ++j) {\n"
               "      float x, y, z;"),
              ("    float bv = -1.0f;", "    float bv = fabsf(qx);"))
_FPS_NO_BLOCK_STAGE = (
    "      const Key all = warp_max_key(lane < nwarps ? slot[lane] : 0ull);\n"
    "      cur = static_cast<int>(~static_cast<unsigned>(all));",
    "      cur = static_cast<int>(slot[lane] >> 63);")
K1_VARIANTS = tuple(Variant(*v) for v in (
    ("shipped: 256 threads x 8 points in registers, redux, one barrier",
     False),
    ("the same block built for up to 1024 threads (64 registers)", False,
     (("  if (threads <= kSmallBlock)", "  if (threads <= 0)"),)),
    ("512 threads x 4 points", False, (), kernels.FpsForm(512, 4, True)),
    ("1024 threads x 2 points", False, (), kernels.FpsForm(1024, 2, True)),
    ("128 threads x 16 points", False, (), kernels.FpsForm(128, 16, True)),
    ("128 threads x 16 points, coordinates in shared memory", False, (),
     kernels.FpsForm(128, 16, False)),
    ("five shuffle rounds on the key for redux", False,
     (("constexpr bool kRedux = true;", "constexpr bool kRedux = false;"),)),
    ("two barriers a step (warp 0 reduces, pick through shared memory)",
     False, (("constexpr bool kOneBarrier = true;",
              "constexpr bool kOneBarrier = false;"),)),
    ("no distance update (min against |pick x|)", True,
     (("sqdist(x, y, z, qx, qy, qz)", "fabsf(qx)"),)),
    ("no per-point work: the step chain alone", True, _FPS_CHAIN),
    ("the chain without the cross-warp stage", True,
     _FPS_CHAIN + (_FPS_NO_BLOCK_STAGE,)),
    ("the chain without the warp stage", True,
     _FPS_CHAIN + (("    const Key wkey = warp_max_key(key);",
                    "    const Key wkey = key;"),)),
    ("the chain without the barrier", True,
     _FPS_CHAIN + (("    __syncthreads();\n    if constexpr (kOneBarrier) {",
                    "    if constexpr (kOneBarrier) {"),)),
))


def _k2_form(**fields):
    """The shipped K2 form with ``fields`` replaced at every shape (a split
    above 1 only where the shipped form splits), the tile resized to the
    split's range of candidates (up to the tile cap)."""
    def form(b, n, m):
        f = kernels.MinArgminForm(*_SHIPPED_FORMS["min_argmin"](b, n, m))
        if fields.get("split", 1) > 1 and f.split == 1:
            return f
        f = f._replace(**fields)
        chunk = -(-m // f.split)
        return f._replace(tile=min(kernels._MA_TILE, chunk + chunk % 2))
    return form


K2_VARIANTS = tuple(Variant(*v) for v in (
    ("shipped: 128 threads, packed bf16 keys, queries a thread and split "
     "by min_argmin_form", False),
    *((f"{p} quer{'y' if p == 1 else 'ies'} a thread at every shape",
       False, (), _k2_form(points_per_thread=p)) for p in (1, 2, 4, 8)),
    ("no split: one block takes every candidate", False, (),
     _k2_form(split=1)),
    ("bf16 as float compare and two selects (no packed key)", False,
     (("    if constexpr (BF16) {\n      unsigned kb[P];",
       "    if constexpr (false) {\n      unsigned kb[P];"),
      ("          const float d = fmaxf(dist(px[k], py[k], pz[k], psq[k], "
       "c), 0.0f);\n",
       # round to bf16, then clamp; adding +0 turns a -0 into +0, whose key
       # orders right in the cluster merge
       "          float d = dist(px[k], py[k], pz[k], psq[k], c);\n"
       "          if (BF16) {\n"
       "            unsigned short h;\n"
       "            asm(\"cvt.rn.bf16.f32 %0, %1;\" : \"=h\"(h) : \"f\"(d));\n"
       "            d = __fadd_rn(__uint_as_float(static_cast<unsigned>(h) "
       "<< 16), 0.0f);\n"
       "          }\n"
       "          d = fmaxf(d, 0.0f);\n"),
      ("  if constexpr (!BF16) {\n    if (c_begin < c_end) {",
       "  if constexpr (true) {\n    if (c_begin < c_end) {"))),
    ("split 8 at most (the portable cluster size)", False, (),
     _k2_form(split=8)),
    ("fp32 loop unrolled 4 candidates", False,
     (("#pragma unroll 8\n      for (int j = 0; j < len; ++j) {",
       "#pragma unroll 4\n      for (int j = 0; j < len; ++j) {"),)),
    ("bf16 pair loop unrolled 2 pairs", False,
     (("#pragma unroll 4\n      for (int j = 0; j < len2; j += 2) {",
       "#pragma unroll 2\n      for (int j = 0; j < len2; j += 2) {"),)),
    ("candidates pre-scaled by 2 (exact here, not for subnormal products)",
     False, (("__fsub_rn(psq, __fmul_rn(2.0f, cross))",
              "__fsub_rn(psq, cross)"),
             ("c = make_float4(x, y, z, sq3(x, y, z));",
              "c = make_float4(2.0f * x, 2.0f * y, 2.0f * z, "
              "sq3(x, y, z));"))),
))

_NO_MMA = ("      Wgmma<N>::mma(acc,", "      if (kp < 0) Wgmma<N>::mma(acc,")
K3_VARIANTS = tuple(Variant(*v) for v in (
    ("shipped: clusters of 2, 4 stages", False, ()),
    ("no cluster (each block loads whole slices)", False,
     (("constexpr int kCluster = 2;", "constexpr int kCluster = 1;"),)),
    ("3 weight stages", False,
     (("constexpr int kMaxStages = 4;", "constexpr int kMaxStages = 3;"),)),
    ("cluster-scope release on every stage arrive", False,
     (("mbarrier.arrive.shared::cluster.b64 _, [ra];",
       "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];"),
      ("    mbar_arrive(empty + 8 * s);",
       "    mbar_arrive_cluster(empty + 8 * s, cluster_rank());"))),
    ("no tensor-core work", True, (_NO_MMA,)),
    ("no input load", True,
     (("      load_input(xb, buf_p, rows_valid, cin, kp1, tid);", ""),)),
    ("no node-max pass", True,
     (("        for (int e = tid; e < lay.tm * (c / 2); e += kConsumers) {",
       "        for (int e = tid; e < 0 * lay.tm; e += kConsumers) {"),)),
    ("no epilogues", True,
     (("  store_relu_bf16<N>(acc, out, wg * N, wi, lane);",
       "  if (kp < 0) store_relu_bf16<N>(acc, out, wg * N, wi, lane);"),
      ("  store_node_max<N>(acc, staging, wg * N,",
       "  if (kp < 0) store_node_max<N>(acc, staging, wg * N,"))),
    ("no weight copies, no tensor-core work", True,
     (_NO_MMA,
      ("            mbar_expect_tx(full0 + 8 * stage, bytes);",
       "            mbar_expect_tx(full0 + 8 * stage, 0);"),
      ("            bulk_multicast(ring_base",
       "            if (bytes == 0) bulk_multicast(ring_base"))),
))
K4_VARIANTS = tuple(Variant(*v) for v in (
    ("shipped: first pass with the loads, later passes on a list, "
     "candidates gathered in one scan", False, ()),
    ("candidates always by the two index-ordered scans", False,
     (("constexpr int kGatherCap = 1024;",
       "constexpr int kGatherCap = 0;"),)),
    ("no list: every pass over the row, two-scan candidates", False,
     (("constexpr int kListCap = 2048;", "constexpr int kListCap = 0;"),
      ("constexpr int kGatherCap = 1024;",
       "constexpr int kGatherCap = 0;"))),
    ("no candidate sort", True,
     (("  for (int size = 2; size <= len; size <<= 1) {",
       "  for (int size = 2; size <= (k < 0 ? len : 0); size <<= 1) {"),)),
))
K5_VARIANTS = tuple(Variant(*v) for v in (
    ("shipped: clusters of 4, 32-channel tiles, 8 points a thread in "
     "flight, loads ahead of the atomics, one channel order", False),
    ("clusters of 8", False, (), kernels.ScatterForm(8, 32)),
    ("clusters of 2", False, (), kernels.ScatterForm(2, 32)),
    ("no cluster: one block per (cloud, tile)", False, (),
     kernels.ScatterForm(1, 32)),
    ("channel order rotated by the lane group's slot (no bank conflicts)",
     False, (("constexpr bool kRotate = false;",
              "constexpr bool kRotate = true;"),)),
    ("loads after the atomics", False,
     (("constexpr bool kPrefetch = true;",
       "constexpr bool kPrefetch = false;"),)),
    ("4 points a thread in flight", False,
     (("constexpr int kUnroll = 8;", "constexpr int kUnroll = 4;"),)),
    ("plain shared stores for the atomics", True,
     (("if (cb + ch < ct) atomicMax(cell + ch, e[q]);",
       "if (cb + ch < ct) cell[ch] = e[q];"),)),
    ("no points: launch, accumulator set-up and merge alone", True,
     (("    for (; p0 < p_end; p0 += kStep) {",
       "    for (; p0 < (n < 0 ? p_end : 0); p0 += kStep) {"),
      ("    load(p0, cur);\n", ""))),
))
VARIANTS = {"fps": K1_VARIANTS, "min_argmin": K2_VARIANTS,
            "fusion_chain": K3_VARIANTS, "smallest_k": K4_VARIANTS,
            "scatter_max": K5_VARIANTS}
KERNELS = tuple(VARIANTS)
# the wrapper's form function that a variant's form replaces: a variant's
# form is one form for every call, or a function of the call's shape
_FORM_FNS = {"fps": "fps_form", "min_argmin": "min_argmin_form",
             "scatter_max": "scatter_max_form"}
_SHIPPED_FORMS = {name: getattr(kernels, fn) for name, fn in _FORM_FNS.items()}


def patched_source(name, variant):
    """The text of ``csrc/<name>.cu`` with ``variant``'s patches applied;
    raises if a patch no longer occurs in the shipped source."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in variant.patches:
        if old not in text:
            raise SystemExit(f"{name}: the patch of variant "
                             f"{variant.label!r} no longer applies: {old!r}")
        text = text.replace(old, new)
    return text


def _build_variants(name, variants):
    """One library per distinct patch set (variants that differ only in
    their form share the shipped build), nvcc side by side."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    builds = {}
    for v in variants:
        if v.patches in builds:
            continue
        path = OUT_DIR / f"{name}_{len(builds)}.cu"
        path.write_text(patched_source(name, v))
        lib = path.with_suffix(".so")
        proc = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds[v.patches] = (lib, v.label, proc)
    for _, label, proc in builds.values():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: variant {label!r} failed to build:\n"
                             f"{out}")
    return [builds[v.patches][0] for v in variants]


def _bind(name, lib):
    symbol, argtypes = kernels._SIGNATURES[name]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    kernels._FNS[name] = fn


def graph_ms(fn, iters=20, replays=5):
    """Mean device time of ``fn`` over ``iters`` calls in one CUDA graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def _run(name, variants, calls, same):
    """Each variant at each of ``calls`` (a shape label -> call; one call
    for a kernel timed at one shape), checked against the shipped
    variant's result at that shape."""
    if callable(calls):
        calls = {"": calls}
    libs = _build_variants(name, variants)
    form_fn = _FORM_FNS.get(name)
    shipped_form = _SHIPPED_FORMS.get(name)
    rows, refs = [], {}
    try:
        for v, lib in zip(variants, libs):
            _bind(name, lib)
            if v.form is None:
                form = shipped_form
            elif callable(v.form):
                form = v.form
            else:
                form = lambda *_, f=v.form: f  # noqa: E731
            if form_fn:
                setattr(kernels, form_fn, form)
            for shape, call in calls.items():
                out = call()
                torch.cuda.synchronize()
                ref = refs.setdefault(shape, out)
                ok = None if v.timing_only else bool(same(out, ref))
                ms = graph_ms(call)
                rows.append({"kernel": name, "variant": v.label,
                             "shape": shape, "ms": ms,
                             "timing_only": v.timing_only,
                             "same_result": ok})
                print(f"{name}{' ' + shape if shape else ''}: {v.label}: "
                      f"{ms:.4f} ms" + (" (timing only)" if v.timing_only
                                        else f", same result {ok}"),
                      flush=True)
                if ok is False:
                    raise SystemExit(f"{name}: variant {v.label!r} changed "
                                     f"the result {shape}")
    finally:
        kernels._FNS.pop(name, None)
        if form_fn:
            setattr(kernels, form_fn, shipped_form)
    return rows


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None):
    parser = argparse.ArgumentParser(prog="usip_tpu_torch.ablate")
    parser.add_argument("--out", default=None,
                        help="also write the JSON object to this file")
    parser.add_argument("--kernels", nargs="+", default=list(KERNELS),
                        choices=KERNELS, help="the kernels to ablate")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ablate: CUDA is not available; this runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []
    for name in args.kernels:
        rows += _ABLATIONS[name](dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    result = {"card": smi.splitlines()[0] if smi else "unknown",
              "variants": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


def _ablate_fps(dev):
    # LiDAR-like clouds: xy over a 40 m disc, z near the ground
    rng = np.random.default_rng(0)
    r = 40.0 * np.sqrt(rng.uniform(size=(8, 2048)))
    t = rng.uniform(0, 2 * np.pi, size=(8, 2048))
    pts = torch.from_numpy(np.stack(
        [r * np.cos(t), r * np.sin(t), rng.normal(0, 1.5, (8, 2048))],
        -1).astype(np.float32)).to(dev)
    first = torch.from_numpy(rng.integers(0, 2048, 8).astype(
        np.int32)).to(dev)
    return _run("fps", K1_VARIANTS, lambda: kernels.fps(pts, first, 512),
                torch.equal)


def _ablate_min_argmin(dev):
    # LiDAR-like clouds and nodes among their points; keypoints near them
    rng = np.random.default_rng(3)

    def cloud(b, n):
        r = 40.0 * np.sqrt(rng.uniform(size=(b, n)))
        t = rng.uniform(0, 2 * np.pi, size=(b, n))
        return torch.from_numpy(np.stack(
            [r * np.cos(t), r * np.sin(t), rng.normal(0, 1.5, (b, n))],
            -1).astype(np.float32)).to(dev)

    pc8, pc16 = cloud(8, 16384), cloud(16, 16384)
    nodes8, nodes16 = pc8[:, ::32].contiguous(), pc16[:, ::32].contiguous()
    kp = (nodes8 + torch.from_numpy(rng.normal(0, 0.3, (8, 512, 3)).astype(
        np.float32)).to(dev)).contiguous()
    kp2 = (nodes8 + torch.from_numpy(rng.normal(0, 0.3, (8, 512, 3)).astype(
        np.float32)).to(dev)).contiguous()
    calls = {
        "serve (8, 16384) x 512 bf16":
            lambda: kernels.min_argmin(pc8, nodes8, True),
        "train (16, 16384) x 512 bf16":
            lambda: kernels.min_argmin(pc16, nodes16, True),
        "keypoint->cloud (8, 512) x 16384 fp32":
            lambda: kernels.min_argmin(kp, pc8),
        "chamfer (8, 512) x 512 fp32": lambda: kernels.min_argmin(kp, kp2),
    }
    return _run("min_argmin", K2_VARIANTS, calls, _same)


def _ablate_fusion_chain(dev):
    rng = np.random.default_rng(0)
    cin, c, c2 = 131, 256, 512
    dims = [(cin, c), (c, c), (c, c), (c, c2), (c, c2), (c2, c2)]
    ws = [torch.from_numpy(rng.normal(0, (2.0 / d[0]) ** 0.5, size=d)
                           .astype(np.float32)).to(dev) for d in dims]
    bs = [torch.from_numpy(rng.normal(0, 0.1, size=(d[1],))
                           .astype(np.float32)).to(dev)
          for d in dims[:3] + dims[4:]]
    chain = kernels.prepare_chain(ws, bs)
    x = torch.from_numpy(np.abs(rng.normal(size=(8, 512, 16, cin)))
                         .astype(np.float32)).to(dev)
    return _run("fusion_chain", K3_VARIANTS,
                lambda: kernels.fusion_chain(x, chain),
                lambda a, b: float((a - b).abs().max())
                <= 1e-2 * float(b.abs().max()))


def _ablate_smallest_k(dev):
    rng = np.random.default_rng(1)
    # an urban-like cloud: ground with range-falling density and points
    # scattered up to 4 m high, so that some 2 m balls hold fewer than 64
    # points (+inf picks)
    ng = int(16384 * 0.6)
    r, t = 25.0 * rng.uniform(size=(8, ng)), rng.uniform(0, 6.3, (8, ng))
    ground = np.stack([r * np.cos(t), r * np.sin(t),
                       rng.normal(0, 0.1, (8, ng))], -1)
    poles = np.concatenate([rng.uniform(-18, 18, (8, 16384 - ng, 2)),
                            rng.uniform(0, 4, (8, 16384 - ng, 1))], -1)
    pc = torch.from_numpy(rng.permuted(np.concatenate([ground, poles], 1),
                                       axis=1).astype(np.float32)).to(dev)
    scores = ball_scores(pc, pc[:, :512].contiguous(), 2.0)
    return _run("smallest_k", K4_VARIANTS,
                lambda: kernels.smallest_k(scores, 64), _same)


def _ablate_scatter_max(dev):
    # both calls of a SOM forward, C=64 and C=128, uniform ids onto 512 nodes
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 512, size=(8, 16384))).to(dev)
    fs = [torch.from_numpy(rng.normal(size=(8, 16384, c)).astype(
        np.float32)).to(dev) for c in (64, 128)]
    return _run("scatter_max", K5_VARIANTS,
                lambda: tuple(kernels.scatter_max(f, ids, 512) for f in fs),
                _same)


_ABLATIONS = {"fps": _ablate_fps, "min_argmin": _ablate_min_argmin,
              "fusion_chain": _ablate_fusion_chain,
              "smallest_k": _ablate_smallest_k,
              "scatter_max": _ablate_scatter_max}


if __name__ == "__main__":
    main()
