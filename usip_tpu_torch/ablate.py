"""Ablations of the fusion-chain (K3) and smallest-k (K4) kernels on the card.

    python -m usip_tpu_torch.ablate [--out FILE]

Builds variant copies of ``csrc/fusion_chain.cu`` and ``csrc/smallest_k.cu``
(each a set of text patches on the shipped source, into
``build/usip_tpu_torch/ablate/``), binds each through the same ctypes entry
point as the shipped kernel, and times it with CUDA-graph replay at the
serving paths' shapes: K3 at (8, 512, 16, 131) -> (8, 512, 512) with the
KITTI widths, K4 at (8, 512, 16384) k=64 on ball scores of an urban-like
cloud. Variants that compute the function keep it (the result is checked
against the shipped kernel's: within 1e-2 x max|out| for K3, identical for
K4); variants that drop a part of the work (marked "timing only") show what
that part costs. Prints one line per variant and, last, a JSON object of
them all; exits nonzero without CUDA or if a variant's patch no longer
applies.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from usip_tpu_torch import _build
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.ops.grouping import ball_scores

OUT_DIR = _build.BUILD_DIR / "ablate"

_NO_MMA = ("      Wgmma<N>::mma(acc,", "      if (kp < 0) Wgmma<N>::mma(acc,")
# (name, timing only, patches)
K3_VARIANTS = (
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
)
K4_VARIANTS = (
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
)


def _build_variants(name, variants):
    src = (_build.CSRC / f"{name}.cu").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (label, _, patches) in enumerate(variants):
        text = src
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"{name}: the patch of variant {label!r} "
                                 f"no longer applies: {old!r}")
            text = text.replace(old, new)
        path = OUT_DIR / f"{name}_{i}.cu"
        path.write_text(text)
        procs.append(subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(path.with_suffix(".so")), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for (label, _, _), proc in zip(variants, procs):
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name}: variant {label!r} failed to build:\n"
                             f"{out}")
    return [OUT_DIR / f"{name}_{i}.so" for i in range(len(variants))]


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


def _run(name, variants, call, same):
    libs = _build_variants(name, variants)
    rows, ref = [], None
    for (label, timing_only, _), lib in zip(variants, libs):
        _bind(name, lib)
        out = call()
        torch.cuda.synchronize()
        if ref is None:
            ref = out
        ok = None if timing_only else bool(same(out, ref))
        ms = graph_ms(call)
        rows.append({"kernel": name, "variant": label, "ms": ms,
                     "timing_only": timing_only, "same_result": ok})
        print(f"{name}: {label}: {ms:.4f} ms"
              + (" (timing only)" if timing_only else
                 f", same result {ok}"), flush=True)
        if ok is False:
            raise SystemExit(f"{name}: variant {label!r} changed the result")
    kernels._FNS.pop(name, None)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser(prog="usip_tpu_torch.ablate")
    parser.add_argument("--out", default=None,
                        help="also write the JSON object to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("ablate: CUDA is not available; this runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
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
    rows = _run("fusion_chain", K3_VARIANTS,
                lambda: kernels.fusion_chain(x, chain),
                lambda a, b: float((a - b).abs().max())
                <= 1e-2 * float(b.abs().max()))
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
    rows += _run("smallest_k", K4_VARIANTS,
                 lambda: kernels.smallest_k(scores, 64),
                 lambda a, b: torch.equal(a[0], b[0])
                 and torch.equal(a[1], b[1]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    result = {"card": smi.splitlines()[0] if smi else "unknown",
              "variants": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
