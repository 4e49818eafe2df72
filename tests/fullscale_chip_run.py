"""The full-scale KITTI protocol on one GPU, phase by phase, with its record.

    python3 tests/fullscale_chip_run.py [--root build/fullscale] \
        [--out build/fullscale_records] [--phases gen,train,...] [--cgf]

Runs ``python -m usip_tpu_torch.fullscale`` at usip_tpu's sizes (``gen``: 48
frames x 9 train sequences and 36 x 2 test; ``train --epochs 40``; ``eval``;
``train-desc --epochs 30``; ``eval-reg --yaw``), each phase a process of its
own, as the protocol's docstring runs them; then the FPS A/B through ``eval
--override`` (bf16 with bucketed FPS t=2, fp32 with t=2; ``eval`` itself
gives bf16 t=1 and fp32 t=1), and the two engines' clouds/s and idle share
in process on the trained tree (one unprofiled epoch after a warm-up, then
the device's busy time over a profiled epoch under torch.profiler); with
``--cgf`` also the CGF arm (``train-desc --desc-name cgf --override
descriptor.use_cgf_loss=true``, then ``eval-reg --yaw --desc-name cgf``).

Each phase's output goes to ``<out>/<phase>.log``; one JSON record a phase
(wall seconds, the phase's JSON line; for the trains the loss and sigma_min
at the first and last logged steps and the logged clouds/s) is printed and
appended to ``<out>/results.jsonl``, so a run cut short keeps what it
finished. The first record holds the card's name and power limit. Needs
CUDA; exits nonzero at the first phase that fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DET = "fullscale"
PHASES = {
    "gen": ["gen"],
    "train": ["train", "--epochs", "40"],
    "eval": ["eval"],
    "eval_bf16_t2": ["eval", "--override", "data.fps_parallel=2"],
    "eval_fp32_t2": ["eval", "--override", "data.fps_parallel=2",
                     "--override", "detector.compute_dtype=float32"],
    "train_desc": ["train-desc", "--epochs", "30"],
    "eval_reg": ["eval-reg", "--yaw"],
    "engines": None,
    "cgf_train_desc": ["train-desc", "--epochs", "30", "--desc-name", "cgf",
                       "--override", "descriptor.use_cgf_loss=true"],
    "cgf_eval_reg": ["eval-reg", "--yaw", "--desc-name", "cgf"],
}
DEFAULT = ("gen", "train", "eval", "eval_bf16_t2", "eval_fp32_t2",
           "train_desc", "eval_reg", "engines")


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def train_summary(path, steps_prefix):
    """Loss and sigma_min at the first and last logged steps, the epochs'
    averages at the first and last epoch, and the logged clouds/s (each
    the rate since its epoch's start; an epoch's first record, one batch
    in, is left out)."""
    recs = read_jsonl(path)
    steps = [r for r in recs if r.get("prefix") == steps_prefix]
    epochs = [r for r in recs if r.get("prefix") == f"{steps_prefix}_epoch"]
    firsts = {}
    for r in steps:
        firsts.setdefault(r["epoch"], r["step"])
    rates = sorted(r["clouds_per_sec_per_chip"] for r in steps
                   if r["step"] != firsts[r["epoch"]])
    keep = ("step", "epoch", "loss", "sigma_min", "sigma_mean")
    pick = lambda r: {k: r[k] for k in keep if k in r}  # noqa: E731
    return {"first_step": pick(steps[0]), "last_step": pick(steps[-1]),
            "first_epoch": pick(epochs[0]), "last_epoch": pick(epochs[-1]),
            "epochs": len(epochs),
            "logged_clouds_per_sec": {
                "median": rates[len(rates) // 2] if rates else None,
                "min": rates[0] if rates else None,
                "max": rates[-1] if rates else None, "count": len(rates)}}


def run_phase(name, args, root, out):
    cmd = [sys.executable, "-m", "usip_tpu_torch.fullscale", *args,
           "--root", root]
    t0 = time.perf_counter()
    with open(os.path.join(out, f"{name}.log"), "w") as log:
        proc = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.write(proc.stdout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], flush=True)
        raise SystemExit(f"phase {name} exited {proc.returncode}")
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("{")]
    rec = {"phase": name, "argv": args, "seconds": wall,
           "result": json.loads(lines[-1]) if lines else None}
    ckpt = os.path.join(root, "ckpt")
    if name == "train":
        rec["train"] = train_summary(
            os.path.join(ckpt, DET, f"{DET}_metrics.jsonl"), "train")
    elif name.endswith("train_desc"):
        desc = "cgf" if name.startswith("cgf") else DET
        rec["train"] = train_summary(
            os.path.join(ckpt, f"{desc}_descriptor",
                         f"{desc}_desc_metrics.jsonl"), "desc")
    return rec


def _engine_epoch(engine, steps, batch):
    """Warm-up epoch, then a timed one and a profiled one (``chip_smoke.py``'s
    ``profile_busy``, as its phases 7 and 9 measure the engines): clouds/s
    (both clouds of a pair counted) and the idle share of the timed
    epoch."""
    import torch

    from chip_smoke import profile_busy
    engine.train_epoch(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_epoch(1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy = profile_busy(lambda: engine.train_epoch(2), 1)[0]
    return {"steps": steps, "clouds_per_sec": 2 * batch * steps / wall,
            "ms_per_step": wall / steps * 1e3, "busy_ms": busy,
            "wall_ms": wall * 1e3, "idle_share": 1.0 - busy / (wall * 1e3)}


def engines(root, out):
    """Both engines on the full-scale tree (the detector from scratch at the
    preset, the descriptor on the trained detector)."""
    import numpy as np

    from usip_tpu_torch import cli
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.data.descriptor_loaders import KittiDescriptorDataset
    from usip_tpu_torch.data.pipeline import BatchLoader
    from usip_tpu_torch.train.descriptor_loop import DescriptorEngine
    from usip_tpu_torch.train.loop import DetectorEngine

    t0 = time.perf_counter()
    cfg = get_config("kitti", **{"data.dataroot": root,
                                 "train.log_every": 1000})
    train, test = cli._make_loaders(
        cfg, types.SimpleNamespace(synthetic=False),
        cfg.detector.surface_normal_len)
    det = DetectorEngine(cfg, train, test,
                         out_dir=os.path.join(out, "engine_det"),
                         device="cuda")
    res = {"detector": _engine_epoch(det, len(train), cfg.train.batch_size)}
    del det

    dcfg = get_config("kitti", role="descriptor",
                      **{"data.dataroot": root, "train.log_every": 1000})
    ds = KittiDescriptorDataset(dcfg.data, "train",
                                sn_len=dcfg.descriptor.surface_normal_len)
    loader = BatchLoader(ds, dcfg.train.batch_size, shuffle=True,
                         num_workers=dcfg.data.num_workers)
    ckpt = os.path.join(root, "ckpt", DET, "best.pt")
    if not os.path.exists(ckpt):
        ckpt = os.path.join(root, "ckpt", DET, "last.pt")
    desc = DescriptorEngine(
        dcfg, ckpt, train_loader=loader, device="cuda",
        out_dir=os.path.join(out, "engine_desc"),
        mine_negatives=lambda raw: ds.mine_negative_indices(
            np.asarray(raw["seq"]), np.asarray(raw["pose"])))
    res["descriptor"] = _engine_epoch(desc, len(loader),
                                      dcfg.train.batch_size)
    return {"phase": "engines", "seconds": time.perf_counter() - t0,
            "result": res}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(REPO, "build",
                                                   "fullscale"))
    ap.add_argument("--out", default=os.path.join(REPO, "build",
                                                  "fullscale_records"))
    ap.add_argument("--phases", default=",".join(DEFAULT),
                    help="comma list of " + ", ".join(PHASES))
    ap.add_argument("--cgf", action="store_true",
                    help="also the CGF arm (cgf_train_desc, cgf_eval_reg)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA: the protocol runs on the card")
    phases = args.phases.split(",")
    if args.cgf:
        # before the engines, the one phase that runs in this process
        at = phases.index("engines") if "engines" in phases else len(phases)
        phases[at:at] = ["cgf_train_desc", "cgf_eval_reg"]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    os.makedirs(args.out, exist_ok=True)
    results = os.path.join(args.out, "results.jsonl")
    head = {"phase": "card", "card": card(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "root": args.root, "phases": phases}
    print(json.dumps(head), flush=True)
    with open(results, "a") as f:
        f.write(json.dumps(head) + "\n")
    for name in phases:
        rec = (engines(args.root, args.out) if PHASES[name] is None
               else run_phase(name, PHASES[name], args.root, args.out))
        print(json.dumps(rec), flush=True)
        with open(results, "a") as f:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
