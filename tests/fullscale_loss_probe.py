"""Both packages' full-scale ``train`` phase on one small synthetic KITTI
tree, on the CPU, with their default host loaders (the native batch
loaders: the same batches), and the loss each logs.

    JAX_PLATFORMS=cpu python tests/fullscale_loss_probe.py --epochs 20 \\
        --work /tmp/loss_probe

``scripts/fullscale_quality.py train`` (usip_tpu) and ``python -m
usip_tpu_torch.fullscale train`` (the port) run one after the other on the
same tree (9 train sequences of 8 scans of 800 points, the KITTI preset at
``tests/test_torch_fullscale.py``'s small fp32 width); the device draws are
each package's own. Prints one JSON line: per package, the first logged
train loss and each epoch's ``train_epoch`` loss, sigma_min and sigma_mean
and ``test`` loss and chamfer_pure (the keys both engines log). ~4 min for
20 epochs on 4 cores.
"""

import argparse
import importlib.util
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

OVERRIDES = ["data.input_pc_num=512", "data.node_num=128",
             "data.fps_subsample_ratio=2", "data.parent_pc_num=640",
             "detector.c1=16", "detector.c2=64", "detector.node_knn_k=4",
             "detector.compute_dtype=float32"]


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return {
        "first_train_loss": next(r["loss"] for r in recs
                                 if r["prefix"] == "train"),
        "train_epoch": [{k: r[k] for k in ("epoch", "loss", "sigma_min",
                                           "sigma_mean")}
                        for r in recs if r["prefix"] == "train_epoch"],
        "test": [{k: r[k] for k in ("epoch", "loss", "chamfer_pure")}
                 for r in recs if r["prefix"] == "test"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--work", required=True)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(args.threads)

    from usip_tpu_torch import fullscale
    from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree

    root = os.path.join(args.work, "tree")
    shutil.rmtree(args.work, ignore_errors=True)
    build_synthetic_kitti_tree(root, train_seqs=range(9), test_seqs=(9, 10),
                               frames_per_seq=8, test_frames_per_seq=10,
                               target_points=800, seed=0)
    spec = importlib.util.spec_from_file_location(
        "fullscale_quality", os.path.join(REPO, "scripts",
                                          "fullscale_quality.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = {"epochs": args.epochs}
    metrics = os.path.join(root, "ckpt", "fullscale",
                           "fullscale_metrics.jsonl")
    script.phase_train(argparse.Namespace(root=root, epochs=args.epochs,
                                          platform="cpu",
                                          override=OVERRIDES))
    out["usip_tpu"] = _records(metrics)
    shutil.rmtree(os.path.join(root, "ckpt"))
    fullscale.main(["train", "--root", root, "--epochs", str(args.epochs),
                    "--device", "cpu"]
                   + [a for kv in OVERRIDES for a in ("--override", kv)])
    out["port"] = _records(metrics)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
