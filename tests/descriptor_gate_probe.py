"""The descriptor quality gate's ratio in usip_tpu and in the port, seed by
seed, and the spread of its denominator.

For each ``train.seed`` given, on the CPU: usip_tpu's protocol
(``scripts/validate_descriptor.py --use-cgf --rot 2d --test-yaw`` at the
port's gate sizes, its config given that ``train.seed``) and the port's
(``usip_tpu_torch.quality.run_descriptor`` with ``--override
train.seed=S``), each giving the trained, untrained and random yaw-matching
accuracy; then, on each package's own trained detector and the same test
draws, the untrained accuracy of ``--inits`` more descriptor
initialisations (seeds 1000, 1001, ...): the spread the gate's one
untrained draw comes from. One JSON line a seed and package.

    JAX_PLATFORMS=cpu python tests/descriptor_gate_probe.py --seeds 0 1 \\
        [--inits 24] [--out DIR]

Each seed takes about 35 minutes on 8 CPU cores (the port's gate about 11
minutes on 4 cores, usip_tpu's about 23).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def jax_probe(seed, inits, out):
    import jax
    import jax.numpy as jnp

    from usip_tpu.config import Config
    from usip_tpu.models import Descriptor
    from usip_tpu.train.checkpoint import restore_checkpoint
    from usip_tpu.train.loop import init_detector_state
    from usip_tpu.train.steps import make_detector_infer

    spec = importlib.util.spec_from_file_location(
        "validate_descriptor",
        os.path.join(REPO, "scripts", "validate_descriptor.py"))
    vd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vd)
    get_config = vd.get_config
    vd.get_config = lambda *a, **k: get_config(*a, **{**k,
                                                      "train.seed": seed})
    from usip_tpu_torch.quality import DESCRIPTOR_GATE as gate
    argv, sys.argv = sys.argv, [
        "validate_descriptor.py", "--use-cgf", "--rot", "2d", "--test-yaw",
        "--train-size", str(gate["train_size"]),
        "--det-epochs", str(gate["det_epochs"]),
        "--desc-epochs", str(gate["desc_epochs"]), "--out", out]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            vd.main()
    finally:
        sys.argv = argv
    gate = json.loads(buf.getvalue().strip().splitlines()[-1])

    # validate_descriptor.py's test, again, for descriptors initialised
    # from other seeds
    with open(os.path.join(out, "det", "config.json")) as f:
        cfg = Config.from_json(f.read())
    model, state = init_detector_state(cfg, cfg.train.seed)
    state, _ = restore_checkpoint(os.path.join(out, "det", "final.msgpack"),
                                  state)
    infer = jax.jit(make_detector_infer(cfg, model))
    desc = Descriptor(cfg.descriptor)
    describe = jax.jit(lambda v, pc, sn, kp, key: desc.apply(
        v, pc, sn, kp, key=key, train=False)[0])
    test_ds = vd.SyntheticDataset(size=16, input_pc_num=cfg.data.input_pc_num,
                                  surface_normal_len=3, seed=1)
    rng = np.random.default_rng(3)
    items = []
    for i in range(12):
        item = test_ds[i]
        pc, sn = item["src_pc"], item["src_sn"]
        ang = rng.uniform(0, 2 * np.pi)
        R = np.asarray(vd.rotation_matrix(
            np.array([0.0, ang, 0.0], np.float32))).astype(np.float32)
        pc_r = item["dst_pc"] @ R.T
        sn_r = np.concatenate([item["dst_sn"][:, :3] @ R.T,
                               item["dst_sn"][:, 3:]], axis=1)
        kp_a, _ = infer(state, jnp.asarray(pc[None]), jnp.asarray(sn[None]),
                        jax.random.PRNGKey(2 * i))
        kp_p, _ = infer(state, jnp.asarray(pc_r[None]),
                        jnp.asarray(sn_r[None]), jax.random.PRNGKey(2 * i + 1))
        items.append((pc, sn, pc_r, sn_r, R, kp_a, kp_p))
        for _ in range(2):  # the random vectors' draws
            rng.normal(size=(cfg.data.node_num,
                             cfg.descriptor.descriptor_len))

    def accuracy(variables):
        accs = []
        for i, (pc, sn, pc_r, sn_r, R, kp_a, kp_p) in enumerate(items):
            da = np.asarray(describe(variables, pc[None], sn[None], kp_a,
                                     jax.random.PRNGKey(100 + i))[0])
            dp = np.asarray(describe(variables, pc_r[None], sn_r[None], kp_p,
                                     jax.random.PRNGKey(200 + i))[0])
            accs.append(vd.match_accuracy(np.asarray(kp_a[0]), da,
                                          np.asarray(kp_p[0]), dp, R, 0.2))
        return float(np.mean(accs))

    n, m = cfg.data.input_pc_num, cfg.data.node_num
    spread = [accuracy(desc.init(jax.random.PRNGKey(1000 + s),
                                 jnp.zeros((2, n, 3)), jnp.zeros((2, n, 3)),
                                 jnp.zeros((2, m, 3)),
                                 key=jax.random.PRNGKey(0), train=False))
              for s in range(inits)]
    return {"trained": gate["match_acc_trained"],
            "untrained": gate["match_acc_untrained"],
            "random": gate["match_acc_random"], "untrained_by_init": spread}


def port_probe(seed, inits, out):
    import torch

    from usip_tpu_torch import quality
    from usip_tpu_torch.config import Config
    from usip_tpu_torch.models import Descriptor
    from usip_tpu_torch.train.checkpoint import restore_checkpoint
    from usip_tpu_torch.train.loop import init_detector_state

    gate = quality.run_descriptor(out, "cpu",
                                  overrides=[f"train.seed={seed}"],
                                  **quality.DESCRIPTOR_GATE)
    with open(os.path.join(out, "det", "config.json")) as f:
        cfg = Config.from_json(f.read())
    state = init_detector_state(cfg, cfg.train.seed)
    restore_checkpoint(os.path.join(out, "det", "final.pt"), state)
    models = {}
    for s in range(inits):
        torch.manual_seed(1000 + s)
        models[s] = Descriptor(cfg.descriptor)
    accs = quality.yaw_matching(cfg, state.model, models,
                                quality.DESCRIPTOR_GATE["test_items"],
                                quality.DESCRIPTOR_GATE["match_radius"])
    return {**{k: gate[k] for k in ("trained", "untrained", "random")},
            "untrained_by_init": [accs[s] for s in range(inits)]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--inits", type=int, default=24)
    ap.add_argument("--packages", nargs="+", default=["usip_tpu", "port"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = args.out or tempfile.mkdtemp(prefix="desc_gate_probe_")
    probes = {"usip_tpu": jax_probe, "port": port_probe}
    for seed in args.seeds:
        for name in args.packages:
            res = probes[name](seed, args.inits,
                               os.path.join(root, f"{name}_{seed}"))
            spread = res.pop("untrained_by_init")
            mean = float(np.mean(spread))
            print(json.dumps({
                "package": name, "seed": seed, **res,
                "ratio": res["trained"] / max(res["untrained"], 1e-9),
                "untrained_by_init": {"n": len(spread), "mean": mean,
                                      "std": float(np.std(spread)),
                                      "min": min(spread),
                                      "max": max(spread)},
                "ratio_over_mean": res["trained"] / max(mean, 1e-9)}),
                flush=True)


if __name__ == "__main__":
    main()
