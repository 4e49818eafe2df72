"""Probe: the grouped (and SOM k > 1) train step of the port against
usip_tpu's over many draws, with a float64 run of the port as the arbiter.

    JAX_PLATFORMS=cpu python tests/group_step_probe.py knn ball blob som2 \\
        [--seeds 0 1 ... 7] [--key 12] [--arbiter]

For each case and parent seed, one step at the small width of
``torch_group_common`` (key ``--key``) in both packages: the worst gradient
error over max|g| (usip_tpu's gradient from its Adam first moment), the
worst running-statistic error and the worst metric error, relative. With
``--arbiter``, where the gradients differ by more than 1e-5 of max|g|, the
port's step is run again in float64 (its fp32 casts lifted) and both fp32
gradients are measured against it: the one within rounding of the float64
gradient is right, the other met an fp32 near-tie.
"""

import argparse
import copy
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_group_common as g  # noqa: E402
from usip_tpu.train import steps as jsteps  # noqa: E402
from usip_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from usip_tpu.train.state import make_adam as jax_make_adam  # noqa: E402
from usip_tpu_torch.train import TrainState, steps  # noqa: E402


def port_grads(cfg, det, pc, sn, epoch, draws):
    det = copy.deepcopy(det)
    state = TrainState.create(det, cfg.train.lr)
    steps.make_detector_train_step(cfg)(
        state, steps.ParentBatch(torch.from_numpy(pc), torch.from_numpy(sn)),
        epoch, draws=draws)
    return {n: p.grad.double() for n, p in det.named_parameters()}, det


def float64_grads(cfg, det, pc, sn, epoch, draws):
    """The port's step in float64: every ``.float()`` and ``.to(float32)``
    of its code left in float64 for the call."""
    orig_float, orig_to = torch.Tensor.float, torch.Tensor.to

    def to(self, *a, **k):
        a = tuple(torch.float64 if x is torch.float32 else x for x in a)
        if k.get("dtype") is torch.float32:
            k["dtype"] = torch.float64
        return orig_to(self, *a, **k)

    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    torch.Tensor.float = lambda self: self.double()
    torch.Tensor.to = to
    try:
        draws = jax.tree_util.tree_map(
            lambda t: t.double() if t.is_floating_point() else t, draws,
            is_leaf=lambda x: isinstance(x, torch.Tensor))
        return port_grads(cfg, copy.deepcopy(det).double(),
                          pc.astype(np.float64), sn.astype(np.float64),
                          epoch, draws)[0]
    finally:
        torch.Tensor.float, torch.Tensor.to = orig_float, orig_to
        torch.set_default_dtype(default)


def worst(a, b, gmax):
    return max((float((a[n] - b[n]).abs().max()) / gmax, n) for n in b)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="+",
                    choices=["knn", "ball", "blob", "som2"])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--key", type=int, default=12)
    ap.add_argument("--arbiter", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for case in args.cases:
        if case == "som2":
            cfg, jcfg = g.som_configs(2)
        else:
            cfg, jcfg = g.configs("ball" if case == "blob" else case, **(
                {"detector.group_radius": 0.12} if case == "blob" else {}))
        jstep = None
        for seed in args.seeds:
            pc, sn, jmodel, variables, det = g.make_setup(
                cfg, jcfg, seed=seed, blob=case == "blob")
            if jstep is None:
                jstep = jax.jit(jsteps.make_detector_train_step(jcfg, jmodel))
            key, epoch = jax.random.PRNGKey(args.key), 3
            new_state, jm = jstep(
                JaxTrainState.create(variables, jax_make_adam(jcfg.train.lr)),
                jsteps.ParentBatch(pc=g.to_jax(pc), sn=g.to_jax(sn)), key,
                jax.numpy.asarray(epoch))
            draws = g.jax_draws(key, jcfg)
            state = TrainState.create(det, cfg.train.lr)
            m = steps.make_detector_train_step(cfg)(
                state, steps.ParentBatch(g.to_torch(pc), g.to_torch(sn)),
                epoch, draws=draws)
            mu = new_state.opt_state.inner_state[0].mu
            ref = g.port_names({"params": jax.tree_util.tree_map(
                lambda a: np.asarray(a) / 0.1, mu),
                "batch_stats": new_state.batch_stats})
            names = [n for n, _ in det.named_parameters()]
            gmax = max(float(ref[n].abs().max()) for n in names)
            ours = {n: p.grad.double() for n, p in det.named_parameters()}
            ref = {n: ref[n].double() for n in names}
            w = worst(ours, ref, gmax)
            after = g.port_names(new_state.variables)
            stats = max(float(((t - after[n]).abs() / (
                after[n].abs() + 0.05)).max())
                for n, t in det.state_dict().items()
                if n.endswith(("running_mean", "running_var")))
            met = max(abs(float(m[k]) - float(jm[k]))
                      / max(abs(float(jm[k])), 1e-6) for k in jm)
            line = (f"{case} seed {seed} key {args.key}: gradients "
                    f"{w[0]:.2e} of max|g| ({w[1]}), running statistics "
                    f"{stats:.2e}, metrics {met:.2e}")
            if args.arbiter and w[0] > 1e-5:
                start = g.make_setup(cfg, jcfg, seed=seed,
                                     blob=case == "blob")[4]
                g64 = float64_grads(cfg, start, pc, sn, epoch, draws)
                line += (f"; against float64: port "
                         f"{worst(ours, g64, gmax)[0]:.2e}, usip_tpu "
                         f"{worst(ref, g64, gmax)[0]:.2e}")
            print(line, flush=True)


if __name__ == "__main__":
    main()
