"""A resume from usip_tpu's checkpoint carries its Adam state into the port
(``train/checkpoint.py``), on the CPU at ``tests/test_torch_train.py``'s
small fp32 width and with its draws.

usip_tpu takes two jitted train steps from seeded weights and writes its
``.msgpack``; the port restores it into a differently initialised state and
takes the third step with usip_tpu's draws. The step equals usip_tpu's
third step within ``tests/test_torch_train.py``'s fp32 tolerances: every
metric rel 1e-5, the parameters within 1e-5 where the gradient is above
1e-3 x max|g|, the BatchNorm statistics within 1e-6, Adam's first moment
within 1e-5 x max|g| and its count 3. The same restore with a fresh Adam
(the old behaviour) misses usip_tpu's step there by far more. The
params-only files round-trip: the port's ``.pt`` and usip_tpu's
params-only ``.msgpack``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_train import _j, _jax_draws, _port_names, _setup, _t
from usip_tpu.nn.layers import bn_momentum_schedule as jax_bn_schedule
from usip_tpu.train import steps as jsteps
from usip_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from usip_tpu.train.checkpoint import \
    save_params_only as jax_save_params_only
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu_torch.models import Detector
from usip_tpu_torch.train import TrainState, steps
from usip_tpu_torch.train.checkpoint import (load_params_only,
                                             restore_checkpoint,
                                             save_params_only)

torch.set_num_threads(1)

EPOCH = 3


def _close(port, ref, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=what)


def test_resume_from_msgpack_takes_usip_tpu_next_step(tmp_path):
    jcfg, cfg, pc, sn, jmodel, variables, _ = _setup()
    batch = jsteps.ParentBatch(pc=_j(pc), sn=_j(sn))
    step = jax.jit(jsteps.make_detector_train_step(jcfg, jmodel))
    state = JaxTrainState.create(variables, jax_make_adam(jcfg.train.lr))
    keys = [jax.random.PRNGKey(k) for k in (12, 13, 14)]
    for key in keys[:2]:
        state, _ = step(state, batch, key, jnp.asarray(EPOCH))
    path = str(tmp_path / "two_steps.msgpack")
    jax_save_checkpoint(path, state, metadata={"epoch": EPOCH})
    ref_state, jmetrics = step(state, batch, keys[2], jnp.asarray(EPOCH))

    # usip_tpu's gradients of the third step (its loss on the same inputs)
    src, dst, gt = jsteps._prepare_detector_inputs(keys[2], batch, jcfg, True)
    momentum = jax_bn_schedule(jcfg.train.bn_momentum, jnp.asarray(EPOCH),
                               jcfg.train.bn_momentum_decay_step,
                               jcfg.train.bn_momentum_decay)

    def jloss(params):
        (so, do), _ = jsteps._siamese_apply(
            jmodel, {"params": params, "batch_stats": state.batch_stats},
            src, dst, train=True, bn_momentum=momentum)
        return jsteps._detector_losses(jcfg, so, do, src[0], src[1], dst[0],
                                       dst[1], gt)[0]

    jgrads = jax.jit(jax.grad(jloss))(state.params)
    ref_g = _port_names({"params": jgrads,
                         "batch_stats": ref_state.batch_stats})
    after = _port_names(ref_state.variables)
    mu3 = _port_names({"params": ref_state.opt_state.inner_state[0].mu,
                       "batch_stats": ref_state.batch_stats})

    def port_third_step(fresh_adam):
        tstate = TrainState.create(Detector(cfg.detector), cfg.train.lr)
        meta = restore_checkpoint(path, tstate)
        assert meta == {"epoch": EPOCH} and tstate.step == 2
        if fresh_adam:
            tstate.optimizer.state.clear()
        metrics = steps.make_detector_train_step(cfg)(
            tstate, steps.ParentBatch(_t(pc), _t(sn)), EPOCH,
            draws=_jax_draws(keys[2], jcfg))
        assert tstate.step == 3
        return tstate, metrics

    tstate, metrics = port_third_step(fresh_adam=False)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], 1e-5, 1e-6, k)
    gmax = max(float(ref_g[n].abs().max()) for n, _ in
               tstate.model.named_parameters())
    params = dict(tstate.model.named_parameters())
    for name, t in tstate.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        got, ref = t.numpy(), np.asarray(after[name])
        if name.endswith(("running_mean", "running_var")):
            _close(got, ref, 1e-6, 1e-6, name)
            continue
        sure = (ref_g[name].abs() > 1e-3 * gmax).numpy()
        np.testing.assert_allclose(got[sure], ref[sure], rtol=0, atol=1e-5,
                                   err_msg=name)
        entry = tstate.optimizer.state[params[name]]
        assert float(entry["step"]) == 3.0
        _close(entry["exp_avg"].numpy(), mu3[name].numpy(), 0, 1e-5 * gmax,
               name)

    fresh, _ = port_third_step(fresh_adam=True)
    worst = 0.0
    for name, p in fresh.model.named_parameters():
        sure = (ref_g[name].abs() > 1e-3 * gmax).numpy()
        diff = np.abs(p.detach().numpy() - np.asarray(after[name]))[sure]
        worst = max(worst, float(diff.max(initial=0.0)))
    assert worst > 1e-4, worst


def test_params_only_round_trip(tmp_path):
    """The port's ``save_params_only`` -> ``load_params_only`` gives the
    same model; usip_tpu's params-only ``.msgpack`` loads its parameters
    into the port and keeps the model's own BatchNorm statistics."""
    jcfg, cfg, pc, sn, jmodel, variables, det = _setup(seed=1)
    path = str(tmp_path / "det_params.pt")
    save_params_only(path, det)
    other = Detector(cfg.detector)
    load_params_only(path, other)
    for k, v in det.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k

    jpath = str(tmp_path / "det_params.msgpack")
    jax_save_params_only(jpath, variables["params"])
    fresh = Detector(cfg.detector)
    stats = {k: v.clone() for k, v in fresh.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    load_params_only(jpath, fresh)
    ref = _port_names(variables)
    for k, v in fresh.state_dict().items():
        if k in stats:
            assert torch.equal(v, stats[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(v, ref[k]), k
