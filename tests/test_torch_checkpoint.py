"""The port's checkpoints (``usip_tpu_torch.train.checkpoint``), on the CPU.

* usip_tpu writes a small checkpoint after one train step; the port's
  pure-Python msgpack decoder reads it as ``flax.serialization`` does, bit
  for bit, and the restored detector's fp32 eval forward, on JAX's node
  draws, agrees with usip_tpu's within the parity tolerance of
  ``tests/test_torch_parity.py`` (anchors 2e-4, keypoints and sigmas 2e-3).
* The port's own save -> restore -> one step equals one step without the
  break, bit for bit (same batch, same generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from usip_tpu.config import get_config as jax_get_config
from usip_tpu.models import Detector as JaxDetector
from usip_tpu.ops import sample_nodes as jax_sample_nodes
from usip_tpu.train import steps as jsteps
from usip_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from usip_tpu.train.state import TrainState as JaxTrainState
from usip_tpu.train.state import make_adam as jax_make_adam
from usip_tpu.train.torch_import import convert_detector_state_dict
from usip_tpu_torch.config import get_config
from usip_tpu_torch.ops import sample_nodes
from usip_tpu_torch.train import ParentBatch, make_detector_train_step
from usip_tpu_torch.train.checkpoint import (_Reader, read_msgpack,
                                             restore_checkpoint,
                                             save_checkpoint)
from usip_tpu_torch.train.loop import init_detector_state
from usip_tpu_torch.weights import (load_detector_weights, seeded_state_dict,
                                    state_dict_from_jax)

torch.set_num_threads(1)

B, N, P, M, S = 2, 256, 320, 32, 4
OVERRIDES = {"data.input_pc_num": N, "data.parent_pc_num": P,
             "data.node_num": M, "data.fps_subsample_ratio": 2,
             "detector.c1": 16, "detector.c2": 64, "detector.node_knn_k": 4,
             "detector.compute_dtype": "float32"}
# tests/test_torch_parity.py:151-153
TOL_ANCHORS, TOL_OUT = 2e-4, 2e-3


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x):
    return torch.from_numpy(np.array(x))


def _clouds(seed, b, n):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, (b, n, 3)).astype(np.float32),
            rng.normal(size=(b, n, S)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """usip_tpu's ``.msgpack`` after one jitted train step from seeded
    weights (the reference layout's random weights, nontrivial keypoint
    offsets), and the config it was written under."""
    jcfg = jax_get_config("kitti", **OVERRIDES)
    pc, sn = _clouds(0, B, P)
    jmodel = JaxDetector(jcfg.detector)
    init = jmodel.init(jax.random.PRNGKey(0), _j(pc[:1, :N]), _j(sn[:1, :N]),
                       _j(pc[:1, :M]), train=False)
    variables = convert_detector_state_dict(
        seeded_state_dict(get_config("kitti", **OVERRIDES).detector, 1), init)
    state = JaxTrainState.create(variables, jax_make_adam(jcfg.train.lr))
    state, _ = jax.jit(jsteps.make_detector_train_step(jcfg, jmodel))(
        state, jsteps.ParentBatch(pc=_j(pc), sn=_j(sn)),
        jax.random.PRNGKey(3), jnp.asarray(0))
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "best.msgpack")
    jax_save_checkpoint(path, state, metadata={"epoch": 4, "loss": 0.5})
    return path, jcfg, jmodel, state


def _assert_tree_equal(ours, ref, where="root"):
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(ref), where
        for k in ref:
            _assert_tree_equal(ours[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(ours) == len(ref), where
        for i, (a, b) in enumerate(zip(ours, ref)):
            _assert_tree_equal(a, b, f"{where}[{i}]")
    elif isinstance(ref, (np.ndarray, np.generic)) and ref.dtype.name == \
            "bfloat16":
        assert ours.dtype == np.float32 and ours.shape == ref.shape, where
        assert np.array_equal(ours, np.asarray(ref, np.float32)), where
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert isinstance(ours, type(ref)), where
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, where
        assert np.array_equal(ours, ref), where
    else:
        assert type(ours) is type(ref) and ours == ref, where


def _decode(data: bytes):
    reader = _Reader(data)
    out = reader.value()
    assert reader.pos == len(data)
    return out


def test_read_msgpack_equals_flax(jax_checkpoint):
    """step, params, batch_stats and the optax state, bit for bit."""
    path = jax_checkpoint[0]
    with open(path, "rb") as f:
        ref = serialization.msgpack_restore(f.read())
    ours = read_msgpack(path)
    assert sorted(ours) == ["batch_stats", "opt_state", "params", "step"]
    _assert_tree_equal(ours, ref)
    assert int(ours["step"]) == 1


def test_read_msgpack_decodes_every_type_flax_writes():
    """Fix and sized forms of ints, strings, arrays and maps, floats, nil,
    bools, bin, and flax's ndarray, numpy-scalar and complex extensions
    (bfloat16 arrays widened to float32)."""
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "i64": np.arange(-3, 7, dtype=np.int64), "u8": np.arange(9, dtype=np.uint8),
        "bf16": jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16),
        "empty": np.zeros((0, 3), np.float32), "f16": np.ones(2, np.float16),
        "npscalar": np.float32(1.5), "npint": np.int32(-9),
        "ints": [0, 7, 127, 128, 255, 256, 65535, 65536, 2**32, 2**40,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
                 -2**40],
        "floats": [1.25, -0.0, 1e300], "flags": [True, False, None],
        "short": "abc", "str8": "x" * 40, "str16": "y" * 300,
        "array16": list(range(20)), "bin": b"\x00\xffbytes",
        "map16": {str(i): i for i in range(20)}, "complex": complex(1, -2),
        "nested": {"a": {"b": {"c": np.float64(2.0)}}},
    }
    data = serialization.msgpack_serialize(tree)
    ours = _decode(data)
    _assert_tree_equal(ours, serialization.msgpack_restore(data))


def test_msgpack_checkpoint_forward_matches_usip_tpu(jax_checkpoint):
    """The port restores usip_tpu's checkpoint (parameters, BatchNorm
    statistics, step; a fresh Adam) and its fp32 eval forward on JAX's
    nodes agrees with usip_tpu's; the nodes themselves, drawn by the port
    from JAX's draws, are identical."""
    path, jcfg, jmodel, jstate = jax_checkpoint
    cfg = get_config("kitti", **OVERRIDES)
    state = init_detector_state(cfg, seed=7)
    meta = restore_checkpoint(path, state)
    assert meta == {"epoch": 4, "loss": 0.5}
    assert state.step == 1 and not state.optimizer.state
    pc, sn = _clouds(5, 3, N)
    key = jax.random.PRNGKey(21)

    @jax.jit
    def jax_forward(variables, pc, sn, key):
        nodes = jax_sample_nodes(key, pc, M, 2)
        return nodes, jmodel.apply(variables, pc, sn, nodes, train=False)

    jnodes, ref = jax_forward(jstate.variables, _j(pc), _j(sn), key)
    k1, k2 = jax.random.split(key)
    sub = N // 2
    subset = np.stack([np.asarray(jax.random.choice(kb, N, shape=(sub,),
                                                    replace=False))
                       for kb in jax.random.split(k1, 3)])
    first = np.asarray(jax.random.randint(k2, (3,), 0, sub))
    nodes = sample_nodes(_t(pc), M, 2, subset_idx=_t(subset), first=_t(first))
    np.testing.assert_array_equal(nodes.numpy(), np.asarray(jnodes))
    model = state.model.eval()
    with torch.no_grad():
        out = model(_t(pc), _t(sn), nodes)
    for got, want, tol in zip(out, ref, (TOL_ANCHORS, TOL_OUT, TOL_OUT)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol)
    # the keypoint offsets are not trivially small
    assert float((out[1] - out[0]).abs().max()) > 1e-2
    sd = load_detector_weights(path)
    ref_sd = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jstate.variables))
    assert sorted(sd) == sorted(ref_sd)
    assert all(torch.equal(sd[k], ref_sd[k]) for k in sd)


def _batch(seed):
    pc, sn = _clouds(seed, B, P)
    return ParentBatch(_t(pc), _t(sn))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_save_restore_step_equals_unbroken_step(tmp_path):
    """Two steps in one run, and the same two steps with a save after the
    first and a restore into a differently initialised state: the
    parameters, BatchNorm buffers, Adam state, step and metrics of the
    second step agree bit for bit."""
    cfg = get_config("kitti", **OVERRIDES)
    step = make_detector_train_step(cfg)
    a = init_detector_state(cfg, seed=0)
    step(a, _batch(1), 0, generator=_gen(11))
    path = str(tmp_path / "last.pt")
    save_checkpoint(path, a, metadata={"epoch": 0, "loss": 1.0})
    b = init_detector_state(cfg, seed=9)
    assert restore_checkpoint(path, b) == {"epoch": 0, "loss": 1.0}
    assert b.step == a.step == 1
    ma = step(a, _batch(2), 1, generator=_gen(12))
    mb = step(b, _batch(2), 1, generator=_gen(12))
    assert a.step == b.step == 2
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i in oa["state"]:
        for k in oa["state"][i]:
            assert torch.equal(oa["state"][i][k], ob["state"][i][k]), (i, k)
    assert load_detector_weights(path).keys() == sa.keys()


def test_restore_rejects_other_widths(tmp_path, jax_checkpoint):
    cfg = get_config("kitti", **OVERRIDES)
    path = str(tmp_path / "w.pt")
    save_checkpoint(path, init_detector_state(cfg))
    wide = get_config("kitti", **{**OVERRIDES, "detector.c1": 32})
    for p in (path, jax_checkpoint[0]):
        with pytest.raises(ValueError, match="other widths"):
            restore_checkpoint(p, init_detector_state(wide))
