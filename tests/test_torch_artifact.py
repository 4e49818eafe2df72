"""The port's model artifacts (usip_tpu_torch.model_artifact: torch.export
programs of the serving forward, weights baked in) and its five kernels as
``torch.library`` custom ops, on the CPU at usip_tpu's artifact test size
(``tests/test_model_artifact.py``: fp32, N=128, M=16).

Given the same draws, each artifact equals the in-process port bit for bit
(the SOM, knn and ball detectors, the descriptor, the pipeline). Given
usip_tpu's draws for a key, it matches usip_tpu's artifact exported from the
same ``.msgpack``: nodes identical, the descriptor within 1e-5, keypoints
and sigmas within the fused chain's bound (usip_tpu's artifact runs the
fp32 XLA chain, the port's the bf16 fused chain; the bound of
``tests/test_torch_detector.py test_fused_infer_matches_jax_fused``). The
runner keeps usip_tpu's contract and loads no model code.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from usip_tpu import model_artifact as jax_art
from usip_tpu.config import get_config as jax_get_config
from usip_tpu.train.checkpoint import save_checkpoint as jax_save
from usip_tpu.train.descriptor_loop import init_descriptor_state
from usip_tpu.train.loop import init_detector_state
from usip_tpu_torch import model_artifact as art_mod
from usip_tpu_torch.config import get_config
from usip_tpu_torch.models import Descriptor, Detector
from usip_tpu_torch.models.fused_infer import detector_infer_fused
from usip_tpu_torch.ops import kernels
from usip_tpu_torch.ops.sampling import sample_nodes
from usip_tpu_torch.weights import load_detector_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

B, N, M, K = 2, 128, 16, 12
TINY = {"data.input_pc_num": N, "data.node_num": M,
        "detector.c1": 16, "detector.c2": 32, "detector.node_knn_k": 4,
        "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 8,
        "detector.compute_dtype": "float32",
        "descriptor.compute_dtype": "float32",
        "descriptor.surface_normal_len": 3}
GROUPED = {"detector.group_k": 8, "detector.group_radius": 2.0}
FAMILIES = ("som", "knn", "ball")
# usip_tpu's fp32 XLA chain against the port's bf16 fused chain
CHAIN_MAX, CHAIN_MEDIAN = 2e-2, 2e-3
USIP_OPS = ("fps", "min_argmin", "fusion_chain", "smallest_k", "scatter_max")


def _overrides(family):
    return {**TINY, "detector.grouping": family,
            **(GROUPED if family != "som" else {})}


def _cloud(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, N, 3)).astype(np.float32),
            rng.normal(size=(B, N, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """usip_tpu checkpoints (.msgpack) of each detector family and of the
    descriptor; from each, usip_tpu's artifact and the port's (cpu)."""
    tmp = tmp_path_factory.mktemp("artifacts")
    out = {}
    for family in FAMILIES:
        jcfg = jax_get_config("modelnet", **_overrides(family))
        model, state = init_detector_state(jcfg, 0)
        ckpt = str(tmp / f"{family}.msgpack")
        jax_save(ckpt, state)
        jpath, tpath = (str(tmp / f"{family}.{k}") for k in ("jax", "torch"))
        jax_art.export_detector_artifact(jcfg, ckpt, jpath, batch=B,
                                         platforms=("cpu",))
        cfg = get_config("modelnet", **_overrides(family))
        art_mod.export_detector_artifact(cfg, ckpt, tpath, batch=B,
                                         platforms=("cpu",))
        out[family] = (cfg, ckpt, jpath, tpath)
    jcfg = jax_get_config("modelnet", **TINY)
    _, dstate = init_descriptor_state(jcfg, 1)
    dckpt = str(tmp / "desc.msgpack")
    jax_save(dckpt, dstate)
    cfg = get_config("modelnet", **TINY)
    paths = {k: str(tmp / f"desc.{k}") for k in ("jax", "torch")}
    jax_art.export_descriptor_artifact(jcfg, dckpt, paths["jax"], batch=B,
                                       num_keypoints=K, platforms=("cpu",))
    art_mod.export_descriptor_artifact(cfg, dckpt, paths["torch"], batch=B,
                                       num_keypoints=K, platforms=("cpu",))
    out["descriptor"] = (cfg, dckpt, paths["jax"], paths["torch"])
    pipe = {k: str(tmp / f"pipe.{k}") for k in ("jax", "torch")}
    jax_art.export_pipeline_artifact(jcfg, out["som"][1], dckpt, pipe["jax"],
                                     batch=B, platforms=("cpu",))
    art_mod.export_pipeline_artifact(cfg, out["som"][1], dckpt,
                                     pipe["torch"], batch=B,
                                     platforms=("cpu",))
    out["pipeline"] = (cfg, (out["som"][1], dckpt), pipe["jax"],
                       pipe["torch"])
    return out


def _detector(cfg, ckpt):
    det = Detector(cfg.detector)
    det.load_state_dict(load_detector_weights(ckpt), strict=True)
    return det.eval()


def _descriptor(cfg, ckpt):
    desc = Descriptor(cfg.descriptor)
    desc.load_state_dict(load_detector_weights(ckpt), strict=True)
    return desc.eval()


def _in_process(cfg, ckpt, pc, sn, subset, first):
    node = sample_nodes(pc, cfg.data.node_num, cfg.data.fps_subsample_ratio,
                        subset_idx=subset, first=first)
    _, kp, sig = detector_infer_fused(_detector(cfg, ckpt), pc, sn, node)
    return kp, sig


class _Picks(TorchDispatchMode):
    """The ``usip::`` ops an artifact calls, with their outputs."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "usip":
            self.calls.append((func.__name__.split(".")[0], args, out))
        return out


def _jax_node_draws(key, cfg):
    """usip_tpu.ops.sampling.sample_nodes' draws for a key."""
    sub = max(cfg.data.node_num, N // cfg.data.fps_subsample_ratio)
    k1, k2 = jax.random.split(key)
    subset = np.stack([np.asarray(jax.random.choice(kb, N, shape=(sub,),
                                                    replace=False))
                       for kb in jax.random.split(k1, B)])
    first = np.array(jax.random.randint(k2, (B,), 0, sub))
    return torch.from_numpy(subset).long(), torch.from_numpy(first).long()


def _within_chain_bound(port, ref, what):
    port, ref = np.asarray(port), np.asarray(ref)
    scale = float(np.abs(ref).max())
    err = np.abs(port - ref)
    assert err.max() <= CHAIN_MAX * scale, (what, err.max(), scale)
    assert np.median(err) <= CHAIN_MEDIAN * scale, (what, np.median(err))


# ------------------------------------------- artifact == in-process port --

@pytest.mark.parametrize("family", FAMILIES)
def test_detector_artifact_equals_in_process(arts, family):
    cfg, ckpt, _, tpath = arts[family]
    art = art_mod.load_artifact(tpath, "cpu")
    assert art.header["kind"] == "detector"
    assert [i["name"] for i in art.header["inputs"]] == [
        "pc", "sn", "subset", "first"]
    pc, sn = (torch.from_numpy(a) for a in _cloud(0))
    draws = art_mod.artifact_draws(art.header,
                                   torch.Generator().manual_seed(3))
    kp, sig = art(pc, sn, *draws)
    with torch.no_grad():
        kp_ref, sig_ref = _in_process(cfg, ckpt, pc, sn, *draws)
    assert torch.equal(kp, kp_ref) and torch.equal(sig, sig_ref)


def test_descriptor_artifact_equals_in_process(arts):
    cfg, ckpt, _, tpath = arts["descriptor"]
    art = art_mod.load_artifact(tpath, "cpu")
    assert art.header["descriptor_len"] == 16
    assert art.header["keypoint_num"] == K
    pc, sn = (torch.from_numpy(a) for a in _cloud(1))
    kp = pc[:, :K].contiguous()
    priority = torch.rand((B, N), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref, _ = _descriptor(cfg, ckpt)(pc, sn, kp, priority)
    assert torch.equal(art(pc, sn, kp, priority), ref)


def test_pipeline_artifact_equals_in_process(arts):
    cfg, (dckpt, desc_ckpt), _, tpath = arts["pipeline"]
    art = art_mod.load_artifact(tpath, "cpu")
    assert art.header["outputs"] == ["keypoints", "sigmas", "descriptors"]
    pc, sn = (torch.from_numpy(a) for a in _cloud(2))
    subset, first, priority = art_mod.artifact_draws(
        art.header, torch.Generator().manual_seed(5))
    kp, sig, desc = art(pc, sn, subset, first, priority)
    with torch.no_grad():
        kp_ref, sig_ref = _in_process(cfg, dckpt, pc, sn, subset, first)
        desc_ref, _ = _descriptor(cfg, desc_ckpt)(pc, sn, kp_ref, priority)
    assert torch.equal(kp, kp_ref) and torch.equal(sig, sig_ref)
    assert torch.equal(desc, desc_ref)


@pytest.mark.parametrize("kind", ["som", "pipeline"])
def test_graph_calls_the_usip_ops(arts, kind):
    """The exported graph calls the kernels by name (not their plain
    versions unrolled: the SOM graph has a few hundred nodes, where tracing
    the plain FPS loop gives thousands)."""
    art = art_mod.load_artifact(arts[kind][3], "cpu")
    graph = art._module.graph
    targets = {str(n.target) for n in graph.nodes}
    for op in USIP_OPS:
        assert f"usip.{op}.default" in targets, (op, kind)
    assert len(graph.nodes) < 1000


# ----------------------------------------- against usip_tpu's artifacts --

@pytest.mark.parametrize("family", FAMILIES)
def test_detector_artifact_matches_usip_tpu(arts, family):
    cfg, _, jpath, tpath = arts[family]
    pc, sn = _cloud(6)
    key = jax.random.PRNGKey(11)
    kp_j, sig_j = jax_art.load_artifact(jpath)(jnp.asarray(pc),
                                              jnp.asarray(sn), key)
    subset, first = _jax_node_draws(key, cfg)
    art = art_mod.load_artifact(tpath, "cpu")
    with _Picks() as picks:
        kp, sig = art(pc, sn, subset, first)
    # the nodes: usip_tpu's sample_nodes for the key, identical
    from usip_tpu.ops.sampling import sample_nodes as jax_sample_nodes
    nodes_j = np.asarray(jax_sample_nodes(key, jnp.asarray(pc), M,
                                          cfg.data.fps_subsample_ratio))
    (fps_out,) = [out for op, _, out in picks.calls if op == "fps"]
    sub_pts = np.take_along_axis(pc, subset.numpy()[..., None], axis=1)
    nodes = np.take_along_axis(sub_pts, fps_out.long().numpy()[..., None],
                               axis=1)
    np.testing.assert_array_equal(nodes, nodes_j)
    _within_chain_bound(kp.numpy(), kp_j, f"{family} keypoints")
    _within_chain_bound(sig.numpy(), sig_j, f"{family} sigmas")


def test_descriptor_artifact_matches_usip_tpu(arts):
    _, _, jpath, tpath = arts["descriptor"]
    pc, sn = _cloud(7)
    kp = pc[:, :K]
    key = jax.random.PRNGKey(3)
    d_j = jax_art.load_artifact(jpath)(jnp.asarray(pc), jnp.asarray(sn),
                                      jnp.asarray(kp), key)
    priority = np.asarray(jax.random.uniform(key, (B, N)))
    d = art_mod.load_artifact(tpath, "cpu")(pc, sn, kp, priority)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_j), atol=1e-5,
                               rtol=0)


def test_pipeline_artifact_matches_usip_tpu(arts):
    """The fused program against usip_tpu's: keypoints and sigmas within the
    chain's bound; the descriptors of the port's own keypoints equal the
    port's descriptor artifact's (usip_tpu describes its own keypoints,
    which the chain moves)."""
    cfg, _, jpath, tpath = arts["pipeline"]
    pc, sn = _cloud(8)
    key = jax.random.PRNGKey(5)
    kp_j, sig_j, _ = jax_art.load_artifact(jpath)(jnp.asarray(pc),
                                                 jnp.asarray(sn), key)
    subset, first = _jax_node_draws(key, cfg)
    priority = np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                             (B, N)))
    kp, sig, desc = art_mod.load_artifact(tpath, "cpu")(
        pc, sn, subset, first, priority)
    _within_chain_bound(kp.numpy(), kp_j, "pipeline keypoints")
    _within_chain_bound(sig.numpy(), sig_j, "pipeline sigmas")
    assert desc.shape == (B, M, 16)
    torch.testing.assert_close(torch.linalg.norm(desc, dim=-1),
                               torch.ones(B, M))


# ------------------------------------------------------------ the runner --

def _clouds(tmp_path, count, points, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(count):
        p = str(tmp_path / f"c{i}.npy")
        np.save(p, rng.normal(size=(points, 6)).astype(np.float32))
        paths.append(p)
    return paths


def test_run_detector_artifact_ragged(arts, tmp_path):
    det, desc = arts["som"][3], arts["descriptor"][3]
    paths = _clouds(tmp_path, 5, 200, 2)  # batch 2: a ragged last chunk
    out = str(tmp_path / "served")
    stats = art_mod.run_detector_artifact(det, paths, out, num_keypoints=K,
                                          desc_artifact_path=desc,
                                          device="cpu")
    assert stats == {"clouds": 5, "out": out}
    for i in range(5):
        kp = np.fromfile(os.path.join(out, f"c{i}.keypoints.bin"),
                         np.float32)
        assert kp.size == K * 3
        d = np.fromfile(os.path.join(out, f"c{i}.desc.bin"), np.float32)
        assert d.size == K * 16
    # the same seed, the same files
    again = str(tmp_path / "again")
    art_mod.run_detector_artifact(det, paths, again, num_keypoints=K,
                                  desc_artifact_path=desc, device="cpu")
    for name in os.listdir(out):
        with open(os.path.join(out, name), "rb") as a, \
                open(os.path.join(again, name), "rb") as b:
            assert a.read() == b.read(), name


def test_run_pipeline_artifact_pairs_rows(arts, tmp_path):
    pipe = arts["pipeline"][3]
    paths = _clouds(tmp_path, 3, 150, 4)
    out = str(tmp_path / "served")
    stats = art_mod.run_detector_artifact(pipe, paths, out, num_keypoints=10,
                                          device="cpu")
    assert stats["clouds"] == 3
    for i in range(3):
        kp = np.fromfile(os.path.join(out, f"c{i}.keypoints.bin"),
                         np.float32).reshape(-1, 3)
        d = np.fromfile(os.path.join(out, f"c{i}.desc.bin"),
                        np.float32).reshape(-1, 16)
        # paired rows of the model's 16 proposals, no padding
        assert kp.shape[0] == d.shape[0] == 10
    with pytest.raises(ValueError, match="already embeds"):
        art_mod.run_detector_artifact(pipe, paths, out,
                                      desc_artifact_path=pipe, device="cpu")


def test_run_detector_artifact_contract_errors(arts, tmp_path):
    det, desc = arts["som"][3], arts["descriptor"][3]
    (p,) = _clouds(tmp_path, 1, 64, 0)
    with pytest.raises(ValueError, match="expected a detector"):
        art_mod.run_detector_artifact(desc, [p], str(tmp_path / "x"),
                                      device="cpu")
    with pytest.raises(ValueError, match="exported for 12 keypoints"):
        art_mod.run_detector_artifact(det, [p], str(tmp_path / "y"),
                                      num_keypoints=8,
                                      desc_artifact_path=desc, device="cpu")
    # a file holds programs only for the platforms it was exported for
    header, blob = art_mod._read(det)
    cuda_only = str(tmp_path / "cuda_only.usipart")
    art_mod._write(cuda_only, dict(header, platforms=["cuda"]),
                   {"cuda": blob})
    with pytest.raises(ValueError, match="not for 'cpu'"):
        art_mod.load_artifact(cuda_only, "cpu")


def test_bad_magic_and_usip_tpu_artifacts_rejected(arts, tmp_path):
    p = str(tmp_path / "junk.usipart")
    with open(p, "wb") as f:
        f.write(b"NOTMAGIC" + b"\x00" * 32)
    with pytest.raises(ValueError, match="bad magic"):
        art_mod.load_artifact(p, "cpu")
    with pytest.raises(ValueError, match=r"usip_tpu \(JAX\) model artifact"):
        art_mod.load_artifact(arts["som"][2], "cpu")
    # and usip_tpu refuses the port's file
    with pytest.raises(ValueError, match="bad magic"):
        jax_art.load_artifact(arts["som"][3])


def test_cuda_platform_and_device_need_cuda(arts, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the refusals hold where CUDA is absent")
    cfg, ckpt, _, tpath = arts["som"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        art_mod.export_detector_artifact(cfg, ckpt, str(tmp_path / "c"),
                                         batch=B)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        art_mod.load_artifact(tpath)
    with pytest.raises(ValueError, match="choose from"):
        art_mod.export_detector_artifact(cfg, ckpt, str(tmp_path / "t"),
                                         batch=B, platforms=("tpu",))


def test_runner_loads_no_model_code(arts, tmp_path):
    """In a fresh interpreter, ``run-model`` (through ``cli.main``) and
    ``run_detector_artifact`` load an artifact and serve clouds with no
    module of usip_tpu, jax, or the port's models, nn, train, weights or
    config loaded."""
    paths = _clouds(tmp_path, 3, 150, 9)
    code = (
        "import sys\n"
        "from usip_tpu_torch import cli\n"
        f"cli.main(['run-model', '--artifact', {arts['som'][3]!r}, "
        f"'--input', {str(tmp_path)!r}, '--out', {str(tmp_path / 'a')!r}, "
        "'--device', 'cpu', '--num-keypoints', '8'])\n"
        "from usip_tpu_torch.model_artifact import run_detector_artifact\n"
        f"run_detector_artifact({arts['pipeline'][3]!r}, {paths!r}, "
        f"{str(tmp_path / 'b')!r}, 8, device='cpu')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('usip_tpu', 'jax', 'flax') or m.split('.')[:2] in ("
        "['usip_tpu_torch', 'models'], ['usip_tpu_torch', 'nn'], "
        "['usip_tpu_torch', 'train'], ['usip_tpu_torch', 'weights'], "
        "['usip_tpu_torch', 'config'])]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(os.listdir(tmp_path / "a")) == 3
    assert len(os.listdir(tmp_path / "b")) == 6


def test_export_model_and_run_model_commands(arts, tmp_path):
    """``export-model`` (two artifacts, and ``--pipeline``) and ``run-model``
    through ``cli.main`` on the CPU."""
    from usip_tpu_torch import cli
    _, ckpt, _, _ = arts["som"]
    _, dckpt, _, _ = arts["descriptor"]
    flags = ["--dataset", "modelnet", "--platforms", "cpu", "--batch", "2"]
    for k, v in TINY.items():
        flags += ["--override", f"{k}={v}"]
    det = str(tmp_path / "det.usipart")
    cli.main(["export-model", "--checkpoint", ckpt, "--out", det,
              "--descriptor-checkpoint", dckpt, "--num-keypoints", "8",
              *flags])
    desc = str(tmp_path / "det.descriptor.usipart")
    assert art_mod._read(desc)[0]["keypoint_num"] == 8
    pipe = str(tmp_path / "pipe.usipart")
    cli.main(["export-model", "--checkpoint", ckpt, "--out", pipe,
              "--descriptor-checkpoint", dckpt, "--pipeline", *flags])
    assert art_mod._read(pipe)[0]["kind"] == "pipeline"
    _clouds(tmp_path, 3, 150, 1)
    for artifact, extra in ((det, ["--desc-artifact", desc]), (pipe, [])):
        out = str(tmp_path / ("served_" + os.path.basename(artifact)))
        cli.main(["run-model", "--artifact", artifact, "--input",
                  str(tmp_path / "*.npy"), "--out", out, "--device", "cpu",
                  "--num-keypoints", "8", *extra])
        assert sorted(os.listdir(out)) == sorted(
            f"c{i}.{s}.bin" for i in range(3) for s in ("keypoints", "desc"))
    with pytest.raises(SystemExit, match="--pipeline needs"):
        cli.main(["export-model", "--checkpoint", ckpt, "--out", pipe,
                  "--pipeline", *flags])


# ------------------------------------------------------------ the ops ----

def _op_cases():
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
    nodes = pts[:, :8].contiguous()
    det = Detector(get_config("modelnet", **TINY).detector).eval()
    chain = kernels.prepare_chain(*kernels.fusion_chain_params(
        det.knnlayer_1))
    grouped = torch.from_numpy(rng.normal(size=(2, 8, 4, 19)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(0, 6, size=(2, 64)))
    return {
        "fps": (pts, torch.tensor([0, 5], dtype=torch.int32), 16),
        "min_argmin": (pts, nodes, True),
        "fusion_chain": (grouped, chain.packed, *chain.biases, 19, 16, 32),
        "smallest_k": (pts[..., 0].contiguous(), 100),
        "scatter_max": (torch.from_numpy(rng.normal(size=(2, 64, 8)).astype(
            np.float32)), ids, 8),
    }


@pytest.mark.parametrize("op", USIP_OPS)
def test_custom_op_fake_matches_cpu_kernel(op):
    """Each op's fake kernel gives its CPU kernel's shapes and dtypes
    (``torch.library.opcheck``: the schema, the fake tensor, and the
    autograd registration of an op without gradients); its CPU kernel is the
    plain version."""
    args = _op_cases()[op]
    fn = getattr(torch.ops.usip, op).default
    torch.library.opcheck(fn, args, test_utils=(
        "test_schema", "test_faketensor", "test_autograd_registration"))
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else a
                     for a in args]
        fake = fn(*fake_args)
    real = fn(*args)
    fake = fake if isinstance(fake, tuple) else (fake,)
    real = real if isinstance(real, tuple) else (real,)
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype) == (r.shape, r.dtype), op
