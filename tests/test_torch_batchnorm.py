"""Train-mode BatchNorm's five stages (``ops/kernels.py batch_norm_*``,
``csrc/batch_norm.cu``) and the layer that chains them
(``nn/layers.py _TrainBatchNorm``).

On the CPU (where the ops, CUDA only, are not run: the plain stages stand
in for the kernels):

* the plain stages, statistics -> finalise -> apply and backward reduce ->
  backward apply, against autograd of ``batch_norm_plain`` (the CPU's
  path, today's layer): outputs, ``dx``, the weight's and bias's
  gradients, the running statistics and the batch count, in bf16 and fp32,
  at the port's widths and one not a multiple of 8, with and without the
  fused ReLU;
* the autograd Function that chains them, on CPU tensors;
* two ranks: each rank's weight and bias gradients from its own rows, its
  ``dx`` from the totals of both, against one rank holding every row;
* the ops' fake kernels against the plain stages' shapes, the wrappers
  refusing CPU tensors, the kernel's forms, its build entry and launch
  count; ``PointwiseLayer`` on the CPU as before.

On the card (the ``cuda`` marker; they skip elsewhere; on a GPU host, where
jax is absent: ``python -m pytest --noconftest -m cuda
tests/test_torch_batchnorm.py -q``): each kernel against its plain stage at
the train cells' shapes, the ops under ``torch.library.opcheck``, the same
bits on a second run, and the layer
through the kernels alone, its launches under a replayed step the eager
step's.
"""

import types

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from usip_tpu_torch import _build
from usip_tpu_torch.nn import layers
from usip_tpu_torch.nn.layers import (BatchNorm, PointwiseLayer,
                                      _TrainBatchNorm, batch_norm_plain)
from usip_tpu_torch.ops import kernels
from torch_dist_common import BN_STAGES, plain_bn_stages

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
WIDTHS = (32, 64, 128, 256, 512, 100)
MOMENTUM = 0.3


def _layer(c, seed=0):
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c).train()
    bn.momentum = MOMENTUM
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
        bn.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn


def _rows(shape, dtype, seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = 2.0 * torch.randn(shape, generator=gen) + 0.5
    up = torch.randn(shape, generator=gen)
    return x.to(dtype), up.to(dtype)


def _plain(bn, x, up, relu):
    """Autograd of ``batch_norm_plain`` (and the layer's ReLU): output,
    dx, weight and bias gradients."""
    x = x.clone().requires_grad_(True)
    y = bn(x, relu=relu)
    (y.float() * up.float()).sum().backward()
    return y.detach(), x.grad, bn.weight.grad, bn.bias.grad


def _close(got, ref, what):
    """Within one rounding of ``ref``'s dtype at its largest value (bf16:
    2^-8; fp32: 1e-6)."""
    tol = (2.0 ** -8 if ref.dtype == torch.bfloat16 else 1e-6)
    scale = max(float(ref.float().abs().max()), 1e-30)
    err = float((got.float() - ref.float()).abs().max())
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    assert err <= tol * scale, (what, err, scale)


@pytest.fixture
def plain_stages():
    with plain_bn_stages():
        yield


def _same_state(bn, ref):
    for name in ("running_mean", "running_var"):
        _close(getattr(bn, name), getattr(ref, name), name)
    assert torch.equal(bn.num_batches_tracked, ref.num_batches_tracked)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "none"])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_stages_are_autograd_of_plain(dtype, c, relu):
    """stats -> finalise -> apply and backward reduce -> backward apply (the
    plain stages, chained by hand) give autograd's output, gradients,
    running statistics and batch count of ``batch_norm_plain``."""
    dt = DTYPES[dtype]
    x, up = _rows((3, 70, c), dt)
    ref = _layer(c)
    y_ref, dx_ref, dw_ref, db_ref = _plain(ref, x, up, relu)

    bn = _layer(c)
    totals = kernels.batch_norm_stats_plain(x)
    assert float(totals[-1]) == 210.0
    mean, rstd = kernels.batch_norm_finalise_plain(
        totals, bn.running_mean, bn.running_var, bn.num_batches_tracked,
        MOMENTUM, bn.eps)
    y = kernels.batch_norm_apply_plain(x, mean, rstd, bn.weight.detach(),
                                       bn.bias.detach(), relu)
    dy = up.float().to(dt)
    sum_g, sum_gx = kernels.batch_norm_backward_reduce_plain(
        dy, x, mean, rstd, bn.weight.detach(), bn.bias.detach(), relu)
    dx = kernels.batch_norm_backward_apply_plain(
        dy, x, mean, rstd, bn.weight.detach(), bn.bias.detach(), sum_g,
        sum_gx, totals[-1:], relu)
    _close(y, y_ref, "y")
    _close(dx, dx_ref, "dx")
    _close(sum_gx, dw_ref, "weight grad")
    _close(sum_g, db_ref, "bias grad")
    _same_state(bn, ref)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "none"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_function_chains_the_stages(plain_stages, dtype, relu):
    """``_TrainBatchNorm`` (the CUDA route, run here on the plain stages)
    against the CPU layer: the gradients land on the right inputs."""
    dt = DTYPES[dtype]
    x, up = _rows((2, 5, 33, 64), dt, seed=3)
    ref = _layer(64, seed=2)
    y_ref, dx_ref, dw_ref, db_ref = _plain(ref, x, up, relu)
    bn = _layer(64, seed=2)
    xg = x.clone().requires_grad_(True)
    y = _TrainBatchNorm.apply(xg, bn.weight, bn.bias, bn, relu)
    (y.float() * up.float()).sum().backward()
    _close(y.detach(), y_ref, "y")
    _close(xg.grad, dx_ref, "dx")
    _close(bn.weight.grad, dw_ref, "weight grad")
    _close(bn.bias.grad, db_ref, "bias grad")
    _same_state(bn, ref)


class _OtherRank:
    """Stands in for ``torch.distributed`` on rank 0 of two: each
    all-reduce adds what rank 1 (``x1``, ``up1``) contributes to it, the
    forward's totals first, then the backward's sums at the global mean and
    1/std the first gave."""

    def __init__(self, x1, up1, bn, relu, group):
        self.x1, self.dy1, self.bn, self.relu = x1, up1, bn, relu
        self.group, self.calls = group, 0

    def all_reduce(self, t, group=None):
        assert group == self.group
        w, b = self.bn.weight.detach(), self.bn.bias.detach()
        if self.calls == 0:
            self.totals = t + kernels.batch_norm_stats_plain(self.x1)
            t.copy_(self.totals)
        else:
            c = w.shape[0]
            count = self.totals[2 * c:]
            mean = self.totals[:c] / count
            var = (self.totals[c:2 * c] / count - mean.square()).clamp_min(0)
            rstd = torch.rsqrt(var + self.bn.eps)
            t.add_(torch.cat(kernels.batch_norm_backward_reduce_plain(
                self.dy1, self.x1, mean, rstd, w, b, self.relu)))
        self.calls += 1


@pytest.mark.parametrize("group", [None, "pg"], ids=["default", "named"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "none"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_two_ranks_split_local_and_global_totals(monkeypatch, plain_stages,
                                                 dtype, relu, group):
    """Rank 0 of two: its output and ``dx`` from the totals of both ranks
    (those of one rank holding every row), its weight and bias gradients
    from its own rows (what the data-parallel gradient sum adds to rank 1's),
    the running statistics from the global count; over a mesh's default
    group (its ``group`` None, as ``make_mesh`` gives) and a named one."""
    dt = DTYPES[dtype]
    x, up = _rows((2, 96, 100), dt, seed=4)
    ref = _layer(100, seed=5)
    y_ref, dx_ref, dw_ref, db_ref = _plain(ref, x, up, relu)

    bn = _layer(100, seed=5)
    bn.process_group = types.SimpleNamespace(size=2, group=group)
    other = _OtherRank(x[1:], up[1:], bn, relu, group)
    monkeypatch.setattr(layers, "dist", other)
    x0 = x[:1].clone().requires_grad_(True)
    y0 = _TrainBatchNorm.apply(x0, bn.weight, bn.bias, bn, relu)
    (y0.float() * up[:1].float()).sum().backward()
    assert other.calls == 2
    _close(y0.detach(), y_ref[:1], "y")
    _close(x0.grad, dx_ref[:1], "dx")
    _same_state(bn, ref)
    # rank 1's gradients of the parameters, from its own rows
    _, _, w1, b1 = _plain(_layer(100, seed=5), x[1:], up[1:], relu)
    w, b = bn.weight.detach(), bn.bias.detach()
    c = 100
    count = other.totals[2 * c:]
    mean = other.totals[:c] / count
    rstd = torch.rsqrt((other.totals[c:2 * c] / count - mean.square())
                       .clamp_min(0) + bn.eps)
    g1, gx1 = kernels.batch_norm_backward_reduce_plain(
        up[1:], x[1:], mean, rstd, w, b, relu)
    _close(bn.weight.grad + gx1, dw_ref, "weight grad, both ranks")
    _close(bn.bias.grad + g1, db_ref, "bias grad, both ranks")
    g0, gx0 = kernels.batch_norm_backward_reduce_plain(
        up[:1], x[:1], mean, rstd, w, b, relu)
    assert torch.equal(bn.weight.grad, gx0) and torch.equal(bn.bias.grad, g0)


def _op_cases():
    x, up = _rows((2, 40, 24), torch.bfloat16, seed=6)
    bn = _layer(24, seed=7)
    w, b = bn.weight.detach(), bn.bias.detach()
    totals = kernels.batch_norm_stats_plain(x)
    mean, rstd = kernels.batch_norm_finalise_plain(
        totals, bn.running_mean.clone(), bn.running_var.clone(),
        bn.num_batches_tracked.clone(), 0.1, 1e-5)
    sg, sgx = kernels.batch_norm_backward_reduce_plain(up, x, mean, rstd, w,
                                                       b, True)
    return {
        "batch_norm_stats": (x,),
        "batch_norm_finalise": (totals, bn.running_mean, bn.running_var,
                                bn.num_batches_tracked, 0.1, 1e-5),
        "batch_norm_apply": (x, mean, rstd, w, b, True),
        "batch_norm_backward_reduce": (up, x, mean, rstd, w, b, True),
        "batch_norm_backward_apply": (up, x, mean, rstd, w, b, sg, sgx,
                                      totals[-1:], True),
    }


BN_OPS = list(BN_STAGES)
# the arguments each op writes in place
BN_WRITES = {"batch_norm_finalise": {"running_mean", "running_var",
                                     "num_batches_tracked"}}


@pytest.mark.parametrize("op", BN_OPS)
def test_fake_kernels_give_the_cpu_shapes(op):
    """Each op's fake kernel gives its plain stage's shapes and dtypes on
    CPU tensors, its schema marks what it writes in place, and its wrapper
    refuses CPU tensors (no fallback to the plain stage)."""
    args = _op_cases()[op]
    fn = getattr(torch.ops.usip, op).default
    with FakeTensorMode() as mode:
        fake = fn(*[mode.from_tensor(a) if torch.is_tensor(a) else a
                    for a in args])
    real = getattr(kernels, op + "_plain")(
        *[a.clone() if torch.is_tensor(a) else a for a in args])
    fake = fake if isinstance(fake, tuple) else (fake,)
    real = real if isinstance(real, tuple) else (real,)
    assert len(fake) == len(real), op
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype) == (r.shape, r.dtype), op
    writes = {a.name for a in fn._schema.arguments
              if a.alias_info is not None and a.alias_info.is_write}
    assert writes == BN_WRITES.get(op, set()), op
    with pytest.raises(ValueError, match="CUDA"):
        getattr(kernels, op)(*args)


def test_kernel_is_built_and_counted():
    """``csrc/batch_norm.cu`` is a kernel of the build, its entry points
    counted under one ``LAUNCHES`` key; ``batch_norm`` binds the statistics
    pass (what a loader that warms every ``KERNELS`` entry binds)."""
    assert "batch_norm" in _build.KERNELS
    assert (_build.CSRC / "batch_norm.cu").exists()
    assert "batch_norm" in kernels.LAUNCHES
    entries = [n for n in kernels._SIGNATURES if n.startswith("batch_norm")]
    assert {kernels._library(n) for n in entries} == {"batch_norm"}
    assert kernels._SIGNATURES["batch_norm"][0] == "usip_bn_stats"
    assert len(entries) == 6
    source = (_build.CSRC / "batch_norm.cu").read_text()
    for n in entries:
        assert f"int {kernels._SIGNATURES[n][0]}(" in source, n
    code = source[source.index("#include"):]
    assert "atomic" not in code


# rows, C, itemsize, misaligned -> the form the docstring gives, or its
# invariants
FORMS = [(262144, 64, 2, 8), (262144, 128, 2, 8), (131072, 256, 2, 8),
         (131072, 512, 2, 8), (8192, 512, 4, 4), (8192, 256, 4, 4),
         (262144, 32, 2, 8), (3670016, 64, 2, 8), (210, 100, 2, 4),
         (210, 100, 4, 4), (100, 4096, 4, 4), (7, 3, 2, 1), (0, 64, 2, 8)]


@pytest.mark.parametrize("rows,c,itemsize,vec", FORMS)
def test_form_covers_the_rows(rows, c, itemsize, vec):
    """The widest vector that divides C (16 bytes at most), at most 256
    vectors a block, every row and channel covered once, chunks whole
    multiples of the rows a block takes at a time, about four blocks an SM;
    a misaligned pointer halves the vector until it is aligned."""
    form = kernels.batch_norm_form(rows, c, itemsize, (256,))
    assert form.vec == vec
    assert form.tile <= kernels._BN_THREADS
    assert form.tile * form.tiles * form.vec >= c > (form.tiles - 1) * \
        form.tile * form.vec
    per = kernels._BN_THREADS // form.tile
    assert form.rows_per_block % per == 0
    assert form.blocks * form.rows_per_block >= rows
    assert (form.blocks - 1) * form.rows_per_block < max(rows, 1)
    assert form.blocks * form.tiles <= kernels._BN_BLOCKS + form.tiles
    if rows >= 100000:
        assert form.blocks * form.tiles >= kernels._BN_BLOCKS // 2
    if vec > 1:
        odd = kernels.batch_norm_form(rows, c, itemsize,
                                      (256, 256 + itemsize * vec // 2))
        assert odd.vec == vec // 2


def test_form_of_the_detector_rows():
    assert kernels.batch_norm_form(262144, 64, 2, (0,)) == (8, 8, 1, 512, 512)
    assert kernels.batch_norm_form(8192, 512, 4, (0,)) == (4, 128, 1, 16, 512)


@pytest.mark.parametrize("activation", ["relu", "elu", None])
def test_pointwise_layer_on_the_cpu_is_unchanged(activation):
    """On CPU tensors a train-mode ``PointwiseLayer`` is its dense map,
    ``batch_norm_plain`` and its activation, bit for bit, gradients too."""
    torch.manual_seed(0)
    layer = PointwiseLayer(12, 40, activation, "batch", torch.bfloat16).train()
    twin = PointwiseLayer(12, 40, activation, "batch", torch.bfloat16).train()
    twin.load_state_dict(layer.state_dict())
    x = torch.randn(2, 30, 12)
    y = layer(x)
    act = layers.activation_fn(activation)
    ref = act(batch_norm_plain(twin.norm, twin.conv(x, torch.bfloat16)))
    assert torch.equal(y, ref)
    y.float().sum().backward()
    ref.float().sum().backward()
    for p, q in zip(layer.parameters(), twin.parameters()):
        assert torch.equal(p.grad, q.grad)
    for p, q in zip(layer.buffers(), twin.buffers()):
        assert torch.equal(p, q)


# ----------------------------------------------------------------- card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")
    return torch.device("cuda")


# (rows shape, dtype): the KITTI detector step's train-mode layers
# (first_pointnet, second_pointnet, kNN fusion before and after, the head's
# fp32 mlp1/mlp2) and the descriptor step's balls of 64 around 256 keypoints
# of 8 clouds (it describes the anchors, then the positives), conv1-conv4
CARD_SHAPES = [((16, 16384, 64), "bf16"), ((16, 16384, 128), "bf16"),
               ((16, 512, 16, 256), "bf16"), ((16, 512, 16, 512), "bf16"),
               ((16, 512, 512), "fp32"), ((16, 512, 256), "fp32"),
               ((8, 256, 64, 32), "bf16"), ((8, 256, 64, 64), "bf16"),
               ((8, 256, 64, 128), "bf16")]


def _card_rows(shape, dtype, dev):
    x, up = _rows(shape, DTYPES[dtype], seed=11)
    return x.to(dev), up.to(dev)


def _rel(got, ref, what, tol):
    scale = max(float(ref.float().abs().max()), 1e-30)
    err = float((got.detach().float().cpu() - ref.float().cpu()).abs()
                .max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "none"])
@pytest.mark.parametrize("shape,dtype", CARD_SHAPES,
                         ids=[f"{'x'.join(map(str, s))}-{d}"
                              for s, d in CARD_SHAPES])
def test_kernels_are_their_plain_stages(dev, shape, dtype, relu):
    """Each kernel against its plain stage on the same inputs: the sums to
    1e-5 of their largest (another order of addition), mean and 1/std to
    1e-5, the running statistics to 1e-5, the apply bit for bit (the same
    rounding steps), dx within one rounding of its dtype; each call
    launches its kernels (stats 2, finalise 1, apply 1, backward reduce 2,
    backward apply 1)."""
    x, up = _card_rows(shape, dtype, dev)
    c = shape[-1]
    bn = _layer(c, seed=12).to(dev)
    w, b = bn.weight.detach(), bn.bias.detach()
    cpu = {k: v.cpu() for k, v in
           (("x", x), ("up", up), ("w", w), ("b", b))}
    kernels.reset_launch_counts()
    totals = kernels.batch_norm_stats(x)
    _rel(totals, kernels.batch_norm_stats_plain(cpu["x"]), "totals", 1e-5)
    assert kernels.LAUNCHES["batch_norm"] == 2
    rm, rv, nb = (bn.running_mean.cpu(), bn.running_var.cpu(),
                  bn.num_batches_tracked.cpu())
    mean, rstd = kernels.batch_norm_finalise(
        totals, bn.running_mean, bn.running_var, bn.num_batches_tracked,
        MOMENTUM, bn.eps)
    mean_p, rstd_p = kernels.batch_norm_finalise_plain(
        totals.cpu(), rm, rv, nb, MOMENTUM, bn.eps)
    for got, ref, what in ((mean, mean_p, "mean"), (rstd, rstd_p, "rstd"),
                           (bn.running_mean, rm, "running_mean"),
                           (bn.running_var, rv, "running_var")):
        _rel(got, ref, what, 1e-5)
    assert int(bn.num_batches_tracked) == int(nb) == 1
    m, r = mean.cpu(), rstd.cpu()
    y = kernels.batch_norm_apply(x, mean, rstd, w, b, relu)
    assert torch.equal(y.cpu(), kernels.batch_norm_apply_plain(
        cpu["x"], m, r, cpu["w"], cpu["b"], relu))
    sg, sgx = kernels.batch_norm_backward_reduce(up, x, mean, rstd, w, b,
                                                 relu)
    sg_p, sgx_p = kernels.batch_norm_backward_reduce_plain(
        cpu["up"], cpu["x"], m, r, cpu["w"], cpu["b"], relu)
    _rel(sg, sg_p, "sum g", 1e-5)
    _rel(sgx, sgx_p, "sum g x_hat", 1e-5)
    dx = kernels.batch_norm_backward_apply(up, x, mean, rstd, w, b, sg, sgx,
                                           totals[-1:], relu)
    dx_p = kernels.batch_norm_backward_apply_plain(
        cpu["up"], cpu["x"], m, r, cpu["w"], cpu["b"], sg.cpu(), sgx.cpu(),
        totals[-1:].cpu(), relu)
    _rel(dx, dx_p, "dx", 2.0 ** -8 if dtype == "bf16" else 1e-6)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["batch_norm"] == 7


@pytest.mark.cuda
@pytest.mark.parametrize("op", BN_OPS)
def test_ops_pass_opcheck_on_the_card(dev, op):
    """``torch.library.opcheck`` of each op on CUDA tensors: the schema,
    mutations included, the fake kernel against the CUDA kernel, and the
    autograd registration of an op without gradients."""
    args = [a.to(dev) if torch.is_tensor(a) else a for a in _op_cases()[op]]
    torch.library.opcheck(getattr(torch.ops.usip, op).default, args,
                          test_utils=("test_schema", "test_faketensor",
                                      "test_autograd_registration"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_layer_runs_the_kernels_alone_and_repeats(dev, dtype):
    """A train-mode ``BatchNorm`` on CUDA rows launches 4 kernels forward and
    3 backward and no other path; twice on the same input and state it
    gives the same bits (no atomics); its result is the CPU layer's."""
    x, up = _card_rows((16, 512, 16, 256), dtype, dev)
    runs = []
    for _ in range(2):
        bn = _layer(256, seed=13).to(dev)
        xg = x.clone().requires_grad_(True)
        kernels.reset_launch_counts()
        y = bn(xg, relu=True)
        assert kernels.LAUNCHES["batch_norm"] == 4
        (y.float() * up.float()).sum().backward()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["batch_norm"] == 7
        assert sum(kernels.LAUNCHES.values()) == 7
        runs.append([y, xg.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean, bn.running_var])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    ref = _layer(256, seed=13)
    y_ref, dx_ref, dw_ref, db_ref = _plain(ref, x.cpu(), up.cpu(), True)
    tol = 2.0 ** -8 if dtype == "bf16" else 1e-5
    _rel(runs[0][0], y_ref, "y", tol)
    _rel(runs[0][1], dx_ref, "dx", 4 * tol)
    _rel(runs[0][2], dw_ref, "weight grad", 1e-4)
    _rel(runs[0][3], db_ref, "bias grad", 1e-4)
    _rel(runs[0][4], ref.running_mean, "running_mean", 1e-5)
    _rel(runs[0][5], ref.running_var, "running_var", 1e-5)


@pytest.mark.cuda
def test_replayed_step_counts_the_eager_launches(dev):
    """The KITTI detector's train step: 7 BatchNorm launches for each of its
    train-mode BatchNorm layers on the eager route, and as many each time
    its CUDA graph replays."""
    from usip_tpu_torch.config import get_config
    from usip_tpu_torch.train.loop import init_detector_state
    from usip_tpu_torch.train.steps import (ParentBatch,
                                            _prepare_detector_inputs,
                                            make_detector_train_step)
    cfg = get_config("kitti", **{"data.input_pc_num": 4096,
                                 "data.parent_pc_num": 5120,
                                 "train.batch_size": 4})
    state = init_detector_state(cfg, 0, dev)
    layers_n = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    gen = torch.Generator(device=dev).manual_seed(3)
    batch = ParentBatch(
        (20 * torch.randn((4, 5120, 3), generator=gen, device=dev)).half(),
        torch.randn((4, 5120, 4), generator=gen, device=dev).half())
    step = make_detector_train_step(cfg)
    kernels.reset_launch_counts()
    step(state, batch, 1, _inputs=_prepare_detector_inputs(
        batch, cfg, True, None, gen))
    torch.cuda.synchronize()
    eager = kernels.LAUNCHES["batch_norm"]
    assert eager == 7 * layers_n > 0
    counts = []
    for _ in range(3):
        kernels.reset_launch_counts()
        step(state, batch, 1, generator=gen)
        counts.append(kernels.LAUNCHES["batch_norm"])
    assert step.graph_counts["replays"] == 2
    assert counts[1:] == [eager, eager]
