"""The kernels' forms and the ablation's variants, on the CPU (no GPU, no
nvcc needed).

* ``kernels.fps_form`` and ``kernels.scatter_max_form`` choose the form that
  ``csrc/fps.cu`` and ``csrc/scatter_max.cu`` are launched with: their
  choices at the serving paths' shapes and at the edges of each form, and
  their limits.
* ``python -m usip_tpu_torch.ablate`` builds each variant as text patches on
  the shipped ``csrc/*.cu``: every patch must still occur in the source it
  patches (a stale patch would otherwise show only on the card), and every
  form a variant forces must be one the kernel takes.
"""

import pytest

from usip_tpu_torch import _build, ablate
from usip_tpu_torch.ops import kernels

_VARIANTS = [(name, v) for name in ablate.KERNELS
             for v in ablate.VARIANTS[name]]


@pytest.mark.parametrize("name,variant", _VARIANTS,
                         ids=[f"{n}-{i}" for n in ablate.KERNELS
                              for i in range(len(ablate.VARIANTS[n]))])
def test_ablation_patches_apply_to_shipped_source(name, variant):
    shipped = (_build.CSRC / f"{name}.cu").read_text()
    for old, new in variant.patches:
        assert old in shipped, f"{variant.label!r}: {old!r} not in {name}.cu"
        assert old != new
    patched = ablate.patched_source(name, variant)
    assert (patched != shipped) == bool(variant.patches)


@pytest.mark.parametrize("name", ablate.KERNELS)
def test_ablation_lists(name):
    """The first variant is the shipped kernel as it stands; labels are
    unique; only a kernel whose wrapper has a form function forces forms."""
    variants = ablate.VARIANTS[name]
    assert variants[0].patches == () and variants[0].form is None
    assert not variants[0].timing_only
    assert len({v.label for v in variants}) == len(variants)
    if name not in ablate._FORM_FNS:
        assert all(v.form is None for v in variants)


def _fps_form_ok(form, s):
    threads, ppt, in_registers = form
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert threads * ppt >= s
    if in_registers:
        assert ppt in (1, 2, 4, 8, 16)
        assert ppt < 16 or threads <= 512
    else:
        assert ppt == 16


@pytest.mark.parametrize("variant", [v for v in ablate.K1_VARIANTS if v.form],
                         ids=lambda v: v.label)
def test_fps_ablation_forms_are_taken(variant):
    """Every forced K1 form covers the ablation's 2048-point clouds with a
    form the C entry point takes."""
    _fps_form_ok(variant.form, 2048)


@pytest.mark.parametrize("variant",
                         [v for v in ablate.K5_VARIANTS if v.form],
                         ids=lambda v: v.label)
def test_scatter_ablation_forms_are_taken(variant):
    cluster, tile = variant.form
    assert 1 <= cluster <= 8 and tile in (8, 16, 32)
    assert 4 * tile * 512 <= kernels._MAX_SMEM


@pytest.mark.parametrize("s,form", [
    (1, (32, 1, True)), (32, (32, 1, True)), (33, (32, 2, True)),
    (65, (32, 4, True)), (129, (32, 8, True)), (256, (32, 8, True)),
    (257, (64, 8, True)), (2047, (256, 8, True)), (2048, (256, 8, True)),
    (2049, (288, 8, True)), (8192, (1024, 8, True)),
    (8193, (544, 16, False)), (kernels.FPS_MAX_S, (928, 16, False))])
def test_fps_form_choices(s, form):
    """256 threads of 8 points at the serving paths' 2048-point subsets; the
    fewest points a thread (up to 8, coordinates in registers) that one warp
    covers, then the fewest warps; 16 points a thread from shared memory
    past 8192 points."""
    assert kernels.fps_form(s) == kernels.FpsForm(*form)


def test_fps_form_every_size():
    """For every S the wrapper takes: a form the kernel takes, with the
    fewest warps, and the cloud's coordinate planes in shared memory."""
    for s in range(1, kernels.FPS_MAX_S + 1):
        form = kernels.fps_form(s)
        _fps_form_ok(form, s)
        assert (form.threads - 32) * form.points_per_thread < s
        assert form.in_registers == (s <= 8192)
        assert 12 * s + 1024 <= kernels._MAX_SMEM


@pytest.mark.parametrize("s", [0, -1, kernels.FPS_MAX_S + 1])
def test_fps_form_limits(s):
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fps_form(s)
    assert kernels.FPS_MAX_S == kernels._MAX_SMEM // 16 == 14528


@pytest.mark.parametrize("n,m,form", [
    (16384, 512, (4, 32)), (4096, 512, (1, 32)), (8191, 512, (1, 32)),
    (8192, 512, (2, 32)), (16383, 512, (2, 32)), (32768, 512, (8, 32)),
    (10 ** 6, 512, (8, 32)), (0, 1, (1, 32)), (16384, 1816, (4, 32)),
    (16384, 1817, (4, 16)), (16384, 3632, (4, 16)), (16384, 3633, (4, 8)),
    (16384, 7264, (4, 8))])
def test_scatter_max_form_choices(n, m, form):
    """Clusters of 4 at the SOM trunk's 16384 points (each block at least
    4096 points, at most 8 blocks); the widest channel tile whose (M, tile)
    accumulator fits one block."""
    got = kernels.scatter_max_form(n, m)
    assert got == kernels.ScatterForm(*form)
    assert 4 * got.tile * m <= kernels._MAX_SMEM


@pytest.mark.parametrize("m", [0, -3, 7265])
def test_scatter_max_form_limits(m):
    with pytest.raises(ValueError, match="shared memory"):
        kernels.scatter_max_form(16384, m)


# the four shapes K2 is timed at: serve and train assignments, the train
# step's keypoint -> cloud and keypoint chamfer
_K2_SHAPES = [(8, 16384, 512), (16, 16384, 512), (8, 512, 16384),
              (8, 512, 512)]


@pytest.mark.parametrize("variant",
                         [v for v in ablate.K2_VARIANTS if v.form],
                         ids=lambda v: v.label)
@pytest.mark.parametrize("shape", _K2_SHAPES)
def test_min_argmin_ablation_forms_are_taken(variant, shape):
    """Every forced K2 form, at each shape, is one the C entry point takes
    and whose shared memory fits one block; the forced field is the one the
    label names and the rest is the shipped form's."""
    b, n, m = shape
    f = variant.form(b, n, m)
    shipped = kernels.min_argmin_form(b, n, m)
    assert f.threads % 32 == 0 and 32 <= f.threads <= 256
    assert f.points_per_thread in (1, 2, 4, 8)
    assert 1 <= f.split <= 16 and f.tile % 2 == 0
    assert 16 * f.tile + 8 * f.threads * f.points_per_thread \
        <= kernels._MAX_SMEM
    assert f.threads == shipped.threads
    chunk = -(-m // f.split)
    assert f.tile == min(2048, chunk + chunk % 2)
    if "no split" in variant.label:
        assert f.split == 1
    elif "split 8" in variant.label:
        assert f.split == (8 if shipped.split > 1 else 1)
    else:
        assert f.split == shipped.split
        assert variant.label.startswith(f"{f.points_per_thread} quer")


def test_min_argmin_ablation_restores_the_form():
    """The ablation's forms wrap the shipped form function, which the
    module still holds."""
    assert ablate._SHIPPED_FORMS["min_argmin"] is kernels.min_argmin_form
