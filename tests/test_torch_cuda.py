"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and nvcc (a CUDA kernel has no CPU build), so
they carry the ``cuda`` marker and skip elsewhere. On a GPU host, where jax
is absent, run them without the suite's conftest (which sets jax up):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

They cover the main paths' shapes and shapes off them: odd and ragged
sizes, small widths, K that does not divide the 64-row tile, rows that are
not a multiple of 32, channel counts that are not a multiple of the scatter
tile; min/argmin at its four shapes and on ties, -0.0, negative and
subnormal distances; smallest-k on the descriptor's random-priority ball
scores, fp32 and bf16, on the indoor descriptor's (8, 512, 5000) k=448
balls over room frames, at k = 256, 448 and 512 on long rows and at the
lite detector's node kNN (16, 512, 512) k=32, at the grouped train
steps' (16, 512, 16384) k=64 on natural-order ball scores and knn
distances of urban-like clouds and the SOM k=2 assignment's (16 x 16384
rows of 512) k=2 on bf16 distances and scatter-max over its stacked ids
(16, 32768); the fusion chain and
scatter-max at the lite widths; the train step's nearest-neighbour and
scatter-max gradients against the CPU.
"""

import numpy as np
import pytest
import torch

from usip_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.normal(size=shape) * scale).astype(
        np.float32)).to(dev)


@pytest.mark.parametrize("s,k,dup", [(2048, 512, False), (1000, 77, False),
                                     (1000, 1, False), (600, 300, True)])
def test_fps_kernel_matches_plain(dev, s, k, dup):
    rng = np.random.default_rng(s + k)
    pts = _rand(rng, (3, s, 3), dev, 20.0)
    if dup:
        pts = torch.cat([pts[:, : s // 2], pts[:, : s // 2]], 1).contiguous()
    first = torch.from_numpy(rng.integers(0, s, 3).astype(np.int32)).to(dev)
    got = kernels.fps(pts, first, k)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.fps_plain(pts, first, k))


def _fps_case(dev, b, s, k, seed, pts=None):
    rng = np.random.default_rng(seed)
    if pts is None:
        pts = _rand(rng, (b, s, 3), dev, 20.0)
    first = torch.from_numpy(rng.integers(0, s, b).astype(np.int32)).to(dev)
    got = kernels.fps(pts, first, k)
    torch.cuda.synchronize()
    ref = kernels.fps_plain(pts, first, k)
    assert torch.equal(got, ref)
    return got


# each boundary of the kernel's forms (kernels.fps_form: points a thread x
# threads, +-1), and the largest cloud the wrapper takes
@pytest.mark.parametrize("s", [32, 33, 64, 65, 128, 129, 256, 257, 512,
                               513, 1024, 1025, 2047, 2048, 2049, 4096, 4097,
                               8192, 8193, kernels.FPS_MAX_S])
def test_fps_kernel_form_boundaries(dev, s):
    _fps_case(dev, 2, s, min(s, 300), s)


@pytest.mark.parametrize("s", [1, 33, 1000, 8193])
def test_fps_kernel_k_equals_s(dev, s):
    """Every point picked: the last picks run over distances of 0."""
    got = _fps_case(dev, 2, s, s, s + 1)
    assert torch.equal(got.sort(-1).values,
                       torch.arange(s, dtype=torch.int32,
                                    device=dev).expand(2, s))


def test_fps_kernel_all_points_equal(dev):
    """Every distance 0: each pick after the seed is the lowest index."""
    pts = torch.full((3, 2048, 3), 3.5, device=dev)
    got = _fps_case(dev, 3, 2048, 512, 7, pts)
    assert bool((got[:, 1:] == 0).all())


@pytest.mark.parametrize("b", [1, 64])
def test_fps_kernel_batch(dev, b):
    _fps_case(dev, b, 2048, 512, b)


@pytest.mark.parametrize("n,m", [(16384, 512), (1000, 77), (5, 1)])
@pytest.mark.parametrize("round_bf16", [False, True])
def test_min_argmin_kernel_matches_plain(dev, n, m, round_bf16):
    rng = np.random.default_rng(n + m)
    pts = _rand(rng, (2, n, 3), dev, 10.0)
    nodes = pts[:, :m].contiguous() if m <= n else _rand(rng, (2, m, 3), dev)
    mins, idx = kernels.min_argmin(pts, nodes, round_bf16)
    rmins, ridx = kernels.min_argmin_plain(pts, nodes, round_bf16)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx)
    assert torch.equal(mins, rmins)


def _min_argmin_case(pts, nodes, round_bf16):
    mins, idx = kernels.min_argmin(pts, nodes, round_bf16)
    torch.cuda.synchronize()
    rmins, ridx = kernels.min_argmin_plain(pts, nodes, round_bf16)
    assert torch.equal(idx, ridx)
    assert torch.equal(mins, rmins)
    return mins, idx


# the four shapes of the main paths: the serve and train assignments (bf16),
# the train step's keypoint -> cloud and keypoint chamfer (fp32); each in
# both modes
@pytest.mark.parametrize("b,n,m", [(8, 16384, 512), (16, 16384, 512),
                                   (8, 512, 16384), (8, 512, 512)])
@pytest.mark.parametrize("round_bf16", [False, True])
def test_min_argmin_kernel_main_shapes(dev, b, n, m, round_bf16):
    rng = np.random.default_rng(b + n + m)
    pts = _rand(rng, (b, n, 3), dev, 20.0)
    nodes = (pts[:, :m] if m <= n else _rand(rng, (b, m, 3), dev, 20.0))
    _min_argmin_case(pts, nodes.contiguous(), round_bf16)


# ragged M about the tile (2048) and the cluster split, ragged N about the
# 128-thread blocks
@pytest.mark.parametrize("m", [1, 3, 129, 16384, 20000])
@pytest.mark.parametrize("n", [1, 77, 1000, 4099])
@pytest.mark.parametrize("round_bf16", [False, True])
def test_min_argmin_kernel_ragged(dev, n, m, round_bf16):
    rng = np.random.default_rng(n * 7 + m)
    pts = _rand(rng, (3, n, 3), dev, 5.0)
    nodes = _rand(rng, (3, m, 3), dev, 5.0)
    _min_argmin_case(pts, nodes, round_bf16)


@pytest.mark.parametrize("kind", ["duplicated_nodes", "integer_grid",
                                  "near_coincident", "signed_zero",
                                  "subnormal_products"])
@pytest.mark.parametrize("n,m", [(16384, 512), (512, 16384), (300, 70)])
@pytest.mark.parametrize("round_bf16", [False, True])
def test_min_argmin_kernel_adversarial(dev, kind, n, m, round_bf16):
    """Identical to the plain version where the order is hard to keep:
    every node twice (exact ties, the first wins); integer coordinates (many
    equal distances); nodes 1e-6 from points 100 m out (negative rounded
    distances, clamped to 0, the first of them wins); coordinates near 1e-21
    (distances that round to -0.0 in bf16); coordinates whose products are
    subnormal."""
    rng = np.random.default_rng(n + m + len(kind))
    if kind == "duplicated_nodes":
        pts = rng.normal(0, 5, (2, n, 3))
        half = rng.normal(0, 5, (2, (m + 1) // 2, 3))
        nodes = np.concatenate([half, half], 1)[:, :m]
    elif kind == "integer_grid":
        pts = rng.integers(-4, 5, (2, n, 3))
        nodes = rng.integers(-4, 5, (2, m, 3))
    elif kind == "near_coincident":
        pts = rng.uniform(90, 110, (2, n, 3))
        nodes = pts[:, rng.integers(0, n, m)] + rng.normal(0, 1e-6, (2, m, 3))
    elif kind == "signed_zero":
        pts = rng.normal(0, 1e-21, (2, n, 3))
        nodes = rng.normal(0, 1e-21, (2, m, 3))
    else:
        pts = rng.normal(0, 1e-19, (2, n, 3))
        nodes = rng.normal(0, 1e-20, (2, m, 3))
    to = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)  # noqa: E731
    mins, _ = _min_argmin_case(to(pts), to(nodes), round_bf16)
    # the minimum is a clamped distance
    assert bool((mins >= 0).all())


@pytest.mark.parametrize("bm,k,cin,c,c2", [(4096, 16, 131, 256, 512),
                                           (37, 4, 19, 32, 64),
                                           (50, 3, 35, 64, 32),
                                           (9, 64, 16, 32, 32),
                                           (1000, 16, 67, 128, 256),
                                           (3, 1, 40, 64, 128),
                                           (513, 32, 131, 256, 512),
                                           (4096, 4, 67, 128, 256),
                                           (4096, 32, 67, 128, 256)])
def test_fusion_chain_kernel_matches_plain(dev, bm, k, cin, c, c2):
    """Within 1e-2 * max|plain| (max) and 1e-3 * max|plain| (median): bf16
    operands, fp32 sums in another order. The kernel takes the weights
    packed once by ``prepare_chain``; an odd tile count leaves one block of
    a cluster pair without nodes."""
    rng = np.random.default_rng(bm + k)
    x = _rand(rng, (1, bm, k, cin), dev)
    dims = [(cin, c), (c, c), (c, c), (c, c2), (c, c2), (c2, c2)]
    ws = [_rand(rng, d, dev, (2.0 / d[0]) ** 0.5) for d in dims]
    bs = [_rand(rng, (d[1],), dev, 0.1) for d in dims[:3] + dims[4:]]
    chain = kernels.prepare_chain(ws, bs)
    got = kernels.fusion_chain(x, chain)
    ref = kernels.fusion_chain_plain(x, ws, bs)
    # the packed layout on the card reads back as the bf16 weights
    for w, u in zip(ws, kernels.unpack_chain(chain)):
        assert torch.equal(u, w.to(torch.bfloat16))
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    assert scale > 0
    assert float(err.max()) <= 1e-2 * scale
    assert float(err.median()) <= 1e-3 * scale


@pytest.mark.parametrize("rows,n", [(37, 1000), (5, 16384), (300, 7),
                                    (3, 50000)])
@pytest.mark.parametrize("k", [1, 7, 64, 128])
def test_smallest_k_kernel_matches_plain(dev, rows, n, k):
    """Values and indices identical to the plain version on rows with
    integer ties, +inf runs, NaN and -inf, including k > N."""
    rng = np.random.default_rng(rows * n + k)
    s = rng.integers(-20, 20, size=(rows, n)).astype(np.float32)
    kinds = rng.integers(0, 16, size=s.shape)
    s[kinds == 0] = np.inf
    s[kinds == 1] = np.nan
    s[kinds == 2] = -np.inf
    s[0] = np.inf
    scores = torch.from_numpy(s).to(dev)
    vals, idx = kernels.smallest_k(scores, k)
    rvals, ridx = kernels.smallest_k_plain(scores, k)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx)
    assert torch.equal(vals, rvals)


def _adversarial_rows(rng, rows, n, kind):
    """Rows that stress the select-by-threshold kernel's order: +0.0 and
    -0.0 ties among few distinct values; rows of all +inf (every pick a tie
    at the threshold); NaN, -inf and +inf mixed with finite values."""
    if kind == "signed_zeros":
        s = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32),
                       size=(rows, n))
    elif kind == "inf_rows":
        s = rng.normal(size=(rows, n)).astype(np.float32)
        s[::2] = np.inf
        s[1::4, : n // 3] = np.inf
    else:
        s = rng.normal(size=(rows, n)).astype(np.float32)
        kinds = rng.integers(0, 4, size=s.shape)
        s[kinds == 0] = np.nan
        s[kinds == 1] = -np.inf
        s[kinds == 2] = np.inf
    return s


@pytest.mark.parametrize("kind", ["signed_zeros", "inf_rows", "nan_mix"])
@pytest.mark.parametrize("n", [7, 512, 1000, 16384])
@pytest.mark.parametrize("k", [1, 16, 64, 128])
def test_smallest_k_kernel_adversarial(dev, kind, n, k):
    """Identical to the plain version, values (-0.0 kept as -0.0) and
    indices, on ties at +-0, rows of +inf, NaN/-inf mixes; k > N pads. The
    plain version runs on the CPU here: its stable sort is the contract,
    whatever the card's sort makes of -0.0."""
    rng = np.random.default_rng(n * k + len(kind))
    s = torch.from_numpy(_adversarial_rows(rng, 6, n, kind))
    vals, idx = kernels.smallest_k(s.to(dev), k)
    torch.cuda.synchronize()
    vals, idx = vals.cpu(), idx.cpu()
    rvals, ridx = kernels.smallest_k_plain(s, k)
    assert torch.equal(idx, ridx)
    assert torch.equal(vals, rvals)
    assert torch.equal(torch.signbit(vals), torch.signbit(rvals))


@pytest.mark.parametrize("k", [16, 32, 33])
def test_smallest_k_kernel_many_short_rows(dev, k):
    """4096 rows of N=512: the warp-per-row form (k <= 32) and the block
    form (k = 33), on integer distances full of ties."""
    rng = np.random.default_rng(k)
    s = rng.integers(0, 30, size=(8, 512, 512)).astype(np.float32)
    scores = torch.from_numpy(s).to(dev)
    vals, idx = kernels.smallest_k(scores, k)
    rvals, ridx = kernels.smallest_k_plain(scores, k)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx)
    assert torch.equal(vals, rvals)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("inside", [0.002, 0.05, 0.6])
def test_smallest_k_kernel_random_priorities(dev, bf16, inside):
    """The descriptor's ball scores: uniform priorities (fp32, or rounded
    to bf16: thousands of ties) where a point is in the ball, +inf
    elsewhere, a few to most of 16384 points inside; and the whole ball
    query on the card against the CPU with the same priorities."""
    from usip_tpu_torch.ops import ball_query
    rng = np.random.default_rng(int(inside * 1000) + bf16)
    prio = torch.from_numpy(rng.uniform(size=(64, 16384)).astype(np.float32))
    if bf16:
        prio = prio.to(torch.bfloat16).float()
    s = torch.where(torch.from_numpy(rng.uniform(size=prio.shape) < inside),
                    prio, torch.inf)
    vals, idx = kernels.smallest_k(s.to(dev), 64)
    torch.cuda.synchronize()
    rvals, ridx = kernels.smallest_k_plain(s, 64)
    assert torch.equal(idx.cpu(), ridx) and torch.equal(vals.cpu(), rvals)
    pc = torch.from_numpy(rng.normal(0, 8, (2, 16384, 3)).astype(np.float32))
    kp = pc[:, :256] + 0.3
    pr = torch.from_numpy(rng.uniform(size=(2, 16384)).astype(np.float32))
    got = ball_query(pc.to(dev), kp.to(dev), 2.0, 64, pr.to(dev),
                     round_bf16=bf16)
    ref = ball_query(pc, kp, 2.0, 64, pr, round_bf16=bf16)
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def _room_frame(seed, n=5000):
    """One synthetic SceneNN-style frame of ``n`` points (a view cone of a
    room of ``data/synthetic.py``), in its camera frame."""
    from usip_tpu_torch.data import synthetic
    rng = np.random.default_rng(seed)
    pts, _, _, (w, d, _) = synthetic._make_room(rng)
    cam = np.array([w / 2, d / 2, 1.4])
    target = cam + np.array([w, d * 0.3, -0.4])
    pose = synthetic._camera_pose(cam, target)
    mask = synthetic._view_points(pts, cam, pose[:3, 2], 6.0,
                                  np.cos(np.deg2rad(60.0)))
    (p,) = synthetic._fixed_count(rng, [pts[mask]], n)
    return ((p - cam) @ pose[:3, :3]).astype(np.float32)


@pytest.mark.parametrize("k", [448, 32])
def test_smallest_k_kernel_indoor_ball(dev, k):
    """The indoor descriptor's ball selection, (8, 512, 5000) k=448 in
    radius 0.75 on fp32 random priorities over room frames: some balls
    hold more than k points (past the radix list's 2048 keys in their
    first bin), some fewer (+inf picks past their count); and k=32."""
    from usip_tpu_torch.ops.grouping import ball_scores
    rng = np.random.default_rng(k)
    pc = torch.from_numpy(np.stack([_room_frame(s) for s in range(8)]))
    kp = torch.stack([pc[b, torch.from_numpy(rng.choice(5000, 512,
                                                        replace=False))]
                      for b in range(8)]) + 0.05
    prio = torch.from_numpy(rng.uniform(size=(8, 5000)).astype(np.float32))
    s = ball_scores(pc, kp, 0.75, prio)
    inside = torch.isfinite(s).sum(-1)
    assert bool((inside > 448).any() and (inside < 448).any())
    vals, idx = kernels.smallest_k(s.to(dev), k)
    torch.cuda.synchronize()
    rvals, ridx = kernels.smallest_k_plain(s, k)
    assert torch.equal(idx.cpu(), ridx) and torch.equal(vals.cpu(), rvals)


@pytest.mark.parametrize("inside", [0.02, 0.3, 0.95])
@pytest.mark.parametrize("k", [256, 448, 512])
def test_smallest_k_kernel_large_k(dev, inside, k):
    """k of 256, 448 and 512 on long rows (N = 16384 and 5000) of random
    priorities, fp32, rounded to bf16 (ties), and in [0.5, 1) (every finite
    key in one first-pass bin, more than the radix list's 2048 keys), a few
    to most entries finite: the block form's candidate sort of 256 and
    512."""
    rng = np.random.default_rng(k + int(inside * 100))
    for n in (16384, 5000):
        prio = rng.uniform(size=(64, n)).astype(np.float32)
        prio[32:48] = torch.from_numpy(prio[32:48]).to(
            torch.bfloat16).float()
        prio[48:] = 0.5 + 0.5 * prio[48:]
        s = torch.from_numpy(np.where(rng.uniform(size=prio.shape) < inside,
                                      prio, np.inf).astype(np.float32))
        vals, idx = kernels.smallest_k(s.to(dev), k)
        torch.cuda.synchronize()
        rvals, ridx = kernels.smallest_k_plain(s, k)
        assert torch.equal(idx.cpu(), ridx) and torch.equal(vals.cpu(), rvals)


def test_smallest_k_kernel_node_knn_k32(dev):
    """The lite detector's node kNN in the detector role: (16, 512, 512)
    k=32, on the edge of the warp-per-row form, on the squared distances
    of 512 FPS-like nodes of room frames."""
    from usip_tpu_torch.ops import pairwise_sqdist
    rng = np.random.default_rng(5)
    pc = torch.from_numpy(np.stack([_room_frame(s)[rng.choice(
        5000, 512, replace=False)] for s in range(16)]))
    d = pairwise_sqdist(pc, pc)
    vals, idx = kernels.smallest_k(d.to(dev), 32)
    torch.cuda.synchronize()
    rvals, ridx = kernels.smallest_k_plain(d, 32)
    assert torch.equal(idx.cpu(), ridx) and torch.equal(vals.cpu(), rvals)


def _urban_cloud(rng, b, n):
    """Urban-like clouds: 60% ground over a 25 m disc (denser near the
    centre), 40% on 40 poles of radius 0.5 m and height 4 m, rows in random
    order: some 2 m balls around their points hold more than 64 points,
    some fewer."""
    ng = int(n * 0.6)
    r, t = 25.0 * rng.uniform(size=(b, ng)), rng.uniform(0, 2 * np.pi,
                                                         (b, ng))
    ground = np.stack([r * np.cos(t), r * np.sin(t),
                       rng.normal(0, 0.1, (b, ng))], -1)
    centres = rng.uniform(-18, 18, (b, 40, 2))
    cxy = np.take_along_axis(centres, rng.integers(0, 40, (b, n - ng))[
        ..., None], axis=1)
    pr, pt = 0.5 * np.sqrt(rng.uniform(size=(b, n - ng))), rng.uniform(
        0, 2 * np.pi, (b, n - ng))
    poles = np.stack([cxy[..., 0] + pr * np.cos(pt),
                      cxy[..., 1] + pr * np.sin(pt),
                      rng.uniform(0, 4, (b, n - ng))], -1)
    pc = np.concatenate([ground, poles], 1)
    return np.stack([c[rng.permutation(n)] for c in pc]).astype(np.float32)


@pytest.mark.parametrize("kind", ["ball", "knn"])
def test_smallest_k_kernel_grouped_train_shape(dev, kind):
    """The grouped train step's selection, both siamese copies of 8 clouds
    at once: (16, 512, 16384) k=64 on natural-order ball scores (r=2: the
    point's index inside, +inf outside; balls past 64 and short of it) and
    on knn distances, 512 nodes drawn from each cloud."""
    from usip_tpu_torch.ops import pairwise_sqdist
    from usip_tpu_torch.ops.grouping import ball_scores
    rng = np.random.default_rng(16)
    pc = torch.from_numpy(_urban_cloud(rng, 16, 16384)).to(dev)
    node = pc[:, torch.from_numpy(rng.choice(16384, 512, replace=False)).to(
        dev)].contiguous()
    scores = (ball_scores(pc, node, 2.0) if kind == "ball"
              else pairwise_sqdist(node, pc))
    if kind == "ball":
        inside = torch.isfinite(scores).sum(-1)
        assert bool((inside > 64).any() and (inside < 64).any())
    vals, idx = kernels.smallest_k(scores, 64)
    torch.cuda.synchronize()
    rvals, ridx = kernels.smallest_k_plain(scores, 64)
    assert torch.equal(idx, ridx) and torch.equal(vals, rvals)


def test_smallest_k_kernel_som_k2_assignment(dev):
    """SOM with k=2 nodes a point: each of 16 x 16384 points' two nearest
    of 512 nodes, on the bf16 trunk's rounded distances (many ties among
    near nodes, resolved to the lowest index)."""
    from usip_tpu_torch.ops import pairwise_sqdist
    rng = np.random.default_rng(17)
    pc = torch.from_numpy(_urban_cloud(rng, 16, 16384)).to(dev)
    node = pc[:, torch.from_numpy(rng.choice(16384, 512, replace=False)).to(
        dev)].contiguous()
    d = pairwise_sqdist(pc, node, round_bf16=True)
    vals, idx = kernels.smallest_k(d, 2)
    torch.cuda.synchronize()
    rvals, ridx = kernels.smallest_k_plain(d, 2)
    assert torch.equal(idx, ridx) and torch.equal(vals, rvals)
    assert d.unique().numel() < d.numel() // 4


@pytest.mark.parametrize("c", [64, 128])
def test_scatter_max_kernel_som_k2_stacked_ids(dev, c):
    """SOM with k=2 nodes a point: the masked scatter-max over the stacked
    ids (16, 2 x 16384) of each point's two nearest of 512 nodes (the
    8-block cluster form), at both feature widths of the trunk."""
    from usip_tpu_torch.ops import assign_points_to_nodes
    rng = np.random.default_rng(18)
    pc = torch.from_numpy(_urban_cloud(rng, 16, 16384)).to(dev)
    node = pc[:, torch.from_numpy(rng.choice(16384, 512, replace=False)).to(
        dev)].contiguous()
    ids = assign_points_to_nodes(pc, node, k=2, round_bf16=True).ids
    assert ids.shape == (16, 32768)
    assert kernels.scatter_max_form(32768, 512).cluster == 8
    _scatter_case(dev, _rand(rng, (16, 32768, c), dev, 3.0), ids, 512)


def test_smallest_k_grad_on_card(dev):
    """The autograd wrapper's backward on the card equals the CPU one."""
    from usip_tpu_torch.ops.topk import smallest_k

    s = torch.from_numpy(np.random.default_rng(0).normal(
        size=(6, 777)).astype(np.float32))
    g = torch.from_numpy(np.random.default_rng(1).normal(
        size=(6, 9)).astype(np.float32))
    grads = []
    for d in (dev, torch.device("cpu")):
        x = s.to(d).requires_grad_(True)
        smallest_k(x, 9)[0].backward(g.to(d))
        grads.append(x.grad.cpu())
    assert torch.equal(*grads)


def test_min_argmin_fold_two_would_break_identity(dev):
    """Why csrc/min_argmin.cu keeps the doubling in ``dist``:
    built with candidates pre-scaled by 2 (the ablation's variant), p.(2n)
    stands for 2 (p.n) exactly except where a product is subnormal, where
    fl(2ab) and 2 fl(ab) round on the subnormal grid; on such inputs the
    folded kernel's minima differ from the plain version's, the shipped
    kernel's do not."""
    from usip_tpu_torch import ablate

    rng = np.random.default_rng(13)
    x = rng.uniform(1e-20, 3e-20, 4096).astype(np.float32)
    pts = np.zeros((1, 4096, 3), np.float32)
    pts[0, :, 0] = x
    nodes = np.array([[[2.3e-20, 0.0, 0.0]]], np.float32)
    pts, nodes = torch.from_numpy(pts).to(dev), torch.from_numpy(nodes).to(dev)
    rmins, ridx = kernels.min_argmin_plain(pts, nodes)
    shipped = kernels.min_argmin(pts, nodes)
    variant = next(v for v in ablate.K2_VARIANTS if "pre-scaled by 2" in
                   v.label)
    lib = ablate._build_variants("min_argmin", [variant])[0]
    try:
        ablate._bind("min_argmin", lib)
        folded = kernels.min_argmin(pts, nodes)
        torch.cuda.synchronize()
    finally:
        kernels._FNS.pop("min_argmin", None)
    assert torch.equal(shipped[0], rmins) and torch.equal(shipped[1], ridx)
    assert torch.equal(folded[1], ridx)
    differ = int((folded[0] != rmins).sum())
    print(f"x2 fold: {differ} of 4096 minima differ from the plain version")
    assert differ > 0


def test_nearest_neighbor_grad_on_card(dev):
    """The train step's nearest neighbour (K2 in fp32 and the custom
    backward) on the card against the CPU: indices identical, distances and
    gradients within 1e-6 (the square root is the card's and the CPU's own;
    the card's scatter_add sums in another order)."""
    from usip_tpu_torch.ops.geometry import nearest_neighbor

    rng = np.random.default_rng(11)
    src = rng.normal(0, 5, (4, 512, 3)).astype(np.float32)
    dst = rng.normal(0, 5, (4, 16384, 3)).astype(np.float32)
    src[:, :7] = dst[:, 100:107]
    g = rng.normal(size=(4, 512)).astype(np.float32)
    outs = []
    for d in (dev, torch.device("cpu")):
        s = torch.from_numpy(src).to(d).requires_grad_(True)
        t = torch.from_numpy(dst).to(d).requires_grad_(True)
        dist, idx = nearest_neighbor(s, t)
        (dist * torch.from_numpy(g).to(d)).sum().backward()
        outs.append([x.detach().cpu() for x in (dist, idx, s.grad, t.grad)])
    gpu, cpu = outs
    assert torch.equal(gpu[1], cpu[1])
    for a, b in zip(gpu[:1] + gpu[2:], cpu[:1] + cpu[2:]):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-6), \
            float((a - b).abs().max())


@pytest.mark.parametrize("backend", ["fast", "native"])
def test_masked_scatter_max_grad_on_card(dev, backend):
    """The scatter-max kernel's forward and the plain backward on the card
    against the CPU, on features with ties: identical."""
    from usip_tpu_torch.ops import masked_scatter_max

    rng = np.random.default_rng(12)
    f = np.round(rng.normal(size=(2, 16384, 64)) * 2).astype(np.float32) / 2
    ids = rng.integers(0, 500, size=(2, 16384))
    g = rng.normal(size=(2, 512, 64)).astype(np.float32)
    outs = []
    for d in (dev, torch.device("cpu")):
        x = torch.from_numpy(f).to(d).requires_grad_(True)
        out = masked_scatter_max(x, torch.from_numpy(ids).to(d), 512,
                                 backend)
        (out * torch.from_numpy(g).to(d)).sum().backward()
        outs.append((out.detach().cpu(), x.grad.cpu()))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("b,n,m,c", [(8, 16384, 512, 64), (2, 1000, 77, 13),
                                     (3, 333, 5, 40), (1, 17, 600, 3),
                                     (16, 10240, 512, 32),
                                     (16, 5000, 512, 64)])
def test_scatter_max_kernel_matches_plain(dev, b, n, m, c):
    """Equal to scatter_reduce('amax') with empty nodes 0, including nodes no
    point maps to and negative features."""
    rng = np.random.default_rng(n + m + c)
    f = _rand(rng, (b, n, c), dev, 3.0)
    ids = torch.from_numpy(rng.integers(0, max(1, m - 3), size=(b, n))).to(dev)
    got = kernels.scatter_max(f, ids, m)
    ref = kernels.scatter_max_plain(f, ids, m)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def _scatter_case(dev, f, ids, m):
    got = kernels.scatter_max(f, ids, m)
    torch.cuda.synchronize()
    ref = kernels.scatter_max_plain(f, ids, m)
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("m,node", [(1, 0), (512, 300)])
def test_scatter_max_kernel_one_node(dev, m, node):
    """Every point on one node (of 1, and of 512): each block of the cluster
    updates the same row, the others stay 0."""
    rng = np.random.default_rng(m)
    f = _rand(rng, (2, 16384, 64), dev, 3.0)
    ids = torch.full((2, 16384), node, dtype=torch.int64, device=dev)
    got = _scatter_case(dev, f, ids, m)
    assert torch.equal(got[:, node], f.amax(1))
    assert int((got != 0).any(-1).sum()) == 2


@pytest.mark.parametrize("kind", ["signed_zeros", "all_negative"])
def test_scatter_max_kernel_signs(dev, kind):
    """+0.0 and -0.0 only, or every feature below 0: the ordered-int
    encoding keeps the order of negative floats, and a node's max stays
    negative while an empty node is 0."""
    rng = np.random.default_rng(len(kind))
    if kind == "signed_zeros":
        f = rng.choice(np.array([0.0, -0.0], np.float32), (2, 16384, 64))
    else:
        f = -np.abs(rng.normal(size=(2, 16384, 64))).astype(np.float32) - 1
    ids = torch.from_numpy(rng.integers(0, 500, size=(2, 16384))).to(dev)
    got = _scatter_case(dev, torch.from_numpy(f).to(dev), ids, 512)
    if kind == "all_negative":
        assert bool((got[:, :500] < 0).all() and (got[:, 500:] == 0).all())


@pytest.mark.parametrize("n,m,c", [(16384, 512, 13), (16384, 512, 40),
                                   (16384 + 37, 512, 64), (40003, 512, 64),
                                   (9000, 512, 128), (3000, 2000, 24),
                                   (2100, 5000, 9)])
def test_scatter_max_kernel_forms(dev, n, m, c):
    """Ragged channel tiles (C = 13, 40, 9), N not a multiple of the
    cluster's chunk (N = 16421 over 4 blocks, 40003 over 8, 9000 over 2),
    the 16- and 8-channel tiles of many nodes (kernels.scatter_max_form)."""
    rng = np.random.default_rng(n + m + c)
    f = _rand(rng, (3, n, c), dev, 3.0)
    ids = torch.from_numpy(rng.integers(0, m, size=(3, n))).to(dev)
    _scatter_case(dev, f, ids, m)


def test_scatter_max_kernel_unaligned_features(dev):
    """C % 4 == 0 but the features 4 bytes past a 16-byte boundary: scalar
    loads instead of float4."""
    rng = np.random.default_rng(5)
    flat = _rand(rng, (2 * 4096 * 32 + 1,), dev)
    f = flat[1:].view(2, 4096, 32)
    assert f.is_contiguous() and f.data_ptr() % 16 != 0
    ids = torch.from_numpy(rng.integers(0, 512, size=(2, 4096))).to(dev)
    _scatter_case(dev, f, ids, 512)


def test_wrappers_reject_bad_cuda_inputs(dev):
    pts = torch.zeros((2, 64, 3), device=dev)
    first = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        kernels.fps(pts.double(), first, 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fps(pts.transpose(0, 1).contiguous().transpose(0, 1), first, 8)
    with pytest.raises(ValueError):
        kernels.fps(pts, first, 65)
    with pytest.raises(TypeError):
        kernels.min_argmin(pts, pts.half())
    with pytest.raises(ValueError, match="multiples of 32"):
        x = torch.zeros((1, 2, 4, 5), device=dev)
        dims = [(5, 16), (16, 16), (16, 16), (16, 32), (16, 32), (32, 32)]
        kernels.fusion_chain(x, kernels.prepare_chain(
            [torch.zeros(d, device=dev) for d in dims],
            [torch.zeros(d[1], device=dev) for d in dims[:3] + dims[4:]]))
    scores = torch.zeros((4, 256), device=dev)
    with pytest.raises(TypeError):
        kernels.smallest_k(scores.double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.smallest_k(scores.t(), 2)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.smallest_k(torch.zeros((1, kernels.SMALLEST_K_MAX_N + 1),
                                       device=dev), 8)
    f = torch.zeros((2, 64, 8), device=dev)
    ids = torch.zeros((2, 64), dtype=torch.int64, device=dev)
    with pytest.raises(TypeError):
        kernels.scatter_max(f.half(), ids, 4)
    with pytest.raises(TypeError):
        kernels.scatter_max(f, ids.int(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.scatter_max(f.transpose(0, 1).contiguous().transpose(0, 1),
                            ids, 4)
