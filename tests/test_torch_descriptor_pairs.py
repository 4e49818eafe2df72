"""The KITTI descriptor's pair loader (``KittiDescriptorDataset``) on a small
synthetic KITTI tree, with the port's host library built by g++.

The pose table read at construction is ``load_pose``'s, index by index
(``tests/test_torch_host.py`` holds the numpy path's items, which read it,
to usip_tpu's). The native pair path (``get_batch``) gives the numpy path's keys,
shapes and metadata, its anchors and positives are the library's batch
loads at the batch's seeds, every positive lies within ``positive_radius``
or is the anchor, one seed repeats its batches, and it steps aside (None)
without the library or with a radius crop. The miner's draws leave the
batches' alone. A ``BatchLoader`` takes the native path for every batch, a
``DescriptorEngine`` epoch trains through it on the CPU, and the engine's
wire encode (``pack_pair_batch``) is usip_tpu's.
"""

import numpy as np
import pytest
import torch

from usip_tpu_torch import native
from usip_tpu_torch.config import get_config
from usip_tpu_torch.data.descriptor_loaders import KittiDescriptorDataset
from usip_tpu_torch.data.pipeline import BatchLoader, collate
from usip_tpu_torch.data.synthetic import build_synthetic_kitti_tree
from usip_tpu_torch.train.checkpoint import save_checkpoint
from usip_tpu_torch.train.descriptor_loop import DescriptorEngine
from usip_tpu_torch.train.loop import init_detector_state

N = 128
SEED = 11
KEYS = ("anc_pc", "anc_sn", "pos_pc", "pos_sn", "seq", "pose", "index")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """6 scans of 300 points a train sequence, 5 a test sequence, 1.5 m
    apart."""
    root = tmp_path_factory.mktemp("kitti_pairs")
    build_synthetic_kitti_tree(str(root), frames_per_seq=6,
                               test_frames_per_seq=5, target_points=300,
                               seed=4)
    return str(root)


@pytest.fixture
def library():
    if not native.available():
        pytest.skip("the host library must build (g++) for the native path")


def _config(tree, **extra):
    return get_config("kitti", role="descriptor",
                      **{"data.dataroot": tree, "data.input_pc_num": N,
                         **extra})


def _dataset(tree, mode="train", seed=SEED, **extra):
    return KittiDescriptorDataset(_config(tree, **extra).data, mode,
                                  seed=seed)


def _draws(twin, rows, offset=0):
    """What ``get_batch`` draws for ``rows``, repeated on a twin dataset
    (same seed, same state): the positives, then the anchors' and the
    positives' batch seeds."""
    positives = [twin._find_positive(twin._rng, int(i)) for i in rows]
    return positives, twin._item_seed(offset), twin._item_seed(offset)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_pose_table_is_load_pose(tree, mode):
    ds = _dataset(tree, mode)
    assert ds.poses.shape == (len(ds), 4, 4) and ds.seqs.dtype == np.int64
    for i in range(len(ds)):
        seq, pose = ds.base.load_pose(i)
        assert ds.seqs[i] == seq
        assert ds.poses[i].dtype == pose.dtype
        assert np.array_equal(ds.poses[i], pose)


@pytest.mark.parametrize("wire", ["float32", "float16"])
def test_native_batch_has_the_numpy_layout(tree, library, wire):
    """Keys in order, shapes and dtypes of the collated items; the clouds
    in the wire's dtype (the numpy path's float32 on the float32 wire)."""
    rows = [3, 17, 40, 8]
    ds = _dataset(tree, **{"data.wire_dtype": wire})
    batch = ds.get_batch(rows)
    items = collate([_dataset(tree)[i] for i in rows])
    assert tuple(batch) == tuple(items) == KEYS
    for k in KEYS:
        assert batch[k].shape == items[k].shape, k
        cloud = k.endswith(("_pc", "_sn"))
        want = np.dtype(wire) if cloud else items[k].dtype
        assert batch[k].dtype == want, k
        if not cloud:
            assert np.array_equal(batch[k], items[k]), k
    assert ds.counts == {"native_batches": 1, "numpy_items": 0,
                         "positive_fallbacks": 0}


@pytest.mark.parametrize("offset", [0, 4])
def test_native_batch_is_the_library_loads(tree, library, offset):
    """Anchors and positives are ``batch_load_subsample`` over their paths
    at the seeds the dataset drew after the positives; every positive lies
    within ``positive_radius`` of its anchor, in its sequence, or is the
    anchor."""
    ds, twin = _dataset(tree), _dataset(tree)
    radius = ds.cfg.positive_radius
    for rows in ([0, 5, 6, 53], [12, 13, 30, 31], [47, 2, 29, 18]):
        batch = ds.get_batch(rows, offset)
        positives, seed_anc, seed_pos = _draws(twin, rows, offset)
        for seed, idx, prefix in ((seed_anc, rows, "anc"),
                                  (seed_pos, positives, "pos")):
            pc, sn = native.batch_load_subsample(
                [ds.base.item_path(i) for i in idx], N, ds.sn_len,
                seed=seed, dtype=np.float16)
            assert np.array_equal(batch[prefix + "_pc"], pc)
            assert np.array_equal(batch[prefix + "_sn"], sn)
        for a, p in zip(rows, positives):
            gap = np.linalg.norm(ds.poses[p][:3, 3] - ds.poses[a][:3, 3])
            assert p == a or (gap < radius and ds.seqs[p] == ds.seqs[a])
        assert any(p != a for a, p in zip(rows, positives))
    assert ds.counts["positive_fallbacks"] == twin.counts[
        "positive_fallbacks"]


def test_native_batches_repeat_for_a_seed(tree, library):
    rows = ([1, 2, 3, 4], [20, 21, 50, 9])
    first, again, other = (_dataset(tree, seed=s) for s in (SEED, SEED, 12))
    for r in rows:
        a, b, c = first.get_batch(r), again.get_batch(r), other.get_batch(r)
        for k in KEYS:
            assert np.array_equal(a[k], b[k]), k
        assert not np.array_equal(a["anc_pc"], c["anc_pc"])


def test_miner_draws_apart_from_the_batches(tree, library):
    """Mining between batches, as the engine's main thread does while the
    producer thread assembles the next, leaves the batches those of a twin
    that mines nothing; the negatives repeat for a seed."""
    rows = ([1, 2, 3, 4], [20, 21, 50, 9], [33, 40, 5, 11])
    ds, quiet, again = _dataset(tree), _dataset(tree), _dataset(tree)
    negatives = []
    for r in rows:
        a, b = ds.get_batch(r), quiet.get_batch(r)
        for k in KEYS:
            assert np.array_equal(a[k], b[k]), k
        negatives.append(ds.mine_negative_indices(a["seq"], a["pose"]))
    for r, neg in zip(rows, negatives):
        c = again.get_batch(r)
        assert np.array_equal(
            again.mine_negative_indices(c["seq"], c["pose"]), neg)


@pytest.mark.parametrize("wire", ["float32", "float16"])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_pack_pair_batch_is_usip_tpus(dtype, wire):
    """The engine's one-pass encode of the pair wire gives usip_tpu's
    ``pack_pair_batch`` bytes, from the numpy path's fp32 clouds and from
    the native path's fp16 ones."""
    from usip_tpu.train import steps as ref_steps
    from usip_tpu_torch.train import steps
    rng = np.random.default_rng(6)
    clouds = [(rng.standard_normal((3, 64, c)) * 40).astype(dtype)
              for c in (3, 4, 3, 4)]
    neg = np.array([2, 0, 1], np.int64)
    ours = steps.pack_pair_batch(*clouds, neg, wire=wire)
    ref = ref_steps.pack_pair_batch(*clouds, neg, wire=wire)
    assert ours.x.dtype == ref.x.dtype and ours.x.shape == ref.x.shape
    assert ours.x.tobytes() == ref.x.tobytes()
    assert ours.neg_idx.dtype == ref.neg_idx.dtype
    assert np.array_equal(ours.neg_idx, ref.neg_idx)


def test_native_path_steps_aside(tree, library, monkeypatch):
    """None under a radius crop (the library crops nothing) and without
    the library; the loader then serves the items, as usip_tpu's."""
    cropped = _dataset(tree, **{"data.crop_radius": 30.0})
    assert cropped.get_batch([0, 1]) is None
    ds = _dataset(tree)
    monkeypatch.setattr(native, "available", lambda: False)
    assert ds.get_batch([0, 1]) is None
    for source in (cropped, ds):
        loader = BatchLoader(source, 4, shuffle=True, seed=3)
        batches = list(loader)
        assert len(batches) == len(loader) == 13
        assert loader.served == {"get_batch": 0, "items": 13}
        assert source.counts["native_batches"] == 0
        assert source.counts["numpy_items"] == 52


def test_batch_loader_takes_the_native_path(tree, library):
    ds = _dataset(tree)
    loader = BatchLoader(ds, 4, shuffle=True, seed=3)
    for _ in range(2):
        batches = list(loader)
        assert len(batches) == 13
        assert all(b["anc_pc"].dtype == np.float16 for b in batches)
    assert loader.served == {"get_batch": 26, "items": 0}
    assert ds.counts["native_batches"] == 26
    assert ds.counts["numpy_items"] == 0
    # 6 scans 1.5 m apart: every search ends within the radius
    assert ds.counts["positive_fallbacks"] == 0


def test_a_search_that_finds_nothing_pairs_the_anchor(tree, library):
    """With a radius of 0 the search draws nothing and falls back: each
    positive is its anchor's scan at the positives' seed, counted."""
    ds = _dataset(tree, **{"data.positive_radius": 0.0})
    twin = _dataset(tree, **{"data.positive_radius": 0.0})
    rows = [7, 8, 30]
    batch = ds.get_batch(rows)
    positives, _, seed_pos = _draws(twin, rows)
    assert positives == rows
    pc, _ = native.batch_load_subsample([ds.base.item_path(i) for i in rows],
                                        N, ds.sn_len, seed=seed_pos,
                                        dtype=np.float16)
    assert np.array_equal(batch["pos_pc"], pc)
    assert ds.counts["positive_fallbacks"] == 3


def test_descriptor_engine_trains_through_the_native_path(tree, library,
                                                         tmp_path):
    """One epoch of the scan objective at a tiny width on the CPU, fed by
    the pair batches of ``get_batch`` and the pose-distance miner."""
    cfg = _config(tree, **{
        "data.node_num": 16, "detector.c1": 16, "detector.c2": 32,
        "detector.node_knn_k": 4, "descriptor.descriptor_len": 16,
        "descriptor.ball_nsamples": 8, "descriptor.ball_radius": 0.75,
        "train.batch_size": 4, "train.log_every": 1000})
    ckpt = str(tmp_path / "det.pt")
    save_checkpoint(ckpt, init_detector_state(cfg, 0))
    ds = KittiDescriptorDataset(cfg.data, "train", seed=SEED)
    loader = BatchLoader(ds, cfg.train.batch_size, shuffle=True, seed=3)

    def mine(meta):
        return ds.mine_negative_indices(np.asarray(meta["seq"]),
                                        np.asarray(meta["pose"]))

    eng = DescriptorEngine(cfg, ckpt, train_loader=loader,
                           mine_negatives=mine, device="cpu",
                           out_dir=str(tmp_path / "desc"))
    before = {k: v.clone() for k, v in eng.state.model.state_dict().items()}
    avg = eng.train_epoch(0)
    assert eng.state.step == len(loader) == 13
    assert np.isfinite(avg["loss"])
    # the prefetch runs on into the next epoch: at least this one's 13
    eng.close()
    assert loader.served["items"] == 0 and loader.served["get_batch"] >= 13
    assert ds.counts["native_batches"] == loader.served["get_batch"]
    moved = [k for k, v in eng.state.model.state_dict().items()
             if v.is_floating_point() and not torch.equal(v, before[k])]
    assert moved


def test_engine_epochs_take_the_loaders_passes_in_order(tree, library,
                                                       tmp_path):
    """The engine's one prefetch over its epochs gives each epoch's steps
    the batches of one pass of the loader, in order, and the miner's
    negatives for them, as a twin loader and dataset iterated pass by pass
    give them; a pass left before its end (the step raised) restarts the
    prefetch, and ``close`` stops it."""
    cfg = _config(tree, **{
        "data.node_num": 16, "detector.c1": 16, "detector.c2": 32,
        "detector.node_knn_k": 4, "descriptor.descriptor_len": 16,
        "descriptor.ball_nsamples": 8, "descriptor.ball_radius": 0.75,
        "train.batch_size": 4, "train.log_every": 1000})
    ckpt = str(tmp_path / "det.pt")
    save_checkpoint(ckpt, init_detector_state(cfg, 0))
    ds, twin = (KittiDescriptorDataset(cfg.data, "train", seed=SEED)
                for _ in range(2))
    loader = BatchLoader(ds, cfg.train.batch_size, shuffle=True, seed=3)
    twin_loader = BatchLoader(twin, cfg.train.batch_size, shuffle=True,
                              seed=3)
    eng = DescriptorEngine(
        cfg, ckpt, train_loader=loader, device="cpu",
        mine_negatives=lambda meta: ds.mine_negative_indices(
            np.asarray(meta["seq"]), np.asarray(meta["pose"])),
        out_dir=str(tmp_path / "desc"))
    seen = []

    class Stop(Exception):
        pass

    def record(state, detector, batch, epoch, **kw):
        seen.append((epoch, batch.x.clone(), batch.neg_idx.clone()))
        if epoch == 2 and len(seen) == 2 * 13 + 2:
            raise Stop
        return {"loss": torch.zeros(())}

    eng.step_fn = record
    for epoch in range(2):
        eng.train_epoch(epoch)
    with pytest.raises(Stop):
        eng.train_epoch(2)
    assert eng._train_stream is not None and eng._mid_pass
    eng.close()
    assert eng._train_stream is None
    assert [e for e, _, _ in seen] == [0] * 13 + [1] * 13 + [2] * 2
    want = []
    for _ in range(2):
        for raw in twin_loader:
            x, _ = eng._device_batch(raw)
            neg = twin.mine_negative_indices(np.asarray(raw["seq"]),
                                             np.asarray(raw["pose"]))
            want.append((x, torch.as_tensor(neg, dtype=torch.long)))
    for (_, x, neg), (wx, wneg) in zip(seen, want):
        assert torch.equal(x, wx) and torch.equal(neg, wneg)
