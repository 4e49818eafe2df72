"""The port's default host data path (``get_batch``: the native C++ batch
loader of ``usip_tpu_torch.native``) against usip_tpu's default path, on the
CPU, with both libraries built.

On small trees of every native-eligible dataset (modelnet, oxford's train
and test layouts with their ENU -> camera flip in ``post_batch``, kitti,
scenenn, match3d, a concatenation of two scenenn splits), each dataset's
``get_batch`` and ``ParentCloudDataset.get_batch`` give usip_tpu's arrays
byte for byte at the float32 and float16 wires, with the port's library at
one thread against usip_tpu's at one a core; two epochs of ``BatchLoader``
give usip_tpu's pipeline batch for batch (shuffle order and seeds drawn
from the dataset's rng included), every batch through ``get_batch``. Where
an item is not a plain ``.npy`` (a kitti radius crop) or not siamese
(``ModelNetClsDataset``) both packages return None and fall back to their
per-item path, which stays equal. With the port's ``shard=(0, 1)`` the
batches are one rank's: usip_tpu's. Over two ranks, each with its own
dataset and loader, the ranks' slices put together are usip_tpu's global
batch: rank r's item b draws as usip_tpu's item ``r * B / R + b``.
"""

import functools
import pickle

import numpy as np
import pytest

import usip_tpu.native as jax_native
from usip_tpu import config as jax_config
from usip_tpu.data import loaders as jax_loaders
from usip_tpu.data import pipeline as jax_pipeline
from usip_tpu_torch import config as torch_config
from usip_tpu_torch import native
from usip_tpu_torch.data import loaders as torch_loaders
from usip_tpu_torch.data import pipeline as torch_pipeline

pytestmark = pytest.mark.skipif(
    not (native.available() and jax_native.available()),
    reason="both host libraries must build (g++) for the comparison")

N, P = 192, 256
ROWS = ([3, 0, 5, 1], [2, 2, 4, 0])


def _save(path, rng, n, cols):
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, rng.normal(0, 5, (n, cols)).astype(np.float32))


def _sizes(rng, count):
    # shorter than the parent, between, and longer
    return [int(s) for s in rng.choice([150, 230, 300, 420], count)]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_trees")
    rng = np.random.default_rng(0)
    # modelnet: 6-column shapes
    mn = root / "modelnet"
    mn.mkdir()
    (mn / "modelnet40_shape_names.txt").write_text("chair\ndesk\n")
    names = [f"{c}_{i:04d}" for i, c in enumerate(["chair", "desk"] * 3)]
    (mn / "modelnet40_train.txt").write_text("\n".join(names) + "\n")
    (mn / "modelnet40_test.txt").write_text(names[0] + "\n")
    for name, n in zip(names, _sizes(rng, len(names))):
        _save(mn / name[:-5] / f"{name}.npy", rng, n, 6)
    # oxford: train_relative.txt + train scans, test models + gt pickle
    ox = root / "oxford"
    lines = []
    for i, n in enumerate(_sizes(rng, 6)):
        _save(ox / "train_np_nofilter" / f"scan_{i}.npy", rng, n, 8)
        lines.append(f"scan_{i}.bin | {(i + 1) % 6} | {(i + 2) % 6}")
    (ox / "train_relative.txt").write_text("\n".join(lines) + "\n")
    test = ox / "test_models_20k_np_nofilter"
    for i, n in enumerate(_sizes(rng, 6)):
        _save(test / f"{i}.npy", rng, n, 8)
    with open(test / "groundtruths.pkl", "wb") as f:
        pickle.dump([{"anc_idx": i, "pos_idx": (i + 1) % 6} for i in
                     range(6)], f)
    # kitti: the 11 sequences' folders, 2 scans a train sequence
    kt = root / "kitti"
    for seq in range(11):
        for i, n in enumerate(_sizes(rng, 2 if seq < 9 else 3)):
            _save(kt / "data_odometry_velodyne" / "numpy" / f"{seq:02d}"
                  / torch_loaders.KITTI_NP_FOLDER / f"{i:06d}.npy", rng,
                  n, 8)
    # scenenn: train and val splits
    sc = root / "scenenn"
    for mode, count in (("train", 6), ("val", 3), ("test", 4)):
        for i, n in enumerate(_sizes(rng, count)):
            _save(sc / f"frames_{mode}" / f"{i}.npy", rng, n, 7)
        with open(sc / f"info_{mode}.pkl", "wb") as f:
            pickle.dump({"pairs_np": np.zeros((0, 2), np.int64),
                         "icp_np": np.zeros((0, 4, 4)),
                         "positive_list": [[] for _ in range(count)],
                         "sample_num": count}, f)
    # match3d: training_list.txt folders, one sub-folder of fragments each
    m3 = root / "match3d"
    folders = ["scene_a", "scene_b"]
    for folder in folders:
        for i, n in enumerate(_sizes(rng, 3)):
            _save(m3 / folder / "seq-01" / f"frag_{i}.npy", rng, n, 8)
    (m3 / "training_list.txt").write_text("\n".join(folders) + "\n")
    return root


# dataset name, tree folder, mode, sn_len
CASES = [("modelnet", "modelnet", "train", 3),
         ("oxford", "oxford", "train", 4),
         ("oxford", "oxford", "test", 4),
         ("kitti", "kitti", "train", 4),
         ("kitti", "kitti", "test", 1),
         ("scenenn", "scenenn", "train", 4),
         ("match3d", "match3d", "train", 4)]
IDS = [f"{c[0]}-{c[2]}-sn{c[3]}" for c in CASES]


def _configs(root, name, **extra):
    over = {"data.dataroot": str(root), "data.input_pc_num": N,
            "data.parent_pc_num": P, **extra}
    return (torch_config.get_config(name, **over).data,
            jax_config.get_config(name, **over).data)


def _datasets(trees, case, seed=5, **extra):
    name, folder, mode, sn_len = case
    ours_cfg, ref_cfg = _configs(trees / folder, name, **extra)
    return (torch_loaders.make_detector_dataset(name, ours_cfg, mode, sn_len,
                                                seed=seed),
            jax_loaders.make_detector_dataset(name, ref_cfg, mode, sn_len,
                                              seed=seed))


def _assert_batches_equal(a, b):
    assert a is not None and b is not None
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


@pytest.fixture
def port_one_thread(monkeypatch):
    """The port's batch loader on one C++ thread (usip_tpu's on one a
    core): the batches do not depend on the thread count."""
    monkeypatch.setattr(native, "batch_load_subsample", functools.partial(
        native.batch_load_subsample, threads=1))


@pytest.mark.parametrize("wire", ["float32", "float16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_get_batch_equals_usip_tpu(trees, case, wire, port_one_thread):
    ours, ref = _datasets(trees, case, **{"data.wire_dtype": wire})
    dtype = np.float16 if wire == "float16" else np.float32
    for row in ROWS:
        row = [i % len(ours) for i in row]
        a, b = ours.get_batch(row), ref.get_batch(row)
        _assert_batches_equal(a, b)
        assert a["src_pc"].dtype == dtype
        assert a["src_pc"].shape == (len(row), N, 3)
        pa = torch_loaders.ParentCloudDataset(ours).get_batch(row)
        pb = jax_loaders.ParentCloudDataset(ref).get_batch(row)
        _assert_batches_equal(pa, pb)
        assert pa["pc"].shape == (len(row), P, 3) and pa["pc"].dtype == dtype
    # the dataset rngs moved alike: the next per-item draw agrees too
    _assert_batches_equal(ours[1], ref[1])


def test_concat_and_flip(trees):
    """ConcatSiameseDataset over scenenn's train and val (usip_tpu's
    scenenn training set) delegates paths to its children; oxford's parent
    batches come out flipped to camera axes, normals too."""
    a = [torch_loaders.make_detector_dataset(
        "scenenn", _configs(trees / "scenenn", "scenenn")[0], m, 4, seed=2)
        for m in ("train", "val")]
    b = [jax_loaders.make_detector_dataset(
        "scenenn", _configs(trees / "scenenn", "scenenn")[1], m, 4, seed=2)
        for m in ("train", "val")]
    ca, cb = (torch_loaders.ConcatSiameseDataset(a),
              jax_loaders.ConcatSiameseDataset(b))
    row = [8, 0, 6, 7, 2]
    _assert_batches_equal(ca.get_batch(row), cb.get_batch(row))
    _assert_batches_equal(torch_loaders.ParentCloudDataset(ca).get_batch(row),
                          jax_loaders.ParentCloudDataset(cb).get_batch(row))
    ours, _ = _datasets(trees, CASES[1])
    parent = torch_loaders.ParentCloudDataset(ours)
    seed = int(np.random.default_rng(5).integers(0, 2 ** 62))
    raw = native.batch_load_subsample([ours.item_path(i) for i in (0, 1)],
                                      P, 4, seed=seed)
    got = parent.get_batch([0, 1])
    np.testing.assert_array_equal(got["pc"][..., 0], raw[0][..., 0])
    np.testing.assert_array_equal(got["pc"][..., 1], -raw[0][..., 2])
    np.testing.assert_array_equal(got["pc"][..., 2], raw[0][..., 1])
    np.testing.assert_array_equal(got["sn"][..., 1], -raw[1][..., 2])
    np.testing.assert_array_equal(got["sn"][..., 3], raw[1][..., 3])


@pytest.mark.parametrize("parent", [False, True])
@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3], CASES[5]],
                         ids=[IDS[0], IDS[1], IDS[3], IDS[5]])
def test_batch_loader_two_epochs_equal_usip_tpu(trees, case, parent):
    """usip_tpu's default pipeline against the port's, batch for batch over
    two epochs (the shuffle rng carries over), every batch through
    ``get_batch``; the port's ``shard=(0, 1)`` is the same loader."""
    ours, ref = _datasets(trees, case, **{"data.wire_dtype": "float16"})
    if parent:
        ours = torch_loaders.ParentCloudDataset(ours)
        ref = jax_loaders.ParentCloudDataset(ref)
    la = torch_pipeline.BatchLoader(ours, 2, shuffle=True, num_workers=4,
                                    seed=7, shard=(0, 1))
    lb = jax_pipeline.BatchLoader(ref, 2, shuffle=True, num_workers=4, seed=7)
    for _ in range(2):
        batches_a, batches_b = list(la), list(lb)
        assert len(batches_a) == len(batches_b) == len(la) > 1
        for a, b in zip(batches_a, batches_b):
            _assert_batches_equal(a, b)
    assert la.served == {"get_batch": 2 * len(la), "items": 0}


@pytest.mark.parametrize("parent", [False, True])
@pytest.mark.parametrize("case", [CASES[0], CASES[5]], ids=[IDS[0], IDS[5]])
def test_sharded_ranks_make_usip_tpu_global_batch(trees, case, parent):
    """Two ranks, each with its own dataset (the same seed) and its own
    ``shard=(r, 2)`` loader of the global batch of 4: their slices, rank 0's
    rows first, equal usip_tpu's one-host batches over two epochs."""
    def dataset(side):
        ds = _datasets(trees, case, **{"data.wire_dtype": "float16"})[side]
        if parent:
            return (torch_loaders if side == 0 else
                    jax_loaders).ParentCloudDataset(ds)
        return ds
    ranks = [torch_pipeline.BatchLoader(dataset(0), 4, shuffle=True,
                                        num_workers=4, seed=7, shard=(r, 2))
             for r in range(2)]
    lb = jax_pipeline.BatchLoader(dataset(1), 4, shuffle=True,
                                  num_workers=4, seed=7)
    for _ in range(2):
        slices = [list(loader) for loader in ranks]
        batches_b = list(lb)
        assert len(slices[0]) == len(slices[1]) == len(batches_b) > 0
        for a0, a1, b in zip(*slices, batches_b):
            assert a0[next(iter(a0))].shape[0] == 2
            _assert_batches_equal(
                {k: np.concatenate([a0[k], a1[k]]) for k in a0}, b)
    for loader in ranks:
        assert loader.served == {"get_batch": 2 * len(loader), "items": 0}


def test_ineligible_items_fall_back_alike(trees):
    """A kitti radius crop and ModelNetClsDataset's single-view items have
    no batch path in either package; their per-item batches agree (one
    fetch thread on usip_tpu's side: its items share one rng)."""
    crop = {"data.crop_radius": 4.0}
    ours, ref = _datasets(trees, CASES[3], **crop)
    assert ours.get_batch([0, 1]) is None and ref.get_batch([0, 1]) is None
    la = torch_pipeline.BatchLoader(torch_loaders.ParentCloudDataset(ours),
                                    2, num_workers=4, seed=3)
    lb = jax_pipeline.BatchLoader(jax_loaders.ParentCloudDataset(ref), 2,
                                  num_workers=1, seed=3)
    for a, b in zip(list(la), list(lb), strict=True):
        _assert_batches_equal(a, b)
    assert la.served == {"get_batch": 0, "items": len(la)}
    ours_cfg, ref_cfg = _configs(trees / "modelnet", "modelnet")
    ca = torch_loaders.ModelNetClsDataset(ours_cfg, "train", seed=4)
    cb = jax_loaders.ModelNetClsDataset(ref_cfg, "train", seed=4)
    assert ca.get_batch([0, 1]) is None and cb.get_batch([0, 1]) is None
    for i in range(len(ca)):
        _assert_batches_equal(ca[i], cb[i])


def test_both_off_keeps_the_numpy_path(trees, monkeypatch):
    """With both libraries forced off, ``get_batch`` returns None in both
    packages and the per-item batches agree."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    ours, ref = _datasets(trees, CASES[5])
    assert ours.get_batch([0, 1]) is None and ref.get_batch([0, 1]) is None
    la = torch_pipeline.BatchLoader(ours, 2, num_workers=4, seed=1)
    lb = jax_pipeline.BatchLoader(ref, 2, num_workers=1, seed=1)
    for a, b in zip(list(la), list(lb), strict=True):
        _assert_batches_equal(a, b)
    assert la.served["get_batch"] == 0
