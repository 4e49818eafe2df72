"""Detector dataset loaders for the six domains (counterpart of
``usip_tpu/data/loaders.py``; the port keeps its own copy).

Host-side work only: locate files, load ``.npy`` clouds, fixed-shape random
subsampling, channel split, coordinate flips, radius crop. Node FPS and all
augmentation (the GT transform included) run on the device in the train step.

Each dataset yields a dict {src_pc (N,3), src_sn (N,S), dst_pc, dst_sn}: the
two un-augmented siamese samplings of the same cloud (or the same frame), the
reference loaders' recipe before their ``.augment()``.

Directory contracts match the reference datasets exactly:
  * modelnet: modelnet40-normal_numpy tree (modelnet_shrec_loader.py:27-63),
  * shrec: npz tree with pc/sn (modelnet_shrec_loader.py:66-112),
  * oxford: train_relative.txt + train_np_nofilter/*.npy Nx8, ENU coords
    (oxford_detector_loader.py:43-76,184-203),
  * kitti: data_odometry_velodyne/numpy/<seq>/np_0.20_20480_r90_sn/*.npy Nx8 in
    camera coords + poses/<seq>/*.npz (kitti_detector_loader.py:23-147),
  * scenenn: frames_<mode>/*.npy + info_<mode>.pkl (scenenn_detector_loader.py:48-67),
  * match3d: training_list.txt folder tree walk (match3d_detector_loader.py:50-75).

Both of usip_tpu's paths are ported. By default (``get_batch``) a whole
batch is assembled in the C++ thread pool of the port's host library
(``native.py``, ``csrc/host/usip_native.cpp``): the dataset's
``numpy.random.Generator`` draws one seed for the src copies and one for the
dst copies (one for a parent batch), and the library draws each item from
``seed + b * 7919``, as usip_tpu's does (``b`` the item's place in the
global batch: a rank that loads its slice passes the slice's ``offset``). Where the library is not built, or
an item is not a plain ``.npy`` (shrec's npz, a kitti radius crop, a
single-view item), ``get_batch`` returns None and the loader fetches items
through ``__getitem__``, every draw from the dataset's Generator in
usip_tpu's numpy-path order. On either path one seed gives the batches
usip_tpu gives on that path.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from usip_tpu_torch.config import DataConfig
from usip_tpu_torch.data.augment import coordinate_enu_to_cam
from usip_tpu_torch.data.common import radius_crop, split_pc_sn, subsample_fixed


class SiameseDetectorDataset:
    """Base: two independent samplings of the item -> siamese batch dict."""

    def __init__(self, cfg: DataConfig, sn_len: int, seed: int = 0):
        self.cfg = cfg
        self.sn_len = sn_len
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        raise NotImplementedError

    def sample_instance(self, rng: np.random.Generator, index: int,
                        n: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """One fixed-size sampling of item ``index``; ``n`` defaults to
        cfg.input_pc_num (parent-cloud callers pass cfg.parent_pc_num)."""
        raise NotImplementedError

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = self._rng
        src_pc, src_sn = self.sample_instance(rng, index)
        dst_pc, dst_sn = self.sample_instance(rng, index)
        return {"src_pc": src_pc, "src_sn": src_sn,
                "dst_pc": dst_pc, "dst_sn": dst_sn}

    # -------------------- native batch fast path (usip_native.cpp) ----------
    # Datasets whose item is a plain Nx(3+sn) .npy needing only
    # subsample+split return the file path here; the thread-pooled C++ loader
    # then assembles the whole batch in one GIL-free call (the reference's
    # DataLoader(num_workers) analog, kitti/options_detector.py:25).

    def item_path(self, index: int) -> Optional[str]:
        return None

    def post_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Hook for cheap whole-batch post-processing (e.g. coordinate flips)."""
        return batch

    def get_batch(self, indices: Sequence[int], offset: int = 0
                  ) -> Optional[Dict[str, np.ndarray]]:
        """Assemble a siamese batch via the native loader, or None to signal
        the caller to fall back to per-item ``__getitem__``. ``indices`` sit
        at ``offset`` in the global batch: item b draws as the global batch's
        item ``offset + b`` (a rank's slice of usip_tpu's one-host batch)."""
        from usip_tpu_torch import native
        if not native.available():
            return None
        paths = [self.item_path(int(i)) for i in indices]
        if any(p is None for p in paths):
            return None
        n = self.cfg.input_pc_num
        dt = self._wire_numpy_dtype()
        seed_src = self._item_seed(offset)
        seed_dst = self._item_seed(offset)
        src_pc, src_sn = native.batch_load_subsample(paths, n, self.sn_len,
                                                     seed=seed_src, dtype=dt)
        dst_pc, dst_sn = native.batch_load_subsample(paths, n, self.sn_len,
                                                     seed=seed_dst, dtype=dt)
        return self.post_batch({"src_pc": src_pc, "src_sn": src_sn,
                                "dst_pc": dst_pc, "dst_sn": dst_sn})

    def _item_seed(self, offset: int) -> int:
        """One batch seed from the dataset's rng, moved to the item at
        ``offset`` (the library draws item b from ``seed + b * 7919``)."""
        return int(self._rng.integers(0, 2 ** 62)) + offset * 7919

    def _wire_numpy_dtype(self):
        """The float16 wire is encoded in the native loader's thread pool
        (F16C), which the engine's copy to the card then takes as it is;
        other wires load fp32."""
        return np.float16 if self.cfg.wire_dtype == "float16" else np.float32


class ModelNetDataset(SiameseDetectorDataset):
    """ModelNet40 10k (x,y,z,nx,ny,nz npy per shape)."""

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 3,
                 classes: int = 40, seed: int = 0):
        super().__init__(cfg, sn_len, seed)
        root = cfg.dataroot
        with open(os.path.join(root, f"modelnet{classes}_shape_names.txt")) as f:
            shapes = [s.rstrip() for s in f.readlines()]
        list_file = {"train": f"modelnet{classes}_train.txt",
                     "test": f"modelnet{classes}_test.txt"}[mode]
        with open(os.path.join(root, list_file)) as f:
            names = [s.rstrip() for s in f.readlines()]
        self.items: List[Tuple[str, int]] = []
        for name in names:
            folder = name[0:-5]
            self.items.append((os.path.join(root, folder, name + ".npy"),
                               shapes.index(folder)))

    def __len__(self):
        return len(self.items)

    def sample_instance(self, rng, index, n=None):
        path, _ = self.items[index]
        data = np.load(path)
        data = subsample_fixed(rng, data, n or self.cfg.input_pc_num)
        return split_pc_sn(data, self.sn_len)

    def item_path(self, index):
        return self.items[index][0]


class ModelNetClsDataset(ModelNetDataset):
    """Classification-style single-view items ``{pc, sn, label}``: the
    SO-Net-legacy loader (reference data/modelnet_cls_loader.py:84-208,
    unreferenced by any USIP entry script), kept so the reference tree's
    data surface carries over. Nodes are sampled on the device like every
    other loader here."""

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pc, sn = self.sample_instance(self._rng, index)
        return {"pc": pc, "sn": sn,
                "label": np.asarray(self.items[index][1], np.int32)}

    def get_batch(self, indices, offset=0):
        # the native fast path assembles *siamese* batches; single-view items
        # take the per-item route
        return None


class ShrecDataset(SiameseDetectorDataset):
    """SHREC2016 (npz with 'pc'/'sn', modelnet_shrec_loader.py:162-174)."""

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 3,
                 seed: int = 0):
        super().__init__(cfg, sn_len, seed)
        root = cfg.dataroot
        rows = round(np.sqrt(cfg.node_num))
        with open(os.path.join(root, "category.txt")) as f:
            categories = [s.rstrip() for s in f.readlines()]
        with open(os.path.join(root, f"{mode}.txt")) as f:
            lines = [s.rstrip() for s in f.readlines()]
        self.items = []
        for line in lines:
            if mode in ("train", "val"):
                name, cat = [x.strip() for x in line.split(",")]
                if cat not in categories:
                    continue
            else:
                name = line
            self.items.append(os.path.join(root, f"{rows}x{rows}", mode,
                                           "model_" + name + ".npz"))

    def __len__(self):
        return len(self.items)

    def sample_instance(self, rng, index, n=None):
        data = np.load(self.items[index])
        pc, sn = data["pc"], data["sn"]
        merged = np.concatenate([pc, sn], axis=1)
        merged = subsample_fixed(rng, merged, n or self.cfg.input_pc_num)
        return split_pc_sn(merged, self.sn_len)


def parse_relative_txt(path: str) -> List[Dict]:
    """Oxford train_relative.txt: ``file | pos_list | nonneg_list`` per line."""
    items = []
    with open(path) as f:
        for line in f:
            parts = line.split("|")
            if len(parts) != 3:
                continue
            items.append({
                "file": parts[0].strip(),
                "pos_list": list(map(int, parts[1].split())),
                "nonneg_list": list(map(int, parts[2].split())),
            })
    return items


class OxfordDataset(SiameseDetectorDataset):
    """Oxford RobotCar detector set; clouds stored ENU on disk, returned in camera
    coords (flip applied here, matching oxford_detector_loader.py:202-203)."""

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 4, seed: int = 0):
        super().__init__(cfg, sn_len, seed)
        self.mode = mode
        root = cfg.dataroot
        if mode == "train":
            self.items = parse_relative_txt(os.path.join(root, "train_relative.txt"))
            self.folder = os.path.join(root, "train_np_nofilter")
        else:
            with open(os.path.join(root, "test_models_20k_np_nofilter",
                                   "groundtruths.pkl"), "rb") as f:
                self.items = pickle.load(f)
            self.folder = os.path.join(root, "test_models_20k_np_nofilter")

    def __len__(self):
        return len(self.items)

    def _load(self, index):
        if self.mode == "train":
            fn = self.items[index]["file"]
            return np.load(os.path.join(self.folder, fn[0:-3] + "npy"))
        anc_idx = self.items[index]["anc_idx"]
        return np.load(os.path.join(self.folder, f"{anc_idx}.npy"))

    def sample_instance(self, rng, index, n=None):
        data = subsample_fixed(rng, self._load(index), n or self.cfg.input_pc_num)
        pc, sn = split_pc_sn(data, self.sn_len)
        pc = coordinate_enu_to_cam(pc)
        if self.sn_len >= 3:
            sn = np.concatenate([coordinate_enu_to_cam(sn[:, :3]), sn[:, 3:]], 1)
        return pc, sn

    def item_path(self, index):
        if self.mode == "train":
            fn = self.items[index]["file"]
            return os.path.join(self.folder, fn[0:-3] + "npy")
        return os.path.join(self.folder, f"{self.items[index]['anc_idx']}.npy")

    def post_batch(self, batch):
        # ENU->cam on the stacked (B, N, 3) arrays (elementwise column swap);
        # applies to siamese (src_/dst_) and parent-cloud (pc/sn) batches
        # alike. In place, on the arrays the native loader just made: the
        # copy and the concatenation of normals cost the loader's thread
        # more than the load itself at 8 x 20480 points
        def flip(a):
            y = a[..., 1].copy()
            np.negative(a[..., 2], out=a[..., 1])
            a[..., 2] = y

        for k in batch:
            if k.endswith("pc") or (k.endswith("sn") and self.sn_len >= 3):
                flip(batch[k])
        return batch


KITTI_NP_FOLDER = "np_0.20_20480_r90_sn"


class KittiDataset(SiameseDetectorDataset):
    """KITTI odometry detector set; seqs 0-8 train / 9-10 test. Camera coords on
    disk (kitti_detector_loader.py:24-33,101-147)."""

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 4, seed: int = 0):
        super().__init__(cfg, sn_len, seed)
        self.root = cfg.dataroot
        self.seqs = list(range(9)) if mode == "train" else [9, 10]
        self.folders = [os.path.join(self.root, "data_odometry_velodyne",
                                     "numpy", f"{s:02d}", KITTI_NP_FOLDER)
                        for s in self.seqs]
        self.counts = [len(os.listdir(f)) for f in self.folders]
        self.cum = np.cumsum(self.counts).tolist()

    def __len__(self):
        return self.cum[-1]

    def locate(self, index: int) -> Tuple[int, int, int]:
        """-> (seq_pos, seq_id, index_in_seq)."""
        for i, c in enumerate(self.cum):
            if index < c:
                start = 0 if i == 0 else self.cum[i - 1]
                return i, self.seqs[i], index - start
        raise IndexError(index)

    def load_pose(self, index: int) -> Tuple[int, np.ndarray]:
        i, seq, in_seq = self.locate(index)
        pose = np.load(os.path.join(self.root, "poses", f"{seq:02d}",
                                    f"{in_seq:06d}.npz"))["pose"]
        return seq, pose

    def sample_instance(self, rng, index, n=None):
        i, seq, in_seq = self.locate(index)
        data = np.load(os.path.join(self.folders[i], f"{in_seq:06d}.npy"))
        if self.cfg.crop_radius is not None and self.cfg.crop_radius < 90:
            data = radius_crop(data, self.cfg.crop_radius)
        data = subsample_fixed(rng, data, n or self.cfg.input_pc_num)
        return split_pc_sn(data, self.sn_len)

    def item_path(self, index):
        if self.cfg.crop_radius is not None and self.cfg.crop_radius < 90:
            return None  # native path has no radius crop; use __getitem__
        i, _, in_seq = self.locate(index)
        return os.path.join(self.folders[i], f"{in_seq:06d}.npy")


class SceneNNDataset(SiameseDetectorDataset):
    """SceneNN indoor frames (scenenn_detector_loader.py:48-90)."""

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 4, seed: int = 0):
        super().__init__(cfg, sn_len, seed)
        root = cfg.dataroot
        self.frame_folder = os.path.join(root, "frames_" + mode)
        with open(os.path.join(root, f"info_{mode}.pkl"), "rb") as f:
            info = pickle.load(f)
        self.pairs_np = info["pairs_np"]
        self.icp_np = info["icp_np"]
        self.positive_list = info["positive_list"]
        self.sample_num = info["sample_num"]

    def __len__(self):
        return self.sample_num

    def sample_instance(self, rng, index, n=None):
        data = np.load(os.path.join(self.frame_folder, f"{index}.npy"))
        data = subsample_fixed(rng, data, n or self.cfg.input_pc_num)
        return split_pc_sn(data, self.sn_len)

    def item_path(self, index):
        return os.path.join(self.frame_folder, f"{index}.npy")


class Match3DDataset(SiameseDetectorDataset):
    """3DMatch training fragments: recursive folder walk
    (match3d_detector_loader.py:50-75)."""

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 4, seed: int = 0):
        super().__init__(cfg, sn_len, seed)
        root = cfg.dataroot
        list_file = {"train": "training_list.txt", "test": "testing_list.txt"}[mode]
        with open(os.path.join(root, list_file)) as f:
            folders = [s.rstrip() for s in f.readlines() if s.strip()]
        self.files: List[str] = []
        for folder in folders:
            base = os.path.join(root, folder)
            for sub in sorted(os.listdir(base)):
                subdir = os.path.join(base, sub)
                if not os.path.isdir(subdir):
                    continue
                for fn in sorted(os.listdir(subdir)):
                    self.files.append(os.path.join(subdir, fn))

    def __len__(self):
        return len(self.files)

    def sample_instance(self, rng, index, n=None):
        data = np.load(self.files[index])
        data = subsample_fixed(rng, data, n or self.cfg.input_pc_num)
        return split_pc_sn(data, self.sn_len)

    def item_path(self, index):
        return self.files[index]


class ConcatSiameseDataset(SiameseDetectorDataset):
    """Concatenation of same-type siamese datasets (scenenn trains on
    train+val, scenenn/train_detector.py:55-60). Delegates loading to the
    child owning each index, so the native batch fast path keeps working."""

    def __init__(self, children: Sequence[SiameseDetectorDataset]):
        assert children
        super().__init__(children[0].cfg, children[0].sn_len)
        self.children = list(children)
        self._cum = np.cumsum([len(c) for c in children]).tolist()

    def __len__(self) -> int:
        return self._cum[-1]

    def _locate(self, index: int) -> Tuple[SiameseDetectorDataset, int]:
        for k, c in enumerate(self._cum):
            if index < c:
                start = 0 if k == 0 else self._cum[k - 1]
                return self.children[k], index - start
        raise IndexError(index)

    def sample_instance(self, rng, index, n=None):
        child, local = self._locate(index)
        return child.sample_instance(rng, local, n)

    def item_path(self, index):
        child, local = self._locate(index)
        return child.item_path(local)

    def post_batch(self, batch):
        # same-type children share the post-processing (e.g. a coordinate flip)
        return self.children[0].post_batch(batch)


class ParentCloudDataset:
    """View over a SiameseDetectorDataset for device-side siamese sampling
    (cfg.device_sampling): each item is the parent cloud at a fixed size
    {pc (P,3), sn (P,S)}; the train step draws both input_pc_num-subsamples on
    the device (train/steps.py ParentBatch), so only one copy crosses to it.

    Parent rows come in uniformly random order (the native partial
    Fisher-Yates or ``subsample_fixed``), which the train step's 'slice'
    sampling mode relies on (train/steps.py
    _as_siamese). Files larger than parent_pc_num are host-subsampled to P
    first, which mildly correlates the siamese pair against the reference's
    independent draws (kitti_detector_loader.py:101-147); at kitti scale the
    tree is exactly 20480 points, so the parent is the whole cloud."""

    def __init__(self, base: SiameseDetectorDataset):
        self.base = base
        self.cfg = base.cfg
        p = base.cfg.parent_pc_num
        if p is None:
            raise ValueError("device_sampling requires data.parent_pc_num")
        if p < base.cfg.input_pc_num:
            raise ValueError(
                f"parent_pc_num {p} < input_pc_num {base.cfg.input_pc_num}")
        self.parent_pc_num = p

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pc, sn = self.base.sample_instance(self.base._rng, index,
                                           n=self.parent_pc_num)
        return {"pc": pc, "sn": sn}

    def get_batch(self, indices: Sequence[int], offset: int = 0
                  ) -> Optional[Dict[str, np.ndarray]]:
        """The parents of ``indices`` in one native call (in the wire dtype,
        float16 encoded in the C++ pool), or None for the per-item route;
        ``offset`` as in ``SiameseDetectorDataset.get_batch``."""
        from usip_tpu_torch import native
        if not native.available():
            return None
        paths = [self.base.item_path(int(i)) for i in indices]
        if any(p is None for p in paths):
            return None
        seed = self.base._item_seed(offset)
        pc, sn = native.batch_load_subsample(paths, self.parent_pc_num,
                                             self.base.sn_len, seed=seed,
                                             dtype=self.base._wire_numpy_dtype())
        return self.base.post_batch({"pc": pc, "sn": sn})


DETECTOR_DATASETS = {
    "modelnet": ModelNetDataset,
    "shrec": ShrecDataset,
    "oxford": OxfordDataset,
    "kitti": KittiDataset,
    "scenenn": SceneNNDataset,
    "match3d": Match3DDataset,
}


def make_detector_dataset(name: str, cfg: DataConfig, mode: str, sn_len: int,
                          seed: int = 0) -> SiameseDetectorDataset:
    return DETECTOR_DATASETS[name](cfg, mode, sn_len=sn_len, seed=seed)
