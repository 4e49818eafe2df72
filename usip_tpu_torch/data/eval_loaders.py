"""Evaluation-only frame loaders feeding keypoint export (counterpart of
``usip_tpu/data/eval_loaders.py``; the port keeps its own copy, replacing
the reference's evaluation/{kitti_test,oxford_test,redwood}_loader.py and
data/{match3d_eval,modelnet_rotated}_loader.py)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from usip_tpu_torch.config import DataConfig
from usip_tpu_torch.data.augment import coordinate_enu_to_cam
from usip_tpu_torch.data.common import split_pc_sn, subsample_fixed
from usip_tpu_torch.data.loaders import KITTI_NP_FOLDER


def load_kitti_test_pairs(txt_root: str, seq: int) -> List[Dict]:
    """Parse groundtruths.txt for one sequence into unique anc frames with a
    paired pos frame (evaluation/kitti_test_loader.py:24-58)."""
    dataset: List[Dict] = []
    seen = set()
    with open(os.path.join(txt_root, f"{seq:02d}", "groundtruths.txt")) as f:
        for i, line in enumerate(f):
            if i == 0:
                continue  # header
            parts = line.split()
            anc_idx, pos_idx = int(parts[0]), int(parts[1])
            if anc_idx not in seen:
                seen.add(anc_idx)
                dataset.append({"seq": seq, "anc_idx": anc_idx, "pos_idx": pos_idx})
            if pos_idx not in seen:
                seen.add(pos_idx)
                dataset.append({"seq": seq, "anc_idx": pos_idx, "pos_idx": anc_idx})
    return dataset


class KittiTestFrames:
    """Unique test frames from the registration ground-truth lists; yields
    (pc, sn, seq, anc_idx) for keypoint export."""

    def __init__(self, cfg: DataConfig, txt_root: str, numpy_root: str,
                 seqs=(9, 10), sn_len: int = 4, seed: int = 0):
        self.cfg = cfg
        self.sn_len = sn_len
        self.numpy_root = numpy_root
        self._rng = np.random.default_rng(seed)
        self.items: List[Dict] = []
        for seq in seqs:
            self.items.extend(load_kitti_test_pairs(txt_root, seq))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        item = self.items[index]
        path = os.path.join(self.numpy_root, f"{item['seq']:02d}",
                            KITTI_NP_FOLDER, f"{item['anc_idx']:06d}.npy")
        data = subsample_fixed(self._rng, np.load(path), self.cfg.input_pc_num)
        pc, sn = split_pc_sn(data, self.sn_len)
        return {"pc": pc, "sn": sn, "seq": np.int64(item["seq"]),
                "frame": np.int64(item["anc_idx"])}


class OxfordTestFrames:
    """The Oxford test models ``0.npy .. {n-1}.npy``, ENU->cam
    (evaluation/oxford_test_loader.py:43-88).

    ``count=None`` (the port's default) counts the models on disk, at most
    the protocol's 828: the full tree gives usip_tpu's 828, a smaller one (a
    synthetic tree) its own count, where usip_tpu always reads 828. A gap in
    the numbering raises, as usip_tpu fails on the missing file."""

    def __init__(self, cfg: DataConfig, sn_len: int = 4, seed: int = 0,
                 count: Optional[int] = None):
        self.cfg = cfg
        self.sn_len = sn_len
        self._rng = np.random.default_rng(seed)
        self.folder = os.path.join(cfg.dataroot, "test_models_20k_np_nofilter")
        if count is None:
            names = {f for f in os.listdir(self.folder) if f.endswith(".npy")}
            if not names:
                raise FileNotFoundError(f"no Oxford test models in "
                                        f"{self.folder}")
            missing = sorted(set(map("{}.npy".format, range(len(names))))
                             - names)
            if missing:
                raise FileNotFoundError(
                    f"Oxford test models in {self.folder} are not numbered "
                    f"0..{len(names) - 1}: {missing[0]} is missing")
            count = min(len(names), 828)
        self.count = count

    def __len__(self):
        return self.count

    def __getitem__(self, index):
        data = np.load(os.path.join(self.folder, f"{index}.npy"))
        data = subsample_fixed(self._rng, data, self.cfg.input_pc_num)
        pc, sn = split_pc_sn(data, self.sn_len)
        pc = coordinate_enu_to_cam(pc)
        if self.sn_len >= 3:
            sn = np.concatenate([coordinate_enu_to_cam(sn[:, :3]), sn[:, 3:]], 1)
        return {"pc": pc, "sn": sn, "seq": np.int64(0), "frame": np.int64(index)}


class RedwoodFrames:
    """Redwood eval scenes: <root>/<scene>/*.npy (evaluation/redwood_loader.py)."""

    SCENES = ("livingroom1", "livingroom2", "office1", "office2")

    def __init__(self, cfg: DataConfig, sn_len: int = 4, seed: int = 0,
                 scenes=None):
        self.cfg = cfg
        self.sn_len = sn_len
        self._rng = np.random.default_rng(seed)
        self.items = []
        for si, scene in enumerate(scenes or self.SCENES):
            folder = os.path.join(cfg.dataroot, scene)
            if not os.path.isdir(folder):
                continue
            n = len([f for f in os.listdir(folder) if f.endswith(".npy")])
            for i in range(n):
                self.items.append((si, scene, i))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        si, scene, frame = self.items[index]
        data = np.load(os.path.join(self.cfg.dataroot, scene, f"{frame}.npy"))
        data = subsample_fixed(self._rng, data, self.cfg.input_pc_num)
        pc, sn = split_pc_sn(data, self.sn_len)
        return {"pc": pc, "sn": sn, "seq": np.int64(si), "frame": np.int64(frame)}


class Match3DEvalFrames:
    """3DMatch eval fragments: 8 fixed scenes (data/match3d_eval_loader.py:39-57)."""

    SCENES = (
        "7-scenes-redkitchen",
        "sun3d-home_at-home_at_scan1_2013_jan_1",
        "sun3d-home_md-home_md_scan9_2012_sep_30",
        "sun3d-hotel_uc-scan3",
        "sun3d-hotel_umd-maryland_hotel1",
        "sun3d-hotel_umd-maryland_hotel3",
        "sun3d-mit_76_studyroom-76-1studyroom2",
        "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika",
    )

    def __init__(self, cfg: DataConfig, sn_len: int = 4, seed: int = 0,
                 scenes=None):
        self.cfg = cfg
        self.sn_len = sn_len
        self._rng = np.random.default_rng(seed)
        self.items = []
        for si, scene in enumerate(scenes or self.SCENES):
            folder = os.path.join(cfg.dataroot, scene)
            if not os.path.isdir(folder):
                continue
            n = len([f for f in os.listdir(folder) if f.endswith(".npy")])
            for i in range(n):
                self.items.append((si, scene, i))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        si, scene, frame = self.items[index]
        data = np.load(os.path.join(self.cfg.dataroot, scene,
                                    f"cloud_bin_{frame}.npy"))
        data = subsample_fixed(self._rng, data, self.cfg.input_pc_num)
        pc, sn = split_pc_sn(data, self.sn_len)
        return {"pc": pc, "sn": sn, "seq": np.int64(si), "frame": np.int64(frame)}


class ModelNetRotatedFrames:
    """Original + rotated ModelNet test clouds for repeatability
    (data/modelnet_rotated_loader.py:18-29): <root>/{original,rotated}/<i>.npy and
    gt transforms <root>/rotated/<i>_gt.npy (4x4), if present."""

    def __init__(self, cfg: DataConfig, sn_len: int = 3, seed: int = 0,
                 subset: str = "original"):
        self.cfg = cfg
        self.sn_len = sn_len
        self.subset = subset
        self._rng = np.random.default_rng(seed)
        folder = os.path.join(cfg.dataroot, subset)
        self.count = len([f for f in os.listdir(folder)
                          if f.endswith(".npy") and not f.endswith("_gt.npy")])

    def __len__(self):
        return self.count

    def __getitem__(self, index):
        data = np.load(os.path.join(self.cfg.dataroot, self.subset,
                                    f"{index}.npy"))
        data = subsample_fixed(self._rng, data, self.cfg.input_pc_num)
        pc, sn = split_pc_sn(data, self.sn_len)
        return {"pc": pc, "sn": sn, "seq": np.int64(0), "frame": np.int64(index)}
