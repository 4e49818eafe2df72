"""Descriptor (anchor/positive) dataset loaders and in-batch negative mining
(counterpart of ``usip_tpu/data/descriptor_loaders.py``; the port keeps its
own copy, held equal to usip_tpu's by ``tests/test_torch_host.py``).

Reference semantics:
  * oxford: positive = random scan from the anchor's pos_list; negatives mined
    in-batch as any batch entry not in the anchor's non-negative list
    (oxford_descriptor_loader.py:127-146,231-281),
  * kitti: positive = random nearby scan within positive_radius (pose-distance
    bounded search); negatives = in-batch entries >negative_radius away or in a
    different sequence (kitti_descriptor_loader.py:154-203,278-317).

The indoor pair loader (SceneNN) is not ported yet.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

from usip_tpu_torch.config import DataConfig
from usip_tpu_torch.data.augment import coordinate_enu_to_cam
from usip_tpu_torch.data.common import (relative_translation_norm,
                                        split_pc_sn, subsample_fixed)
from usip_tpu_torch.data.loaders import KittiDataset, parse_relative_txt


class OxfordDescriptorDataset:
    """Anchor + random positive; list-based in-batch negative mining."""

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 4, seed: int = 0):
        self.cfg = cfg
        self.sn_len = sn_len
        self.mode = mode
        self._rng = np.random.default_rng(seed)
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

    def _load_line(self, line_idx: int) -> np.ndarray:
        if self.mode == "train":
            fn = self.items[line_idx]["file"]
            return np.load(os.path.join(self.folder, fn[0:-3] + "npy"))
        # test entries are groundtruths.pkl rows with anc_idx/pos_idx
        return np.load(os.path.join(self.folder,
                                    f"{self.items[line_idx]['anc_idx']}.npy"))

    def _prep(self, rng, data) -> Tuple[np.ndarray, np.ndarray]:
        data = subsample_fixed(rng, data, self.cfg.input_pc_num)
        pc, sn = split_pc_sn(data, self.sn_len)
        pc = coordinate_enu_to_cam(pc)
        if self.sn_len >= 3:
            sn = np.concatenate([coordinate_enu_to_cam(sn[:, :3]), sn[:, 3:]], 1)
        return pc, sn

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = self._rng
        anc_pc, anc_sn = self._prep(rng, self._load_line(index))
        if self.mode == "train":
            pos_list = self.items[index]["pos_list"]
            pos_idx = (int(pos_list[rng.integers(0, len(pos_list))])
                       if pos_list else index)
            pos = self._load_line(pos_idx)
        else:
            pos = np.load(os.path.join(
                self.folder, f"{self.items[index]['pos_idx']}.npy"))
        pos_pc, pos_sn = self._prep(rng, pos)
        return {"anc_pc": anc_pc, "anc_sn": anc_sn,
                "pos_pc": pos_pc, "pos_sn": pos_sn,
                "index": np.int64(index)}

    def mine_negative_indices(self, batch_indices: np.ndarray,
                              rng: Optional[np.random.Generator] = None
                              ) -> np.ndarray:
        """For each batch entry pick another entry not in its non-negative list
        (oxford_descriptor_loader.py:231-281). Returns positions into the batch."""
        rng = rng or self._rng
        b = len(batch_indices)
        neg = np.zeros(b, np.int64)
        for i in range(b):
            nonneg = set(self.items[int(batch_indices[i])]["nonneg_list"])
            candidates = [j for j in range(b)
                          if j != i and int(batch_indices[j]) not in nonneg]
            if candidates:
                neg[i] = candidates[rng.integers(0, len(candidates))]
            else:
                neg[i] = (i + 1) % b  # degenerate fallback
        return neg


class KittiDescriptorDataset:
    """Anchor + nearby positive (pose search); pose-distance negative mining."""

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 4, seed: int = 0):
        self.cfg = cfg
        self.sn_len = sn_len
        self._rng = np.random.default_rng(seed)
        # reuse the detector dataset's sequence indexing + loading
        self.base = KittiDataset(cfg, mode, sn_len=sn_len, seed=seed)

    def __len__(self):
        return len(self.base)

    def _find_positive(self, rng, index: int) -> int:
        """Bounded random search for a scan within positive_radius
        (kitti_descriptor_loader.py:154-190), deadlock-guarded."""
        i, seq, in_seq = self.base.locate(index)
        _, pose = self.base.load_pose(index)
        interval = int(self.cfg.positive_radius / 0.8 * 2)
        lo = max(in_seq - interval, 0)
        hi = min(in_seq + interval, self.base.counts[i] - 1)
        start = 0 if i == 0 else self.base.cum[i - 1]
        for _ in range(interval * 3):
            cand = int(rng.integers(lo, hi + 1))
            _, cand_pose = self.base.load_pose(start + cand)
            distance = float(np.linalg.norm((cand_pose - pose)[0:3, 3]))
            if distance < self.cfg.positive_radius:
                return start + cand
            if cand < in_seq:
                lo = cand + 1
            else:
                hi = cand - 1
        return index  # fall back to self

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = self._rng
        anc_pc, anc_sn = self.base.sample_instance(rng, index)
        pos_index = self._find_positive(rng, index)
        pos_pc, pos_sn = self.base.sample_instance(rng, pos_index)
        seq, pose = self.base.load_pose(index)
        return {"anc_pc": anc_pc, "anc_sn": anc_sn,
                "pos_pc": pos_pc, "pos_sn": pos_sn,
                "seq": np.int64(seq), "pose": pose.astype(np.float32),
                "index": np.int64(index)}

    def mine_negative_indices(self, seqs: np.ndarray, poses: np.ndarray,
                              rng: Optional[np.random.Generator] = None
                              ) -> np.ndarray:
        """In-batch negatives: different sequence, or pose distance beyond
        negative_radius (kitti_descriptor_loader.py:278-317)."""
        rng = rng or self._rng
        b = len(seqs)
        neg = np.zeros(b, np.int64)
        for i in range(b):
            candidates = []
            for j in range(b):
                if j == i:
                    continue
                if seqs[i] != seqs[j]:
                    candidates.append(j)
                elif relative_translation_norm(poses[i], poses[j]) > \
                        self.cfg.negative_radius:
                    candidates.append(j)
            neg[i] = (candidates[rng.integers(0, len(candidates))]
                      if candidates else (i + 1) % b)
        return neg


def cart_to_hom_apply(T: np.ndarray, pc: np.ndarray) -> np.ndarray:
    """hom2cart(T @ cart2hom(pc)) for (N, 3) pc and 4x4 T
    (scenenn_descriptor_loader.py:230-240)."""
    homo = np.concatenate([pc, np.ones((pc.shape[0], 1), pc.dtype)], axis=1)
    out = homo @ T.T
    return out[:, :3] / out[:, 3:4]
