"""Descriptor (anchor/positive) dataset loaders and in-batch negative mining
(counterpart of ``usip_tpu/data/descriptor_loaders.py``; the port keeps its
own copy, held equal to usip_tpu's by ``tests/test_torch_host.py``, and
adds a native pair batch path to the KITTI loader, whose draws are its
own).

Reference semantics:
  * oxford: positive = random scan from the anchor's pos_list; negatives mined
    in-batch as any batch entry not in the anchor's non-negative list
    (oxford_descriptor_loader.py:127-146,231-281),
  * kitti: positive = random nearby scan within positive_radius (pose-distance
    bounded search); negatives = in-batch entries >negative_radius away or in a
    different sequence (kitti_descriptor_loader.py:154-203,278-317),
  * scenenn (indoor): real pair list; the anchor is ICP-aligned into the positive's
    frame (hom2cart(icp @ cart2hom(pc)), scenenn_descriptor_loader.py:230-240); the
    CGF loss then uses the device-side GT transform and mines its negatives
    per keypoint on the device, so this loader mines none.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from usip_tpu_torch.config import DataConfig
from usip_tpu_torch.data.augment import coordinate_enu_to_cam
from usip_tpu_torch.data.common import (relative_translation_norm,
                                        split_pc_sn, subsample_fixed)
from usip_tpu_torch.data.loaders import (KittiDataset, SiameseDetectorDataset,
                                         parse_relative_txt)


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
    """Anchor + nearby positive (pose search); pose-distance negative mining.

    The split's poses are read once, at construction: ``poses`` ``(len, 4,
    4)`` as stored, and ``seqs`` ``(len,)``, the sequence of each index.
    The positive search and the items read them there.

    Two paths, as the detector datasets have (``data/loaders.py``). By
    default ``get_batch`` assembles a whole pair batch: the positives are
    searched on the host with the dataset's Generator, in batch order, then
    the Generator draws one seed for the anchors and one for the positives
    (``_item_seed``), and two calls of the native library's thread pool load,
    subsample and split the clouds, item b drawing from ``seed + b * 7919``,
    encoded to the wire there. usip_tpu has no such pair path, so these
    batches are the port's own draws. Where the library is not built, or the
    scans are radius-cropped, ``get_batch`` returns None and the loader
    fetches items through ``__getitem__``, every draw from the dataset's
    Generator in usip_tpu's order: item for item usip_tpu's.

    The loader's producer thread makes those draws while the main thread
    mines the negatives, so the miner draws from a Generator of its own
    (``_miner_rng``, seeded from ``seed``) where usip_tpu's shares the
    dataset's: a seed then gives the same batches and negatives however the
    two threads interleave.

    ``counts``: ``native_batches`` (batches ``get_batch`` assembled),
    ``numpy_items`` (items ``__getitem__`` assembled) and
    ``positive_fallbacks`` (searches that found no scan within
    ``positive_radius`` and paired the anchor with itself).
    """

    _item_seed = SiameseDetectorDataset._item_seed
    _wire_numpy_dtype = SiameseDetectorDataset._wire_numpy_dtype

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 4, seed: int = 0):
        self.cfg = cfg
        self.sn_len = sn_len
        self._rng = np.random.default_rng(seed)
        self._miner_rng = np.random.default_rng((seed, 1))
        # reuse the detector dataset's sequence indexing + loading
        self.base = KittiDataset(cfg, mode, sn_len=sn_len, seed=seed)
        table = [self.base.load_pose(i) for i in range(len(self.base))]
        self.seqs = np.array([seq for seq, _ in table], np.int64)
        self.poses = (np.stack([pose for _, pose in table]) if table
                      else np.zeros((0, 4, 4)))
        self.counts = {"native_batches": 0, "numpy_items": 0,
                       "positive_fallbacks": 0}

    def __len__(self):
        return len(self.base)

    def _find_positive(self, rng, index: int) -> int:
        """Bounded random search for a scan within positive_radius
        (kitti_descriptor_loader.py:154-190), deadlock-guarded."""
        i, seq, in_seq = self.base.locate(index)
        pose = self.poses[index]
        interval = int(self.cfg.positive_radius / 0.8 * 2)
        lo = max(in_seq - interval, 0)
        hi = min(in_seq + interval, self.base.counts[i] - 1)
        start = 0 if i == 0 else self.base.cum[i - 1]
        for _ in range(interval * 3):
            cand = int(rng.integers(lo, hi + 1))
            cand_pose = self.poses[start + cand]
            distance = float(np.linalg.norm((cand_pose - pose)[0:3, 3]))
            if distance < self.cfg.positive_radius:
                return start + cand
            if cand < in_seq:
                lo = cand + 1
            else:
                hi = cand - 1
        self.counts["positive_fallbacks"] += 1
        return index  # fall back to self

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = self._rng
        anc_pc, anc_sn = self.base.sample_instance(rng, index)
        pos_index = self._find_positive(rng, index)
        pos_pc, pos_sn = self.base.sample_instance(rng, pos_index)
        self.counts["numpy_items"] += 1
        return {"anc_pc": anc_pc, "anc_sn": anc_sn,
                "pos_pc": pos_pc, "pos_sn": pos_sn,
                "seq": self.seqs[index],
                "pose": self.poses[index].astype(np.float32),
                "index": np.int64(index)}

    def get_batch(self, indices: Sequence[int], offset: int = 0
                  ) -> Optional[Dict[str, np.ndarray]]:
        """The pair batch of ``indices`` through the native library, with
        the keys, shapes and metadata of the collated ``__getitem__`` items
        and the clouds in the wire's dtype; None where the library is not
        built or the scans are cropped. ``indices`` sit at ``offset`` in the
        global batch."""
        from usip_tpu_torch import native
        if not native.available():
            return None
        anchors = [int(i) for i in indices]
        anc_paths = [self.base.item_path(i) for i in anchors]
        if any(p is None for p in anc_paths):
            return None
        positives = [self._find_positive(self._rng, i) for i in anchors]
        pos_paths = [self.base.item_path(i) for i in positives]
        n, dt = self.cfg.input_pc_num, self._wire_numpy_dtype()
        anc_pc, anc_sn = native.batch_load_subsample(
            anc_paths, n, self.sn_len, seed=self._item_seed(offset), dtype=dt)
        pos_pc, pos_sn = native.batch_load_subsample(
            pos_paths, n, self.sn_len, seed=self._item_seed(offset), dtype=dt)
        self.counts["native_batches"] += 1
        return {"anc_pc": anc_pc, "anc_sn": anc_sn,
                "pos_pc": pos_pc, "pos_sn": pos_sn,
                "seq": self.seqs[anchors],
                "pose": self.poses[anchors].astype(np.float32),
                "index": np.array(anchors, np.int64)}

    def mine_negative_indices(self, seqs: np.ndarray, poses: np.ndarray,
                              rng: Optional[np.random.Generator] = None
                              ) -> np.ndarray:
        """In-batch negatives: different sequence, or pose distance beyond
        negative_radius (kitti_descriptor_loader.py:278-317); without
        ``rng`` the miner's own Generator."""
        rng = rng or self._miner_rng
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


class SceneNNDescriptorDataset:
    """Indoor pair loader: anchor frame ICP-aligned onto its positive frame."""

    def __init__(self, cfg: DataConfig, mode: str, sn_len: int = 4, seed: int = 0,
                 test_subsample: int = 3):
        self.cfg = cfg
        self.sn_len = sn_len
        self.mode = mode
        self._rng = np.random.default_rng(seed)
        root = cfg.dataroot
        self.frame_folder = os.path.join(root, "frames_" + mode)
        with open(os.path.join(root, f"info_{mode}.pkl"), "rb") as f:
            info = pickle.load(f)
        self.pairs_np = np.asarray(info["pairs_np"])  # (P, 2) [anc, pos]
        self.icp_np = np.asarray(info["icp_np"])      # (P, 4, 4)
        if mode != "train" and test_subsample > 1:
            # test set subsampled x1/3 (scenenn_descriptor_loader.py:92-96)
            keep = np.arange(0, len(self.pairs_np), test_subsample)
            self.pairs_np = self.pairs_np[keep]
            self.icp_np = self.icp_np[keep]

    def __len__(self):
        return len(self.pairs_np)

    def _load(self, rng, frame_idx: int):
        data = np.load(os.path.join(self.frame_folder, f"{frame_idx}.npy"))
        data = subsample_fixed(rng, data, self.cfg.input_pc_num)
        return split_pc_sn(data, self.sn_len)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = self._rng
        anc_idx, pos_idx = (int(self.pairs_np[index][0]),
                            int(self.pairs_np[index][1]))
        anc_pc, anc_sn = self._load(rng, anc_idx)
        pos_pc, pos_sn = self._load(rng, pos_idx)
        icp = self.icp_np[index].astype(np.float64)
        anc_pc = cart_to_hom_apply(icp, anc_pc).astype(np.float32)
        if self.sn_len >= 3:
            R = icp[:3, :3].astype(np.float32)
            anc_sn = np.concatenate([anc_sn[:, :3] @ R.T, anc_sn[:, 3:]], axis=1)
        return {"anc_pc": anc_pc, "anc_sn": anc_sn,
                "pos_pc": pos_pc, "pos_sn": pos_sn,
                "index": np.int64(index)}
