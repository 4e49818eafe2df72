"""Single dataclass-based config system: the port's own copy of
``usip_tpu/config.py`` (pure stdlib), kept field for field and preset for
preset equal to it (``tests/test_torch_host.py`` holds the two together).

Replaces the reference's nine per-dataset argparse ``Options`` copies
(``{modelnet,oxford,kitti,scenenn,match3d}/options_*.py``) with one config
type plus per-dataset presets. Preset values transcribed from the defaults
table of those files (see SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class DetectorConfig:
    """Architecture + loss hyperparameters of the keypoint detector.

    Mirrors the knobs consumed by ``RPN_Detector``/``RPN_DetectorLite``/
    ``RPN_Detector_KNN``/``RPN_Detector_Ball`` (reference models/networks.py:20-738).
    """

    # grouping variant: 'som' (query_topk + scatter-max, RPN_Detector),
    # 'knn' (RPN_Detector_KNN), 'ball' (RPN_Detector_Ball)
    grouping: str = "som"
    # feature widths; full detector uses (128, 512), lite (indoor) uses (64, 256)
    c1: int = 128
    c2: int = 512
    # point->node association top-k (reference opt.k, always 1 in released configs)
    k: int = 1
    # kNN over nodes inside GeneralKNNFusionModule (reference opt.node_knn_k_1)
    node_knn_k: int = 16
    # grouping size for knn/ball variants (reference hardcodes 64, networks.py:563,691)
    group_k: int = 64
    # ball radius for the 'ball' variant (reference hardcodes 2, networks.py:692)
    group_radius: float = 2.0
    surface_normal_len: int = 4
    activation: str = "relu"
    normalization: str = "batch"
    # sigma = softplus(head) + lower bound (networks.py:154)
    sigma_lower_bound: float = 1e-3
    # trunk/fusion matmul compute dtype ('bfloat16' rides the MXU at full rate;
    # geometry/distances/head stay fp32). Params are always fp32.
    compute_dtype: str = "bfloat16"
    # masked scatter-max backend: 'fast' | 'native' | 'onehot' (ops/segment.py)
    scatter_backend: str = "fast"
    # knn/ball trunk neighbor selection: 'exact' (reference top-k / natural-
    # order scan semantics) | 'approx' (lax.approx_min_k bucketed reduction,
    # ~7x less select time at LiDAR scale; a documented semantic deviation —
    # near-miss neighbors for 'knn', bucket-strided scan picks for 'ball')
    group_method: str = "exact"
    # inference-time kNN-fusion stack executor: 'xla' | 'pallas' (VMEM-
    # resident fused MLP chain, ops/pallas_kernels.py fused_fusion_chain;
    # eval-mode only — BN folded into the weights. Training always uses XLA.)
    fusion_backend: str = "xla"


@dataclass(frozen=True)
class DescriptorConfig:
    """Ball-grouping descriptor (DescriptorLiteOld / DescriptorLiteOldGlobal)."""

    descriptor_len: int = 128
    ball_radius: float = 2.0
    ball_nsamples: int = 64
    # 'global' adds the PPFNet-style global-context fusion (networks.py:388-479)
    use_global_context: bool = False
    # training objective: None follows the reference pairing (CGF keypoint
    # triplet iff global-context/indoor, scan triplet otherwise,
    # train_descriptor.py loss selection); True/False overrides it — e.g. the
    # per-keypoint CGF triplet on an outdoor preset, the lever PERFORMANCE.md's
    # yaw protocol identifies (requires augment.height_scale=false; the
    # height rescale does not commute with post-detection CGF grouping)
    use_cgf_loss: Optional[bool] = None
    # ball_query selection: 'exact' keeps the reference's uniform
    # without-replacement ball sampling semantics; 'auto' switches clouds
    # >=4096 points to the TPU approx_min_k partial reduction (7.6x faster,
    # distribution preserved — ops/grouping.py). Default is parity-safe
    # 'exact'; the A/B-validated LiDAR presets (kitti/oxford) opt into 'auto'.
    ball_method: str = "exact"
    # dtype of the ball query's (B, M, N) distance/score tensors — its entire
    # HBM traffic (1.7x at KITTI scale). 'bfloat16' is on-chip-validated
    # uniform for random priorities (ops/grouping.py) but resolves priority
    # ties toward low indices and blurs boundary membership — default is
    # parity-safe 'float32'; kitti/oxford presets opt into 'bfloat16'.
    ball_compute_dtype: str = "float32"
    surface_normal_len: int = 4
    activation: str = "relu"
    normalization: str = "batch"
    compute_dtype: str = "bfloat16"


@dataclass(frozen=True)
class LossConfig:
    """Training loss weights/thresholds (reference models/losses.py + options)."""

    keypoint_on_pc_alpha: float = 1.0
    # 'point_to_point' -> SingleSideChamferLoss; 'point_to_plane' -> PointOnSurfaceLoss
    keypoint_on_pc_type: str = "point_to_point"
    # descriptor triplet losses
    triple_loss_gamma: float = 0.5
    sigma_max: float = 3.0
    cgf_radius: float = 0.075


@dataclass(frozen=True)
class AugmentConfig:
    """On-device augmentation (reference data/augmentation.py + loader .augment())."""

    rot_horizontal: bool = False
    rot_3d: bool = False
    rot_perturbation: bool = False
    translation_perturbation: bool = False
    scale_thre: float = 0.2
    shift_thre: float = 0.2
    # per-point jitter applied inside the loaders' .augment() (per-dataset sigmas,
    # e.g. kitti_detector_loader.py:163-171, modelnet_shrec_loader.py:195-201)
    jitter: bool = False
    jitter_pc_sigma: float = 0.01
    jitter_pc_clip: float = 0.05
    jitter_node_sigma: float = 0.04
    jitter_node_clip: float = 0.1
    # modelnet reuses the same jitter noise for both siamese copies
    shared_jitter: bool = False
    # shared-augment uniform scale range (loader .augment())
    aug_scale_low: float = 0.9
    aug_scale_high: float = 1.1
    # modelnet's loader also scales the normals (modelnet_shrec_loader.py:233);
    # the lidar loaders comment that line out (oxford_detector_loader.py:172)
    scale_sn: bool = False
    # ground-truth transform of the dst copy (transform_pc_pytorch call sites)
    gt_scale_thre: float = 0.2
    gt_shift_thre: float = 0.5
    # oxford-specific random height scaling z*[0.25,1.2] (oxford_detector_loader.py:188-192)
    height_scale: bool = False
    height_scale_low: float = 0.25
    height_scale_high: float = 1.2

    @property
    def rot_type(self) -> Optional[str]:
        if self.rot_3d:
            return "3d"
        if self.rot_horizontal:
            return "2d"
        return None


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    lr: float = 1e-3
    # LR multiplied by lr_decay_ratio every lr_decay_step epochs, floored at 1e-5
    # (reference ModelDetector.update_learning_rate, train_detector.py per-dataset steps)
    lr_decay_step: int = 40
    lr_decay_ratio: float = 0.5
    lr_clip: float = 1e-5
    epochs: int = 500
    bn_momentum: float = 0.1
    bn_momentum_decay_step: Optional[int] = None
    bn_momentum_decay: float = 0.6
    # keep-ratio lower limit for random point dropout (1.0 disables; keypoint_detector.py:161)
    random_pc_dropout_lower_limit: float = 1.0
    seed: int = 0
    # --- cadence: 'epoch' (most training scripts) or 'samples' (match3d's step-count
    # loop, match3d/train_detector.py:71-80,144-145,173) ---
    cadence: str = "epoch"
    test_every_samples: int = 10_000
    # truncate the sample-cadence test sweep (match3d: break at >2000)
    test_max_samples: int = 2_000
    lr_decay_samples: int = 100_000
    # best-loss saves only after 10x test_every_samples (match3d:161)
    save_min_samples: int = 100_000
    # data-parallel submesh size; 1 = single chip
    num_devices: int = 1
    checkpoint_dir: str = "checkpoints"
    name: str = "train"
    log_every: int = 20
    save_every_epochs: int = 1
    # also keep per-epoch history files epoch_<n>.msgpack (the reference's
    # '<epoch>_net_detector.pth' trail that modelnet/oxford training scripts write,
    # modelnet/train_detector.py:111-113) instead of only best/last
    keep_epoch_checkpoints: bool = False
    # Descriptor best.msgpack selection criterion: 'loss' (reference parity —
    # the descriptor training scripts gate on best test loss, oxford/train_descriptor.py
    # test loop) or 'match_acc' (per-keypoint 1-NN matching accuracy under the
    # CGF GT alignment; requires the CGF objective). Measured motivation
    # (PERFORMANCE.md indoor 2x2): at long training the CGF test loss keeps
    # improving while fragment-registration recall DROPS — best-by-test-loss
    # picked arm D's epoch-72 checkpoint (recall 0.268) over the better
    # 30-epoch one; match_acc is the in-step registration proxy.
    select_best_by: str = "loss"
    # keypoint-scene visuals every N epochs (0 = off): .npz scatter payload +
    # PNG render, the visdom display_current_results analog
    # (keypoint_detector.py:259-334)
    vis_every_epochs: int = 0


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "modelnet"
    dataroot: str = ""
    input_pc_num: int = 5000
    node_num: int = 512
    # FPS node sampling runs over a random 1/fps_subsample_ratio subset of the cloud
    fps_subsample_ratio: int = 4
    # eval/export-time override of fps_subsample_ratio (None = same as train).
    # The reference's TEST loaders use a coarser recipe than its train loaders
    # (kitti_test_loader.py:74-131 FPS-samples nodes from a random 1/4 subset
    # vs the train loader's 1/8); our shipped eval path inherits the train
    # recipe, worth ~2 pt repeatability in our favor at kitti scale
    # (PARITY.md round 4). Set data.eval_fps_subsample_ratio=4 to run the
    # repeatability protocol at the reference test loader's exact recipe.
    eval_fps_subsample_ratio: Optional[int] = None
    # bucketed-FPS factor (ops/sampling.py): t independent FPS instances over
    # random row-buckets — sequential depth/iteration work both /t. 1 = exact.
    fps_parallel: int = 1
    num_workers: int = 8
    # kitti: optional radius crop
    crop_radius: Optional[float] = None
    # descriptor positive-pair search radius (kitti_descriptor_loader.py:154)
    positive_radius: float = 5.0
    negative_radius: float = 50.0
    # --- wire-efficiency knobs (host->device transfer is serialized with
    # compute on remote-attached TPUs; see PERFORMANCE.md engine section) ---
    # ship the parent cloud once and draw both siamese subsamples on device
    # (instead of 2x input_pc_num points per item over the wire)
    device_sampling: bool = False
    # fixed parent-cloud size for device_sampling (e.g. 20480 for the kitti
    # np_0.20_20480_r90_sn tree); must be >= input_pc_num
    parent_pc_num: Optional[int] = None
    # 'slice' (free; requires host-shuffled parent rows, which the loaders
    # guarantee) or 'topk' (exactly-independent subsets, ~30 ms/step at kitti
    # scale) — see train/steps.py _as_siamese
    device_sampling_mode: str = "slice"
    # dtype of point/normal arrays on the wire; float16 halves transfer bytes
    # (decoded to float32 on device before any geometry). 'quant' (parent-
    # cloud wire mode only) packs coords as int16 + normals as int8 with
    # per-cloud scales — 10 bytes/pt vs float16's 14 at S=4, and *tighter*
    # coordinates than fp16 at LiDAR range (uniform ~1.5 mm at 100 m vs
    # fp16's ~4 cm mantissa step). 'float16_packed' (parent mode only)
    # concatenates [pc|sn] into ONE fp16 buffer so the latency-dominated
    # transport pays a single per-transfer RPC instead of two
    # (PERFORMANCE.md "wire format A/B")
    wire_dtype: str = "float32"


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    descriptor: DescriptorConfig = field(default_factory=DescriptorConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **sections) -> "Config":
        return dataclasses.replace(self, **sections)

    def with_overrides(self, **dotted) -> "Config":
        """Override leaf fields with dotted keys, e.g. ``data.input_pc_num=1024``."""
        cfg = self
        for key, value in dotted.items():
            section, _, leaf = key.partition(".")
            if not leaf:
                raise KeyError(f"expected dotted key 'section.field', got {key!r}")
            sub = getattr(cfg, section)
            cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(sub, **{leaf: value})})
        return cfg

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        """Reconstruct a Config from ``to_json`` output (e.g. a training run's
        saved config.json, for export/eval against that run)."""
        raw = json.loads(text)
        sections = {
            "data": DataConfig, "detector": DetectorConfig,
            "descriptor": DescriptorConfig, "loss": LossConfig,
            "augment": AugmentConfig, "train": TrainConfig,
        }
        kwargs = {}
        for name, typ in sections.items():
            fields = {f.name for f in dataclasses.fields(typ)}
            vals = {k: v for k, v in raw.get(name, {}).items() if k in fields}
            # json turns None-typed ints into strings via default=str; coerce
            for k, v in list(vals.items()):
                if v == "None":
                    vals[k] = None
            kwargs[name] = typ(**vals)
        return cls(**kwargs)


def _object_preset() -> Config:
    """ModelNet40 / SHREC detector (reference modelnet/options_detector.py)."""
    return Config(
        data=DataConfig(dataset="modelnet", input_pc_num=5000, node_num=512),
        detector=DetectorConfig(
            grouping="som", c1=128, c2=512, node_knn_k=32,
            surface_normal_len=3, sigma_lower_bound=1e-4,
        ),
        loss=LossConfig(keypoint_on_pc_alpha=1.0),
        augment=AugmentConfig(
            rot_3d=True, jitter=True, shared_jitter=True,
            jitter_pc_sigma=0.01, jitter_pc_clip=0.05,
            jitter_node_sigma=0.04, jitter_node_clip=0.1,
            aug_scale_low=0.8, aug_scale_high=1.2, scale_sn=True,
            gt_scale_thre=0.2, gt_shift_thre=0.5,
        ),
        train=TrainConfig(batch_size=8, lr_decay_step=40),
    )


def _oxford_preset() -> Config:
    """Oxford RobotCar detector (reference oxford/options_detector.py)."""
    return Config(
        # device_sampling: ship each ~20k-pt submap once (fp32 wire — ENU
        # magnitudes are not crop-bounded like kitti's r90)
        data=DataConfig(dataset="oxford", input_pc_num=16384, node_num=512,
                        fps_subsample_ratio=8, fps_parallel=1,
                        device_sampling=True, parent_pc_num=20480),
        detector=DetectorConfig(
            grouping="som", c1=128, c2=512, node_knn_k=16,
            surface_normal_len=4, sigma_lower_bound=1e-3,
        ),
        loss=LossConfig(keypoint_on_pc_alpha=1.0),
        augment=AugmentConfig(
            rot_horizontal=True, height_scale=True, jitter=True,
            jitter_pc_sigma=0.04, jitter_pc_clip=0.12,
            jitter_node_sigma=0.04, jitter_node_clip=0.12,
            aug_scale_low=0.7, aug_scale_high=1.3,
            gt_scale_thre=0.0, gt_shift_thre=0.5,
        ),
        train=TrainConfig(batch_size=8, lr_decay_step=10),
    )


def _kitti_preset() -> Config:
    """KITTI detector (reference kitti/options_detector.py)."""
    return Config(
        # device_sampling: the disk tree is fixed 20480-pt clouds
        # (np_0.20_20480_r90_sn) — ship the parent once in fp16 (|x| < 90 m
        # after the r90 crop -> <=0.03 m quantization vs the 0.2 m voxel grid)
        # and draw both siamese subsamples on device
        # fps_parallel=1: exact FPS (the reference's semantics). The Mosaic
        # VMEM kernel removed the serial-latency penalty that motivated the
        # round-2 bucketed t=2 default — exact now costs ~1% (943.5 vs 953.7
        # clouds/s, PERFORMANCE.md round 3); t=2 (repeatability-neutral) and
        # t=4/8 remain available where raw rate matters
        data=DataConfig(dataset="kitti", input_pc_num=16384, node_num=512,
                        fps_subsample_ratio=8, fps_parallel=1,
                        device_sampling=True, parent_pc_num=20480,
                        wire_dtype="float16"),
        detector=DetectorConfig(
            grouping="som", c1=128, c2=512, node_knn_k=16,
            surface_normal_len=4, sigma_lower_bound=1e-3,
        ),
        loss=LossConfig(keypoint_on_pc_alpha=0.01),
        augment=AugmentConfig(
            rot_horizontal=True, jitter=True,
            jitter_pc_sigma=0.04, jitter_pc_clip=0.12,
            jitter_node_sigma=0.04, jitter_node_clip=0.12,
            aug_scale_low=0.9, aug_scale_high=1.1,
            gt_scale_thre=0.0, gt_shift_thre=0.5,
        ),
        train=TrainConfig(batch_size=8, lr_decay_step=10),
    )


def _scenenn_preset() -> Config:
    """SceneNN indoor detector (reference scenenn/options_detector.py)."""
    return Config(
        # device_sampling: indoor frames are modest fixed trees — ship one
        # 12288-pt parent (fp32 wire; indoor coords need the precision) and
        # draw both siamese subsamples on device, the same lever that took
        # kitti 120->172 clouds/s (PERFORMANCE.md engine section)
        data=DataConfig(dataset="scenenn", input_pc_num=10240, node_num=512,
                        device_sampling=True, parent_pc_num=12288),
        detector=DetectorConfig(
            grouping="som", c1=128, c2=512, node_knn_k=32,
            surface_normal_len=4, sigma_lower_bound=1e-4,
        ),
        loss=LossConfig(keypoint_on_pc_alpha=100.0),
        augment=AugmentConfig(
            rot_3d=True, jitter=True,
            jitter_pc_sigma=0.01, jitter_pc_clip=0.02,
            jitter_node_sigma=0.01, jitter_node_clip=0.02,
            aug_scale_low=0.8, aug_scale_high=1.2,
            gt_scale_thre=0.1, gt_shift_thre=0.5,
        ),
        train=TrainConfig(batch_size=8, lr_decay_step=30),
    )


def _match3d_preset() -> Config:
    """3DMatch detector (reference match3d/options_detector.py)."""
    return Config(
        # device_sampling: same parent-cloud wire lever as scenenn/kitti
        data=DataConfig(dataset="match3d", input_pc_num=10240, node_num=512,
                        device_sampling=True, parent_pc_num=12288),
        detector=DetectorConfig(
            grouping="som", c1=128, c2=512, node_knn_k=32,
            surface_normal_len=4, sigma_lower_bound=1e-4,
        ),
        loss=LossConfig(keypoint_on_pc_alpha=10.0),
        augment=AugmentConfig(
            rot_3d=True, jitter=True,
            jitter_pc_sigma=0.01, jitter_pc_clip=0.02,
            jitter_node_sigma=0.01, jitter_node_clip=0.02,
            aug_scale_low=0.8, aug_scale_high=1.2,
            gt_scale_thre=0.1, gt_shift_thre=0.5,
        ),
        # match3d trains by sample count, not epochs (train_detector.py:71-80)
        train=TrainConfig(batch_size=8, lr_decay_step=40, cadence="samples",
                          epochs=100),
    )


def _descriptor_preset(base: Config, **desc_kw) -> Config:
    return dataclasses.replace(base, descriptor=DescriptorConfig(**desc_kw))


PRESETS = {
    "modelnet": _object_preset,
    "shrec": _object_preset,
    "oxford": _oxford_preset,
    "kitti": _kitti_preset,
    "scenenn": _scenenn_preset,
    "match3d": _match3d_preset,
}


def get_config(dataset: str, role: str = "detector", **overrides) -> Config:
    """Per-dataset preset; ``overrides`` are dotted keys (``data.input_pc_num=...``).

    ``role='descriptor'`` applies the descriptor-training deltas from the
    reference's options_descriptor.py files (SURVEY §5.6: kitti descriptor uses
    256 keypoints; scenenn descriptor uses 5000-pt clouds).
    """
    try:
        cfg = PRESETS[dataset]()
    except KeyError:
        raise KeyError(f"unknown dataset {dataset!r}; choose from {sorted(PRESETS)}")
    if role == "descriptor":
        if dataset == "kitti":
            cfg = cfg.with_overrides(**{"data.node_num": 256})
        elif dataset == "scenenn":
            cfg = cfg.with_overrides(**{"data.input_pc_num": 5000,
                                        "detector.node_knn_k": 4})
            # indoor pipeline builds the lite-width detector
            # (models/keypoint_detector.py:19-22 selects RPN_DetectorLite when
            # scene=='indoor'; scenenn/options_descriptor.py:64)
            cfg = dataclasses.replace(cfg, detector=lite_detector(cfg.detector))
    elif role != "detector":
        raise ValueError(f"unknown role {role!r}")
    # descriptor presets per dataset (options_descriptor.py files)
    if dataset in ("oxford", "kitti"):
        # ball 'auto'+bf16 are the A/B-validated fast paths at LiDAR scale
        # (PERFORMANCE.md round 2); parity-sensitive presets keep the
        # exact/fp32 defaults (round-2 ADVICE)
        cfg = _descriptor_preset(
            cfg, descriptor_len=128, ball_radius=2.0, ball_nsamples=64,
            use_global_context=False, surface_normal_len=4,
            ball_method="auto", ball_compute_dtype="bfloat16",
        )
        cfg = dataclasses.replace(
            cfg, loss=dataclasses.replace(cfg.loss, triple_loss_gamma=0.5, sigma_max=3.0))
    elif dataset == "scenenn":
        # indoor descriptor: node_num 512, pc 5000, ball (0.75, 448), CGF loss
        cfg = _descriptor_preset(
            cfg, descriptor_len=128, ball_radius=0.75, ball_nsamples=448,
            use_global_context=True, surface_normal_len=4,
        )
        cfg = dataclasses.replace(
            cfg, loss=dataclasses.replace(
                cfg.loss, triple_loss_gamma=0.3, sigma_max=0.5, cgf_radius=0.075))
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    return cfg


def lite_detector(cfg: DetectorConfig) -> DetectorConfig:
    """Indoor 'lite' widths (RPN_DetectorLite, networks.py:165-307)."""
    return dataclasses.replace(cfg, c1=64, c2=256)
