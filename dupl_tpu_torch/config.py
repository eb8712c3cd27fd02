"""Recipe configuration of the port: one frozen dataclass per concern.

The port's own copy of the recipe dataclasses (model, optimizer, PAR, GMM,
CRF, data, training schedule) and of the VOC and COCO recipes.  Field names,
defaults and recipe values equal those of the JAX package's ``config`` module;
``tests/test_torch_config.py`` compares the two field by field.  Nothing here
imports or locates the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

VOC_CLASS_LIST = (
    "bg", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "table", "dog", "horse", "motorbike", "person", "plant",
    "sheep", "sofa", "train", "tvmonitor",
)

# Per-class cosine-descent targets for the high CAM threshold
# (reference: train_final_voc.py:163-166 — 0.70 for a few "stuff-like" classes,
# 0.55 for the rest; indexed by foreground class 0..19).
VOC_HIGH_THRE_TARGETS = (
    0.70, 0.70, 0.70, 0.70, 0.55, 0.55, 0.55, 0.55, 0.70, 0.55,
    0.55, 0.55, 0.55, 0.55, 0.55, 0.55, 0.55, 0.55, 0.70, 0.55,
)

# The 80 COCO categories in the VOC-style mask index order (1..80 after bg).
COCO_CLASS_LIST = (
    "bg", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Dual-student model (reference: model/model_dupl.py:9-214)."""

    backbone: str = "deit_base_patch16"          # vit registry name
    num_classes: int = 21                        # incl. background
    aux_layer: int = -3                          # block tap for aux classifier (vit.py:326)
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    decoder_dim: int = 512                       # LargeFOV embed (decoder/conv_head.py:14)
    decoder_dilation: int = 5
    pretrained_img_size: int = 224               # grid that pos_embed was trained at
    # Compute dtype for matmul-heavy paths.  Params stay float32; bfloat16
    # operands run on the tensor cores.
    compute_dtype: str = "bfloat16"
    # Residual-stream dtype for the ViT blocks.  float32 for training
    # (LayerNorm statistics and residual adds at full precision); inference
    # pipelines set bfloat16, halving the device-memory traffic between the
    # matrix products.
    stream_dtype: str = "float32"
    # tanh-approximate GELU deviates by ~1e-3 from the exact form; training
    # defaults to the exact erf form the backbone was trained with (torch
    # nn.GELU default); inference pipelines may enable the approximation.
    gelu_approximate: bool = False
    # dynamic-int8 GEMMs for inference pipelines only (ops/quant.py; the
    # Trainer refuses a training step with it).  Never enabled for training.
    quantized_inference: bool = False
    # Residual-stream dtype for the NO-GRAD multi-scale CAM pass in training
    # (reference: torch.no_grad() forwards, train_final_voc.py:216).  ``None``
    # follows ``stream_dtype``; the production recipes (tools/train.py) set
    # "bfloat16" — the grad forward keeps ``stream_dtype`` while the CAM pass
    # tolerates bf16 rounding (pseudo-labels come from min-max-normalised CAMs
    # and the whole pipeline is built for label noise; agreement vs an f32
    # stream is tested in tests/test_train_step.py).
    cam_stream_dtype: Optional[str] = None
    # rematerialise transformer blocks in the backward pass
    # (torch.utils.checkpoint): trades a second block forward for O(depth)
    # activation memory.
    remat: bool = False

    @property
    def num_fg(self) -> int:
        return self.num_classes - 1

    @property
    def grid(self) -> int:
        return self.pretrained_img_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """PolyWarmupAdamW semantics (reference: utils/optimizer.py:38-68,
    utils/train_helper.py:21-53): linear warmup from ``lr*warmup_ratio`` over
    ``warmup_iters`` then ``(1 - t/T)**power`` decay; heads & decoder run at 10x LR."""

    lr: float = 6e-5
    warmup_iters: int = 1500
    warmup_ratio: float = 1e-6
    power: float = 0.9
    weight_decay: float = 1e-2
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    head_lr_mult: float = 10.0


@dataclasses.dataclass(frozen=True)
class ParConfig:
    """Pixel-adaptive refinement (reference: model/PAR.py)."""

    dilations: Sequence[int] = (1, 2, 4, 8, 12, 24)
    num_iter: int = 10
    w1: float = 0.3                              # rgb affinity bandwidth
    w2: float = 0.01                             # position-affinity mix-in
    down_scale: int = 2                          # run PAR at half image res
    compute_dtype: str = "float32"               # "bfloat16": inference-only
                                                 # fast path (f32-accumulated)
    # Compact the PAR class axis to this many present classes (the batched
    # form of the reference's per-image valid-key gather, cam_helper.py:413).
    # EXACT with a fallback to the full axis when an image exceeds
    # it; None disables.  10 covers every VOC image; COCO recipes use 16.
    class_budget: Optional[int] = 10


@dataclasses.dataclass(frozen=True)
class GmmConfig:
    """On-device per-image 2-component EM noise filter (replaces sklearn loop,
    reference: train_final_voc.py:358-394)."""

    num_iter: int = 10
    reg_covar: float = 5e-4
    loss_floor: float = 0.1                      # only losses > floor enter the fit
    min_pixels: int = 1000                       # skip fit below this count
    valid_thre: float = 1.0                      # |mu1 - mu0| gate
    gamma: float = 0.95                          # p(noise) threshold


@dataclasses.dataclass(frozen=True)
class CrfConfig:
    """Mean-field CRF post-processing (reference: utils/dcrf.py:42-68 with params
    from tools/eval_seg_voc.py:104-111)."""

    iter_max: int = 10
    pos_w: float = 1.0
    pos_xy_std: float = 1.0
    bi_w: float = 4.0
    bi_xy_std: float = 121.0
    bi_rgb_std: float = 5.0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    root_dir: str = ""
    name_list_dir: str = ""
    train_split: str = "train_aug"
    val_split: str = "val"
    crop_size: int = 448
    rescale_range: Tuple[float, float] = (0.5, 2.0)
    img_fliplr: bool = True
    num_workers: int = 8
    prefetch: int = 4


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    optim: OptimConfig = OptimConfig()
    par: ParConfig = ParConfig()
    gmm: GmmConfig = GmmConfig()
    crf: CrfConfig = CrfConfig()
    data: DataConfig = DataConfig()

    seed: int = 0
    samples_per_device: int = 2
    # The reference recipe's GLOBAL batch (VOC: 2/GPU x 2 GPUs = 4,
    # README.md:87; COCO: 2/GPU x 4 GPUs = 8, README.md:97).  Optimization
    # dynamics follow the global batch, not the per-device one, so the
    # production entry point (tools/train.py) derives
    # ``samples_per_device = max(1, global_batch // n_data_devices)`` from
    # this unless ``--samples-per-device`` is given explicitly; library users
    # who construct their own loops from ``samples_per_device`` are
    # unaffected (``None`` disables the derivation).
    global_batch: Optional[int] = 4
    max_iters: int = 20000
    log_iters: int = 200
    eval_iters: int = 2000

    # Curriculum phase boundaries (reference: train_final_voc.py:194,286 /
    # train_final_coco.py:241,312).
    cam_iters: int = 2000                        # phase 1: cls+ptc+sim only
    gmm_iters: int = 8000                        # phase 2: + cross seg loss; phase 3: + GMM & reg
    # COCO only: iteration at which pseudo-label source switches from aux-CAM
    # static thresholds to main-CAM dynamic thresholds (train_final_coco.py:312-333).
    refine_switch_iters: Optional[int] = None

    # CAM thresholds (train_final_voc.py:78-81).
    high_thre: float = 0.7
    low_thre: float = 0.25
    bkg_thre: float = 0.5
    high_thre_targets: Tuple[float, ...] = VOC_HIGH_THRE_TARGETS
    cam_scales: Tuple[float, ...] = (1.0, 0.5, 1.5)
    # Merge the training-time multi-scale CAMs at input_size/this factor
    # instead of full resolution.  ``None`` keeps the reference semantics
    # (merge at input size, cam_helper.py:186); the production recipes set 2 —
    # every training consumer downscales anyway (PAR refinement at
    # ``par.down_scale`` = 2, PTC targets at patch resolution), so the
    # full-res merge is pure memory traffic.  Pseudo-label deviation is bounded
    # by tests/test_train_step.py::test_cam_merge_downscale_agreement.
    cam_merge_downscale: Optional[int] = None

    # Loss weights (train_final_voc.py:451-456).
    w_ptc: float = 0.2
    w_seg: float = 0.2
    w_sim: float = 0.1
    w_reg: float = 0.05

    # Strong-view perturbation (imutils.py:305-317): RandAugment(n, m) + hflip.
    aug_n: int = 5
    aug_m: int = 10
    aug_downscale: float = 0.75                  # model_dupl.py:196
    reg_conf_thre: float = 0.9                   # train_final_voc.py:422

    ignore_index: int = 255
    work_dir: str = "work_dir"
    class_list: Tuple[str, ...] = VOC_CLASS_LIST

    @property
    def num_classes(self) -> int:
        return self.model.num_classes


def voc_config(**overrides) -> TrainConfig:
    """VOC recipe (reference defaults: train_final_voc.py:33-90)."""
    return dataclasses.replace(TrainConfig(), **overrides)


def coco_config(**overrides) -> TrainConfig:
    """COCO recipe (reference: train_final_coco.py — 81 classes, 80k iters,
    uniform 0.65→0.55 high-threshold schedule, bkg 0.45, aux_layer=9,
    refine source switch at 12k iters)."""
    base = TrainConfig(
        model=ModelConfig(num_classes=81, aux_layer=9),
        par=ParConfig(class_budget=16),  # COCO images rarely exceed 15 cats
        max_iters=80000,
        cam_iters=8000,
        gmm_iters=32000,
        refine_switch_iters=12000,
        samples_per_device=2,
        global_batch=8,
        high_thre=0.65,
        low_thre=0.25,
        bkg_thre=0.45,
        high_thre_targets=tuple([0.55] * 80),
        # COCO weights sim at 0.05 in every active phase
        # (train_final_coco.py:441-448), vs 0.1 on VOC.
        w_sim=0.05,
        class_list=COCO_CLASS_LIST,
    )
    return dataclasses.replace(base, **overrides)


def bench_config(dataset: str = "voc", **model_overrides) -> TrainConfig:
    """The configuration of the JAX side's measurement programs
    (``bench.py:105-109``, ``tools/bench_components.py:74-81``): the
    dataset's recipe with a ViT-B/16 of tanh GELU and a bf16 residual
    stream, and PAR propagating in bf16 on a class budget.  VOC: 21 classes,
    budget 10; COCO: ``coco_config`` with its model replaced as the JAX
    tool replaces it (81 classes, the default ``aux_layer``), budget 16.
    ``model_overrides`` set further ``ModelConfig`` fields (``backbone``;
    ``quantized_inference``, the JAX tool's ``--int8``: w8a8 products in
    every block, ``ops/quant.py``)."""
    recipe, num_classes, budget = {"voc": (voc_config, 21, 10),
                                   "coco": (coco_config, 81, 16)}[dataset]
    model = ModelConfig(**{"num_classes": num_classes,
                           "gelu_approximate": True,
                           "stream_dtype": "bfloat16", **model_overrides})
    return recipe(model=model,
                  par=ParConfig(compute_dtype="bfloat16", class_budget=budget))


def resolve_samples_per_device(cfg: TrainConfig, n_data: int):
    """Derive ``samples_per_device`` from the recipe's global batch.

    The reference's optimization recipe is defined by its GLOBAL batch
    (VOC 4 / COCO 8 — README.md:87,97); per-device batch is an artifact of
    the rig.  Returns ``(cfg, warning_or_None)`` with ``samples_per_device``
    set to ``max(1, global_batch // n_data)``; a warning string is returned
    when the mesh cannot hit the recipe's global batch exactly.  No-op when
    ``cfg.global_batch`` is None.
    """
    if cfg.global_batch is None:
        return cfg, None
    spd = max(1, cfg.global_batch // n_data)
    warn = None
    if spd * n_data != cfg.global_batch:
        warn = (f"global_batch {cfg.global_batch} not divisible by {n_data} "
                f"data devices; training at global batch {spd * n_data}")
    return dataclasses.replace(cfg, samples_per_device=spd), warn
