"""The training engine (counterpart of ``dupl_tpu/engine/train.py``;
reference: train_final_voc.py:174-472, train_final_coco.py).

One ``Trainer.train_step`` is DuPL's full step for the curriculum phase the
host-known step count falls in:

  warmup      (step < cam_iters):  cls + ptc + sim
  seg_static  (COCO only, step < refine_switch_iters): + cross seg loss from
              aux-CAM labels at static thresholds
  seg         (step < gmm_iters):  + cross seg loss from PAR-refined labels,
              dynamic thresholds
  full        (else):              + GMM noise filter + strong-view
              consistency

The JAX package traces CAM generation, PAR, the GMM and the augmentation
inside ``value_and_grad`` under ``stop_gradient``.  Here they run under
``torch.no_grad()`` (not ``inference_mode``: their results meet recorded
ops), and only two forwards record a graph: the un-flipped scale-1.0
``forward_with_cams`` of each student, whose encoder pass the CAM fusion
shares, and the strong view's ``forward``.  The two students run one after
the other where the JAX package vmaps them.

A step has no host sync: the phase, the loss weights, the LR and the
threshold schedule come from the host's step count; every data-dependent
gate is a ``where``; metrics come back as 0-d tensors.  The one host-side
decision, whether the batch fits PAR's class budget, is taken from the
batch's host copy by :meth:`Trainer.put` before anything is queued.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dupl_tpu_torch import config as config_lib
from dupl_tpu_torch.engine.optimizer import PolyWarmupAdamW
from dupl_tpu_torch.models.convert import init_weights
from dupl_tpu_torch.models.network import DualStudent, StudentOut, _dtype
from dupl_tpu_torch.ops import augment as augment_ops
from dupl_tpu_torch.ops import cam as cam_ops
from dupl_tpu_torch.ops import gmm as gmm_ops
from dupl_tpu_torch.ops import image as image_ops
from dupl_tpu_torch.ops import losses as loss_ops
from dupl_tpu_torch.ops import par as par_ops
from dupl_tpu_torch.ops import schedule as schedule_ops


def par_fn(cfg, imgs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """PAR with the recipe's ``cfg.par`` settings: (B, H, W, 3) images and
    (B, H, W, C) masks -> refined (B, H, W, C) float32."""
    p = cfg.par
    return par_ops.par_refine(imgs, masks, dilations=tuple(p.dilations),
                              num_iter=p.num_iter, w1=p.w1, w2=p.w2,
                              compute_dtype=p.compute_dtype)


def refine(cfg, cams: torch.Tensor, image01: torch.Tensor,
           cls_label: torch.Tensor, img_box, high_thre,
           fits_budget: Optional[bool] = None) -> torch.Tensor:
    """PAR-refined pseudo-labels per branch: cams (2, B, h, w, C_fg) ->
    labels (2, B, H, W).  Both students' CAMs, with both background planes,
    ride one PAR call, so the image-only affinity is computed once per
    image.  ``fits_budget``: ``cam_ops.fits_class_budget`` of ``cls_label``
    and ``cfg.par.class_budget``, taken before the CAMs were queued (None
    takes it here)."""
    valid = cams * cls_label[None, :, None, None, :]
    return cam_ops.refine_cams_with_bkg(
        functools.partial(par_fn, cfg), image01, valid, cls_label,
        high_thre=high_thre, low_thre=cfg.low_thre, img_box=img_box,
        ignore_index=cfg.ignore_index, down_scale=cfg.par.down_scale,
        class_budget=cfg.par.class_budget, fits_budget=fits_budget)


def production_config(dataset: str = "voc", **overrides):
    """The recipe the training entry point runs: the dataset's config with
    a bf16 residual stream in the no-grad CAM passes and the CAMs merged at
    half the input size."""
    base = {"voc": config_lib.voc_config,
            "coco": config_lib.coco_config}[dataset]()
    model = dataclasses.replace(base.model, cam_stream_dtype="bfloat16")
    return dataclasses.replace(base, model=model, cam_merge_downscale=2,
                               **overrides)


@dataclasses.dataclass
class TrainState:
    """What a step reads and updates in place."""
    model: DualStudent
    optimizer: PolyWarmupAdamW
    step: int                 # completed steps, known on the host
    rng: torch.Generator      # draws the strong view's op indices


class LossWeights(NamedTuple):
    cls: float
    ptc: float
    seg: float
    sim: float
    reg: float


def loss_weights(cfg, step: int) -> LossWeights:
    """Host-side phase weight table.  The reference gates with ``<=`` while
    its compute branches use ``<`` (train_final_voc.py:194 vs :451); ``<``
    is used throughout, as in the JAX package."""
    if cfg.refine_switch_iters is None:  # VOC (train_final_voc.py:451-456)
        if step < cfg.cam_iters:
            return LossWeights(1.0, cfg.w_ptc, 0.0, cfg.w_sim, 0.0)
        if step < cfg.gmm_iters:
            return LossWeights(1.0, cfg.w_ptc, cfg.w_seg, cfg.w_sim, 0.0)
        return LossWeights(1.0, cfg.w_ptc, cfg.w_seg, cfg.w_sim, cfg.w_reg)
    # COCO (train_final_coco.py:441-448)
    if step < cfg.cam_iters:
        return LossWeights(1.0, 0.0, 0.0, 0.0, 0.0)
    if step < cfg.refine_switch_iters:
        return LossWeights(1.0, 0.0, cfg.w_seg, cfg.w_sim, 0.0)
    return LossWeights(1.0, cfg.w_ptc, cfg.w_seg, cfg.w_sim, cfg.w_reg)


def phase_of(cfg, step: int) -> str:
    if step < cfg.cam_iters:
        return "warmup"
    if cfg.refine_switch_iters is not None and step < cfg.refine_switch_iters:
        return "seg_static"  # COCO: aux CAM + static thresholds (coco:312-321)
    if step < cfg.gmm_iters:
        return "seg"
    return "full"


def phase_start(cfg, phase: str) -> int:
    """The first step of a curriculum phase."""
    starts = {"warmup": 0, "seg": cfg.cam_iters, "full": cfg.gmm_iters}
    if cfg.refine_switch_iters is not None:
        starts.update(seg_static=cfg.cam_iters, seg=cfg.refine_switch_iters)
    if phase not in starts:
        raise ValueError(f"phase {phase!r} is not one of {sorted(starts)}")
    return starts[phase]


class Trainer:
    """The phase steps of one recipe on one device (``"cuda"`` unless the
    caller names another)."""

    def __init__(self, cfg, model: Optional[DualStudent] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model or DualStudent(cfg.model)
        # The no-grad CAM passes may run a cheaper residual stream
        # (ModelConfig.cam_stream_dtype) on the same parameters.
        cam_dt = cfg.model.cam_stream_dtype
        self.cam_stream_dtype = (
            _dtype(cam_dt) if cam_dt is not None
            and cam_dt != cfg.model.stream_dtype else None)
        # on the trainer's device from the start: a copy from the host
        # inside a step would wait for everything queued before it
        self.high_start = torch.full((cfg.model.num_fg,), cfg.high_thre,
                                     device=self.device)
        self.high_target = torch.tensor(cfg.high_thre_targets,
                                        dtype=torch.float32,
                                        device=self.device)
        # COCO anneals thresholds from the refine switch, VOC from cam_iters
        self.anneal_start = (
            cfg.refine_switch_iters if cfg.refine_switch_iters is not None
            else cfg.cam_iters)
        # Called with a stage's name when its work has been queued (the
        # profiler records a CUDA event there); None costs nothing.
        self.stage_hook: Optional[Callable[[str], None]] = None

    def _mark(self, stage: str) -> None:
        if self.stage_hook is not None:
            self.stage_hook(stage)

    # ------------------------------------------------------------------ state
    def init_state(self, seed: Optional[int] = None,
                   init: bool = True) -> TrainState:
        """Seeded weights (``init=False`` keeps the model's own, e.g. loaded
        ones), the model on the trainer's device, a fresh optimizer, step 0
        and the augmentation generator."""
        seed = self.cfg.seed if seed is None else seed
        if init:
            init_weights(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        optimizer = PolyWarmupAdamW(self.model, self.cfg.optim,
                                    self.cfg.max_iters)
        rng = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        return TrainState(self.model, optimizer, 0, rng)

    def put(self, batch) -> Dict[str, torch.Tensor]:
        """A batch of numpy arrays or tensors (``image``, ``cls_label``,
        ``img_box``) -> tensors on the trainer's device, plus
        ``fits_budget``: whether every image's classes fit PAR's class
        budget, read from the host copy so that no step waits for it."""
        out = {k: torch.as_tensor(v) for k, v in batch.items()
               if k != "fits_budget"}
        fits = batch.get("fits_budget")
        if fits is None:
            fits = cam_ops.fits_class_budget(out["cls_label"],
                                             self.cfg.par.class_budget)
        out = {k: v.to(self.device) for k, v in out.items()}
        out["fits_budget"] = fits
        return out

    # -------------------------------------------------------- building blocks
    def _merge_size(self, inputs: torch.Tensor):
        d = self.cfg.cam_merge_downscale
        return None if d is None else (inputs.shape[1] // d,
                                       inputs.shape[2] // d)

    def _cam_fn(self, student):
        """The no-grad CAM pass of one student, on the CAM stream dtype."""
        @torch.no_grad()
        def fn(x):
            return student.cam_only(x, stream_dtype=self.cam_stream_dtype)
        return fn

    @torch.no_grad()
    def _multi_scale_cams(self, inputs: torch.Tensor):
        """(cams, cams_aux), each (2, B, h, w, C_fg): the fused CAMs of
        both students, every scale through the no-grad CAM pass.  Merged at
        full resolution (reference semantics) or at
        input / ``cam_merge_downscale`` (production recipes)."""
        outs = [cam_ops.multi_scale_cam(
            self._cam_fn(self.model.student(i)), inputs, self.cfg.cam_scales,
            merge_size=self._merge_size(inputs)) for i in range(2)]
        return tuple(torch.stack(x) for x in zip(*outs))

    def _cams_with_grad_out(self, inputs: torch.Tensor):
        """Multi-scale CAMs (no grad) and the differentiated scale-1.0
        forward.  The un-flipped scale-1.0 encoder pass is shared between
        the CAM fusion (detached, ``Student.forward_with_cams``) and the
        head outputs the losses differentiate; the reference runs it twice.
        Its flip and the other scales run the no-grad CAM pass.  Returns
        (cams, cams_aux, out), each leaf branch-stacked."""
        per = [cam_ops.multi_scale_cam_with_outputs(
            self.model.student(i).forward_with_cams,
            self._cam_fn(self.model.student(i)), inputs, self.cfg.cam_scales,
            with_aux=True, merge_size=self._merge_size(inputs),
            split_flip=True) for i in range(2)]
        cams = torch.stack([p[0] for p in per])
        cams_aux = torch.stack([p[1] for p in per])
        out = StudentOut(*(torch.stack(x) for x in zip(per[0][2], per[1][2])))
        return cams, cams_aux, out

    @torch.no_grad()
    def _ptc_targets(self, cams_aux, cls_label, img_box, grid: int,
                     high_thre, dynamic: bool) -> torch.Tensor:
        """Affinity targets for the PTC loss from aux CAMs at patch
        resolution (train_final_voc.py:220-235), (2, B, g*g, g*g).  The
        reference passes full-resolution ``img_box`` coordinates into the
        patch-resolution map and relies on slice clamping; ``box_mask``
        reproduces that."""
        cfg = self.cfg
        small = image_ops.resize_bilinear(cams_aux, (grid, grid), batch_dims=2)
        masks = []
        for c in small:
            _, label = cam_ops.cam_to_label(
                c, cls_label, bkg_thre=cfg.bkg_thre, img_box=img_box,
                ignore_mid=True,
                high_thre=high_thre if dynamic else cfg.high_thre,
                low_thre=cfg.low_thre, ignore_index=cfg.ignore_index)
            masks.append(cam_ops.label_to_aff_mask(label, cfg.ignore_index))
        return torch.stack(masks)

    def _high_thresholds(self, step: int, cls_label: torch.Tensor):
        """(B,) per-sample high thresholds at the host's ``step``."""
        cfg = self.cfg
        vec = schedule_ops.cosine_descent(
            self.high_start, self.high_target, step - self.anneal_start,
            cfg.max_iters - self.anneal_start)
        return schedule_ops.per_sample_high_thre(vec, cls_label)

    @torch.no_grad()
    def _refine(self, cams, inputs_denorm, batch, high_thre):
        return refine(self.cfg, cams, inputs_denorm, batch["cls_label"],
                      batch["img_box"], high_thre,
                      fits_budget=batch.get("fits_budget"))

    @torch.no_grad()
    def _gmm_filter(self, segs, refined) -> torch.Tensor:
        """Per branch, the CE of the branch's own (detached) segs against
        its own refined labels drives the noise fit (voc:358-394)."""
        cfg, g = self.cfg, self.cfg.gmm
        return torch.stack([gmm_ops.gmm_filter_labels(
            loss_ops.cross_entropy_map(segs[k], refined[k], cfg.ignore_index),
            refined[k], num_iter=g.num_iter, reg_covar=g.reg_covar,
            loss_floor=g.loss_floor, min_pixels=g.min_pixels,
            valid_thre=g.valid_thre, gamma=g.gamma,
            ignore_index=cfg.ignore_index) for k in range(2)])

    # ------------------------------------------------------------------ phases
    @staticmethod
    def _common_losses(out: StudentOut, cls_label, aff_masks):
        """cls + ptc + sim, shared by all phases; ``out`` leaves are
        branch-stacked (2, B, ...)."""
        msm = loss_ops.multilabel_soft_margin_loss
        cls_loss = (msm(out.cls[0], cls_label) + msm(out.cls_aux[0], cls_label)
                    + msm(out.cls[1], cls_label)
                    + msm(out.cls_aux[1], cls_label))
        ptc_loss = (loss_ops.masked_ptc_loss(out.fmap[0], aff_masks[0])
                    + loss_ops.masked_ptc_loss(out.fmap[1], aff_masks[1]))
        sim_loss = (loss_ops.discrepancy_loss(out.fmap[0], out.fmap[1])
                    + loss_ops.discrepancy_loss(out.fmap[1], out.fmap[0]))
        return cls_loss, ptc_loss, sim_loss

    @staticmethod
    @torch.no_grad()
    def _train_f1(cls_logits, cls_label) -> torch.Tensor:
        """Train-time multilabel micro-F1 of branch 1 over the batch, on
        the device (the reference logs sklearn's F1 of sample 0)."""
        pred, true = cls_logits > 0, cls_label > 0
        tp = (pred & true).sum()
        fp = (pred & ~true).sum()
        fn = (~pred & true).sum()
        return 2 * tp / (2 * tp + fp + fn).clamp_min(1)

    @staticmethod
    def _metrics(total, out, cls_label, **terms) -> Dict[str, torch.Tensor]:
        zero = total.new_zeros(())
        m = {k: terms.get(k, zero).detach() for k in
             ("cls_loss", "ptc_loss", "seg_loss", "sim_loss", "reg_loss")}
        m["cls_score"] = Trainer._train_f1(out.cls[0], cls_label)
        m["loss"] = total.detach()
        return m

    def _loss_warmup(self, batch, w: LossWeights, step: int, aug_ops=None):
        """Phase 1: cls + ptc + sim (train_final_voc.py:194-258).  The
        decoder's output is unused, so its parameters get no gradient."""
        inputs, _ = image_ops.prepare_inputs(batch["image"])
        cls_label = batch["cls_label"]
        grid = inputs.shape[1] // self.cfg.model.patch_size
        _, cams_aux, out = self._cams_with_grad_out(inputs)
        self._mark("cam_and_forward")
        aff = self._ptc_targets(cams_aux, cls_label, batch["img_box"], grid,
                                high_thre=None, dynamic=False)
        self._mark("labels")
        cls_l, ptc_l, sim_l = self._common_losses(out, cls_label, aff)
        total = w.cls * cls_l + w.ptc * ptc_l + w.sim * sim_l
        return total, self._metrics(total, out, cls_label, cls_loss=cls_l,
                                    ptc_loss=ptc_l, sim_loss=sim_l)

    def _loss_seg(self, batch, w: LossWeights, step: int, aug_ops=None, *,
                  static_refine: bool):
        """Phase 2: + cross-supervised seg loss from PAR-refined labels
        (train_final_voc.py:260-356).  ``static_refine`` is the COCO window
        where refinement uses aux CAMs and static thresholds
        (train_final_coco.py:312-321)."""
        cfg = self.cfg
        inputs, inputs_denorm = image_ops.prepare_inputs(batch["image"])
        cls_label = batch["cls_label"]
        _, h, w_, _ = inputs.shape
        grid = h // cfg.model.patch_size
        high_b = self._high_thresholds(step, cls_label)
        cams, cams_aux, out = self._cams_with_grad_out(inputs)
        self._mark("cam_and_forward")
        aff = self._ptc_targets(cams_aux, cls_label, batch["img_box"], grid,
                                high_thre=high_b, dynamic=not static_refine)
        refined = self._refine(cams_aux if static_refine else cams,
                               inputs_denorm, batch,
                               cfg.high_thre if static_refine else high_b)
        self._mark("labels")
        cls_l, ptc_l, sim_l = self._common_losses(out, cls_label, aff)
        segs_up = image_ops.resize_bilinear(out.seg, (h, w_), batch_dims=2)
        # cross supervision: student k learns from the other's labels
        seg_l = (loss_ops.seg_loss(segs_up[0], refined[1], cfg.ignore_index)
                 + loss_ops.seg_loss(segs_up[1], refined[0], cfg.ignore_index))
        total = (w.cls * cls_l + w.ptc * ptc_l + w.seg * seg_l
                 + w.sim * sim_l)
        return total, self._metrics(total, out, cls_label, cls_loss=cls_l,
                                    ptc_loss=ptc_l, seg_loss=seg_l,
                                    sim_loss=sim_l)

    def _loss_full(self, batch, w: LossWeights, step: int, aug_ops=None):
        """Phase 3: + GMM noise filtering + strong-view consistency
        (train_final_voc.py:286-447)."""
        cfg = self.cfg
        inputs, inputs_denorm = image_ops.prepare_inputs(batch["image"])
        cls_label = batch["cls_label"]
        _, h, w_, _ = inputs.shape
        grid = h // cfg.model.patch_size
        with torch.no_grad():
            aug01 = augment_ops.strong_augment(inputs_denorm, aug_ops,
                                               cfg.aug_m)
            inputs_aug_small = image_ops.resize_bilinear(
                image_ops.normalize(aug01),
                (int(h * cfg.aug_downscale), int(w_ * cfg.aug_downscale)))
        self._mark("strong_view")
        high_b = self._high_thresholds(step, cls_label)
        cams, cams_aux, out = self._cams_with_grad_out(inputs)
        self._mark("cam_and_forward")
        aff = self._ptc_targets(cams_aux, cls_label, batch["img_box"], grid,
                                high_thre=high_b, dynamic=True)
        refined = self._refine(cams, inputs_denorm, batch, high_b)
        self._mark("labels")
        out_aug = self.model(inputs_aug_small)
        self._mark("strong_forward")
        cls_l, ptc_l, sim_l = self._common_losses(out, cls_label, aff)

        segs_up = image_ops.resize_bilinear(out.seg, (h, w_), batch_dims=2)
        segs_sg = segs_up.detach()
        filtered = self._gmm_filter(segs_sg, refined)
        seg_l = (loss_ops.seg_loss(segs_up[0], filtered[1], cfg.ignore_index)
                 + loss_ops.seg_loss(segs_up[1], filtered[0], cfg.ignore_index))

        # consistency: the strong view (trained) matches confident clean-view
        # predictions inside the other label's ignore region (voc:404-436)
        segs_aug = image_ops.resize_bilinear(out_aug.seg.flip(3), (h, w_),
                                             batch_dims=2)  # flipped back
        with torch.no_grad():
            m, pseudo = segs_sg.float().max(dim=-1)
            conf = torch.exp(m - torch.logsumexp(segs_sg.float(), dim=-1))
        reg_l = 0.0
        for k in range(2):
            uncertain = ((filtered[1 - k] == cfg.ignore_index)
                         & (conf[k] > cfg.reg_conf_thre))
            target = torch.where(uncertain, pseudo[k],
                                 torch.full_like(pseudo[k], cfg.ignore_index))
            ce = loss_ops.cross_entropy_map(segs_aug[k], target,
                                            cfg.ignore_index)
            cnt = uncertain.sum()
            reg_k = ce.sum() / cnt.clamp_min(1)
            reg_l = reg_l + torch.where(cnt > 0, reg_k, torch.zeros_like(reg_k))
        total = (w.cls * cls_l + w.ptc * ptc_l + w.seg * seg_l
                 + w.sim * sim_l + w.reg * reg_l)
        return total, self._metrics(total, out, cls_label, cls_loss=cls_l,
                                    ptc_loss=ptc_l, seg_loss=seg_l,
                                    sim_loss=sim_l, reg_loss=reg_l)

    @torch.no_grad()
    def full_phase_labels(self, batch, step: int):
        """Parity and debug hook: the phase-3 pseudo-labels before and
        after the GMM noise filter, as :meth:`_loss_full` computes them:
        ``(refined, filtered)``, each (2, B, H, W).  The noise mask is
        ``(filtered == ignore) & (refined != ignore)``."""
        batch = self.put(batch)
        inputs, inputs_denorm = image_ops.prepare_inputs(batch["image"])
        _, h, w_, _ = inputs.shape
        high_b = self._high_thresholds(step, batch["cls_label"])
        cams, _, out = self._cams_with_grad_out(inputs)
        refined = self._refine(cams, inputs_denorm, batch, high_b)
        segs_up = image_ops.resize_bilinear(out.seg, (h, w_), batch_dims=2)
        return refined, self._gmm_filter(segs_up, refined)

    # ------------------------------------------------------------------ public
    def grad_step(self, state: TrainState, batch, step: Optional[int] = None,
                  aug_ops: Optional[torch.Tensor] = None
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Phase-dispatched (grads, metrics) without applying an update:
        ``loss.backward()`` into the parameters' ``.grad`` (cleared first),
        returned by parameter name; a parameter outside the phase's graph
        (the decoder in warm-up) has no entry.  ``aug_ops``: the strong
        view's (aug_n, B) op indices; drawn from ``state.rng`` when None."""
        step = state.step if step is None else step
        batch = self.put(batch)
        phase = phase_of(self.cfg, step)
        if phase == "full" and aug_ops is None:
            aug_ops = augment_ops.draw_ops(
                state.rng, self.cfg.aug_n, batch["image"].shape[0],
                device=self.device)
        loss_fn = {
            "warmup": self._loss_warmup,
            "seg_static": functools.partial(self._loss_seg, static_refine=True),
            "seg": functools.partial(self._loss_seg, static_refine=False),
            "full": self._loss_full,
        }[phase]
        state.optimizer.zero_grad(set_to_none=True)
        total, metrics = loss_fn(batch, loss_weights(self.cfg, step), step,
                                 aug_ops)
        self._mark("losses")
        total.backward()
        self._mark("backward")
        grads = {n: p.grad for n, p in state.model.named_parameters()
                 if p.grad is not None}
        return grads, metrics

    def train_step(self, state: TrainState, batch, step: Optional[int] = None,
                   aug_ops: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step in the phase of ``step`` (default: the
        state's own count).  Updates ``state`` in place and returns it with
        the step's metrics (0-d tensors on the device; reading one waits
        for the step)."""
        _, metrics = self.grad_step(state, batch, step, aug_ops)
        state.optimizer.step()
        self._mark("optimizer")
        state.step += 1
        return state, metrics
