"""Offline segmentation evaluation: multi-scale + flip inference, branch
selection, CRF post-processing (counterpart of ``dupl_tpu/engine/eval_seg.py``;
reference: tools/eval_seg_voc.py, tools/eval_seg_coco_ddp.py).

Reference semantics preserved: per scale the batch is concatenated with its
horizontal flip, seg logits are upsampled and flip-summed; scales are
max-merged (VOC, eval_seg_voc.py:76-77) or sum-merged (COCO,
eval_seg_coco_ddp.py:120-121); the better branch by raw mIoU is selected
(eval_seg_voc.py:185-188) and CRF-refined.

Two input modes.  ``native`` (the VOC protocol) feeds each image at its own
resolution, bucketed by shape so same-shape images batch together; logits
come out at the label's resolution, so the argmax runs on the device and
only uint8 labels are copied to the host.  ``fixed`` (the COCO protocol)
resizes every image to the crop size; merged fp32 logits are copied to the
host and bilinear-resized to each label's size there, in PIL, exactly where
the reference resizes (eval_seg_voc.py:126-128).  The CRF runs on the device
(batched mean-field) or through the native permutohedral oracle at native
resolution.  The token count follows the image: one run may send some
buckets through the max-free attention kernel and others, from 2048 tokens,
through the flash kernel (``ops/attention.py``).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dupl_tpu_torch.ops import crf as crf_ops
from dupl_tpu_torch.ops import image as image_ops
from dupl_tpu_torch.ops.image import resize_bilinear
from dupl_tpu_torch.utils import colormap
from dupl_tpu_torch.utils import metrics as metrics_utils
from dupl_tpu_torch.utils.metrics import add_hist, resize_logits_host


def msc_seg_logits(seg_fn: Callable[[torch.Tensor], torch.Tensor],
                   x: torch.Tensor, out_size, scales: Sequence[float],
                   merge: str = "max", batch_dims: int = 1) -> torch.Tensor:
    """``seg_fn`` maps an NHWC batch to (..., B, h, w, C) seg logits; leading
    axes before the batch (the dual-student branch axis) ride along, and
    ``batch_dims`` counts the output's axes up to and including the batch.
    Per scale the batch rides with its horizontal flip; logits are resized
    to ``out_size`` and flip-summed; scales merge by max or sum."""
    b, hh, ww, _ = x.shape
    merged = None
    for sc in scales:
        size = (int(hh * sc), int(ww * sc))
        xs = x if sc == 1.0 else resize_bilinear(x, size)
        both = torch.cat([xs, xs.flip(2)], dim=0)
        seg = resize_bilinear(seg_fn(both), tuple(out_size),
                              batch_dims=batch_dims)
        seg = seg[..., :b, :, :, :] + seg[..., b:, :, :, :].flip(-2)
        if merged is None:
            merged = seg
        elif merge == "max":
            merged = torch.maximum(merged, seg)
        else:
            merged = merged + seg
    return merged


def resolve_input_mode(dataset: str, requested: "str | None",
                       log=None) -> str:
    """CLI guard for ``tools/eval_seg_torch.py --input-mode``.

    Defaults follow each reference script's own protocol: VOC evaluates at
    native resolution (tools/eval_seg_voc.py:56-60), COCO at the fixed crop
    (eval_seg_coco_ddp.py:96).  Explicitly forcing ``fixed`` on VOC is
    honored but warned about: it is not the reference VOC protocol."""
    if requested is None:
        return "native" if dataset == "voc" else "fixed"
    if dataset == "voc" and requested == "fixed":
        msg = ("--input-mode fixed on VOC is not the reference protocol "
               "(eval_seg_voc.py evaluates at native resolution); use "
               "--input-mode native (the default)")
        if log is not None:
            log.warning(msg)
        else:
            import warnings
            warnings.warn(msg)
    return requested


def _pad_edge(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, ph, pw, C), the last row and column repeated."""
    h, w = x.shape[1:3]
    if (ph, pw) == (h, w):
        return x
    y = F.pad(x.permute(0, 3, 1, 2), (0, pw - w, 0, ph - h), mode="replicate")
    return y.permute(0, 2, 3, 1)


class SegEvaluator:
    def __init__(self, cfg, model, scales: Sequence[float] = (1.0, 1.5, 1.25),
                 merge: str = "max", input_mode: str = "fixed",
                 merge_at: str = "input"):
        """``model``: a ``DualStudent`` holding the weights, on the device
        the evaluation runs on.

        ``input_mode``: 'fixed' resizes every image to the crop size (the
        reference's COCO eval); 'native' feeds each image at its original
        resolution like the reference's VOC eval (eval_seg_voc.py:56-60).

        ``merge_at``: 'input' merges scales at the model-input resolution
        (the reference VOC protocol, whose label-native input makes this the
        label resolution); 'decoder' merges at the scale-1.0 decoder
        resolution, exactly the reference COCO protocol
        (eval_seg_coco_ddp.py:93-121: other scales' segs are resized down to
        the scale-1.0 seg size before the sum, and only the merged map is
        resized to the label), and a 16 x 16-fold smaller copy to the
        host."""
        self.cfg = cfg
        self.model = model
        self.scales = tuple(scales)
        self.merge = merge
        self.input_mode = input_mode
        if input_mode == "native" and merge_at == "decoder":
            raise ValueError("merge_at='decoder' applies to fixed-input mode")
        self.merge_at = merge_at

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def msc_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 or normalised float batch on the device ->
        (2, B, *out, C) merged logits of both students; the output
        resolution is the input's, or the scale-1.0 decoder grid under
        ``merge_at='decoder'``.  The branch axis rides through
        ``msc_seg_logits`` as a leading axis."""
        patch = self.model.cfg.patch_size
        x, _ = image_ops.prepare_inputs(x)
        hh, ww = x.shape[1:3]
        out = ((hh // patch, ww // patch) if self.merge_at == "decoder"
               else (hh, ww))
        return msc_seg_logits(lambda both: self.model(both).seg, x, out,
                              self.scales, self.merge, batch_dims=2)

    def _chunks(self, dataset, indices: List[int], batch_size: int):
        """Lists of dataset indices, one per device batch."""
        if self.input_mode != "native":
            return [indices[lo:lo + batch_size]
                    for lo in range(0, len(indices), batch_size)]
        # Shape bucketing: same-shape images batch together (VOC val is
        # dominated by a handful of shapes, e.g. 500 x 375 / 375 x 500).
        # Shapes come from the JPEG headers, no pixel decode.  Order
        # changes, scores don't (they are hist-accumulated).  Batch 1 when
        # the dataset cannot report sizes cheaply.
        if not hasattr(dataset, "image_size"):
            return [[i] for i in indices]
        by_shape: Dict[tuple, List[int]] = {}
        for i in indices:
            by_shape.setdefault(tuple(dataset.image_size(i)), []).append(i)
        return [grp[lo:lo + batch_size] for grp in by_shape.values()
                for lo in range(0, len(grp), batch_size)]

    def _batches(self, dataset, chunks):
        """(images done before, samples, image batch on the device)."""
        dev = self.device
        base = self.cfg.data.crop_size
        lo = 0
        for chunk in chunks:
            samples = [dataset[i] for i in chunk]
            if self.input_mode == "native":
                # same-shape bucket: one stack, one copy; msc_logits
                # normalises (uint8 wire format or float)
                imgs = torch.from_numpy(
                    np.stack([s["image"] for s in samples])).to(dev)
            else:
                # torch.tensor copies: PIL-backed arrays are read-only
                imgs = torch.cat([resize_bilinear(image_ops.prepare_inputs(
                    torch.tensor(s["image"], device=dev)[None])[0],
                    (base, base)) for s in samples])
            yield lo, samples, imgs
            lo += len(chunk)

    @torch.inference_mode()
    def run(self, dataset, *, batch_size: int = 8, crf: str = "device",
            out_dir: Optional[str] = None, max_images: Optional[int] = None,
            log=None, shard: int = 0, num_shards: int = 1,
            ensemble: bool = False,
            branch: Optional[int] = None) -> Dict[str, object]:
        """Evaluate; returns per-branch raw scores, the selected branch, CRF
        scores, the raw confusion matrices (``hist_1``/``hist_2``/
        ``crf_hist``) so sharded runs can be merged into the reference's
        single global metric, and ``crf_branch``: the branch whose logits
        the CRF pass refined (0 for the ensemble), which
        :func:`merge_shard_results` needs to tell whether ``crf_hist`` of
        several shards may be summed.  ``shard``/``num_shards`` stride the
        dataset like the reference's DDP eval split
        (eval_seg_coco_ddp.py:240-242); the reference gathers histograms
        across ranks before its branch pick, so a multi-shard run should
        force ``branch`` (after a cross-shard pick via
        :func:`merge_shard_results`) or use ``ensemble``.

        ``ensemble=True`` averages the two students' logits for the CRF pass
        instead of picking the better branch.  ``branch`` forces the CRF
        branch (1 or 2) regardless of this shard's local scores."""
        cfg = self.cfg
        nc = cfg.num_classes
        base = cfg.data.crop_size
        native = self.input_mode == "native"

        indices = list(range(len(dataset)))[shard::num_shards]
        if max_images is not None:
            indices = indices[:max_images]
        chunks = self._chunks(dataset, indices, batch_size)

        # ---- pass 1: raw mIoU per branch (nothing stored: streaming) -------
        hists = {1: np.zeros((nc, nc), np.float64),
                 2: np.zeros((nc, nc), np.float64)}
        for n_batches, (lo, samples, imgs) in enumerate(
                self._batches(dataset, chunks)):
            dev_logits = self.msc_logits(imgs)                 # (2, B, h, w, C)
            if native:
                # logits are already at the label's resolution: argmax on
                # the device and copy uint8 labels, the batch's one
                # synchronous copy
                labels_b = dev_logits.argmax(dim=-1).to(torch.uint8).cpu().numpy()
                for bi, s in enumerate(samples):
                    for k in (1, 2):
                        add_hist(hists[k], s["label"], labels_b[k - 1, bi])
            else:
                logits = dev_logits.float().cpu().numpy()
                for bi, s in enumerate(samples):
                    size = s["label"].shape
                    for k in (1, 2):
                        up = resize_logits_host(logits[k - 1, bi], size)
                        add_hist(hists[k], s["label"], up.argmax(-1))
            if log and n_batches % 10 == 0:
                log.info("eval %d/%d", lo + len(samples), len(indices))

        scores = {k: metrics_utils.scores_from_hist(hists[k]) for k in (1, 2)}
        # reference tie-break: branch 1 only if strictly better
        # (eval_seg_voc.py:185-188, eval_seg_coco_ddp.py:251-254)
        best = branch or (1 if scores[1]["miou"] > scores[2]["miou"] else 2)
        result: Dict[str, object] = {
            "seg_score_1": scores[1], "seg_score_2": scores[2], "branch": best,
            "hist_1": hists[1], "hist_2": hists[2],
        }
        if log:
            log.info("branch1 mIoU %.3f | branch2 mIoU %.3f -> branch %d%s",
                     100 * scores[1]["miou"], 100 * scores[2]["miou"], best,
                     " (forced)" if branch else "")
        if crf == "none":
            return result

        if out_dir:
            os.makedirs(os.path.join(out_dir, "seg_preds"), exist_ok=True)
            os.makedirs(os.path.join(out_dir, "seg_preds_rgb"), exist_ok=True)

        # ---- pass 2: recompute the chosen branch's logits and CRF each batch
        # immediately (bounded memory at any dataset size) ---------------------
        crf_hist = np.zeros((nc, nc), np.float64)
        dev = self.device
        pool = None
        if crf == "native":
            from dupl_tpu_torch.ops.crf_native import DenseCRF, default_workers
            post = DenseCRF.from_config(cfg.crf)
            pool = ThreadPoolExecutor(default_workers())

        def record(s, pred):
            add_hist(crf_hist, s["label"], pred)
            self._write_pred(out_dir, s["name"], pred)

        try:  # the pool must not leak worker threads if the loop raises
            for lo, samples, imgs in self._batches(dataset, chunks):
                dev_logits = self.msc_logits(imgs)             # (2, B, h, w, C)
                pick = (dev_logits.mean(dim=0) if ensemble
                        else dev_logits[best - 1])             # (B, h, w, C)
                if crf == "device" and native:
                    # whole chain on the device; only uint8 labels leave it.
                    # The CRF wants sizes that its pivot cells divide: pad
                    # to multiples of 8 by repeating the edge.
                    lh, lw = pick.shape[1:3]
                    ph, pw = -(-lh // 8) * 8, -(-lw // 8) * 8
                    probs = torch.softmax(_pad_edge(pick.float(), ph, pw), -1)
                    # raw images ride up as uint8 (4x fewer bytes)
                    raw = torch.from_numpy(np.stack(
                        [s["raw_image"] for s in samples])).to(dev)
                    imgs01 = _pad_edge(raw.float() / 255.0, ph, pw)
                    refined = crf_ops.crf_from_config(imgs01, probs, cfg.crf)
                    preds = refined[:, :lh, :lw].argmax(dim=-1).to(
                        torch.uint8).cpu().numpy()
                    for bi, s in enumerate(samples):
                        record(s, preds[bi])
                elif crf == "device":
                    pick = pick.float()
                    if self.merge_at == "decoder":  # the CRF wants image res
                        pick = resize_bilinear(pick, (base, base))
                    probs = torch.softmax(pick, dim=-1)
                    imgs01 = torch.cat([resize_bilinear(
                        torch.tensor(s["raw_image"], device=dev).float()[None]
                        / 255.0, (base, base)) for s in samples])
                    refined = crf_ops.crf_from_config(
                        imgs01, probs, cfg.crf).cpu().numpy()
                    for bi, s in enumerate(samples):
                        record(s, resize_logits_host(
                            refined[bi], s["label"].shape).argmax(-1))
                else:  # native permutohedral at native res (reference-exact)
                    logits = pick.float().cpu().numpy()

                    def job(arg):
                        s, lg = arg
                        up = resize_logits_host(lg, s["label"].shape)
                        prob = np.exp(up - up.max(-1, keepdims=True))
                        prob /= prob.sum(-1, keepdims=True)
                        out = post(s["raw_image"], prob.transpose(2, 0, 1))
                        return s, out.argmax(0)

                    for s, pred in pool.map(job, zip(samples, logits)):
                        record(s, pred)
        finally:
            if pool is not None:
                pool.shutdown()
        result["crf_score"] = metrics_utils.scores_from_hist(crf_hist)
        result["crf_hist"] = crf_hist
        result["crf_branch"] = 0 if ensemble else best
        if log:
            log.info("CRF mIoU %.3f", 100 * result["crf_score"]["miou"])
        return result

    @staticmethod
    def _write_pred(out_dir, name, pred):
        if not out_dir:
            return
        from PIL import Image
        Image.fromarray(pred.astype(np.uint8)).save(
            os.path.join(out_dir, "seg_preds", name + ".png"))
        Image.fromarray(colormap.encode_cmap(pred)).save(
            os.path.join(out_dir, "seg_preds_rgb", name + ".png"))


def merge_shard_results(results) -> Dict[str, object]:
    """Combine per-shard :meth:`SegEvaluator.run` results into the reference
    protocol's single global metric.

    The reference DDP eval gathers histograms across ranks and then picks
    the better branch once (eval_seg_coco_ddp.py:244-254); summing the
    per-shard confusion matrices here is numerically identical to the
    single-process run over the whole split.  Accepts result dicts (or
    anything mapping with ``hist_1``/``hist_2`` and optional ``crf_hist``
    with its ``crf_branch``).

    ``crf_hist`` counts the CRF of one branch's logits (or of the
    ensemble's), and each shard picks its branch from its own images unless
    told otherwise.  Histograms of different branches are not one metric, so
    shards whose ``crf_branch`` differ (or is missing) raise: run the CRF
    pass again with the merged pick forced (``branch=``), or with
    ``ensemble``."""
    results = list(results)
    h1 = sum(np.asarray(r["hist_1"], np.float64) for r in results)
    h2 = sum(np.asarray(r["hist_2"], np.float64) for r in results)
    scores = {1: metrics_utils.scores_from_hist(h1),
              2: metrics_utils.scores_from_hist(h2)}
    best = 1 if scores[1]["miou"] > scores[2]["miou"] else 2
    merged: Dict[str, object] = {
        "seg_score_1": scores[1], "seg_score_2": scores[2], "branch": best,
        "hist_1": h1, "hist_2": h2,
    }
    with_crf = [r for r in results if r.get("crf_hist") is not None]
    if with_crf:
        picks = [None if r.get("crf_branch") is None else int(r["crf_branch"])
                 for r in with_crf]
        if None in picks or len(set(picks)) != 1:
            raise ValueError(
                f"merge_shard_results: the shards' CRF passes refined "
                f"different branches (crf_branch {picks}; 0 is the ensemble, "
                f"None unknown): their crf_hist are not one metric.  The "
                f"merged raw scores pick branch {best}; rerun each shard's "
                f"CRF pass with branch={best}, or with ensemble=True")
        ch = sum(np.asarray(r["crf_hist"], np.float64) for r in with_crf)
        merged["crf_hist"] = ch
        merged["crf_score"] = metrics_utils.scores_from_hist(ch)
        merged["crf_branch"] = picks[0]
    return merged
