"""Piece-by-piece timing of the headline pseudo-label pipeline
(``bench_torch.py``) on one card: the counterpart of
``tools/bench_components.py``.

    python tools/bench_components_torch.py [--batch 16] [--iters 5]
        [--dataset voc|coco] [--density realistic|dense] [--device cuda]

Builds ``config.bench_config(dataset)`` (VOC: 21 classes, class budget 10;
COCO: 81 classes, budget 16; tanh GELU, bf16 stream, bf16 PAR) with weights
from seed 0 and ``synthetic_batch(batch, crop=448, num_fg=classes - 1)``.
Each piece is timed on its own as the minimum over ``--iters`` calls after
one warm-up, each call followed by a ``torch.cuda.synchronize()``:

* ``cam_fwd_scale<s>``: both students' ``cam_only`` on the batch and its
  flip at each CAM scale, with the JAX tool's TFLOPS estimate;
* ``multi_scale_cam_full``: both students' multi-scale CAMs with outputs;
* ``par_refine``: ``Trainer._refine`` of those CAMs (K3, K4);
* ``par_affinity`` (K3) at (B, 224, 224) and ``par_propagate`` (K4) at
  (B, 224, 224, 4 x budget) x 10 rounds, alone;
* ``crf_fast``: student 1's seg logits resized, soft-maxed, fast CRF (K5);
* ``pipeline``: the whole pipeline with ``crf_labels_from_config(fast=True,
  class_budget=32 when there are more than 32 classes)``, beside the sum
  of the three components above;
* ``eval_protocol``: ``engine/eval_seg.msc_seg_logits`` of both students
  (VOC: max merge at the input size, scales 1.0 / 1.5 / 1.25; COCO: sum
  merge on the decoder grid, scales 1.0 / 1.25 / 1.5, then resized), then
  the CRF labels.

``--density dense`` gives every image 20 present classes, drawn as the JAX
tool draws them; at COCO width that overruns the class budget of 16 and
PAR takes the full class axis (K4 at C 324).  ``--int8`` sets
``quantized_inference`` (the JAX tool's flag): every block's four products
run w8a8 (``ops/quant.py``: kernels Q1 and Q2 on the card), the same rows
are timed.  Prints the card's name and power limit, one row a
piece and last a JSON line of the JAX tool's ``report`` keys (seconds; the
per-scale entries ``[seconds, TFLOPS]``) plus ``par_affinity`` and
``par_propagate``.  ``--device cpu`` runs the plain twins, a functional
check; ``--backbone`` and ``--crop`` exist for it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dense_labels(batch: int, num_fg: int):
    """20 present classes an image, drawn from ``RandomState(1)`` as
    ``tools/bench_components.py:81-87`` draws them."""
    import numpy as np

    rs = np.random.RandomState(1)
    dense = np.zeros((batch, num_fg), np.float32)
    for i in range(batch):
        dense[i, rs.choice(num_fg, size=20, replace=False)] = 1
    return dense


def pipeline(trainer, batch, crf_budget):
    """``bench_torch.py``'s pipeline with the JAX tool's CRF step:
    ``crf_labels_from_config(fast=True, class_budget=crf_budget)``.
    Returns ``(refined (2, B, H, W), labels (B, H, W))``."""
    import bench_torch
    from dupl_tpu_torch.ops import crf as crf_ops

    refined, denorm, probs = bench_torch.refine_and_probs(trainer, batch)
    return refined, crf_ops.crf_labels_from_config(
        denorm, probs, trainer.cfg.crf, fast=True, class_budget=crf_budget)


def eval_protocol(trainer, inputs, dataset: str, crf_budget):
    """The offline evaluation protocol of the JAX tool: both students' 3
    scales x flip seg logits, VOC max-merged at the input size, COCO
    summed on the decoder grid and then resized; the CRF labels of student
    1's.  Returns ``(segs (2, B, ...), labels (B, H, W))``."""
    import torch

    from dupl_tpu_torch.engine.eval_seg import msc_seg_logits
    from dupl_tpu_torch.ops import crf as crf_ops
    from dupl_tpu_torch.ops import image as image_ops

    cfg, model = trainer.cfg, trainer.model
    size = inputs.shape[1:3]
    if dataset == "voc":
        merge, scales, out = "max", (1.0, 1.5, 1.25), size
    else:
        patch = cfg.model.patch_size
        merge, scales = "sum", (1.0, 1.25, 1.5)
        out = (size[0] // patch, size[1] // patch)
    segs = msc_seg_logits(lambda both: model(both).seg, inputs, out, scales,
                          merge, batch_dims=2)
    pick = segs[0]
    if pick.shape[1:3] != size:          # decoder-grid merge -> CRF size
        pick = image_ops.resize_bilinear(pick, size)
    probs = torch.softmax(pick, dim=-1)
    labels = crf_ops.crf_labels_from_config(
        image_ops.denormalize(inputs), probs, cfg.crf, fast=True,
        class_budget=crf_budget)
    return segs, labels


def run(argv=None) -> dict:
    """The measurement; returns the report.  Raises without the card it
    is asked for."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--int8", action="store_true",
                    help="dynamic-int8 GEMMs (ModelConfig.quantized_inference)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--dataset", choices=["voc", "coco"], default="voc")
    ap.add_argument("--density", choices=["realistic", "dense"],
                    default="realistic",
                    help="realistic: ~3 present classes an image; dense: "
                         "20, past COCO's class budget of 16")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backbone", default="deit_base_patch16")
    ap.add_argument("--crop", type=int, default=448)
    args = ap.parse_args(argv)

    import torch

    import bench_torch
    from dupl_tpu_torch.config import bench_config
    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.models.vit import VIT_CONFIGS
    from dupl_tpu_torch.ops import crf as crf_ops
    from dupl_tpu_torch.ops import image as image_ops
    from dupl_tpu_torch.ops import par_cuda
    from dupl_tpu_torch.utils.device import cli_device
    from dupl_tpu_torch.utils.timing import card_line

    device = cli_device(args.device)
    print(card_line(device), flush=True)
    cfg = bench_config(args.dataset, backbone=args.backbone,
                       quantized_inference=args.int8)
    nc, b, crop = cfg.model.num_classes, args.batch, args.crop
    crf_budget = 32 if nc > 32 else None
    trainer = bench_torch.build(cfg, 0, device)
    arrays = synthetic_batch(b, crop=crop, num_fg=nc - 1)
    if args.density == "dense":
        arrays["cls_label"] = dense_labels(b, nc - 1)
    batch = trainer.put(arrays)
    inputs = batch["image"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timeit(fn, *fargs):
        fn(*fargs)
        sync()
        best = float("inf")
        for _ in range(args.iters):
            t0 = time.perf_counter()
            fn(*fargs)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    report = {}
    spec = VIT_CONFIGS[cfg.model.backbone]
    d, depth, patch = spec.embed_dim, spec.depth, cfg.model.patch_size
    with torch.inference_mode():
        for s in cfg.cam_scales:
            hw = int(crop * s)
            x = (image_ops.resize_bilinear(inputs, (hw, hw)) if s != 1.0
                 else inputs)
            both = torch.cat([x, x.flip(2)], dim=0)
            dt = timeit(trainer.model.cam_only, both)
            n_tok = (hw // patch) ** 2 + 1
            # the JAX tool's estimate: 2 branches x seqs x 2 FLOPs a MAC x
            # blocks x (12 N D^2 matmul + 2 N^2 D attention MACs)
            flops = (2 * both.shape[0] * 2 * depth
                     * (12 * n_tok * d * d + 2 * n_tok * n_tok * d))
            report[f"cam_fwd_scale{s}"] = (dt, flops / dt / 1e12)
            print(f"cam_only scale={s} ({hw}px, {n_tok} tok, 2x"
                  f"{both.shape[0]} seqs): {dt * 1e3:.1f} ms  "
                  f"~{flops / dt / 1e12:.1f} TFLOPS", flush=True)

        dt = timeit(bench_torch.msc_cams, trainer, inputs)
        report["multi_scale_cam_full"] = dt
        print(f"multi_scale_cam_with_outputs (3 scales x flip x 2 branches): "
              f"{dt * 1e3:.1f} ms", flush=True)
        cams, seg = bench_torch.msc_cams(trainer, inputs)

        denorm = image_ops.denormalize(inputs)
        dt = timeit(trainer._refine, cams, denorm, batch, cfg.high_thre)
        report["par_refine"] = dt
        print(f"PAR refine (2 branches, 2 planes): {dt * 1e3:.1f} ms",
              flush=True)

        # PAR alone at the refine size: one call for the batch, both
        # branches' two planes on the compacted class axis
        par = cfg.par
        hs = crop // par.down_scale
        ch = 4 * par.class_budget
        img_small = torch.zeros(b, hs, hs, 3, device=device)
        masks = torch.zeros(b, hs, hs, ch, device=device)
        dt = timeit(par_cuda.affinity, img_small, par.dilations, par.w1,
                    par.w2)
        report["par_affinity"] = dt
        print(f"  par affinity ({b},{hs},{hs}): {dt * 1e3:.1f} ms", flush=True)
        aff = par_cuda.affinity(img_small, par.dilations, par.w1, par.w2)
        dt = timeit(par_cuda.propagate, masks, aff, par.dilations,
                    par.num_iter, par.compute_dtype)
        report["par_propagate"] = dt
        print(f"  par propagate ({b},{hs},{hs},{ch}) x{par.num_iter}: "
              f"{dt * 1e3:.1f} ms", flush=True)
        del img_small, masks, aff

        def crf(denorm, seg):
            return crf_ops.crf_from_config(
                denorm, bench_torch.seg_probs(seg, (crop, crop)), cfg.crf,
                fast=True, return_logits=True)

        dt = timeit(crf, denorm, seg)
        report["crf_fast"] = dt
        print(f"CRF fast (batch {b}): {dt * 1e3:.1f} ms", flush=True)
        del cams, seg

        dt = timeit(pipeline, trainer, batch, crf_budget)
        report["pipeline"] = dt
        print(f"end-to-end pipeline: {dt * 1e3:.1f} ms -> {b / dt:.2f} img/s "
              f"({b / dt / bench_torch.REFERENCE_IMG_PER_S:.2f}x baseline)",
              flush=True)
        comp_sum = (report["multi_scale_cam_full"] + report["par_refine"]
                    + report["crf_fast"])
        print(f"(component sum {comp_sum * 1e3:.1f} ms; fusion/dispatch delta "
              f"{(dt - comp_sum) * 1e3:+.1f} ms)", flush=True)

        dt = timeit(eval_protocol, trainer, inputs, args.dataset, crf_budget)
        report["eval_protocol"] = dt
        print(f"eval protocol (3 scales x flip x 2 branches + CRF): "
              f"{dt * 1e3:.1f} ms -> {b / dt:.2f} img/s", flush=True)
    print(json.dumps(report), flush=True)
    return report


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
