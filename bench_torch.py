"""Headline benchmark of the PyTorch port: CAM + PAR + CRF pseudo-label
inference on the ViT-B/16 dual student (the counterpart of ``bench.py``).

    python3 bench_torch.py [--style blob|photo] [--seed 0] [--device cuda]
                           [--backbone NAME] [--crop 448] [--batch 16]

Builds ``bench.py``'s configuration (``config.bench_config("voc")``: tanh
GELU, a bf16 residual stream, PAR in bf16 on a class budget of 10) with
weights drawn from ``--seed``, takes ``synthetic_batch(16, crop=448,
style)`` and runs :func:`cam_par_pipeline`: the multi-scale + flip CAMs of
both students merged at half the input size, PAR refinement into
pseudo-labels (K3, K4), student 1's segmentation posteriors and the fast
mean-field CRF (K5), then the argmax.  On the same inputs it gives what
``engine/export.py:make_pseudo_label_fn`` gives.

Protocol (``bench.py``'s): one warm-up call, one untimed call under
``utils/flops.count_flops`` (the model FLOPs, each kernel by its op's flop
formula), then 3 windows of 10 calls queued back to back with one
``torch.cuda.synchronize()`` each; the best window gives img/s = batch * 10
/ wall and ``mfu`` = FLOPs a call * 10 / wall / the card's dense bf16 peak.
Whether the batch fits PAR's class budget is read once from the host's copy
of the labels (as ``Trainer.put`` does), so no call waits on the device.

Prints the card's name and power limit on stderr and ONE JSON line on
stdout: ``metric`` (``cam_par_crf_inference_voc_vitb``, ``_photo`` appended
for the photo style), ``value`` (img/s), ``unit``, ``vs_baseline`` and,
where the card's peak is known (``utils/flops.py``), ``mfu`` and
``tflops_per_img``.  Without a card (``--device cuda``, the default) it
prints the line with ``value`` null and an ``error`` and exits 1; there is
no CPU fallback.  ``--device cpu`` runs the plain twins, a functional check
whose times say nothing; ``--backbone``, ``--crop`` and ``--batch`` exist
for it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

# The reference's CAM-path validation: 1,449 VOC val images in ~9.3 min on
# an RTX 3090 (BASELINE.md), the figure bench.py's vs_baseline divides by.
REFERENCE_IMG_PER_S = 2.6
METRIC = "cam_par_crf_inference_voc_vitb"
WINDOWS, CALLS = 3, 10


def build(cfg, seed: int, device):
    """A ``Trainer`` (PAR refinement, the device) around the dual student
    of ``cfg`` with weights drawn from ``seed``, on ``device``."""
    import torch

    from dupl_tpu_torch.engine.train import Trainer
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent

    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(device).eval()
    return Trainer(cfg, model=model, device=device)


def msc_cams(trainer, inputs):
    """Both students' multi-scale + flip CAMs at ``cfg.cam_scales``,
    merged at half the input size, and their scale-1.0 head outputs:
    ``(cams (2, B, H/2, W/2, C_fg), seg (2, B, h, w, C))``."""
    import torch

    from dupl_tpu_torch.ops import cam as cam_ops

    cfg = trainer.cfg
    merge = (inputs.shape[1] // 2, inputs.shape[2] // 2)
    cams, segs = [], []
    for i in range(2):          # bench.py vmaps the branches
        s = trainer.model.student(i)
        cam, _, out = cam_ops.multi_scale_cam_with_outputs(
            s.forward_with_cams, s.cam_only, inputs, cfg.cam_scales,
            with_aux=False, merge_size=merge)
        cams.append(cam)
        segs.append(out.seg)
    return torch.stack(cams), torch.stack(segs)


def seg_probs(seg, size):
    """Student 1's segmentation logits at ``size``, soft-maxed."""
    import torch

    from dupl_tpu_torch.ops import image as image_ops

    return torch.softmax(image_ops.resize_bilinear(seg[0], size), dim=-1)


def refine_and_probs(trainer, batch):
    """The pipeline up to its CRF: ``(refined (2, B, H, W), image01 (B, H,
    W, 3), probs (B, H, W, C))``, the PAR-refined pseudo-labels of both
    students, the de-normalised images and student 1's segmentation
    posteriors at the input size."""
    from dupl_tpu_torch.ops import image as image_ops

    inputs = batch["image"]
    cams, seg = msc_cams(trainer, inputs)
    denorm = image_ops.denormalize(inputs)
    refined = trainer._refine(cams, denorm, batch, trainer.cfg.high_thre)
    return refined, denorm, seg_probs(seg, inputs.shape[1:3])


def cam_par_pipeline(trainer, batch):
    """``bench.py:cam_par_pipeline``: ``(refined (2, B, H, W), labels (B,
    H, W))``, the labels being the argmax of the fast CRF's logits.
    ``batch``: ``Trainer.put`` of the images, class labels and boxes."""
    from dupl_tpu_torch.ops import crf as crf_ops

    refined, denorm, probs = refine_and_probs(trainer, batch)
    logits = crf_ops.crf_from_config(denorm, probs, trainer.cfg.crf,
                                     fast=True, return_logits=True)
    return refined, logits.argmax(dim=-1)


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--style", default="blob", choices=["blob", "photo"],
                    help="synthetic scenes: blobs (the headline) or 1/f "
                         "textures with JPEG noise")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backbone", default="deit_base_patch16")
    ap.add_argument("--crop", type=int, default=448)
    ap.add_argument("--batch", type=int, default=16)
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """The benchmark; returns its line.  Raises without the card it is
    asked for."""
    args = _args(argv)

    import torch

    from dupl_tpu_torch.config import bench_config
    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.utils import flops as flops_utils
    from dupl_tpu_torch.utils.timing import card_line

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: bench_torch runs on the card "
                           "(--device cpu for a functional run)")
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(card_line(device), file=sys.stderr, flush=True)

    cfg = bench_config("voc", backbone=args.backbone)
    trainer = build(cfg, args.seed, device)
    batch = trainer.put(synthetic_batch(args.batch, crop=args.crop,
                                        style=args.style))

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    with torch.inference_mode():
        cam_par_pipeline(trainer, batch)                # warm-up
        sync()
        flops_per_call = flops_utils.count_flops(cam_par_pipeline, trainer,
                                                 batch)
        sync()
        wall = float("inf")
        for _ in range(WINDOWS):
            t0 = time.perf_counter()
            outs = [cam_par_pipeline(trainer, batch) for _ in range(CALLS)]
            sync()
            wall = min(wall, time.perf_counter() - t0)
            del outs
    img_per_s = args.batch * CALLS / wall
    util = flops_utils.mfu(flops_per_call, CALLS, wall, device)
    line = {"metric": METRIC + ("_photo" if args.style == "photo" else ""),
            "value": round(img_per_s, 2), "unit": "img/s",
            "vs_baseline": round(img_per_s / REFERENCE_IMG_PER_S, 2)}
    if util is not None:
        line["mfu"] = round(util, 4)
        line["tflops_per_img"] = round(flops_per_call / 1e12 / args.batch, 2)
    return line


def main(argv=None) -> int:
    style = _args(argv).style
    try:
        line = run(argv)
    except Exception as exc:    # stdout keeps one parseable line
        traceback.print_exc()
        print(json.dumps({
            "metric": METRIC + ("_photo" if style == "photo" else ""),
            "value": None, "unit": "img/s", "vs_baseline": None,
            "error": f"{type(exc).__name__}: {exc}"[:500]}), flush=True)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
