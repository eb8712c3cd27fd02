"""Stage-by-stage timing of the training step on one card: the counterpart
of ``tools/train_dissect.py``.

    python tools/train_dissect_torch.py [--batch 8] [--iters 6]
                                        [--device cuda]

The JAX tool's recipe (``voc_config`` with a bf16 residual stream in the
no-grad CAM passes and the CAMs merged at half the input size, that is
``production_config("voc")``), ViT-B/16, seeded weights, one
``synthetic_batch`` at crop 448.  Each stage is timed as the minimum over
``--iters`` calls after one warm-up, each call followed by a
``torch.cuda.synchronize()``:

* ``msc``: ``Trainer._multi_scale_cams`` (6 no-grad forwards, K1);
* ``strong_augment``: the strong view (``ops/augment.strong_augment``);
* ``refine``: ``Trainer._refine`` (K3, K4);
* ``ptc_targets``: ``Trainer._ptc_targets`` at the patch grid;
* ``grad``: the dual forward and backward of ``cls + 0.2 ptc + 0.1 sim +
  0.2 seg`` (:func:`dissect_loss`: student 1's seg logits against all-zero
  targets; K1 and K2);
* ``gmm``: the GMM filter of both branches on zero logits;
* ``optimizer``: one AdamW update on zero gradients;
* ``full_step``: ``Trainer.train_step`` in the full phase, also as it/s.

Prints the card's name and power limit, one row a stage and last a JSON
line of the stages' milliseconds.  ``--device cpu`` runs the plain twins, a
functional check; ``--backbone`` and ``--crop`` exist for it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def dissect_loss(trainer, inputs, cls_label, aff):
    """``tools/train_dissect.py``'s ``grad_step`` loss: the dual student's
    forward, ``cls + 0.2 ptc + 0.1 sim`` against the PTC targets ``aff``
    and ``0.2`` times student 1's balanced seg loss, at the input size,
    against all-zero (background) targets."""
    import torch

    from dupl_tpu_torch.engine.train import Norms
    from dupl_tpu_torch.ops import image as image_ops
    from dupl_tpu_torch.ops import losses as loss_ops

    out = trainer.model(inputs)
    cls_l, ptc_l, sim_l = trainer._common_losses(out, cls_label, aff,
                                                 Norms())
    b, h, w, _ = inputs.shape
    segs_up = image_ops.resize_bilinear(out.seg, (h, w), batch_dims=2)
    zeros = torch.zeros(b, h, w, dtype=torch.long, device=inputs.device)
    seg_l = loss_ops.seg_loss(segs_up[0], zeros, trainer.cfg.ignore_index)
    return cls_l + 0.2 * ptc_l + 0.1 * sim_l + 0.2 * seg_l


def run(argv=None) -> dict:
    """The measurement; returns the row of milliseconds.  Raises without
    the card it is asked for."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backbone", default="deit_base_patch16")
    ap.add_argument("--crop", type=int, default=448)
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.engine.train import Trainer, production_config
    from dupl_tpu_torch.ops import augment as augment_ops
    from dupl_tpu_torch.ops import image as image_ops
    from dupl_tpu_torch.utils.device import cli_device
    from dupl_tpu_torch.utils.timing import card_line

    device = cli_device(args.device)
    print(card_line(device), flush=True)
    cfg = production_config("voc")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone=args.backbone))
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    b, crop = args.batch, args.crop
    batch = trainer.put(synthetic_batch(b, crop=crop,
                                        num_fg=cfg.model.num_fg))
    inputs, cls_label = batch["image"], batch["cls_label"]
    denorm = image_ops.denormalize(inputs)
    grid = crop // cfg.model.patch_size
    gen = torch.Generator(device=device).manual_seed(0)

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
        return 1e3 * best

    rows = {}

    def row(key, what, ms):
        rows[key] = ms
        print(f"{what}: {ms:.1f} ms", flush=True)

    row("msc", "train MSC (6 fwd, merge at half size + aux)",
        timeit(trainer._multi_scale_cams, inputs))
    cams, cams_aux = trainer._multi_scale_cams(inputs)
    aug_ops = augment_ops.draw_ops(gen, cfg.aug_n, b)
    with torch.no_grad():
        row("strong_augment", "strong augment",
            timeit(augment_ops.strong_augment, denorm, aug_ops, cfg.aug_m))
    row("refine", "refine",
        timeit(trainer._refine, cams, denorm, batch, cfg.high_thre))

    def ptc(cams_aux):
        return trainer._ptc_targets(cams_aux, cls_label, batch["img_box"],
                                    grid, high_thre=None, dynamic=False)

    row("ptc_targets", "ptc targets", timeit(ptc, cams_aux))
    aff = ptc(cams_aux)

    def grad_step():
        state.optimizer.zero_grad(set_to_none=True)
        dissect_loss(trainer, inputs, cls_label, aff).backward()

    row("grad", "dual fwd/bwd + losses", timeit(grad_step))

    refined = trainer._refine(cams, denorm, batch, cfg.high_thre)
    segs = torch.zeros(2, b, crop, crop, cfg.num_classes, device=device)
    row("gmm", "GMM filter (CE map + EM, 2 branches)",
        timeit(trainer._gmm_filter, segs, refined))
    del cams, cams_aux, refined, segs

    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    row("optimizer", "optimizer update (AdamW, both students)",
        timeit(state.optimizer.step))

    step = cfg.gmm_iters + 1       # a full-phase step
    state.step = state.optimizer.global_step = step
    rows["full_step"] = timeit(lambda: trainer.train_step(state, batch,
                                                          step=step))
    print(f"full phase-3 step: {rows['full_step']:.1f} ms -> "
          f"{1e3 / rows['full_step']:.2f} it/s", flush=True)
    print(json.dumps(rows), flush=True)
    return rows


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
