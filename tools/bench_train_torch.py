"""Train-step benchmark of the PyTorch port on one card.

    python tools/bench_train_torch.py [--batch 4] [--iters 5] [--phase full]
                                      [--dataset voc] [--device cuda]
                                      [--crop N]

Builds the production recipe (ViT-B/16 dual student, bf16 compute, fp32
residual stream in the differentiated pass, bf16 stream in the no-grad CAM
passes, CAMs merged at half the input size), seeded random weights and one
synthetic batch at the recipe's crop, takes two untimed steps in the chosen
curriculum phase, one more untimed step under ``FlopCounterMode``
(``utils/flops.py``: the step's model FLOPs, the kernels' by their ops'
flop formulas) and then ``--iters`` timed ones.  Prints ms per step, steps
and images per second, peak device memory, the kernels' launches per step,
FLOPs per step, TFLOPs per image, the card's dense bf16 peak and the MFU
(FLOPs per step / median step time / peak; the counterpart of
``tools/bench_train.py``'s MFU line), and the card's name and power limit;
the last line is a JSON summary.  ``--device cpu`` runs the plain twins (a
functional check: its times say nothing about the card, and its ``mfu`` is
null; the FLOP count is the card's); ``--crop`` exists for that check
alone, to shrink the batch to what a CPU takes (``--device cpu --crop 64
--batch 2``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def kernel_counters():
    from dupl_tpu_torch.ops import attention, par_cuda

    return {"exp_attention": attention.exp_attention_cuda,
            "exp_attention_bwd": attention.exp_attention_bwd_cuda,
            "par_affinity": par_cuda.affinity_cuda,
            "par_propagate": par_cuda.propagate_cuda}


def main(argv=None) -> int:
    return 0 if run(argv) is not None else 2


def run(argv=None):
    """The benchmark; returns its JSON summary (None without a card when
    one is asked for)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--phase", default="full",
                    choices=("warmup", "seg_static", "seg", "full"))
    ap.add_argument("--dataset", default="voc", choices=("voc", "coco"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--crop", type=int, default=None,
                    help="override the recipe's crop size (for --device cpu)")
    args = ap.parse_args(argv)

    import torch

    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.engine.train import (Trainer, phase_of, phase_start,
                                             production_config)
    from dupl_tpu_torch.utils import flops as flops_utils

    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        print("bench_train_torch: no CUDA device (use --device cpu for a "
              "functional run)", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = "cpu"
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    cfg = production_config(args.dataset)
    crop = args.crop or cfg.data.crop_size
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state()
    state.step = state.optimizer.global_step = phase_start(cfg, args.phase)
    assert phase_of(cfg, state.step) == args.phase
    batch = trainer.put(synthetic_batch(args.batch, crop=crop,
                                        num_fg=cfg.model.num_fg))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    for _ in range(2):
        state, metrics = trainer.train_step(state, batch)
    sync()
    flops_per_step = flops_utils.count_flops(trainer.train_step, state, batch)
    sync()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(args.iters):
        t = time.perf_counter()
        state, metrics = trainer.train_step(state, batch)
        sync()
        times.append(time.perf_counter() - t)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    launches = {k: fn.launches / args.iters for k, fn in counters.items()}
    loss = {k: float(v) for k, v in metrics.items()}
    peak_flops = flops_utils.peak_flops_per_device(dev)
    util = flops_utils.mfu(flops_per_step, 1, med, dev)
    tf_per_img = flops_per_step / 1e12 / args.batch
    print(f"{args.dataset} {args.phase} | batch {args.batch} crop {crop} | "
          f"{1e3 * med:.1f} ms/it (median of {args.iters}) | {1 / med:.3f} "
          f"it/s | {args.batch / med:.3f} img/s | peak memory "
          f"{'%.3f GiB' % peak if on_card else 'not measured'} | kernel "
          f"launches a step {json.dumps(launches)} | loss {loss['loss']:.4f} "
          f"| flops_per_step {flops_per_step:.6e} ({tf_per_img:.4f} TF/img) "
          f"| peak_flops {'%.4g' % peak_flops if peak_flops else 'none'} | mfu "
          f"{'%.4f' % util if util is not None else 'not measured'}",
          flush=True)
    summary = {
        "device": card, "dataset": args.dataset, "phase": args.phase,
        "batch": args.batch, "crop": crop, "ms_per_step": 1e3 * med,
        "ms_per_step_all": [1e3 * t for t in times],
        "steps_per_s": 1 / med, "img_per_s": args.batch / med,
        "peak_gib": peak, "launches_per_step": launches, "metrics": loss,
        "flops_per_step": flops_per_step, "tf_per_img": tf_per_img,
        "peak_flops": peak_flops, "mfu": util}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    sys.exit(main())
