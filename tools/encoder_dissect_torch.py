"""Where the time of the ``cam_only`` encoder pass goes beyond its GEMMs:
the counterpart of ``tools/encoder_dissect.py`` on one card.

    python tools/encoder_dissect_torch.py [--seqs 64] [--size 448]
                                          [--iters 10] [--device cuda]
                                          [--gelu tanh|erf]

``bench_config``'s model (ViT-B/16, tanh GELU, bf16 residual stream,
weights from seed 1); ``--gelu erf`` takes the training recipe's exact GELU
instead (kernel G on the card).  Each stage is timed as ``--iters`` calls queued back
to back after one warm-up, with one ``torch.cuda.synchronize()`` at the
end, divided by ``--iters``:

* ``cam_only`` of one ``Student`` on (seqs, size, size, 3) inputs;
* ``Student._features`` (the encoder without the CAM head);
* 12 x ``Block`` with one set of parameters on bf16 tokens;
* 12 x ``Attention`` (qkv, K1, proj) and 12 x ``Mlp`` on those tokens,
  the MLP beside its GEMM roofline at the card's dense bf16 peak
  (``utils/flops.py``);
* ``mlp_train``: 12 x ``Mlp`` forward and backward on 16 sequences (a
  training step's scale-1.0 pass of 4 images and their flips through two
  students), the GELU's backward included;
* 12 x ``ops/attention.exp_attention`` (K1) on (seqs, N, 12, 64), beside
  the roofline of the qkv and output projections.

Prints the card's name and power limit, one row a stage and last a JSON
line of the stages' milliseconds and the rooflines (null where the peak is
not known).  ``--device cpu`` runs the plain twins, a functional check;
``--backbone`` exists for it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TRAIN_SEQS = 16


def run(argv=None) -> dict:
    """The measurement; returns the row of milliseconds.  Raises without
    the card it is asked for."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seqs", type=int, default=64)
    ap.add_argument("--size", type=int, default=448)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backbone", default="deit_base_patch16")
    ap.add_argument("--gelu", choices=["tanh", "erf"], default="tanh",
                    help="tanh: bench_config's GELU; erf: the recipe's")
    args = ap.parse_args(argv)

    import torch

    from dupl_tpu_torch.config import bench_config
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import Student
    from dupl_tpu_torch.models.vit import VIT_CONFIGS, Attention, Block, Mlp
    from dupl_tpu_torch.ops.attention import exp_attention
    from dupl_tpu_torch.utils import flops as flops_utils
    from dupl_tpu_torch.utils.device import cli_device
    from dupl_tpu_torch.utils.timing import card_line

    device = cli_device(args.device)
    print(card_line(device), flush=True)
    tanh = args.gelu == "tanh"
    cfg = bench_config("voc", backbone=args.backbone,
                       gelu_approximate=tanh).model
    spec = VIT_CONFIGS[cfg.backbone]
    d, heads, hidden = spec.embed_dim, spec.num_heads, int(
        spec.embed_dim * spec.mlp_ratio)
    hw = args.size
    n_tok = (hw // cfg.patch_size) ** 2 + 1
    g = torch.Generator().manual_seed(0)
    x = torch.randn(args.seqs, hw, hw, 3, generator=g).to(device)
    student = Student(cfg)
    init_weights(student, torch.Generator().manual_seed(1))
    student.to(device).eval()
    peak = flops_utils.peak_flops_per_device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def bench(fn, *fargs):
        fn(*fargs)
        sync()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            fn(*fargs)
        sync()
        return (time.perf_counter() - t0) / args.iters

    def twelve(module):
        def fn(t):
            for _ in range(12):
                t = module(t).to(t.dtype)
            return t
        return fn

    def roofline_ms(flops):
        return None if peak is None else 1e3 * flops / peak

    rows = {}
    with torch.inference_mode():
        rows["cam_only"] = 1e3 * bench(student.cam_only, x)
        print(f"cam_only full ({args.seqs} seqs, {n_tok} tok): "
              f"{rows['cam_only']:.1f} ms", flush=True)
        rows["features"] = 1e3 * bench(student._features, x)
        print(f"  encoder (_features): {rows['features']:.1f} ms (cam head "
              f"+{rows['cam_only'] - rows['features']:.1f} ms)", flush=True)

        tokens = torch.randn(args.seqs, n_tok, d, generator=g).to(
            device, torch.bfloat16)
        bf16 = torch.bfloat16
        blk = Block(d, heads, spec.mlp_ratio, bf16, tanh)
        attn = Attention(d, heads, bf16)
        mlp = Mlp(d, hidden, bf16, tanh)
        mods = torch.nn.ModuleDict({"block": blk, "attn": attn, "mlp": mlp})
        init_weights(mods, torch.Generator().manual_seed(3))
        mods.to(device).eval()
        rows["blocks"] = 1e3 * bench(twelve(blk), tokens)
        print(f"  12x Block (same params): {rows['blocks']:.1f} ms "
              f"(embed/LN/interp delta "
              f"{rows['features'] - rows['blocks']:+.1f} ms)", flush=True)
        rows["attention"] = 1e3 * bench(twelve(attn), tokens)
        print(f"  12x Attention(+qkv/proj): {rows['attention']:.1f} ms",
              flush=True)
        rows["mlp"] = 1e3 * bench(twelve(mlp), tokens)
        # the MLP's two GEMMs, D x 4D each
        rows["mlp_roofline"] = roofline_ms(
            12 * 2 * 2 * args.seqs * n_tok * d * hidden)
        rf = rows["mlp_roofline"]
        print(f"  12x Mlp: {rows['mlp']:.1f} ms (roofline "
              f"{'%.1f ms' % rf if rf is not None else 'not known'})  "
              f"[blocks - attn - mlp = "
              f"{rows['blocks'] - rows['attention'] - rows['mlp']:+.1f} ms "
              f"LN/residual]", flush=True)

        q = torch.randn(args.seqs, n_tok, heads, d // heads, generator=g).to(
            device, bf16)

        def kernels(t):
            for _ in range(12):
                t = exp_attention(t, t, t, scale=0.125)
            return t

        rows["exp_attention"] = 1e3 * bench(kernels, q)
        rows["qkv_proj_roofline"] = roofline_ms(
            12 * 2 * 4 * args.seqs * n_tok * d * d)
        rf = rows["qkv_proj_roofline"]
        print(f"  12x exp_attention kernel: {rows['exp_attention']:.1f} ms "
              f"(qkv+proj roofline "
              f"{'%.1f ms' % rf if rf is not None else 'not known'})",
              flush=True)
    # outside inference_mode: parameters made there cannot be saved for
    # a backward
    mlp = Mlp(d, hidden, torch.bfloat16, tanh)
    init_weights(mlp, torch.Generator().manual_seed(3))
    mlp.to(device)
    small = torch.randn(TRAIN_SEQS, n_tok, d, generator=g).to(
        device, torch.bfloat16)

    def train(t):
        t = t.clone().requires_grad_(True)
        twelve(mlp)(t).float().sum().backward()

    rows["mlp_train"] = 1e3 * bench(train, small)
    print(f"  12x Mlp forward and backward ({TRAIN_SEQS} seqs): "
          f"{rows['mlp_train']:.1f} ms", flush=True)
    print(json.dumps(rows), flush=True)
    return rows


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
