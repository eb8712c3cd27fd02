"""The yardstick's arithmetic: the card's peaks, the model FLOPs of the two
programs, and the least time of a kernel from its shapes.

Peaks: NVIDIA's H100 SXM datasheet, dense (frozen from
``dupl_tpu_torch/utils/flops.py``): 989 TFLOP/s bf16 on the tensor cores,
1,979 TOP/s int8, 67 TFLOP/s fp32 outside the tensor cores (an SM's 128
fp32 lanes; the special-function unit an eighth of their instruction
rate), HBM3 at 3.35 TB/s.

Model FLOPs are the products the outputs need (two per multiply-add), by
the type the configuration computes them in: the ViT's products, the
attention and the decoder in bf16 (the four block products in int8 with
``quantized_inference``); the CAM classifier and the CRF's pivot products
in fp32; the CRF's full-resolution slice its fp32 score and its bf16 value
product.  Resizes, norms, softmaxes, PAR and every other elementwise pass
count nothing.  ``tests/test_bench_counts.py`` holds the totals equal to
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference.

The kernel bounds are frozen from ``chip_smoke.py`` (``bound_ms``,
``k5_bound``) and ``PERF.md``'s kernel table: the larger of the operations
over their peak and the bytes (each input read once, each output written
once) over the memory's rate.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Sequence

PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
        "sfu": 67e12 / 2 / 8, "hbm": 3.35e12}


def least_seconds(flops: Dict[str, float]) -> float:
    """Each type's FLOPs over its own peak, summed."""
    return sum(n / PEAK[t] for t, n in flops.items())


def _bound(ops: float, rate: str, nbytes: float) -> float:
    return max(ops / PEAK[rate], nbytes / PEAK["hbm"])


# -- kernels -------------------------------------------------------------------

def k1_bound(b: int, n: int, h: int, d: int) -> float:
    """K1 (exp attention) on (B, N, H, D): two products of 2 N^2 D a head;
    q, k, v read and the output written in bf16."""
    return _bound(4 * b * h * n * n * d, "bf16", 4 * b * h * n * d * 2)


def q2_bound(m: int, n: int, k: int) -> float:
    """Q2 (the w8a8 product): 2 M N K int8 operations; the int8 operands,
    the fp32 row and column scales and bias read, the fp32 output
    written."""
    return _bound(2 * m * n * k, "int8",
                  m * k + n * k + 4 * m + 8 * n + 4 * m * n)


def k4_bound(b: int, c: int, h: int, w: int, taps: int, rounds: int,
             aff_bytes: int) -> float:
    """K4 (PAR propagation), all ``rounds`` of a call: a product and a sum a
    tap and pixel-channel, at the fp32 rate in fp32 mode and at twice it
    in the 16-bit modes (bf16x2 / f16x2); the fp32 masks read and written
    once, the affinity read once."""
    pix = b * h * w
    ops = rounds * 2 * taps * pix * c / (1 if aff_bytes == 4 else 2)
    return _bound(ops, "fp32", 4 * pix * 2 * c + aff_bytes * pix * taps)


def k5_bound(b: int, n: int, ns: int, v: int) -> float:
    """K5 (the CRF's kernel apply): per (pixel, pivot) entry the 11-wide
    score's 22 fp32 FLOPs, one exp on the special-function unit and the
    value product's 2 VP FLOPs (V rounded up to 8) in bf16 on the tensor
    cores: the largest of the three, or the bytes (basis, coef, logc,
    values in, (N, V) out, fp32)."""
    entries = b * n * ns
    vp = -(-v // 8) * 8
    ops = max(22 * entries / PEAK["fp32"], entries / PEAK["sfu"],
              2 * vp * entries / PEAK["bf16"])
    nbytes = 4 * b * (n * 11 + 11 * ns + ns + ns * v + n * v)
    return max(ops, nbytes / PEAK["hbm"])


# -- model FLOPs ---------------------------------------------------------------

def encoder_flops(cfg: dict, m: int, h: int, w: int) -> Counter:
    """One ViT forward of ``m`` images of h x w pixels."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    hid, heads = cfg["mlp_dim"], cfg["num_heads"]
    hw = (h // p) * (w // p)
    n = hw + 1
    prod = "int8" if cfg.get("quantized_inference") else "bf16"
    out = Counter()
    out["bf16"] += 2 * m * hw * d * 3 * p * p                 # patch embed
    out[prod] += cfg["depth"] * 2 * m * n * d * (3 * d + d + 2 * hid)
    out["bf16"] += cfg["depth"] * 4 * m * heads * n * n * (d // heads)
    return out


def decoder_flops(cfg: dict, m: int, h: int, w: int) -> Counter:
    hw = (h // cfg["patch_size"]) * (w // cfg["patch_size"])
    d, e = cfg["embed_dim"], cfg["decoder_dim"]
    return Counter({"bf16": 2 * m * hw * 9 * e * (d + e)
                    + 2 * m * hw * e * cfg["num_classes"]})


def crf_fast_flops(b: int, h: int, w: int, c: int, s: int,
                   iters: int) -> Counter:
    """The fast CRF: the pivot-to-pivot kernel, ``iters`` - 1 pivot
    rounds, and the full-resolution slice (its score in fp32, its value
    product, the C columns and the count, in bf16)."""
    n, ns = h * w, (h // s) * (w // s)
    return Counter({"fp32": 2 * b * ns * 11 * ns
                    + (iters - 1) * 2 * b * ns * ns * c
                    + 2 * b * n * 11 * ns,
                    "bf16": 2 * b * n * ns * (c + 1)})


def _scaled(h: int, s: float) -> int:
    return int(s * h)


def pseudo_label_flops(cfg: dict, b: int, h: int, w: int) -> Counter:
    """A call of the pseudo-label factory on B images of h x w."""
    out = Counter()
    p = cfg["patch_size"]
    for _ in range(2):                                          # students
        for s in cfg["cam_scales"]:
            hs, ws = _scaled(h, s), _scaled(w, s)
            out += encoder_flops(cfg, 2 * b, hs, ws)
            hw = (hs // p) * (ws // p)
            out["fp32"] += 2 * 2 * b * hw * cfg["embed_dim"] * (
                cfg["num_classes"] - 1)                         # CAM head
            if s == 1.0:
                out += decoder_flops(cfg, b, hs, ws)
    c = cfg["crf"]
    out += crf_fast_flops(b, h, w, cfg["num_classes"], c["downsample"],
                          c["iter_max"])
    return out


def serving_flops(cfg: dict, b: int, h: int, w: int,
                  scales: Sequence[float], crf: bool = True) -> Counter:
    """A call of the serving program (both students) on B images."""
    out = Counter()
    for _ in range(2):
        for s in scales:
            hs, ws = _scaled(h, s), _scaled(w, s)
            out += encoder_flops(cfg, 2 * b, hs, ws)
            out += decoder_flops(cfg, 2 * b, hs, ws)
    if crf:
        c = cfg["crf"]
        out += crf_fast_flops(b, h, w, cfg["num_classes"], c["downsample"],
                              c["iter_max"])
    return out
