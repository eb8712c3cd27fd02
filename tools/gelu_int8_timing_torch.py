"""Times the exact GELU G (``csrc/gelu_erf.cu``), the quantization Q1
(``csrc/quantize_rows.cu``) and the w8a8 product Q2 (``csrc/int8_gemm.cu``)
of one or more checkouts in turn, beside ptxas's registers and spills of
every instantiation, a digest of each library's machine code (SASS, from
``cuobjdump``) and a digest of each result, so that a change to any of them
can be held to its parent's times, code and bits on one card.

    python tools/gelu_int8_timing_torch.py [ROOT ...]

Each ROOT (default: this checkout) is a checkout of the repository, run in
a process of its own that imports ``dupl_tpu_torch`` from ROOT and builds
ROOT's kernels into ROOT/build.  Give the roots in turns (parent, change,
change, parent) to see the spread.  Shapes: G at the MLP's hidden
activations of ``chip_smoke.py`` phase 30 (12,560 x 3072: N(0, 1.5^2)
draws, and draws of one erfc branch each, |z| < 1 and |z| >= 2), forward
and backward, bf16 and fp32; Q2 at ViT-B's four products (M 12,560; qkv,
proj, fc1 on bf16 activations, fc2 on fp32 ones) with the bias; Q1 as the
int8 path runs it: both operands of qkv, proj and fc1, and fc2's input
from fc1's fp32 output through the tanh or the erf GELU with fc2's weight.
A checkout whose Q1 takes one operand a launch (before the pair and the
GELU entry) runs it once an operand, after the GELU as its encoder ran it:
the nine f32 operations of ``gelu_tanh``, or G.  The operands are made
from one seed, the same in every ROOT; the results of fc2's tanh path are
not compared across roots (the f32 tanh GELU's recipe changed with the
GELU entry).  Times are medians of one call on an idle device between two
CUDA events (the op's host time to enqueue included, as ``chip_smoke.py``
reports ``ms``) and of rounds of calls back to back (the host's time
hidden behind the device's work: ``ms_back_to_back``).  Prints the card's
name and power limit, one JSON line per ROOT, then a table.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from attn_fwd_timing_torch import _sass_digests, _time_ms  # noqa: E402

ROWS = 16 * 785          # bench_config's 16 images at scale 1.0
PRODUCTS = {"qkv": (2304, 768, "bfloat16"), "proj": (768, 768, "bfloat16"),
            "fc1": (3072, 768, "bfloat16"), "fc2": (768, 3072, "float32")}
LIBS = ("gelu_erf", "quantize_rows", "int8_gemm")


def _times(fn):
    """[ms of one call, ms a call back to back], medians."""
    return [_time_ms(fn), _time_ms(fn, back_to_back=True)]


def _digest(t) -> str:
    """The first 12 hex digits of the SHA-256 of a result's bits."""
    import torch

    bits = t.contiguous().view({1: torch.int8, 2: torch.int16,
                                4: torch.int32}[t.element_size()])
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:12]


def measure(root: str) -> dict:
    """ptxas usage, SASS and result digests and times of G, Q1 and Q2 as
    ``root`` builds them."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from dupl_tpu_torch.kernels import build
    from dupl_tpu_torch.models.vit import gelu_tanh
    from dupl_tpu_torch.ops import gelu, quant

    if not torch.cuda.is_available():
        raise SystemExit("gelu_int8_timing: needs a CUDA card")
    dev = torch.device("cuda:0")
    rec = {"root": root, "ptxas": {}, "sass": {}, "digest": {},
           "digest_tanh": {}, "g": {}, "q1": {}, "q2": {}}
    for name in LIBS:
        rec["ptxas"][name] = build.ptxas_usage(name)
        rec["sass"][name] = _sass_digests(build.build(name))
    pair = getattr(quant, "quantize_pair_cuda", None)

    def q1(a, w):
        """(qa, sa, qw, sw): one launch, or one an operand."""
        if pair is not None:
            return pair(a, w)
        return (*quant.quantize_rows_cuda(a), *quant.quantize_rows_cuda(w))

    def q1_gelu(h, w, approximate):
        if pair is not None:
            return quant.gelu_quantize_pair_cuda(h, w, approximate)
        return q1(gelu_tanh(h) if approximate else gelu.gelu_erf_cuda(h), w)

    g = torch.Generator(device=dev).manual_seed(19)
    bf = torch.bfloat16
    u = torch.rand(ROWS, 3072, generator=g, device=dev)
    draws = {"mixed": (torch.randn(ROWS, 3072, generator=g, device=dev)
                       * 1.5).to(bf),
             "small": ((u * 2 - 1) * 1.4).to(bf),
             "large": (torch.where(u < 0.5, -1.0, 1.0)
                       * (2.9 + 5 * torch.rand(ROWS, 3072, generator=g,
                                               device=dev))).to(bf)}
    gh = torch.randn(ROWS, 3072, generator=g, device=dev).to(bf)
    del u
    for name, x in draws.items():
        rec["g"][f"bf16 {name} forward"] = _times(lambda: gelu.gelu_erf_cuda(x))
        rec["g"][f"bf16 {name} backward"] = _times(
            lambda: gelu.gelu_erf_bwd_cuda(x, gh))
        rec["digest"][f"g bf16 {name}"] = _digest(gelu.gelu_erf_cuda(x))
    rec["digest"]["g bf16 mixed backward"] = _digest(
        gelu.gelu_erf_bwd_cuda(draws["mixed"], gh))
    x, gx = draws["mixed"].float(), gh.float()
    del draws, gh
    rec["g"]["fp32 mixed forward"] = _times(lambda: gelu.gelu_erf_cuda(x))
    rec["g"]["fp32 mixed backward"] = _times(
        lambda: gelu.gelu_erf_bwd_cuda(x, gx))
    rec["digest"]["g fp32 mixed"] = _digest(gelu.gelu_erf_cuda(x))
    del x, gx
    torch.cuda.empty_cache()
    for name, (n, k, dt) in PRODUCTS.items():
        a = (torch.randn(ROWS, k, generator=g, device=dev)
             * torch.rand(ROWS, 1, generator=g, device=dev) * 4).to(
                 getattr(torch, dt))
        w = torch.randn(n, k, generator=g, device=dev) * 0.02
        bias = torch.randn(n, generator=g, device=dev) * 0.02
        qa, sa, qw, sw = q1(a, w)
        rec["q2"][name] = _times(
            lambda: quant.int8_linear_cuda(qa, sa, qw, sw, bias))
        rec["digest"][f"q2 {name}"] = _digest(
            quant.int8_linear_cuda(qa, sa, qw, sw, bias))
        if name != "fc2":
            rec["q1"][name] = _times(lambda: q1(a, w))
            for i, t in enumerate((qa, sa, qw, sw)):
                rec["digest"][f"q1 {name} {i}"] = _digest(t)
        else:   # a as fc1's fp32 output: fc2's input through the GELU
            for approximate, tag in ((True, "tanh"), (False, "erf")):
                rec["q1"][f"fc2 {tag}"] = _times(
                    lambda: q1_gelu(a, w, approximate))
                out = rec["digest"] if tag == "erf" else rec["digest_tanh"]
                for i, t in enumerate(q1_gelu(a, w, approximate)):
                    out[f"q1 fc2 {tag} {i}"] = _digest(t)
        del a, w, bias, qa, sa, qw, sw
        torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="*", default=["."])
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.one)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    recs = []
    for root in args.roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        recs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(recs[-1]), flush=True)
    same = all(r["digest"] == recs[0]["digest"] for r in recs)
    print(f"results bit-equal across the roots: {same}")
    for name in LIBS:
        print(f"{name} SASS equal across the roots: "
              f"{all(r['sass'][name] == recs[0]['sass'][name] for r in recs)}"
              f"; every instantiation of the first root's in each root (a "
              f"change that only adds kernels keeps them): "
              f"{[set(recs[0]['sass'][name]) <= set(r['sass'][name]) for r in recs]}")
    print("root | kernel shape: ms of one call / ms a call back to back "
          "| registers (spill stores, loads) per instantiation")
    for rec in recs:
        times = " | ".join(f"{kern} {shape}: {t[0]:.4f} / {t[1]:.4f}"
                           for kern in ("g", "q1", "q2")
                           for shape, t in rec[kern].items())
        regs = " ".join(f"{r}({st},{ld})" for name in rec["ptxas"]
                        for _, r, st, ld in rec["ptxas"][name])
        print(f"{rec['root']} | {times} | {regs}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
