"""Times the exact GELU G (``csrc/gelu_erf.cu``) and the w8a8 product Q2
(``csrc/int8_gemm.cu``) of one or more checkouts in turn, beside ptxas's
registers and spills of every instantiation and a digest of each result, so
that a change to either kernel can be held to its parent's times and bits
on one card.

    python tools/gelu_int8_timing_torch.py [ROOT ...]

Each ROOT (default: this checkout) is a checkout of the repository, run in
a process of its own that imports ``dupl_tpu_torch`` from ROOT and builds
ROOT's kernels into ROOT/build.  Give the roots in turns (parent, change,
change, parent) to see the spread.  Shapes: G at the MLP's hidden
activations of ``chip_smoke.py`` phase 30 (12,560 x 3072: N(0, 1.5^2)
draws, and draws of one erfc branch each, |z| < 1 and |z| >= 2), forward
and backward, bf16 and fp32; Q2 at ViT-B's four products (M 12,560; qkv,
proj, fc1 on bf16 activations, fc2 on fp32 ones) with the bias.  The
operands are made from one seed, the same in every ROOT.  Times are
medians of one call on an idle device between two CUDA events (the op's
host time to enqueue included, as ``chip_smoke.py`` reports ``ms``) and
of rounds of calls back to back (the host's time hidden behind the
device's work: ``ms_back_to_back``).  Prints the card's name and power
limit, one JSON line per ROOT, then a table.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from attn_fwd_timing_torch import _time_ms  # noqa: E402

ROWS = 16 * 785          # bench_config's 16 images at scale 1.0
PRODUCTS = {"qkv": (2304, 768, "bfloat16"), "proj": (768, 768, "bfloat16"),
            "fc1": (3072, 768, "bfloat16"), "fc2": (768, 3072, "float32")}


def _times(fn):
    """[ms of one call, ms a call back to back], medians."""
    return [_time_ms(fn), _time_ms(fn, back_to_back=True)]


def _digest(t) -> str:
    """The first 12 hex digits of the SHA-256 of a result's bits."""
    import torch

    bits = t.contiguous().view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return hashlib.sha256(bits.cpu().numpy().tobytes()).hexdigest()[:12]


def measure(root: str) -> dict:
    """ptxas usage, result digests and times of G and Q2 as ``root`` builds
    them."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from dupl_tpu_torch.kernels import build
    from dupl_tpu_torch.ops import gelu, quant

    if not torch.cuda.is_available():
        raise SystemExit("gelu_int8_timing: needs a CUDA card")
    dev = torch.device("cuda:0")
    rec = {"root": root, "ptxas": {}, "digest": {}, "g": {}, "q2": {}}
    for name in ("gelu_erf", "int8_gemm"):
        rec["ptxas"][name] = build.ptxas_usage(name)
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
        qa, sa = quant.quantize_rows_cuda(a)
        qw, sw = quant.quantize_rows_cuda(w)
        rec["q2"][name] = _times(
            lambda: quant.int8_linear_cuda(qa, sa, qw, sw, bias))
        rec["digest"][f"q2 {name}"] = _digest(
            quant.int8_linear_cuda(qa, sa, qw, sw, bias))
        del a, w, bias, qa, sa, qw, sw
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
    print("root | kernel shape: ms of one call / ms a call back to back "
          "| registers (spill stores, loads) per instantiation")
    for rec in recs:
        times = " | ".join(f"{kern} {shape}: {t[0]:.4f} / {t[1]:.4f}"
                           for kern in ("g", "q2")
                           for shape, t in rec[kern].items())
        regs = " ".join(f"{r}({st},{ld})" for name in rec["ptxas"]
                        for _, r, st, ld in rec["ptxas"][name])
        print(f"{rec['root']} | {times} | {regs}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
