"""Times the attention forward kernels K1 (``csrc/exp_attention.cu``) and
L1f (``csrc/flash_attention.cu``) of one or more checkouts in turn, beside
ptxas's registers and spills and a digest of the machine code (SASS, from
``cuobjdump``) of every instantiation, so that a change to their shared
header ``csrc/attention_fwd.cuh`` can be held to its parent's code and
times on one card; and the host time to enqueue one K1 and one K2
(``csrc/exp_attention_bwd.cu``) call, so that a change to their launch
path can be held to its parent's.

    python tools/attn_fwd_timing_torch.py [ROOT ...]

Each ROOT (default: this checkout) is a checkout of the repository, run in
a process of its own that imports ``dupl_tpu_torch`` from ROOT and builds
ROOT's two kernels into ROOT/build.  Give the roots in turns (parent,
change, change, parent) to see the spread.  Shapes: K1 at ``chip_smoke.py``
phase 3's (B 16, H 12, D 64; N 1765, 1226, 785), L1f at phase 14's (B 16,
N 2117; B 2, N 5185), q, k, v column slices of one projection.  Times are
medians of one call between two CUDA events and of rounds of back-to-back
calls (~5 ms each), as ``chip_smoke.py``'s ``time_ms``; host times
(``host_us``: K1 at its three shapes, K2 at phase 11's B 4, N 785) are
medians of 201 calls enqueued while a spin kernel keeps the card busy, as
``chip_smoke.py``'s ``host_us`` takes 21.  Prints the card's name and power limit, one
JSON line per ROOT, then a table.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

K1_SHAPES = ((16, 1765), (16, 1226), (16, 785))
L1F_SHAPES = ((16, 2117), (2, 5185))


def _time_ms(fn, back_to_back=False, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()

    def round_ms(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    reps = (max(1, min(20, int(5.0 / max(round_ms(1), 1e-3))))
            if back_to_back else 1)
    return statistics.median(round_ms(reps) for _ in range(iters))


def _host_us(fn, reps=201):
    """Median host time (us) to enqueue one call while the device is busy."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)   # ~30 ms of device time
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(ts)


def _sass_digests(lib) -> list:
    """A digest of each kernel's SASS in ``lib``, in file order: of its
    instruction lines alone, each with its encoding words, their runs of
    blanks collapsed (cuobjdump pads its columns to the widest instruction
    of the whole library, which moves when a kernel is added).  The names
    are left out (they carry the template arguments, which may be spelt
    differently in two checkouts), and so is the text that follows the
    dump's last kernel, which moves when a kernel is added after it."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return [hashlib.sha256("\n".join(
        " ".join(line.split()) for line in re.findall(r".*/\*.*", body)
    ).encode()).hexdigest()[:12] for body in sass.split("Function : ")[1:]]


def measure(root: str) -> dict:
    """ptxas usage and times of K1 and L1f as ``root`` builds them."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from dupl_tpu_torch.kernels import build
    from dupl_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise SystemExit("attn_fwd_timing: needs a CUDA card")
    dev = torch.device("cuda:0")
    g = torch.Generator(device=dev).manual_seed(0)

    def views(b, n, h=12, d=64):
        qkv = torch.randn(b, n, 3 * h * d, generator=g, device=dev).to(
            torch.bfloat16)
        return [qkv[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
                for i in range(3)]

    rec = {"root": root, "ptxas": {}, "sass": {}, "k1": {}, "l1f": {},
           "host_us": {}}
    for name in ("exp_attention", "flash_attention"):
        rec["ptxas"][name] = build.ptxas_usage(name)
        rec["sass"][name] = _sass_digests(build.build(name))
    for b, n in K1_SHAPES:
        q, k, v = views(b, n)
        qs = q * 0.125

        def k1():
            attention.exp_attention_cuda(qs, k, v)

        rec["k1"][f"BH={12 * b},N={n}"] = [_time_ms(k1),
                                            _time_ms(k1, back_to_back=True)]
        rec["host_us"][f"K1 BH={12 * b},N={n}"] = _host_us(k1)
    q, k, v = views(4, 785)
    qs, go = q * 0.125, torch.randn_like(q)
    rec["host_us"]["K2 B=4,N=785,H=12,D=64"] = _host_us(
        lambda: attention.exp_attention_bwd_cuda(qs, k, v, go))
    for b, n in L1F_SHAPES:
        q, k, v = views(b, n)

        def l1f():
            attention.flash_attention_cuda(q, k, v, 0.125)

        rec["l1f"][f"B={b},N={n}"] = [_time_ms(l1f),
                                      _time_ms(l1f, back_to_back=True)]
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
    print("root | kernel shape: ms one call / back to back | host us a "
          "call | registers (spill stores, loads) per instantiation | SASS "
          "digests")
    for rec in recs:
        times = " | ".join(f"{kern} {shape}: {t[0]:.4f} / {t[1]:.4f}"
                           for kern in ("k1", "l1f")
                           for shape, t in rec[kern].items())
        times += " | " + " ".join(f"{key} {us:.1f}"
                                  for key, us in rec["host_us"].items())
        regs = " ".join(f"{r}({st},{ld})" for name in rec["ptxas"]
                        for _, r, st, ld in rec["ptxas"][name])
        sass = " ".join(d for name in rec["sass"] for d in rec["sass"][name])
        print(f"{rec['root']} | {times} | {regs} | {sass}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
