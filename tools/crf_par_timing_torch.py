"""Times the PAR affinity K3 (``csrc/par_affinity.cu``), the PAR
propagation K4 (``csrc/par_propagate.cu``), the CRF kernel-apply K5
(``csrc/crf_apply.cu``) and its bf16-exp variant P3
(``csrc/crf_apply_bf16.cu``) of one or more checkouts in turn, beside
ptxas's registers and spills and a digest of the machine code (SASS, from
``cuobjdump``) of every instantiation, so that a change to one of them, or
to the header K5 and P3 share (``csrc/mma_bf16.cuh``), can be held to its
parent's code and times on one card.

    python tools/crf_par_timing_torch.py [ROOT ...]

Each ROOT (default: this checkout) is a checkout of the repository, run in
a process of its own that imports ``dupl_tpu_torch`` from ROOT and builds
ROOT's kernels into ROOT/build.  Give the roots in turns (parent, change,
change, parent) to see the spread.  Shapes: K3 at ``chip_smoke.py`` phase
7's uint8 image (B 16, 224^2, 48 taps), a training step's B 4, and B 16
with the same taps in another order (K3's path for dilations other than
the recipe's); K4 at phase 8's B 16, 224^2, C 40, 10 rounds, fp32 and
bf16; K5 at phase 4's B 2, N 200,704, Ns 3,136, V 22 and 82; P3 and K5 at the P3 tool's
B 16, V 22 (``tools/crf_apply_experiment_torch.py``'s operands).  Times are
medians of one call between two CUDA events, of rounds of back-to-back
calls (~5 ms each), as ``chip_smoke.py``'s ``time_ms``, and for K3 of
CUDA-graph replays (the device's time alone).  Prints the card's name and
power limit, one JSON line per ROOT, then a table, and whether each root
keeps every instantiation (SASS digest) of the first root's.  Needs a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from attn_fwd_timing_torch import _sass_digests, _time_ms  # noqa: E402

KERNELS = ("par_affinity", "par_propagate", "crf_apply", "crf_apply_bf16")


def _graph_ms(fn, reps=20, iters=7):
    """Median device time of ``fn`` from replays of a CUDA graph of
    ``reps`` calls: the kernels alone, without the host's time to launch."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / reps)
    return statistics.median(ts)


def measure(root: str) -> dict:
    """ptxas usage, SASS digests and times of K3, K5 and P3 as ``root``
    builds them."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.join(root, "tools"))
    import torch

    import crf_apply_experiment_torch as crf_tool
    from dupl_tpu_torch.kernels import build
    from dupl_tpu_torch.ops import crf_cuda, experiments, par_cuda

    if not torch.cuda.is_available():
        raise SystemExit("crf_par_timing: needs a CUDA card")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"root": root, "ptxas": {}, "sass": {}, "k3": {}, "k4": {},
           "k5": {}, "p3": {}}
    for name in KERNELS:
        rec["sass"][name] = _sass_digests(build.build(name))
        rec["ptxas"][name] = build.ptxas_usage(name)
    g = torch.Generator(device=dev).manual_seed(0)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, 224, device=dev),
                            torch.linspace(0, 1, 224, device=dev),
                            indexing="ij")
    smooth = torch.stack([0.5 + 0.4 * torch.sin(5 * xx + 3 * yy), yy,
                          0.3 + 0.5 * xx * yy], -1).expand(16, 224, 224, 3)
    img = ((smooth + 0.002 * torch.randn(16, 224, 224, 3, generator=g,
                                         device=dev)).clamp(0, 1)
           * 255).round() / 255
    # the recipe's dilations at B 16 and 4; at B 16 also the same taps in
    # another order, which K3 reads with offsets from the launch and not as
    # constants of the kernel
    for b, dil in ((16, (1, 2, 4, 8, 12, 24)), (4, (1, 2, 4, 8, 12, 24)),
                   (16, (2, 1, 4, 8, 12, 24))):
        x = img[:b].contiguous()

        def k3():
            par_cuda.affinity_cuda(x, dil)

        rec["k3"][f"B={b},224x224,dilations={','.join(map(str, dil))}"] = [
            _time_ms(k3), _time_ms(k3, back_to_back=True), _graph_ms(k3)]
    aff = par_cuda.affinity_cuda(img)
    masks = torch.softmax(3 * torch.randn(16, 40, 224, 224, generator=g,
                                          device=dev), 1)
    for dt in (torch.float32, torch.bfloat16):
        a = aff.to(dt)
        rec["k4"][f"B=16,224x224,C=40,{str(dt)[6:]}"] = [
            _time_ms(lambda: par_cuda.propagate_cuda(masks, a)),
            _time_ms(lambda: par_cuda.propagate_cuda(masks, a),
                     back_to_back=True)]
    del img, x, aff, masks, a
    for v in (22, 82):
        ops = crf_tool.make_inputs(2, 200704, 3136, dev, v=v)
        rec["k5"][f"B=2,N=200704,Ns=3136,V={v}"] = [
            _time_ms(lambda: crf_cuda.kernel_apply_cuda(*ops)),
            _time_ms(lambda: crf_cuda.kernel_apply_cuda(*ops),
                     back_to_back=True)]
    ops = crf_tool.make_inputs(16, 200704, 3136, dev)
    key = "B=16,N=200704,Ns=3136,V=22"
    rec["p3"][key] = [_time_ms(lambda: experiments.kernel_apply_bf16(*ops),
                               iters=5)]
    rec["k5"][key] = [_time_ms(lambda: crf_cuda.kernel_apply(*ops), iters=5)]
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
    print("root | kernel shape: ms one call / back to back (/ graph) | "
          "registers (spill stores, loads) per instantiation | SASS digests")
    for rec in recs:
        times = " | ".join(
            f"{kern} {shape}: {' / '.join(f'{x:.4f}' for x in t)}"
            for kern in ("k3", "k4", "k5", "p3")
            for shape, t in rec[kern].items())
        regs = " ".join(f"{r}({st},{ld})" for name in KERNELS
                        for _, r, st, ld in rec["ptxas"][name])
        sass = " ".join(f"{name}: {' '.join(rec['sass'][name])}"
                        for name in KERNELS)
        print(f"{rec['root']} | {times} | {regs} | {sass}")
    for name in KERNELS:
        print(f"{name}: every instantiation of the first root's in each root "
              f"{[set(recs[0]['sass'][name]) <= set(r['sass'][name]) for r in recs]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
