"""The readings a cell's limits are set from, many seeds in one process
(set-up is paid once a seed, not once a process).  Not run by the
benchmark's own runs.

    python3 benchmark/readings.py --workload <name> --seeds 1 12 \
        [--seconds 2] [--control]

Without ``--control``: sound runs of the program, each a short window (every
pool batch called) and the full check, one JSON line a seed with the worst
of every number.  With ``--control``: a control of the cell, which has to
come out as not correct: ``program-int8``, the program's own int8 path
(``quantized_inference``) judged against the float32 reference (a bf16
configuration's); ``fp8``, the reference computed in float8 e4m3 where the
configuration holds bf16, put in the program's place (a bf16
configuration's); ``int4``, the reference with int4 products in the
program's place, judged against the reference's int8 products (the int8
configuration's).  With ``--fault``: the program with a fault of
``benchmark/faults.py`` planted in its timed path, which has to come out
as not correct too.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import faults  # noqa: E402


def reference_control(cell, seed: int, device, prec: str) -> dict:
    """The worst numbers of the reference computed in ``prec`` put in the
    program's place, against the reference as the configuration states
    it."""
    import torch

    from benchmark import capture, compare, spec, traffic, weights

    entry = spec.entry_module(cell).Entry(None, None, cell.config,
                                          cell.traffic, device)
    ref = spec.reference_module(cell)
    w = weights.make(cell.config, seed, device)
    pool = traffic.generate(cell.traffic, seed, cell.root)
    by_batch = {}
    for p, j in traffic.check_sample(cell.traffic, seed):
        by_batch.setdefault(p, []).append(j)
    rows, products = [], []
    block = 4 if device.type == "cuda" else 1 << 30
    with torch.no_grad():
        for p, js in sorted(by_batch.items()):
            for i in range(0, len(js), block):
                part = js[i:i + block]
                local = list(range(len(part)))
                low = entry.reference(ref, w, pool[p], part, None, prec=prec,
                                      record=None if products else products)
                if rows == []:
                    rows += capture.judge_products(products, ref, w,
                                                   cell.config)
                capt, labels = entry.from_reference(low)
                want = entry.reference(ref, w, pool[p], part,
                                       entry.stage_inputs(capt, local))
                rows += entry.judge_images(capt, labels, want, local)
    limits = {k: v for k, v in cell.limits.items() if k != "rerun_mismatch"}
    worst, checks, ok, _ = compare.judge(rows, limits)
    return {"correct": ok, "numbers": worst}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs=2, required=True,
                    metavar=("FIRST", "LAST"))
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", choices=("program-int8", "fp8", "int4"),
                    help="the control: the program's int8 path, or the "
                         "reference in fp8 or int4 in the program's place")
    ap.add_argument("--fault", choices=faults.NAMES,
                    help="a fault planted in the program's timed path")
    args = ap.parse_args(argv)
    import torch

    from benchmark import run, spec

    run._pin_caches()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cell = spec.resolve(args.workload)
    for seed in range(args.seeds[0], args.seeds[1] + 1):
        t = time.perf_counter()
        if args.control in ("fp8", "int4"):
            rec = reference_control(cell, seed, dev, args.control)
        else:
            plant = (faults.plant(args.fault, cell.traffic["entry"])
                     if args.fault else contextlib.nullcontext())
            with plant:
                line, worst = run.run_cell(
                    cell, seed, args.seconds, False, dev, t_start=t,
                    quantized=True if args.control else None)
            rec = {"correct": line["correct"], "numbers": worst,
                   "img_s": line["metrics"]["img_s"]["value"]}
        kind = args.control or args.fault or "program"
        rec.update(workload=args.workload, seed=seed, kind=kind,
                   seconds=time.perf_counter() - t)
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
