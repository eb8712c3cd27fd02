"""Run one cell of ``BENCHMARK.json`` once, on one CUDA card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix, entry,
metric readers and limits are found by name (``benchmark/spec.py``).

Set-up (``setup_s``, from the process's start): the port's configuration
from the configuration's file (every number checked against it), the
weights drawn from ``--seed`` on the card, the model built around them, a
pool of input batches from ``--seed`` put on the card, two warm-up calls
(the first run in a checkout also compiles the kernels into
``build/dupl_tpu_torch/``).  The window: a closed loop calls the entry back
to back on the pool's batches, with no synchronise of its own, until
``--seconds`` have passed and every batch has been called, then one
``torch.cuda.synchronize()``.  With ``--trace 0`` the line carries the
end-to-end metrics: ``img_s`` (images over the window's wall),
``peak_mem_gib`` (``torch.cuda.max_memory_allocated`` over set-up and
window) and ``setup_s``.  With ``--trace 1`` the same window runs, then the
staged loop (the program's layer entries under CUDA events) and a
``torch.profiler`` pass over three whole calls; the line carries the cell's
per-layer metrics, the device's busy and window seconds and a breakdown.

Then ``correct``: the entry is called once more on every pool batch with
its layer outputs read, the program is freed, and the plain float32
reference (``benchmark/reference/``, TF32 off) judges the images of
``check_images`` on the same weights and inputs (``benchmark/compare.py``;
limits in ``benchmark/limits/<workload>.json``).  Each number and its limit
goes to standard error and, under ``checks``, last into the line.

Exits 2 without a card (or fewer cards than the cell asks for) and 3 if
JAX, or the JAX package, is loaded; neither prints a result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "benchmark"
PROFILED_CALLS = 3


def _pin_caches() -> None:
    """Every kernel and build cache at a fixed path inside the checkout
    (the port's own nvcc builds go to ``build/dupl_tpu_torch/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(CACHE / sub)


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(entry, pool, seconds: float, device):
    """The closed loop: (calls, wall seconds, the last output of each pool
    batch)."""
    calls, last = 0, {}
    t0 = time.perf_counter()
    while True:
        p = calls % len(pool)
        last[p] = entry(pool[p])
        calls += 1
        if calls >= len(pool) and time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    return calls, time.perf_counter() - t0, last


def staged(entry, pool, device) -> dict:
    """Mean milliseconds of each stage of the entry's staged loop: one pass
    over the pool, CUDA events at the stage boundaries (the host clock on
    the CPU), one synchronise at the end."""
    import torch

    runs = []
    for args in pool:
        marks = []

        def mark(name, marks=marks):
            if device.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append((name, ev))
            else:
                marks.append((name, time.perf_counter()))

        entry.staged(args, mark)
        runs.append(marks)
    _sync(device)
    out = {}
    for marks in runs:
        for (_, a), (name, b) in zip(marks, marks[1:]):
            ms = (a.elapsed_time(b) if device.type == "cuda"
                  else 1e3 * (b - a))
            out[name] = out.get(name, 0.0) + ms / len(runs)
    return out


def profiled(entry, pool, device) -> list:
    """The chrome-trace events of a ``torch.profiler`` pass: one call, then
    ``PROFILED_CALLS`` calls and their synchronise inside the
    ``benchmark.window`` annotation."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        entry(pool[-1])
        _sync(device)
        with record_function(trace.WINDOW):
            for i in range(PROFILED_CALLS):
                entry(pool[i % len(pool)])
            _sync(device)
    return trace.events_of(prof)


def check(cell, entry, pool, pool_np, last, seed: int, device):
    """(rows of numbers, seconds): the entry's judged calls, then the
    reference on the judged images and on the first judged call's block
    products, the program freed in between."""
    import torch

    from benchmark import capture, spec, traffic, weights

    t = time.perf_counter()
    by_batch = {}
    for p, j in traffic.check_sample(cell.traffic, seed):
        by_batch.setdefault(p, []).append(j)
    rows, capt, products = [], {}, None
    for p in sorted(by_batch):
        capt[p] = entry.capture(pool[p], seed + p)
        rows.append({"rerun_mismatch": entry.rerun(last[p], capt[p]["out"])})
        got = capt[p].pop("products")
        products = got if products is None else products
    entry.release()
    del pool[:]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = spec.reference_module(cell)
    w = weights.make(cell.config, seed, device)
    block = 4 if device.type == "cuda" else 1 << 30
    with torch.no_grad():
        rows += capture.judge_products(products, ref, w, cell.config)
        for p, js in sorted(by_batch.items()):
            for i in range(0, len(js), block):
                part = js[i:i + block]
                out = entry.reference(ref, w, pool_np[p], part,
                                      entry.stage_inputs(capt[p], part))
                rows += entry.judge_images(capt[p], last[p], out, part)
    return rows, time.perf_counter() - t


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device, *,
             quantized=None, t_start=None):
    """One run of ``cell``: (the result's line, the worst of every number
    compared)."""
    import torch

    from benchmark import compare, nojax, program, spec, trace, traffic, \
        weights

    t_start = T_START if t_start is None else t_start
    on_card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    marks = [("start", t_start), ("imports", time.perf_counter())]
    cfg = program.port_config(cell.config, quantized)
    w = weights.make(cell.config, seed, device)
    model = program.build_model(cfg, w, device)
    del w
    entry = spec.entry_module(cell).Entry(cfg, model, cell.config,
                                          cell.traffic, device)
    del model
    _sync(device)
    marks.append(("model", time.perf_counter()))
    pool_np = traffic.generate(cell.traffic, seed, cell.root)
    pool = [entry.inputs(b) for b in pool_np]
    marks.append(("traffic", time.perf_counter()))
    for _ in range(2):
        entry(pool[0])
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start

    calls, wall, last = window(entry, pool, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = nojax.found()
    if found:
        raise JaxLoaded(found)
    batch = cell.traffic["batch"]
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    values, breakdown = {}, None
    if not trace_on:
        values = {"img_s": batch * calls / wall,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    else:
        stages = staged(entry, pool, device)
        events = profiled(entry, pool, device)
        t0, t1 = trace.window(events) or (0.0, 0.0)
        busy = sum(b - a for a, b in trace.busy_intervals(events, t0, t1))
        dev.update(busy_s=busy * 1e-6, window_s=(t1 - t0) * 1e-6)
        breakdown = {"device_ops": trace.top_kernels(events, t0, t1),
                     "idle_gaps": trace.idle_gaps(events, t0, t1)}
        flops = entry.flops()
        ctx = SimpleNamespace(
            cell=cell, config=cell.config, traffic=cell.traffic,
            window={"calls": calls, "seconds": wall}, stages=stages,
            events=events, t0=t0, t1=t1, flops=flops,
            profiled_calls=PROFILED_CALLS,
            profiled_images=PROFILED_CALLS * batch,
            op_kernels=functools.lru_cache(maxsize=None)(
                lambda name: trace.op_kernels(events, name)))
        for m in cell.per_layer:
            v = spec.metric_reader(cell, m["name"])(ctx)
            if v is not None:
                values[m["name"]] = v
        del events, ctx
    rows, check_s = check(cell, entry, pool, pool_np, last, seed, device)
    worst, checks, ok, failed = compare.judge(rows, cell.limits)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    line = {"correct": ok, "attempted": batch * calls, "failed": failed,
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in values.items()},
            "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    parts = ", ".join(f"{b[0]} {b[1] - a[1]:.3f}"
                      for a, b in zip(marks, marks[1:]))
    _log(f"window: {calls} calls in {wall:.3f} s; set-up {setup_s:.3f} s "
         f"({parts}); check {check_s:.3f} s over {len(rows)} rows")
    return line, worst


class JaxLoaded(RuntimeError):
    pass


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    _pin_caches()
    sys.path.insert(0, str(ROOT))
    from benchmark import nojax, spec

    found = nojax.found()
    if found:
        _log(f"refused: loaded at start-up: {', '.join(found)}")
        return 3
    cell = spec.resolve(args.workload)
    import torch

    need = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        _log(f"refused: the cell runs on {need} CUDA card(s), {have} found; "
             "there is no CPU fallback")
        return 2
    try:
        line, _ = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda:0"))
    except JaxLoaded as e:
        _log(f"refused: loaded once the window closed: {e}")
        return 3
    found = nojax.found()
    if found:
        _log(f"refused: loaded once the window closed: {', '.join(found)}")
        return 3
    _log(card_line())
    for name, c in line["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:      # the line stays unprinted; the cause on stderr
        traceback.print_exc()
        sys.exit(1)
