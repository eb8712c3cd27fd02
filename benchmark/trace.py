"""Reading a ``torch.profiler`` trace: the device's busy time, the kernels
each ``dupl::`` op launched, the kernels by device time and the device's
idle gaps by what the host was doing.

The interval arithmetic is ``dupl_tpu_torch/engine/profile.py``'s
(``device_busy_us``, ``kernel_table``), copied: the union of the kernel,
copy and memset intervals, so overlapping streams count once.  A kernel
belongs to an op when the runtime or driver call that launched it (the
event with the kernel's correlation id) lies inside the op's interval on
the op's thread.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "benchmark.window"


def events_of(prof) -> List[dict]:
    """The chrome-trace events of a finished ``torch.profiler.profile``,
    through a file in the temporary directory that is removed at once."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _x(events, cats) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def window(events) -> Optional[Tuple[float, float]]:
    """(start, end) in us of the host's ``benchmark.window`` annotation."""
    for e in events:
        if e.get("ph") == "X" and e.get("name") == WINDOW and \
                e.get("cat") == "user_annotation":
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def busy_intervals(events, t0: float, t1: float) -> List[Tuple[float, float]]:
    """The union of the device intervals, clipped to [t0, t1], sorted."""
    spans = sorted((max(float(e["ts"]), t0),
                    min(float(e["ts"]) + float(e["dur"]), t1))
                   for e in _x(events, DEVICE_CATS))
    out: List[Tuple[float, float]] = []
    for a, b in spans:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def kernels(events, t0: float = float("-inf"),
            t1: float = float("inf")) -> List[dict]:
    return [e for e in _x(events, ("kernel",))
            if t0 <= float(e["ts"]) <= t1]


def top_kernels(events, t0, t1, n: int = 10) -> List[list]:
    """The ``n`` kernels (by name, its first 120 characters) that took the
    most device time, in seconds."""
    tot: Dict[str, float] = collections.Counter()
    for e in kernels(events, t0, t1):
        tot[e["name"][:120]] += float(e["dur"]) * 1e-6
    return [[k, v] for k, v in tot.most_common(n)]


def idle_gaps(events, t0: float, t1: float, n: int = 10) -> List[list]:
    """The device's idle time in [t0, t1], summed by the innermost host op
    running at the middle of each gap; the ``n`` largest, in seconds."""
    busy = busy_intervals(events, t0, t1)
    gaps, cur = [], t0
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in _x(events, ("cpu_op", "user_annotation"))
                 if e.get("name") != WINDOW)
    starts = [o[0] for o in ops]
    tot: Dict[str, float] = collections.Counter()
    for a, b in gaps:
        mid, name = (a + b) / 2, "host: python"
        for k in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            s, e, nm = ops[k]
            if e >= mid:
                name = nm
                break
            if mid - s > 5e6:
                break
        tot[name] += (b - a) * 1e-6
    return [[k, v] for k, v in tot.most_common(n)]


def op_kernels(events, op_name: str):
    """(the ``op_name`` op events, the kernel events they launched), or
    None where the trace links no kernel to a launching call."""
    ops = sorted((e for e in _x(events, ("cpu_op",))
                  if e["name"] == op_name), key=lambda e: float(e["ts"]))
    launches = {}
    for e in _x(events, LAUNCH_CATS):
        c = e.get("args", {}).get("correlation")
        if c is not None:
            launches[c] = e
    kerns = kernels(events)
    if not launches or not any(k.get("args", {}).get("correlation")
                               in launches for k in kerns):
        return None
    by_tid: Dict[object, list] = collections.defaultdict(list)
    for o in ops:
        by_tid[o.get("tid")].append((float(o["ts"]),
                                     float(o["ts"]) + float(o["dur"])))
    starts = {t: [a for a, _ in v] for t, v in by_tid.items()}
    mine = []
    for k in kerns:
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is None or launch.get("tid") not in by_tid:
            continue
        spans, t = by_tid[launch["tid"]], float(launch["ts"])
        i = bisect.bisect_right(starts[launch["tid"]], t) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1]:
            mine.append(k)
    return ops, mine


def input_dims(op: dict) -> list:
    return op.get("args", {}).get("Input Dims", [])


def input_types(op: dict) -> list:
    return op.get("args", {}).get("Input type", [])
