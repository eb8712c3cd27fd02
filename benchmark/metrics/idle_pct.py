"""``idle_pct``: the share of the profiled window in which the device runs
nothing, in %: 1 - the union of the kernel, copy and memset intervals over
the span of the profiler's pass of whole calls.  Both come from the same
trace, so the share lies in [0, 100]; the profiler slows the host, so where
the host paces the device the share reads above that of the untraced
window.  The untraced window's wall a call is no span for busy time taken
from the profiled pass: the two runs differ, and the share read below 0
where the device was busy throughout."""

from benchmark import trace


def read(ctx):
    if ctx.events is None or ctx.t1 <= ctx.t0:
        return None
    busy = sum(b - a for a, b in trace.busy_intervals(ctx.events, ctx.t0,
                                                       ctx.t1))
    if not busy:
        return None
    return 100.0 * (1.0 - busy / (ctx.t1 - ctx.t0))
