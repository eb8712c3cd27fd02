"""``launches_per_img``: CUDA kernels a labelled image, counted in the
profiler's pass over whole calls of the entry."""

from benchmark import trace


def read(ctx):
    if ctx.events is None or not ctx.profiled_images:
        return None
    n = len(trace.kernels(ctx.events, ctx.t0, ctx.t1))
    return n / ctx.profiled_images if n else None
