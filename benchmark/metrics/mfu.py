"""``mfu``: the whole call's share of the card's peak, in %.  The model
FLOPs of a call (``benchmark/counts.py``), each type over its own peak,
summed to the least time a call could take; times the calls of the traced
run's window, which runs outside the profiler; over that window's wall."""

from benchmark import counts


def read(ctx):
    w = ctx.window
    if not w["calls"] or w["seconds"] <= 0:
        return None
    return 100.0 * w["calls"] * counts.least_seconds(ctx.flops) / w["seconds"]
