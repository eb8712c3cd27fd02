"""``par_ms``: device milliseconds a call spends in PAR's refinement into pseudo-labels (`engine/train.py:refine` -> `ops/par.py`, K3 and K4): CUDA
events around the benchmark's call into that layer in the staged loop (the
program's forward, layer by layer, with no synchronise between calls), the
mean over the loop."""


def read(ctx):
    return ctx.stages.get("par")
