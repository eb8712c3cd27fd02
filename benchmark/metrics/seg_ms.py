"""``seg_ms``: device milliseconds a call spends in both students' multi-scale + flip segmentation logits (`engine/eval_seg.py:msc_seg_logits`): CUDA
events around the benchmark's call into that layer in the staged loop (the
program's forward, layer by layer, with no synchronise between calls), the
mean over the loop."""


def read(ctx):
    return ctx.stages.get("seg")
