"""``crf_ms``: device milliseconds a call spends in the softmax of the segmentation logits, the fast CRF (`ops/crf.py:crf_from_config`, K5) and the argmax: CUDA
events around the benchmark's call into that layer in the staged loop (the
program's forward, layer by layer, with no synchronise between calls), the
mean over the loop."""


def read(ctx):
    return ctx.stages.get("crf")
