"""``cam_ms``: device milliseconds a call spends in both students' multi-scale + flip CAMs (`ops/cam.py:multi_scale_cam_with_outputs` over the encoder, the CAM heads and the decoder): CUDA
events around the benchmark's call into that layer in the staged loop (the
program's forward, layer by layer, with no synchronise between calls), the
mean over the loop."""


def read(ctx):
    return ctx.stages.get("cam")
