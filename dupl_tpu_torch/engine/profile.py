"""Where the time goes in the pseudo-label factory, on one card.

    python -m dupl_tpu_torch.engine.profile [--batch 16] [--crop 448]
                                            [--out build/profile]

Builds ``voc_config()``'s ViT-B/16 dual student from seed 0 and feeds
``make_pseudo_label_fn`` the synthetic inputs of :func:`pseudo_label_inputs`.
After two warm-up calls it prints:

* the wall time of five calls (median) and the host CPU time of one;
* one call traced with ``torch.profiler``: its wall time, the device's busy
  time (the union of the kernel, copy and memset intervals in the trace),
  the device's idle share of the call, and the kernels by device time;
* the stages timed with CUDA events, each run on its own: the multi-scale
  CAM of each student, the PAR refinement of both, the fast CRF.

The trace goes to ``<out>/pseudo_label_trace.json`` (open it in Perfetto),
and the last line of the output is a JSON summary.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time
from typing import Dict, Iterable, Tuple

import numpy as np

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def pseudo_label_inputs(n: int, size: int, seed: int):
    """Blob images (8 x 8 colour blocks plus noise) as uint8 (n, size,
    size, 3), 1-3 present classes of 20 per image as float32 multi-hot, and
    int32 boxes (top, bottom, left, right): even images full, odd ones
    partial."""
    r = np.random.RandomState(seed)
    blocks = r.rand(n, 8, 8, 3)
    img = np.kron(blocks, np.ones((1, size // 8, size // 8, 1)))
    img = np.clip(img + 0.05 * r.rand(n, size, size, 3), 0, 1)
    cls = np.zeros((n, 20), np.float32)
    for i in range(n):
        cls[i, r.choice(20, r.randint(1, 4), replace=False)] = 1
    box = np.tile(np.asarray([[0, size, 0, size]], np.int32), (n, 1))
    box[1::2] = [size // 28, size - size // 28, size // 56, size - size // 56]
    return (img * 255).round().astype(np.uint8), cls, box


def device_busy_us(events: Iterable[dict]) -> Tuple[float, float, float]:
    """Chrome-trace events -> (busy, first start, last end) in us: busy is
    the length of the union of the device intervals (kernels, copies,
    memsets), so overlapping streams are not counted twice."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS)
    if not spans:
        return 0.0, 0.0, 0.0
    busy, (cur_a, cur_b) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return busy + cur_b - cur_a, spans[0][0], cur_b


def kernel_table(events: Iterable[dict], top: int = 15) -> Dict[str, list]:
    """Device time and count per kernel name (its first 90 characters:
    template instances that share them are summed), the ``top`` largest."""
    tot, cnt = collections.Counter(), collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            tot[e["name"][:90]] += e["dur"]
            cnt[e["name"][:90]] += 1
    return {name: [round(us / 1e3, 3), cnt[name]]
            for name, us in tot.most_common(top)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--crop", type=int, default=448)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    from dupl_tpu_torch.config import voc_config
    from dupl_tpu_torch.engine import train
    from dupl_tpu_torch.engine.export import make_pseudo_label_fn
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.ops import cam as cam_ops
    from dupl_tpu_torch.ops import crf as crf_ops
    from dupl_tpu_torch.ops import image as image_ops

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = voc_config()
    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev)
    fn = make_pseudo_label_fn(cfg, model)
    call_args = tuple(torch.from_numpy(a).to(dev) for a in
                      pseudo_label_inputs(args.batch, args.crop, seed=1))
    for _ in range(2):
        fn(*call_args)
    torch.cuda.synchronize()

    walls = []
    for _ in range(5):
        t = time.perf_counter()
        fn(*call_args)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    cpu0 = time.process_time()
    fn(*call_args)
    torch.cuda.synchronize()
    host_cpu_ms = 1e3 * (time.process_time() - cpu0)

    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, "pseudo_label_trace.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn(*call_args)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    busy_us, first, last = device_busy_us(events)
    kernels = kernel_table(events)

    def stage_ms(stage, reps=3):
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            stage()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    images, cls_label, img_box = call_args
    with torch.inference_mode():
        x, image01 = image_ops.prepare_inputs(images)
        merge = (x.shape[1] // 2, x.shape[2] // 2)
        cams, segs, stages = [], [], {}
        for i in range(2):
            s = model.student(i)

            def cam_stage(s=s):
                return cam_ops.multi_scale_cam_with_outputs(
                    s.forward_with_cams, s.cam_only, x, cfg.cam_scales,
                    with_aux=False, merge_size=merge)

            stages[f"cam_student{i + 1}"] = stage_ms(cam_stage)
            cam, _, out = cam_stage()
            cams.append(cam)
            segs.append(out.seg)
        cams = torch.stack(cams)
        stages["refine"] = stage_ms(lambda: train.refine(
            cfg, cams, image01, cls_label, img_box, high_thre=cfg.high_thre))
        probs = torch.softmax(
            image_ops.resize_bilinear(segs[0], x.shape[1:3]), -1)
        stages["crf"] = stage_ms(lambda: crf_ops.crf_from_config(
            image01, probs, cfg.crf, fast=True, return_logits=True))

    summary = {
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch, "crop": args.crop,
        "wall_ms_median_of_5": statistics.median(walls),
        "wall_ms": walls, "host_cpu_ms": host_cpu_ms,
        "traced_wall_ms": traced_ms, "device_busy_ms": busy_us / 1e3,
        "device_span_ms": (last - first) / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / traced_ms,
        "stages_ms": stages,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print("kernels by device time (ms, launches):")
    for name, (ms, n) in kernels.items():
        print(f"  {ms:9.3f} {n:5d}  {name}")
    print(f"trace: {trace_path}")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
