"""Where the time goes in the pseudo-label factory, in a training step or
in the evaluation of one native-resolution batch, on one card.

    python -m dupl_tpu_torch.engine.profile
        [--path pseudo_label|train|serve|eval]
        [--batch N] [--crop 448] [--phase full] [--image-size 375 500]
        [--transfer-dtype uint8|float32]
        [--compute-dtype bfloat16|float16|float32] [--out build/profile]

``--path pseudo_label`` (the default, batch 16) builds ``voc_config()``'s
ViT-B/16 dual student from seed 0 and feeds ``make_pseudo_label_fn`` the
synthetic inputs of :func:`pseudo_label_inputs`.  After two warm-up calls it
prints:

* the wall time of five calls (median) and the host CPU time of one;
* one call traced with ``torch.profiler``: its wall time, the device's busy
  time (the union of the kernel, copy and memset intervals in the trace),
  the device's idle share of the call, and the kernels by device time;
* the stages timed with CUDA events, each run on its own: the multi-scale
  CAM of each student, the PAR refinement of both, the fast CRF.

``--path train`` (batch 4) builds the production training recipe
(``engine.train.production_config``), seeded weights and one synthetic batch,
takes two untimed ``Trainer.train_step`` calls in ``--phase`` and prints the
same three things for a step: wall times of five steps and the host CPU time
of one; one traced step (device busy time, idle share, kernels by device
time); and the step's stages from CUDA events recorded where each stage's
work has been queued (``Trainer.stage_hook``), so a stage's time includes
any wait of the device for the host inside it.

``--path serve`` (batch 8) builds the same model behind
``InferenceSession.from_model`` (scales 1.0 / 1.5 / 1.25 x flip, max merge,
ensemble, fast CRF: the serving program) and times one dispatch of
``--batch`` blob images of varied sizes (``serve_images``): the host's
resize to the crop and back and the device's program.  It prints the same
wall, host CPU, traced and kernel figures for a dispatch.

``--path eval`` (batch 8) writes a synthetic VOC-structured tree of
``--batch`` JPEGs of ``--image-size`` (height, width; 375 x 500 is VOC's most
common, 500 x 500 reaches 2117 tokens at scale 1.5 and with them the flash
kernel) and runs ``SegEvaluator.run`` of the VOC protocol (native
resolution, scales 1.0 / 1.5 / 1.25 x flip, max merge, device CRF) over
that one batch: both passes, each recomputing the forward.  It prints the
same wall, host CPU, traced and kernel figures for the run, and the stages:
JPEG and PNG decode on the host, the copy to the device, the forward of each
scale, the argmax and the copy of the uint8 labels, the padded mean-field
CRF, and the histograms on the host.  ``--transfer-dtype float32`` reads
the images in the reference's wire format (host-normalised float32, four
times the bytes of the default uint8) to weigh the copy to the device
(the question of the JAX package's ``tools/val_feed_experiment.py``).

``--compute-dtype`` sets the model's compute dtype on the pseudo-label and
serving paths (the recipe's ``bfloat16`` by default; PAR keeps its own
dtype), so that two dtypes' kernel tables can be set side by side.

The trace goes to ``<out>/<path>_trace.json`` (open it in Perfetto), and the
last line of the output is a JSON summary.
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


def serve_images(n: int, seed: int):
    """``n`` uint8 blob images (h, w, 3) of VOC-like sizes, cycling through
    375 x 500, 500 x 333, 448 x 448 and 333 x 500."""
    sizes = [(375, 500), (500, 333), (448, 448), (333, 500)]
    r = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        blocks = r.rand(6, 8, 3)
        img = np.kron(blocks, np.ones((h // 6 + 1, w // 8 + 1, 1)))[:h, :w]
        img = np.clip(img + 0.05 * r.rand(h, w, 3), 0, 1)
        out.append((img * 255).round().astype(np.uint8))
    return out


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


def measure(call, trace_path: str) -> Tuple[dict, Dict[str, list]]:
    """Five timed calls, the host CPU time of one and one traced call of
    ``call`` (already warmed up) -> (summary fields, kernel table)."""
    import torch

    walls = []
    for _ in range(5):
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t))
    cpu0 = time.process_time()
    call()
    torch.cuda.synchronize()
    host_cpu_ms = 1e3 * (time.process_time() - cpu0)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        call()
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t)
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    busy_us, first, last = device_busy_us(events)
    return {
        "wall_ms_median_of_5": statistics.median(walls),
        "wall_ms": walls, "host_cpu_ms": host_cpu_ms,
        "traced_wall_ms": traced_ms, "device_busy_ms": busy_us / 1e3,
        "device_span_ms": (last - first) / 1e3,
        # tracing slows the host; where the host is the bound, the traced
        # call is longer than an untraced one and its idle share larger
        "device_idle_share": 1.0 - busy_us / 1e3 / traced_ms,
        "device_busy_share_of_untraced_wall":
            busy_us / 1e3 / statistics.median(walls),
    }, kernel_table(events)


def report(summary: dict, kernels: Dict[str, list], trace_path: str) -> None:
    print("kernels by device time (ms, launches):")
    for name, (ms, n) in kernels.items():
        print(f"  {ms:9.3f} {n:5d}  {name}")
    print(f"trace: {trace_path}")
    print(json.dumps(summary), flush=True)


def stage_ms(stage, reps: int = 3) -> float:
    """Median device time of ``stage()`` from CUDA events, each run on its
    own."""
    import torch

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


def host_ms(stage, reps: int = 3) -> float:
    """Median wall time of a host-only ``stage()``."""
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        stage()
        out.append(1e3 * (time.perf_counter() - t))
    return statistics.median(out)


def profile_eval(args, trace_path: str) -> None:
    import torch

    from dupl_tpu_torch.config import voc_config
    from dupl_tpu_torch.data.voc import VocSegDataset, write_synthetic_voc
    from dupl_tpu_torch.engine.eval_seg import (SegEvaluator, _pad_edge,
                                                msc_seg_logits)
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.ops import attention
    from dupl_tpu_torch.ops import crf as crf_ops
    from dupl_tpu_torch.ops import image as image_ops
    from dupl_tpu_torch.utils.metrics import add_hist

    dev = torch.device("cuda:0")
    cfg = voc_config()
    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev).eval()
    size = tuple(args.image_size)
    root, lists = write_synthetic_voc(
        os.path.join(args.out, f"eval_tree_{size[0]}x{size[1]}"),
        [size] * args.batch, seed=0)
    ds = VocSegDataset(root, lists, "val", transfer_dtype=args.transfer_dtype)
    scales = (1.0, 1.5, 1.25)
    ev = SegEvaluator(cfg, model, scales=scales, merge="max",
                      input_mode="native")

    def run():
        return ev.run(ds, batch_size=args.batch, crf="device")

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the stages first: once the profiler has run, its tracing library stays
    # loaded and every later launch costs the host more
    stages = {"host_decode": host_ms(
        lambda: [ds[i] for i in range(args.batch)])}
    samples = [ds[i] for i in range(args.batch)]
    stack = np.stack([s["image"] for s in samples])
    stages["copy_to_device"] = stage_ms(
        lambda: torch.from_numpy(stack).to(dev))
    imgs = torch.from_numpy(stack).to(dev)
    attention_kernel = {}       # which attention kernel each scale's views take
    with torch.inference_mode():
        x, image01 = image_ops.prepare_inputs(imgs)
        for sc in scales:
            launches = attention.flash_attention_cuda.launches
            stages[f"forward_scale_{sc}"] = stage_ms(lambda: msc_seg_logits(
                lambda both: model(both).seg, x, size, (sc,), "max",
                batch_dims=2))
            attention_kernel[str(sc)] = (
                "flash_attention" if attention.flash_attention_cuda.launches
                > launches else "exp_attention")
        logits = ev.msc_logits(imgs)
        stages["argmax_and_copy"] = stage_ms(
            lambda: logits.argmax(dim=-1).to(torch.uint8).cpu())
        labels = logits.argmax(dim=-1).to(torch.uint8).cpu().numpy()
        ph, pw = -(-size[0] // 8) * 8, -(-size[1] // 8) * 8

        def crf_stage():
            probs = torch.softmax(_pad_edge(logits[0].float(), ph, pw), -1)
            refined = crf_ops.crf_from_config(_pad_edge(image01, ph, pw),
                                              probs, cfg.crf)
            return refined[:, :size[0], :size[1]].argmax(dim=-1).to(
                torch.uint8).cpu()

        stages["crf_and_copy"] = stage_ms(crf_stage)
    hist = np.zeros((cfg.num_classes, cfg.num_classes), np.float64)
    stages["host_histograms"] = host_ms(lambda: [
        add_hist(hist, s["label"], labels[k, i])
        for i, s in enumerate(samples) for k in (0, 1)])

    summary, kernels = measure(run, trace_path)
    wall = summary["wall_ms_median_of_5"]
    summary = {"device": torch.cuda.get_device_name(0), "path": "eval",
               "batch": args.batch, "image_size": list(size),
               "transfer_dtype": args.transfer_dtype,
               "tokens_per_scale": [
                   (int(size[0] * sc) // 16) * (int(size[1] * sc) // 16) + 1
                   for sc in scales],
               **summary, "img_per_s": 1e3 * args.batch / wall,
               "stages_ms": stages, "attention_kernel": attention_kernel,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    report(summary, kernels, trace_path)


def profile_train(args, trace_path: str) -> None:
    import torch

    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.engine.train import (Trainer, phase_start,
                                             production_config)

    cfg = production_config("voc")
    trainer = Trainer(cfg, device="cuda:0")
    state = trainer.init_state()
    state.step = state.optimizer.global_step = phase_start(cfg, args.phase)
    batch = trainer.put(synthetic_batch(args.batch, crop=args.crop,
                                        num_fg=cfg.model.num_fg))

    def step():
        trainer.train_step(state, batch)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the stages first: once the profiler has run, its tracing library stays
    # loaded and every later launch costs the host more
    stage_runs = []
    for _ in range(3):
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def hook(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

        trainer.stage_hook = hook
        step()
        trainer.stage_hook = None
        torch.cuda.synchronize()
        stage_runs.append({name: a.elapsed_time(b) for (_, a), (name, b)
                           in zip(marks, marks[1:])})
    summary, kernels = measure(step, trace_path)
    stages = {name: statistics.median(r[name] for r in stage_runs)
              for name in stage_runs[0]}
    summary = {"device": torch.cuda.get_device_name(0), "path": "train",
               "phase": args.phase, "batch": args.batch, "crop": args.crop,
               **summary, "stages_ms": stages,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    report(summary, kernels, trace_path)


def profile_pseudo_label(args, trace_path: str) -> None:
    import torch

    from dupl_tpu_torch.config import ModelConfig, voc_config
    from dupl_tpu_torch.engine import train
    from dupl_tpu_torch.engine.export import make_pseudo_label_fn
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent
    from dupl_tpu_torch.ops import cam as cam_ops
    from dupl_tpu_torch.ops import crf as crf_ops
    from dupl_tpu_torch.ops import image as image_ops

    dev = torch.device("cuda:0")
    cfg = voc_config(model=ModelConfig(compute_dtype=args.compute_dtype))
    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    model.to(dev)
    fn = make_pseudo_label_fn(cfg, model)
    call_args = tuple(torch.from_numpy(a).to(dev) for a in
                      pseudo_label_inputs(args.batch, args.crop, seed=1))
    for _ in range(2):
        fn(*call_args)
    torch.cuda.synchronize()

    summary, kernels = measure(lambda: fn(*call_args), trace_path)

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

    summary = {"device": torch.cuda.get_device_name(0),
               "path": "pseudo_label", "batch": args.batch, "crop": args.crop,
               "compute_dtype": args.compute_dtype,
               **summary, "stages_ms": stages,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    report(summary, kernels, trace_path)


def profile_serve(args, trace_path: str) -> None:
    import torch

    from dupl_tpu_torch.config import ModelConfig, voc_config
    from dupl_tpu_torch.engine.serve import InferenceSession
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent

    dev = torch.device("cuda:0")
    cfg = voc_config(model=ModelConfig(compute_dtype=args.compute_dtype))
    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    session = InferenceSession.from_model(
        cfg, model, device=dev, batch_size=args.batch,
        scales=(1.0, 1.5, 1.25), merge="max", branch="ensemble", crf=True)
    images = serve_images(args.batch, seed=2)
    for _ in range(2):
        session.predict(images)
    torch.cuda.synchronize()
    summary, kernels = measure(lambda: session.predict(images), trace_path)
    summary = {"device": torch.cuda.get_device_name(0), "path": "serve",
               "batch": args.batch, "crop": cfg.data.crop_size,
               "compute_dtype": args.compute_dtype, **summary,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    report(summary, kernels, trace_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", default="pseudo_label",
                    choices=("pseudo_label", "train", "serve", "eval"))
    ap.add_argument("--batch", type=int, default=None,
                    help="default: 16 for pseudo_label, 4 for train, 8 for "
                         "serve and eval")
    ap.add_argument("--crop", type=int, default=448)
    ap.add_argument("--phase", default="full",
                    choices=("warmup", "seg", "full"),
                    help="the curriculum phase of --path train")
    ap.add_argument("--image-size", type=int, nargs=2, default=(375, 500),
                    metavar=("H", "W"),
                    help="the images of --path eval (height, width)")
    ap.add_argument("--transfer-dtype", default="uint8",
                    choices=("uint8", "float32"),
                    help="the image wire format of --path eval")
    ap.add_argument("--compute-dtype", default="bfloat16",
                    choices=("bfloat16", "float16", "float32"),
                    help="the model's compute dtype of --path pseudo_label "
                         "and serve")
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = {"pseudo_label": 16, "train": 4, "serve": 8,
                      "eval": 8}[args.path]

    import torch

    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    trace_path = os.path.join(args.out, f"{args.path}_trace.json")
    {"pseudo_label": profile_pseudo_label, "train": profile_train,
     "serve": profile_serve, "eval": profile_eval}[args.path](args, trace_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
