"""On-card smoke run of the PyTorch port's serving path (dupl_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the CUDA toolkit) and this checkout; imports no
JAX.  Phases, each printing one result line:

1. device: the card, its power limit, TF32 off for matmuls and convolutions;
2. build: both CUDA kernels compiled from dupl_tpu_torch/csrc for sm_90a;
3. K1 (exp-attention) against its plain twin on the card, bf16, at the
   serving path's token counts and one case with logits past the clamp;
4. K5 (CRF kernel-apply) against its plain twin at the fast CRF's
   full-resolution slice (2 images of 448^2, 3,136 pivots, V = 22 and 1);
5. the slice: a ViT-B/16 dual student (VOC, 21 classes, crop 448, weights
   from seed 0) behind the batched HTTP server; 16 concurrent clients POST
   JPEG/PNG images of varied sizes, twice (the second round is measured);
   every answer must be a 200 label map of the input's size, and both
   kernels must have launched in the measured round;
6. the same model at crop 224, batch 1, on the card and on the CPU (plain
   paths): ensemble logits before the CRF, and the CRF labels, must agree.

Then a JSON line with every kernel's launches, error and times, and last
``{"ok": true, "device": {...}}``.  Any failed phase raises: the script
exits non-zero and prints no result.  Without a CUDA device it exits 2.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor


def check(cond: bool, msg: str) -> None:
    """Fail the phase (asserts vanish under ``python -O``; this does not)."""
    if not cond:
        raise RuntimeError(msg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2

    import numpy as np

    from dupl_tpu_torch.kernels import build
    from dupl_tpu_torch.ops import attention, crf, crf_cuda

    dev = torch.device("cuda:0")

    # -- 1. device -------------------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | tf32 off",
          flush=True)

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all(verbose=True)
    print(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"total {time.perf_counter() - t0:.2f} s", flush=True)

    def time_ms(fn, iters=10, warmup=2):
        """Median per-call device time from CUDA events."""
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def bf16_ulp(x):
        return torch.exp2(torch.floor(torch.log2(
            x.clamp_min(torch.finfo(torch.float32).tiny))) - 7)

    # -- 3. K1 against its twin ----------------------------------------------------
    # Tolerance: one bf16 ulp at the scale of each output row (max |out| over
    # the head dim).  Kernel and twin round the same fp32 quantities to bf16;
    # their fp32 sums run in different orders, which can flip the rounding of
    # a bf16(e) entry, and an element that nearly cancels carries that error
    # at its row's scale.
    g = torch.Generator(device=dev).manual_seed(0)
    k1 = {"err": 0.0, "ms": {}, "plain_ms": {}}
    cases = [(2, 197, 1.0), (2, 785, 1.0), (2, 1226, 1.0), (2, 1765, 1.0),
             (2, 785, 40.0),               # logits far past the clamp at 60
             (16, 785, 1.0), (16, 1226, 1.0), (16, 1765, 1.0)]  # batch-8 x flip
    for b, n, mult in cases:
        q, k, v = (torch.randn(b, n, 12, 64, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        q = (q.float() * mult).to(torch.bfloat16)
        qs = (q * torch.tensor(0.125, dtype=torch.bfloat16, device=dev))

        def bhnd(x):
            return x.permute(0, 2, 1, 3).reshape(b * 12, n, 64)

        got = attention.exp_attention_cuda(qs, k, v)
        torch.cuda.synchronize()
        want = attention.exp_attention_ref(bhnd(qs), bhnd(k), bhnd(v)).to(
            torch.bfloat16).float()
        want = want.reshape(b, 12, n, 64).permute(0, 2, 1, 3)
        err = (got.float() - want).abs()
        bound = bf16_ulp(want.abs().amax(-1, keepdim=True))
        check(bool(torch.isfinite(got.float()).all()), f"K1 N={n}: non-finite")
        check(bool((err <= bound).all()),
              f"K1 B={b} N={n} x{mult}: error {err.max().item():.3g} exceeds "
              f"one bf16 ulp of its row ({(err / bound).max().item():.2f} ulp)")
        k1["err"] = max(k1["err"], err.max().item())
        if mult == 1.0:
            key = f"BH={b * 12},N={n}"
            k1["ms"][key] = time_ms(lambda: attention.exp_attention_cuda(qs, k, v))
            k1["plain_ms"][key] = time_ms(lambda: attention.exp_attention_ref(
                bhnd(qs), bhnd(k), bhnd(v)).to(torch.bfloat16))
        del q, k, v, qs, got, want, err, bound
    print(f"[K1 exp_attention] max_abs_err {k1['err']:.4g} (bound: 1 bf16 ulp "
          f"of the row) | kernel ms {json.dumps(k1['ms'])} | plain ms "
          f"{json.dumps(k1['plain_ms'])}", flush=True)

    # -- 4. K5 against its twin ----------------------------------------------------
    # Inputs are the fast CRF's own: the pivot lattice of two smooth 448^2
    # images and value columns like the final slice's (21 class columns plus
    # the cell count).  Tolerance: 2e-3 of each output column's scale; kernel
    # entries are rounded to bf16 (2^-8), and a different fp32 summation order
    # of the 11-wide score can flip that rounding for an entry.
    yy, xx = torch.meshgrid(torch.linspace(0, 1, 448, device=dev),
                            torch.linspace(0, 1, 448, device=dev),
                            indexing="ij")
    img = torch.stack([torch.sin(6 * xx) * 0.5 + 0.5, yy, xx * yy], -1)
    img = torch.stack([img, img.flip(0)])
    img = (img + 0.03 * torch.randn(img.shape, generator=g, device=dev)).clamp(0, 1)
    basis, coef, logc, _, _ = crf.pivot_lattice(img, 8, 121.0, 5.0)
    k5 = {"err": 0.0, "ms": {}, "plain_ms": {}}
    for nv in (22, 1):
        vals = torch.rand(2, coef.shape[2], nv, generator=g, device=dev) * 2.0
        vals[..., -1] = 64.0
        got = crf_cuda.kernel_apply_cuda(basis, coef, logc, vals)
        torch.cuda.synchronize()
        want = crf_cuda.kernel_apply_ref(basis, coef, logc, vals)
        err = (got - want).abs()
        scale = want.abs().amax(dim=(0, 1))
        check(bool(torch.isfinite(got).all()), f"K5 V={nv}: non-finite")
        check(bool((err.amax(dim=(0, 1)) <= 2e-3 * scale).all()),
              f"K5 V={nv}: error {err.max().item():.3g} exceeds 2e-3 of the "
              f"column scale")
        k5["err"] = max(k5["err"], err.max().item())
        key = f"B=2,N={basis.shape[1]},Ns={coef.shape[2]},V={nv}"
        k5["ms"][key] = time_ms(
            lambda: crf_cuda.kernel_apply_cuda(basis, coef, logc, vals))
        k5["plain_ms"][key] = time_ms(
            lambda: crf_cuda.kernel_apply_ref(basis, coef, logc, vals))
    del basis, coef, logc, vals, got, want, err
    print(f"[K5 crf_apply] max_abs_err {k5['err']:.4g} (bound: 2e-3 of the "
          f"column) | kernel ms {json.dumps(k5['ms'])} | plain ms "
          f"{json.dumps(k5['plain_ms'])}", flush=True)

    # -- 5. the slice ------------------------------------------------------------
    from PIL import Image

    from dupl_tpu_torch.config import voc_config
    from dupl_tpu_torch.engine.serve import (Batcher, InferenceSession,
                                             make_http_server)
    from dupl_tpu_torch.models.convert import init_weights
    from dupl_tpu_torch.models.network import DualStudent

    cfg = voc_config()   # deit_base_patch16, 21 classes, crop 448, bf16 compute
    check(cfg.model.backbone == "deit_base_patch16"
          and cfg.data.crop_size == 448 and cfg.num_classes == 21,
          "voc_config() is not the ViT-B/16 VOC recipe")
    t0 = time.perf_counter()
    model = DualStudent(cfg.model)
    init_weights(model, torch.Generator().manual_seed(0))
    session = InferenceSession.from_model(
        cfg, model, device=dev, batch_size=8, scales=(1.0, 1.5, 1.25),
        merge="max", branch="ensemble", crf=True)
    batcher = Batcher(session, max_delay_s=0.05)
    batcher.submit(np.zeros((64, 64, 3), np.uint8)).result(timeout=600)
    setup_s = time.perf_counter() - t0

    rs = np.random.RandomState(0)
    sizes = [(375, 500), (500, 333), (281, 500), (448, 448), (333, 500),
             (500, 375), (120, 160), (480, 640), (366, 500), (500, 400),
             (224, 300), (375, 500), (400, 300), (500, 500), (260, 390),
             (338, 450)]
    bodies = []
    for i, (h, w) in enumerate(sizes):
        yy_, xx_ = np.mgrid[0:h, 0:w]
        arr = np.stack([(xx_ * (1 + i)) % 256, (yy_ * 3) % 256,
                        ((xx_ + yy_) // 4) % 256], -1).astype(np.float32)
        arr[h // 4:h // 2, w // 3:2 * w // 3] = rs.randint(0, 256, 3)
        arr = np.clip(arr + rs.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        fmt = "JPEG" if i % 2 == 0 else "PNG"
        Image.fromarray(arr).save(buf, format=fmt)
        bodies.append((buf.getvalue(), f"image/{fmt.lower()}", (h, w)))

    server = make_http_server(batcher, "127.0.0.1", 0)
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}/v1/segment"

    def post(item):
        body, ctype, hw = item
        req = urllib.request.Request(url, data=body, method="POST", headers={
            "Content-Type": ctype, "Accept": "application/x-npy"})
        t = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            status, blob = r.status, r.read()
        return status, np.load(io.BytesIO(blob)), hw, time.perf_counter() - t

    def http_round():
        """All requests at once from concurrent clients; every answer must
        be a 200 label map of its input's size with VOC labels."""
        t = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            results = list(pool.map(post, bodies))
        wall = time.perf_counter() - t
        for status, lab, hw, _ in results:
            check(status == 200, f"HTTP {status}")
            check(lab.shape == hw, f"label map {lab.shape} for an image of {hw}")
            check(lab.dtype == np.uint8 and int(lab.max()) <= 20,
                  f"labels out of range: max {lab.max()}")
        return sorted(r[3] for r in results), wall

    try:
        # the first round through the HTTP stack pays one-time host costs
        # (~0.5 s before the first decode finishes); the second is measured
        http_round()
        before = batcher.stats()
        attention.exp_attention_cuda.launches = 0
        crf_cuda.kernel_apply_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        lat, wall = http_round()
        launches = {"exp_attention": attention.exp_attention_cuda.launches,
                    "crf_apply": crf_cuda.kernel_apply_cuda.launches}
        after = batcher.stats()
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        srv_thread.join(timeout=10)
    check(launches["exp_attention"] > 0 and launches["crf_apply"] > 0,
          f"a kernel of the path never launched: {launches}")
    dispatches = after["dispatches"] - before["dispatches"]
    dispatch_ms = 1e3 * (after["dispatch_seconds"]
                         - before["dispatch_seconds"]) / dispatches
    print(f"[slice] ViT-B/16 dual student, crop 448, batch 8, MSC 1.0/1.5/1.25 "
          f"x flip, ensemble, fast CRF | {len(lat)} requests all 200 (second "
          f"round) | {len(lat) / wall:.3f} img/s | p50 latency "
          f"{1e3 * statistics.median(lat):.1f} ms | max latency "
          f"{1e3 * lat[-1]:.1f} ms | dispatches {dispatches}, "
          f"{dispatch_ms:.1f} ms each | peak memory {peak / 2**30:.3f} GiB | "
          f"launches {json.dumps(launches)} | setup {setup_s:.1f} s",
          flush=True)

    # -- 6. card against CPU -------------------------------------------------------
    # Same weights, crop 224, batch 1.  The card runs K1 (max-free exp softmax,
    # bf16 probabilities) and K5; the CPU runs exact softmax and the plain CRF
    # tile loop; both compute in bf16 as the recipe says, rounding at slightly
    # different places.  Bounds: ensemble logits within 5e-2 of their scale;
    # labels before and after the CRF at least 98% equal.
    from dupl_tpu_torch.engine.eval_seg import msc_seg_logits
    from dupl_tpu_torch.ops import image as image_ops

    img224 = np.array(Image.open(io.BytesIO(bodies[0][0])).convert("RGB")
                      .resize((224, 224), Image.BILINEAR))[None]

    def forward(device):
        m = model.to(device)
        x, image01 = image_ops.prepare_inputs(torch.from_numpy(img224).to(device))
        with torch.inference_mode():
            seg = msc_seg_logits(lambda z: m(z).seg, x, (224, 224),
                                 (1.0, 1.5, 1.25), "max", batch_dims=2)
            logits = seg.mean(0)
            lab = crf.crf_from_config(image01, torch.softmax(logits, -1),
                                      cfg.crf, fast=True,
                                      return_logits=True).argmax(-1)
        return logits.float().cpu(), lab.cpu()

    attention.exp_attention_cuda.launches = 0
    g_logits, g_lab = forward(dev)
    check(attention.exp_attention_cuda.launches > 0,
          "the card forward did not run K1")
    c_logits, c_lab = forward(torch.device("cpu"))
    err = (g_logits - c_logits).abs().max().item()
    scale = c_logits.abs().max().item()
    raw_agree = (g_logits.argmax(-1) == c_logits.argmax(-1)).float().mean().item()
    crf_agree = (g_lab == c_lab).float().mean().item()
    check(bool(torch.isfinite(g_logits).all()), "non-finite logits on the card")
    check(err <= 5e-2 * scale, f"card vs CPU logits: {err:.4g} > 5e-2 x {scale:.4g}")
    check(raw_agree >= 0.98 and crf_agree >= 0.98,
          f"card vs CPU label agreement {raw_agree:.4f} / CRF {crf_agree:.4f}")
    print(f"[card vs cpu] crop 224 batch 1 | logits max abs err {err:.4g} "
          f"(scale {scale:.4g}, bound 5e-2 of it) | argmax agreement "
          f"{raw_agree:.4f} | CRF label agreement {crf_agree:.4f}", flush=True)

    kernels = [
        {"name": "exp_attention", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/exp_attention.cu",
         "replaces": "dupl_tpu/ops/attention.py:98",
         "launches": launches["exp_attention"],
         "max_abs_err": k1["err"],
         "ms": k1["ms"]["BH=192,N=1765"],
         "plain_ms": k1["plain_ms"]["BH=192,N=1765"]},
        {"name": "crf_apply", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/crf_apply.cu",
         "replaces": "dupl_tpu/ops/crf_pallas.py:30",
         "launches": launches["crf_apply"],
         "max_abs_err": k5["err"],
         "ms": k5["ms"]["B=2,N=200704,Ns=3136,V=22"],
         "plain_ms": k5["plain_ms"]["B=2,N=200704,Ns=3136,V=22"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
