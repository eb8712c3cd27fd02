"""On-card smoke run of the PyTorch port (dupl_tpu_torch): the serving path
and the pseudo-label path.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the CUDA toolkit) and this checkout; imports no
JAX.  Phases, each printing one result line:

1. device: the card, its power limit, TF32 off for matmuls and convolutions;
2. build: every CUDA kernel compiled from dupl_tpu_torch/csrc for sm_90a,
   one nvcc per source, all at once;
3. K1 (exp-attention) against its plain twin on the card, bf16, at the
   serving path's token counts and one case with logits past the clamp;
4. K5 (CRF kernel-apply) against its plain twin at the fast CRF's
   full-resolution slice (2 images of 448^2, 3,136 pivots, V = 22 and 1);
5. the serving slice: a ViT-B/16 dual student (VOC, 21 classes, crop 448,
   weights from seed 0) behind the batched HTTP server; 16 concurrent
   clients POST JPEG/PNG images of varied sizes, twice (the second round is
   measured); every answer must be a 200 label map of the input's size, and
   both kernels must have launched in the measured round;
6. the same model at crop 224, batch 1, on the card and on the CPU (plain
   paths): ensemble logits before the CRF, and the CRF labels, must agree;
7. K3 (PAR affinity) against its plain twin at (16, 224, 224, 3): smooth,
   noisy and uint8-quantised images, and a ragged small case;
8. K4 (PAR propagation) against its plain twin at 16 x 224^2, 10 rounds:
   C = 40 in fp32 and bf16, C = 84 in fp32, and a ragged case;
9. the pseudo-label slice: ``make_pseudo_label_fn`` with the same model at
   batch 16, crop 448 (multi-scale CAM of both students, PAR, fast CRF):
   two warm-up calls, five timed calls; well-formed labels, and K1, K3, K4
   and K5 launched in the timed calls; then one call past the class budget,
   which must launch K4 at full width and match the timed call's labels on
   the images it shares with it;
10. the pseudo-label path at crop 224, batch 2, on the card and on the CPU,
   within the class budget and past it: refined and CRF labels must agree.

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
    from dupl_tpu_torch.ops import attention, crf, crf_cuda, par_cuda

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

    # -- 7. K3 against its twin ------------------------------------------------------
    # Tolerance: 1e-5 absolute on values in [0, 1.01].  Kernel and twin run
    # the same fp32 operations in the same order (the kernel's sums use
    # __fmul_rn/__fadd_rn, so nvcc cannot contract them), so even where var =
    # sum x^2 - K mean^2 cancels on a flat neighbourhood they round alike;
    # only exp and the order of the softmax sum differ, by ulps.  The bound
    # sits well below the position term (up to ~8e-4 a tap), so a kernel
    # with a wrong w2 or misplaced position constants fails.
    b7, h7 = 16, 224
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h7, device=dev),
                            torch.linspace(0, 1, h7, device=dev), indexing="ij")
    smooth = torch.stack([0.5 + 0.4 * torch.sin(5 * xx + 3 * yy), yy,
                          0.3 + 0.5 * xx * yy], -1).expand(b7, h7, h7, 3)
    smooth = (smooth + 0.002 * torch.randn(b7, h7, h7, 3, generator=g,
                                           device=dev)).clamp(0, 1)
    images7 = {
        "smooth": smooth.contiguous(),
        "noisy": torch.rand(b7, h7, h7, 3, generator=g, device=dev),
        "uint8": (smooth * 255).round() / 255,
        "ragged": torch.rand(3, 37, 53, 3, generator=g, device=dev),
    }
    k3 = {"err": 0.0, "ms": {}, "plain_ms": {}}
    for name, img in images7.items():
        got = par_cuda.affinity_cuda(img)
        torch.cuda.synchronize()
        want = par_cuda.affinity_ref(img)
        err = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"K3 {name}: non-finite")
        check(err <= 1e-5, f"K3 {name}: error {err:.3g} exceeds 1e-5")
        k3["err"] = max(k3["err"], err)
        if name != "ragged":
            k3["ms"][name] = time_ms(lambda: par_cuda.affinity_cuda(img))
            k3["plain_ms"][name] = time_ms(lambda: par_cuda.affinity_ref(img))
    aff40 = par_cuda.affinity_cuda(images7["uint8"])    # feeds phase 8
    del images7, smooth, got, want
    print(f"[K3 par_affinity] max_abs_err {k3['err']:.4g} (bound 1e-5) | B=16, "
          f"224^2, 48 taps | kernel ms {json.dumps(k3['ms'])} | plain ms "
          f"{json.dumps(k3['plain_ms'])}", flush=True)

    # -- 8. K4 against its twin ------------------------------------------------------
    # Peaked posteriors (softmax of 3x Gaussian logits) over the uint8 image's
    # affinity, 10 rounds.  fp32: within 1e-5 of the output's scale (kernel
    # FMAs against the twin's separate multiply and add).  bf16: within two
    # bf16 ulps of each element.  Kernel and twin round every product and
    # partial sum to bf16 alike; a kernel that skips the rounding of the
    # staged mask, of the products or of the group sums lands 3-17 ulps
    # away after 10 rounds (simulated on the CPU twin).
    k4 = {"err": {}, "ms": {}, "plain_ms": {}}
    ragged_img = torch.rand(3, 37, 53, 3, generator=g, device=dev)
    for c, cdt, img_aff in ((40, "float32", aff40), (40, "bfloat16", aff40),
                            (84, "float32", aff40),
                            (5, "float32", par_cuda.affinity_cuda(ragged_img))):
        shape = (img_aff.shape[0], img_aff.shape[2], img_aff.shape[3], c)
        masks = torch.softmax(3 * torch.randn(shape, generator=g, device=dev), -1)
        m_in = masks.permute(0, 3, 1, 2).contiguous()
        a_in = img_aff.to(getattr(torch, cdt))
        got = par_cuda.propagate_cuda(m_in, a_in).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        want = par_cuda.propagate_ref(masks, img_aff, compute_dtype=cdt)
        err = (got - want).abs()
        key = f"B={shape[0]},{shape[1]}x{shape[2]},C={c},{cdt}"
        check(bool(torch.isfinite(got).all()), f"K4 {key}: non-finite")
        if cdt == "float32":
            bound = 1e-5 * want.abs().max().item()
            check(err.max().item() <= bound,
                  f"K4 {key}: error {err.max().item():.3g} > {bound:.3g}")
        else:
            ulps = (err / bf16_ulp(want.abs())).max().item()
            check(ulps <= 2.0, f"K4 {key}: error {err.max().item():.3g}, "
                  f"{ulps:.2f} bf16 ulps of its element (bound 2)")
        k4["err"][key] = err.max().item()
        if shape[0] == 16:
            k4["ms"][key] = time_ms(lambda: par_cuda.propagate_cuda(m_in, a_in))
            k4["plain_ms"][key] = time_ms(
                lambda: par_cuda.propagate_ref(masks, img_aff,
                                               compute_dtype=cdt), iters=3,
                warmup=1)
        del masks, m_in, a_in, got, want, err
    del aff40
    print(f"[K4 par_propagate] max_abs_err {json.dumps(k4['err'])} | 10 rounds "
          f"| kernel ms {json.dumps(k4['ms'])} | plain ms "
          f"{json.dumps(k4['plain_ms'])}", flush=True)

    # -- 9. the pseudo-label slice ---------------------------------------------------
    from dupl_tpu_torch.engine.export import make_pseudo_label_fn
    from dupl_tpu_torch.engine.profile import pseudo_label_inputs

    def on(device, *arrays):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    model.to(dev)
    pl_fn = make_pseudo_label_fn(cfg, model)
    args9 = on(dev, *pseudo_label_inputs(16, 448, seed=1))
    for _ in range(2):
        pl_fn(*args9)
    torch.cuda.synchronize()
    counters = (attention.exp_attention_cuda, crf_cuda.kernel_apply_cuda,
                par_cuda.affinity_cuda, par_cuda.propagate_cuda)
    for f in counters:
        f.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        refined, crf_labels = pl_fn(*args9)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    pl_launches = dict(zip(("exp_attention", "crf_apply", "par_affinity",
                            "par_propagate"), (f.launches for f in counters)))
    peak9 = torch.cuda.max_memory_allocated()
    check(all(n > 0 for n in pl_launches.values()),
          f"a kernel of the pseudo-label path never launched: {pl_launches}")

    def check_labels(refined, crf_labels, b, size, what):
        check(refined.shape == (2, b, size, size) and refined.dtype == torch.uint8,
              f"{what}: refined {tuple(refined.shape)} {refined.dtype}")
        vals = set(torch.unique(refined).tolist())
        check(vals <= set(range(21)) | {cfg.ignore_index},
              f"{what}: refined values {sorted(vals)}")
        check(cfg.ignore_index in vals, f"{what}: no ignore band")
        check(crf_labels.shape == (b, size, size)
              and crf_labels.dtype == torch.uint8
              and int(crf_labels.max()) <= 20,
              f"{what}: crf labels {tuple(crf_labels.shape)} max "
              f"{int(crf_labels.max())}")

    check_labels(refined, crf_labels, 16, 448, "pseudo-label slice")
    # The fallback: image 3 gets 12 present classes, so the whole batch runs
    # PAR on the full class axis (C = 84).  Every channel propagates on its
    # own and the compaction is exact, so the other images' labels must
    # match the compact call's, and the CRF labels (which ignore the class
    # labels) all of them.
    img9, cls9, box9 = pseudo_label_inputs(16, 448, seed=1)
    cls9[3, :12] = 1
    for f in counters:
        f.launches = 0
    fb_refined, fb_crf = pl_fn(*on(dev, img9, cls9, box9))
    fb_launches = par_cuda.propagate_cuda.launches
    check(fb_launches == cfg.par.num_iter,
          f"fallback call: K4 launched {fb_launches} times")
    check_labels(fb_refined, fb_crf, 16, 448, "fallback call")
    others = [i for i in range(16) if i != 3]
    fb_agree = (fb_refined[:, others] == refined[:, others]).float().mean().item()
    check(fb_agree >= 0.999 and bool((fb_crf == crf_labels).all()),
          f"fallback call: refined labels of the other images agree with the "
          f"compact call on {fb_agree:.5f}")
    del args9, refined, crf_labels, fb_refined, fb_crf
    med9 = statistics.median(times)
    print(f"[pseudo-label slice] ViT-B/16 dual student, crop 448, batch 16, CAM "
          f"scales {tuple(cfg.cam_scales)} x flip, PAR 224^2 x 10 rounds "
          f"(class budget {cfg.par.class_budget}, fp32), fast CRF | median "
          f"{1e3 * med9:.1f} ms of 5 ({', '.join(f'{1e3 * t:.1f}' for t in times)}) "
          f"| {16 / med9:.3f} img/s | peak memory {peak9 / 2**30:.3f} GiB | "
          f"launches {json.dumps(pl_launches)} | fallback call: K4 "
          f"{fb_launches} launches at C = 84, other images' labels agree "
          f"{fb_agree:.5f}", flush=True)

    # -- 10. pseudo-label path, card against CPU -----------------------------------------
    # Same weights, crop 224, batch 2, once within the class budget and once
    # past it (image 1 with 12 present classes: the full class axis).  The
    # card runs K1 (max-free exp softmax, bf16 probabilities), K3, K4 and K5;
    # the CPU runs exact softmax and the plain twins; both compute in bf16 as
    # the recipe says.  Bound: refined and CRF labels at least 98% equal.
    args10 = pseudo_label_inputs(2, 224, seed=2)
    fb10 = tuple(a.copy() for a in args10)
    fb10[1][1, :12] = 1
    on_card = [tuple(t.cpu() for t in pl_fn(*on(dev, *a)))
               for a in (args10, fb10)]
    model.to("cpu")
    cpu_fn = make_pseudo_label_fn(cfg, model)
    agree10 = {}
    for name, a, (g_ref, g_crf) in zip(("compact", "fallback"),
                                       (args10, fb10), on_card):
        c_ref, c_crf = cpu_fn(*on("cpu", *a))
        agree10[name] = ((g_ref == c_ref).float().mean().item(),
                         (g_crf == c_crf).float().mean().item())
        check(min(agree10[name]) >= 0.98,
              f"card vs CPU ({name}): refined agreement "
              f"{agree10[name][0]:.4f}, CRF {agree10[name][1]:.4f}")
    print("[pseudo-label card vs cpu] crop 224 batch 2 | " + " | ".join(
        f"{name}: refined label agreement {r:.4f}, CRF label agreement {c:.4f}"
        for name, (r, c) in agree10.items()), flush=True)

    k3_key = "uint8"
    k4_key = "B=16,224x224,C=40,float32"
    kernels = [
        {"name": "exp_attention", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/exp_attention.cu",
         "replaces": "dupl_tpu/ops/attention.py:98",
         "launches": launches["exp_attention"],
         "launches_pseudo_label": pl_launches["exp_attention"],
         "max_abs_err": k1["err"],
         "ms": k1["ms"]["BH=192,N=1765"],
         "plain_ms": k1["plain_ms"]["BH=192,N=1765"]},
        {"name": "crf_apply", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/crf_apply.cu",
         "replaces": "dupl_tpu/ops/crf_pallas.py:30",
         "launches": launches["crf_apply"],
         "launches_pseudo_label": pl_launches["crf_apply"],
         "max_abs_err": k5["err"],
         "ms": k5["ms"]["B=2,N=200704,Ns=3136,V=22"],
         "plain_ms": k5["plain_ms"]["B=2,N=200704,Ns=3136,V=22"]},
        {"name": "par_affinity", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/par_affinity.cu",
         "replaces": "dupl_tpu/ops/par_pallas.py:141",
         "launches": pl_launches["par_affinity"],
         "max_abs_err": k3["err"],
         "ms": k3["ms"][k3_key], "plain_ms": k3["plain_ms"][k3_key]},
        {"name": "par_propagate", "route": "cuda",
         "source": "dupl_tpu_torch/csrc/par_propagate.cu",
         "replaces": "dupl_tpu/ops/par_pallas.py:37",
         "launches": pl_launches["par_propagate"],
         "max_abs_err": k4["err"][k4_key],
         "ms": k4["ms"][k4_key], "plain_ms": k4["plain_ms"][k4_key]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
