"""The port's CUDA kernels against their plain twins on the card, at edge
shapes the main paths do not reach (ragged lengths, strided views, every
head dim and value width the kernels take, images smaller than the PAR
dilations) and their input checks.

Needs a CUDA card and nvcc; skips elsewhere.  On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from dupl_tpu_torch.ops import attention, crf, crf_cuda, par, par_cuda

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _row_ulp_ok(got, want):
    """One bf16 ulp at the scale of each output row (see chip_smoke.py)."""
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return bool(((got.float() - want).abs() <= ulp).all())


@pytest.mark.parametrize("b,n,h,d", [(1, 64, 2, 64), (3, 100, 2, 64),
                                     (2, 197, 3, 16), (1, 300, 4, 32),
                                     (2, 257, 2, 80)])
def test_exp_attention_on_qkv_views(dev, b, n, h, d):
    """K1 reads q, k, v as column slices of one (B, N, 3C) projection, as
    the ViT does, and matches the twin."""
    g = torch.Generator(device=dev).manual_seed(n)
    c = h * d
    qkv = torch.randn(b, n, 3 * c, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, d)
               for i in range(3))
    assert not k.is_contiguous()
    before = attention.exp_attention_cuda.launches
    got = attention.exp_attention(q, k, v, scale=d ** -0.5)
    assert attention.exp_attention_cuda.launches == before + 1
    ref = attention.exp_attention(q.cpu(), k.cpu(), v.cpu(), scale=d ** -0.5)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _row_ulp_ok(got.cpu(), ref.float())
    assert _row_ulps(got.cpu(), ref)[1] <= 1e-3


_K1_EDGES = [(1, n, 2, d) for d in (16, 32, 64, 80)
             for n in (127, 128, 129, 255, 256, 257, 2045, 2046, 2047)]


@pytest.mark.parametrize("b,n,h,d", _K1_EDGES)
def test_exp_attention_tile_edges(dev, b, n, h, d):
    """K1 at the edges of its 128-key tiles and 128-row blocks (a last key
    tile of 127, 128 or 1 keys; a last block whose second warpgroup has no
    row, one row or a full half), every head dim, strided q, k, v: within 1
    bf16 ulp of the row at the maximum and 1e-3 on average of its twin."""
    qs, k, v, _ = _qkvg(dev, b, n, h, d, seed=n + d)
    assert not k.is_contiguous()
    got = attention.exp_attention_cuda(qs, k, v)
    torch.cuda.synchronize()
    want = attention.exp_attention_ref(*(attention._to_bhnd(x)
                                         for x in (qs, k, v)))
    assert torch.isfinite(got.float()).all()
    worst, mean = _row_ulps(attention._to_bhnd(got), want.to(torch.bfloat16))
    assert worst <= 1.0 and mean <= 1e-3, (worst, mean)


@pytest.mark.parametrize("kind", ["running_max", "p_fp32", "denom_bf16"])
@pytest.mark.parametrize("n", [785, 1765])
def test_exp_attention_bounds_tell_a_wrong_kernel(dev, kind, n):
    """The bounds K1 is held to (1 bf16 ulp of the row at the maximum, 1e-3
    on average) tell a changed function apart: against each wrong twin of
    chip_smoke.py's ``exp_attn_wrong`` the kernel falls outside them."""
    from chip_smoke import exp_attn_wrong

    qs, k, v, _ = _qkvg(dev, 2, n, 12, 64, seed=n)
    got = attention.exp_attention_cuda(qs, k, v)
    want = exp_attn_wrong(*(attention._to_bhnd(x) for x in (qs, k, v)), kind)
    worst, mean = _row_ulps(attention._to_bhnd(got), want)
    assert worst > 1.0 or mean > 1e-3, (worst, mean)


def test_exp_attention_clamp(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, 130, 2, 64, generator=g, device=dev) * m
               for m in (40.0, 1.0, 1.0))
    got = attention.exp_attention(q, k, v, scale=0.125)
    ref = attention.exp_attention(q.cpu(), k.cpu(), v.cpu(), scale=0.125)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _row_ulp_ok(got.cpu(), ref)


def test_dot_attention_dispatch(dev):
    """Below 128 tokens plain softmax (no launch), 128..2047 the max-free
    kernel, 2048 and above the flash kernel: the line is the unpadded
    length."""
    n0 = attention.exp_attention_cuda.launches
    x = torch.randn(1, 127, 2, 64, device=dev, dtype=torch.bfloat16)
    attention.dot_attention(x, x, x, scale=0.125)
    assert attention.exp_attention_cuda.launches == n0
    x = torch.randn(1, 128, 2, 64, device=dev, dtype=torch.bfloat16)
    attention.dot_attention(x, x, x, scale=0.125)
    assert attention.exp_attention_cuda.launches == n0 + 1
    f0 = attention.flash_attention_cuda.launches
    x = torch.randn(1, 2047, 1, 64, device=dev, dtype=torch.bfloat16)
    attention.dot_attention(x, x, x, scale=0.125)
    assert attention.exp_attention_cuda.launches == n0 + 2
    assert attention.flash_attention_cuda.launches == f0
    x = torch.randn(1, 2048, 1, 64, device=dev, dtype=torch.bfloat16)
    out = attention.dot_attention(x, x, x, scale=0.125)
    assert attention.exp_attention_cuda.launches == n0 + 2
    assert attention.flash_attention_cuda.launches == f0 + 1
    assert out.shape == x.shape and torch.isfinite(out.float()).all()


def test_exp_attention_rejects_bad_operands(dev):
    x = torch.zeros(1, 130, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.exp_attention_cuda(x.float(), x, x)
    with pytest.raises(ValueError, match="head dim"):
        y = torch.zeros(1, 130, 2, 48, device=dev, dtype=torch.bfloat16)
        attention.exp_attention_cuda(y, y, y)
    odd_rows = torch.zeros(1, 130, 2, 65, device=dev,
                           dtype=torch.bfloat16)[..., :64]  # stride 65
    with pytest.raises(ValueError, match="strides"):
        attention.exp_attention_cuda(x, odd_rows, x)
    with pytest.raises(ValueError, match="strides"):
        attention.exp_attention_cuda(x, x, torch.zeros(
            1, 130, 2, 128, device=dev, dtype=torch.bfloat16)[..., ::2])


def _qkvg(dev, b, n, h, d, seed, q_mult=1.0):
    """Operands as the ViT hands them to the kernels: q (pre-scaled), k, v
    column slices of one (B, N, 3C) projection, and a cotangent."""
    g = torch.Generator(device=dev).manual_seed(seed)
    c = h * d
    qkv = torch.randn(b, n, 3 * c, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, d)
               for i in range(3))
    qs = (q.float() * q_mult * d ** -0.5).to(torch.bfloat16)
    go = torch.randn(b, n, h, d, generator=g, device=dev).to(torch.bfloat16)
    return qs, k, v, go


def _row_ulps(got, want):
    """(max, mean) of |got - want| in bf16 ulps of each row's scale."""
    want = want.float()
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    err = (got.float() - want).abs() / torch.exp2(
        torch.floor(torch.log2(scale)) - 7)
    return err.max().item(), err.mean().item()


@pytest.mark.parametrize("b,n,h,d", [(1, 64, 2, 64), (3, 100, 2, 64),
                                     (2, 442, 3, 64), (2, 197, 3, 16),
                                     (1, 300, 4, 32), (2, 257, 2, 80),
                                     (1, 1226, 2, 64)] + [
    # the edges of the 64-row tiles and 128-row blocks, every head dim
    (1, n, 2, d) for d in (16, 32, 64, 80)
    for n in (127, 128, 129, 255, 256, 257, 895, 896, 897)])
def test_exp_attention_bwd_matches_twin(dev, b, n, h, d):
    """K2 against its twin at ragged lengths, every head dim, strided k and
    v, and one length past the reference kernel's 896.  Kernel and twin
    round the same fp32 quantities to bf16 and sum in different orders:
    every output within 2 bf16 ulps of its row's scale, and within 0.01 ulp
    on average (a kernel that leaves ds in fp32 is ~0.1 ulp off on average,
    one without delta tens of ulps at the maximum)."""
    qs, k, v, go = _qkvg(dev, b, n, h, d, seed=n)
    assert not k.is_contiguous()
    n0 = attention.exp_attention_bwd_cuda.launches
    got = attention.exp_attention_bwd_cuda(qs, k, v, go)
    torch.cuda.synchronize()
    assert attention.exp_attention_bwd_cuda.launches == n0 + 1
    want = attention.exp_attention_bwd_ref(*(
        attention._to_bhnd(x) for x in (qs, k, v, go)))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == qs.shape and x.dtype == torch.bfloat16
        assert x.is_contiguous() and torch.isfinite(x.float()).all()
        worst, mean = _row_ulps(attention._to_bhnd(x), w)
        assert worst <= 2.0 and mean <= 0.01, (name, worst, mean)


def test_exp_attention_bwd_clamp_mask(dev):
    """Scores far past the clamp at 60: ds is zero there.  Rows are nearly
    one-hot, so t - delta cancels and the two summation orders differ by
    more than elsewhere (10-17 ulps of the row measured on an H100); a
    kernel without the mask is hundreds of ulps away, and tens on average."""
    qs, k, v, go = _qkvg(dev, 2, 442, 4, 64, seed=7, q_mult=24.0)
    ops = tuple(attention._to_bhnd(x) for x in (qs, k, v, go))
    s = ops[0].float() @ ops[1].float().transpose(-1, -2)
    assert (s >= 60).float().mean().item() > 0.001
    got = attention.exp_attention_bwd_cuda(qs, k, v, go)
    want = attention.exp_attention_bwd_ref(*ops)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        worst, mean = _row_ulps(attention._to_bhnd(x), w)
        assert worst <= 64.0 and mean <= 0.01, (name, worst, mean)


@pytest.mark.parametrize("kind,n,q_mult,max_bound", [
    ("none", 442, 1.0, 2.0), ("no_delta", 442, 1.0, 2.0),
    ("ds_fp32", 442, 1.0, 2.0), ("ds_fp32", 785, 1.0, 2.0),
    ("none", 442, 24.0, 64.0), ("no_clamp_mask", 442, 24.0, 64.0)])
def test_exp_attention_bwd_bounds_tell_a_wrong_kernel(dev, kind, n, q_mult,
                                                      max_bound):
    """The bounds K2 is held to (2 bf16 ulps of the row at the maximum, 64
    past the clamp, 0.01 on average) are tight enough to be worth
    something: held against a twin that drops delta, drops the clamp mask
    or leaves ds in fp32, the kernel is outside them; against the unchanged
    formulation (``none``) it is inside."""
    from chip_smoke import exp_attn_bwd_wrong

    qs, k, v, go = _qkvg(dev, 4, n, 12, 64, seed=n, q_mult=q_mult)
    ops = tuple(attention._to_bhnd(x) for x in (qs, k, v, go))
    got = attention.exp_attention_bwd_cuda(qs, k, v, go)
    worst = mean = 0.0
    for x, w in zip(got, exp_attn_bwd_wrong(*ops, kind)):
        a, b = _row_ulps(attention._to_bhnd(x), w)
        worst, mean = max(worst, a), max(mean, b)
    inside = worst <= max_bound and mean <= 0.01
    assert inside == (kind == "none"), (kind, worst, mean)


def test_exp_attention_function_backward_runs_the_kernel(dev, monkeypatch):
    """Under autograd on CUDA tensors ``exp_attention`` launches K1 forward
    and K2 backward, never a twin, and its gradients are the twin's."""
    def no_twin(*a, **k):
        raise AssertionError("a plain twin ran on CUDA tensors")
    monkeypatch.setattr(attention, "exp_attention_ref", no_twin)
    monkeypatch.setattr(attention, "exp_attention_bwd_ref", no_twin)
    g = torch.Generator(device=dev).manual_seed(3)
    b, n, h, d = 2, 300, 3, 64
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device=dev,
                      requires_grad=True)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
               for i in range(3))
    f0 = attention.exp_attention_cuda.launches
    b0 = attention.exp_attention_bwd_cuda.launches
    out = attention.dot_attention(q, k, v, scale=d ** -0.5)
    go = torch.randn(out.shape, generator=g, device=dev)
    out.backward(go)
    torch.cuda.synchronize()
    assert attention.exp_attention_cuda.launches == f0 + 1
    assert attention.exp_attention_bwd_cuda.launches == b0 + 1
    monkeypatch.undo()
    qkv_c = qkv.detach().cpu().requires_grad_()
    qc, kc, vc = (qkv_c[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
                  for i in range(3))
    attention.exp_attention(qc, kc, vc, scale=d ** -0.5).backward(go.cpu())
    scale = qkv_c.grad.abs().max().item()
    assert (qkv.grad.cpu() - qkv_c.grad).abs().max().item() <= 2 ** -7 * scale


def test_train_step_runs_the_kernels_without_a_host_sync(dev):
    """``Trainer.train_step`` on the card, tiny ViT (head dim 16), crop 256:
    every phase launches K1 and K2 as counted from the code (12 blocks
    become 4; the scale-0.5 views, 65 tokens, take plain softmax), never
    waits for the device inside a step (PyTorch's sync debug mode raises),
    and moves the weights."""
    import dataclasses

    from dupl_tpu_torch.config import GmmConfig
    from dupl_tpu_torch.data.pipeline import synthetic_batch
    from dupl_tpu_torch.engine.train import (Trainer, phase_start,
                                             production_config)

    cfg = production_config("voc", gmm=GmmConfig(min_pixels=100))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone="test_tiny_patch16"))
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state()
    batch = trainer.put(synthetic_batch(2, crop=256))
    for phase, k1, k2 in (("warmup", 24, 8), ("seg", 24, 8), ("full", 32, 16)):
        state.step = state.optimizer.global_step = phase_start(cfg, phase)
        trainer.train_step(state, batch)          # first use: builds, caches
        before = state.model.branch1.encoder.cls_token.detach().clone()
        attention.exp_attention_cuda.launches = 0
        attention.exp_attention_bwd_cuda.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, metrics = trainer.train_step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert attention.exp_attention_cuda.launches == k1, phase
        assert attention.exp_attention_bwd_cuda.launches == k2, phase
        assert all(torch.isfinite(v) for v in metrics.values()), phase
        assert not torch.equal(
            state.model.branch1.encoder.cls_token.detach(), before)


def test_exp_attention_bwd_rejects_bad_operands(dev):
    x = torch.zeros(1, 130, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.exp_attention_bwd_cuda(x, x, x, x.float())
    y = torch.zeros(1, 130, 2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        attention.exp_attention_bwd_cuda(y, y, y, y)
    with pytest.raises(ValueError, match="shapes"):
        attention.exp_attention_bwd_cuda(x, x, x, x[:, :100])
    with pytest.raises(ValueError, match="strides"):
        attention.exp_attention_bwd_cuda(x, x, x, torch.zeros(
            1, 130, 2, 128, device=dev, dtype=torch.bfloat16)[..., ::2])
    with pytest.raises(ValueError, match="CUDA"):
        attention.exp_attention_bwd_cuda(x, x.cpu(), x, x)


@pytest.mark.parametrize("nv", [1, 5, 21, 22, 32, 33, 64, 81, 82, 130])
def test_crf_apply_widths(dev, nv):
    """K5 against the twin at ragged pixel and pivot counts, B = 3, at every
    width: one 32-column group and up to five (COCO hands it V 81 and 82)."""
    rs = np.random.RandomState(nv)
    b, n, ns = 3, 1000, 300
    basis = torch.tensor(rs.standard_normal((b, n, 11)) * 2.0,
                         dtype=torch.float32, device=dev)
    coef = torch.tensor(rs.standard_normal((b, 11, ns)) * 0.1,
                        dtype=torch.float32, device=dev)
    logc = torch.tensor(-np.abs(rs.standard_normal((b, ns))),
                        dtype=torch.float32, device=dev)
    vals = torch.tensor(rs.standard_normal((b, ns, nv)), dtype=torch.float32,
                        device=dev)
    got = crf_cuda.kernel_apply(basis, coef, logc, vals)
    want = crf_cuda.kernel_apply_ref(basis, coef, logc, vals)
    scale = want.abs().amax(dim=(0, 1))
    assert ((got - want).abs().amax(dim=(0, 1)) <= 2e-3 * scale).all()


def test_crf_apply_column_groups_are_independent(dev):
    """K5 at V 82 runs three 32-column groups in one launch; each group's
    columns are bit-equal to a call on that slice of the values alone."""
    g = torch.Generator(device=dev).manual_seed(82)
    basis = torch.randn(2, 777, 11, generator=g, device=dev) * 2.0
    coef = torch.randn(2, 11, 250, generator=g, device=dev) * 0.1
    logc = -torch.randn(2, 250, generator=g, device=dev).abs()
    vals = torch.randn(2, 250, 82, generator=g, device=dev)
    n0 = crf_cuda.kernel_apply_cuda.launches
    got = crf_cuda.kernel_apply_cuda(basis, coef, logc, vals)
    assert crf_cuda.kernel_apply_cuda.launches == n0 + 1
    for c0 in range(0, 82, 32):
        part = crf_cuda.kernel_apply_cuda(basis, coef, logc,
                                          vals[..., c0:c0 + 32].contiguous())
        assert torch.equal(got[..., c0:c0 + 32], part), c0


def test_crf_apply_rejects_bad_operands(dev):
    z = torch.zeros(1, 64, 11, device=dev)
    coef, logc = torch.zeros(1, 11, 8, device=dev), torch.zeros(1, 8, device=dev)
    with pytest.raises(ValueError, match="V must be"):
        crf_cuda.kernel_apply_cuda(z, coef, logc, torch.zeros(1, 8, 0,
                                                              device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        crf_cuda.kernel_apply_cuda(z, coef, logc,
                                   torch.zeros(1, 3, 8, device=dev).mT)
    with pytest.raises(ValueError, match="want basis"):
        crf_cuda.kernel_apply_cuda(z, coef, logc, torch.zeros(1, 9, 3,
                                                              device=dev))


def test_fast_crf_card_matches_cpu(dev):
    """The whole fast CRF on the card (K5) against the CPU (plain twin):
    labels at least 99.9% equal."""
    rs = np.random.RandomState(0)
    img = torch.tensor(rs.rand(2, 64, 96, 3), dtype=torch.float32)
    logits = torch.tensor(rs.randn(2, 64, 96, 21), dtype=torch.float32)
    probs = torch.softmax(logits * 2, -1)
    kw = dict(iters=5, downsample=8, row_chunk=16, fast=True,
              return_logits=True)
    n0 = crf_cuda.kernel_apply_cuda.launches
    got = crf.mean_field_crf(img.to(dev), probs.to(dev), **kw).cpu()
    assert crf_cuda.kernel_apply_cuda.launches == n0 + 1
    want = crf.mean_field_crf(img, probs, **kw)
    assert (got.argmax(-1) == want.argmax(-1)).float().mean() >= 0.999


DIL = (1, 2, 4, 8, 12, 24)


def _smooth_image(b, h, w, dev, seed):
    """Smooth gradients plus noise, quantised to uint8 / 255: flat
    neighbourhoods, where the affinity's variance cancels in fp32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h, device=dev),
                            torch.linspace(0, 1, w, device=dev), indexing="ij")
    img = torch.stack([0.5 + 0.4 * torch.sin(3 * xx + 2 * yy), yy, xx * yy], -1)
    img = img + 0.02 * torch.randn(b, h, w, 3, generator=g, device=dev)
    return (img.clamp(0, 1) * 255).round() / 255


@pytest.mark.parametrize("b,h,w", [(2, 37, 53), (1, 12, 20), (3, 1, 30),
                                   (1, 64, 1), (2, 224, 224)])
@pytest.mark.parametrize("dil", [DIL, (1, 3)])
def test_par_affinity_shapes(dev, b, h, w, dil):
    """K3 against its twin at ragged sizes, sizes below the largest
    dilation (every tap clamps) and another dilation set: bound 1e-5 on
    values in [0, 1.01] (kernel and twin round alike, even where the
    variance cancels; see chip_smoke.py)."""
    img = _smooth_image(b, h, w, dev, seed=h * w)
    n0 = par_cuda.affinity_cuda.launches
    got = par_cuda.affinity(img, dil)
    assert par_cuda.affinity_cuda.launches == n0 + 1
    want = par_cuda.affinity_ref(img, dil)
    assert got.shape == (b, 8 * len(dil), h, w)
    assert (got - want).abs().max().item() <= 1e-5
    torch.testing.assert_close(got.sum(1), torch.full_like(got[:, 0], 1.01),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("c", [1, 5, 40, 84])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w", [(2, 37, 53), (1, 12, 20), (1, 100, 7)])
def test_par_propagate_shapes(dev, c, compute_dtype, b, h, w):
    """K4 against its twin, 10 rounds: fp32 within 1e-5 of the output's
    scale; bf16 within two bf16 ulps of each element (kernel and twin
    round alike; dropping any of the bf16 roundings costs 3 ulps or more,
    see chip_smoke.py)."""
    g = torch.Generator(device=dev).manual_seed(c)
    logits = torch.randn(b, h, w, c, generator=g, device=dev) * 3
    masks = torch.softmax(logits, -1)
    aff = par_cuda.affinity(_smooth_image(b, h, w, dev, seed=c), DIL)
    n0 = par_cuda.propagate_cuda.launches
    got = par_cuda.propagate(masks, aff, DIL, 10, compute_dtype)
    assert par_cuda.propagate_cuda.launches == n0 + 10
    want = par_cuda.propagate_ref(masks, aff, DIL, 10, compute_dtype)
    assert got.shape == masks.shape and got.dtype == torch.float32
    err = (got - want).abs()
    if compute_dtype == "float32":
        assert err.max().item() <= 1e-5 * want.abs().max().item()
    else:
        ulp = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        assert (err <= 2 * ulp).all()


def test_par_refine_card_matches_cpu(dev):
    """PAR on the card (K3, K4) against the CPU (twins): refined values
    within 1e-4 (the affinities differ by fp32 roundings only)."""
    img = _smooth_image(2, 48, 40, dev, seed=9)
    masks = torch.softmax(torch.randn(2, 48, 40, 9, device=dev) * 2, -1)
    got = par.par_refine(img, masks).cpu()
    want = par.par_refine(img.cpu(), masks.cpu())
    assert (got - want).abs().max().item() <= 1e-4


def test_par_kernels_reject_bad_operands(dev):
    img = torch.zeros(1, 8, 8, 3, device=dev)
    with pytest.raises(TypeError, match="float32"):
        par_cuda.affinity_cuda(img.double(), DIL)
    with pytest.raises(ValueError, match="contiguous"):
        par_cuda.affinity_cuda(torch.zeros(1, 3, 8, 8, device=dev)
                               .permute(0, 2, 3, 1), DIL)
    with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
        par_cuda.affinity_cuda(torch.zeros(1, 8, 8, 4, device=dev), DIL)
    with pytest.raises(ValueError, match="dilations"):
        par_cuda.affinity_cuda(img, (1, 2, 3, 4, 5, 6, 7))
    with pytest.raises(ValueError, match="dilations"):
        par_cuda.affinity_cuda(img, (0, 2))
    m = torch.zeros(1, 5, 8, 8, device=dev)
    aff = torch.zeros(1, 48, 8, 8, device=dev)
    with pytest.raises(ValueError, match="want aff"):
        par_cuda.propagate_cuda(m, aff[:, :40], DIL, 2)
    with pytest.raises(TypeError, match="float32"):
        par_cuda.propagate_cuda(m.half(), aff, DIL, 2)
    with pytest.raises(TypeError):
        par_cuda.propagate_cuda(m, aff.half(), DIL, 2)
    with pytest.raises(ValueError, match="dilations"):
        par_cuda.propagate_cuda(m, aff, (1, 2, 4, 8, 12, 41), 2)
    with pytest.raises(ValueError, match="CUDA"):
        par_cuda.propagate_cuda(m, aff.cpu(), DIL, 2)


# -- the flash-attention kernels (L1f forward, L1b backward) ------------------

def _flash_ops(dev, b, n, h, d, seed, q_mult=1.0):
    """Unscaled q, k, v as column slices of one (B, N, 3C) projection, and a
    cotangent."""
    qs, k, v, go = _qkvg(dev, b, n, h, d, seed, q_mult=q_mult * d ** 0.5)
    return qs, k, v, go


_FLASH_SHAPES = [(1, 64, 2, 64), (3, 100, 2, 64), (2, 197, 3, 16),
                 (1, 300, 4, 32), (2, 257, 2, 80), (1, 2117, 2, 64),
                 (1, 2305, 12, 64)] + [
    # the edges of the 128-key and 64-row tiles, every head dim
    (1, n, 2, d) for d in (16, 32, 64, 80)
    for n in (127, 128, 129, 2047, 2048, 2049)]


@pytest.mark.parametrize("b,n,h,d", _FLASH_SHAPES)
def test_flash_attention_matches_twin(dev, b, n, h, d):
    """L1f against its twin at ragged lengths (partial last tiles), the
    edges of its tiles, every head dim, strided k and v.  Kernel and twin
    walk the same 128-key tiles with the same running maximum and round the
    same fp32 quantities to bf16; their exps and sum orders differ.
    Bounds: 1 bf16 ulp of the row at the maximum, 0.01 on average (a kernel
    that leaves p in fp32, or one that rounds p against another maximum
    than the running one, falls outside them: see the test below).  The
    log-sum-exp within 1e-5."""
    q, k, v, _ = _flash_ops(dev, b, n, h, d, seed=n)
    assert not k.is_contiguous()
    n0 = attention.flash_attention_cuda.launches
    out, lse = attention.flash_attention_cuda(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == n0 + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    assert out.is_contiguous() and lse.shape == (b, h, n)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    want, want_lse = attention.flash_attention_ref(
        *(attention._to_bhn(x) for x in (q, k, v)), d ** -0.5)
    worst, mean = _row_ulps(attention._to_bhn(out), want)
    assert worst <= 1.0 and mean <= 0.01, (worst, mean)
    assert (lse - want_lse).abs().max().item() <= 1e-5


@pytest.mark.parametrize("kind", ["p_fp32", "global_max"])
@pytest.mark.parametrize("n", [300, 2117])
def test_flash_attention_bounds_tell_a_wrong_kernel(dev, kind, n):
    """The bounds L1f is held to (1 bf16 ulp of the row at the maximum,
    0.01 on average) tell the new tiling apart: against a twin that leaves p
    in fp32, or one that rounds p against the row's global maximum, the
    kernel falls outside them (chip_smoke.py's ``flash_fwd_wrong``)."""
    from chip_smoke import flash_fwd_wrong

    q, k, v, _ = _flash_ops(dev, 2, n, 12, 64, seed=n)
    out, _ = attention.flash_attention_cuda(q, k, v, 0.125)
    want = flash_fwd_wrong(*(attention._to_bhn(x) for x in (q, k, v)), 0.125,
                           kind)
    worst, mean = _row_ulps(attention._to_bhn(out), want)
    assert worst > 1.0 or mean > 0.01, (worst, mean)


@pytest.mark.parametrize("n", [442, 1765])
def test_flash_attention_against_exp_attention(dev, n):
    """Below 2048 tokens L1f and K1 compute the same softmax, K1 without the
    max subtraction and with q pre-scaled in bf16 (exact at head dim 64):
    the outputs differ by the rounding of p against another reference point
    only.  Bounds: 2 bf16 ulps of the row, 0.25 on average (measured on an
    H100: 2.0, 0.12-0.18)."""
    q, k, v, _ = _flash_ops(dev, 2, n, 12, 64, seed=n)
    out, _ = attention.flash_attention_cuda(q, k, v, 0.125)
    k1 = attention.exp_attention_cuda(q * 0.125, k, v)
    worst, mean = _row_ulps(attention._to_bhn(out), attention._to_bhn(k1))
    assert worst <= 2.0 and mean <= 0.25, (worst, mean)


def test_flash_attention_large_logits(dev):
    """Logits up to the hundreds, where max-free exp would overflow: finite,
    and within the same bounds of the twin."""
    q, k, v, _ = _flash_ops(dev, 1, 2100, 2, 64, seed=11, q_mult=30.0)
    s = (attention._to_bhn(q).float()
         @ attention._to_bhn(k).float().transpose(-1, -2)) * 0.125
    assert s.max().item() > 100
    out, lse = attention.flash_attention_cuda(q, k, v, 0.125)
    want, want_lse = attention.flash_attention_ref(
        *(attention._to_bhn(x) for x in (q, k, v)), 0.125)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    worst, mean = _row_ulps(attention._to_bhn(out), want)
    assert worst <= 1.0 and mean <= 0.01, (worst, mean)


@pytest.mark.parametrize("b,n,h,d", _FLASH_SHAPES)
def test_flash_attention_bwd_matches_twin(dev, b, n, h, d):
    """L1b against its twin on the forward kernel's own out and lse, at the
    same shapes as the forward.  Kernel and twin round the same fp32
    quantities to bf16 and sum in different orders: within 2 bf16 ulps of
    the row at the maximum and 0.01 on average."""
    q, k, v, go = _flash_ops(dev, b, n, h, d, seed=n)
    out, lse = attention.flash_attention_cuda(q, k, v, d ** -0.5)
    n0 = attention.flash_attention_bwd_cuda.launches
    got = attention.flash_attention_bwd_cuda(q, k, v, out, lse, go, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.flash_attention_bwd_cuda.launches == n0 + 1
    want = attention.flash_attention_bwd_ref(
        *(attention._to_bhn(x) for x in (q, k, v, out)), lse,
        attention._to_bhn(go), d ** -0.5)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == q.shape and x.dtype == torch.bfloat16
        assert x.is_contiguous() and torch.isfinite(x.float()).all()
        worst, mean = _row_ulps(attention._to_bhn(x), w)
        assert worst <= 2.0 and mean <= 0.01, (name, worst, mean)


def test_flash_attention_bwd_peaked_rows(dev):
    """Logits six times wider: rows are nearly one-hot, t - delta cancels
    and the two summation orders differ by more (13 ulps of the row measured
    on an H100, bound 64); the mean stays within 0.01."""
    q, k, v, go = _flash_ops(dev, 2, 2117, 12, 64, seed=2117, q_mult=6.0)
    out, lse = attention.flash_attention_cuda(q, k, v, 0.125)
    got = attention.flash_attention_bwd_cuda(q, k, v, out, lse, go, 0.125)
    want = attention.flash_attention_bwd_ref(
        *(attention._to_bhn(x) for x in (q, k, v, out)), lse,
        attention._to_bhn(go), 0.125)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        worst, mean = _row_ulps(attention._to_bhn(x), w)
        assert worst <= 64.0 and mean <= 0.01, (name, worst, mean)


def flash_wrong_twin(q, k, v, out, lse, g, scale, kind):
    """``flash_attention_bwd_ref`` with one step done wrongly
    ((..., N, D)): ``no_delta`` drops delta, ``ds_fp32`` leaves ds unrounded,
    ``lse_is_max`` normalises by the row maximum instead of the
    log-sum-exp."""
    qf, kf, vf, of, gf = (x.to(torch.bfloat16).float()
                          for x in (q, k, v, out, g))
    s = scale * (qf @ kf.transpose(-1, -2))
    if kind == "lse_is_max":
        lse = s.amax(-1)
    p = torch.exp(s - lse[..., None])
    t = gf @ vf.transpose(-1, -2)
    delta = (of * gf).sum(-1, keepdim=True)
    if kind == "no_delta":
        delta = torch.zeros_like(delta)
    ds = p * (t - delta)
    if kind != "ds_fp32":
        ds = ds.to(torch.bfloat16).float()
    dq, dk = scale * (ds @ kf), scale * (ds.transpose(-1, -2) @ qf)
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ gf
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


@pytest.mark.parametrize("kind", ["none", "no_delta", "ds_fp32", "lse_is_max"])
@pytest.mark.parametrize("n", [300, 2305])
def test_flash_attention_bwd_bounds_tell_a_wrong_kernel(dev, kind, n):
    """The bounds L1b is held to (2 bf16 ulps of the row at the maximum,
    0.01 on average) tell a wrong kernel: against a twin without delta
    (110-450 ulps at the maximum), with ds left in fp32 (0.09-0.13 ulp on
    average; the maximum, 1-2 ulps, does not show it) or with the row
    maximum in place of the log-sum-exp (230-255 ulps) the kernel is
    outside them; against the unchanged formulation (``none``) inside."""
    q, k, v, go = _flash_ops(dev, 2, n, 12, 64, seed=n)
    out, lse = attention.flash_attention_cuda(q, k, v, 0.125)
    got = attention.flash_attention_bwd_cuda(q, k, v, out, lse, go, 0.125)
    ops = (*(attention._to_bhn(x) for x in (q, k, v, out)), lse,
           attention._to_bhn(go))
    worst = mean = 0.0
    for x, w in zip(got, flash_wrong_twin(*ops, 0.125, kind)):
        a, b = _row_ulps(attention._to_bhn(x), w)
        worst, mean = max(worst, a), max(mean, b)
    inside = worst <= 2.0 and mean <= 0.01
    assert inside == (kind == "none"), (kind, worst, mean)


def test_flash_attention_bwd_is_repeatable_and_masks_the_tail(dev):
    """No atomics: two launches give the same bits.  And a ragged tail has
    no padded key: with one key fewer, the gradients of the keys that remain
    are those of the same problem computed on its own."""
    q, k, v, go = _flash_ops(dev, 1, 2050, 2, 64, seed=4)
    out, lse = attention.flash_attention_cuda(q, k, v, 0.125)
    a = attention.flash_attention_bwd_cuda(q, k, v, out, lse, go, 0.125)
    b = attention.flash_attention_bwd_cuda(q, k, v, out, lse, go, 0.125)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    n = 2049                        # one row into the 33rd tile
    qs, ks, vs, gs = (x[:, :n] for x in (q, k, v, go))
    out_s, lse_s = attention.flash_attention_cuda(qs, ks, vs, 0.125)
    got = attention.flash_attention_bwd_cuda(qs, ks, vs, out_s, lse_s, gs,
                                             0.125)
    want = attention.flash_attention_bwd_ref(
        *(attention._to_bhn(x) for x in (qs, ks, vs, out_s)), lse_s,
        attention._to_bhn(gs), 0.125)
    for x, w in zip(got, want):
        assert x.shape == (1, n, 2, 64)
        worst, mean = _row_ulps(attention._to_bhn(x), w)
        assert worst <= 2.0 and mean <= 0.01, (worst, mean)


def test_flash_attention_function_backward_runs_the_kernels(dev, monkeypatch):
    """Under autograd on CUDA tensors ``dot_attention`` at 2048 tokens or
    more launches L1f forward and L1b backward, never a twin, and its
    gradients are the twins' (the CPU function's)."""
    def no_twin(*a, **k):
        raise AssertionError("a plain twin ran on CUDA tensors")
    monkeypatch.setattr(attention, "flash_attention_ref", no_twin)
    monkeypatch.setattr(attention, "flash_attention_bwd_ref", no_twin)
    g = torch.Generator(device=dev).manual_seed(3)
    b, n, h, d = 1, 2060, 3, 64
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device=dev,
                      requires_grad=True)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
               for i in range(3))
    f0 = attention.flash_attention_cuda.launches
    b0 = attention.flash_attention_bwd_cuda.launches
    out = attention.dot_attention(q, k, v, scale=d ** -0.5)
    go = torch.randn(out.shape, generator=g, device=dev)
    out.backward(go)
    torch.cuda.synchronize()
    assert attention.flash_attention_cuda.launches == f0 + 1
    assert attention.flash_attention_bwd_cuda.launches == b0 + 1
    monkeypatch.undo()
    qkv_c = qkv.detach().cpu().requires_grad_()
    qc, kc, vc = (qkv_c[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
                  for i in range(3))
    attention.flash_attention(qc, kc, vc, scale=d ** -0.5).backward(go.cpu())
    scale = qkv_c.grad.abs().max().item()
    assert (qkv.grad.cpu() - qkv_c.grad).abs().max().item() <= 2 ** -7 * scale


def test_flash_attention_rejects_bad_operands(dev):
    x = torch.zeros(1, 130, 2, 64, device=dev, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 130, device=dev)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.flash_attention_cuda(x.float(), x, x, 0.125)
    y = torch.zeros(1, 130, 2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        attention.flash_attention_cuda(y, y, y, 0.125)
    with pytest.raises(ValueError, match="shapes"):
        attention.flash_attention_cuda(x, x, x[:, :100], 0.125)
    with pytest.raises(ValueError, match="strides"):
        attention.flash_attention_cuda(x, x, torch.zeros(
            1, 130, 2, 128, device=dev, dtype=torch.bfloat16)[..., ::2], 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention_cuda(x, x.cpu(), x, 0.125)
    with pytest.raises(ValueError, match="lse"):
        attention.flash_attention_bwd_cuda(x, x, x, x, lse[:, :, :100], x,
                                           0.125)
    with pytest.raises(ValueError, match="lse"):
        attention.flash_attention_bwd_cuda(x, x, x, x, lse.double(), x, 0.125)
    with pytest.raises(TypeError, match="bfloat16"):
        attention.flash_attention_bwd_cuda(x, x, x, x, lse, x.float(), 0.125)


def test_crf_apply_at_the_evaluator_shape(dev):
    """K5 at the native-resolution evaluator's shape: a 500 x 375 image
    edge-padded to 504 x 376 (N 189,504 pixels, 2,961 pivots), V 21 and
    V 1, through ``kernel_apply`` with the evaluator's ``block_rows``
    (``_auto_tile(376, 56)`` = 47 rows of 504).  Bound as elsewhere: 2e-3 of
    each column's scale."""
    g = torch.Generator(device=dev).manual_seed(0)
    h, w = 376, 504
    assert crf._auto_tile(h, 56) == 47 and crf._auto_tile(h, 8) == 8
    yy, xx = torch.meshgrid(torch.linspace(0, 1, h, device=dev),
                            torch.linspace(0, 1, w, device=dev), indexing="ij")
    img = torch.stack([torch.sin(6 * xx) * 0.5 + 0.5, yy, xx * yy], -1)[None]
    img = (img + 0.03 * torch.randn(img.shape, generator=g, device=dev)
           ).clamp(0, 1)
    basis, coef, logc, _, _ = crf.pivot_lattice(img, 8, 121.0, 5.0)
    assert basis.shape == (1, 189504, 11) and coef.shape == (1, 11, 2961)
    for nv in (21, 1):
        vals = torch.rand(1, 2961, nv, generator=g, device=dev) * 64.0
        n0 = crf_cuda.kernel_apply_cuda.launches
        got = crf_cuda.kernel_apply(basis, coef, logc, vals,
                                    block_rows=47 * w)
        assert crf_cuda.kernel_apply_cuda.launches == n0 + 1
        want = crf_cuda.kernel_apply_ref(basis, coef, logc, vals,
                                         block_rows=47 * w)
        scale = want.abs().amax(dim=(0, 1))
        assert ((got - want).abs().amax(dim=(0, 1)) <= 2e-3 * scale).all()


# ---- the experiment kernels P1-P4 (ops/experiments.py) ----------------------
from dupl_tpu_torch.ops import experiments  # noqa: E402


def _row_ulps(got, want):
    """(max, mean) error in bf16 ulps at the scale of each output row."""
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    err = (got.float() - want).abs() / torch.exp2(
        torch.floor(torch.log2(scale)) - 7)
    return err.max().item(), err.mean().item()


def _attn_operands(dev, shape, seed, q_mult=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    return ((q * q_mult).to(torch.bfloat16), k.to(torch.bfloat16),
            v.to(torch.bfloat16))


@pytest.mark.parametrize("bh,n,d,q_mult", [
    (4, 197, 64, 0.125), (2, 300, 32, 0.18), (3, 64, 16, 0.25),
    (2, 257, 80, 0.11), (2, 1, 64, 0.125), (2, 130, 64, 5.0)])
def test_exp_attention_ones_matches_twin(dev, bh, n, d, q_mult):
    """P1 against its twin at ragged lengths, every head dim and past the
    clamp: within 2 bf16 ulps of the row (the order of the fp32 sums can
    flip the rounding of an e entry, which an element of a row carries at
    the row's scale), 1e-3 ulp on average."""
    q, k, v = _attn_operands(dev, (bh, n, d), seed=n, q_mult=q_mult)
    n0 = experiments.exp_attention_ones_cuda.launches
    got = experiments.exp_attention_ones(q, k, v)
    assert experiments.exp_attention_ones_cuda.launches == n0 + 1
    assert got.shape == (bh, n, d) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    want = experiments.exp_attention_ones_ref(q, k, v).to(torch.bfloat16).float()
    mx, mean = _row_ulps(got, want)
    assert mx <= 2.0 and mean <= 1e-3, (mx, mean)


def test_exp_attention_ones_on_views_and_wrong_twin(dev):
    """Strided q, k, v (column slices of one projection) through the
    (B, N, H, D) wrapper; and the twin with the fp32 row sum (the
    exp-attention twin) falls outside the mean bound."""
    b, n, h, d = 2, 785, 12, 64
    g = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn(b, n, 3 * h * d, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
               for i in range(3))
    q = q * torch.tensor(0.125, dtype=torch.bfloat16, device=dev)
    got = experiments.exp_attention_ones_cuda(q, k, v)
    bhnd = [attention._to_bhnd(x) for x in (q, k, v)]
    want = attention._from_bhnd(experiments.exp_attention_ones_ref(*bhnd).to(
        torch.bfloat16), b).float()
    mx, mean = _row_ulps(got, want)
    assert mx <= 2.0 and mean <= 1e-3, (mx, mean)
    wrong = attention._from_bhnd(attention.exp_attention_ref(*bhnd).to(
        torch.bfloat16), b).float()
    assert _row_ulps(got, wrong)[1] > 1e-3


@pytest.mark.parametrize("b,n,h,d,scale", [
    (1, 197, 3, 64, 0.125), (2, 300, 2, 32, 32 ** -0.5),
    (1, 64, 2, 16, 0.25), (1, 257, 2, 80, 80 ** -0.5), (2, 442, 12, 64, 0.11)])
def test_exp_attention_bnhd_matches_twin(dev, b, n, h, d, scale):
    """P2 against its twin, also at scales bf16 does not represent; equal to
    the scale pass followed by K1 but for the order of fp32 sums (K1 sums in
    128-key tiles, P2 in 64: within the same bounds of each other); and the
    twin with the scale left in fp32 falls outside the mean bound."""
    q, k, v = _attn_operands(dev, (b, n, h, d), seed=n + 7)
    n0 = experiments.exp_attention_bnhd_cuda.launches
    got = experiments.exp_attention_bnhd(q, k, v, scale)
    assert experiments.exp_attention_bnhd_cuda.launches == n0 + 1
    want = experiments.exp_attention_bnhd_ref(q, k, v, scale).to(
        torch.bfloat16).float()
    mx, mean = _row_ulps(got, want)
    assert mx <= 2.0 and mean <= 1e-3, (mx, mean)
    k1 = attention.exp_attention_cuda(q * experiments.bf16_scale(scale), k, v)
    mx, mean = _row_ulps(got, k1.float())
    assert mx <= 2.0 and mean <= 1e-3, (mx, mean)
    if experiments.bf16_scale(scale) != scale:
        qs = (q.float() * scale).to(torch.bfloat16)
        wrong = attention._from_bhnd(attention.exp_attention_ref(
            *(attention._to_bhnd(x) for x in (qs, k, v))).to(torch.bfloat16), b)
        assert _row_ulps(got, wrong.float())[1] > 1e-3


def _crf_operands(dev, b, n, ns, v, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    basis = torch.randn(b, n, 11, generator=g, device=dev)
    coef = torch.randn(b, 11, ns, generator=g, device=dev) * 0.1
    logc = -torch.randn(b, ns, generator=g, device=dev).abs()
    logc[:, ::5] = float("-inf")
    vals = torch.randn(b, ns, v, generator=g, device=dev)
    return basis, coef, logc, vals


@pytest.mark.parametrize("b,n,ns,v", [(2, 1000, 200, 22), (1, 130, 17, 1),
                                      (1, 4096, 256, 8), (2, 777, 333, 32),
                                      (1, 50176, 784, 21)])
def test_kernel_apply_bf16_matches_twin(dev, b, n, ns, v):
    """P3 against its twin at ragged pixel and pivot counts and every width
    class: at most 5e-4 of a column's largest output, 1e-4 of it on
    average; every fifth pivot has logc = -inf."""
    ops = _crf_operands(dev, b, n, ns, v, seed=n)
    n0 = experiments.kernel_apply_bf16_cuda.launches
    got = experiments.kernel_apply_bf16(*ops)
    assert experiments.kernel_apply_bf16_cuda.launches == n0 + 1
    want = experiments.kernel_apply_bf16_ref(*ops)
    assert got.shape == (b, n, v) and torch.isfinite(got).all()
    err, scale = (got - want).abs(), want.abs().amax(dim=(0, 1))
    assert (err.amax(dim=(0, 1)) <= 5e-4 * scale).all()
    assert (err.mean(dim=(0, 1)) <= 1e-4 * scale).all()


def test_kernel_apply_bf16_zero_pivots_and_wrong_twin(dev):
    basis, coef, logc, vals = _crf_operands(dev, 2, 50176, 784, 22, seed=1)
    dead = torch.full_like(logc, float("-inf"))
    assert experiments.kernel_apply_bf16(basis, coef, dead, vals).abs().max() == 0
    got = experiments.kernel_apply_bf16(basis, coef, logc, vals)
    wrong = crf_cuda.kernel_apply_ref(basis, coef, logc, vals)
    scale = wrong.abs().amax(dim=(0, 1))
    assert ((got - wrong).abs().mean(dim=(0, 1)) > 1e-4 * scale).all()
    with pytest.raises(TypeError, match="float32"):
        experiments.kernel_apply_bf16_cuda(basis.double(), coef, logc, vals)
    with pytest.raises(ValueError, match="V must be"):
        experiments.kernel_apply_bf16_cuda(basis, coef, logc,
                                           vals.repeat(1, 1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        experiments.kernel_apply_bf16_cuda(basis, coef.transpose(1, 2)
                                           .contiguous().transpose(1, 2),
                                           logc, vals)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["mul", "exp", "exp2", "exp_min", "tanh",
                                  "expf"])
def test_exp_rate_matches_twin(dev, name, dtype):
    """P4 against its twin on a tile whose size is no multiple of a thread's
    elements, 256 passes.  fp32: 1e-5 * iters relative to the largest
    result.  bf16: the packed instructions round as the twin's operations
    do, so mul, exp, exp_min are equal but for an exp at a rounding
    boundary (2 bf16 ulps of the largest result); ex2.approx.ftz.bf16x2 and
    tanh.approx.bf16x2 are approximations good to about a bf16 ulp; over
    several passes that error adds up with the accumulator's own roundings
    (8 passes leave 9% of the tanh tile more than 2 ulps away), and near
    stagnation the accumulator depends on its term discontinuously.  So
    here they run one pass, which is f(x) itself: 99% of the elements
    within 2 ulps, all within 8 (the 4096 passes of the tool are held in
    chip_smoke.py)."""
    if name == "expf" and dtype == torch.bfloat16:
        with pytest.raises(TypeError, match="float32 only"):
            experiments.exp_rate(torch.zeros(8, device=dev, dtype=dtype),
                                 name, 2)
        return
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.randn(63, 257, generator=g, device=dev) - 1.0).to(dtype)
    approx = dtype == torch.bfloat16 and name in ("exp2", "tanh")
    iters = 1 if approx else 256
    n0 = experiments.exp_rate_cuda.launches
    got = experiments.exp_rate(x, name, iters)
    assert experiments.exp_rate_cuda.launches == n0 + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = experiments.exp_rate_ref(x, name, iters).float()
    err = (got.float() - want).abs()
    top = want.abs().max()
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * 256 * top
    elif approx:
        close = err <= 2.0 ** -7 * want.abs().clamp_min(1e-3)
        assert close.float().mean() >= 0.99, close.float().mean()
        assert (err <= 2.0 ** -5 * want.abs().clamp_min(1e-3)).all()
    else:
        assert err.max() <= 2.0 ** -7 * top
    zero = experiments.exp_rate(x, name, 0)
    assert zero.abs().max() == 0


def test_experiment_dispatchers_never_take_the_twin_on_the_card(dev, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a plain twin ran on a CUDA tensor")

    for name in ("exp_attention_ones_ref", "exp_attention_bnhd_ref",
                 "kernel_apply_bf16_ref", "exp_rate_ref"):
        monkeypatch.setattr(experiments, name, boom)
    q, k, v = _attn_operands(dev, (2, 130, 64), seed=0)
    experiments.exp_attention_ones(q, k, v)
    experiments.exp_attention_bnhd(*_attn_operands(dev, (1, 130, 2, 64), 0))
    experiments.kernel_apply_bf16(*_crf_operands(dev, 1, 256, 32, 4, 0))
    experiments.exp_rate(torch.zeros(64, device=dev), "exp", 4)
    with pytest.raises(TypeError, match="bfloat16"):
        experiments.exp_attention_ones(q.float(), k, v)
    with pytest.raises(ValueError, match="head dim"):
        experiments.exp_attention_bnhd_cuda(*_attn_operands(dev, (1, 130, 2, 48), 0))
    with pytest.raises(ValueError, match="contiguous"):
        experiments.exp_rate_cuda(torch.zeros(8, 8, device=dev).t(), "exp", 2)
