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


def test_exp_attention_clamp(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, 130, 2, 64, generator=g, device=dev) * m
               for m in (40.0, 1.0, 1.0))
    got = attention.exp_attention(q, k, v, scale=0.125)
    ref = attention.exp_attention(q.cpu(), k.cpu(), v.cpu(), scale=0.125)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _row_ulp_ok(got.cpu(), ref)


def test_dot_attention_dispatch(dev):
    """Below 128 tokens plain softmax (no launch), 128..2047 the kernel,
    2048 and above raises until the flash kernel is ported."""
    n0 = attention.exp_attention_cuda.launches
    x = torch.randn(1, 127, 2, 64, device=dev, dtype=torch.bfloat16)
    attention.dot_attention(x, x, x, scale=0.125)
    assert attention.exp_attention_cuda.launches == n0
    x = torch.randn(1, 128, 2, 64, device=dev, dtype=torch.bfloat16)
    attention.dot_attention(x, x, x, scale=0.125)
    assert attention.exp_attention_cuda.launches == n0 + 1
    x = torch.zeros(1, 2048, 1, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="flash"):
        attention.dot_attention(x, x, x, scale=0.125)


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


@pytest.mark.parametrize("nv", [1, 5, 21, 22, 32])
def test_crf_apply_widths(dev, nv):
    """K5 against the twin at ragged pixel and pivot counts, B = 3."""
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


def test_crf_apply_rejects_bad_operands(dev):
    z = torch.zeros(1, 64, 11, device=dev)
    coef, logc = torch.zeros(1, 11, 8, device=dev), torch.zeros(1, 8, device=dev)
    with pytest.raises(ValueError, match="V must be"):
        crf_cuda.kernel_apply_cuda(z, coef, logc, torch.zeros(1, 8, 33,
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
