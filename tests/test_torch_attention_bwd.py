"""The plain twin of the exp-attention backward kernel (K2) against the JAX
package's Pallas backward kernel run in interpret mode, against the exact
fp32 vjp of the forward formulation, and the ``autograd.Function`` that
pairs the forward and backward on CPU tensors."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dupl_tpu.ops import attention as jattention
from dupl_tpu_torch.ops import attention

torch.set_num_threads(2)


def _operands(n, d, bh=3, seed=0, q_mult=1.0):
    rs = np.random.RandomState(seed)
    q, k, v, g = (rs.standard_normal((bh, n, d)).astype(np.float32)
                  for _ in range(4))
    q = q * q_mult * d ** -0.5
    # rounded to bf16 once, so that both frameworks start from equal values
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, g))


def _jnp(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _row_ulps(got, want):
    """|got - want| in bf16 ulps of each row's scale (max over the row)."""
    want = want.float()
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return ((got.float() - want).abs() / ulp).max().item()


@pytest.mark.parametrize("n,d", [(130, 64), (203, 64), (130, 16), (157, 32)])
def test_twin_matches_pallas_backward_interpret(n, d):
    """Both round the same fp32 quantities to bf16 (ds, p, the outputs);
    their fp32 sums run in different orders and the Pallas kernel subtracts
    its zero-padding from the denominator, so a rounding may flip: two bf16
    ulps of the row's scale."""
    ops = _operands(n, d)
    want = jattention._exp_attention_bwd_fused(*map(_jnp, ops), interpret=True)
    got = attention.exp_attention_bwd_ref(*ops)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert gt.dtype == torch.bfloat16 and gt.shape == (3, n, d)
        assert _row_ulps(gt, w) <= 2.0, name


@pytest.mark.parametrize("n,d", [(130, 64), (203, 32)])
def test_twin_matches_exact_vjp(n, d):
    """Against autograd through ``exp_attention_ref`` (the exact fp32 vjp
    of the forward's formulation, which differentiates through the bf16
    rounding of e as the identity).  The twin rounds ds and p to bf16
    (2^-9 relative each) before N-term sums and its results once more:
    1.5% of each output's largest magnitude."""
    q, k, v, g = _operands(n, d, seed=1)
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    out = attention.exp_attention_ref(*leaves)
    want = torch.autograd.grad(out, leaves, g.float())
    got = attention.exp_attention_bwd_ref(q, k, v, g)
    for name, gt, w in zip(("dq", "dk", "dv"), got, want):
        err = (gt.float() - w).abs().max().item()
        assert err <= 1.5e-2 * w.abs().max().item(), (name, err)


def test_clamp_mask_stops_the_gradient():
    """Scores at or past the clamp (60) pass no gradient to q and k.  With
    q scaled up, many scores pass it; a twin without the mask differs."""
    _, _, v, g = _operands(130, 64, seed=2)
    # q in multiples of 2 and k of 1/2: every score is an exact fp32 sum in
    # any order, so both frameworks see the same scores on either side of 60
    rs = np.random.RandomState(2)
    q = torch.from_numpy(np.round(rs.standard_normal((3, 130, 64)) * 2) * 2
                         ).to(torch.bfloat16)
    k = torch.from_numpy(np.round(rs.standard_normal((3, 130, 64)) * 2) / 2
                         ).to(torch.bfloat16)
    s = q.float() @ k.float().transpose(-1, -2)
    assert (s >= 60).any() and (s < 60).any()
    dq, dk, dv = attention.exp_attention_bwd_ref(q, k, v, g)
    want = jattention._exp_attention_bwd_fused(*map(_jnp, (q, k, v, g)),
                                               interpret=True)
    for gt, w in zip((dq, dk, dv), want):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert torch.isfinite(gt.float()).all()
        assert _row_ulps(gt, w) <= 2.0
    # the unmasked formula, same roundings
    e = torch.exp(s.clamp(max=60.0))
    p = e / e.sum(-1, keepdim=True)
    t = g.float() @ v.float().transpose(-1, -2)
    ds = (p * (t - (p * t).sum(-1, keepdim=True))).to(torch.bfloat16).float()
    unmasked_dq = (ds @ k.float()).to(torch.bfloat16)
    assert _row_ulps(dq, unmasked_dq.float()) > 16.0
    # a row whose every score is clamped gets exactly no gradient
    big = q.clone()
    big[:, 0] = 0
    big[:, 0, 0] = 3000.0
    kk = k.clone()
    kk[..., 0] = kk[..., 0].abs() + 1.0
    dq_big, _, _ = attention.exp_attention_bwd_ref(big, kk, v, g)
    assert (dq_big[:, 0] == 0).all()


@pytest.mark.parametrize("b,n,h,d", [(2, 130, 2, 64), (1, 141, 3, 16)])
def test_function_on_cpu_pairs_the_twins(b, n, h, d):
    """``exp_attention`` under autograd on CPU tensors: the forward is the
    forward twin, the backward the backward twin, through the scale product
    and the casts (``gradcheck`` means nothing in bf16)."""
    rs = np.random.RandomState(3)
    c = h * d
    qkv = torch.from_numpy(rs.standard_normal((b, n, 3 * c)).astype(
        np.float32)).requires_grad_()
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, h, d)
               for i in range(3))
    scale = d ** -0.5
    out = attention.exp_attention(q, k, v, scale=scale)
    assert out.dtype == torch.float32 and out.shape == (b, n, h, d)
    g = torch.from_numpy(rs.standard_normal((b, n, h, d)).astype(np.float32))
    (dqkv,) = torch.autograd.grad(out, qkv, g)

    def bhnd(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, n, d)

    qs = q.detach().to(torch.bfloat16) * torch.tensor(scale).to(torch.bfloat16)
    fwd = attention.exp_attention_ref(bhnd(qs), bhnd(k.detach()),
                                      bhnd(v.detach())).to(torch.bfloat16)
    assert torch.equal(bhnd(out).to(torch.bfloat16), fwd)
    dq, dk, dv = attention.exp_attention_bwd_ref(
        bhnd(qs), bhnd(k.detach()), bhnd(v.detach()), bhnd(g))

    def back(x):
        return x.reshape(b, h, n, d).permute(0, 2, 1, 3).reshape(b, n, c)

    # dq passes back through the bf16 scale product
    want_q = (back(dq) * torch.tensor(scale).to(torch.bfloat16)).float()
    want = torch.cat([want_q, back(dk).float(), back(dv).float()], dim=-1)
    assert torch.equal(dqkv, want)


def test_dot_attention_on_cpu_stays_exact_softmax():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.standard_normal((1, 130, 2, 64)).astype(
        np.float32)).requires_grad_()
    out = attention.dot_attention(x, x, x, scale=0.125)
    assert torch.allclose(out, attention.softmax_attention(x, x, x,
                                                           scale=0.125))
    out.sum().backward()
    assert torch.isfinite(x.grad).all()


def _ulps(got, want):
    """(max, mean) of |got - want| in bf16 ulps of each row's scale."""
    want = want.float()
    scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    err = (got.float() - want).abs() / torch.exp2(torch.floor(torch.log2(
        scale)) - 7)
    return err.max().item(), err.mean().item()


def _bwd_in_tiles(q, k, v, g, tile=64):
    """The twin's function with its sums taken tile by tile, as the kernel
    takes them: the row statistics sum_j e and sum_j e*t over 64-key tiles
    (delta = sum e*t / sum e), dq over key tiles, dk and dv over query
    tiles."""
    qf, kf, vf, gf = (x.to(torch.bfloat16).float() for x in (q, k, v, g))
    n = qf.shape[-2]
    s = qf @ kf.transpose(-1, -2)
    t = gf @ vf.transpose(-1, -2)
    e = torch.exp(s.clamp(max=60.0))
    l = u = 0.0
    for k0 in range(0, n, tile):
        l = l + e[..., k0:k0 + tile].sum(-1, keepdim=True)
        u = u + (e * t)[..., k0:k0 + tile].sum(-1, keepdim=True)
    inv = 1.0 / l
    p = e * inv
    ds = torch.where(s < 60.0, p * (t - u * inv), torch.zeros_like(p))
    ds = ds.to(torch.bfloat16).float()
    pb = p.to(torch.bfloat16).float()
    dq = dk = dv = 0.0
    for a in range(0, n, tile):
        dq = dq + ds[..., a:a + tile] @ kf[..., a:a + tile, :]
        dk = dk + ds[..., a:a + tile, :].transpose(-1, -2) @ qf[..., a:a + tile, :]
        dv = dv + pb[..., a:a + tile, :].transpose(-1, -2) @ gf[..., a:a + tile, :]
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


@pytest.mark.parametrize("kind,n,q_mult", [
    ("tiles_64", 197, 1.0), ("tiles_64", 785, 1.0), ("tiles_64", 197, 24.0),
    ("no_delta", 197, 1.0), ("no_delta", 785, 1.0), ("ds_fp32", 197, 1.0),
    ("ds_fp32", 785, 1.0), ("no_clamp_mask", 197, 24.0)])
def test_k2_bounds_tell_wrong_twins(kind, n, q_mult):
    """The bounds K2 is held to on the card (2 bf16 ulps of the row at the
    maximum, 64 with scores past the clamp, 0.01 on average) against the
    twin: the same function summed in 64-row tiles with the kernel's delta
    (sum e*t / sum e) lies inside them, and each wrong twin of
    chip_smoke.py's ``exp_attn_bwd_wrong`` (no delta, ds left in fp32, no
    clamp mask) lies outside."""
    from chip_smoke import exp_attn_bwd_wrong

    q, k, v, g = _operands(n, 64, bh=4, seed=n, q_mult=q_mult)
    if q_mult > 1:
        s = q.float() @ k.float().transpose(-1, -2)
        assert (s >= 60).float().mean().item() > 0.001
    want = attention.exp_attention_bwd_ref(q, k, v, g)
    got = (_bwd_in_tiles(q, k, v, g) if kind == "tiles_64"
           else exp_attn_bwd_wrong(q, k, v, g, kind))
    worst = mean = 0.0
    for x, w in zip(got, want):
        a, b = _ulps(x, w)
        worst, mean = max(worst, a), max(mean, b)
    inside = worst <= (2.0 if q_mult == 1.0 else 64.0) and mean <= 0.01
    assert inside == (kind == "tiles_64"), (kind, worst, mean)
