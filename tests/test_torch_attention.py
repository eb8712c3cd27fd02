"""Port parity: dupl_tpu_torch.ops.attention against dupl_tpu.ops.attention
on the same numpy inputs (CPU).

The exp-attention twin (what the CPU takes in place of kernel K1) is held to
the reference's Pallas kernel in interpret mode and to its XLA reference
``_exp_attention_ref`` within one bf16 ulp at the scale of each output row
(the largest |value| over the head dim).  Both sides round the same fp32
values to bf16; fp32 summation order differs, which can flip the bf16
rounding of a kernel entry, and an element that nearly cancels inherits
that error at the scale of its row, not its own.  ``dot_attention``'s
exact-softmax path is held to ``jax.nn.dot_product_attention`` in fp32 at
atol 1e-5."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.ops import attention as jattn
from dupl_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)


def _bf16_ulp(x):
    """Spacing of bf16 numbers at |x| (8 significant bits)."""
    ax = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(ax)) - 7)


def _within_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    bound = _bf16_ulp(np.abs(want).max(axis=-1, keepdims=True))
    assert (err <= bound).all(), float((err / bound).max())


def _qkv(n, q_mult=1.0, seed=0, b=1, h=2, d=32):
    rs = np.random.RandomState(seed)
    q = (rs.randn(b, n, h, d) * q_mult).astype(np.float32)
    k = rs.randn(b, n, h, d).astype(np.float32)
    v = rs.randn(b, n, h, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("n,q_mult", [(130, 1.0), (197, 1.0), (300, 1.0),
                                      (197, 40.0)])  # last: logits past 60
def test_exp_attention_twin_matches_pallas(n, q_mult):
    q, k, v = _qkv(n, q_mult)
    d = q.shape[-1]
    want = jattn.exp_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               scale=d ** -0.5, interpret=True)
    got = tattn.exp_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=d ** -0.5)
    assert got.dtype == torch.float32 and got.shape == q.shape
    _within_ulp(got.numpy(), want)
    if q_mult > 1:
        assert np.isfinite(got.numpy()).all()


@pytest.mark.parametrize("n,q_mult", [(130, 1.0), (300, 40.0)])
def test_exp_attention_ref_matches(n, q_mult):
    q, k, v = _qkv(n, q_mult, seed=1)
    bh = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, n, x.shape[-1])  # noqa: E731
    qs = (bh(q) * 0.125).astype(np.float32)
    want = jattn._exp_attention_ref(jnp.asarray(qs, jnp.bfloat16),
                                    jnp.asarray(bh(k), jnp.bfloat16),
                                    jnp.asarray(bh(v), jnp.bfloat16))
    got = tattn.exp_attention_ref(torch.from_numpy(qs), torch.from_numpy(bh(k)),
                                  torch.from_numpy(bh(v)))
    _within_ulp(got.numpy(), want)


@pytest.mark.parametrize("n", [17, 197])
def test_dot_attention_matches_dpa(n):
    """CPU dispatch is exact softmax at every length, as in the reference."""
    q, k, v = _qkv(n, seed=2, b=2, h=3, d=16)
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), scale=0.25)
    got = tattn.dot_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel wrapper launches or raises; it never computes on the CPU."""
    q, k, v = (torch.zeros(1, 130, 2, 64, dtype=torch.bfloat16)
               for _ in range(3))
    with pytest.raises(ValueError, match="CUDA"):
        tattn.exp_attention_cuda(q, k, v)
    assert tattn.exp_attention_cuda.launches == 0


def _row_ulps(got, want):
    """(max, mean) of |got - want| in bf16 ulps of each row's scale."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want) / _bf16_ulp(np.abs(want).max(axis=-1,
                                                          keepdims=True))
    return float(err.max()), float(err.mean())


def _exp_attention_in_tiles(q, k, v, tile=64):
    """The twin's function with its key sums taken tile by tile (the
    numerator's product and the denominator, 64 keys at a time), as a kernel
    that streams K and V sums them: another order of the same fp32 sums."""
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    num = den = 0.0
    for k0 in range(0, qf.shape[-2], tile):
        e = torch.exp(torch.clamp(qf @ kf[..., k0:k0 + tile, :].transpose(
            -1, -2), max=60.0))
        num = num + e.to(torch.bfloat16).float() @ vf[..., k0:k0 + tile, :]
        den = den + e.sum(-1, keepdim=True)
    return (num / den).to(torch.bfloat16)


@pytest.mark.parametrize("kind", ["tiles_64", "running_max", "p_fp32",
                                  "denom_bf16"])
@pytest.mark.parametrize("n", [197, 785])
def test_k1_bounds_tell_wrong_twins(kind, n):
    """The bounds K1 is held to on the card (1 bf16 ulp of the row at the
    maximum, 1e-3 ulp on average) against the twin: the same function
    summed in another order (64-key tiles) lies inside them, and each wrong
    twin of chip_smoke.py's ``exp_attn_wrong`` (the flash kernel's running
    maximum, e left in fp32 for the value product, the denominator summed
    from bf16(e)) lies outside."""
    from chip_smoke import exp_attn_wrong

    rs = np.random.RandomState(n)
    q, k, v = (torch.from_numpy(rs.standard_normal((4, n, 64)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    q = (q.float() * 0.125).to(torch.bfloat16)
    want = tattn.exp_attention_ref(q, k, v).to(torch.bfloat16)
    got = (_exp_attention_in_tiles(q, k, v) if kind == "tiles_64"
           else exp_attn_wrong(q, k, v, kind))
    worst, mean = _row_ulps(got.float(), want.float())
    inside = worst <= 1.0 and mean <= 1e-3
    assert inside == (kind == "tiles_64"), (kind, worst, mean)
