"""The plain twins of the flash-attention kernels (L1f forward, L1b
backward) against jax's exact softmax attention on the same numpy inputs
(CPU), the autograd pairing, and the N >= 2048 dispatch.

On the TPU ``dupl_tpu.ops.attention.dot_attention`` sends these lengths to
jax's library Pallas flash kernel; off the TPU it calls
``jax.nn.dot_product_attention``, the exact function both compute, which is
what the twins are held to here (in fp32 on bf16-rounded operands)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu_torch.config import ModelConfig
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import attention

torch.set_num_threads(2)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _operands(seed, b, n, h, d, mult=1.0):
    rs = np.random.RandomState(seed)
    q, k, v, g = (_bf16(rs.standard_normal((b, n, h, d)).astype(np.float32))
                  for _ in range(4))
    return _bf16(q * mult), k, v, g


def _row_ulps(got, want):
    """(max, mean) of |got - want| in bf16 ulps of each row's scale (the
    largest magnitude over the head dim)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1e-30)
    err = np.abs(got - want) / np.exp2(np.floor(np.log2(scale)) - 7)
    return err.max(), err.mean()


def _bhnd(x):
    return torch.from_numpy(x).permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,n,h,d,mult", [(1, 2117, 2, 64, 1.0),
                                          (2, 333, 3, 16, 1.0),
                                          (1, 200, 2, 80, 8.0)])
def test_flash_twin_forward_matches_jax(b, n, h, d, mult):
    """N 2117 (a 500 x 500 VOC image at scale 1.5) and ragged lengths, one
    with logits of magnitude ~50.  The twin rounds p to bf16 (2^-9 relative,
    averaged over the keys) and the result once: within 2 bf16 ulps of the
    row of jax's fp32 result at the maximum and 0.3 on average (measured:
    0.7-1.3 and 0.08-0.15, most of it the final rounding to bf16), and the
    log-sum-exp within 1e-5 relative."""
    q, k, v, _ = _operands(n, b, n, h, d, mult)
    scale = d ** -0.5
    want = np.asarray(jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale))
    out, lse = attention.flash_attention_ref(_bhnd(q), _bhnd(k), _bhnd(v),
                                             scale)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert out.shape == (b, h, n, d) and lse.shape == (b, h, n)
    worst, mean = _row_ulps(out.float().permute(0, 2, 1, 3).numpy(), want)
    assert worst <= 2.0 and mean <= 0.3, (worst, mean)
    s = np.einsum("bnhd,bmhd->bhnm", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    want_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile", [64, 100, 128, 4096])
def test_flash_twin_does_not_depend_on_the_tiling_beyond_rounding(tile):
    """The online softmax over the kernel's 128-key tiles against other
    tilings (64, the earlier kernel's) and one whole-row tile: the same
    function up to where p is rounded (1 bf16 ulp of the row)."""
    q, k, v, _ = _operands(7, 1, 300, 2, 32)
    a, la = attention.flash_attention_ref(_bhnd(q), _bhnd(k), _bhnd(v), 0.2)
    b, lb = attention.flash_attention_ref(_bhnd(q), _bhnd(k), _bhnd(v), 0.2,
                                          tile=tile)
    worst, _ = _row_ulps(b.float().numpy(), a.float().numpy())
    assert worst <= 1.0
    np.testing.assert_allclose(lb.numpy(), la.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,n,h,d", [(1, 2117, 2, 64), (2, 333, 3, 16)])
def test_flash_twin_backward_matches_jax(b, n, h, d):
    """The twin backward, fed the twin forward's out and lse, against
    ``jax.vjp`` of exact attention in fp32.  The twin rounds ds and p to bf16
    before their products and each result once; jax rounds nothing.  Bounds:
    4 bf16 ulps of the row at the maximum and 0.25 on average (measured:
    1.1-1.5 and 0.13-0.18; rounding a result to bf16 once is already ~0.13
    ulp of its row on average, so no bf16 result can come closer)."""
    q, k, v, g = _operands(n + 1, b, n, h, d)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda a, b_, c: jax.nn.dot_product_attention(
        a, b_, c, scale=scale), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    out, lse = attention.flash_attention_ref(_bhnd(q), _bhnd(k), _bhnd(v),
                                             scale)
    got = attention.flash_attention_bwd_ref(_bhnd(q), _bhnd(k), _bhnd(v), out,
                                            lse, _bhnd(g), scale)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16 and x.shape == (b, h, n, d)
        worst, mean = _row_ulps(x.float().permute(0, 2, 1, 3).numpy(),
                                np.asarray(w))
        assert worst <= 4.0 and mean <= 0.25, (name, worst, mean)


def _exact_attention64(q, k, v, scale):
    """fp64 softmax attention on (B, N, H, D) numpy arrays."""
    s = np.einsum("bnhd,bmhd->bhnm", q, k) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhnm,bmhd->bnhd", p, v)


def test_flash_function_gradients_match_finite_differences():
    """``_FlashAttention`` under autograd at a tiny size: the gradient of
    sum(out * g) against central finite differences of exact fp64 attention
    at the same bf16-rounded operands.  The function computes in bf16, so it
    is held to 2^-6 of each gradient's largest entry, not to fp64
    accuracy."""
    q, k, v, g = (x.astype(np.float64) for x in _operands(3, 1, 9, 2, 16))
    scale = 0.25
    ts = [torch.from_numpy(x).float().requires_grad_() for x in (q, k, v)]
    out = attention.flash_attention(*ts, scale=scale)
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(g).float())
    eps = 1e-5
    for i, (name, t) in enumerate(zip("qkv", ts)):
        ops = [q, k, v]
        num = np.zeros_like(ops[i])
        for idx in np.ndindex(*ops[i].shape):
            hi = [x.copy() for x in ops]
            lo = [x.copy() for x in ops]
            hi[i][idx] += eps
            lo[i][idx] -= eps
            num[idx] = ((_exact_attention64(*hi, scale)
                         - _exact_attention64(*lo, scale)) * g).sum() / (2 * eps)
        err = np.abs(t.grad.numpy() - num).max()
        assert err <= 2 ** -6 * np.abs(num).max(), (name, err)


def test_flash_function_matches_plain_autograd():
    """The pairing of the two twins in one ``autograd.Function`` gives the
    gradients of plain autograd through exact softmax, to bf16 accuracy
    (2^-7 of each gradient's scale), on strided views of one qkv tensor."""
    rs = np.random.RandomState(0)
    b, n, h, d = 2, 150, 2, 16
    qkv = torch.from_numpy(rs.standard_normal((b, n, 3 * h * d)).astype(
        np.float32))
    go = torch.from_numpy(rs.standard_normal((b, n, h, d)).astype(np.float32))
    grads = []
    for fn in (attention.flash_attention, attention.softmax_attention):
        x = qkv.clone().requires_grad_()
        q, k, v = (x[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
                   for i in range(3))
        fn(q, k, v, scale=d ** -0.5).backward(go)
        grads.append(x.grad)
    assert ((grads[0] - grads[1]).abs().max().item()
            <= 2 ** -7 * grads[1].abs().max().item())


@pytest.mark.parametrize("n", [2048, 2117])
def test_dot_attention_takes_long_sequences_on_the_cpu(n, monkeypatch):
    """2048 tokens and more no longer raise; on the CPU ``dot_attention``
    keeps exact softmax at every length (as the reference keeps
    ``jax.nn.dot_product_attention`` off the TPU), without the flash
    twins."""
    def no_twin(*a, **k):
        raise AssertionError("dot_attention ran a flash twin on the CPU")
    monkeypatch.setattr(attention, "flash_attention_ref", no_twin)
    q, k, v, _ = _operands(n, 1, n, 1, 16)
    got = attention.dot_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  scale=0.25)
    want = np.asarray(jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.25))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert attention.flash_attention_cuda.launches == 0


def test_flash_kernel_wrappers_reject_cpu_tensors():
    x = torch.zeros(1, 64, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention_cuda(x, x, x, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        attention.flash_attention_bwd_cuda(x, x, x, x, torch.zeros(1, 2, 64),
                                           x, 0.125)
    assert attention.flash_attention_cuda.launches == 0
    assert attention.flash_attention_bwd_cuda.launches == 0


def test_vit_forward_past_2048_tokens_matches_jax(tmp_path):
    """Both packages' tiny dual student on a 736 x 736 input: 46 x 46 + 1 =
    2117 tokens, the length a 500 x 500 VOC image reaches at scale 1.5.
    fp32 and exact softmax on both sides (CPU); atol 1e-4 on outputs of
    magnitude ~1-10 (fp32 summation order)."""
    kw = dict(backbone="test_tiny_patch16", compute_dtype="float32")
    jmodel = JDualStudent(JModelConfig(**kw))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path / "w.npz")
    ckpt.export_weights(path, params)
    model = DualStudent(ModelConfig(**kw))
    model.load_state_dict(load_weights(path))
    x = np.random.RandomState(0).randn(1, 736, 736, 3).astype(np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    want = jmodel.apply(params, jnp.asarray(x))
    assert got.fmap.shape == (2, 1, 46, 46, 32)
    for name in ("cls", "seg", "fmap", "cls_aux"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-4, err_msg=name)
