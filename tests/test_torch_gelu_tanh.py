"""The tanh GELU of the port (``dupl_tpu_torch/ops/gelu.py:gelu_tanh``, the
twin of Q1's fused fc2 entry) against jitted ``jax.nn.gelu(x,
approximate=True)``: bit for bit in f32 (XLA's own tanh, its FMA, its
flush of subnormals) and in bf16, and wrong twins that are not."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dupl_tpu_torch.models import vit
from dupl_tpu_torch.ops import gelu

torch.set_num_threads(2)

_JGELU = jax.jit(partial(jax.nn.gelu, approximate=True))


def _unequal(a, b):
    """Elements whose bits differ (NaNs equal)."""
    same = a.view(np.int32) == b.view(np.int32)
    return ~(same | (np.isnan(a) & np.isnan(b)))


def _jax(x32, dtype=jnp.float32):
    return np.asarray(_JGELU(jnp.asarray(x32).astype(dtype))
                      .astype(jnp.float32))


def _port(x32, dtype=torch.float32):
    return gelu.gelu_tanh(torch.from_numpy(x32).to(dtype)).float().numpy()


def _near(target, n=64):
    """f32 x on both sides of the x whose v = sqrt(2/pi) (x + 0.044715 x^3)
    is ``target``: the root and n neighbours each way."""
    r = np.roots([gelu._TANH_S * gelu._TANH_C3, 0, gelu._TANH_S, -target])
    x = np.float32(r[np.isreal(r)].real[0])
    out = [x]
    lo = hi = x
    for _ in range(n):
        lo, hi = np.nextafter(lo, np.float32(-np.inf)), np.nextafter(
            hi, np.float32(np.inf))
        out += [lo, hi]
    return out


def _edges():
    """±0, subnormals and the normal boundary, both sides of the |v| <
    4e-4 branch, of the ±7.9988 clamp and of |v| = 20, ±inf, NaN, the
    largest finite values, and magnitudes over the whole exponent range."""
    tiny = np.float32(2.0 ** -126)
    vals = [0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40, tiny, -tiny,
            np.nextafter(tiny, np.float32(0)), 2 * tiny, -2.5 * tiny,
            np.inf, -np.inf, np.nan, 3.4e38, -3.4e38, 1e13, -1e13]
    for target in (gelu._TANH_SMALL, gelu._TANH_CLAMP, 20.0):
        vals += _near(target) + _near(-target)
    mags = np.exp2(np.random.RandomState(7).uniform(-149, 128, 20_000))
    signs = np.where(np.arange(mags.size) % 2, -1.0, 1.0)
    return np.concatenate([np.array(vals, np.float32),
                           (mags * signs).astype(np.float32)])


def test_f32_bit_equal_to_jitted_jax():
    """2^20 draws of 3 N(0, 1) and the edge values, bit for bit, also at
    lengths that leave XLA's vector loop a tail."""
    x = (np.random.RandomState(0).randn(1 << 20) * 3).astype(np.float32)
    x = np.concatenate([x, _edges()])
    assert not _unequal(_port(x), _jax(x)).any()
    for n in (1, 7, 1025):
        assert not _unequal(_port(x[-n:]), _jax(x[-n:])).any()


def test_f32_subnormals_flushed():
    """XLA's CPU flushes subnormal inputs and results to zero of their
    sign: gelu of a subnormal, and of x whose result would be one, is ±0."""
    x = np.array([1e-40, -1e-40, 1.5e-38, -1.5e-38, 2.0 ** -126],
                 np.float32)
    got = _port(x)
    assert (got == 0).all() and (np.signbit(got) == np.signbit(x)).all()
    assert not _unequal(got, _jax(x)).any()


def test_bf16_every_value_bit_equal():
    """Every bf16 value (the nine operations one rounding at a time, as
    ``tests/test_torch_bench.py`` holds them on draws), but for XLA's CPU
    flushing f32 subnormals: below |x| = 2^-125 jitted JAX gives ±0 where
    the bf16 twin keeps a subnormal (the bf16 main path runs on the card,
    which keeps them too)."""
    bits = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    got, want = _port(bits, torch.bfloat16), _jax(bits, jnp.bfloat16)
    bad = _unequal(got, want)
    assert (np.abs(bits[bad]) < 2.0 ** -125).all() and (want[bad] == 0).all()
    normal = (np.abs(bits) >= 2.0 ** -125) | (bits == 0) | np.isnan(bits)
    assert (~normal).sum() == 510 and not bad[normal].any()


def test_the_port_keeps_its_import_path():
    """``models/vit.py`` imports the GELU that ``ops/gelu.py`` defines."""
    assert vit.gelu_tanh is gelu.gelu_tanh


def _torch_tanh(x):
    """The nine operations in f32 with ``torch.tanh``: the port's f32 tanh
    GELU before XLA's recipe."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype)

    inner = c(np.sqrt(2 / np.pi)) * (x + c(0.044715) * (x * (x * x)))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


@pytest.mark.parametrize("kind", ["torch_tanh", "no_inner_fma",
                                  "no_flush"])
def test_f32_wrong_twins_differ(kind, monkeypatch):
    """``torch.tanh`` in place of XLA's (a third of the draws), the cubic's
    sum rounded on its own where XLA's CPU makes it an FMA, and subnormals
    kept: each breaks bit-equality."""
    x = (np.random.RandomState(1).randn(200_000) * 3).astype(np.float32)
    if kind == "torch_tanh":
        got = _torch_tanh(torch.from_numpy(x)).numpy()
        assert _unequal(got, _jax(x)).mean() > 0.2
        return
    if kind == "no_inner_fma":
        real = gelu.fma_f32

        def fma(a, b, c):
            if isinstance(b, float) and b == gelu._TANH_C3:
                return a * b + c
            return real(a, b, c)
        monkeypatch.setattr(gelu, "fma_f32", fma)
        assert _unequal(_port(x), _jax(x)).sum() > 1000
        return
    monkeypatch.setattr(gelu, "_flush", lambda t: t)
    x = _edges()
    assert _unequal(_port(x), _jax(x)).sum() > 100
