"""The exact (erf) GELU of the port (``dupl_tpu_torch/ops/gelu.py``, kernel
G's plain twins) against the jitted JAX package: ``jax.jit(jax.nn.gelu(x,
approximate=False))`` and ``jax.vjp`` of it, bit for bit in bf16 and f32,
and the bf16 ViT block of the training recipe (erf GELU) against the JAX
block on the same weights (``tests/test_torch_bench.py:_blocks``)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dupl_tpu_torch.ops import gelu
from dupl_tpu_torch.utils import flops
from test_torch_bench import _blocks

torch.set_num_threads(2)

_JGELU = jax.jit(partial(jax.nn.gelu, approximate=False))
_JVJP = jax.jit(lambda x, g: jax.vjp(_JGELU, x)[1](g)[0])
TINY = 2.0 ** -126          # the smallest normal f32 / bf16 magnitude


def _bf16_values():
    """Every finite bf16 value, as float32."""
    bits = (np.arange(65536, dtype=np.uint32) << 16).view(np.float32)
    return bits[np.isfinite(bits)]


def _jax_fwd(x32, dtype):
    return np.asarray(_JGELU(jnp.asarray(x32).astype(dtype))
                      .astype(jnp.float32))


def _port_fwd(x32, dtype):
    t = torch.from_numpy(x32).to(dtype)
    return gelu.gelu_erf_ref(t).float().numpy()


def _unequal(a, b):
    return ~((a == b) | (np.isnan(a) & np.isnan(b)))


def test_bf16_every_normal_value_below_8():
    """All 33,024 nonzero normal bf16 values with |x| < 8 (and both
    zeros).  The only differences are XLA's CPU flushing a subnormal f32
    intermediate to zero: for the 256 normal x with |x| < 2^-125, 0.5 x is
    subnormal in f32; jitted JAX gives 0, the port keeps it (as the card
    does; rounded to bf16 it may reach 2^-126).  Every other value is
    bit-equal; there is no exp-caused difference (the twin's exp is XLA's
    too)."""
    x = _bf16_values()
    x = x[(np.abs(x) < 8) & ((np.abs(x) >= TINY) | (x == 0))]
    assert x.size == 33_024 + 2
    got, want = _port_fwd(x, torch.bfloat16), _jax_fwd(x, jnp.bfloat16)
    flushed = (x != 0) & (np.abs(x) < 2.0 ** -125)
    assert flushed.sum() == 256
    assert (want[flushed] == 0).all() and (got[flushed] != 0).all()
    assert not _unequal(got[~flushed], want[~flushed]).any()


def test_bf16_subnormal_inputs():
    """Subnormal bf16 inputs: XLA's CPU flushes them (and the result) to
    zero; the port computes them (0.5 x rounded to bf16, or -0 / +0)."""
    x = _bf16_values()
    x = x[(x != 0) & (np.abs(x) < TINY)]
    got, want = _port_fwd(x, torch.bfloat16), _jax_fwd(x, jnp.bfloat16)
    assert (want == 0).all()
    half = torch.from_numpy(x * 0.5).to(torch.bfloat16).float().numpy()
    assert np.array_equal(got, half)


def test_bf16_normal_draws_all_equal():
    """200,000 N(0, 1.5^2) bf16 inputs: 0 unequal (F.gelu, which rounds
    once, differs on ~23% of them)."""
    x = (np.random.RandomState(0).randn(200_000) * 1.5).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    want = _jax_fwd(x, jnp.bfloat16)
    assert not _unequal(_port_fwd(x, torch.bfloat16), want).any()
    one_rounding = F.gelu(torch.from_numpy(x).to(torch.bfloat16)).float()
    assert _unequal(one_rounding.numpy(), want).mean() > 0.15


def test_f32_seeded_sample():
    """f32: 400,000 values over N(0, 3^2) and U(-12, 12), bit-equal but
    for results XLA flushes (subnormal: x below about -13)."""
    rs = np.random.RandomState(1)
    x = np.concatenate([rs.randn(200_000) * 3,
                        rs.uniform(-12, 12, 200_000)]).astype(np.float32)
    got, want = _port_fwd(x, torch.float32), _jax_fwd(x, jnp.float32)
    bad = _unequal(got, want)
    assert (np.abs(got[bad]) < TINY).all() and (want[bad] == 0).all()
    assert bad.sum() <= 10


def test_f32_twins_on_the_emulated_fma(monkeypatch):
    """Where ``torch.addcmul`` is not a fused multiply-add, the twins take
    the float64 emulation: forward and VJP on f32 draws bit-equal to the
    twins on the fused path and to jitted JAX (|x| < 12; the forward's
    flushed results as in :func:`test_f32_seeded_sample`), and equal to
    ``addcmul`` on ties and subnormal sums, where a plain float64 sum
    rounds twice."""
    rs = np.random.RandomState(5)
    x = np.concatenate([rs.randn(50_000) * 3,
                        rs.uniform(-12, 12, 50_000)]).astype(np.float32)
    g = rs.randn(x.size).astype(np.float32)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    addcmul_fuses = gelu._addcmul_fuses("cpu")
    fused = gelu.gelu_erf_ref(xt), gelu.gelu_erf_bwd_ref(xt, gt)
    monkeypatch.setattr(gelu, "_addcmul_fuses", lambda device_type: False)
    emulated = gelu.gelu_erf_ref(xt), gelu.gelu_erf_bwd_ref(xt, gt)
    for a, b in zip(fused, emulated):
        assert not _unequal(a.numpy(), b.numpy()).any()
    want = _jax_fwd(x, jnp.float32)
    bad = _unequal(emulated[0].numpy(), want)
    assert (want[bad] == 0).all() and bad.sum() <= 10
    assert not _unequal(emulated[1].numpy(), np.asarray(_JVJP(x, g))).any()
    # a b + c a hair below a float32 midpoint whose float64 sum rounds
    # onto it: 1 + 2^-23 + 2^-24 - 2^-70 (normal) and 2^-127 + 2^-149 +
    # 2^-150 - 2^-196 (subnormal); once rounded, both stay at c
    a = torch.tensor([1 + 2.0 ** -23, 2.0 ** -75 * (1 + 2.0 ** -23)])
    b = torch.tensor([2.0 ** -24 * (1 - 2.0 ** -23),
                      2.0 ** -75 * (1 - 2.0 ** -23)])
    c = torch.tensor([1 + 2.0 ** -23, 2.0 ** -127 + 2.0 ** -149])
    twice = (a.double() * b.double() + c.double()).float()
    assert (twice != c).all() and torch.equal(gelu._fma_emulated(a, b, c), c)
    if addcmul_fuses:
        assert torch.equal(torch.addcmul(c, a, b), c)


def test_wrong_twins_differ_from_jax(monkeypatch):
    """The one-rounding GELU breaks bit-equality with jitted JAX on bf16
    draws, and the HLO read literally (every product and sum rounded on
    its own, no FMA where XLA's CPU contracts) on f32 draws (in bf16 the
    FMAs' last bits never survive the rounding of these draws)."""
    rs = np.random.RandomState(2)
    x = (rs.randn(200_000) * 1.5).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = _jax_fwd(xt.float().numpy(), jnp.bfloat16)
    assert _unequal(F.gelu(xt).float().numpy(), want).sum() > 1000
    x32 = (rs.randn(200_000) * 3).astype(np.float32)
    monkeypatch.setattr(gelu, "fma_f32",
                        lambda a, b, c: (torch.as_tensor(a) * b) + c)
    assert _unequal(_port_fwd(x32, torch.float32),
                    _jax_fwd(x32, jnp.float32)).sum() > 1000


def test_backward_bf16_every_normal_value():
    """jax.vjp of the jitted GELU on every normal bf16 x with |x| < 8, with
    a seeded bf16 cotangent: bit-equal (0 unequal)."""
    x = _bf16_values()
    x = x[(np.abs(x) < 8) & (np.abs(x) >= TINY)]
    g = (np.random.RandomState(3).randn(x.size)).astype(np.float32)
    xb, gb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, g))
    want = np.asarray(_JVJP(jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
                            jnp.asarray(gb.float().numpy()).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    got = gelu.gelu_erf_bwd_ref(xb, gb).float().numpy()
    assert not _unequal(got, want).any()


def test_backward_f32():
    """jax.vjp in f32 on 200,000 seeded values with |x| < 12 (beyond,
    exp(-x^2 / 2) is subnormal and XLA flushes it): bit-equal."""
    rs = np.random.RandomState(4)
    x = np.concatenate([rs.randn(100_000) * 3,
                        rs.uniform(-12, 12, 100_000)]).astype(np.float32)
    x = np.clip(x, -12, 12)
    g = rs.randn(x.size).astype(np.float32)
    want = np.asarray(_JVJP(x, g))
    got = gelu.gelu_erf_bwd_ref(torch.from_numpy(x),
                                torch.from_numpy(g)).numpy()
    assert not _unequal(got, want).any()


def _all_bf16_and_cotangent():
    """Every bf16 bit pattern as x, and a seeded bf16 cotangent g whose
    first elements are +0, -0, +inf, -inf and NaN (each against every x
    class through the seeded rest)."""
    x = torch.arange(65536, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16)
    g = np.random.RandomState(6).randn(65536).astype(np.float32) * 2
    g[:5] = [0.0, -0.0, np.inf, -np.inf, np.nan]
    g[65536 // 2:65536 // 2 + 5] = g[:5]
    return x, torch.from_numpy(g).to(torch.bfloat16)


def _bf16_round(v):
    """float32 -> bf16 bits (uint32, in the high half), round to nearest
    even; NaN stays a NaN."""
    u = v.astype(np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return np.where(np.isnan(v), u | np.uint32(0x00400000), r).view(np.float32)


def _u16(t):
    return t.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("way", ["forward", "backward"])
def test_kernel_bf16_arithmetic_emulated(way):
    """Kernel G's bf16 design on the CPU, in numpy: the tables built from
    ``_bf16_tables`` as the card holds them (the forward's bf16 bits; the
    backward's word packing bf16 erfc(z) low and bf16 exp(-bf16(bf16(z)^2))
    high), the gather by the 16 input bits, and the backward's products
    that mix x and g in the kernel's order, each rounded to bf16.  Over all
    65,536 bf16 x against a seeded bf16 g with +-0, +-inf and NaN: bit-equal
    to the twins."""
    x, g = _all_bf16_and_cotangent()
    fwd, ec, e = gelu._bf16_tables(torch.device("cpu"))
    bits = _u16(x).astype(np.int64)
    if way == "forward":
        got = (_u16(fwd)[bits].astype(np.uint32) << 16).view(np.float32)
        want = gelu.gelu_erf_ref(x).float().numpy()
        assert not _unequal(got, want).any()
        return
    word = ((ec.numpy().view(np.uint32) >> 16)
            | (e.numpy().view(np.uint32) & np.uint32(0xFFFF0000)))
    w = word[bits]
    ec_x = (w << 16).view(np.float32)
    e_x = (w & np.uint32(0xFFFF0000)).view(np.float32)
    xf, gf = x.float().numpy(), g.float().numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        t = _bf16_round(_bf16_round(_bf16_round(xf * np.float32(0.5)) * gf)
                        * np.float32(-1.125))
        left = -_bf16_round(_bf16_round(t * e_x) * np.float32(0.70703125))
        right = _bf16_round(_bf16_round(gf * ec_x) * np.float32(0.5))
        got = _bf16_round(left + right)
    want = gelu.gelu_erf_bwd_ref(x, g).float().numpy()
    assert not _unequal(got, want).any()
    assert np.isnan(want).sum() > 0 and (want[np.isfinite(want)] != 0).any()


@pytest.mark.parametrize("kind", ["table_negated_index", "bwd_factors_swapped",
                                  "bwd_e_unrounded_z"])
def test_table_design_wrong_twins_differ(kind):
    """``chip_smoke.gelu_wrong``'s faults of G's table design (the forward
    table read at -x, erfc and exp swapped in the packed word, the exp of
    the unrounded z^2) each differ from the twin on more than 100 of the
    65,536 bf16 inputs (the last moves the exp's bf16 value for ~1,100 x,
    and 401 outputs), as phase 30 holds them on the card."""
    from chip_smoke import gelu_wrong

    x, g = _all_bf16_and_cotangent()
    if kind == "table_negated_index":
        got, want = gelu_wrong(x, kind), gelu.gelu_erf_ref(x)
    else:
        got, want = gelu_wrong(x, kind, g), gelu.gelu_erf_bwd_ref(x, g)
    assert _unequal(got.float().numpy(), want.float().numpy()).sum() > 100


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_pair_saves_x_only(dtype):
    """``gelu_erf`` runs the forward op, saves only x, and its backward is
    ``dupl::gelu_erf_bwd`` (the twins on the CPU); no FLOPs counted."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(3, 40, 64).astype(np.float32)).to(dtype)
    x.requires_grad_(True)
    y = gelu.gelu_erf(x)
    assert torch.equal(y.detach(), gelu.gelu_erf_ref(x.detach()))
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == x.data_ptr()
    g = torch.from_numpy(rs.randn(3, 40, 64).astype(np.float32)).to(dtype)
    y.backward(g)
    assert torch.equal(x.grad, gelu.gelu_erf_bwd_ref(x.detach(), g))
    assert flops.count_flops(gelu.gelu_erf, x.detach()) == 0


def test_float16_exact_gelu_is_refused_where_configured():
    """Where G refuses a dtype: no longer float16, since it has an f16
    mode (a float16 ViT with the exact GELU builds and runs its blocks'
    GELU in f16, as the tanh GELU and the int8 path do), but a dtype it has
    no mode for,
    naming it."""
    from dupl_tpu_torch.models.vit import VIT_CONFIGS, ViT

    spec = VIT_CONFIGS["test_tiny_patch16"]
    vit = ViT(spec, compute_dtype=torch.float16, gelu_approximate=False)
    h = torch.randn(2, 3, vit.blocks[0].mlp.fc1.out_features).half()
    assert torch.equal(gelu.gelu_erf(h), gelu.gelu_erf_ref(h))
    ViT(spec, compute_dtype=torch.float16, gelu_approximate=True)
    ViT(spec, compute_dtype=torch.float16, gelu_approximate=False, quant=True)
    with pytest.raises(TypeError, match="torch.float64"):
        gelu.gelu_erf(torch.zeros(3, dtype=torch.float64))


# Bounds over the output's largest magnitude s: at most ``max_ulps`` bf16
# ulps of s anywhere, ``mean`` * s on average, ``share`` of the elements
# unequal.  Op by op: the JAX block run eagerly with its GELU jitted, as the
# JAX package always runs it (eager, jax.nn.gelu rounds its erfc argument
# to bf16, which jit does not); read: bf16 stream 0.5 ulp, 2.0e-6 * s,
# 0.21%; fp32 stream 0.5 ulp, 2.2e-6 * s, 0.37%.  With F.gelu's one
# rounding the port read 3.3e-4 * s and 32% / 45% unequal, outside them.
# Jitted, XLA keeps the residual sum unrounded into the next LayerNorm
# (excess precision), so 2 ulps and 2e-3 * s (read 1 / 1.44 ulps, 6.8e-4 /
# 6.4e-4 * s).
BLOCK_BOUNDS = {"op_by_op": (1.0, 1e-5, 0.01), "jit": (2.0, 2e-3, 1.0)}


def _block_err(stream, mode, monkeypatch, port_gelu=None):
    """(max in bf16 ulps of s, mean / s, share unequal) of the erf block
    against the JAX one (``tests/test_torch_bench.py:_blocks``)."""
    jb, params, xj, tb, tx = _blocks(stream, gelu_approximate=False)
    if mode == "jit":
        want = jax.jit(jb.apply)(params, xj)
    else:
        import flax.linen

        def jitted_gelu(x, approximate=False):
            assert not approximate
            with jax.disable_jit(False):
                return _JGELU(x)

        with monkeypatch.context() as m, jax.disable_jit():
            m.setattr(flax.linen, "gelu", jitted_gelu)
            want = jb.apply(params, xj)
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad(), monkeypatch.context() as m:
        if port_gelu is not None:
            import dupl_tpu_torch.models.vit as tvit
            m.setattr(tvit, "gelu_erf", port_gelu)
        got = tb(tx)
    assert got.dtype == getattr(torch, stream)
    got = got.float().numpy()
    s = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(s)) - 7)
    err = np.abs(got - want)
    return err.max() / ulp, err.mean() / s, (err > 0).mean()


@pytest.mark.parametrize("stream", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["op_by_op", "jit"])
def test_block_matches_jax(stream, mode, monkeypatch):
    """The bf16-compute block with the erf GELU against the JAX block, op by
    op (GELU jitted) and jitted, on both residual streams, within
    ``BLOCK_BOUNDS``; op by op, the one-rounding F.gelu falls outside."""
    bound = BLOCK_BOUNDS[mode]
    got = _block_err(stream, mode, monkeypatch)
    assert all(g <= b for g, b in zip(got, bound)), (got, bound)
    if mode == "op_by_op":
        wrong = _block_err(stream, mode, monkeypatch, port_gelu=F.gelu)
        assert wrong[1] > bound[1] and wrong[2] > bound[2], wrong
