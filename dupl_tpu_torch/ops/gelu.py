"""The GELUs as the jitted JAX package computes them: the exact (erf) one,
kernel G, and the tanh one.

``jax.nn.gelu(x, approximate=False)`` is ``0.5 * x * erfc(-x * sqrt(1/2))``.
Under ``jax.jit`` (the JAX package always runs its model jitted) XLA fuses
the whole expression into one loop and expands ``erfc`` into its own f32
polynomial (an ``exp`` and two branches; no libm call), and its ``exp``
into its own polynomial too.  On bf16 ``x`` the jitted function is

    bf16( bf16(0.5 * x) * bf16( erfc( f32(-x) * 0.70703125 ) ) )

with 0.70703125 the bf16 rounding of sqrt(1/2) and the ``erfc`` argument
never rounded to bf16; on f32 ``x`` it is ``(0.5 * x) * erfc(-x *
0x1.6a09e6p-1)`` in f32.  ``F.gelu`` rounds once and ``torch.special.erfc``
is another function (45% of f32 inputs differ, by up to 1.04e-5 relative),
so neither gives the JAX package's bits.

:func:`gelu_erf_ref` and :func:`gelu_erf_bwd_ref` are the plain twins: the
expression above and the derivative that ``jax.vjp`` of the jitted function
computes, in the input's dtype, with XLA's ``erfc`` and ``exp`` written out
(``_erfc_xla``, ``_exp_xla``).  The constants, branches and order of
operations were read from the compiled HLO and LLVM IR of
``jax.jit(jax.lax.erfc)`` and of the jitted GELU and its VJP on the CPU
(jax 0.9.0: ``.lower(x).compile().as_text()`` and
``XLA_FLAGS=--xla_dump_to``).  XLA's CPU code generator contracts each
Horner step ``acc * w + c`` of both expansions, ``1 - z * P`` and the exp's
range reduction into fused multiply-adds; nothing else.  The twins take
those steps as exactly rounded FMAs (``fma_f32``) and every other operation
rounded on its own.  They equal the jitted JAX function bit for bit on every
normal bf16 input and on f32 (``tests/test_torch_gelu.py``); XLA's CPU
flushes subnormal inputs and results to zero, which the twins do not.

On f16 ``x`` XLA keeps the fused loop in f16, and its CPU code generator
(on an x86 host with AVX512-FP16: ``vmulph``, ``vfmadd231ph``) rounds every
f16 operation on its own; only the ``erfc`` and the exps run in f32:

    f16( f16(0.5 * x) * f16( erfc( f32( f16(-x * s) ) ) ) )

with s = f16(sqrt(1/2)) = 0.70703125, so the ``erfc`` argument IS rounded,
unlike bf16.  The VJP rounds every product to f16, takes its exp of
``-f16(z * z)`` in f32 rounded to f16, and contracts the last product with
the sum into one f16 FMA (:func:`_fma_f16`).  f16 arithmetic there keeps
subnormals, and so do the twins: they equal the jitted function on every
finite f16 input.

``dupl::gelu_erf`` and ``dupl::gelu_erf_bwd`` (``ops/library.py``) run the
twins on CPU tensors and kernel G (``csrc/gelu_erf.cu``: one elementwise
pass each, the same roundings; bf16 and f16 read tables of all 65,536
inputs that G's own code builds on the device, as the twins read
``_bf16_tables`` and ``_f16_tables``) on CUDA tensors.  :func:`gelu_erf`
pairs them in a ``torch.autograd.Function`` that saves only ``x``.  Their flop formula
is 0: elementwise work is not counted (``utils/flops.py``).

:func:`gelu_tanh` is ``jax.nn.gelu(x, approximate=True)`` as jitted JAX
computes it.  In bf16 that is nine operations rounded one at a time.  In
f32 XLA expands ``tanh`` into its own rational approximation, read from the
LLVM IR and the machine code of the jitted function on the CPU (jax 0.9.0):
``v = fma(x^3, 0.044715, x) * sqrt(2/pi)``; ``v`` itself below |v| =
0x1.a36e2ep-12; else ``v`` clamped to +-0x1.ffec88p+2 and ``v P(v^2) /
Q(v^2)`` with each Horner step one FMA and an IEEE division; +-1 from |v|
= 20; then ``x ((t + 1) 0.5)``.  XLA's CPU flushes subnormal inputs and
results to zero, and so does the f32 twin (the card's kernel, the fused
GELU of ``ops/quant.py``'s fc2 quantization, does the same).  In f16 the
operations are f16 ones, each rounded, ``x^3 * c + x`` one f16 FMA, and the
tanh is the f32 rational one on ``f32(v)``, rounded to f16; subnormals are
kept, as in bf16 (XLA's f16 arithmetic keeps them too).  Its backward is
the f16 VJP of ``jax.vjp`` of the jitted function (:class:`_GeluTanhF16`),
read from the same code: f16 operations with three f16 FMAs.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from dupl_tpu_torch.ops import library
from dupl_tpu_torch.ops.attention import _raw_stream, _require_cuda

_BF16, _F16, _F32 = torch.bfloat16, torch.float16, torch.float32
_DTYPES = (_BF16, _F16, _F32)
# G's dtype code (csrc/gelu_erf.cu): 0 fp32, 1 bf16, 2 f16
_MODE = {_F32: 0, _BF16: 1, _F16: 2}


def _hex(*values: str):
    return tuple(float.fromhex(v) for v in values)


# XLA's f32 erfc (the constants of jax.jit(jax.lax.erfc)'s compiled HLO).
# |z| < 1: 1 - z * P(z^2)
_ERFC_SMALL = _hex("0x1.496a32p-14", "-0x1.a3f7p-11", "0x1.5405b2p-8",
                   "-0x1.b7f90ep-6", "0x1.ce2cf8p-4", "-0x1.81273ep-2",
                   "0x1.20dd74p+0")
# 1 <= |z| < 2: exp(-z^2) * (1 / |z|) * Q(1 / z^2)
_ERFC_MID = _hex("0x1.7d39e8p-6", "-0x1.1c10dp-3", "0x1.7997ap-2",
                 "-0x1.2a39fp-1", "0x1.3df3c6p-1", "-0x1.fa518p-2",
                 "0x1.5ca8e2p-2", "-0x1.18b1p-2", "0x1.20adccp-1")
# |z| >= 2: the same with R(1 / z^2); 0 once -z^2 < -88.7228394
_ERFC_BIG = _hex("-0x1.4f4906p+3", "0x1.9f4538p+3", "-0x1.dfb694p+2",
                 "0x1.75e3f4p+1", "-0x1.03e86cp+0", "0x1.aff87cp-2",
                 "-0x1.20d8bap-2", "0x1.20dd72p-1")
_ERFC_UNDERFLOW = float.fromhex("-0x1.62e43p+6")
# XLA's f32 exp (its CPU expansion, inlined in the fused loop): clamp, n =
# floor(x log2 e + 1/2) in [-127, 127], r = x - n ln2 in two parts,
# exp(r) = 1 + r + r^2 P(r), times 2^n built in the exponent bits
_EXP_LO, _EXP_HI = _hex("-0x1.5f3334p+6", "0x1.633334p+6")
_LOG2E, _LN2_HI, _LN2_LO = _hex("0x1.715476p+0", "0x1.63p-1",
                                "-0x1.bd0106p-13")
_EXP_POLY = _hex("0x1.a0d2cep-13", "0x1.6e879cp-10", "0x1.11121p-7",
                 "0x1.555382p-5", "0x1.555554p-3", "0x1p-1")
# sqrt(1/2) and -2/sqrt(pi) in the input's dtype, as jax.nn.gelu and its
# VJP round them
_SQRT_HALF = {_BF16: 0.70703125, _F16: 0.70703125,
              _F32: float.fromhex("0x1.6a09e6p-1")}
_NEG_TWO_OVER_SQRT_PI = {_BF16: -1.125, _F16: float.fromhex("-0x1.20cp+0"),
                         _F32: float.fromhex("-0x1.20dd76p+0")}


def _as64(t):
    """float64 of a tensor; a Python float is already one."""
    return t.double() if isinstance(t, torch.Tensor) else t


def _round_to_odd(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``p + c`` of float64 or float32 values rounded to odd: TwoSum's error
    picks the odd neighbour of an inexact sum."""
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    bits = s.view(torch.int64 if s.dtype == torch.float64 else torch.int32)
    even = (bits & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, away), s)


# float64 bits: the low 29 bits of a float32 midpoint; |x| below 2^-126
_F32_TIE = (1 << 29) - 1, 1 << 28
_ABS_BITS, _F32_TINY_BITS = (1 << 63) - 1, (1023 - 126) << 52


def _fma_emulated(a, b, c) -> torch.Tensor:
    """:func:`fma_f32` in float64: the product is exact there and the sum
    rounds once; rounding that to float32 is exact unless it lies on a
    float32 midpoint (or in the subnormal range), where the sum is taken
    again rounded to odd (53 >= 24 + 2 bits)."""
    p = _as64(a) * _as64(b)
    c64 = _as64(c)
    s = p + c64
    bits = s.view(torch.int64)
    mask, tie = _F32_TIE
    mag = bits & _ABS_BITS
    fix = ((bits & mask) == tie) | ((mag < _F32_TINY_BITS) & (mag != 0))
    if bool(fix.any()):
        if not isinstance(c64, torch.Tensor):
            c64 = torch.full_like(s, c64)
        s = torch.where(fix, _round_to_odd(p, c64.expand_as(s)), s)
    return s.float()


def _f32(v, device) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor)
            else torch.tensor(v, dtype=_F32, device=device))


@functools.lru_cache(maxsize=None)
def _addcmul_fuses(device_type: str) -> bool:
    """Whether ``torch.addcmul`` on this device type rounds ``c + a * b``
    once, as the kernels of a build compiled with FMA contraction do.  A
    build's vector body, scalar tail and broadcast loops are probed against
    :func:`_fma_emulated` on draws where one rounding and two differ on
    about a quarter of the elements."""
    gen = torch.Generator().manual_seed(0)
    ok = True
    for n in (1, 3, 8, 15, 16, 17, 31, 33, 64, 1000, 70001):
        a, b, c = (torch.randn(3, n, generator=gen)
                   * torch.tensor([[1.0], [1.0], [1e-3]])).to(device_type)
        for cc, bb in ((c, b), (c[:1].reshape(()), b), (c, b[:1].reshape(()))):
            ok &= torch.equal(torch.addcmul(cc, a, bb),
                              _fma_emulated(a, bb, cc))
    return bool(ok)


def fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` of float32 values (tensors or Python floats) rounded
    once: ``torch.addcmul`` where it is a fused multiply-add
    (:func:`_addcmul_fuses`), else :func:`_fma_emulated`."""
    t = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
    if _addcmul_fuses(t.device.type):
        return torch.addcmul(_f32(c, t.device), _f32(a, t.device),
                             _f32(b, t.device))
    return _fma_emulated(a, b, c)


def _fma_f16(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float16 values (``b`` may be a Python float that
    float16 holds) rounded once to float16, as an f16 FMA: the product is
    exact in float32, the sum is rounded to odd there (24 bits >= 11 + 2),
    so that the last rounding, to float16, is the only one that counts."""
    p = a.float() * b
    c32 = c.float().expand_as(p)
    s = p + c32
    return torch.where(torch.isfinite(s), _round_to_odd(p, c32), s).half()


def _exp_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 exp on the CPU, bit for bit."""
    x = x.clamp(_EXP_LO, _EXP_HI)
    n = torch.floor(fma_f32(x, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma_f32(-n, _LN2_HI, x)
    r = fma_f32(-n, _LN2_LO, r)
    p = fma_f32(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        p = fma_f32(p, r, c)
    y = fma_f32(p, r * r, r) + 1.0
    two_n = torch.bitwise_left_shift(n.to(torch.int32) + 127, 23)
    return y * two_n.view(_F32)


@functools.lru_cache(maxsize=None)
def _erfc_coefs(device: torch.device) -> torch.Tensor:
    """(9, 3) f32: step i of the three expansions' Horner schemes for
    |z| < 1, < 2 and beyond, the shorter ones led by zeros (``fma(v, 0,
    0)`` and ``fma(0, v, c)`` are exact, so a zero step changes nothing)."""
    rows = [(0.0,) * (9 - len(p)) + p
            for p in (_ERFC_SMALL, _ERFC_MID, _ERFC_BIG)]
    return torch.tensor(rows, dtype=_F32, device=device).t().contiguous()


def _erfc_xla(z: torch.Tensor, e: torch.Tensor = None) -> torch.Tensor:
    """XLA's f32 erfc, bit for bit; ``e``: exp(-z^2) if already computed
    (XLA's VJP shares it).  Each element's branch runs the same 9 Horner
    steps on its own variable (z^2 below 1, else 1 / z^2) and coefficients."""
    az = z.abs()
    z2 = z * z
    nz2 = -z2
    if e is None:
        e = _exp_xla(nz2)
    one = torch.ones_like(z)
    w = torch.div(one, z2)
    small = az < 1.0
    branch = (az >= 1.0).long() + (az >= 2.0).long()
    v = torch.where(small, z2, w)
    coefs = _erfc_coefs(z.device).index_select(1, branch.flatten()).view(
        9, *z.shape)
    acc = fma_f32(v, coefs[0], coefs[1])
    for i in range(2, 9):
        acc = fma_f32(acc, v, coefs[i])
    y = (e * torch.div(one, az)) * acc
    y = torch.where(nz2 < _ERFC_UNDERFLOW, torch.zeros_like(y), y)
    y = torch.where(z < 0, 2.0 - y, y)
    return torch.where(small, fma_f32(-z, acc, 1.0), y)


def _check_dtype(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x must be bfloat16, float16 or float32, "
                        f"got {x.dtype}")


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(_BF16).float()


@functools.lru_cache(maxsize=None)
def _bf16_tables(device: torch.device):
    """Over all 65,536 bf16 values x (indexed by their bits): the forward's
    result, and the backward's two x-only factors, bf16(erfc(z)) and
    bf16(exp(-bf16(bf16(z)^2))) with z = f32(-x) * bf16(sqrt(1/2)), as
    float32."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=device)
    x = bits.to(torch.int16).view(_BF16)
    z = (-x).float() * _SQRT_HALF[_BF16]
    ec = _bf(_erfc_xla(z))
    fwd = (_bf(x.float() * 0.5) * ec).to(_BF16)
    zb = _bf(z)
    e = _bf(_exp_xla(-_bf(zb * zb)))
    order = torch.argsort(bits & 0xFFFF)      # table index = bits & 0xFFFF
    return fwd[order], ec[order], e[order]


@functools.lru_cache(maxsize=None)
def _f16_tables(device: torch.device):
    """The same over all 65,536 f16 values x: the forward's result,
    f16(erfc(f32(z))) and f16(exp(-f16(z^2))) with z = f16(-x s), each f16
    operation rounded on its own (module docstring), as float16."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=device)
    x = bits.to(torch.int16).view(_F16)
    z = (-x) * _SQRT_HALF[_F16]
    ec = _erfc_xla(z.float()).half()
    fwd = (x * 0.5) * ec
    e = _exp_xla((-(z * z)).float()).half()
    order = torch.argsort(bits & 0xFFFF)
    return fwd[order], ec[order], e[order]


def _table_index(x: torch.Tensor) -> torch.Tensor:
    """The table index of 16-bit values: their bits."""
    return x.view(torch.int16).to(torch.int32).bitwise_and(0xFFFF).long()


def gelu_erf_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of G's forward: ``jax.jit(jax.nn.gelu(approximate=
    False))`` on bf16, f16 or f32 ``x``, in ``x``'s dtype.  bf16 and f16
    read the function's value from a table of all 65,536 inputs made by the
    same expression."""
    _check_dtype(x, "gelu_erf")
    with torch.no_grad():
        if x.dtype == _BF16:
            return _bf16_tables(x.device)[0][_table_index(x)]
        if x.dtype == _F16:
            return _f16_tables(x.device)[0][_table_index(x)]
        z = (-x) * _SQRT_HALF[_F32]
        return (x * 0.5) * _erfc_xla(z)


def gelu_erf_bwd_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain twin of G's backward: the input cotangent that ``jax.vjp`` of
    the jitted GELU gives for the output cotangent ``g``, in ``x``'s dtype:
    ``-(((0.5x g) c) exp(-z^2)) s + (g erfc(z)) 0.5`` with ``z = -x s``, ``s``
    = sqrt(1/2) and ``c`` = -2/sqrt(pi) in that dtype.  In bf16 every
    product rounds, and the exp's argument is ``-bf16(bf16(z)^2)``; the
    erfc is the forward's (f32 ``z``); the two factors that depend on x
    alone come from tables of all bf16 inputs.  In f16 the same, but ``z``
    and ``z^2`` are f16 products and the last product and the sum are one
    f16 FMA.  In f32 the erfc shares the exp, and the last product and the
    sum are one FMA."""
    _check_dtype(x, "gelu_erf_bwd")
    if g.dtype != x.dtype or g.shape != x.shape:
        raise ValueError(f"gelu_erf_bwd: g must be {x.dtype} of shape "
                         f"{tuple(x.shape)}, got {g.dtype} "
                         f"{tuple(g.shape)}")
    dt = x.dtype
    s, c = _SQRT_HALF[dt], _NEG_TWO_OVER_SQRT_PI[dt]
    with torch.no_grad():
        if dt == _BF16:
            _, ec_tab, e_tab = _bf16_tables(x.device)
            i = _table_index(x)
            gf = g.float()
            t = _bf(_bf(_bf(x.float() * 0.5) * gf) * c)
            left = -_bf(_bf(t * e_tab[i]) * s)
            right = _bf(_bf(gf * ec_tab[i]) * 0.5)
            return (left + right).to(_BF16)
        if dt == _F16:
            _, ec_tab, e_tab = _f16_tables(x.device)
            i = _table_index(x)
            t = (((x * 0.5) * g) * c) * e_tab[i]
            right = (g * ec_tab[i]) * 0.5
            return _fma_f16(-t, s, right)      # XLA contracts the last step
        t = ((x * 0.5) * g) * c
        z = (-x) * s
        e = _exp_xla(-(z * z))
        right = (g * _erfc_xla(z, e)) * 0.5
        return fma_f32(-(t * e), s, right)   # XLA contracts the last step


# XLA's f32 tanh inside the jitted tanh GELU (the hex literals of its LLVM
# IR): the inner cubic's coefficient and sqrt(2/pi); below _TANH_SMALL
# tanh(v) is v; the clamp; the numerator's and denominator's Horner
# coefficients in v^2, highest first
_TANH_C3, _TANH_S = _hex("0x1.6e4e26p-5", "0x1.988454p-1")
_TANH_SMALL, _TANH_CLAMP = _hex("0x1.a36e2ep-12", "0x1.ffec88p+2")
_TANH_P = _hex("-0x1.3e4b8p-52", "0x1.c266fcp-43", "-0x1.7a6ffep-34",
               "0x1.b80082p-25", "0x1.f28694p-17", "0x1.4e1bdap-11",
               "0x1.40b3b8p-8")
_TANH_Q = _hex("0x1.41a7bp-20", "0x1.f12bacp-14", "0x1.29540ap-9",
               "0x1.40b3bap-8")
_F32_TINY = 2.0 ** -126


def _flush(t: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values to zero of the same sign, as XLA's CPU does."""
    return torch.where(t.abs() < _F32_TINY, t * 0.0, t)


def _tanh_xla(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 tanh inside the jitted tanh GELU, bit for bit."""
    vc = v.clamp(-_TANH_CLAMP, _TANH_CLAMP)
    v2 = vc * vc
    p = fma_f32(v2, _TANH_P[0], _TANH_P[1])
    for c in _TANH_P[2:]:
        p = fma_f32(p, v2, c)
    q = fma_f32(v2, _TANH_Q[0], _TANH_Q[1])
    for c in _TANH_Q[2:]:
        q = fma_f32(q, v2, c)
    t = torch.where(v.abs() < _TANH_SMALL, v, (vc * p) / q)
    return torch.where(v.abs() >= 20.0, torch.copysign(torch.ones_like(v), v),
                       t)


def _gelu_tanh_f32(x: torch.Tensor) -> torch.Tensor:
    """The jitted f32 tanh GELU, bit for bit (module docstring)."""
    x = _flush(x)
    t = _tanh_xla(fma_f32((x * x) * x, _TANH_C3, x) * _TANH_S)
    return _flush(x * ((t + 1.0) * 0.5))


# jax.nn.gelu(approximate=True)'s constants in f16: the cubic's
# coefficient, sqrt(2/pi), and their f16 product, which XLA folds into the
# VJP's chain
_TANH_F16_C3, _TANH_F16_S, _TANH_F16_CS = 0.044708251953125, 0.7978515625, \
    0.035675048828125


def _tanh_f16(x: torch.Tensor):
    """``x * x`` and the tanh of the jitted f16 tanh GELU: the cubic's ``x^3
    c + x`` one f16 FMA, XLA's f32 tanh of ``f32(v)`` rounded to f16."""
    xx = x * x
    v = _fma_f16(xx * x, _TANH_F16_C3, x) * _TANH_F16_S
    return xx, _tanh_xla(v.float()).half()


@functools.lru_cache(maxsize=None)
def _f16_tanh_tables(device: torch.device):
    """Over all 65,536 f16 values x (indexed by their bits): the jitted f16
    tanh GELU's result, its tanh t and ``x * x``, as float16."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=device)
    x = bits.to(torch.int16).view(_F16)
    xx, t = _tanh_f16(x)
    order = torch.argsort(bits & 0xFFFF)
    return (x * ((t + 1.0) * 0.5))[order], t[order], xx[order]


class _GeluTanhF16(torch.autograd.Function):
    """The jitted f16 tanh GELU and its ``jax.vjp``, bit for bit; saves only
    ``x``.  The forward, and the backward's tanh and ``x * x``, depend on
    the 16 input bits alone and are read from :func:`_f16_tanh_tables`.
    The VJP is XLA's fused loop: every product and sum an f16 operation,
    three of them contracted into f16 FMAs, and the cubic's chain rule by
    the folded constant c s."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _f16_tanh_tables(x.device)[0][_table_index(x)]

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        _, t_tab, xx_tab = _f16_tanh_tables(x.device)
        i = _table_index(x)
        t, xx = t_tab[i], xx_tab[i]
        g = g.to(_F16)
        d = ((x * g) * 0.5) * (1.0 - t)
        d = _fma_f16(d, t, d)                 # the tanh's 1 - t^2
        dx = _fma_f16(g, (t + 1.0) * 0.5, d * _TANH_F16_S)
        return _fma_f16(d * _TANH_F16_CS, xx * 3.0, dx)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU as jitted ``jax.nn.gelu(approximate=True)``
    computes it.  f32: XLA's expansion; f16: its f16 recipe (module
    docstring), and the backward its VJP's.  Other dtypes:
    ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x^3))))`` one operation at
    a time in ``x``'s dtype, the constants rounded to it and ``x^3`` as
    ``x * (x * x)``; in bf16 this rounds where the JAX package rounds
    (``F.gelu(approximate="tanh")`` rounds once, and differs in the last
    bit on ~40% of elements)."""
    if x.dtype == _F32:
        return _gelu_tanh_f32(x)
    if x.dtype == _F16:
        return _GeluTanhF16.apply(x)

    def c(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    inner = c(math.sqrt(2 / math.pi)) * (x + c(0.044715) * (x * (x * x)))
    return x * (c(0.5) * (c(1.0) + torch.tanh(inner)))


@functools.lru_cache(maxsize=None)
def _entries():
    """The C entry points of ``csrc/gelu_erf.cu``, built on first use."""
    from dupl_tpu_torch.kernels import build

    lib = build.load("gelu_erf")
    fwd, bwd = lib.dupl_gelu_erf_fwd, lib.dupl_gelu_erf_bwd
    for fn, n_ptr in ((fwd, 2), (bwd, 3)):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    return fwd, bwd


def _check_cuda(x: torch.Tensor, name: str, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: {name} must be on a CUDA device, got "
                         f"{x.device}")
    _check_dtype(x, what)
    if not x.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _fwd_kernel(x: torch.Tensor) -> torch.Tensor:
    """``dupl::gelu_erf`` on CUDA tensors: kernel G's forward on the
    current stream."""
    from dupl_tpu_torch.kernels import build

    _check_cuda(x, "x", "gelu_erf")
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            status = _entries()[0](x.data_ptr(), out.data_ptr(), x.numel(),
                                   _MODE[x.dtype],
                                   _raw_stream(x.device))
        build.check(status, "gelu_erf")
        gelu_erf_cuda.launches += 1
        gelu_erf_cuda.launches_f16 += x.dtype == _F16
    return out


def _bwd_kernel(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``dupl::gelu_erf_bwd`` on CUDA tensors: kernel G's backward on the
    current stream."""
    from dupl_tpu_torch.kernels import build

    _check_cuda(x, "x", "gelu_erf_bwd")
    _check_cuda(g, "g", "gelu_erf_bwd")
    if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device:
        raise ValueError(f"gelu_erf_bwd: g must match x ({x.dtype} "
                         f"{tuple(x.shape)} on {x.device}), got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            status = _entries()[1](x.data_ptr(), g.data_ptr(),
                                   out.data_ptr(), x.numel(),
                                   _MODE[x.dtype],
                                   _raw_stream(x.device))
        build.check(status, "gelu_erf_bwd")
        gelu_erf_bwd_cuda.launches += 1
    return out


def _like(x, *_):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


# G as the ops dupl::gelu_erf and dupl::gelu_erf_bwd: the launchers above
# on CUDA tensors, the plain twins on CPU tensors.  Elementwise work counts
# no FLOPs (utils/flops.py), as for K3 and K4.
_G = library.register("gelu_erf(Tensor x) -> Tensor", cuda=_fwd_kernel,
                      cpu=gelu_erf_ref, fake=_like, flops=lambda x: 0)
_G_BWD = library.register("gelu_erf_bwd(Tensor x, Tensor g) -> Tensor",
                          cuda=_bwd_kernel, cpu=gelu_erf_bwd_ref, fake=_like,
                          flops=lambda x, g: 0)


def gelu_erf_cuda(x: torch.Tensor) -> torch.Tensor:
    """Kernel G's forward on a CUDA tensor, through ``dupl::gelu_erf``;
    raises for any other device.  Counts in ``gelu_erf_cuda.launches``, the
    f16 mode's also in ``gelu_erf_cuda.launches_f16``."""
    _require_cuda("gelu_erf", x)
    return _G(x)


gelu_erf_cuda.launches = gelu_erf_cuda.launches_f16 = 0


def gelu_erf_bwd_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel G's backward on CUDA tensors, through ``dupl::gelu_erf_bwd``;
    raises for any other device.  Counts in
    ``gelu_erf_bwd_cuda.launches``."""
    _require_cuda("gelu_erf_bwd", x)
    return _G_BWD(x, g)


gelu_erf_bwd_cuda.launches = 0


class _GeluErf(torch.autograd.Function):
    """G's forward and backward through their ops; saves only ``x`` (the
    expansion's intermediates are recomputed by the backward)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _G(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _G_BWD(x, g.to(x.dtype).contiguous())


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU of the JAX package (bf16, f16 or f32, any shape): CPU
    tensors run the twins, CUDA tensors kernel G, forward and backward."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gelu_erf: unsupported device {x.device}")
    return _GeluErf.apply(x.contiguous())
