"""The kernels of the four kernel-experiment tools (counterparts of the
Pallas kernels in ``tools/exp_attn_experiment.py``,
``tools/exp_attn_layout_experiment.py``, ``tools/crf_apply_experiment.py``
and ``tools/exp_rate_experiment.py``).

Each kernel has a plain twin with the kernel's roundings (``*_ref``), a
wrapper that launches the CUDA kernel and counts its launches (``*_cuda``),
and a dispatcher: CPU tensors take the twin, CUDA tensors launch the kernel
or raise.

* P1 ``exp_attention_ones`` (``csrc/exp_attention_ones.cu``): exp attention
  whose row sum is a column of the second product, so the denominator sums
  the bf16-rounded e.
* P2 ``exp_attention_bnhd`` (``csrc/exp_attention_bnhd.cu``): exp attention
  on (B, N, H, D) operands with the q scale applied inside the kernel.
* P3 ``kernel_apply_bf16`` (``csrc/crf_apply_bf16.cu``): the CRF
  kernel-apply with the clamped score rounded to bf16 before the exp, any
  number of value columns.
* P4 ``exp_rate`` (``csrc/exp_rate.cu``): the instruction-rate probe,
  ``acc <- acc + f(x + acc * 1e-9)`` for ``iters`` passes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dupl_tpu_torch.ops.attention import _LOGIT_CLAMP, _check_flash_operands
from dupl_tpu_torch.ops.crf_cuda import _values_bf16

_DIM = 11
RATE_FNS = ("mul", "exp", "exp2", "exp_min", "tanh", "expf")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16, keep computing in fp32."""
    return x.to(torch.bfloat16).float()


def bf16_scale(scale: float) -> float:
    """``scale`` rounded to bf16, as jax rounds a Python scalar that meets a
    bf16 array."""
    return torch.tensor(scale, dtype=torch.bfloat16).item()


# --------------------------------------------------------------------- P1
def exp_attention_ones_ref(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Plain twin of P1: q pre-scaled, (..., N, D) -> (..., N, D) float32
    (the kernel rounds it to bf16 once).  Operands rounded to bf16, s and
    both contractions in fp32; numerator and denominator both sum
    bf16(e)."""
    qf, kf, vf = _bf16(q), _bf16(k), _bf16(v)
    s = torch.matmul(qf, kf.transpose(-1, -2))
    e = _bf16(torch.exp(torch.clamp(s, max=_LOGIT_CLAMP)))
    return torch.matmul(e, vf) / e.sum(dim=-1, keepdim=True)


@functools.lru_cache(maxsize=None)
def _ones_entry():
    from dupl_tpu_torch.kernels import build

    fn = build.load("exp_attention_ones").dupl_exp_attention_ones
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    return fn


def _strides(q, k, v):
    return (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                *v.stride()[:3])


def exp_attention_ones_cuda(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor) -> torch.Tensor:
    """Launch kernel P1 on the current stream.  q (pre-scaled), k, v:
    (B, N, H, D) bf16 on one CUDA device, possibly strided views ->
    (B, N, H, D) bf16."""
    from dupl_tpu_torch.kernels import build

    _check_flash_operands("exp_attention_ones",
                          ((q, "q"), (k, "k"), (v, "v")))
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _ones_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), b, n, h, d, _strides(q, k, v),
                               stream)
    build.check(status, "exp_attention_ones")
    exp_attention_ones_cuda.launches += 1
    return out


exp_attention_ones_cuda.launches = 0


def exp_attention_ones(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """P1 on (BH, N, D) operands, q pre-scaled, as the tool calls it ->
    (BH, N, D) bf16."""
    if q.device.type == "cpu":
        return exp_attention_ones_ref(q, k, v).to(torch.bfloat16)
    if q.device.type != "cuda":
        raise ValueError(f"exp_attention_ones: unsupported device {q.device}")
    # (BH, N, D) is the kernel's (B, N, H, D) with one head
    return exp_attention_ones_cuda(q.unsqueeze(2), k.unsqueeze(2),
                                   v.unsqueeze(2)).squeeze(2)


# --------------------------------------------------------------------- P2
def exp_attention_bnhd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float = 0.125) -> torch.Tensor:
    """Plain twin of P2: unscaled q, k, v, each (B, N, H, D) -> (B, N, H, D)
    float32.  q times the bf16-rounded scale, rounded to bf16; then the exp
    attention's roundings: s in fp32, the denominator sums the fp32 e, the
    numerator contracts bf16(e)."""
    qs = _bf16(_bf16(q) * bf16_scale(scale)).permute(0, 2, 1, 3)
    kf, vf = _bf16(k).permute(0, 2, 1, 3), _bf16(v).permute(0, 2, 1, 3)
    s = torch.matmul(qs, kf.transpose(-1, -2))
    e = torch.exp(torch.clamp(s, max=_LOGIT_CLAMP))
    out = torch.matmul(_bf16(e), vf) / e.sum(dim=-1, keepdim=True)
    return out.permute(0, 2, 1, 3)


@functools.lru_cache(maxsize=None)
def _bnhd_entry():
    from dupl_tpu_torch.kernels import build

    fn = build.load("exp_attention_bnhd").dupl_exp_attention_bnhd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_int64),
                      ctypes.c_void_p])
    return fn


def exp_attention_bnhd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float = 0.125) -> torch.Tensor:
    """Launch kernel P2 on the current stream.  Unscaled q, k, v:
    (B, N, H, D) bf16 on one CUDA device, possibly strided views ->
    (B, N, H, D) bf16.  The scale is rounded to bf16 here and multiplied in
    the kernel."""
    from dupl_tpu_torch.kernels import build

    _check_flash_operands("exp_attention_bnhd",
                          ((q, "q"), (k, "k"), (v, "v")))
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _bnhd_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), b, n, h, d, bf16_scale(scale),
                               _strides(q, k, v), stream)
    build.check(status, "exp_attention_bnhd")
    exp_attention_bnhd_cuda.launches += 1
    return out


exp_attention_bnhd_cuda.launches = 0


def exp_attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float = 0.125) -> torch.Tensor:
    """P2: unscaled (B, N, H, D) operands -> (B, N, H, D) bf16."""
    if q.device.type == "cpu":
        return exp_attention_bnhd_ref(q, k, v, scale).to(torch.bfloat16)
    if q.device.type != "cuda":
        raise ValueError(f"exp_attention_bnhd: unsupported device {q.device}")
    return exp_attention_bnhd_cuda(q, k, v, scale)


# --------------------------------------------------------------------- P3
def kernel_apply_bf16_ref(basis: torch.Tensor, coef: torch.Tensor,
                          logc: torch.Tensor, vals: torch.Tensor,
                          block_rows: int = 25088) -> torch.Tensor:
    """Plain twin of P3, tiled over ``block_rows`` pixel rows.  basis
    (B, N, 11), coef (B, 11, Ns), logc (B, Ns), vals (B, Ns, V) -> (B, N, V)
    float32.  The clamped fp32 score is rounded to bf16, k is the exp of
    that bf16 value rounded to bf16, the values are rounded to bf16, the
    product accumulates in fp32.  (``crf_cuda.kernel_apply_ref`` is the
    form with the exp of the fp32 score: the wrong twin the card checks hold
    P3 apart from.)"""
    vb = _bf16(vals)
    lc = logc[:, None, :]
    out = []
    for lo in range(0, basis.shape[1], block_rows):
        s = torch.minimum(torch.matmul(basis[:, lo:lo + block_rows], coef), lc)
        out.append(torch.matmul(_bf16(torch.exp(_bf16(s))), vb))
    return torch.cat(out, dim=1)


@functools.lru_cache(maxsize=None)
def _apply_entry():
    from dupl_tpu_torch.kernels import build

    fn = build.load("crf_apply_bf16").dupl_crf_apply_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def kernel_apply_bf16_cuda(basis: torch.Tensor, coef: torch.Tensor,
                           logc: torch.Tensor,
                           vals: torch.Tensor) -> torch.Tensor:
    """Launch kernel P3 on the current stream; one launch covers the batch
    and every value column (any V).  All operands fp32 and contiguous on one
    CUDA device."""
    from dupl_tpu_torch.kernels import build

    dev = basis.device
    for x, name in ((basis, "basis"), (coef, "coef"), (logc, "logc"),
                    (vals, "vals")):
        if x.device != dev or not x.is_cuda:
            raise ValueError(f"kernel_apply_bf16: {name} must be on {dev} "
                             f"(a CUDA device), got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"kernel_apply_bf16: {name} must be float32, "
                            f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"kernel_apply_bf16: {name} must be contiguous")
    b, n, d = basis.shape
    ns, nv = vals.shape[1], vals.shape[2]
    if (d != _DIM or coef.shape != (b, _DIM, ns) or logc.shape != (b, ns)
            or vals.shape[0] != b):
        raise ValueError(f"kernel_apply_bf16: want basis (B, N, {_DIM}), coef "
                         f"(B, {_DIM}, Ns), logc (B, Ns), vals (B, Ns, V); got "
                         f"{tuple(basis.shape)} {tuple(coef.shape)} "
                         f"{tuple(logc.shape)} {tuple(vals.shape)}")
    if nv < 1:
        raise ValueError(f"kernel_apply_bf16: V must be at least 1, got {nv}")
    vb = _values_bf16(vals)
    out = torch.empty((b, n, nv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = _apply_entry()(basis.data_ptr(), coef.data_ptr(),
                                logc.data_ptr(), vb.data_ptr(),
                                out.data_ptr(), b, n, ns, nv, stream)
    build.check(status, "crf_apply_bf16")
    kernel_apply_bf16_cuda.launches += 1
    return out


kernel_apply_bf16_cuda.launches = 0


def kernel_apply_bf16(basis: torch.Tensor, coef: torch.Tensor,
                      logc: torch.Tensor, vals: torch.Tensor,
                      block_rows: int = 25088) -> torch.Tensor:
    """P3 for a batch of images -> (B, N, V) float32.  ``block_rows`` tiles
    the CPU twin only."""
    if basis.device.type == "cpu":
        return kernel_apply_bf16_ref(basis, coef, logc, vals, block_rows)
    if basis.device.type != "cuda":
        raise ValueError(f"kernel_apply_bf16: unsupported device "
                         f"{basis.device}")
    return kernel_apply_bf16_cuda(basis, coef, logc, vals.float().contiguous())


# --------------------------------------------------------------------- P4
def _rate_fn(name: str, x: torch.Tensor):
    """f of the probe on tensors like ``x``; a Python scalar meets the array
    in the array's type, so the constants are rounded to it first."""
    c_mul = torch.tensor(1.0001, dtype=x.dtype, device=x.device)
    c_min = torch.tensor(60.0, dtype=x.dtype, device=x.device)
    return {
        "mul": lambda v: v * c_mul,
        "exp": torch.exp,
        "exp2": torch.exp2,
        "exp_min": lambda v: torch.exp(torch.minimum(v, c_min)),
        "tanh": torch.tanh,
        "expf": torch.exp,
    }[name]


def exp_rate_ref(x: torch.Tensor, name: str, iters: int) -> torch.Tensor:
    """Plain twin of P4: ``iters`` passes of ``acc + f(x + acc * 1e-9)``
    from acc = 0, every operation in ``x.dtype`` (in bf16 the product, both
    sums and f each round to bf16; a scalar constant is rounded to the type
    first).  ``exp2`` is the base-2 exponential itself, what the card's
    instruction computes (jax lowers it to ``exp(x * ln 2)``, rounding the
    product to the array's type)."""
    if name not in RATE_FNS:
        raise ValueError(f"exp_rate: f must be one of {RATE_FNS}, got {name!r}")
    fn = _rate_fn(name, x)
    eps = torch.tensor(1e-9, dtype=x.dtype, device=x.device)
    acc = torch.zeros_like(x)
    for _ in range(iters):
        acc = acc + fn(x + acc * eps)
    return acc


@functools.lru_cache(maxsize=None)
def _rate_entry():
    from dupl_tpu_torch.kernels import build

    fn = build.load("exp_rate").dupl_exp_rate
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return fn


def exp_rate_cuda(x: torch.Tensor, name: str, iters: int) -> torch.Tensor:
    """Launch kernel P4 on the current stream: x fp32 or bf16, contiguous,
    on a CUDA device -> the accumulated tile, same shape and type."""
    from dupl_tpu_torch.kernels import build

    if name not in RATE_FNS:
        raise ValueError(f"exp_rate: f must be one of {RATE_FNS}, got {name!r}")
    if not x.is_cuda or not x.is_contiguous():
        raise ValueError("exp_rate kernel: x must be a contiguous CUDA tensor")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"exp_rate kernel: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if name == "expf" and x.dtype != torch.float32:
        raise TypeError("exp_rate kernel: 'expf' exists in float32 only")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _rate_entry()(x.data_ptr(), out.data_ptr(), x.numel(),
                               int(iters), RATE_FNS.index(name),
                               int(x.dtype == torch.bfloat16), stream)
    build.check(status, "exp_rate")
    exp_rate_cuda.launches += 1
    return out


exp_rate_cuda.launches = 0


def exp_rate(x: torch.Tensor, name: str, iters: int) -> torch.Tensor:
    """P4: the accumulated tile after ``iters`` passes of f ``name``."""
    if x.device.type == "cpu":
        return exp_rate_ref(x, name, iters)
    if x.device.type != "cuda":
        raise ValueError(f"exp_rate: unsupported device {x.device}")
    return exp_rate_cuda(x, name, iters)
