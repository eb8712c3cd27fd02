"""Dynamic int8 quantization for the inference path (counterpart of
``dupl_tpu/ops/quant.py``): w8a8 products with per-row activation scales
and per-output-channel weight scales, both quantized on the fly at every
call (no offline packing, as in the JAX package).

The port's weight is ``nn.Linear``'s (N, K), so the JAX package's
per-column scale of its (K, N) kernel is a per-row scale here, and one
function quantizes activations and weights:

* :func:`quantize_rows` (``dupl::quantize_rows``, kernel Q1,
  ``csrc/quantize_rows.cu``): x (R, K) bf16 or fp32 -> (q int8 (R, K),
  s fp32 (R, 1)) with ``s = max(amax_k |x| * f32(1/127), 1e-8)`` and ``q =
  clamp(round_half_even(x / s), -127, 127)``.  Jitted, XLA rewrites the JAX
  package's ``max|x| / 127.0`` as a product with the f32 constant 1/127 and
  keeps ``x / s`` a true division; this is that recipe, bit for bit.
* :func:`int8_linear` (``dupl::int8_linear``, kernel Q2,
  ``csrc/int8_gemm.cu``): ``(f32(sum_k qa[m, k] qw[n, k]) * sa[m]) * sw[n]``
  -> (M, N) fp32, the JAX package's ``y * s_a * s_w`` in that order; with
  a bias, the last product and the bias add are one fused multiply-add
  (``fma(y s_a, s_w, bias)``), as XLA's CPU code contracts them when
  ``QDense`` adds its bias under ``jit`` (separate roundings differ on ~3%
  of the outputs).  The int32 sum is exact, so the twin takes it as a
  float64 product (each partial sum an integer below 2^53; ``int8 @ int8``
  would return int8 and wrap) and any order of k gives the same bits.
* :func:`quantized_matmul`: ``QDense``'s product (``dupl_tpu/ops/quant.py:
  quantized_matmul``, bias added after the rescale as
  ``dupl_tpu/models/vit.py:QDense`` adds it).

CPU tensors run the plain twins; CUDA tensors launch Q1 and Q2 or raise.
The flop formula of ``dupl::int8_linear`` is 2 M N K; Q1's is 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from dupl_tpu_torch.ops import library
from dupl_tpu_torch.ops.attention import _raw_stream, _require_cuda
from dupl_tpu_torch.ops.gelu import fma_f32

_INV_127 = float.fromhex("0x1.020408p-7")   # f32(1/127)
_MIN_SCALE = float.fromhex("0x1.5798eep-27")  # f32(1e-8)
_DTYPES = (torch.bfloat16, torch.float32)


def quantize_rows_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of Q1: x (R, K) -> (q int8 (R, K), s fp32 (R, 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    s = torch.clamp(amax * torch.tensor(_INV_127, device=x.device),
                    min=_MIN_SCALE)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def int8_linear_ref(qa: torch.Tensor, sa: torch.Tensor, qw: torch.Tensor,
                    sw: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of Q2: qa (M, K), qw (N, K) int8, sa (M, 1), sw (N, 1),
    bias (N,) fp32 or None -> (M, N) fp32."""
    acc = (qa.double() @ qw.double().t()).float() * sa
    if bias is None:
        return acc * sw.reshape(1, -1)
    return fma_f32(acc, sw.reshape(1, -1), bias)


def _check(x: torch.Tensor, name: str, dtypes, what: str,
           dim: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: {name} must be on a CUDA device, got "
                         f"{x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: {name} must be "
                        f"{' or '.join(map(str, dtypes))}, got {x.dtype}")
    if x.dim() != dim or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: {name} must be a contiguous, 16-byte "
                         f"aligned {dim}-D tensor, got {tuple(x.shape)} "
                         f"strides {x.stride()}")


@functools.lru_cache(maxsize=None)
def _entries():
    """The C entry points of ``csrc/quantize_rows.cu`` and
    ``csrc/int8_gemm.cu``, built on first use."""
    from dupl_tpu_torch.kernels import build

    q1 = build.load("quantize_rows").dupl_quantize_rows
    q1.restype = ctypes.c_int
    q1.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    q2 = build.load("int8_gemm").dupl_int8_gemm
    q2.restype = ctypes.c_int
    q2.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return q1, q2


def _quantize_kernel(x: torch.Tensor):
    """``dupl::quantize_rows`` on CUDA tensors: Q1 on the current stream;
    x (R, K) bf16 or fp32, K a multiple of 8."""
    from dupl_tpu_torch.kernels import build

    _check(x, "x", _DTYPES, "quantize_rows", 2)
    r, k = x.shape
    if k % 8 or k < 8:
        raise ValueError(f"quantize_rows: K must be a positive multiple of 8, "
                         f"got {k}")
    q = torch.empty((r, k), dtype=torch.int8, device=x.device)
    s = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    if r:
        with torch.cuda.device(x.device):
            status = _entries()[0](x.data_ptr(), q.data_ptr(), s.data_ptr(),
                                   r, k, int(x.dtype == torch.bfloat16),
                                   _raw_stream(x.device))
        build.check(status, "quantize_rows")
        quantize_rows_cuda.launches += 1
    return q, s


def _gemm_kernel(qa, sa, qw, sw, bias=None):
    """``dupl::int8_linear`` on CUDA tensors: Q2 on the current stream; K a
    multiple of 32, N of 8."""
    from dupl_tpu_torch.kernels import build

    what = "int8_linear"
    _check(qa, "qa", (torch.int8,), what, 2)
    _check(qw, "qw", (torch.int8,), what, 2)
    _check(sa, "sa", (torch.float32,), what, 2)
    _check(sw, "sw", (torch.float32,), what, 2)
    (m, k), (n, kw) = qa.shape, qw.shape
    if kw != k or k % 32 or k < 32 or n % 8 or n < 8:
        raise ValueError(f"{what}: want qa (M, K), qw (N, K) with K a "
                         f"multiple of 32 and N of 8, got {tuple(qa.shape)}, "
                         f"{tuple(qw.shape)}")
    if sa.shape != (m, 1) or sw.shape != (n, 1):
        raise ValueError(f"{what}: want sa ({m}, 1), sw ({n}, 1), got "
                         f"{tuple(sa.shape)}, {tuple(sw.shape)}")
    if bias is not None:
        _check(bias, "bias", (torch.float32,), what, 1)
        if bias.shape != (n,):
            raise ValueError(f"{what}: want bias ({n},), got "
                             f"{tuple(bias.shape)}")
    devices = {t.device for t in (qa, sa, qw, sw, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on {sorted(map(str, devices))}")
    out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
    if m:
        with torch.cuda.device(qa.device):
            status = _entries()[1](
                qa.data_ptr(), sa.data_ptr(), qw.data_ptr(), sw.data_ptr(),
                0 if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
                k, _raw_stream(qa.device))
        build.check(status, what)
        int8_linear_cuda.launches += 1
    return out


def _quantize_fake(x):
    r, k = x.shape
    return (x.new_empty((r, k), dtype=torch.int8),
            x.new_empty((r, 1), dtype=torch.float32))


def _gemm_fake(qa, sa, qw, sw, bias=None):
    return qa.new_empty((qa.shape[0], qw.shape[0]), dtype=torch.float32)


# Q1 and Q2 as the ops dupl::quantize_rows and dupl::int8_linear: the
# launchers above on CUDA tensors, the plain twins on CPU tensors.  Q2's
# flop formula counts its products (2 M N K, as a matmul counts); Q1's
# elementwise work counts none.
_Q1 = library.register(
    "quantize_rows(Tensor x) -> (Tensor, Tensor)",
    cuda=_quantize_kernel, cpu=quantize_rows_ref, fake=_quantize_fake,
    flops=lambda x: 0)
_Q2 = library.register(
    "int8_linear(Tensor qa, Tensor sa, Tensor qw, Tensor sw, Tensor? bias) "
    "-> Tensor",
    cuda=_gemm_kernel, cpu=int8_linear_ref, fake=_gemm_fake,
    flops=lambda qa, sa, qw, sw, bias: 2 * qa[0] * qw[0] * qa[1])


def quantize_rows_cuda(x: torch.Tensor):
    """Kernel Q1 on a CUDA tensor, through ``dupl::quantize_rows``; raises
    for any other device.  Counts in ``quantize_rows_cuda.launches``."""
    _require_cuda("quantize_rows", x)
    return _Q1(x)


quantize_rows_cuda.launches = 0


def int8_linear_cuda(qa, sa, qw, sw, bias=None) -> torch.Tensor:
    """Kernel Q2 on CUDA tensors, through ``dupl::int8_linear``; raises for
    any other device.  Counts in ``int8_linear_cuda.launches``."""
    _require_cuda("int8_linear", qa)
    return _Q2(qa, sa, qw, sw, bias)


int8_linear_cuda.launches = 0


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, K) bf16 or fp32 -> (q int8 (R, K), s fp32 (R, 1))."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    return _Q1(x.contiguous())


def int8_linear(qa, sa, qw, sw, bias=None) -> torch.Tensor:
    """(f32(qa qw^T) * sa) * sw^T (+ bias): (M, N) fp32."""
    if qa.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_linear: unsupported device {qa.device}")
    return _Q2(qa, sa, qw, sw, bias)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., K) float, w (N, K) float (``nn.Linear``'s layout), bias (N,)
    or None -> (..., N) float32: both operands quantized to int8 at every
    call (per-row scales), the int32 product rescaled in fp32 and the bias
    added in fp32 (the last product and the add fused, as jitted JAX)."""
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != k:
        raise ValueError(f"quantized_matmul: want w (N, {k}), got "
                         f"{tuple(w.shape)}")
    if x.dtype not in _DTYPES:
        x = x.float()
    qa, sa = quantize_rows(x.reshape(-1, k))
    qw, sw = quantize_rows(w if w.dtype in _DTYPES else w.float())
    b = None if bias is None else bias.float().contiguous()
    y = int8_linear(qa, sa, qw, sw, b)
    return y.reshape(*x.shape[:-1], w.shape[0])
