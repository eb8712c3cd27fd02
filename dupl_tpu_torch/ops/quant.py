"""Dynamic int8 quantization for the inference path (counterpart of
``dupl_tpu/ops/quant.py``): w8a8 products with per-row activation scales
and per-output-channel weight scales, both quantized on the fly at every
call (no offline packing, as in the JAX package).

The port's weight is ``nn.Linear``'s (N, K), so the JAX package's
per-column scale of its (K, N) kernel is a per-row scale here, and one
function quantizes activations and weights:

* :func:`quantize_pair` (``dupl::quantize_pair``, kernel Q1,
  ``csrc/quantize_rows.cu``): x (M, K) and w (N, K), each bf16 or fp32 ->
  (qx int8 (M, K), sx fp32 (M, 1), qw int8 (N, K), sw fp32 (N, 1)), each
  operand quantized by :func:`quantize_rows_ref`'s recipe: ``s =
  max(amax_k |x| * f32(1/127), 1e-8)`` and ``q = clamp(round_half_even(x /
  s), -127, 127)``.  Jitted, XLA rewrites the JAX package's ``max|x| /
  127.0`` as a product with the f32 constant 1/127 and keeps ``x / s`` a
  true division; this is that recipe, bit for bit.  Both operands of a
  product in one launch.
* :func:`gelu_quantize_pair` (``dupl::gelu_quantize_pair``, Q1's second
  entry): the same on ``gelu(h)`` for fc1's fp32 output ``h``, the GELU
  (``ops/gelu.py``: the tanh one or the exact one, bit for bit as jitted
  JAX) taken inside the kernel, so that fc2's input is never written in
  fp32.  Q1 takes rows of at most :data:`MAX_ROW_BYTES` (K <= 6144 in fp32,
  12,288 in bf16); both functions refuse wider ones on every device.
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
  ``dupl_tpu/models/vit.py:QDense`` adds it), optionally on the GELU of
  its input (fc2 of ``Mlp``: ``QDense(nn.gelu(h))``).

CPU tensors run the plain twins; CUDA tensors launch Q1 and Q2 or raise.
The flop formula of ``dupl::int8_linear`` is 2 M N K; Q1's entries' 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from dupl_tpu_torch.ops import library
from dupl_tpu_torch.ops.attention import _raw_stream, _require_cuda
from dupl_tpu_torch.ops.gelu import fma_f32, gelu_erf_ref, gelu_tanh

_INV_127 = float.fromhex("0x1.020408p-7")   # f32(1/127)
_MIN_SCALE = float.fromhex("0x1.5798eep-27")  # f32(1e-8)
_DTYPES = (torch.bfloat16, torch.float32)
# csrc/quantize_rows.cu: 256 threads of six 16-byte chunks hold a row
MAX_ROW_BYTES = 24_576


def quantize_rows_ref(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of Q1: x (R, K) -> (q int8 (R, K), s fp32 (R, 1))."""
    xf = x.float()
    amax = xf.abs().amax(dim=1, keepdim=True)
    s = torch.clamp(amax * torch.tensor(_INV_127, device=x.device),
                    min=_MIN_SCALE)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def quantize_pair_ref(x: torch.Tensor, w: torch.Tensor):
    """Plain twin of Q1: :func:`quantize_rows_ref` of x and of w."""
    return (*quantize_rows_ref(x), *quantize_rows_ref(w))


def gelu_quantize_pair_ref(h: torch.Tensor, w: torch.Tensor,
                           approximate: bool):
    """Plain twin of Q1's GELU entry: :func:`quantize_rows_ref` of the
    GELU of h (fp32; the tanh one with ``approximate``) and of w."""
    g = gelu_tanh(h) if approximate else gelu_erf_ref(h)
    return (*quantize_rows_ref(g), *quantize_rows_ref(w))


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

    q1 = build.load("quantize_rows").dupl_quantize_pair
    q1.restype = ctypes.c_int
    q1.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    q2 = build.load("int8_gemm").dupl_int8_gemm
    q2.restype = ctypes.c_int
    q2.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return q1, q2


def _check_pair(x: torch.Tensor, w: torch.Tensor, what: str,
                gelu: bool = False) -> None:
    """x (M, K), w (N, K), K a positive multiple of 8 whose rows Q1 holds
    (:data:`MAX_ROW_BYTES`), x fp32 under the GELU: Q1's shapes, refused
    alike on every device."""
    if gelu and x.dtype != torch.float32:
        raise TypeError(f"{what}: h must be float32, got {x.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{what}: want x (M, K) and w (N, K), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    k = x.shape[1]
    if k % 8 or k < 8:
        raise ValueError(f"{what}: K must be a positive multiple of 8, got {k}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype in _DTYPES and k * t.element_size() > MAX_ROW_BYTES:
            raise ValueError(f"{what}: a row of {name} holds {k} "
                             f"{t.dtype} values, past Q1's cap of "
                             f"{MAX_ROW_BYTES} bytes")


def _pair_kernel(x: torch.Tensor, w: torch.Tensor, gelu: int, counter):
    """Q1 on CUDA tensors on the current stream: x (M, K) and w (N, K),
    bf16 or fp32 each; ``gelu`` 1 (tanh) or 2 (erf) takes the GELU of x,
    which must then be fp32.  A launch counts in ``counter.launches``."""
    from dupl_tpu_torch.kernels import build

    what = counter.__name__.removesuffix("_cuda")
    _check_pair(x, w, what, bool(gelu))
    _check(x, "x", _DTYPES, what, 2)
    _check(w, "w", _DTYPES, what, 2)
    if x.device != w.device:
        raise ValueError(f"{what}: x on {x.device}, w on {w.device}")
    (m, k), n = x.shape, w.shape[0]
    out = (torch.empty((m, k), dtype=torch.int8, device=x.device),
           torch.empty((m, 1), dtype=torch.float32, device=x.device),
           torch.empty((n, k), dtype=torch.int8, device=x.device),
           torch.empty((n, 1), dtype=torch.float32, device=x.device))
    if m + n:
        with torch.cuda.device(x.device):
            status = _entries()[0](
                x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in out), m,
                n, k, int(x.dtype == torch.bfloat16),
                int(w.dtype == torch.bfloat16), gelu, _raw_stream(x.device))
        build.check(status, what)
        counter.launches += 1
    return out


def _quantize_pair_kernel(x: torch.Tensor, w: torch.Tensor):
    """``dupl::quantize_pair`` on CUDA tensors."""
    return _pair_kernel(x, w, 0, quantize_pair_cuda)


def _gelu_quantize_pair_kernel(h: torch.Tensor, w: torch.Tensor,
                               approximate: bool):
    """``dupl::gelu_quantize_pair`` on CUDA tensors."""
    return _pair_kernel(h, w, 1 if approximate else 2,
                        gelu_quantize_pair_cuda)


def _quantize_pair_cpu(x: torch.Tensor, w: torch.Tensor):
    """``dupl::quantize_pair`` on CPU tensors: the twin, on Q1's shapes."""
    _check_pair(x, w, "quantize_pair")
    return quantize_pair_ref(x, w)


def _gelu_quantize_pair_cpu(h: torch.Tensor, w: torch.Tensor,
                            approximate: bool):
    """``dupl::gelu_quantize_pair`` on CPU tensors: the twin, on Q1's
    shapes."""
    _check_pair(h, w, "gelu_quantize_pair", True)
    return gelu_quantize_pair_ref(h, w, approximate)


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


def _pair_fake(x, w, approximate=None):
    (m, k), n = x.shape, w.shape[0]
    return (x.new_empty((m, k), dtype=torch.int8),
            x.new_empty((m, 1), dtype=torch.float32),
            x.new_empty((n, k), dtype=torch.int8),
            x.new_empty((n, 1), dtype=torch.float32))


def _gemm_fake(qa, sa, qw, sw, bias=None):
    return qa.new_empty((qa.shape[0], qw.shape[0]), dtype=torch.float32)


# Q1's two entries and Q2 as the ops dupl::quantize_pair,
# dupl::gelu_quantize_pair and dupl::int8_linear: the launchers above on
# CUDA tensors, the plain twins on CPU tensors.  Q2's flop formula counts
# its products (2 M N K, as a matmul counts); Q1's elementwise work (and
# its GELU's) counts none.
_PAIR = "-> (Tensor, Tensor, Tensor, Tensor)"
_Q1 = library.register(
    f"quantize_pair(Tensor x, Tensor w) {_PAIR}",
    cuda=_quantize_pair_kernel, cpu=_quantize_pair_cpu, fake=_pair_fake,
    flops=lambda x, w: 0)
_Q1_GELU = library.register(
    f"gelu_quantize_pair(Tensor h, Tensor w, bool approximate) {_PAIR}",
    cuda=_gelu_quantize_pair_kernel, cpu=_gelu_quantize_pair_cpu,
    fake=_pair_fake, flops=lambda h, w, approximate: 0)
_Q2 = library.register(
    "int8_linear(Tensor qa, Tensor sa, Tensor qw, Tensor sw, Tensor? bias) "
    "-> Tensor",
    cuda=_gemm_kernel, cpu=int8_linear_ref, fake=_gemm_fake,
    flops=lambda qa, sa, qw, sw, bias: 2 * qa[0] * qw[0] * qa[1])


def quantize_pair_cuda(x: torch.Tensor, w: torch.Tensor):
    """Kernel Q1 on CUDA tensors, through ``dupl::quantize_pair``; raises
    for any other device.  Counts in ``quantize_pair_cuda.launches``."""
    _require_cuda("quantize_pair", x)
    return _Q1(x, w)


quantize_pair_cuda.launches = 0


def gelu_quantize_pair_cuda(h: torch.Tensor, w: torch.Tensor,
                            approximate: bool):
    """Q1's GELU entry on CUDA tensors, through
    ``dupl::gelu_quantize_pair``; raises for any other device.  Counts in
    ``gelu_quantize_pair_cuda.launches``."""
    _require_cuda("gelu_quantize_pair", h)
    return _Q1_GELU(h, w, approximate)


gelu_quantize_pair_cuda.launches = 0


def int8_linear_cuda(qa, sa, qw, sw, bias=None) -> torch.Tensor:
    """Kernel Q2 on CUDA tensors, through ``dupl::int8_linear``; raises for
    any other device.  Counts in ``int8_linear_cuda.launches``."""
    _require_cuda("int8_linear", qa)
    return _Q2(qa, sa, qw, sw, bias)


int8_linear_cuda.launches = 0


def _device_ok(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def quantize_pair(x: torch.Tensor, w: torch.Tensor):
    """x (M, K), w (N, K), bf16 or fp32 each -> (qx int8 (M, K), sx fp32
    (M, 1), qw int8 (N, K), sw fp32 (N, 1))."""
    _device_ok(x, "quantize_pair")
    return _Q1(x.contiguous(), w.contiguous())


def gelu_quantize_pair(h: torch.Tensor, w: torch.Tensor, approximate: bool):
    """:func:`quantize_pair` of (gelu(h), w) for fp32 h (M, K): the tanh
    GELU with ``approximate``, else the exact one, as jitted JAX rounds
    them."""
    _device_ok(h, "gelu_quantize_pair")
    return _Q1_GELU(h.contiguous(), w.contiguous(), bool(approximate))


def int8_linear(qa, sa, qw, sw, bias=None) -> torch.Tensor:
    """(f32(qa qw^T) * sa) * sw^T (+ bias): (M, N) fp32."""
    _device_ok(qa, "int8_linear")
    return _Q2(qa, sa, qw, sw, bias)


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     gelu: Optional[str] = None) -> torch.Tensor:
    """x (..., K) float, w (N, K) float (``nn.Linear``'s layout), bias (N,)
    or None -> (..., N) float32: both operands quantized to int8 at every
    call (per-row scales, one Q1 launch), the int32 product rescaled in
    fp32 and the bias added in fp32 (the last product and the add fused, as
    jitted JAX).  ``gelu`` ("tanh" or "erf"): the product of the GELU of x,
    which must be fp32 (fc1's output), taken inside x's quantization."""
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != k:
        raise ValueError(f"quantized_matmul: want w (N, {k}), got "
                         f"{tuple(w.shape)}")
    if gelu not in (None, "tanh", "erf"):
        raise ValueError(f"quantized_matmul: gelu must be None, 'tanh' or "
                         f"'erf', got {gelu!r}")
    wq = w if w.dtype in _DTYPES else w.float()
    if gelu is None:
        x2 = (x if x.dtype in _DTYPES else x.float()).reshape(-1, k)
        qa, sa, qw, sw = quantize_pair(x2, wq)
    else:
        qa, sa, qw, sw = gelu_quantize_pair(x.reshape(-1, k), wq,
                                            gelu == "tanh")
    b = None if bias is None else bias.float().contiguous()
    y = int8_linear(qa, sa, qw, sw, b)
    return y.reshape(*x.shape[:-1], w.shape[0])
