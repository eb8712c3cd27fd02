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
  fp32.  These two hold a row of at most :data:`MAX_ROW_BYTES` (K <= 6144
  in fp32, 12,288 in bf16) in one launch; both functions take wider rows
  through the two entries below.
* :func:`row_absmax_pair` (``dupl::row_absmax_pair``) and
  :func:`quantize_pair_given` (``dupl::quantize_pair_given``): Q1 in two
  passes, the rows' maxima (of |x| or of |gelu(x)|, and of |w|), then the
  quantization by maxima that are given.  The maximum is exact in any
  order, so the two passes give the one-launch entries' bits at any K; a
  row-parallel product under tensor parallelism all-reduces the maxima of
  its shares of K between them (``parallel/tensor_parallel.py``).
* :func:`int8_linear` (``dupl::int8_linear``, kernel Q2,
  ``csrc/int8_gemm.cu``): ``(f32(sum_k qa[m, k] qw[n, k]) * sa[m]) * sw[n]``
  -> (M, N) fp32, the JAX package's ``y * s_a * s_w`` in that order; with
  a bias, the last product and the bias add are one fused multiply-add
  (``fma(y s_a, s_w, bias)``), as XLA's CPU code contracts them when
  ``QDense`` adds its bias under ``jit`` (separate roundings differ on ~3%
  of the outputs).  The int32 sum is exact, so the twin takes it as a
  float64 product (each partial sum an integer below 2^53; ``int8 @ int8``
  would return int8 and wrap) and any order of k gives the same bits.
* :func:`int8_matmul_i32` (``dupl::int8_matmul_i32``, Q2's main loop with
  an int32 store) and :func:`int8_rescale` (``dupl::int8_rescale``, Q2's
  epilogue as a kernel of its own): :func:`int8_linear` split at its exact
  int32 sum, which a row-parallel product sums over its model group before
  the rescale and the bias.
* :func:`quantized_matmul`: ``QDense``'s product (``dupl_tpu/ops/quant.py:
  quantized_matmul``, bias added after the rescale as
  ``dupl_tpu/models/vit.py:QDense`` adds it), optionally on the GELU of
  its input (fc2 of ``Mlp``: ``QDense(nn.gelu(h))``).

CPU tensors run the plain twins; CUDA tensors launch Q1 and Q2 or raise.
The flop formulas of ``dupl::int8_linear`` and ``dupl::int8_matmul_i32``
are 2 M N K; Q1's entries' and the rescale's 0.
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
# csrc/quantize_rows.cu: 256 threads of six 16-byte chunks hold a row in the
# one-launch entries; wider rows take the two-pass ones
MAX_ROW_BYTES = 24_576
_GELUS = (None, "tanh", "erf")    # the C entries' gelu codes 0, 1, 2


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


def _gelu_of(x: torch.Tensor, gelu: Optional[str]) -> torch.Tensor:
    """x, or the GELU named by ``gelu`` of fp32 x, as the kernels take it."""
    if gelu is None:
        return x
    return gelu_tanh(x) if gelu == "tanh" else gelu_erf_ref(x)


def gelu_quantize_pair_ref(h: torch.Tensor, w: torch.Tensor,
                           approximate: bool):
    """Plain twin of Q1's GELU entry: :func:`quantize_rows_ref` of the
    GELU of h (fp32; the tanh one with ``approximate``) and of w."""
    g = _gelu_of(h, "tanh" if approximate else "erf")
    return (*quantize_rows_ref(g), *quantize_rows_ref(w))


def _gelu_code(gelu: Optional[str], what: str) -> int:
    """The C entries' code of a GELU name (0 none, 1 tanh, 2 erf)."""
    if gelu not in _GELUS:
        raise ValueError(f"{what}: gelu must be None, 'tanh' or 'erf', got "
                         f"{gelu!r}")
    return _GELUS.index(gelu)


def row_absmax_pair_ref(x: torch.Tensor, w: torch.Tensor,
                        gelu: Optional[str] = None):
    """Plain twin of Q1's first pass: (fp32 (M,) maxima of |x| a row, or of
    |gelu(x)|, fp32 (N,) maxima of |w| a row)."""
    return (_gelu_of(x, gelu).float().abs().amax(dim=1),
            w.float().abs().amax(dim=1))


def _quantize_rows_given_ref(x: torch.Tensor, amax: torch.Tensor):
    """:func:`quantize_rows_ref`'s recipe by the given maxima (R,)."""
    s = torch.clamp(amax.reshape(-1, 1)
                    * torch.tensor(_INV_127, device=x.device), min=_MIN_SCALE)
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return q, s


def quantize_pair_given_ref(x: torch.Tensor, w: torch.Tensor,
                            amax_x: torch.Tensor, amax_w: torch.Tensor,
                            gelu: Optional[str] = None):
    """Plain twin of Q1's second pass: :func:`quantize_pair_ref`'s outputs
    (of gelu(x) with ``gelu``), each row by its given maximum."""
    return (*_quantize_rows_given_ref(_gelu_of(x, gelu), amax_x),
            *_quantize_rows_given_ref(w, amax_w))


def int8_matmul_i32_ref(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Plain twin of Q2's int32 entry: qa (M, K), qw (N, K) int8 -> the
    exact sums (M, N) int32 (a float64 product: each partial sum an integer
    below 2^53)."""
    return (qa.double() @ qw.double().t()).to(torch.int32)


def int8_rescale_ref(acc: torch.Tensor, sa: torch.Tensor, sw: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of the rescale: acc (M, N) int32, sa (M, 1), sw (N, 1),
    bias (N,) or None -> (M, N) fp32 in :func:`int8_linear_ref`'s order."""
    y = acc.float() * sa
    if bias is None:
        return y * sw.reshape(1, -1)
    return fma_f32(y, sw.reshape(1, -1), bias)


def int8_linear_ref(qa: torch.Tensor, sa: torch.Tensor, qw: torch.Tensor,
                    sw: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain twin of Q2: qa (M, K), qw (N, K) int8, sa (M, 1), sw (N, 1),
    bias (N,) fp32 or None -> (M, N) fp32: the rescale of the exact int32
    sums."""
    return int8_rescale_ref(int8_matmul_i32_ref(qa, qw), sa, sw, bias)


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

    def entry(lib, name, pointers, ints):
        fn = getattr(build.load(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                       + [ctypes.c_void_p])
        return fn

    return {"pair": entry("quantize_rows", "dupl_quantize_pair", 6, 6),
            "absmax": entry("quantize_rows", "dupl_row_absmax_pair", 4, 6),
            "given": entry("quantize_rows", "dupl_quantize_pair_given", 8, 6),
            "gemm": entry("int8_gemm", "dupl_int8_gemm", 6, 3),
            "i32": entry("int8_gemm", "dupl_int8_gemm_i32", 3, 3),
            "rescale": entry("int8_gemm", "dupl_int8_rescale", 5, 2)}


def _one_launch(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether Q1's one-launch entries hold a row of x and of w
    (:data:`MAX_ROW_BYTES`)."""
    return max(x.element_size(), w.element_size()) * x.shape[-1] \
        <= MAX_ROW_BYTES


def _check_pair(x: torch.Tensor, w: torch.Tensor, what: str,
                gelu: bool = False, one_launch: bool = True) -> None:
    """x (M, K), w (N, K), K a positive multiple of 8, x fp32 under the
    GELU; with ``one_launch`` rows that the one-launch entries hold: Q1's
    shapes, refused alike on every device."""
    if gelu and x.dtype != torch.float32:
        raise TypeError(f"{what}: h must be float32, got {x.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"{what}: want x (M, K) and w (N, K), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    k = x.shape[1]
    if k % 8 or k < 8:
        raise ValueError(f"{what}: K must be a positive multiple of 8, got {k}")
    if one_launch and x.dtype in _DTYPES and w.dtype in _DTYPES \
            and not _one_launch(x, w):
        raise ValueError(f"{what}: rows of {k} values are past the "
                         f"{MAX_ROW_BYTES} bytes of the one-launch entry; "
                         f"row_absmax_pair and quantize_pair_given take them")


def _check_maxima(amax: torch.Tensor, rows: int, name: str, what: str,
                  cuda: bool) -> None:
    if amax.dtype != torch.float32 or amax.shape != (rows,):
        raise ValueError(f"{what}: want {name} ({rows},) float32, got "
                         f"{tuple(amax.shape)} {amax.dtype}")
    if cuda and (not amax.is_cuda or not amax.is_contiguous()):
        raise ValueError(f"{what}: {name} must be a contiguous CUDA tensor")


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
            status = _entries()["pair"](
                x.data_ptr(), w.data_ptr(), *(t.data_ptr() for t in out), m,
                n, k, int(x.dtype == torch.bfloat16),
                int(w.dtype == torch.bfloat16), gelu, _raw_stream(x.device))
        build.check(status, what)
        counter.launches += 1
    return out


def _two_pass_operands(x, w, gelu, what):
    """Q1's two-pass shapes on CUDA tensors; the C entries' dtype flags
    and GELU code."""
    code = _gelu_code(gelu, what)
    _check_pair(x, w, what, gelu is not None, one_launch=False)
    _check(x, "x", _DTYPES, what, 2)
    _check(w, "w", _DTYPES, what, 2)
    if x.device != w.device:
        raise ValueError(f"{what}: x on {x.device}, w on {w.device}")
    return (int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            code)


def _row_absmax_pair_kernel(x: torch.Tensor, w: torch.Tensor,
                            gelu: Optional[str] = None):
    """``dupl::row_absmax_pair`` on CUDA tensors: Q1's first pass."""
    from dupl_tpu_torch.kernels import build

    flags = _two_pass_operands(x, w, gelu, "row_absmax_pair")
    (m, k), n = x.shape, w.shape[0]
    out = (torch.empty(m, dtype=torch.float32, device=x.device),
           torch.empty(n, dtype=torch.float32, device=x.device))
    if m + n:
        with torch.cuda.device(x.device):
            status = _entries()["absmax"](
                x.data_ptr(), w.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), m, n, k, *flags, _raw_stream(x.device))
        build.check(status, "row_absmax_pair")
        row_absmax_pair_cuda.launches += 1
    return out


def _quantize_pair_given_kernel(x: torch.Tensor, w: torch.Tensor,
                                amax_x: torch.Tensor, amax_w: torch.Tensor,
                                gelu: Optional[str] = None):
    """``dupl::quantize_pair_given`` on CUDA tensors: Q1's second pass."""
    from dupl_tpu_torch.kernels import build

    what = "quantize_pair_given"
    flags = _two_pass_operands(x, w, gelu, what)
    (m, k), n = x.shape, w.shape[0]
    _check_maxima(amax_x, m, "amax_x", what, True)
    _check_maxima(amax_w, n, "amax_w", what, True)
    out = _pair_fake(x, w)
    if m + n:
        with torch.cuda.device(x.device):
            status = _entries()["given"](
                x.data_ptr(), w.data_ptr(), amax_x.data_ptr(),
                amax_w.data_ptr(), *(t.data_ptr() for t in out), m, n, k,
                *flags, _raw_stream(x.device))
        build.check(status, what)
        quantize_pair_given_cuda.launches += 1
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


def _check_gemm(qa, qw, what: str):
    """Q2's operands on CUDA tensors: qa (M, K), qw (N, K) int8, K a
    multiple of 32, N of 8."""
    _check(qa, "qa", (torch.int8,), what, 2)
    _check(qw, "qw", (torch.int8,), what, 2)
    (m, k), (n, kw) = qa.shape, qw.shape
    if kw != k or k % 32 or k < 32 or n % 8 or n < 8:
        raise ValueError(f"{what}: want qa (M, K), qw (N, K) with K a "
                         f"multiple of 32 and N of 8, got {tuple(qa.shape)}, "
                         f"{tuple(qw.shape)}")
    return m, n, k


def _check_scales(sa, sw, bias, m: int, n: int, what: str) -> None:
    """The rescale's operands on CUDA tensors: sa (M, 1), sw (N, 1), bias
    (N,) or None, fp32."""
    _check(sa, "sa", (torch.float32,), what, 2)
    _check(sw, "sw", (torch.float32,), what, 2)
    if sa.shape != (m, 1) or sw.shape != (n, 1):
        raise ValueError(f"{what}: want sa ({m}, 1), sw ({n}, 1), got "
                         f"{tuple(sa.shape)}, {tuple(sw.shape)}")
    if bias is not None:
        _check(bias, "bias", (torch.float32,), what, 1)
        if bias.shape != (n,):
            raise ValueError(f"{what}: want bias ({n},), got "
                             f"{tuple(bias.shape)}")


def _one_device(what: str, *tensors) -> None:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{what}: operands on {sorted(map(str, devices))}")


def _gemm_kernel(qa, sa, qw, sw, bias=None):
    """``dupl::int8_linear`` on CUDA tensors: Q2 on the current stream; K a
    multiple of 32, N of 8."""
    from dupl_tpu_torch.kernels import build

    what = "int8_linear"
    m, n, k = _check_gemm(qa, qw, what)
    _check_scales(sa, sw, bias, m, n, what)
    _one_device(what, qa, sa, qw, sw, bias)
    out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
    if m:
        with torch.cuda.device(qa.device):
            status = _entries()["gemm"](
                qa.data_ptr(), sa.data_ptr(), qw.data_ptr(), sw.data_ptr(),
                0 if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
                k, _raw_stream(qa.device))
        build.check(status, what)
        int8_linear_cuda.launches += 1
    return out


def _i32_kernel(qa, qw):
    """``dupl::int8_matmul_i32`` on CUDA tensors: Q2's main loop, the int32
    sums stored."""
    from dupl_tpu_torch.kernels import build

    what = "int8_matmul_i32"
    m, n, k = _check_gemm(qa, qw, what)
    _one_device(what, qa, qw)
    out = torch.empty((m, n), dtype=torch.int32, device=qa.device)
    if m:
        with torch.cuda.device(qa.device):
            status = _entries()["i32"](qa.data_ptr(), qw.data_ptr(),
                                       out.data_ptr(), m, n, k,
                                       _raw_stream(qa.device))
        build.check(status, what)
        int8_matmul_i32_cuda.launches += 1
    return out


def _rescale_kernel(acc, sa, sw, bias=None):
    """``dupl::int8_rescale`` on CUDA tensors: Q2's epilogue on int32
    sums."""
    from dupl_tpu_torch.kernels import build

    what = "int8_rescale"
    _check(acc, "acc", (torch.int32,), what, 2)
    m, n = acc.shape
    _check_scales(sa, sw, bias, m, n, what)
    _one_device(what, acc, sa, sw, bias)
    out = torch.empty((m, n), dtype=torch.float32, device=acc.device)
    if m and n:
        with torch.cuda.device(acc.device):
            status = _entries()["rescale"](
                acc.data_ptr(), sa.data_ptr(), sw.data_ptr(),
                0 if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
                _raw_stream(acc.device))
        build.check(status, what)
        int8_rescale_cuda.launches += 1
    return out


def _row_absmax_pair_cpu(x, w, gelu=None):
    """``dupl::row_absmax_pair`` on CPU tensors: the twin, on Q1's
    shapes."""
    _gelu_code(gelu, "row_absmax_pair")
    _check_pair(x, w, "row_absmax_pair", gelu is not None, one_launch=False)
    return row_absmax_pair_ref(x, w, gelu)


def _quantize_pair_given_cpu(x, w, amax_x, amax_w, gelu=None):
    """``dupl::quantize_pair_given`` on CPU tensors: the twin, on Q1's
    shapes."""
    what = "quantize_pair_given"
    _gelu_code(gelu, what)
    _check_pair(x, w, what, gelu is not None, one_launch=False)
    _check_maxima(amax_x, x.shape[0], "amax_x", what, False)
    _check_maxima(amax_w, w.shape[0], "amax_w", what, False)
    return quantize_pair_given_ref(x, w, amax_x, amax_w, gelu)


def _pair_fake(x, w, approximate=None):
    (m, k), n = x.shape, w.shape[0]
    return (x.new_empty((m, k), dtype=torch.int8),
            x.new_empty((m, 1), dtype=torch.float32),
            x.new_empty((n, k), dtype=torch.int8),
            x.new_empty((n, 1), dtype=torch.float32))


def _gemm_fake(qa, sa, qw, sw, bias=None):
    return qa.new_empty((qa.shape[0], qw.shape[0]), dtype=torch.float32)


def _absmax_fake(x, w, gelu=None):
    return (x.new_empty(x.shape[0], dtype=torch.float32),
            x.new_empty(w.shape[0], dtype=torch.float32))


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
# Q1's two passes, Q2's int32 product and its rescale, the same way
_Q1_AMAX = library.register(
    "row_absmax_pair(Tensor x, Tensor w, str? gelu=None) -> (Tensor, Tensor)",
    cuda=_row_absmax_pair_kernel, cpu=_row_absmax_pair_cpu,
    fake=_absmax_fake, flops=lambda x, w, gelu=None: 0)
_Q1_GIVEN = library.register(
    f"quantize_pair_given(Tensor x, Tensor w, Tensor amax_x, Tensor amax_w, "
    f"str? gelu=None) {_PAIR}",
    cuda=_quantize_pair_given_kernel, cpu=_quantize_pair_given_cpu,
    fake=lambda x, w, amax_x, amax_w, gelu=None: _pair_fake(x, w),
    flops=lambda x, w, amax_x, amax_w, gelu=None: 0)
_Q2_I32 = library.register(
    "int8_matmul_i32(Tensor qa, Tensor qw) -> Tensor",
    cuda=_i32_kernel, cpu=int8_matmul_i32_ref,
    fake=lambda qa, qw: qa.new_empty((qa.shape[0], qw.shape[0]),
                                     dtype=torch.int32),
    flops=lambda qa, qw: 2 * qa[0] * qw[0] * qa[1])
_RESCALE = library.register(
    "int8_rescale(Tensor acc, Tensor sa, Tensor sw, Tensor? bias) -> Tensor",
    cuda=_rescale_kernel, cpu=int8_rescale_ref,
    fake=lambda acc, sa, sw, bias=None: acc.new_empty(
        acc.shape, dtype=torch.float32),
    flops=lambda acc, sa, sw, bias: 0)


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


def row_absmax_pair_cuda(x: torch.Tensor, w: torch.Tensor,
                         gelu: Optional[str] = None):
    """Q1's first pass on CUDA tensors, through ``dupl::row_absmax_pair``;
    raises for any other device.  Counts in
    ``row_absmax_pair_cuda.launches``."""
    _require_cuda("row_absmax_pair", x)
    return _Q1_AMAX(x, w, gelu)


row_absmax_pair_cuda.launches = 0


def quantize_pair_given_cuda(x, w, amax_x, amax_w,
                             gelu: Optional[str] = None):
    """Q1's second pass on CUDA tensors, through
    ``dupl::quantize_pair_given``; raises for any other device.  Counts in
    ``quantize_pair_given_cuda.launches``."""
    _require_cuda("quantize_pair_given", x)
    return _Q1_GIVEN(x, w, amax_x, amax_w, gelu)


quantize_pair_given_cuda.launches = 0


def int8_matmul_i32_cuda(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Q2's int32 entry on CUDA tensors, through ``dupl::int8_matmul_i32``;
    raises for any other device.  Counts in
    ``int8_matmul_i32_cuda.launches``."""
    _require_cuda("int8_matmul_i32", qa)
    return _Q2_I32(qa, qw)


int8_matmul_i32_cuda.launches = 0


def int8_rescale_cuda(acc, sa, sw, bias=None) -> torch.Tensor:
    """The rescale on CUDA tensors, through ``dupl::int8_rescale``; raises
    for any other device.  Counts in ``int8_rescale_cuda.launches``."""
    _require_cuda("int8_rescale", acc)
    return _RESCALE(acc, sa, sw, bias)


int8_rescale_cuda.launches = 0


def _device_ok(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


def quantize_pair(x: torch.Tensor, w: torch.Tensor):
    """x (M, K), w (N, K), bf16 or fp32 each -> (qx int8 (M, K), sx fp32
    (M, 1), qw int8 (N, K), sw fp32 (N, 1)): one launch, or the two passes
    for rows past :data:`MAX_ROW_BYTES`."""
    _device_ok(x, "quantize_pair")
    x, w = x.contiguous(), w.contiguous()
    if _one_launch(x, w):
        return _Q1(x, w)
    return quantize_pair_given(x, w, *row_absmax_pair(x, w))


def gelu_quantize_pair(h: torch.Tensor, w: torch.Tensor, approximate: bool):
    """:func:`quantize_pair` of (gelu(h), w) for fp32 h (M, K): the tanh
    GELU with ``approximate``, else the exact one, as jitted JAX rounds
    them."""
    _device_ok(h, "gelu_quantize_pair")
    h, w = h.contiguous(), w.contiguous()
    if _one_launch(h, w):
        return _Q1_GELU(h, w, bool(approximate))
    gelu = "tanh" if approximate else "erf"
    return quantize_pair_given(h, w, *row_absmax_pair(h, w, gelu), gelu)


def row_absmax_pair(x: torch.Tensor, w: torch.Tensor,
                    gelu: Optional[str] = None):
    """x (M, K), w (N, K) -> (fp32 (M,) maxima of |x| a row, or of
    |gelu(x)| for fp32 x and ``gelu`` "tanh" or "erf"; fp32 (N,) maxima of
    |w| a row), at any K."""
    _device_ok(x, "row_absmax_pair")
    return _Q1_AMAX(x.contiguous(), w.contiguous(), gelu)


def quantize_pair_given(x: torch.Tensor, w: torch.Tensor,
                        amax_x: torch.Tensor, amax_w: torch.Tensor,
                        gelu: Optional[str] = None):
    """:func:`quantize_pair`'s outputs (of gelu(x) with ``gelu``), each row
    quantized by its given maximum (fp32 (M,) and (N,)) in place of its
    own, at any K."""
    _device_ok(x, "quantize_pair_given")
    return _Q1_GIVEN(x.contiguous(), w.contiguous(), amax_x.contiguous(),
                     amax_w.contiguous(), gelu)


def int8_matmul_i32(qa: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """qa (M, K), qw (N, K) int8 -> the exact sums qa qw^T, (M, N) int32."""
    _device_ok(qa, "int8_matmul_i32")
    return _Q2_I32(qa, qw)


def int8_rescale(acc: torch.Tensor, sa: torch.Tensor, sw: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(f32(acc) * sa) * sw^T (+ bias, fused with the last product): the
    rescale of :func:`int8_linear` on int32 sums (M, N)."""
    _device_ok(acc, "int8_rescale")
    return _RESCALE(acc, sa, sw, bias)


def int8_linear(qa, sa, qw, sw, bias=None) -> torch.Tensor:
    """(f32(qa qw^T) * sa) * sw^T (+ bias): (M, N) fp32."""
    _device_ok(qa, "int8_linear")
    return _Q2(qa, sa, qw, sw, bias)


def product_operands(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor], gelu: Optional[str]):
    """The operands of a w8a8 product as Q1 and Q2 take them: x (..., K)
    as (M, K) (bf16 or fp32; fp32 under the GELU), w (N, K) bf16 or fp32,
    bias fp32 or None; refuses a ``gelu`` other than None, "tanh", "erf"."""
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[1] != k:
        raise ValueError(f"quantized_matmul: want w (N, {k}), got "
                         f"{tuple(w.shape)}")
    _gelu_code(gelu, "quantized_matmul")
    if gelu is None and x.dtype not in _DTYPES:
        x = x.float()
    return (x.reshape(-1, k), w if w.dtype in _DTYPES else w.float(),
            None if bias is None else bias.float().contiguous())


def quantized_matmul(x: torch.Tensor, w: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     gelu: Optional[str] = None) -> torch.Tensor:
    """x (..., K) float, w (N, K) float (``nn.Linear``'s layout), bias (N,)
    or None -> (..., N) float32: both operands quantized to int8 at every
    call (per-row scales, one Q1 launch, or two past
    :data:`MAX_ROW_BYTES`), the int32 product rescaled in fp32 and the bias
    added in fp32 (the last product and the add fused, as jitted JAX).
    ``gelu`` ("tanh" or "erf"): the product of the GELU of x, which must be
    fp32 (fc1's output), taken inside x's quantization."""
    x2, wq, b = product_operands(x, w, bias, gelu)
    if gelu is None:
        qa, sa, qw, sw = quantize_pair(x2, wq)
    else:
        qa, sa, qw, sw = gelu_quantize_pair(x2, wq, gelu == "tanh")
    y = int8_linear(qa, sa, qw, sw, b)
    return y.reshape(*x.shape[:-1], w.shape[0])
