"""Attention dispatch (counterpart of ``dupl_tpu/ops/attention.py``).

``dot_attention`` follows the reference's dispatch by sequence length:

* CPU tensors, and any sequence shorter than 128 tokens: exact softmax
  attention in plain torch (matmul, softmax, matmul) — what
  ``jax.nn.dot_product_attention`` gives the reference there;
* CUDA tensors with 128 <= N < 2048: the max-free exp-attention kernel
  (``csrc/exp_attention.cu``, kernel K1), which every ViT block of the
  serving path runs at every scale (785, 1226 and 1765 tokens at a 448 crop).
  Under autograd its backward is the hand-written kernel K2
  (``csrc/exp_attention_bwd.cu``), paired with K1 in one
  ``torch.autograd.Function``.  The reference's backward kernel holds a whole
  head on chip and therefore stops at 896 padded tokens, beyond which the
  reference differentiates its plain formulation; K2 is tiled, so it takes
  every length K1 takes and the port has no such second path;
* CUDA tensors with N >= 2048: exact softmax attention by the flash kernels
  (``csrc/flash_attention.cu`` forward, kernel L1f, and
  ``csrc/flash_attention_bwd.cu`` backward, kernel L1b, paired in one
  ``torch.autograd.Function``), where the reference calls jax's library
  Pallas flash attention.  The line is drawn on the unpadded length.  The
  native-resolution evaluation reaches it: a 500 x 500 image at scale 1.5 is
  2117 tokens.

The exp form is softmax without the max subtraction: logits are clamped at
60 so exp never overflows fp32, which ViT attention logits never reach.  One
run may therefore send some batches through the max-free kernel and others
through the exact one, as the reference does.

The four kernels are the registered ops ``dupl::exp_attention``,
``dupl::exp_attention_bwd``, ``dupl::flash_attention`` and
``dupl::flash_attention_bwd`` (``ops/library.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dupl_tpu_torch.ops import library

_EXP_MIN_SEQ = 128
_EXP_MAX_SEQ = 2048
_LOGIT_CLAMP = 60.0
_KERNEL_HEAD_DIMS = (16, 32, 64, 80)


def exp_attention_ref(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Plain twin of the exp-attention kernel: q pre-scaled, (BH, N, D) ->
    (BH, N, D) float32.  Operands are rounded to bf16 and contracted in fp32
    (bf16 x bf16 products are exact in fp32, so this is the fp32-accumulated
    bf16 product the kernel computes)."""
    qf = q.to(torch.bfloat16).float()
    kf = k.to(torch.bfloat16).float()
    vf = v.to(torch.bfloat16).float()
    s = torch.matmul(qf, kf.transpose(-1, -2))
    e = torch.exp(torch.clamp(s, max=_LOGIT_CLAMP))
    denom = e.sum(dim=-1, keepdim=True)
    return torch.matmul(e.to(torch.bfloat16).float(), vf) / denom


def exp_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          g: torch.Tensor):
    """Plain twin of the exp-attention backward kernel: q (pre-scaled), k,
    v and the output cotangent g, each (BH, N, D) -> (dq, dk, dv), each
    (BH, N, D) bf16.  Roundings as the kernel: operands rounded to bf16,
    scores, p = e / sum(e), t = g.v^T and delta = rowsum(p * t) in fp32;
    ds = p * (t - delta) rounded to bf16 (zero where the score reached the
    clamp) before both of its products, p rounded to bf16 for dv, fp32
    sums, results rounded to bf16 once."""
    qf, kf, vf, gf = (x.to(torch.bfloat16).float() for x in (q, k, v, g))
    s = torch.matmul(qf, kf.transpose(-1, -2))
    e = torch.exp(torch.clamp(s, max=_LOGIT_CLAMP))
    p = e / e.sum(dim=-1, keepdim=True)
    t = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (p * t).sum(dim=-1, keepdim=True)
    ds = torch.where(s < _LOGIT_CLAMP, p * (t - delta), torch.zeros_like(p))
    ds = ds.to(torch.bfloat16).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), gf)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _check_operand(x: torch.Tensor, name: str,
                   kernel: str = "exp_attention") -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{kernel} kernel: {name} must be bfloat16, "
                        f"got {x.dtype}")
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]):
        raise ValueError(f"{kernel} kernel: {name} needs a contiguous "
                         f"head dim and strides that are multiples of 8, got "
                         f"strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"{kernel} kernel: {name} must be 16-byte aligned")


def _raw_stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` as an int for a C entry point,
    by the raw accessor: a fraction of ``current_stream().cuda_stream``'s
    host time, which counts on the host-bound training step."""
    return torch._C._cuda_getCurrentRawStream(device.index)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of ``csrc/exp_attention.cu``, built on first use."""
    from dupl_tpu_torch.kernels import build

    fn = build.load("exp_attention").dupl_exp_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
    return fn


def _exp_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """``dupl::exp_attention`` on CUDA tensors: launch kernel K1 on the
    current stream.  q (pre-scaled), k, v: (B, N, H, D) bf16 on one CUDA
    device, D in {16, 32, 64, 80} -> (B, N, H, D) bf16.  k and v may be
    strided views (e.g. column slices of the qkv projection)."""
    from dupl_tpu_torch.kernels import build

    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("exp_attention kernel: q, k, v must share one CUDA "
                         "device")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"exp_attention kernel: want equal (B, N, H, D) "
                         f"shapes, got {q.shape} {k.shape} {v.shape}")
    b, n, h, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"exp_attention kernel: head dim must be one of "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(x, name)
    out = torch.empty((b, n, h, d), dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        status = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, n, h, d, *q.stride()[:3],
                          *k.stride()[:3], *v.stride()[:3],
                          _raw_stream(q.device))
    build.check(status, "exp_attention")
    exp_attention_cuda.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    """The C entry point of ``csrc/exp_attention_bwd.cu``, built on first
    use."""
    from dupl_tpu_torch.kernels import build

    fn = build.load("exp_attention_bwd").dupl_exp_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
    return fn


def _exp_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor):
    """``dupl::exp_attention_bwd`` on CUDA tensors: launch kernel K2 on the
    current stream.  q (pre-scaled), k, v and the output cotangent g:
    (B, N, H, D) bf16 on one CUDA device, D in {16, 32, 64, 80}, each
    possibly a strided view -> (dq, dk, dv), each (B, N, H, D) bf16
    contiguous."""
    from dupl_tpu_torch.kernels import build

    if not (q.is_cuda and all(x.device == q.device for x in (k, v, g))):
        raise ValueError("exp_attention_bwd kernel: q, k, v, g must share "
                         "one CUDA device")
    if q.dim() != 4 or any(x.shape != q.shape for x in (k, v, g)):
        raise ValueError(f"exp_attention_bwd kernel: want equal (B, N, H, D) "
                         f"shapes, got {q.shape} {k.shape} {v.shape} "
                         f"{g.shape}")
    b, n, h, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"exp_attention_bwd kernel: head dim must be one of "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    for x, name in ((q, "q"), (k, "k"), (v, "v"), (g, "g")):
        _check_operand(x, name)
    # one allocation for the three results, one for the scratch: the two
    # row statistics, 1 / sum(e) and delta, of every query row, padded to a
    # multiple of 64 rows (0 past N), written by the first kernel and
    # copied tile by tile by the second
    grads = torch.empty((3, b, n, h, d), dtype=torch.bfloat16,
                        device=q.device)
    npad = -(-n // 64) * 64
    stats = torch.empty((2, b * h, npad), dtype=torch.float32,
                        device=q.device)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *g.stride()[:3])
    step, part = b * n * h * d * 2, b * h * npad * 4   # bytes
    with torch.cuda.device(q.device):
        base, sbase = grads.data_ptr(), stats.data_ptr()
        status = _bwd_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              g.data_ptr(), base, base + step,
                              base + 2 * step, sbase, sbase + part, b, n, h,
                              d, strides, _raw_stream(q.device))
    build.check(status, "exp_attention_bwd")
    dq, dk, dv = grads.unbind(0)
    exp_attention_bwd_cuda.launches += 1
    return dq, dk, dv


def _to_bhnd(x: torch.Tensor) -> torch.Tensor:
    b, n, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, n, d)


def _from_bhnd(x: torch.Tensor, b: int) -> torch.Tensor:
    bh, n, d = x.shape
    return x.reshape(b, bh // b, n, d).permute(0, 2, 1, 3)


def _bnhd_like(q: torch.Tensor) -> torch.Tensor:
    """A contiguous (B, N, H, D) bf16 result on ``q``'s device."""
    return q.new_empty(q.shape, dtype=torch.bfloat16)


def _exp_attention_twin(q, k, v):
    out = exp_attention_ref(_to_bhnd(q), _to_bhnd(k), _to_bhnd(v))
    return _from_bhnd(out.to(torch.bfloat16), q.shape[0]).contiguous()


def _exp_attention_bwd_twin(q, k, v, g):
    grads = exp_attention_bwd_ref(_to_bhnd(q), _to_bhnd(k), _to_bhnd(v),
                                  _to_bhnd(g))
    return tuple(_from_bhnd(x, q.shape[0]).contiguous() for x in grads)


def _attention_flops(q_shape, backward: bool = False) -> int:
    """The flop formula of the four attention ops: model FLOPs of exact
    softmax attention on (B, N, H, D) operands, as ``FlopCounterMode``
    counts :func:`softmax_attention` (two products of 2 N^2 D FLOPs a head)
    and its autograd backward (four).  The kernels' own recomputation of
    the scores in the backward is not counted."""
    b, n, h, d = q_shape
    return (8 if backward else 4) * b * h * n * n * d


# K1 and K2 as the ops dupl::exp_attention and dupl::exp_attention_bwd, on
# (B, N, H, D) bf16 operands with q pre-scaled.  CPU tensors take the plain
# twins; CUDA tensors launch the kernels or raise.
_K1 = library.register(
    "exp_attention(Tensor q, Tensor k, Tensor v) -> Tensor",
    cuda=_exp_attention_kernel, cpu=_exp_attention_twin,
    fake=lambda q, k, v: _bnhd_like(q),
    flops=lambda q, k, v: _attention_flops(q))
_K2 = library.register(
    "exp_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor g) "
    "-> (Tensor, Tensor, Tensor)",
    cuda=_exp_attention_bwd_kernel, cpu=_exp_attention_bwd_twin,
    fake=lambda q, k, v, g: tuple(_bnhd_like(q) for _ in range(3)),
    flops=lambda q, k, v, g: _attention_flops(q, backward=True))


def _check_device(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")


class _ExpAttention(torch.autograd.Function):
    """K1 forward, K2 backward (the reference's ``custom_vjp``), both
    through their ops."""

    @staticmethod
    def forward(ctx, qs, k, v):
        _check_device(qs, "exp_attention")
        ctx.save_for_backward(qs, k, v)   # k, v: views of the qkv product
        return _K1(qs, k, v)

    @staticmethod
    def backward(ctx, g):
        qs, k, v = ctx.saved_tensors
        return _K2(qs, k, v, g.to(torch.bfloat16).contiguous())


def _require_cuda(kernel: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"{kernel} kernel: operands must be on a CUDA "
                         f"device, got {x.device}")


def exp_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Kernel K1 on CUDA tensors, through ``dupl::exp_attention``; raises
    for any other device.  ``exp_attention_cuda.launches`` counts K1's
    launches by any route that reaches the op (a sealed program
    included)."""
    _require_cuda("exp_attention", q)
    return _K1(q, k, v)


exp_attention_cuda.launches = 0


def exp_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor):
    """Kernel K2 on CUDA tensors, through ``dupl::exp_attention_bwd``;
    raises for any other device.  Counts in
    ``exp_attention_bwd_cuda.launches``."""
    _require_cuda("exp_attention_bwd", q)
    return _K2(q, k, v, g)


exp_attention_bwd_cuda.launches = 0


def exp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float) -> torch.Tensor:
    """Max-free single-pass attention; q, k, v: (B, N, H, D) -> same, in
    ``q.dtype``.  q is scaled and rounded to bf16 first and the result is
    rounded to bf16, as the reference kernel does.  CPU tensors run the plain
    twins; CUDA tensors launch the kernels, forward and backward.  The scale
    product and the casts are ordinary autograd ops around the kernel pair.
    The scale is rounded to bf16 before the product, as jax's weakly typed
    scalar is (exact for head dim 64, where it is 1/8)."""
    # a Python float, so no scalar crosses to the device; bf16 times a
    # bf16-rounded scalar rounds as the product of two bf16 tensors does
    scale_bf16 = torch.tensor(scale, dtype=torch.bfloat16).item()
    qs = q.to(torch.bfloat16) * scale_bf16
    out = _ExpAttention.apply(qs, k.to(torch.bfloat16), v.to(torch.bfloat16))
    return out.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, tile: int = 128):
    """Plain twin of the flash-attention forward kernel: unscaled q, k, v,
    each (..., N, D) -> (out (..., N, D) bf16, lse (..., N) fp32).  Roundings
    as the kernel: operands rounded to bf16; s = scale * (q . k^T) in fp32;
    online softmax over ``tile``-key tiles with a running row maximum m, the
    running sum l of the fp32 p = exp(s - m) and the accumulator of
    bf16(p) . v both rescaled by exp(m_old - m_new); out = acc / l rounded to
    bf16 once; lse = m + log(l).  The kernel's key tile is 128: the running
    maximum, against which p is rounded, moves every 128 keys."""
    qf, kf, vf = (x.to(torch.bfloat16).float() for x in (q, k, v))
    n = qf.shape[-2]
    m = torch.full_like(qf[..., :1], float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for k0 in range(0, n, tile):
        s = torch.matmul(qf, kf[..., k0:k0 + tile, :].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(torch.bfloat16).float(),
                                        vf[..., k0:k0 + tile, :])
        m = m_new
    return (acc / l).to(torch.bfloat16), (m + torch.log(l))[..., 0]


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            out: torch.Tensor, lse: torch.Tensor,
                            g: torch.Tensor, scale: float):
    """Plain twin of the flash-attention backward kernel: unscaled q, k, v,
    the forward's out and the output cotangent g, each (..., N, D), and the
    forward's lse (..., N) -> (dq, dk, dv), each (..., N, D) bf16.  Roundings
    as the kernel: operands rounded to bf16; p = exp(scale * s - lse), t =
    g . v^T and delta = rowsum(out * g) in fp32; ds = p * (t - delta) rounded
    to bf16 before both of its products, p rounded to bf16 for dv; fp32 sums;
    dq = scale * ds . k, dk = scale * ds^T . q, dv = p^T . g, each rounded to
    bf16 once."""
    qf, kf, vf, of, gf = (x.to(torch.bfloat16).float()
                          for x in (q, k, v, out, g))
    s = torch.matmul(qf, kf.transpose(-1, -2))
    p = torch.exp(scale * s - lse.float()[..., None])
    t = torch.matmul(gf, vf.transpose(-1, -2))
    delta = (of * gf).sum(dim=-1, keepdim=True)
    ds = (p * (t - delta)).to(torch.bfloat16).float()
    dq = scale * torch.matmul(ds, kf)
    dk = scale * torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), gf)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _check_flash_operands(kernel: str, operands) -> None:
    """Shared checks of (B, N, H, D) bf16 kernel operands (the flash kernels
    and the experiment kernels of ``ops/experiments.py``)."""
    q = operands[0][0]
    if not (q.is_cuda and all(x.device == q.device for x, _ in operands)):
        raise ValueError(f"{kernel} kernel: operands must share one CUDA "
                         f"device")
    if q.dim() != 4 or any(x.shape != q.shape for x, _ in operands):
        raise ValueError(f"{kernel} kernel: want equal (B, N, H, D) shapes, "
                         f"got {[tuple(x.shape) for x, _ in operands]}")
    if q.shape[3] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel: head dim must be one of "
                         f"{_KERNEL_HEAD_DIMS}, got {q.shape[3]}")
    for x, name in operands:
        _check_operand(x, name, kernel)


@functools.lru_cache(maxsize=None)
def _flash_entry():
    """The C entry point of ``csrc/flash_attention.cu``, built on first
    use."""
    from dupl_tpu_torch.kernels import build

    fn = build.load("flash_attention").dupl_flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_int64),
                      ctypes.c_void_p])
    return fn


def _flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float):
    """``dupl::flash_attention`` on CUDA tensors: launch kernel L1f on the
    current stream.  Unscaled q, k, v:
    (B, N, H, D) bf16 on one CUDA device, D in {16, 32, 64, 80}, each
    possibly a strided view -> (out (B, N, H, D) bf16 contiguous, lse
    (B, H, N) fp32).  Any N; the scale is applied to the scores in the
    kernel."""
    from dupl_tpu_torch.kernels import build

    _check_flash_operands("flash_attention", ((q, "q"), (k, "k"), (v, "v")))
    b, n, h, d = q.shape
    out = torch.empty((b, n, h, d), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 9)(*q.stride()[:3], *k.stride()[:3],
                                   *v.stride()[:3])
    with torch.cuda.device(q.device):
        status = _flash_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), lse.data_ptr(), b, n, h, d,
                                float(scale), strides, _raw_stream(q.device))
    build.check(status, "flash_attention")
    flash_attention_cuda.launches += 1
    return out, lse


@functools.lru_cache(maxsize=None)
def _flash_bwd_entry():
    """The C entry point of ``csrc/flash_attention_bwd.cu``, built on first
    use."""
    from dupl_tpu_torch.kernels import build

    fn = build.load("flash_attention_bwd").dupl_flash_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.POINTER(ctypes.c_int64),
                      ctypes.c_void_p])
    return fn


def _flash_attention_bwd_kernel(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, out: torch.Tensor,
                                lse: torch.Tensor, g: torch.Tensor,
                                scale: float):
    """``dupl::flash_attention_bwd`` on CUDA tensors: launch kernel L1b on
    the current stream.  Unscaled q, k, v, the
    forward's out and the output cotangent g: (B, N, H, D) bf16 on one CUDA
    device, each possibly a strided view; lse: the forward's (B, H, N) fp32
    -> (dq, dk, dv), each (B, N, H, D) bf16 contiguous."""
    from dupl_tpu_torch.kernels import build

    _check_flash_operands("flash_attention_bwd", (
        (q, "q"), (k, "k"), (v, "v"), (out, "out"), (g, "g")))
    b, n, h, d = q.shape
    if (lse.shape != (b, h, n) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd kernel: lse must be a "
                         f"contiguous float32 {(b, h, n)} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=torch.bfloat16,
                              device=q.device) for _ in range(3))
    # lse (in log2 units) and delta = rowsum(out * g) of every query row,
    # padded to a multiple of 64 rows: written by the kernel's first pass and
    # copied tile by tile by its second
    npad = -(-n // 64) * 64
    scratch = torch.empty((2, b * h, npad), dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_int64 * 15)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3],
                                    *g.stride()[:3])
    with torch.cuda.device(q.device):
        status = _flash_bwd_entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            g.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), b, n, h, d, float(scale),
            strides, _raw_stream(q.device))
    build.check(status, "flash_attention_bwd")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


def _to_bhn(x: torch.Tensor) -> torch.Tensor:
    """(B, N, H, D) -> (B, H, N, D), a view."""
    return x.permute(0, 2, 1, 3)


def _flash_attention_twin(q, k, v, scale):
    out, lse = flash_attention_ref(_to_bhn(q), _to_bhn(k), _to_bhn(v), scale)
    return _to_bhn(out).contiguous(), lse.contiguous()


def _flash_attention_bwd_twin(q, k, v, out, lse, g, scale):
    grads = flash_attention_bwd_ref(*(_to_bhn(x) for x in (q, k, v, out)),
                                    lse, _to_bhn(g), scale)
    return tuple(_to_bhn(x).contiguous() for x in grads)


def _flash_attention_fake(q, k, v, scale):
    b, n, h, _ = q.shape
    return _bnhd_like(q), q.new_empty((b, h, n), dtype=torch.float32)


# L1f and L1b as the ops dupl::flash_attention and dupl::flash_attention_bwd,
# on unscaled (B, N, H, D) bf16 operands.  CPU tensors take the plain twins;
# CUDA tensors launch the kernels or raise.
_L1F = library.register(
    "flash_attention(Tensor q, Tensor k, Tensor v, float scale) "
    "-> (Tensor, Tensor)",
    cuda=_flash_attention_kernel, cpu=_flash_attention_twin,
    fake=_flash_attention_fake,
    flops=lambda q, k, v, scale: _attention_flops(q))
_L1B = library.register(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
    "Tensor lse, Tensor g, float scale) -> (Tensor, Tensor, Tensor)",
    cuda=_flash_attention_bwd_kernel, cpu=_flash_attention_bwd_twin,
    fake=lambda q, k, v, out, lse, g, scale: tuple(_bnhd_like(q)
                                                   for _ in range(3)),
    flops=lambda q, k, v, out, lse, g, scale: _attention_flops(
        q, backward=True))


class _FlashAttention(torch.autograd.Function):
    """L1f forward, L1b backward, both through their ops."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        _check_device(q, "flash_attention")
        out, lse = _L1F(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)  # k, v: views of the qkv product
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_L1B(q, k, v, out, lse, g.to(torch.bfloat16).contiguous(),
                      ctx.scale), None)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float):
    """Kernel L1f on CUDA tensors, through ``dupl::flash_attention``;
    raises for any other device.  Counts in
    ``flash_attention_cuda.launches``."""
    _require_cuda("flash_attention", q)
    return _L1F(q, k, v, float(scale))


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, g: torch.Tensor, scale: float):
    """Kernel L1b on CUDA tensors, through ``dupl::flash_attention_bwd``;
    raises for any other device.  Counts in
    ``flash_attention_bwd_cuda.launches``."""
    _require_cuda("flash_attention_bwd", q)
    return _L1B(q, k, v, out, lse, g, float(scale))


flash_attention_bwd_cuda.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float) -> torch.Tensor:
    """Exact softmax attention by the flash kernels; q, k, v: (B, N, H, D)
    -> same, in ``q.dtype``.  Operands are rounded to bf16 and the result is
    bf16, as the reference's library kernel takes and gives them; the scale
    is an fp32 argument applied to the scores.  CPU tensors run the plain
    twins; CUDA tensors launch the kernels, forward and backward."""
    out = _FlashAttention.apply(q.to(torch.bfloat16), k.to(torch.bfloat16),
                                v.to(torch.bfloat16), float(scale))
    return out.to(q.dtype)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: float) -> torch.Tensor:
    """Exact softmax attention, (B, N, H, D) -> (B, N, H, D), with the
    numerics of ``jax.nn.dot_product_attention``: logits in at least fp32,
    softmax in fp32, probabilities cast to the value dtype for the second
    product."""
    logit_dtype = torch.promote_types(q.dtype, torch.float32)
    qh = q.permute(0, 2, 1, 3).to(logit_dtype)
    kh = k.permute(0, 2, 1, 3).to(logit_dtype)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    out = torch.matmul(probs, v.permute(0, 2, 1, 3))
    return out.permute(0, 2, 1, 3)


def dot_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float) -> torch.Tensor:
    """q, k, v: (B, N, H, D) -> (B, N, H, D).  CPU tensors take exact
    softmax at every length; CUDA tensors the kernels by the unpadded token
    count: max-free exp attention below 2048, flash attention from there."""
    n = q.shape[1]
    if q.device.type == "cpu" or n < _EXP_MIN_SEQ:
        return softmax_attention(q, k, v, scale=scale)
    if n < _EXP_MAX_SEQ:
        return exp_attention(q, k, v, scale=scale)
    return flash_attention(q, k, v, scale=scale)
