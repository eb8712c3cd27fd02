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
* CUDA tensors with N >= 2048: not ported yet (the reference's library flash
  kernel); raises.

The exp form is softmax without the max subtraction: logits are clamped at
60 so exp never overflows fp32, which ViT attention logits never reach.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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


def _check_operand(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"exp_attention kernel: {name} must be bfloat16, "
                        f"got {x.dtype}")
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]):
        raise ValueError(f"exp_attention kernel: {name} needs a contiguous "
                         f"head dim and strides that are multiples of 8, got "
                         f"strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"exp_attention kernel: {name} must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of ``csrc/exp_attention.cu``, built on first use."""
    from dupl_tpu_torch.kernels import build

    fn = build.load("exp_attention").dupl_exp_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_int64] * 9 + [ctypes.c_void_p])
    return fn


def exp_attention_cuda(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Launch kernel K1 on the current stream.  q (pre-scaled), k, v:
    (B, N, H, D) bf16 on one CUDA device, D in {16, 32, 64, 80} ->
    (B, N, H, D) bf16.  k and v may be strided views (e.g. column slices of
    the qkv projection)."""
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
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, n, h, d, *q.stride()[:3],
                          *k.stride()[:3], *v.stride()[:3], stream)
    build.check(status, "exp_attention")
    exp_attention_cuda.launches += 1
    return out


exp_attention_cuda.launches = 0


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


def exp_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor):
    """Launch kernel K2 on the current stream.  q (pre-scaled), k, v and the
    output cotangent g: (B, N, H, D) bf16 on one CUDA device, D in
    {16, 32, 64, 80}, each possibly a strided view -> (dq, dk, dv), each
    (B, N, H, D) bf16 contiguous."""
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
    dq, dk, dv = (torch.empty((b, n, h, d), dtype=torch.bfloat16,
                              device=q.device) for _ in range(3))
    # the two row statistics, 1 / sum(e) and delta, written by the kernel's
    # first pass and read by its second
    stats = torch.empty((2, b * h, n), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *g.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _bwd_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                              dv.data_ptr(), stats[0].data_ptr(),
                              stats[1].data_ptr(), b, n, h, d, strides, stream)
    build.check(status, "exp_attention_bwd")
    exp_attention_bwd_cuda.launches += 1
    return dq, dk, dv


exp_attention_bwd_cuda.launches = 0


def _to_bhnd(x: torch.Tensor) -> torch.Tensor:
    b, n, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, n, d)


def _from_bhnd(x: torch.Tensor, b: int) -> torch.Tensor:
    bh, n, d = x.shape
    return x.reshape(b, bh // b, n, d).permute(0, 2, 1, 3)


class _ExpAttention(torch.autograd.Function):
    """Kernel K1 forward, kernel K2 backward, on (B, N, H, D) bf16 operands
    with q pre-scaled (the reference's ``custom_vjp``).  CPU tensors take
    the two plain twins; CUDA tensors launch the kernels or raise."""

    @staticmethod
    def forward(ctx, qs, k, v):
        ctx.save_for_backward(qs, k, v)   # k, v: views of the qkv product
        if qs.device.type == "cuda":
            return exp_attention_cuda(qs, k, v)
        if qs.device.type != "cpu":
            raise ValueError(f"exp_attention: unsupported device {qs.device}")
        out = exp_attention_ref(_to_bhnd(qs), _to_bhnd(k), _to_bhnd(v))
        return _from_bhnd(out.to(torch.bfloat16), qs.shape[0])

    @staticmethod
    def backward(ctx, g):
        qs, k, v = ctx.saved_tensors
        g = g.to(torch.bfloat16)
        if qs.device.type == "cuda":
            return exp_attention_bwd_cuda(qs, k, v, g.contiguous())
        grads = exp_attention_bwd_ref(_to_bhnd(qs), _to_bhnd(k), _to_bhnd(v),
                                      _to_bhnd(g))
        return tuple(_from_bhnd(x, qs.shape[0]) for x in grads)


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
    """q, k, v: (B, N, H, D) -> (B, N, H, D)."""
    n = q.shape[1]
    if q.device.type == "cpu" or n < _EXP_MIN_SEQ:
        return softmax_attention(q, k, v, scale=scale)
    if n < _EXP_MAX_SEQ:
        return exp_attention(q, k, v, scale=scale)
    raise ValueError(
        f"dot_attention: {n} tokens on {q.device} needs the flash-attention "
        f"kernel (N >= {_EXP_MAX_SEQ}), which is not ported yet")
