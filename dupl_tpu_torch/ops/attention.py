"""Attention dispatch (counterpart of ``dupl_tpu/ops/attention.py``).

``dot_attention`` follows the reference's dispatch by sequence length:

* CPU tensors, and any sequence shorter than 128 tokens: exact softmax
  attention in plain torch (matmul, softmax, matmul) — what
  ``jax.nn.dot_product_attention`` gives the reference there;
* CUDA tensors with 128 <= N < 2048: the max-free exp-attention kernel
  (``csrc/exp_attention.cu``, kernel K1), which every ViT block of the
  serving path runs at every scale (785, 1226 and 1765 tokens at a 448 crop);
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


def exp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float) -> torch.Tensor:
    """Max-free single-pass attention; q, k, v: (B, N, H, D) -> same, in
    ``q.dtype``.  q is scaled and rounded to bf16 first and the result is
    rounded to bf16, as the reference kernel does.  CPU tensors run the plain
    twin; CUDA tensors launch the kernel.  The scale is rounded to bf16
    before the product, as jax's weakly typed scalar is (exact for head dim
    64, where it is 1/8)."""
    scale_bf16 = torch.tensor(scale, dtype=torch.bfloat16, device=q.device)
    qs = q.to(torch.bfloat16) * scale_bf16
    if q.device.type == "cpu":
        b, n, h, d = q.shape

        def to_bhnd(x):
            return x.permute(0, 2, 1, 3).reshape(b * h, n, d)

        out = exp_attention_ref(to_bhnd(qs), to_bhnd(k), to_bhnd(v))
        out = out.to(torch.bfloat16).reshape(b, h, n, d).permute(0, 2, 1, 3)
        return out.to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"exp_attention: unsupported device {q.device}")
    return exp_attention_cuda(qs, k.to(torch.bfloat16),
                              v.to(torch.bfloat16)).to(q.dtype)


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
