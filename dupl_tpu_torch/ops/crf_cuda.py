"""Fused CRF kernel-apply (counterpart of ``dupl_tpu/ops/crf_pallas.py``).

``kernel_apply`` computes ``exp(min(basis @ coef, logc)) @ vals`` with the
kernel entries and the values rounded to bf16 and fp32 accumulation: the
full-resolution slice of the fast mean-field CRF, as the registered op
``dupl::crf_apply``: CPU tensors run the plain twin (the reference's XLA
tile loop, ``dupl_tpu/ops/crf.py:171-185``); CUDA tensors launch kernel K5
(``csrc/crf_apply.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dupl_tpu_torch.ops import library

_DIM = 11


def kernel_apply_ref(basis: torch.Tensor, coef: torch.Tensor,
                     logc: torch.Tensor, vals: torch.Tensor,
                     block_rows: int = 25088) -> torch.Tensor:
    """Plain twin, tiled over ``block_rows`` pixel rows so the (rows, Ns)
    score tile bounds memory.  basis (B, N, 11), coef (B, 11, Ns), logc
    (B, Ns), vals (B, Ns, V) -> (B, N, V) float32."""
    vb = vals.to(torch.bfloat16).float()
    lc = logc[:, None, :]
    out = []
    for lo in range(0, basis.shape[1], block_rows):
        logk = torch.matmul(basis[:, lo:lo + block_rows], coef)
        k = torch.exp(torch.minimum(logk, lc)).to(torch.bfloat16).float()
        out.append(torch.matmul(k, vb))
    return torch.cat(out, dim=1)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point of ``csrc/crf_apply.cu``, built on first use."""
    from dupl_tpu_torch.kernels import build

    fn = build.load("crf_apply").dupl_crf_apply
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _values_bf16(vals: torch.Tensor) -> torch.Tensor:
    """K5's and P3's value operand: (B, Ns, V) rounded to bf16 once and
    zero-padded to a multiple of 8 columns (the kernels copy them 16 bytes
    at a time)."""
    vb = vals.to(torch.bfloat16)
    nv = vals.shape[-1]
    return torch.nn.functional.pad(vb, (0, 8 - nv % 8)) if nv % 8 else vb


def _kernel_apply_kernel(basis: torch.Tensor, coef: torch.Tensor,
                         logc: torch.Tensor, vals: torch.Tensor,
                         block_rows: int) -> torch.Tensor:
    """``dupl::crf_apply`` on CUDA tensors: launch kernel K5 on the current
    stream; one launch covers the batch and every value column (any V; up
    to 96 from one score and exp per pixel and pivot).  ``block_rows``
    tiles the CPU twin only."""
    from dupl_tpu_torch.kernels import build

    dev = basis.device
    for x, name in ((basis, "basis"), (coef, "coef"), (logc, "logc"),
                    (vals, "vals")):
        if x.device != dev or not x.is_cuda:
            raise ValueError(f"crf kernel_apply: {name} must be on {dev} "
                             f"(a CUDA device), got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"crf kernel_apply: {name} must be float32, "
                            f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"crf kernel_apply: {name} must be contiguous")
    b, n, d = basis.shape
    ns, nv = vals.shape[1], vals.shape[2]
    if (d != _DIM or coef.shape != (b, _DIM, ns) or logc.shape != (b, ns)
            or vals.shape[0] != b):
        raise ValueError(f"crf kernel_apply: want basis (B, N, {_DIM}), coef "
                         f"(B, {_DIM}, Ns), logc (B, Ns), vals (B, Ns, V); got "
                         f"{tuple(basis.shape)} {tuple(coef.shape)} "
                         f"{tuple(logc.shape)} {tuple(vals.shape)}")
    if nv < 1:
        raise ValueError(f"crf kernel_apply: V must be at least 1, got {nv}")
    vb = _values_bf16(vals)
    out = torch.empty((b, n, nv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = _entry()(basis.data_ptr(), coef.data_ptr(), logc.data_ptr(),
                          vb.data_ptr(), out.data_ptr(), b, n, ns, nv,
                          stream)
    build.check(status, "crf_apply")
    kernel_apply_cuda.launches += 1
    return out


def _kernel_apply_fake(basis, coef, logc, vals, block_rows):
    return basis.new_empty((*basis.shape[:2], vals.shape[2]),
                           dtype=torch.float32)


# K5 as the op dupl::crf_apply (``ops/library.py``): the launcher above on
# CUDA tensors, the plain twin on CPU tensors.
_K5 = library.register(
    "crf_apply(Tensor basis, Tensor coef, Tensor logc, Tensor vals, "
    "int block_rows) -> Tensor",
    cuda=_kernel_apply_kernel, cpu=kernel_apply_ref, fake=_kernel_apply_fake)


def kernel_apply_cuda(basis: torch.Tensor, coef: torch.Tensor,
                      logc: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Kernel K5 on CUDA tensors, through ``dupl::crf_apply``; raises for
    any other device.  ``kernel_apply_cuda.launches`` counts K5's launches
    by any route that reaches the op (a sealed program included)."""
    if not basis.is_cuda:
        raise ValueError(f"crf kernel_apply: operands must be on a CUDA "
                         f"device, got {basis.device}")
    return _K5(basis, coef, logc, vals, 0)


kernel_apply_cuda.launches = 0


def kernel_apply(basis: torch.Tensor, coef: torch.Tensor, logc: torch.Tensor,
                 vals: torch.Tensor, block_rows: int = 25088) -> torch.Tensor:
    """Fused ``exp(min(basis @ coef, logc)) @ vals`` for a batch of images:
    basis (B, N, 11), coef (B, 11, Ns), logc (B, Ns), vals (B, Ns, V) ->
    (B, N, V) float32.  ``block_rows`` tiles the CPU twin only."""
    if basis.device.type == "cpu":
        return _K5(basis, coef, logc, vals, block_rows)
    if basis.device.type != "cuda":
        raise ValueError(f"crf kernel_apply: unsupported device {basis.device}")
    return kernel_apply_cuda(basis, coef, logc, vals.float().contiguous())
