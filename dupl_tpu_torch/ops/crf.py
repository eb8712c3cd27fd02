"""Batched mean-field DenseCRF (counterpart of ``dupl_tpu/ops/crf.py``).

Same pairwise model and the same pivot approximation as the reference: each
``s x s`` cell is a Gaussian blob in the 5-D bilateral feature space (mean
plus per-dimension variance), and a pixel's bilateral message is computed
against the blobs with the moment-matched kernel, which expands over the
basis (f^2, f, 1) into one 11-wide product.  The position kernel is a local
separable Gaussian at full resolution.

The reference vmaps one image at a time; here every step carries the batch
dimension.  The full-resolution kernel apply (``cross_apply``) is
:func:`dupl_tpu_torch.ops.crf_cuda.kernel_apply`: kernel K5 for CUDA tensors,
the plain tile loop for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dupl_tpu_torch.ops import crf_cuda
from dupl_tpu_torch.ops.image import resize_nearest


def _pos_message(q: torch.Tensor, std: float) -> torch.Tensor:
    """Short-range Gaussian message, zero-padded and normalised by the same
    filter applied to ones.  q: (B, H, W, C).  The separable filter runs as
    shifted fp32 sums, so the result does not depend on the convolution
    backend's precision settings."""
    radius = max(1, int(2 * std))
    ax = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k1 = torch.exp(-0.5 * (ax / std) ** 2).tolist()

    def filt(x, axis):
        n = x.shape[axis]
        pad = [0] * (2 * x.dim())
        pad[2 * (x.dim() - 1 - axis)] = radius      # F.pad lists the last
        pad[2 * (x.dim() - 1 - axis) + 1] = radius  # dim first
        xp = torch.nn.functional.pad(x, pad)
        out = None
        for i, w in enumerate(k1):
            term = xp.narrow(axis, i, n) * w
            out = term if out is None else out + term
        return out

    h, w = q.shape[1:3]
    out = filt(filt(q, 1), 2)
    ones = torch.ones((1, h, w, 1), dtype=q.dtype, device=q.device)
    norm = filt(filt(ones, 1), 2)
    return out / norm


def _features(image01: torch.Tensor, xy_std: float,
              rgb_std: float) -> torch.Tensor:
    """(B, H, W, 5) scaled bilateral features: x/σxy, y/σxy, rgb*255/σrgb."""
    b, h, w, _ = image01.shape
    dev = image01.device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) / xy_std)
    xs = (torch.arange(w, dtype=torch.float32, device=dev) / xy_std)
    ys = ys[None, :, None, None].expand(b, h, w, 1)
    xs = xs[None, None, :, None].expand(b, h, w, 1)
    rgb = image01.float() * (255.0 / rgb_std)
    return torch.cat([xs, ys, rgb], dim=-1)


def _pool(x: torch.Tensor, s: int) -> torch.Tensor:
    """Mean-pool (B, H, W, C) by s."""
    b, h, w, c = x.shape
    return x.reshape(b, h // s, s, w // s, s, c).mean(dim=(2, 4))


def _quad_basis(f: torch.Tensor) -> torch.Tensor:
    """(..., 5) features -> (..., 11) basis (f^2, f, 1)."""
    return torch.cat([f * f, f, torch.ones_like(f[..., :1])], dim=-1)


def pivot_lattice(image01: torch.Tensor, s: int, xy_std: float,
                  rgb_std: float) -> Tuple[torch.Tensor, ...]:
    """The moment-matched pivot blobs of every image:
    ``(basis_full (B, N, 11), coef (B, 11, Ns), logc (B, Ns), mu (B, Ns, 5),
    sig2 (B, Ns, 5))``, with K[i, j] = exp(min(basis_i . coef_j, logc_j))."""
    b = image01.shape[0]
    feat = _features(image01, xy_std, rgb_std)              # (B, H, W, 5)
    mu = _pool(feat, s).reshape(b, -1, 5)                   # (B, Ns, 5)
    m2 = _pool(feat * feat, s).reshape(b, -1, 5)
    sig2 = torch.clamp(m2 - mu * mu, min=0.0)
    prec = 1.0 / (1.0 + sig2)
    logc = -0.5 * torch.log1p(sig2).sum(dim=-1)             # (B, Ns)
    coef = torch.cat([
        -0.5 * prec,
        prec * mu,
        (-0.5 * (prec * mu * mu).sum(dim=-1) + logc)[..., None],
    ], dim=-1).transpose(1, 2).contiguous()                 # (B, 11, Ns)
    basis_full = _quad_basis(feat.reshape(b, -1, 5)).contiguous()
    return basis_full, coef, logc.contiguous(), mu, sig2


_DEGREE_CHUNK = 512  # pivot rows per step: bounds the (B, rows, Ns, 5) temporaries


def _bb_degree(mu: torch.Tensor, sig2: torch.Tensor,
               cnt: float) -> torch.Tensor:
    """Exact blob-to-blob moment-matched degree, (B, Ns), in row chunks."""
    out = []
    for lo in range(0, mu.shape[1], _DEGREE_CHUNK):
        mu_c = mu[:, lo:lo + _DEGREE_CHUNK]
        sig2_c = sig2[:, lo:lo + _DEGREE_CHUNK]
        var = 1.0 + sig2_c[:, :, None, :] + sig2[:, None, :, :]
        d2 = (mu_c[:, :, None, :] - mu[:, None, :, :]) ** 2
        k_bb = torch.exp(-0.5 * (d2 / var).sum(-1)) * torch.rsqrt(var.prod(-1))
        out.append(k_bb.sum(-1) * cnt)
    return torch.cat(out, dim=1)


def _bf16_matmul(a_bf16: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 accumulation and result."""
    return torch.matmul(a_bf16.float(), x.to(torch.bfloat16).float())


def mean_field_crf(image01: torch.Tensor, probs: torch.Tensor, *,
                   iters: int = 10, pos_w: float = 1.0,
                   pos_xy_std: float = 1.0, bi_w: float = 4.0,
                   bi_xy_std: float = 121.0, bi_rgb_std: float = 5.0,
                   downsample: int = 8, row_chunk: int = 56,
                   fast: bool = False,
                   return_logits: bool = False) -> torch.Tensor:
    """Mean-field inference for a batch.

    image01: (B, H, W, 3) in [0,1]; probs: (B, H, W, C) softmax
    probabilities.  Returns (B, H, W, C) marginals (or, with ``fast`` and
    ``return_logits``, the final logits, whose argmax is the same).  H and W
    must be multiples of ``downsample``; ``row_chunk`` tiles the CPU twin of
    the kernel apply.  ``fast=True`` iterates on the pivot lattice and slices
    to full resolution once at the end."""
    b, h, w, c = probs.shape
    s = downsample
    probs = probs.float()
    basis_full, coef, logc, mu, sig2 = pivot_lattice(image01, s, bi_xy_std,
                                                     bi_rgb_std)
    ns = mu.shape[1]
    cnt = float(s * s)

    def cross_apply(values_small):
        return crf_cuda.kernel_apply(basis_full, coef, logc, values_small,
                                     block_rows=row_chunk * w)

    unary = -torch.log(torch.clamp(probs, min=1e-20))

    if fast:
        ks = torch.exp(torch.minimum(torch.matmul(_quad_basis(mu), coef),
                                     logc[:, None, :])).to(torch.bfloat16)
        us = _pool(unary, s).reshape(b, ns, c)
        deg_small = _bb_degree(mu, sig2, cnt)
        invf_small = torch.rsqrt(torch.clamp(deg_small, min=1e-12))
        wsc = (invf_small * s * s)[..., None]                # (B, Ns, 1)
        qs = _pool(probs, s).reshape(b, ns, c)
        for _ in range(iters - 1):
            m = _bf16_matmul(ks, qs * wsc) * invf_small[..., None]
            qs = torch.softmax(-us + bi_w * m, dim=-1)
        # final full-res update: bilateral slice + local position kernel; the
        # cell count rides as an extra value column so the full-res degree
        # comes out of the same kernel apply
        vals = torch.cat([qs * wsc, torch.full((b, ns, 1), cnt,
                                               device=qs.device)], dim=-1)
        out_cols = cross_apply(vals)
        inv_sqrt_full = torch.rsqrt(torch.clamp(out_cols[..., c], min=1e-12))
        m_bi = (out_cols[..., :c] * inv_sqrt_full[..., None]).reshape(b, h, w, c)
        q_up = resize_nearest(qs.reshape(b, h // s, w // s, c), (h, w))
        m_pos = _pos_message(q_up, pos_xy_std)
        logits = -unary + bi_w * m_bi + pos_w * m_pos
        return logits if return_logits else torch.softmax(logits, dim=-1)

    ones = torch.full((b, ns, 1), cnt, device=probs.device)
    deg_full = cross_apply(ones)[..., 0]                     # (B, N)
    inv_sqrt_full = torch.rsqrt(torch.clamp(deg_full, min=1e-12))
    inv_sqrt_map = inv_sqrt_full.reshape(b, h, w, 1)
    q = probs
    for _ in range(iters):
        qsum = _pool(q * inv_sqrt_map, s).reshape(b, ns, c) * (s * s)
        m_bi = (cross_apply(qsum) * inv_sqrt_full[..., None]).reshape(b, h, w, c)
        m_pos = _pos_message(q, pos_xy_std)
        q = torch.softmax(-unary + bi_w * m_bi + pos_w * m_pos, dim=-1)
    return q


def _auto_tile(h: int, limit: int) -> int:
    """Largest divisor of h not exceeding ``limit``."""
    for t in range(min(limit, h), 0, -1):
        if h % t == 0:
            return t
    return 1


def crf_from_config(image01, probs, cfg, **kw):
    """``mean_field_crf`` with the parameters of a ``CrfConfig``."""
    h = probs.shape[1]
    kw.setdefault("downsample", _auto_tile(h, 8))
    kw.setdefault("row_chunk", _auto_tile(h, 56))
    return mean_field_crf(
        image01, probs, iters=cfg.iter_max, pos_w=cfg.pos_w,
        pos_xy_std=cfg.pos_xy_std, bi_w=cfg.bi_w, bi_xy_std=cfg.bi_xy_std,
        bi_rgb_std=cfg.bi_rgb_std, **kw,
    )


def crf_labels_from_config(image01: torch.Tensor, probs: torch.Tensor, cfg,
                           class_budget: Optional[int] = None,
                           **kw) -> torch.Tensor:
    """CRF -> argmax labels (B, H, W) int64, optionally with the class axis
    compacted to a per-image budget (the wide-class-axis throughput lever:
    COCO runs 81 classes).

    Compaction picks each image's ``class_budget`` most plausible classes by
    total spatial probability mass (``torch.topk`` over the per-class sum)
    and runs mean-field on those slots only, which conditions the CRF on
    "the label is one of the image's K dominant classes".  Mass, not max:
    mean-field with a long-range bilateral kernel is itself a mass vote.
    Slot indices map back to class ids with a one-hot matmul, as in the
    reference."""
    b, h, w, c = probs.shape
    if class_budget is None or class_budget >= c:
        lg = crf_from_config(image01, probs, cfg, return_logits=True, **kw)
        return lg.argmax(dim=-1)

    k = class_budget
    score = probs.sum(dim=(1, 2))                            # (B, C)
    idx = torch.topk(score, k, dim=-1).indices               # (B, k)
    sel = torch.nn.functional.one_hot(idx, c).to(probs.dtype)   # (B, k, C)
    compact = torch.einsum("bhwc,bkc->bhwk", probs, sel)
    lg = crf_from_config(image01, compact, cfg, return_logits=True, **kw)
    onehot = torch.nn.functional.one_hot(lg.argmax(dim=-1), k).float()
    ids = torch.einsum("bhwk,bk->bhw", onehot, idx.float())
    return ids.long()
