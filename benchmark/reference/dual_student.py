"""Plain float32 reference of DuPL's ViT dual student and of the two
programs the benchmark drives: the pseudo-label factory (multi-scale + flip
CAMs of both students, PAR refinement with dual background planes, the fast
mean-field CRF over student 1's segmentation posteriors) and the serving
program (multi-scale + flip segmentation logits of both students, max
merge, ensemble, fast CRF).

It follows the published method (DuPL, ``model/model_dupl.py``,
``model/PAR.py``, ``utils/cam_helper.py``, ``utils/dcrf.py``; DeiT-B/16) and
the configuration's file, in float32 throughout: no bf16 rounding, exact
softmax attention, the pivot CRF without its bf16 kernel entries.

``prec`` picks the arithmetic: ``"fp32"``; ``"int8"`` (the int8
configuration's) and ``"int4"`` (its control): the four products of every
block as w-a products quantized as ``dupl_tpu/ops/quant.py:36-48`` defines
them (per-row activation and per-output-channel weight scales
``max|.| / qmax``, at least 1e-8, round-half-even, clipped to +-qmax, an
exact integer sum, here in float64, then the float32 rescale and the bias);
``"fp8"`` (the bf16 configuration's control): every value the configuration
holds in bf16 rounded to float8 e4m3 instead, each row scaled to its
largest value: the operands of every product (the block's four, the
attention's two, the patch embedding's and the decoder's), the residual
stream, PAR's masks and affinities each round, the CRF's kernel entries and
values.  ``None`` takes the configuration's: ``"int8"`` with
``quantized_inference``, else ``"fp32"``.

Everything acts per image, so the caller runs it in blocks of images.  It
imports neither JAX, nor the JAX package, nor anything of
``dupl_tpu_torch``, and takes nothing the program has made, except where a
caller judges the CRF on its own (``crf_fast_logits``, ``serving_labels``)
on the input that the program gave it, once that input has been judged
against the reference's own.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (123.675, 116.28, 103.53)
IMAGENET_STD = (58.395, 57.12, 57.375)
OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
           (1, 1))
_ROW_BLOCK = 8192      # CRF pixel rows a step
_E4M3_MAX = 448.0
_BITS = {"int8": 8, "int4": 4}


def fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3, each slice along ``dim`` scaled so that its
    largest magnitude is e4m3's largest."""
    s = torch.clamp(x.abs().amax(dim=dim, keepdim=True) / _E4M3_MAX,
                    min=1e-30)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _low(x: torch.Tensor, prec: str, dim: int = -1) -> torch.Tensor:
    return fp8(x, dim) if prec == "fp8" else x


# -- image operations ----------------------------------------------------------

def prepare(images_u8: torch.Tensor):
    """uint8 (B, H, W, 3) -> (ImageNet-normalised, [0, 1]) float32."""
    f = images_u8.float()
    mean = torch.tensor(IMAGENET_MEAN, device=f.device)
    std = torch.tensor(IMAGENET_STD, device=f.device)
    return (f - mean) / std, f / 255.0


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """NHWC bilinear resize, half-pixel centres, no antialias."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def minmax_norm(cam: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per (image, class) spatial min-max normalisation of (B, H, W, C)."""
    cam = cam - cam.amin(dim=(1, 2), keepdim=True)
    return cam / (cam.amax(dim=(1, 2), keepdim=True) + eps)


# -- the dual student ----------------------------------------------------------

def quantize(x: torch.Tensor, bits: int):
    """Rows of x (R, K) -> (integer values as float, scales (R, 1))."""
    qmax = 2 ** (bits - 1) - 1
    s = torch.clamp(x.abs().amax(dim=1, keepdim=True) / qmax, min=1e-8)
    return torch.clamp(torch.round(x / s), -qmax, qmax), s


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           prec: str) -> torch.Tensor:
    """A block's product ``x w^T + b`` in ``prec``."""
    if prec not in _BITS:
        return F.linear(_low(x, prec), _low(w, prec), b)
    bits = _BITS[prec]
    k = x.shape[-1]
    qx, sx = quantize(x.reshape(-1, k), bits)
    qw, sw = quantize(w, bits)
    acc = torch.matmul(qx.double(), qw.double().t()).float()
    y = acc * sx * sw.t() + b
    return y.reshape(*x.shape[:-1], w.shape[0])


def gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "tanh":
        return 0.5 * x * (1.0 + torch.tanh(
            math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def encoder(W: Dict[str, torch.Tensor], pre: str, x: torch.Tensor,
            cfg: dict, prec: str, record: Optional[list] = None):
    """ViT of ``cfg`` on (M, H, W, 3) -> (patch tokens after the final
    LayerNorm, aux tokens after block ``aux_layer``), each (M, h, w, D).
    ``record`` gathers (product name, None, input rows, output rows) of
    64 rows of every block product."""
    m, hh, ww, _ = x.shape
    p, d, g = cfg["patch_size"], cfg["embed_dim"], cfg["pretrained_grid"]
    heads, depth = cfg["num_heads"], cfg["depth"]
    h, w = hh // p, ww // p
    t = F.conv2d(_low(x.permute(0, 3, 1, 2), prec, 1),
                 _low(W[f"{pre}.patch_embed.proj.weight"].flatten(1), prec)
                 .view_as(W[f"{pre}.patch_embed.proj.weight"]),
                 W[f"{pre}.patch_embed.proj.bias"], stride=p)
    t = t.flatten(2).transpose(1, 2)
    pos = W[f"{pre}.pos_embed"]
    patch_pos = pos[:, 1:]
    if (h, w) != (g, g):
        grid = patch_pos.reshape(1, g, g, d).permute(0, 3, 1, 2)
        patch_pos = F.interpolate(grid, size=(h, w), mode="bicubic",
                                  align_corners=False)
        patch_pos = patch_pos.permute(0, 2, 3, 1).reshape(1, h * w, d)
    cls = W[f"{pre}.cls_token"].expand(m, 1, d)
    z = _low(torch.cat([cls, t], dim=1) + torch.cat([pos[:, :1], patch_pos], 1),
             prec)
    aux_idx = cfg["aux_layer"] % depth
    aux = None
    hd = d // heads

    def lin(y, name):
        out = linear(y, W[f"{name}.weight"], W[f"{name}.bias"], prec)
        if record is not None:
            y2, o2 = y.reshape(-1, y.shape[-1]), out.reshape(-1, out.shape[-1])
            idx = torch.linspace(0, y2.shape[0] - 1, 64,
                                 device=y.device).long()
            record.append((name, None, y2[idx], o2[idx]))
        return out

    for i in range(depth):
        b = f"{pre}.blocks.{i}"
        y = F.layer_norm(z, (d,), W[f"{b}.norm1.weight"],
                         W[f"{b}.norm1.bias"], 1e-6)
        qkv = lin(y, f"{b}.attn.qkv")
        q, k, v = (_low(t, prec) for t in qkv.reshape(
            m, -1, 3, heads, hd).permute(2, 0, 3, 1, 4))
        att = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5,
                            dim=-1)
        o = torch.matmul(_low(att, prec), v).transpose(1, 2).reshape(m, -1, d)
        z = _low(z + lin(o, f"{b}.attn.proj"), prec)
        y = F.layer_norm(z, (d,), W[f"{b}.norm2.weight"],
                         W[f"{b}.norm2.bias"], 1e-6)
        y = gelu(lin(y, f"{b}.mlp.fc1"), cfg["gelu"])
        z = _low(z + lin(y, f"{b}.mlp.fc2"), prec)
        if i == aux_idx:
            aux = z
    z = F.layer_norm(z, (d,), W[f"{pre}.norm.weight"], W[f"{pre}.norm.bias"],
                     1e-6)
    if aux_idx == depth - 1:
        aux = z
    return (z[:, 1:].reshape(m, h, w, d), aux[:, 1:].reshape(m, h, w, d))


def cam_head(W, student: str, fmap: torch.Tensor) -> torch.Tensor:
    """The classifier applied per pixel: (M, h, w, D) -> (M, h, w, C_fg)."""
    return torch.matmul(fmap, W[f"{student}.classifier.weight"][:, :, 0, 0].t())


def decoder(W, student: str, fmap: torch.Tensor, cfg: dict,
            prec: str = "fp32") -> torch.Tensor:
    """LargeFOV: (M, h, w, D) -> (M, h, w, C) segmentation logits."""
    dil = cfg["decoder_dilation"]

    def conv(x, name, **kw):
        w = W[f"{student}.decoder.{name}.weight"]
        if prec == "fp8":
            x, w = fp8(x, 1), fp8(w.flatten(1)).view_as(w)
        return F.conv2d(x, w, **kw)

    x = fmap.permute(0, 3, 1, 2)
    x = F.relu(conv(x, "conv6", padding=dil, dilation=dil))
    x = F.relu(conv(x, "conv7", padding=dil, dilation=dil))
    return conv(x, "conv8").permute(0, 2, 3, 1)


def _scaled(x: torch.Tensor, s: float) -> torch.Tensor:
    h, w = x.shape[1:3]
    return x if s == 1.0 else resize_bilinear(x, (int(s * h), int(s * w)))


def multi_scale_cam(W, student: str, x: torch.Tensor, cfg: dict,
                    merge_size, prec: str, record: Optional[list] = None):
    """A student's CAMs over ``cam_scales``, each scale with its horizontal
    flip (max-merged at ``merge_size``, ReLU, summed, min-max normalised),
    and its scale-1.0 segmentation logits of the un-flipped images."""
    b = x.shape[0]
    total, seg = None, None
    for s in cfg["cam_scales"]:
        xs = _scaled(x, s)
        fmap, _ = encoder(W, f"{student}.encoder",
                          torch.cat([xs, xs.flip(2)]), cfg, prec, record)
        cam = resize_bilinear(cam_head(W, student, fmap), merge_size)
        cam = torch.relu(torch.maximum(cam[:b], cam[b:].flip(2)))
        total = cam if total is None else total + cam
        if s == 1.0:
            seg = decoder(W, student, fmap[:b], cfg, prec)
    return minmax_norm(total), seg


# -- PAR -----------------------------------------------------------------------

def _taps(dilations: Sequence[int]):
    return [(dy * d, dx * d) for d in dilations for dy, dx in OFFSETS]


def _shift(x: torch.Tensor, dy: int, dx: int, r: int) -> torch.Tensor:
    """x (N, C, H, W) padded by replication with r: the tap at (dy, dx)."""
    h, w = x.shape[2] - 2 * r, x.shape[3] - 2 * r
    return x[:, :, r + dy:r + dy + h, r + dx:r + dx + w]


def par(imgs: torch.Tensor, masks: torch.Tensor, p: dict,
        prec: str = "fp32") -> torch.Tensor:
    """PAR (``model/PAR.py``): the 8-neighbour RGB affinity at each dilation
    (softmax over the taps of -(|dI| / std / w1)^2, channel mean, plus w2
    times the softmax of the same over the taps' distances), then
    ``num_iter`` rounds of mask <- sum_k neighbour_k(mask) * aff_k, with
    replicate padding.  imgs (B, H, W, 3), masks (B, H, W, C) -> (B, H, W,
    C)."""
    taps = _taps(p["dilations"])
    r = max(p["dilations"])
    w1, w2 = p["w1"], p["w2"]
    x = imgs.permute(0, 3, 1, 2)
    xp = F.pad(x, (r, r, r, r), mode="replicate")
    nb = torch.stack([_shift(xp, dy, dx, r) for dy, dx in taps], dim=2)
    std = nb.std(dim=2, keepdim=True)
    aff = -((nb - x[:, :, None]).abs() / (std + 1e-8) / w1) ** 2
    aff = torch.softmax(aff.mean(dim=1), dim=1)               # (B, K, H, W)
    dist = torch.tensor([math.hypot(dy, dx) for dy, dx in taps],
                        dtype=torch.float64)
    pos = torch.softmax(-(dist / (dist.std() + 1e-8) / w1) ** 2, dim=0)
    aff = aff + (w2 * pos).float().to(aff.device)[None, :, None, None]
    aff = _low(aff, prec, 1)
    m = masks.permute(0, 3, 1, 2)
    for _ in range(p["num_iter"]):
        mp = F.pad(_low(m, prec, 1), (r, r, r, r), mode="replicate")
        m = sum(_shift(mp, dy, dx, r) * aff[:, k:k + 1]
                for k, (dy, dx) in enumerate(taps))
    return m.permute(0, 2, 3, 1)


def box_mask(img_box: torch.Tensor, h: int, w: int) -> torch.Tensor:
    rows = torch.arange(h, device=img_box.device)[None, :, None]
    cols = torch.arange(w, device=img_box.device)[None, None, :]
    t, bt, l, rt = (img_box[:, i, None, None] for i in range(4))
    return (rows >= t) & (rows < bt) & (cols >= l) & (cols < rt)


def refine(cams: torch.Tensor, image01: torch.Tensor, cls_label: torch.Tensor,
           img_box: torch.Tensor, cfg: dict, fits: bool, prec: str = "fp32"):
    """Pseudo-labels of both students' CAMs (``utils/cam_helper.py:
    refine_cams_with_bkg``): each view's [background at high_thre | CAMs]
    and [background at low_thre | CAMs], each softmaxed over the image's
    present classes, all in one PAR call at half size (on the image's
    present classes first, in ``class_budget`` slots, where every image of
    the batch fits them: ``fits``); labels by the high stack's argmax,
    ignore where it is background, background where both are.  cams (V, B,
    h, w, C_fg) -> (PAR's output (B, hs, ws, 2V k), labels (V, B, H, W))."""
    p = cfg["par"]
    v, b = cams.shape[:2]
    h, w = image01.shape[1:3]
    hs, ws = h // p["down_scale"], w // p["down_scale"]
    cams = cams * cls_label[None, :, None, None, :]
    cams_small = (cams if cams.shape[2:4] == (hs, ws) else torch.stack(
        [resize_bilinear(c, (hs, ws)) for c in cams]))
    present = torch.cat([torch.ones_like(cls_label[:, :1]), cls_label],
                        -1) > 0
    nclass = present.shape[1]
    planes = []
    for vi in range(v):
        for thre in (cfg["high_thre"], cfg["low_thre"]):
            bkg = torch.full((b, hs, ws, 1), thre, device=cams.device)
            stack = torch.cat([bkg, cams_small[vi]], -1)
            stack = torch.where(present[:, None, None, :], stack,
                                torch.full_like(stack, -1e30))
            planes.append(torch.softmax(stack, -1))
    probs = torch.stack(planes, dim=3)                  # (B, hs, ws, 2V, n)
    budget = p["class_budget"]
    if budget is not None and budget < nclass and fits:
        score = present.long() * (2 * nclass) - torch.arange(
            nclass, device=present.device)
        idx = torch.topk(score, budget, dim=-1).indices          # (B, k)
        probs = torch.gather(probs, 4, idx[:, None, None, None, :].expand(
            b, hs, ws, 2 * v, budget))
    else:
        idx = torch.arange(nclass, device=cams.device).expand(b, nclass)
    k = probs.shape[-1]
    refined = par(resize_bilinear(image01, (hs, ws)),
                  probs.reshape(b, hs, ws, 2 * v * k), p, prec)
    return refined, labels_of(refined, idx, img_box, cfg, (h, w))


def labels_of(refined: torch.Tensor, idx: torch.Tensor, img_box: torch.Tensor,
              cfg: dict, size) -> torch.Tensor:
    """PAR's output (B, hs, ws, 2V k) on class slots ``idx`` (B, k) ->
    pseudo-labels (V, B, H, W)."""
    b, k = idx.shape
    v = refined.shape[-1] // (2 * k)
    h, w = size
    full = resize_bilinear(refined, (h, w)).reshape(b, h, w, 2 * v, k)
    slot = full.argmax(-1).permute(3, 0, 1, 2)                # (2V, B, H, W)
    lab = torch.gather(idx[None].expand(2 * v, b, k), 2,
                       slot.reshape(2 * v, b, -1)).reshape(slot.shape)
    inside = box_mask(img_box, h, w)[None]
    ign = cfg["ignore_index"]
    lab_h = torch.where(inside, lab[0::2], ign)
    lab_l = torch.where(inside, lab[1::2], ign)
    label = torch.where(lab_h == 0, ign, lab_h)
    return torch.where(lab_h + lab_l == 0, 0, label)


# -- the fast mean-field CRF ---------------------------------------------------

def _pool(x: torch.Tensor, s: int) -> torch.Tensor:
    b, h, w, c = x.shape
    return x.reshape(b, h // s, s, w // s, s, c).mean(dim=(2, 4)).reshape(
        b, -1, c)


def _quad(f: torch.Tensor) -> torch.Tensor:
    return torch.cat([f * f, f, torch.ones_like(f[..., :1])], dim=-1)


def _pos_message(q: torch.Tensor, std: float) -> torch.Tensor:
    """The short-range Gaussian message (zero padding), normalised by the
    same filter over ones; shifted sums, no convolution."""
    radius = max(1, int(2 * std))
    taps = [math.exp(-0.5 * (a / std) ** 2)
            for a in range(-radius, radius + 1)]

    def filt(x, axis):
        n = x.shape[axis]
        pad = [0, 0] * x.dim()
        pad[2 * (x.dim() - 1 - axis)] = pad[2 * (x.dim() - 1 - axis) + 1] = \
            radius
        xp = F.pad(x, pad)
        return sum(xp.narrow(axis, i, n) * t for i, t in enumerate(taps))

    ones = torch.ones((1, q.shape[1], q.shape[2], 1), device=q.device)
    return filt(filt(q, 1), 2) / filt(filt(ones, 1), 2)


def crf_fast_logits(image01: torch.Tensor, probs: torch.Tensor,
                    c: dict, prec: str = "fp32") -> torch.Tensor:
    """The fast mean-field CRF's logits (``ops/crf.py``'s pivot scheme on
    the published DenseCRF settings): every ``downsample`` x
    ``downsample`` cell a Gaussian blob in the bilateral (x, y, rgb)
    space; ``iter_max`` - 1 mean-field rounds on the blobs, then one
    full-resolution round (bilateral slice plus the local position
    kernel).  (B, H, W, 3), (B, H, W, C) -> (B, H, W, C)."""
    b, h, w, nc = probs.shape
    s = c["downsample"]
    dev = probs.device
    ys = (torch.arange(h, device=dev, dtype=torch.float32)
          / c["bi_xy_std"])[None, :, None, None].expand(b, h, w, 1)
    xs = (torch.arange(w, device=dev, dtype=torch.float32)
          / c["bi_xy_std"])[None, None, :, None].expand(b, h, w, 1)
    feat = torch.cat([xs, ys, image01 * (255.0 / c["bi_rgb_std"])], -1)
    mu, m2 = _pool(feat, s), _pool(feat * feat, s)
    sig2 = torch.clamp(m2 - mu * mu, min=0.0)
    pr = 1.0 / (1.0 + sig2)
    logc = -0.5 * torch.log1p(sig2).sum(-1)                       # (B, Ns)
    coef = torch.cat([-0.5 * pr, pr * mu,
                      (-0.5 * (pr * mu * mu).sum(-1) + logc)[..., None]],
                     -1).transpose(1, 2)                          # (B, 11, Ns)
    cnt = float(s * s)
    ks = torch.exp(torch.minimum(torch.matmul(_quad(mu), coef),
                                 logc[:, None, :]))
    deg = []
    for lo in range(0, mu.shape[1], 512):
        var = 1.0 + sig2[:, lo:lo + 512, None, :] + sig2[:, None, :, :]
        d2 = (mu[:, lo:lo + 512, None, :] - mu[:, None, :, :]) ** 2
        kbb = torch.exp(-0.5 * (d2 / var).sum(-1)) * torch.rsqrt(
            var.prod(-1))
        deg.append(kbb.sum(-1) * cnt)
    invf = torch.rsqrt(torch.clamp(torch.cat(deg, 1), min=1e-12))
    wsc = (invf * cnt)[..., None]
    unary = -torch.log(torch.clamp(probs, min=1e-20))
    us = _pool(unary, s)
    qs = _pool(probs, s)
    ks = _low(ks, prec)
    for _ in range(c["iter_max"] - 1):
        msg = torch.matmul(ks, _low(qs * wsc, prec, 1)) * invf[..., None]
        qs = torch.softmax(-us + c["bi_w"] * msg, -1)
    vals = torch.cat([qs * wsc, torch.full((b, qs.shape[1], 1), cnt,
                                           device=dev)], -1)
    vals = _low(vals, prec, 1)
    basis = _quad(feat.reshape(b, -1, 5))
    cols = []
    for lo in range(0, basis.shape[1], _ROW_BLOCK):
        kern = torch.exp(torch.minimum(
            torch.matmul(basis[:, lo:lo + _ROW_BLOCK], coef),
            logc[:, None, :]))
        cols.append(torch.matmul(_low(kern, prec), vals))
    cols = torch.cat(cols, 1)
    m_bi = (cols[..., :nc] * torch.rsqrt(torch.clamp(
        cols[..., nc:], min=1e-12))).reshape(b, h, w, nc)
    q_up = qs.reshape(b, h // s, w // s, nc).repeat_interleave(
        s, 1).repeat_interleave(s, 2)
    return -unary + c["bi_w"] * m_bi + c["pos_w"] * _pos_message(
        q_up, c["pos_xy_std"])


# -- the two programs ----------------------------------------------------------

def _prec(cfg: dict, prec) -> str:
    if prec is not None:
        return prec
    return "int8" if cfg.get("quantized_inference") else "fp32"


def _head_prec(prec: str) -> str:
    """The stages after the encoder (PAR, the CRF) hold no int8 values."""
    return "fp8" if prec == "fp8" else "fp32"


def pseudo_label(W, cfg: dict, images: torch.Tensor, cls_label: torch.Tensor,
                 img_box: torch.Tensor, fits: bool, prec=None,
                 record: Optional[list] = None) -> dict:
    """The pseudo-label factory on a block of images: ``cams`` (2, B, H/2,
    W/2, C_fg), ``par`` (PAR's output), ``refined`` (2, B, H, W) labels,
    ``crf`` logits (B, H, W, C) with their inputs ``image01`` and
    ``crf_probs``, and ``crf_labels`` (B, H, W)."""
    prec = _prec(cfg, prec)
    x, image01 = prepare(images)
    h, w = x.shape[1:3]
    cams, seg = [], None
    for i, student in enumerate(("branch1", "branch2")):
        cam, sg = multi_scale_cam(W, student, x, cfg, (h // 2, w // 2), prec,
                                  record)
        cams.append(cam)
        if i == 0:
            seg = sg
    cams = torch.stack(cams)
    refined, labels = refine(cams, image01, cls_label, img_box, cfg, fits,
                             _head_prec(prec))
    probs = torch.softmax(resize_bilinear(seg, (h, w)), -1)
    logits = crf_fast_logits(image01, probs, cfg["crf"], _head_prec(prec))
    return {"cams": cams, "par": refined, "refined": labels, "crf": logits,
            "crf_probs": probs, "image01": image01,
            "crf_labels": logits.argmax(-1)}


def serving(W, cfg: dict, images: torch.Tensor, scales: Sequence[float],
            merge: str = "max", prec=None,
            record: Optional[list] = None) -> dict:
    """The serving program (ensemble of both students) on a block of
    images: ``seg`` (2, B, H, W, C) merged logits and ``labels`` (B, H, W),
    the fast CRF's answer on them (``serving_labels``)."""
    prec = _prec(cfg, prec)
    x, image01 = prepare(images)
    b, h, w = x.shape[:3]
    segs = []
    for student in ("branch1", "branch2"):
        merged = None
        for s in scales:
            xs = _scaled(x, s)
            fmap, _ = encoder(W, f"{student}.encoder",
                              torch.cat([xs, xs.flip(2)]), cfg, prec, record)
            sg = resize_bilinear(decoder(W, student, fmap, cfg, prec),
                                 (h, w))
            sg = sg[:b] + sg[b:].flip(2)
            if merged is None:
                merged = sg
            elif merge == "max":
                merged = torch.maximum(merged, sg)
            else:
                merged = merged + sg
        segs.append(merged)
    seg = torch.stack(segs)
    return {"seg": seg, "labels": serving_labels(image01, seg, cfg,
                                                 _head_prec(prec))}


def serving_labels(image01: torch.Tensor, seg: torch.Tensor, cfg: dict,
                   prec: str = "fp32") -> torch.Tensor:
    """The serving program's answer from merged logits ``seg`` (2, B, H, W,
    C): the mean of both students, softmax, the fast CRF, argmax."""
    probs = torch.softmax(seg.float().mean(0), -1)
    return crf_fast_logits(image01, probs, cfg["crf"], prec).argmax(-1)


def product(W, name: str, x: torch.Tensor, gelu_kind, cfg: dict,
            prec=None) -> torch.Tensor:
    """One block product of the module ``name`` (``...blocks.i.attn.qkv``)
    on rows x, as the configuration computes it (the GELU of x first where
    ``gelu_kind`` is given: fc2 of an int8 block takes fc1's output)."""
    if gelu_kind is not None:
        x = gelu(x, gelu_kind)
    return linear(x, W[f"{name}.weight"], W[f"{name}.bias"],
                  _prec(cfg, prec))
