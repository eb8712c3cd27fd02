"""The pseudo-label engine: CAM -> pixel pseudo-labels (counterpart of
``dupl_tpu/ops/cam.py``; reference: utils/cam_helper.py).

CAMs are (B, H, W, C) with C the foreground classes; pseudo-labels are
(B, H, W) int64 with 0 background, c foreground class c (1-indexed) and
``ignore_index`` uncertain.  The batch axis is carried throughout; the
reference loops over images in Python.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from dupl_tpu_torch.ops import image as image_ops


def _threshold(value, like: torch.Tensor) -> torch.Tensor:
    """A scalar or tensor threshold as a tensor of ``like``'s dtype on its
    device.  A Python scalar is filled in on the device: a copy from the
    host would wait for all work queued there."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=like.dtype)
    return torch.full((), float(value), dtype=like.dtype, device=like.device)


def cam_to_label(cam: torch.Tensor, cls_label: torch.Tensor, *,
                 bkg_thre: float, img_box: Optional[torch.Tensor] = None,
                 ignore_mid: bool = False, high_thre=None, low_thre=None,
                 ignore_index: int = 255
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CAM -> banded pseudo-label (reference: utils/cam_helper.py:8-55).

    cam: (B, H, W, C_fg); cls_label: (B, C_fg) multi-hot.  ``high_thre`` is
    a scalar or a per-sample (B,) tensor.  Banding order: argmax + 1, then
    ``<= bkg_thre -> 0``, then (``ignore_mid``) ``<= high_thre -> ignore``
    and ``<= low_thre -> 0``, and outside ``img_box`` -> ignore.  Returns
    (valid_cam, pseudo_label)."""
    b, h, w, _ = cam.shape
    valid_cam = cam * cls_label[:, None, None, :]
    cam_value, label = valid_cam.max(dim=-1)
    label = label + 1
    label = torch.where(cam_value <= bkg_thre, 0, label)
    if ignore_mid:
        high = _threshold(high_thre, cam)
        if high.dim() == 1:
            high = high[:, None, None]
        label = torch.where(cam_value <= high, ignore_index, label)
        label = torch.where(cam_value <= low_thre, 0, label)
    if img_box is not None:
        label = torch.where(image_ops.box_mask(img_box, h, w), label,
                            ignore_index)
    return valid_cam, label


def label_to_aff_mask(cam_label: torch.Tensor,
                      ignore_index: int = 255) -> torch.Tensor:
    """Pseudo-label (B, H, W) -> (B, HW, HW) pairwise same-class target
    (reference: utils/cam_helper.py:323-335): 1 same class, 0 different,
    ``ignore_index`` on pairs touching an ignored pixel and on the
    diagonal."""
    b, h, w = cam_label.shape
    flat = cam_label.reshape(b, h * w)
    aff = (flat[:, :, None] == flat[:, None, :]).long()
    ign = flat == ignore_index
    aff = torch.where(ign[:, :, None] | ign[:, None, :], ignore_index, aff)
    eye = torch.eye(h * w, dtype=torch.bool, device=cam_label.device)
    return torch.where(eye[None], ignore_index, aff)


def _flip_merge(cam: torch.Tensor, b: int, size) -> torch.Tensor:
    """(2B, h, w, C) CAMs of a batch and its horizontal flip -> (B, mh, mw,
    C): resized, max-merged with the un-flipped copy, ReLU'd."""
    cam = image_ops.resize_bilinear(cam, size)
    return torch.relu(torch.maximum(cam[:b], cam[b:].flip(2)))


def _scaled(inputs: torch.Tensor, s: float) -> torch.Tensor:
    _, h, w, _ = inputs.shape
    return inputs if s == 1.0 else image_ops.resize_bilinear(
        inputs, (int(s * h), int(s * w)))


def multi_scale_cam(cam_fn: Callable, inputs: torch.Tensor,
                    scales: Sequence[float], *,
                    merge_size: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-scale + flip CAM fusion (reference: utils/cam_helper.py:
    164-204).  ``cam_fn(x)`` maps an NHWC batch to ``(cam, cam_aux)`` at
    patch resolution.  Per scale the batch rides with its flip; CAMs are
    resized to ``merge_size`` (default: the input size), flip-max-merged,
    ReLU'd and summed over scales, then min-max normalised per (sample,
    class)."""
    b, h, w, _ = inputs.shape
    size = tuple(merge_size) if merge_size is not None else (h, w)
    cam_sum = aux_sum = None
    for s in scales:
        x = _scaled(inputs, s)
        cam, cam_aux = cam_fn(torch.cat([x, x.flip(2)], dim=0))
        cam, cam_aux = _flip_merge(cam, b, size), _flip_merge(cam_aux, b, size)
        cam_sum = cam if cam_sum is None else cam_sum + cam
        aux_sum = cam_aux if aux_sum is None else aux_sum + cam_aux
    return (image_ops.spatial_minmax_norm(cam_sum),
            image_ops.spatial_minmax_norm(aux_sum))


def multi_scale_cam_with_outputs(full_fn: Callable, cam_fn: Callable,
                                 inputs: torch.Tensor,
                                 scales: Sequence[float], *,
                                 with_aux: bool = True,
                                 merge_size: Optional[Tuple[int, int]] = None,
                                 split_flip: bool = False):
    """:func:`multi_scale_cam` whose scale-1.0 pass runs ``full_fn``
    (``Student.forward_with_cams``), so the caller also gets the head
    outputs of the un-flipped batch from the same encoder pass.

    Returns (cams, cams_aux, out); ``with_aux=False`` skips the aux fusion
    (cams_aux is None).  ``split_flip`` runs the un-flipped scale-1.0 batch
    through ``full_fn`` and its flip through ``cam_fn`` instead of one
    2B batch."""
    b, h, w, _ = inputs.shape
    size = tuple(merge_size) if merge_size is not None else (h, w)
    out_keep = None
    cam_sum = aux_sum = None
    for s in scales:
        x = _scaled(inputs, s)
        if s == 1.0 and split_flip:
            out_keep, cam_u, aux_u = full_fn(x)
            cam_f, aux_f = cam_fn(x.flip(2))
            cam = torch.cat([cam_u, cam_f], dim=0)
            cam_aux = torch.cat([aux_u, aux_f], dim=0)
        else:
            both = torch.cat([x, x.flip(2)], dim=0)
            if s == 1.0:
                out, cam, cam_aux = full_fn(both)
                out_keep = type(out)(*(a[:b] for a in out))
            else:
                cam, cam_aux = cam_fn(both)
        cam = _flip_merge(cam, b, size)
        cam_sum = cam if cam_sum is None else cam_sum + cam
        if with_aux:
            cam_aux = _flip_merge(cam_aux, b, size)
            aux_sum = cam_aux if aux_sum is None else aux_sum + cam_aux
    return (image_ops.spatial_minmax_norm(cam_sum),
            image_ops.spatial_minmax_norm(aux_sum) if with_aux else None,
            out_keep)


def class_budget_predicate(cls_label: torch.Tensor,
                           class_budget: int) -> torch.Tensor:
    """Whether every image's present classes, background included, fit in
    ``class_budget`` slots: a bool tensor on ``cls_label``'s device, which a
    sealed program branches on (``torch.cond``) without reading it on the
    host."""
    return ((cls_label > 0).sum(-1) < class_budget).all()


def fits_class_budget(cls_label: torch.Tensor,
                      class_budget: Optional[int]) -> bool:
    """:func:`class_budget_predicate` on the host (False without a budget):
    whether PAR can run on the compacted class axis.  Reads ``cls_label``
    (B, C_fg) on the host: one device sync when it lies on a card, so
    callers decide this before queueing any work."""
    if class_budget is None:
        return False
    return bool(class_budget_predicate(cls_label, class_budget))


def refine_cams_with_bkg(par_fn: Callable, images: torch.Tensor,
                         cams: torch.Tensor, cls_label: torch.Tensor, *,
                         high_thre, low_thre: float,
                         img_box: Optional[torch.Tensor],
                         ignore_index: int = 255, down_scale: int = 2,
                         class_budget: Optional[int] = None,
                         fits_budget=None) -> torch.Tensor:
    """PAR-refined pseudo-labels with dual background planes (reference:
    utils/cam_helper.py:338-431).

    images: (B, H, W, 3) in [0, 1]; cams: (B, H, W, C_fg), or (V, B, H, W,
    C_fg) for V CAM views of the same images (the dual students), already
    masked by the class label; cls_label: (B, C_fg).  ``high_thre`` is a
    scalar, a per-sample (B,) tensor or a (B, H, W, 1) map.  Returns
    (B, H, W) labels, or (V, B, H, W).

    Each view gives two stacks, [background plane at high_thre | CAMs] and
    [background at low_thre | CAMs], each softmaxed over its present classes
    (absent ones masked to -1e30, so they are exactly 0 and stay 0 through
    PAR).  All 2V stacks ride one PAR call on the class axis, so the
    image-only affinity is computed once.  Label = the high stack's argmax,
    except high == 0 -> ignore, and high == low == 0 -> background.

    ``class_budget`` compacts the class axis to that many slots, present
    classes first (background, then ascending): exact, since absent slots
    stay 0.  If an image has more present classes than slots, the full axis
    runs instead.  ``fits_budget`` is :func:`fits_class_budget`'s answer,
    taken by the caller before it queued the CAMs; None reads ``cls_label``
    here, which waits for the work already queued.  A tensor
    (:func:`class_budget_predicate`) keeps both routes and chooses on the
    device, by ``torch.cond``: the form a sealed program takes."""
    b, h, w, _ = images.shape
    hs, ws = h // down_scale, w // down_scale
    squeeze_view = cams.dim() == 4
    if squeeze_view:
        cams = cams[None]
    v = cams.shape[0]

    # resize acts per channel and keeps constants: the constant background
    # planes are made at the small size, not resized
    high = _threshold(high_thre, cams)
    if high.dim() <= 1:
        bkg_h = high.reshape(-1, 1, 1, 1).expand(b, hs, ws, 1)
    else:
        bkg_h = image_ops.resize_bilinear(high, (hs, ws))
    bkg_l = torch.full((b, hs, ws, 1), low_thre, dtype=cams.dtype,
                       device=cams.device)
    present = torch.cat([torch.ones_like(cls_label[:, :1]), cls_label],
                        dim=-1) > 0                           # (B, nclass)

    images_small = image_ops.resize_bilinear(images, (hs, ws))
    cams_small = (cams if cams.shape[2:4] == (hs, ws)
                  else image_ops.resize_bilinear(cams, (hs, ws), batch_dims=2))

    def masked_softmax(stack):
        stack = torch.where(present[:, None, None, :], stack,
                            torch.full_like(stack, -1e30))
        return torch.softmax(stack, dim=-1)

    nclass = cams_small.shape[-1] + 1
    planes = []
    for vi in range(v):       # plane order: v0_hi, v0_lo, v1_hi, v1_lo, ...
        planes.append(masked_softmax(torch.cat([bkg_h, cams_small[vi]], -1)))
        planes.append(masked_softmax(torch.cat([bkg_l, cams_small[vi]], -1)))
    probs = torch.stack(planes, dim=3)                 # (B, hs, ws, 2V, nclass)

    def plane_labels(p):
        """(B, hs, ws, 2V, k) -> PAR, full-size argmax: high and low labels,
        each (V, B, h, w)."""
        k = p.shape[-1]
        refined = par_fn(images_small, p.reshape(b, hs, ws, 2 * v * k))
        refined = image_ops.resize_bilinear(refined, (h, w))
        lab = refined.reshape(b, h, w, 2 * v, k).argmax(dim=-1)
        lab = lab.permute(3, 0, 1, 2)                     # (2V, B, h, w)
        return lab[0::2], lab[1::2]

    def compacted(probs, present):
        k = class_budget
        score = present.long() * (2 * nclass) - torch.arange(
            nclass, device=present.device)
        idx = torch.topk(score, k, dim=-1).indices             # (B, k)
        compact = torch.gather(probs, 4, idx[:, None, None, None, :].expand(
            b, hs, ws, 2 * v, k))
        slot_h, slot_l = plane_labels(compact)

        def unmap(slot):                                   # slot -> class id
            table = idx[None].expand(v, b, k)
            return torch.gather(table, 2, slot.reshape(v, b, -1)).reshape(
                slot.shape)

        return unmap(slot_h), unmap(slot_l)

    def full(probs, present):
        return plane_labels(probs)

    if class_budget is None or class_budget >= nclass:
        label_h, label_l = full(probs, present)
    elif isinstance(fits_budget, torch.Tensor):
        def dense(route):      # torch.cond wants one layout from both routes
            return lambda *ops: tuple(x.contiguous() for x in route(*ops))

        label_h, label_l = torch.cond(fits_budget, dense(compacted),
                                      dense(full), (probs, present))
    else:
        if fits_budget is None:
            fits_budget = fits_class_budget(cls_label, class_budget)
        route = compacted if fits_budget else full
        label_h, label_l = route(probs, present)

    if img_box is not None:
        inside = image_ops.box_mask(img_box, h, w)[None]       # over views
        label_h = torch.where(inside, label_h, ignore_index)
        label_l = torch.where(inside, label_l, ignore_index)

    label = torch.where(label_h == 0, ignore_index, label_h)
    label = torch.where(label_h + label_l == 0, 0, label)
    return label[0] if squeeze_view else label
