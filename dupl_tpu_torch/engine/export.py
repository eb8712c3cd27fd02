"""The serving program, the pseudo-label program and their sealed form
(counterpart of ``dupl_tpu/engine/export.py``).

:class:`ServingProgram` (uint8 images -> uint8 label maps) and
:class:`PseudoLabelProgram` (images, class labels, boxes -> per-branch
pseudo-labels and CRF labels) are ``nn.Module``s.  The live functions
:func:`make_serving_fn` and :func:`make_pseudo_label_fn` call them under
``torch.inference_mode``; :func:`export_serving` and
:func:`export_pseudo_labeler` trace the same modules with ``torch.export``
under ``torch.no_grad()`` into an ``ExportedProgram``, with the weights baked
in (``bake_params=True``) or as a ``(params, inputs...)`` signature.  Every
kernel of the path is a registered ``dupl::`` op (``ops/library.py``), so the
sealed graph calls the kernels by name: it runs on the card through the same
launchers (and launch counts) as the live path, on the CPU through the same
twins.

Artifact format (one file, ``.duplsrv``), the JAX package's container: the
8-byte magic ``DUPLSRV1``, a uint64 little-endian JSON length, the UTF-8 JSON
metadata (the JAX package's keys, plus ``"runtime": "torch"`` and
``"kernels"``: each op's source digest, ``kernels/build.py:digests``), then
the payload of ``torch.export.save``.  A sealed torch program does not carry
the kernels' code, so :func:`load_artifact` refuses an artifact whose kernel
digests differ from this checkout's sources, and one written by the JAX
package (a StableHLO payload).

Not ported: ``platform="tpu"`` (there is no TPU runtime here; a program is
sealed on the device it will run on, ``device="cuda"`` on the card or
``"cpu"``) and the ``mesh=`` batch-sharded export (one card a process; it
waits for multi-card serving).  Passing either raises ``ValueError``.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from dupl_tpu_torch.engine.eval_seg import msc_seg_logits
from dupl_tpu_torch.engine.train import refine
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import cam as cam_ops
from dupl_tpu_torch.ops import crf as crf_ops
from dupl_tpu_torch.ops import image as image_ops

_MAGIC = b"DUPLSRV1"
_VOC_SCALES = (1.0, 1.5, 1.25)


class ServingProgram(nn.Module):
    """uint8 (B, H, W, 3) image batch -> uint8 (B, H, W) label map.

    Multi-scale + flip seg logits, flip-sum, scale merge, then one student's
    logits (``branch`` in {1, 2}: only that student is held, so only it runs
    and only its weights are sealed) or the mean of both, softmax, the fast
    mean-field CRF, argmax."""

    def __init__(self, cfg, model: DualStudent, *,
                 scales: Sequence[float] = _VOC_SCALES, merge: str = "max",
                 branch: "int | str" = "ensemble", crf: bool = True):
        super().__init__()
        if branch not in (1, 2, "ensemble"):
            raise ValueError(f"branch must be 1, 2 or 'ensemble', got "
                             f"{branch!r}")
        self.net = model if branch == "ensemble" else model.student(branch - 1)
        self.crf_cfg = cfg.crf
        self.scales, self.merge = tuple(scales), merge
        self.ensemble, self.crf = branch == "ensemble", crf

    def _seg(self, both: torch.Tensor) -> torch.Tensor:
        seg = self.net(both).seg          # (2, B, h, w, C) or (B, h, w, C)
        return seg if self.ensemble else seg[None]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x, image01 = image_ops.prepare_inputs(images)
        seg = msc_seg_logits(self._seg, x, x.shape[1:3], self.scales,
                             self.merge, batch_dims=2)
        pick = seg.mean(dim=0) if self.ensemble else seg[0]
        if self.crf:
            probs = torch.softmax(pick, dim=-1)
            pick = crf_ops.crf_from_config(image01, probs, self.crf_cfg,
                                           fast=True, return_logits=True)
        return pick.argmax(dim=-1).to(torch.uint8)


class PseudoLabelProgram(nn.Module):
    """The pseudo-label factory: multi-scale + flip CAMs of both students at
    ``cfg.cam_scales``, merged at half the input size; PAR refinement of
    both into per-branch pseudo-labels; the fast mean-field CRF over student
    1's segmentation posteriors.

    ``forward(images, cls_label, img_box)`` takes uint8 (B, H, W, 3) images,
    (B, C_fg) multi-hot class labels and (B, 4) int boxes on the model's
    device and returns ``(refined, crf_labels)``: uint8 (2, B, H, W)
    pseudo-labels (``cfg.ignore_index`` marks the ignore band) and uint8
    (B, H, W) CRF labels, both at the input resolution.

    Whether PAR runs on the compacted class axis depends on the class
    labels.  Live, the answer is read on the host before any work is
    queued; traced, it stays a device predicate and both routes are sealed,
    chosen by ``torch.cond``."""

    def __init__(self, cfg, model: DualStudent):
        super().__init__()
        self.cfg, self.model = cfg, model

    def forward(self, images: torch.Tensor, cls_label: torch.Tensor,
                img_box: torch.Tensor):
        cfg = self.cfg
        budget = cfg.par.class_budget
        if torch.compiler.is_compiling() and budget is not None:
            fits = cam_ops.class_budget_predicate(cls_label, budget)
        else:
            fits = cam_ops.fits_class_budget(cls_label, budget)
        x, image01 = image_ops.prepare_inputs(images)
        merge = (x.shape[1] // 2, x.shape[2] // 2)
        cams, segs = [], []
        for i in range(2):              # the JAX package vmaps the branches
            s = self.model.student(i)
            cam, _, out = cam_ops.multi_scale_cam_with_outputs(
                s.forward_with_cams, s.cam_only, x, cfg.cam_scales,
                with_aux=False, merge_size=merge)
            cams.append(cam)
            segs.append(out.seg)
        refined = refine(cfg, torch.stack(cams), image01, cls_label, img_box,
                         high_thre=cfg.high_thre, fits_budget=fits)
        seg = image_ops.resize_bilinear(segs[0], x.shape[1:3])
        logits = crf_ops.crf_from_config(image01, torch.softmax(seg, dim=-1),
                                         cfg.crf, fast=True,
                                         return_logits=True)
        return refined.to(torch.uint8), logits.argmax(dim=-1).to(torch.uint8)


def make_serving_fn(cfg, model: DualStudent, *,
                    scales: Sequence[float] = _VOC_SCALES,
                    merge: str = "max",
                    branch: "int | str" = "ensemble",
                    crf: bool = True):
    """:class:`ServingProgram` as a function under ``torch.inference_mode``:
    uint8 (B, H, W, 3) image batch on the model's device -> uint8 (B, H, W)
    label map."""
    program = ServingProgram(cfg, model, scales=scales, merge=merge,
                             branch=branch, crf=crf)

    @torch.inference_mode()
    def fn(images: torch.Tensor) -> torch.Tensor:
        return program(images)

    return fn


def make_pseudo_label_fn(cfg, model: DualStudent):
    """:class:`PseudoLabelProgram` as a function under
    ``torch.inference_mode``: ``fn(images, cls_label, img_box) -> (refined,
    crf_labels)`` (counterpart of
    ``dupl_tpu/engine/export.py:make_pseudo_label_fn``)."""
    program = PseudoLabelProgram(cfg, model)

    @torch.inference_mode()
    def fn(images: torch.Tensor, cls_label: torch.Tensor,
           img_box: torch.Tensor):
        return program(images, cls_label, img_box)

    return fn


def _weights(model: nn.Module) -> dict:
    """``model``'s parameters and buffers by name: the ``params`` argument
    of an unbaked program (the keys of ``models/convert.py:load_weights``
    for a ``DualStudent``)."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


class _Unbaked(nn.Module):
    """``forward(params, *inputs)``: ``program`` run on the weights in
    ``params``, keyed as in ``model`` (``torch.func.functional_call``).
    ``program`` is held outside the module tree, so its own weights are not
    sealed."""

    def __init__(self, program: nn.Module, model: nn.Module):
        super().__init__()
        self._program = (program,)
        key = {id(t): name for name, t in _weights(model).items()}
        self._keys = [(name, key[id(t)])
                      for name, t in _weights(program).items()]

    def forward(self, params, *inputs):
        return torch.func.functional_call(
            self._program[0], {name: params[k] for name, k in self._keys},
            inputs)


def _refuse_unported(platform, mesh) -> None:
    if platform is not None:
        raise ValueError(
            f"platform={platform!r}: the PyTorch port seals a program on the "
            "device it runs on (device='cuda' or 'cpu'); there is no "
            "cross-platform export (dupl_tpu's platform='tpu' has no "
            "counterpart here)")
    if mesh is not None:
        raise ValueError(
            "mesh=: the batch-sharded export is not ported (one card a "
            "process); export for one device")


def _export(program: nn.Module, model: DualStudent,
            inputs: Tuple[torch.Tensor, ...], device, bake_params: bool):
    """``torch.export`` of ``program`` (over ``model``, moved to
    ``device``) on ``inputs`` under ``no_grad``; with ``bake_params`` False,
    of the ``(params, *inputs)`` signature, ``params`` keyed as ``model``'s
    weights.  One eager call first puts ``ops/image.py``'s constants on the
    device, so that the program records them as constants and does not
    rebuild and copy them on every call."""
    model.to(device).eval()
    with torch.no_grad():
        program(*inputs)
        if bake_params:
            return torch.export.export(program, inputs)
        return torch.export.export(_Unbaked(program, model),
                                   (_weights(model), *inputs))


def _meta(kind: str, device: torch.device, batch_size: int, crop: int,
          bake_params: bool, **kw) -> dict:
    from dupl_tpu_torch.kernels import build

    return {"format": "duplsrv/1", "kind": kind, "runtime": "torch",
            "platforms": [device.type], "batch_size": batch_size,
            "crop_size": crop, "bake_params": bake_params, "num_devices": 1,
            "mesh": None, "kernels": build.digests(), **kw}


def export_serving(cfg, model: DualStudent, *, batch_size: int = 8,
                   scales: Sequence[float] = _VOC_SCALES,
                   merge: str = "max",
                   branch: "int | str" = "ensemble",
                   crf: bool = True,
                   device="cuda",
                   bake_params: bool = True,
                   platform: Optional[str] = None,
                   mesh=None):
    """Trace the serving program (:class:`ServingProgram`, the model moved
    to ``device``) at ``(batch_size, crop, crop, 3)`` uint8 and return
    ``(torch.export.ExportedProgram, metadata dict)``.

    ``bake_params=True`` keeps the weights in the program (the artifact is
    self-contained); ``bake_params=False`` exports a ``(params, images)``
    signature for weight-swap serving, ``params`` the model's weights by
    name (``models/convert.py:load_weights`` of a ``.npz``).  ``branch`` 1
    or 2 seals only that student."""
    _refuse_unported(platform, mesh)
    device = torch.device(device)
    crop = cfg.data.crop_size
    program = ServingProgram(cfg, model, scales=scales, merge=merge,
                             branch=branch, crf=crf)
    images = torch.zeros((batch_size, crop, crop, 3), dtype=torch.uint8,
                         device=device)
    exported = _export(program, model, (images,), device, bake_params)
    meta = _meta(
        "segmentation", device, batch_size, crop, bake_params,
        num_classes=cfg.num_classes, class_list=list(cfg.class_list),
        scales=list(scales), merge=merge, branch=branch, crf=crf,
        input=f"uint8[{batch_size},{crop},{crop},3] RGB",
        output=f"uint8[{batch_size},{crop},{crop}] class ids")
    return exported, meta


def export_pseudo_labeler(cfg, model: DualStudent, *, batch_size: int = 16,
                          device="cuda", bake_params: bool = True,
                          platform: Optional[str] = None, mesh=None):
    """Seal the pseudo-label factory (:class:`PseudoLabelProgram`) the way
    :func:`export_serving` seals the segmentation service, at uint8 images,
    float32 (B, C_fg) class labels and int32 (B, 4) boxes; both class-budget
    routes are in the one program."""
    _refuse_unported(platform, mesh)
    device = torch.device(device)
    crop = cfg.data.crop_size
    nfg = cfg.num_classes - 1
    inputs = (torch.zeros((batch_size, crop, crop, 3), dtype=torch.uint8,
                          device=device),
              torch.zeros((batch_size, nfg), dtype=torch.float32,
                          device=device),
              torch.zeros((batch_size, 4), dtype=torch.int32, device=device))
    exported = _export(PseudoLabelProgram(cfg, model), model, inputs, device,
                       bake_params)
    meta = _meta(
        "pseudo_labeler", device, batch_size, crop, bake_params,
        num_classes=cfg.num_classes, cam_scales=list(cfg.cam_scales),
        ignore_index=cfg.ignore_index,
        input=(f"uint8[{batch_size},{crop},{crop},3] RGB, "
               f"float32[{batch_size},{nfg}] cls one-hot, "
               f"int32[{batch_size},4] img box"),
        output="per-branch PAR pseudo-labels + CRF seg labels (uint8)")
    return exported, meta


def save_artifact(path: str, exported, meta: dict) -> None:
    """Write ``exported`` and ``meta`` as one ``.duplsrv`` file."""
    payload = io.BytesIO()
    torch.export.save(exported, payload)
    blob = json.dumps(meta, sort_keys=True).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        f.write(payload.getbuffer())


def _read_header(f, path: str) -> dict:
    magic = f.read(len(_MAGIC))
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a DuPL serving artifact "
                         f"(magic {magic!r})")
    (n,) = struct.unpack("<Q", f.read(8))
    meta = json.loads(f.read(n).decode("utf-8"))
    runtime = meta.get("runtime")
    if runtime != "torch":
        raise ValueError(
            f"{path}: a {runtime or 'jax'} artifact (runtime {runtime!r}), "
            "not one of the PyTorch port; re-export it with "
            "tools/export_model_torch.py")
    from dupl_tpu_torch.kernels import build

    want, have = build.digests(), meta.get("kernels", {})
    stale = sorted(k for k in set(want) | set(have)
                   if have.get(k) != want.get(k))
    if stale:
        raise ValueError(
            f"{path}: sealed against other kernel sources than this "
            f"checkout's ({', '.join(stale)}); re-export it")
    return meta


def read_meta(path: str) -> dict:
    """The metadata of a ``.duplsrv`` file, without its program; refuses
    what :func:`load_artifact` refuses."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def load_artifact(path: str):
    """-> (torch.export.ExportedProgram, metadata dict).  Refuses a file
    that is not a serving artifact, one written by another runtime (the JAX
    package's StableHLO artifacts) and one whose kernel digests differ from
    this checkout's sources."""
    # the sealed graph calls the dupl:: ops by name: register them first
    from dupl_tpu_torch.ops import attention, crf_cuda, par_cuda  # noqa: F401

    with open(path, "rb") as f:
        meta = _read_header(f, path)
        exported = torch.export.load(io.BytesIO(f.read()))
    return exported, meta


def export_from_config(cfg, weights_path: str, out_path: str, *,
                       batch_size: int = 8,
                       scales: Sequence[float] = _VOC_SCALES,
                       merge: str = "max",
                       branch: "int | str" = "ensemble",
                       crf: bool = True,
                       device="cuda",
                       bake_params: bool = True,
                       platform: Optional[str] = None) -> dict:
    """The path of ``tools/export_model_torch.py``: a weights ``.npz`` (the
    JAX package's key layout) in, a ``.duplsrv`` artifact out.  Returns the
    metadata dict."""
    from dupl_tpu_torch.models.convert import load_weights

    model = DualStudent(cfg.model)
    model.load_state_dict(load_weights(weights_path))
    exported, meta = export_serving(
        cfg, model, batch_size=batch_size, scales=scales, merge=merge,
        branch=branch, crf=crf, device=device, bake_params=bake_params,
        platform=platform)
    save_artifact(out_path, exported, meta)
    return meta
