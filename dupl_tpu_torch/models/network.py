"""Student and dual-student models (counterpart of
``dupl_tpu/models/network.py``; reference: model/model_dupl.py).

The reference JAX package stacks the two students' parameters on a leading
branch axis and vmaps one module over it.  Here ``DualStudent`` holds two
``Student`` submodules, ``branch1`` and ``branch2``, named as the reference
``siamese_network.state_dict()`` names them, and stacks their outputs on a
leading branch axis so callers see the JAX package's shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from dupl_tpu_torch.models.decoder import LargeFOV
from dupl_tpu_torch.models.vit import VIT_CONFIGS, ViT


class StudentOut(NamedTuple):
    cls: torch.Tensor       # (B, C_fg) image-level logits
    seg: torch.Tensor       # (B, h, w, C) patch-res segmentation logits
    fmap: torch.Tensor      # (B, h, w, D) post-norm patch features
    cls_aux: torch.Tensor   # (B, C_fg) aux-layer image-level logits


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


class Student(nn.Module):
    """ViT encoder, LargeFOV decoder on the last-layer patch tokens, and
    bias-free 1x1-conv classifiers on the max-pooled main and aux tokens."""

    def __init__(self, cfg):
        super().__init__()
        spec = VIT_CONFIGS[cfg.backbone]
        cd = _dtype(cfg.compute_dtype)
        self.patch_size = cfg.patch_size
        self.encoder = ViT(spec, aux_layer=cfg.aux_layer, compute_dtype=cd,
                           gelu_approximate=cfg.gelu_approximate,
                           quant=cfg.quantized_inference, remat=cfg.remat,
                           stream_dtype=_dtype(cfg.stream_dtype))
        self.decoder = LargeFOV(spec.embed_dim, cfg.num_classes,
                                cfg.decoder_dim, cfg.decoder_dilation,
                                compute_dtype=cd)
        self.classifier = nn.Conv2d(spec.embed_dim, cfg.num_fg, 1, bias=False)
        self.aux_classifier = nn.Conv2d(spec.embed_dim, cfg.num_fg, 1,
                                        bias=False)

    @staticmethod
    def _dense(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        """The 1x1 conv over the last axis of ``x``, computed in the
        promoted dtype of features and weight (flax ``Dense`` with
        ``dtype=None``)."""
        w = conv.weight[:, :, 0, 0]
        dt = torch.promote_types(x.dtype, w.dtype)
        return torch.matmul(x.to(dt), w.to(dt).t())

    def _features(self, x: torch.Tensor,
                  stream_dtype: Optional[torch.dtype] = None):
        """x: (B, H, W, 3) -> (fmap, aux), each (B, h, w, D)."""
        b, hh, ww, _ = x.shape
        h, w = hh // self.patch_size, ww // self.patch_size
        _, tokens, aux_tokens = self.encoder(x, stream_dtype=stream_dtype)
        d = tokens.shape[-1]
        return tokens.reshape(b, h, w, d), aux_tokens.reshape(b, h, w, d)

    def _heads(self, fmap: torch.Tensor, aux: torch.Tensor) -> StudentOut:
        """Decoder and global-max-pooled classifiers."""
        return StudentOut(self._dense(self.classifier, fmap.amax(dim=(1, 2))),
                          self.decoder(fmap), fmap,
                          self._dense(self.aux_classifier, aux.amax(dim=(1, 2))))

    def forward(self, x: torch.Tensor) -> StudentOut:
        """x: (B, H, W, 3) ImageNet-normalised -> StudentOut."""
        return self._heads(*self._features(x))

    def cam_only(self, x: torch.Tensor,
                 stream_dtype: Optional[torch.dtype] = None):
        """CAM = the classifiers applied per pixel to the main and aux
        feature maps, detached (model_dupl.py:81-84).  x: (B, H, W, 3) ->
        (cam, cam_aux), each (B, h, w, C_fg) at patch resolution.
        ``stream_dtype`` runs this pass, with the same parameters, on
        another residual-stream dtype (the trainer's no-grad CAM passes)."""
        fmap, aux = self._features(x, stream_dtype)
        return (self._dense(self.classifier, fmap).detach(),
                self._dense(self.aux_classifier, aux).detach())

    def forward_with_cams(self, x: torch.Tensor):
        """One encoder pass -> (StudentOut, cam, cam_aux): the same values as
        ``forward`` and ``cam_only`` run separately."""
        fmap, aux = self._features(x)
        return (self._heads(fmap, aux),
                self._dense(self.classifier, fmap).detach(),
                self._dense(self.aux_classifier, aux).detach())


class DualStudent(nn.Module):
    """Two independent students (reference: ``siamese_network``,
    model_dupl.py:109-214)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.branch1 = Student(cfg)
        self.branch2 = Student(cfg)

    def student(self, i: int) -> Student:
        """Branch ``i`` in {0, 1} (the JAX package's branch-axis index)."""
        return (self.branch1, self.branch2)[i]

    def forward(self, x: torch.Tensor) -> StudentOut:
        """Both students on the same batch; every output gains a leading
        branch axis of 2."""
        a, b = self.branch1(x), self.branch2(x)
        return StudentOut(*(torch.stack([u, v]) for u, v in zip(a, b)))

    def cam_only(self, x: torch.Tensor):
        """Both students' (cam, cam_aux), each (2, B, h, w, C_fg)."""
        a, b = self.branch1.cam_only(x), self.branch2.cam_only(x)
        return tuple(torch.stack([u, v]) for u, v in zip(a, b))

    def forward_with_cams(self, x: torch.Tensor):
        """Both students' (StudentOut, cam, cam_aux), branch-stacked."""
        (oa, *ca), (ob, *cb) = (self.branch1.forward_with_cams(x),
                                self.branch2.forward_with_cams(x))
        out = StudentOut(*(torch.stack([u, v]) for u, v in zip(oa, ob)))
        return (out, *(torch.stack([u, v]) for u, v in zip(ca, cb)))
