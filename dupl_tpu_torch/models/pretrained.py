"""DeiT / ViT and reference-trained checkpoints for the port's models
(counterpart of ``dupl_tpu/models/pretrained.py``).

The port's parameter names are timm's (``models/vit.py``), the patch
embedding is an OIHW ``nn.Conv2d`` and the classifiers are bias-free 1x1
convs, so a torch checkpoint needs its keys normalised and nothing
transposed.  Each loader accepts and refuses the files the JAX package's
does: it reads exactly the keys ``convert_vit_state_dict`` reads (the first
``depth`` blocks; a missing one raises ``KeyError``), ignores the rest, and
casts to float32.

    normalize_vit_state_dict   prefixes, classifier heads, 2-D patch kernel
    load_deit_checkpoint       a DeiT / timm ``.pth`` -> encoder tensors
    install_pretrained_encoder the same encoder into both students
    load_reference_checkpoint  a trained ``siamese_network`` ``.pth`` ->
                               ``DualStudent`` state dict
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight",
               "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
               "norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias",
               "mlp.fc2.weight", "mlp.fc2.bias")


def vit_keys(depth: int) -> List[str]:
    """The timm names of a ``depth``-block encoder: what the JAX converter
    maps, and what ``models.vit.ViT.state_dict()`` holds."""
    keys = ["cls_token", "pos_embed", "patch_embed.proj.weight",
            "patch_embed.proj.bias"]
    for i in range(depth):
        keys += [f"blocks.{i}.{k}" for k in _BLOCK_KEYS]
    return keys + ["norm.weight", "norm.bias"]


def vit_state_dict(state: Mapping[str, torch.Tensor],
                   depth: int) -> Dict[str, torch.Tensor]:
    """The encoder tensors of a timm/DeiT state dict, in float32: blocks
    ``0..depth-1`` and the embeddings and final norm; other keys (deeper
    blocks, heads) are ignored, a missing one raises ``KeyError``."""
    return {k: torch.as_tensor(state[k]).float() for k in vit_keys(depth)}


def normalize_vit_state_dict(
        state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The state-dict layouts the reference accepts, in DeiT naming:
    ``module.`` / ``backbone.`` / ``encoder.`` prefixes stripped; ``head.*``,
    ``head_dist.*``, ``pre_logits.*`` and ``dist_token`` dropped; a 2-D
    ``patch_embed.proj.weight`` (patchify + linear, (D, 3 P P)) reshaped to
    the conv's OIHW."""
    drop = ("head.", "head_dist.", "pre_logits.", "dist_token")
    out: Dict[str, torch.Tensor] = {}
    for k, v in state.items():
        for pfx in ("module.", "backbone.", "encoder."):
            if k.startswith(pfx):
                k = k[len(pfx):]
        if k.startswith(drop):
            continue
        v = torch.as_tensor(v)
        if k == "patch_embed.proj.weight" and v.dim() == 2:
            ps = int(round((v.shape[1] // 3) ** 0.5))
            v = v.reshape(v.shape[0], 3, ps, ps)
        out[k] = v
    return out


def load_deit_checkpoint(path: str, depth: int = 12) -> Dict[str, torch.Tensor]:
    """A DeiT/ViT ``.pth`` (``{"model": ...}`` as DeiT releases it,
    ``{"state_dict": ...}`` as timm / mmcls export it, or a bare state dict)
    -> the encoder's tensors in float32, keyed as ``ViT.state_dict()``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = (ckpt.get("model", ckpt.get("state_dict", ckpt))
             if isinstance(ckpt, dict) else ckpt)
    return vit_state_dict(normalize_vit_state_dict(state), depth)


def infer_vit_depth(state: Mapping[str, torch.Tensor]) -> int:
    """Number of transformer blocks in a flat state dict."""
    idx = [int(k.split(".")[1]) for k in state
           if k.startswith("blocks.") and k.split(".")[1].isdigit()]
    if not idx:
        raise ValueError("no 'blocks.N.*' keys: not a ViT state dict")
    return max(idx) + 1


@torch.no_grad()
def install_pretrained_encoder(model: torch.nn.Module,
                               encoder: Mapping[str, torch.Tensor]
                               ) -> torch.nn.Module:
    """Copy encoder tensors into both students of a ``DualStudent``, in
    place: the reference loads one DeiT checkpoint into both branches.  The
    decoder and the classifiers are left as they are.  A name the encoder
    does not have raises ``KeyError``, a tensor of another shape
    ``ValueError``."""
    for student in (model.branch1, model.branch2):
        params = dict(student.encoder.named_parameters())
        for name, t in encoder.items():
            p = params[name]
            if p.shape != t.shape:
                raise ValueError(f"pretrained {name}: shape {tuple(t.shape)}, "
                                 f"the encoder's {tuple(p.shape)}")
            p.copy_(t)
    return model


def student_state_dict(state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A flat reference ``network`` state dict (encoder, LargeFOV decoder,
    two bias-free 1x1-conv classifiers; model/model_dupl.py:9-106) -> a
    ``Student`` state dict in float32, the encoder depth read off its keys."""
    enc = {k[len("encoder."):]: v for k, v in state.items()
           if k.startswith("encoder.")}
    out = {f"encoder.{k}": v for k, v in
           vit_state_dict(enc, infer_vit_depth(enc)).items()}
    for k in ("decoder.conv6.weight", "decoder.conv7.weight",
              "decoder.conv8.weight", "classifier.weight",
              "aux_classifier.weight"):
        out[k] = torch.as_tensor(state[k]).float()
    return out


def siamese_state_dict(state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A flat reference ``siamese_network`` state dict (``module.``-prefixed
    when saved from DDP) -> a ``DualStudent`` state dict.  ``module.`` is
    removed as the reference's evaluation removes it
    (tools/eval_seg_voc.py:172-177); a dict without ``branch1.*`` or
    ``branch2.*`` keys raises ``ValueError``."""
    state = {k.replace("module.", ""): v for k, v in state.items()}
    out: Dict[str, torch.Tensor] = {}
    for b in ("branch1", "branch2"):
        sub = {k[len(b) + 1:]: v for k, v in state.items()
               if k.startswith(b + ".")}
        if not sub:
            raise ValueError(
                f"no '{b}.*' keys — not a siamese_network checkpoint "
                f"(got e.g. {sorted(state)[:3]})")
        out.update({f"{b}.{k}": v for k, v in student_state_dict(sub).items()})
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference-trained siamese ``.pth`` (the published ``dupl_voc.pth``
    / ``dupl_coco.pth``, ``torch.save(model.state_dict())``) -> a
    ``DualStudent`` state dict for ``load_state_dict``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and not any("." in k for k in ckpt):
        ckpt = ckpt.get("model", ckpt.get("state_dict", ckpt))
    return siamese_state_dict(ckpt)
