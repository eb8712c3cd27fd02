"""Weight bridge between the JAX package and the port, and seeded
initialisation.

``dupl_tpu.engine.checkpoint.export_weights`` writes a flat ``.npz`` keyed
by flax parameter path, every leaf branch-stacked on a leading axis of 2
(``params/encoder/block0/attn/qkv/kernel`` -> (2, D, 3D)).
:func:`state_dict_from_jax` maps that onto ``DualStudent.state_dict()``
names (``branch1.encoder.blocks.0.attn.qkv.weight`` -> (3D, D)): Dense
kernels are transposed, conv kernels go HWIO -> OIHW, the Dense classifiers
become (C-1, D, 1, 1) 1x1 convs, LayerNorm ``scale`` becomes ``weight``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_DENSE = ("attn/qkv", "attn/proj", "mlp/fc1", "mlp/fc2")


def _student_entry(path: str, leaf: np.ndarray):
    """One branch's flax path (after ``params/``) and leaf -> (torch name,
    array)."""
    parts = path.split("/")
    if parts[0] == "encoder":
        rest = parts[1:]
        if rest[0] in ("cls_token", "pos_embed"):
            return f"encoder.{rest[0]}", leaf
        if rest[0] == "patch_embed":
            if rest[1] == "kernel":
                return "encoder.patch_embed.proj.weight", leaf.transpose(3, 2, 0, 1)
            return "encoder.patch_embed.proj.bias", leaf
        if rest[0] == "norm":
            return f"encoder.norm.{'weight' if rest[1] == 'scale' else 'bias'}", leaf
        if rest[0].startswith("block"):
            i = int(rest[0][len("block"):])
            sub = "/".join(rest[1:-1])
            name = rest[-1]
            prefix = f"encoder.blocks.{i}.{sub.replace('/', '.')}"
            if sub in ("norm1", "norm2"):
                return f"{prefix}.{'weight' if name == 'scale' else 'bias'}", leaf
            if sub in _DENSE:
                return (f"{prefix}.weight", leaf.T) if name == "kernel" else (
                    f"{prefix}.bias", leaf)
    if parts[0] == "decoder" and parts[-1] == "kernel":
        return f"decoder.{parts[1]}.weight", leaf.transpose(3, 2, 0, 1)
    if parts[0] in ("classifier", "aux_classifier") and parts[-1] == "kernel":
        return f"{parts[0]}.weight", leaf.T[:, :, None, None]
    raise KeyError(f"unmapped JAX parameter path: params/{path}")


def state_dict_from_jax(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flat branch-stacked JAX weights -> ``DualStudent`` state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        if not key.startswith("params/"):
            raise KeyError(f"not a flax parameter path: {key}")
        arr = np.asarray(arr, np.float32)
        if arr.shape[0] != 2:
            raise ValueError(f"{key}: want a leading branch axis of 2, "
                             f"got shape {arr.shape}")
        for i in range(2):
            name, leaf = _student_entry(key[len("params/"):], arr[i])
            sd[f"branch{i + 1}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(leaf))
    return sd


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """Read a weights ``.npz`` written by the JAX package's
    ``checkpoint.export_weights`` as a ``DualStudent`` state dict."""
    with np.load(path) as data:
        return state_dict_from_jax({k: data[k] for k in data.files})


def _trunc_normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    torch.nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                generator=gen)


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal at two standard deviations,
    rescaled so the variance is 1 / fan_in."""
    _trunc_normal_(w, (1.0 / fan_in) ** 0.5 / 0.87962566103423978, gen)


@torch.no_grad()
def init_weights(model: torch.nn.Module, gen: torch.Generator) -> None:
    """Initialise a ``Student``/``DualStudent`` in place with the init
    families the JAX package uses (flax defaults): lecun-normal Dense and
    conv kernels, zero biases, unit LayerNorm scales, truncated-normal(0.02)
    class token and position table.  The draws differ from jax's for the
    same seed; the families and scales are the same."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith(("cls_token", "pos_embed")):
            _trunc_normal_(p, 0.02, gen)
        elif ".norm" in name:   # norm, norm1, norm2
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
        elif p.dim() == 4:   # conv OIHW: fan_in = I * kh * kw
            _lecun_normal_(p, p.shape[1] * p.shape[2] * p.shape[3], gen)
        else:                # Linear (out, in)
            _lecun_normal_(p, p.shape[1], gen)
