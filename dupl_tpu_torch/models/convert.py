"""Weight bridge between the JAX package and the port, and seeded
initialisation.

``dupl_tpu.engine.checkpoint.export_weights`` writes a flat ``.npz`` keyed
by flax parameter path, every leaf branch-stacked on a leading axis of 2
(``params/encoder/block0/attn/qkv/kernel`` -> (2, D, 3D)).
:func:`state_dict_from_jax` maps that onto ``DualStudent.state_dict()``
names (``branch1.encoder.blocks.0.attn.qkv.weight`` -> (3D, D)), and
:func:`state_dict_to_jax` maps it back: Dense
kernels are transposed, conv kernels go HWIO -> OIHW (a decoder conv's
bias, ``ASPP``'s, as it is), the Dense classifiers
become (C-1, D, 1, 1) 1x1 convs, LayerNorm ``scale`` becomes ``weight``.

The mapping is a pure relayout, so it carries any tree shaped like the
parameters: a JAX gradient tree, or the optimizer's first and second
moments (:func:`optimizer_state_from_jax`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

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
    if parts[0] == "decoder" and parts[-1] == "bias":    # ASPP's convs
        return f"decoder.{parts[1]}.bias", leaf
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


def _jax_entry(name: str, leaf: np.ndarray):
    """One branch's ``Student`` parameter name and array -> (flax path after
    ``params/``, array): the inverse of :func:`_student_entry`."""
    parts = name.split(".")
    last = parts[-1]
    if parts[0] == "encoder":
        if parts[1] in ("cls_token", "pos_embed"):
            return f"encoder/{parts[1]}", leaf
        if parts[1] == "patch_embed":
            if last == "weight":
                return "encoder/patch_embed/kernel", leaf.transpose(2, 3, 1, 0)
            return "encoder/patch_embed/bias", leaf
        if parts[1] == "norm":
            return f"encoder/norm/{'scale' if last == 'weight' else 'bias'}", leaf
        if parts[1] == "blocks":
            sub = "/".join(parts[3:-1])
            prefix = f"encoder/block{int(parts[2])}/{sub}"
            if sub in ("norm1", "norm2"):
                return f"{prefix}/{'scale' if last == 'weight' else 'bias'}", leaf
            if sub in _DENSE:
                return (f"{prefix}/kernel", leaf.T) if last == "weight" else (
                    f"{prefix}/bias", leaf)
    if parts[0] == "decoder" and last == "weight":
        return f"decoder/{parts[1]}/kernel", leaf.transpose(2, 3, 1, 0)
    if parts[0] == "decoder" and last == "bias":
        return f"decoder/{parts[1]}/bias", leaf
    if parts[0] in ("classifier", "aux_classifier") and last == "weight":
        return f"{parts[0]}/kernel", leaf[:, :, 0, 0].T
    raise KeyError(f"unmapped DualStudent parameter name: {name}")


def state_dict_to_jax(sd: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``DualStudent`` state dict -> flat branch-stacked JAX weights, keyed
    and laid out as ``dupl_tpu.engine.checkpoint.export_weights`` writes
    them: the inverse of :func:`state_dict_from_jax`."""
    flat: Dict[str, np.ndarray] = {}
    for name, t in sd.items():
        if not name.startswith("branch1."):
            if not name.startswith("branch2."):
                raise KeyError(f"not a DualStudent parameter name: {name}")
            continue
        rest = name[len("branch1."):]
        leaves = []
        for i in (1, 2):
            arr = sd[f"branch{i}.{rest}"].detach().float().cpu().numpy()
            key, leaf = _jax_entry(rest, arr)
            leaves.append(leaf)
        flat[f"params/{key}"] = np.ascontiguousarray(np.stack(leaves))
    return flat


def optimizer_state_from_jax(optimizer, step: int,
                             count: Mapping[str, Any],
                             mu: Mapping[str, np.ndarray],
                             nu: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """A JAX ``PhasedAdamWState`` -> a state dict for the port's
    ``PolyWarmupAdamW`` (``optimizer.load_state_dict`` takes it), so a JAX
    train state at step k continues in the port.  ``step`` is the schedule
    step; ``count``, ``mu`` and ``nu`` are the state's three trees flattened
    to flax paths as the weights are (``params/...``): per-leaf Adam step
    counts, and branch-stacked first and second moments."""
    mu_sd, nu_sd = state_dict_from_jax(mu), state_dict_from_jax(nu)
    counts = {}
    for key, c in count.items():
        for i in range(2):
            name, _ = _student_entry(key[len("params/"):],
                                     np.asarray(mu[key])[i])
            counts[f"branch{i + 1}.{name}"] = int(c)
    sd = optimizer.state_dict()
    state, index = {}, 0
    for group in sd["param_groups"]:
        for name in group["names"]:
            state[index] = {"step": counts[name], "exp_avg": mu_sd[name],
                            "exp_avg_sq": nu_sd[name]}
            index += 1
    sd["state"] = state
    sd["global_step"] = int(step)
    return sd


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """Read a weights ``.npz`` written by the JAX package's
    ``checkpoint.export_weights`` as a ``DualStudent`` state dict."""
    with np.load(path) as data:
        return state_dict_from_jax({k: data[k] for k in data.files})


def load_model(cfg, path: str, device) -> torch.nn.Module:
    """A ``DualStudent`` of ``cfg.model`` with the weights of a ``.npz``
    file (:func:`load_weights`), in eval mode on ``device``."""
    from dupl_tpu_torch.models.network import DualStudent

    model = DualStudent(cfg.model)
    model.load_state_dict(load_weights(path))
    return model.to(device).eval()


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
