"""Full-state checkpointing (counterpart of ``dupl_tpu/engine/checkpoint.py``).

The reference saves only ``model.state_dict()`` to a rolling file with no
resume path: optimizer state, LR step and RNG are lost
(train_final_voc.py:512-519).  Here the full ``TrainState`` round-trips
through one ``torch.save`` file a step, ``step_<n>.pt``: the model's weights,
the optimizer's moments, per-parameter step counts and schedule step, the
host's step count and the state of the generator that draws the strong
view's ops.  A file is written under a temporary name and renamed, so a
killed save never leaves a half-written ``step_<n>.pt``.  The weights-only
export for the evaluation tools is a flat ``.npz`` in the JAX package's key
layout, which both packages load.

A file has one layout whatever the grid of ranks that wrote it: under FSDP
and tensor parallelism ``save_state`` gathers the full weights and moments
from every rank (over the data ranks, then over the model group; a
collective: every rank calls it) and rank 0 alone writes;
``restore_state`` loads the file into a plain or a sharded state, each rank
slicing its share.  So a run saved at one grid, sharded or not, resumes at
another.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from dupl_tpu_torch.engine.train import TrainState
from dupl_tpu_torch.models.convert import state_dict_to_jax
from dupl_tpu_torch.parallel import tensor_parallel
from dupl_tpu_torch.parallel.mesh import full_tensor, shard_like

_PREFIX, _SUFFIX = "step_", ".pt"


def _step_of(entry: str) -> Optional[int]:
    """``step_<n>.pt`` -> n; None for anything else, including the
    temporary names (``step_500.pt.tmp-<pid>``) an interrupted save leaves
    behind, which must never crash resume or pruning."""
    if not (entry.startswith(_PREFIX) and entry.endswith(_SUFFIX)):
        return None
    digits = entry[len(_PREFIX):-len(_SUFFIX)]
    return int(digits) if digits.isdigit() else None


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"{_PREFIX}{step}{_SUFFIX}")


def _writes() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def full_state(tensors, model: torch.nn.Module):
    """Tensors of ``model``'s parameters keyed by name (weights, gradients,
    moments) in the one-device layout: gathered over FSDP's data ranks,
    then over the model group (a collective when ``model`` is sharded:
    every rank calls it)."""
    return tensor_parallel.gather_model_state(
        {k: full_tensor(v) for k, v in tensors.items()},
        getattr(model, "tp", None))


def full_model_state(model: torch.nn.Module):
    """The model's state dict with every sharded tensor gathered (a
    collective under FSDP and tensor parallelism: every rank calls it)."""
    return full_state(model.state_dict(), model)


def _param_names(optimizer):
    """The names of the optimizer's parameters, in its state dict's
    index order."""
    return [n for g in optimizer.param_groups for n in g["names"]]


def full_optimizer_state(optimizer, model: torch.nn.Module):
    """The optimizer's state dict with the moments gathered, in the layout
    of one process (a collective under FSDP and tensor parallelism)."""
    sd = optimizer.state_dict()
    names = _param_names(optimizer)
    state = {}
    for i, st in sorted(sd["state"].items()):
        state[i] = dict(st, **{k: full_state({names[i]: st[k]}, model)[
            names[i]] for k in ("exp_avg", "exp_avg_sq")})
    sd["state"] = state
    return sd


def save_state(ckpt_dir: str, state: TrainState, *, keep: int = 3) -> str:
    """Save the full training state as ``ckpt_dir/step_<n>.pt``; retains the
    ``keep`` (>= 1) most recent steps.  Reads the weights and moments off
    the device: one wait for the work queued so far.  Every rank calls it;
    rank 0 writes."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    path = _path(ckpt_dir, int(state.step))
    payload = {"model": full_model_state(state.model),
               "optimizer": full_optimizer_state(state.optimizer,
                                                 state.model),
               "step": int(state.step),
               "rng": state.rng.get_state()}
    if not _writes():
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    _prune(ckpt_dir, keep)
    return path


def _prune(ckpt_dir: str, keep: int) -> None:
    entries = sorted((e for e in os.listdir(ckpt_dir)
                      if _step_of(e) is not None), key=_step_of)
    for e in entries[:-keep]:
        os.remove(os.path.join(ckpt_dir, e))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [s for e in os.listdir(ckpt_dir)
             if (s := _step_of(e)) is not None]
    return max(steps) if steps else None


def restore_state(ckpt_dir: str, state: TrainState,
                  step: Optional[int] = None) -> TrainState:
    """Load a saved step (default: the latest) into ``state`` in place (a
    freshly initialised state of the same recipe, on its device, plain or
    sharded by ``mesh.shard_state``: each rank takes its shares of the
    file's tensors) and return it."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    device = next(state.model.parameters()).device
    payload = torch.load(_path(ckpt_dir, step), map_location=device,
                         weights_only=True)
    tp = getattr(state.model, "tp", None)

    def share(name, ref, full):
        return shard_like(ref, tensor_parallel.shard_like_model(name, full,
                                                                tp))

    own = state.model.state_dict()
    state.model.load_state_dict({k: share(k, own[k], v) if k in own else v
                                 for k, v in payload["model"].items()})
    opt = payload["optimizer"]
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    names = _param_names(state.optimizer)
    for i, st in opt["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            st[k] = share(names[i], params[i], st[k])
    state.optimizer.load_state_dict(opt)
    state.step = int(payload["step"])
    state.rng.set_state(payload["rng"].cpu())
    return state


def export_weights(path: str, state_dict) -> None:
    """Weights-only export of a ``DualStudent`` state dict (the artifact the
    evaluation tools load) as a flat ``.npz`` keyed by flax parameter path,
    every leaf branch-stacked: what ``models.convert.load_weights`` and the
    JAX package's ``checkpoint.load_weights`` read.  Rank 0's to call, with
    :func:`full_model_state`."""
    flat = state_dict_to_jax(state_dict)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
