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
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dupl_tpu_torch.engine.train import TrainState
from dupl_tpu_torch.models.convert import state_dict_to_jax

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


def save_state(ckpt_dir: str, state: TrainState, *, keep: int = 3) -> str:
    """Save the full training state as ``ckpt_dir/step_<n>.pt``; retains the
    ``keep`` (>= 1) most recent steps.  Reads the weights and moments off
    the device: one wait for the work queued so far."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, int(state.step))
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": int(state.step),
                "rng": state.rng.get_state()}, tmp)
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
    freshly initialised state of the same recipe, on its device) and return
    it."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    device = next(state.model.parameters()).device
    payload = torch.load(_path(ckpt_dir, step), map_location=device,
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.rng.set_state(payload["rng"].cpu())
    return state


def export_weights(path: str, state_dict) -> None:
    """Weights-only export of a ``DualStudent`` state dict (the artifact the
    evaluation tools load) as a flat ``.npz`` keyed by flax parameter path,
    every leaf branch-stacked: what ``models.convert.load_weights`` and the
    JAX package's ``checkpoint.load_weights`` read."""
    flat = state_dict_to_jax(state_dict)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
