"""PolyWarmupAdamW as a ``torch.optim.Optimizer`` (counterpart of
``dupl_tpu/engine/optimizer.py``; reference: utils/optimizer.py:38-68,
utils/train_helper.py:21-53, model/model_dupl.py:119-154).

* AdamW (betas 0.9 / 0.999, eps 1e-8, decoupled weight decay 1e-2) with the
  decay scaled by the group LR: ``p -= lr_g * (m_hat / (sqrt(v_hat) + eps)
  + wd * p)``.
* Three groups: ``base`` (the encoder, its norms included) at the base LR,
  ``head`` (both classifiers) and ``decoder`` at ``head_lr_mult`` times it.
* LR schedule: linear warm-up from ``lr * warmup_ratio`` over
  ``warmup_iters`` steps, then poly decay; the schedule step advances on
  every call of :meth:`step`.  The LR is a Python float computed on the
  host from the host's step count.
* ``pos_embed`` is frozen (``requires_grad_(False)``) and in no group.
* A parameter whose ``.grad`` is None is skipped entirely: no decay, no
  moments, no count.  In the warm-up phase the decoder is outside the graph,
  so its Adam step counts (the bias correction) start at the first seg-phase
  step, as in the reference, whose AdamW skips gradient-less parameters.

Updates run through ``torch._foreach`` ops, in place on the parameters and
the moments.  Under FSDP (``parallel/mesh.py``) parameters, gradients and
moments are DTensors of this rank's shards, and the same calls update the
shards elementwise, so the sharded update is the unsharded one's, bit for
bit, on this rank's elements.
"""

from __future__ import annotations

import collections
from typing import Dict, List

import torch

from dupl_tpu_torch.ops.schedule import poly_warmup_schedule

CLS_HEAD_MODULES = ("classifier", "aux_classifier")
GROUPS = ("base", "head", "decoder")


def group_of(name: str) -> str:
    """LR group of a ``DualStudent`` parameter name."""
    parts = name.split(".")
    if "pos_embed" in parts:
        return "frozen"
    if "decoder" in parts:
        return "decoder"
    if any(p in CLS_HEAD_MODULES for p in parts):
        return "head"
    return "base"


def current_lr(cfg, step: int, max_iters: int) -> float:
    return poly_warmup_schedule(
        step, base_lr=cfg.lr, warmup_iters=cfg.warmup_iters,
        warmup_ratio=cfg.warmup_ratio, max_iters=max_iters, power=cfg.power)


class PolyWarmupAdamW(torch.optim.Optimizer):
    """See the module docstring.  ``cfg`` is an ``OptimConfig``;
    ``global_step`` is the schedule step (the reference's
    ``optimizer.global_step``)."""

    def __init__(self, model: torch.nn.Module, cfg, max_iters: int):
        named: Dict[str, List] = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            group = group_of(name)
            if group == "frozen":
                p.requires_grad_(False)
            else:
                named[group].append((name, p))
        mults = {"base": 1.0, "head": cfg.head_lr_mult,
                 "decoder": cfg.head_lr_mult}
        groups = [{"name": g, "lr_mult": mults[g],
                   "params": [p for _, p in named[g]],
                   "names": [n for n, _ in named[g]]} for g in GROUPS]
        super().__init__(groups, dict(betas=tuple(cfg.betas), eps=cfg.eps,
                                      weight_decay=cfg.weight_decay))
        self.cfg = cfg
        self.max_iters = max_iters
        self.global_step = 0

    @property
    def lr(self) -> float:
        """The base LR of the next :meth:`step`."""
        return current_lr(self.cfg, self.global_step, self.max_iters)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("PolyWarmupAdamW.step takes no closure")
        lr = self.lr
        for group in self.param_groups:
            b1, b2 = group["betas"]
            # parameters that share an Adam step count share one foreach call
            buckets = collections.defaultdict(list)
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                buckets[st["step"]].append(p)
            for t, ps in buckets.items():
                gs = [p.grad for p in ps]
                ms = [self.state[p]["exp_avg"] for p in ps]
                vs = [self.state[p]["exp_avg_sq"] for p in ps]
                torch._foreach_mul_(ms, b1)
                torch._foreach_add_(ms, gs, alpha=1 - b1)
                torch._foreach_mul_(vs, b2)
                torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
                denom = torch._foreach_div(vs, 1 - b2 ** t)
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, group["eps"])
                upd = torch._foreach_div(ms, 1 - b1 ** t)
                torch._foreach_div_(upd, denom)
                torch._foreach_add_(upd, ps, alpha=group["weight_decay"])
                torch._foreach_add_(ps, upd, alpha=-lr * group["lr_mult"])
        self.global_step += 1

    def state_dict(self):
        sd = super().state_dict()
        sd["global_step"] = self.global_step
        return sd

    def load_state_dict(self, state_dict):
        sd = dict(state_dict)
        self.global_step = int(sd.pop("global_step"))
        super().load_state_dict(sd)
