"""Reading what the timed path computes, from outside the program.

``wrapped`` swaps a module's function for one that keeps its arguments and
its result while the entry is judged (the program looks its layer entries
up at call time).  ``product_rows`` hooks every block product of the
model (``models/vit.py:Linear``) and keeps rows of its input and output,
drawn from a seed; ``judge_products`` holds each product to the
reference's product of the same rows: the step-by-step check of the
encoder's matrix products on the program's own operands.
"""

from __future__ import annotations

import contextlib
from typing import List

import torch

from benchmark import compare

ROWS = 64      # rows of each product kept


@contextlib.contextmanager
def wrapped(module, name: str, keep):
    """``module.name`` replaced by a function that calls it and hands
    ``keep(args, kwargs, result)`` what it saw."""
    orig = getattr(module, name)

    def call(*args, **kwargs):
        out = orig(*args, **kwargs)
        keep(args, kwargs, out)
        return out

    setattr(module, name, call)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def product_rows(model, seed: int, got: List[tuple]):
    """Keep (module name, GELU taken on the input, input rows, output rows)
    of every block product the model runs, ``ROWS`` rows a call."""
    from dupl_tpu_torch.models.vit import Linear

    hooks = []
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear):
            continue

        def hook(mod, args, kwargs, out, name=name):
            x = args[0]
            x2 = x.reshape(-1, x.shape[-1])
            y2 = out.reshape(-1, out.shape[-1])
            gen = torch.Generator(device=x.device)
            gen.manual_seed(seed * 1000003 + len(got))
            idx = torch.randint(0, x2.shape[0], (ROWS,), generator=gen,
                                device=x.device)
            gelu = kwargs.get("gelu", args[1] if len(args) > 1 else None)
            got.append((name, gelu, x2[idx].float(), y2[idx].float()))

        hooks.append(mod.register_forward_hook(hook, with_kwargs=True))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def judge_products(products, ref, weights: dict, config: dict, prec=None):
    """Rows ``{"gemm_err": ...}``, one a product: the program's output rows
    against the reference's product of the same input rows."""
    rows = []
    for name, gelu, x, y in products:
        want = ref.product(weights, name, x.to(weights[f"{name}.weight"]
                                               .device), gelu, config, prec)
        rows.append({"gemm_err": compare.rel_err(y, want)})
    return rows
