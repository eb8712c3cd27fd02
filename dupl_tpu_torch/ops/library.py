"""The ``dupl`` operator namespace: every kernel of the main path is a
registered ``torch.library`` op, so that ``torch.export`` records it by name
in a sealed program (``engine/export.py``).

Each op has a CUDA kernel (its launcher: checks, the ``ctypes`` call into the
built library, the status check and the launch count), a CPU kernel (its
plain twin) and a fake kernel (the outputs' shapes, types and strides, for
tracing).  An op is not differentiable by itself: its autograd key falls
through to the device kernel, whose outputs never require grad (the CPU
twin runs under ``no_grad``, as the CUDA kernel computes outside autograd).
The two attention forwards get their backward from a
``torch.autograd.Function`` around the forward and backward ops
(``ops/attention.py``).  The ops are registered with ``Library.define`` /
``impl`` and no Python autograd kernel: a call costs one Python kernel over
the launcher's own host time (a ``torch.library.custom_op``, or a Python
autograd kernel, adds more).
"""

from __future__ import annotations

from typing import Callable

import torch

LIB = torch.library.Library("dupl", "FRAGMENT")


def register(schema: str, *, cuda: Callable, cpu: Callable,
             fake: Callable) -> torch._ops.OpOverload:
    """Define ``dupl::<schema>`` with its CUDA, CPU and fake kernels and
    return its overload."""
    name = schema.split("(", 1)[0]
    LIB.define(schema)
    LIB.impl(name, cuda, "CUDA")
    LIB.impl(name, torch.no_grad()(cpu), "CPU")
    LIB.impl(name, torch.library.fallthrough_kernel, "Autograd")
    torch.library.register_fake(f"dupl::{name}", fake, lib=LIB)
    return getattr(torch.ops.dupl, name).default
