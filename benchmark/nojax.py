"""The check that no JAX and no JAX package is loaded in the process.

A module counts by its top-level name, the part before the first dot,
compared whole: ``dupl_tpu_torch`` is not ``dupl_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dupl_tpu")


def found(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN))
