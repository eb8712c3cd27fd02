"""The numbers that decide ``correct``: each a worst case over the images
the reference judged, each held to the cell's limit
(``benchmark/limits/<workload>.json``)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch


def rel_err(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """||prog - ref|| / ||ref|| over one image's tensor, in float64."""
    p, r = prog.double(), ref.double().to(prog.device)
    return float(torch.linalg.vector_norm(p - r)
                 / torch.clamp(torch.linalg.vector_norm(r), min=1e-30))


def mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of elements that differ."""
    return float((a.to(b.device).long() != b.long()).double().mean())


def judge(numbers: List[Dict[str, float]], limits: Dict[str, float]):
    """Per-image numbers -> (worst of each, the checks {name: {value,
    limit}}, correct, the images over a limit).  A number that is NaN, or
    missing, or has no limit, fails."""
    worst: Dict[str, float] = {}
    for row in numbers:
        for k, v in row.items():
            v, cur = float(v), worst.get(k)
            if cur is None or math.isnan(v) or (not math.isnan(cur)
                                                and v > cur):
                worst[k] = v
    checks = {}
    ok = bool(numbers)
    for name, limit in limits.items():
        value: Optional[float] = worst.get(name)
        passed = value is not None and not math.isnan(value) and \
            value <= limit
        ok = ok and passed
        checks[name] = {"value": value, "limit": limit}
    failed = sum(1 for row in numbers
                 if any(k in limits and not float(v) <= limits[k]
                        for k, v in row.items()))
    return worst, checks, ok, failed
