"""Logging / observability helpers (counterpart of
``dupl_tpu/utils/logging.py``; reference: utils/pyutils.py)."""

from __future__ import annotations

import datetime
import logging
import sys
from typing import Dict, Optional

import torch


def setup_logger(filename: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    """File + stream logger (reference: utils/pyutils.py:30-43)."""
    logger = logging.getLogger("dupl_tpu_torch")
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if filename:
        fh = logging.FileHandler(filename)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class AverageMeter:
    """Windowed scalar means, popped at log intervals
    (reference: utils/pyutils.py:59-87).

    Values are held as-is (0-d device tensors included) and only converted
    to Python floats at ``get``/``pop``: a per-step ``float()`` would make the
    host wait for the step it has just queued, once per metric, and the next
    step's launches could not be queued under it; deferring the sync to the
    log boundary lets steps queue back to back.  A window of device scalars
    is stacked and read with one copy."""

    def __init__(self):
        self._vals: Dict[str, list] = {}

    def add(self, values: Dict[str, float]) -> None:
        for k, v in values.items():
            self._vals.setdefault(k, []).append(v)

    def get(self, key: str) -> float:
        vals = self._vals.get(key)
        if not vals:
            return 0.0
        if isinstance(vals[0], torch.Tensor):
            return float(torch.stack([v.detach().float() for v in vals]).mean())
        return sum(float(v) for v in vals) / len(vals)

    def pop(self, key: str) -> float:
        val = self.get(key)
        self._vals.pop(key, None)
        return val


def cal_eta(start: datetime.datetime, cur_iter: int, total_iter: int):
    """Elapsed / remaining wall time strings (reference: utils/pyutils.py:46-56)."""
    now = datetime.datetime.now().replace(microsecond=0)
    elapsed = now - start.replace(microsecond=0)
    if cur_iter > 0:
        eta = datetime.timedelta(
            seconds=int(elapsed.total_seconds() * (total_iter - cur_iter) / cur_iter)
        )
    else:
        eta = datetime.timedelta(0)
    return str(elapsed), str(eta)
