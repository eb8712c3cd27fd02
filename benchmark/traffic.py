"""The one generator of the benchmark's traffic: a traffic file's
parameters and a seed in, a pool of input batches out.

The images come from the scene generator that the traffic file names,
``benchmark/traffic/<scene>.py``: its ``pool(traffic, r)`` returns the
pool's batches (dicts of numpy arrays, the entry's inputs) drawn from the
numpy generator ``r``.  A mix over an existing scene is a new data file;
a new kind of scene is a new generator file; neither edits a file here.

Traffic parameters (a JSON object): ``entry`` (the program entry that the
mix drives, ``benchmark/entries/<entry>.py``), ``scene`` (the generator),
``batch``, ``pool`` (distinct batches, cycled through the window),
``check_batches`` and ``check_images`` (how many of the pool's batches,
and of their images, the reference judges, drawn from the seed; 0 or
absent: all), the scene's own parameters and the entry's own keys.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

SEED_MASK = (1 << 63) - 1
ROOT = Path(__file__).resolve().parents[1]


def rng(seed: int, stream: int) -> np.random.Generator:
    """The generator of one use (``stream``) of ``seed``: any whole
    number, negative or past 64 bits included."""
    return np.random.default_rng([int(seed) & SEED_MASK, stream])


def generate(traffic: dict, seed: int,
             root: Optional[Path] = None) -> List[Dict[str, np.ndarray]]:
    """``traffic['pool']`` batches from the scene generator of the
    benchmark under ``root`` (this checkout's by default)."""
    from benchmark import spec

    path = (root or ROOT) / "benchmark" / "traffic" / f"{traffic['scene']}.py"
    return spec.load_module(path).pool(traffic, rng(seed, 0))


def check_sample(traffic: dict, seed: int) -> List[tuple]:
    """The (pool batch, image) pairs the reference judges, in order:
    ``check_images`` images drawn from the seed among those of
    ``check_batches`` pool batches drawn from the seed (0 or absent: every
    batch, every image).  The check calls the entry once more on each
    batch it judges, so fewer batches keep the check shorter than the
    window."""
    b, p = traffic["batch"], traffic["pool"]
    r = rng(seed, 1)
    batches = list(range(p))
    k = traffic.get("check_batches") or p
    if k < p:
        batches = sorted(int(i) for i in r.choice(p, size=k, replace=False))
    pairs = [(i, j) for i in batches for j in range(b)]
    n = traffic.get("check_images") or len(pairs)
    if n >= len(pairs):
        return pairs
    pick = r.choice(len(pairs), size=n, replace=False)
    return [pairs[k] for k in sorted(pick)]
