"""ctypes bridge to the native permutohedral DenseCRF (counterpart of
``dupl_tpu/ops/crf_native.py``; sources in ``native/densecrf``: C++
mean-field with Gaussian + bilateral kernels, the algorithm the reference
uses via pydensecrf, utils/dcrf.py:42-68).

The shared library is built at first use with g++ into
``build/dupl_tpu_torch/`` at the checkout root, keyed by a hash of the
sources and flags; nothing is written beside the sources.  The ctypes call
releases the GIL, so a thread pool gives the same multi-core fan-out as the
reference's joblib CRF fan-out (tools/eval_seg_voc.py:145-147) without
process overhead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _ROOT / "native" / "densecrf"
BUILD_DIR = _ROOT / "build" / "dupl_tpu_torch"
_SOURCES = ("densecrf.cc", "permutohedral.cc")
_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """Compile ``native/densecrf`` if no library of the same source hash is
    built yet; returns the library path.  A failed build raises."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in sorted(NATIVE_DIR.glob("*.h")) + [NATIVE_DIR / s for s in _SOURCES]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    out = BUILD_DIR / f"densecrf-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), *_SOURCES]
    proc = subprocess.run(cmd, cwd=NATIVE_DIR, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {NATIVE_DIR} (exit "
                           f"{proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.dense_crf_inference.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.dense_crf_inference.restype = None
            _lib = lib
        return _lib


class DenseCRF:
    """Drop-in equivalent of the reference's ``DenseCRF`` callable
    (utils/dcrf.py:42-68): ``crf(image_hwc_uint8, probs_chw) -> marginals_chw``."""

    def __init__(self, iter_max=10, pos_w=1.0, pos_xy_std=1.0,
                 bi_w=4.0, bi_xy_std=121.0, bi_rgb_std=5.0):
        self.iter_max = iter_max
        self.pos_w = pos_w
        self.pos_xy_std = pos_xy_std
        self.bi_w = bi_w
        self.bi_xy_std = bi_xy_std
        self.bi_rgb_std = bi_rgb_std

    @classmethod
    def from_config(cls, cfg) -> "DenseCRF":
        """From a ``CrfConfig``."""
        return cls(cfg.iter_max, cfg.pos_w, cfg.pos_xy_std,
                   cfg.bi_w, cfg.bi_xy_std, cfg.bi_rgb_std)

    def __call__(self, image: np.ndarray, probmap: np.ndarray) -> np.ndarray:
        c, h, w = probmap.shape
        if image.shape != (h, w, 3):
            raise ValueError(f"DenseCRF: image {image.shape} does not match "
                             f"probabilities {probmap.shape}")
        probs = np.ascontiguousarray(probmap, np.float32)
        img = np.ascontiguousarray(image, np.uint8)
        out = np.empty_like(probs)
        _get_lib().dense_crf_inference(
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            h, w, c, self.iter_max,
            self.pos_w, self.pos_xy_std,
            self.bi_w, self.bi_xy_std, self.bi_rgb_std,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out


def default_workers() -> int:
    """Four fifths of the cores, at least one (``os.cpu_count`` may be
    None)."""
    return max(1, int((os.cpu_count() or 1) * 0.8))


def crf_batch(images: Sequence[np.ndarray], probmaps: Sequence[np.ndarray],
              cfg, workers: Optional[int] = None):
    """Threaded fan-out over images (GIL released inside the native call)."""
    crf = DenseCRF.from_config(cfg)
    with ThreadPoolExecutor(workers or default_workers()) as ex:
        return list(ex.map(crf, images, probmaps))
