"""Build and load the hand-written CUDA kernels under ``dupl_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v \
         -o build/dupl_tpu_torch/<name>-<hash>.so csrc/<name>.cu

into ``build/dupl_tpu_torch/`` at the checkout root (nvcc's output beside it
as ``<name>-<hash>.log``), keyed by a hash of the sources and flags, and
loaded with ``ctypes`` (seconds to build, where a
PyTorch C++ extension takes minutes).  A failed build raises; nothing falls
back to the plain PyTorch versions.  So does a build in which ptxas reports
that it serialised a kernel's ``wgmma.mma_async`` products (its "Potential
Performance Loss" notes, C7510-C7515): the flash kernels are built around
asynchronous ``wgmma`` in flight while the softmax runs, and a serialised
build would compute the right numbers slowly without saying so.

One ``nvcc`` per source and machine: a build holds an exclusive ``flock`` on
its source file, so the ranks of a node (``torchrun`` starts one process a
GPU) wait for the first one's compile and load its library.  The kernel
releases the lock when its holder exits, however it exits, so a killed build
leaves nothing behind that blocks the next.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dupl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# ptxas's note when it cannot keep wgmma products asynchronous
WGMMA_SERIALIZED = "wgmma.mma_async instructions are serialized"

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of dupl_tpu_torch need the CUDA toolkit")


# The kernels of the main path, each launched through the registered
# ``torch.library`` op ``dupl::<name>`` (``ops/attention.py``,
# ``ops/crf_cuda.py``, ``ops/par_cuda.py``, ``ops/gelu.py``,
# ``ops/quant.py``): op name -> the stem of its source under ``csrc/``.
OPS = {"exp_attention": "exp_attention",
       "exp_attention_bwd": "exp_attention_bwd",
       "flash_attention": "flash_attention",
       "flash_attention_bwd": "flash_attention_bwd",
       "crf_apply": "crf_apply", "par_affinity": "par_affinity",
       "par_propagate": "par_propagate",
       "gelu_erf": "gelu_erf", "gelu_erf_bwd": "gelu_erf",
       "quantize_pair": "quantize_rows", "gelu_quantize_pair": "quantize_rows",
       "row_absmax_pair": "quantize_rows",
       "quantize_pair_given": "quantize_rows",
       "int8_linear": "int8_gemm", "int8_matmul_i32": "int8_gemm",
       "int8_rescale": "int8_gemm"}


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def source_digest(name: str) -> str:
    """The hash that keys the build of ``csrc/<name>.cu``: its source, every
    header under ``csrc/`` and the nvcc flags."""
    return _digest(CSRC / f"{name}.cu")


def digests() -> Dict[str, str]:
    """``dupl::<name>`` -> :func:`source_digest` of its source, for every op
    of :data:`OPS`.  A sealed program calls the ops by name, so an artifact
    records these and is refused where the sources differ."""
    return {f"dupl::{name}": source_digest(src) for name, src in OPS.items()}


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` if no library of the same source hash is
    built yet; returns the library path."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{_digest(src)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(src, "rb") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():      # another process built it while we waited
            return out
        return _compile(src, out, verbose)


def _compile(src: Path, out: Path, verbose: bool) -> Path:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    if WGMMA_SERIALIZED in log:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"ptxas serialised the wgmma products of {src}:\n"
                           + "\n".join(line for line in log.splitlines()
                                        if WGMMA_SERIALIZED in line))
    if verbose:
        print(log, end="", flush=True)
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


def ptxas_usage(name: str) -> List[Tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    entry function of ``csrc/<name>.cu``, from ptxas's ``-v`` lines in the
    log its build kept beside the library; builds it first if need be."""
    log = build(name).with_suffix(".log").read_text()
    rows, entry, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((entry, int(m.group(1)), *spills))
            entry = None
    return rows


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(build(name)))
        return lib


def build_all(verbose: bool = False) -> Dict[str, float]:
    """Build every kernel source, one nvcc per source, all at once; returns
    seconds per source."""
    def timed(name: str) -> float:
        t0 = time.perf_counter()
        build(name, verbose=verbose)
        return time.perf_counter() - t0

    names = [src.stem for src in sorted(CSRC.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(timed, names)))


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {status}")
