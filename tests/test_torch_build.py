"""The kernel builder of the port (dupl_tpu_torch/kernels/build.py): a
missing toolkit or a failed compile raises; nothing falls back.  And the
port's rule that it never imports JAX."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dupl_tpu_torch

from dupl_tpu_torch.kernels import build

torch.set_num_threads(2)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("exp_attention")


def test_failed_compile_raises_with_the_command(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_nvcc", lambda: "false")  # exits 1
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed") as ei:
        build.build("crf_apply")
    assert "sm_90a" in str(ei.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_library_name_follows_the_sources():
    """The cache key covers every source, header and flag."""
    src = build.CSRC / "exp_attention.cu"
    assert build._digest(src) == build._digest(src)
    assert build._digest(src) != build._digest(build.CSRC / "crf_apply.cu")
    assert sorted(p.stem for p in build.CSRC.glob("*.cu")) == [
        "crf_apply", "exp_attention", "par_affinity", "par_propagate"]


def test_port_never_imports_jax():
    """Every module of dupl_tpu_torch, imported in a fresh interpreter,
    leaves no jax module behind."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        dupl_tpu_torch.__path__, "dupl_tpu_torch."))
    assert "dupl_tpu_torch.ops.par_cuda" in names
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module(n)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         cwd=Path(dupl_tpu_torch.__file__).parents[1]).stdout
    assert out.strip() == "[]", out
