"""The kernel builder of the port (dupl_tpu_torch/kernels/build.py): a
missing toolkit or a failed compile raises; nothing falls back."""

import pytest
import torch

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
        "crf_apply", "exp_attention"]
