"""The port's kernel ops (``dupl_tpu_torch/ops/library.py``): every kernel of
the main path is a registered ``dupl::`` op whose CPU kernel is its plain
twin.  ``torch.library.opcheck`` holds each op's schema, fake kernel (shapes,
types and strides against the twin's), autograd registration and traced
dispatch on CPU tensors at small shapes; ``torch.export`` records the ops
by name; and an export leaves the eager path's cached constants real."""

import numpy as np
import pytest
import torch

from dupl_tpu_torch.config import DataConfig, ModelConfig, voc_config
from dupl_tpu_torch.engine.export import ServingProgram
from dupl_tpu_torch.kernels import build
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import (attention, crf_cuda, gelu, image,  # noqa: F401
                                par_cuda, quant)

torch.set_num_threads(2)
DIL = [1, 2]


def _randn(*shape, dtype=torch.float32, grad=False, seed=0):
    rs = np.random.RandomState(seed + len(shape))
    x = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(dtype)
    return x.requires_grad_(grad)


def _cases():
    """(op name, arguments): one input that requires grad in each, so that
    the autograd registration is exercised (no output may require grad)."""
    bf = torch.bfloat16
    q, k, v, g = (_randn(2, 20, 2, 16, dtype=bf, grad=True, seed=i)
                  for i in range(4))
    out, lse = torch.ops.dupl.flash_attention(q.detach(), k.detach(),
                                              v.detach(), 0.25)
    rs = np.random.RandomState(1)
    imgs = torch.from_numpy(rs.rand(2, 16, 16, 3).astype(np.float32))
    aff = torch.ops.dupl.par_affinity(imgs, DIL, 0.3, 0.01)
    masks = torch.from_numpy(rs.rand(2, 3, 16, 16).astype(np.float32))
    return {
        "exp_attention": (q, k, v),
        "exp_attention_bwd": (q, k, v, g),
        "flash_attention": (q, k, v, 0.25),
        "flash_attention_bwd": (q, k, v, out, lse, g, 0.25),
        "crf_apply": (_randn(2, 64, 11, grad=True), _randn(2, 11, 8),
                      _randn(2, 8), _randn(2, 8, 3), 16),
        "par_affinity": (imgs.clone().requires_grad_(True), DIL, 0.3, 0.01),
        "par_propagate": (masks.clone().requires_grad_(True), aff, DIL, 2),
        "par_propagate_bf16": (masks.clone().requires_grad_(True),
                               aff.to(bf), DIL, 2),
        "par_propagate_f16": (masks.clone().requires_grad_(True),
                              aff.half(), DIL, 2),
        "gelu_erf": (_randn(3, 7, 16, dtype=bf, grad=True),),
        "gelu_erf_fp32": (_randn(3, 7, 16, grad=True),),
        "gelu_erf_f16": (_randn(3, 7, 16, dtype=torch.float16, grad=True),),
        "gelu_erf_bwd": (_randn(3, 7, 16, dtype=bf, grad=True),
                         _randn(3, 7, 16, dtype=bf, seed=1)),
        "gelu_erf_bwd_f16": (_randn(3, 7, 16, dtype=torch.float16, grad=True),
                             _randn(3, 7, 16, dtype=torch.float16, seed=1)),
        "quantize_pair": (_randn(10, 64, dtype=bf, grad=True),
                          _randn(16, 64, seed=1)),
        "gelu_quantize_pair": (_randn(10, 64, grad=True),
                               _randn(16, 64, seed=1), True),
        "gelu_quantize_pair_erf": (_randn(10, 64, grad=True),
                                   _randn(16, 64, seed=1), False),
        "int8_linear": (*torch.ops.dupl.quantize_pair(_randn(10, 64),
                                                      _randn(16, 64, seed=1)),
                        _randn(16, grad=True)),
        "row_absmax_pair": (_randn(10, 64, grad=True), _randn(16, 64, seed=1),
                            "tanh"),
        "quantize_pair_given": (_randn(10, 64, dtype=bf, grad=True),
                                _randn(16, 64, seed=1),
                                _randn(10, seed=2).abs(),
                                _randn(16, seed=3).abs()),
        "int8_matmul_i32": torch.ops.dupl.quantize_pair(
            _randn(10, 64), _randn(16, 64, seed=1))[::2],
        "int8_rescale": (torch.randint(-9999, 9999, (10, 16),
                                       dtype=torch.int32),
                         _randn(10, 1).abs(), _randn(16, 1, seed=1).abs(),
                         _randn(16, grad=True)),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_opcheck(case):
    name = case.removesuffix("_bf16").removesuffix("_fp32").removesuffix(
        "_f16")
    name = name.removesuffix("_erf") if name.endswith("pair_erf") else name
    op = getattr(torch.ops.dupl, name).default
    torch.library.opcheck(op, _cases()[case])


def test_every_kernel_of_the_path_is_an_op():
    """The ops of ``kernels/build.py:OPS`` are registered with a CPU, a CUDA
    and a fake kernel and an autograd registration (a fallthrough: an op is
    not differentiable by itself), each with its CUDA source."""
    for name, src in build.OPS.items():
        qual = f"dupl::{name}"
        for key in ("CPU", "CUDA", "Meta", "Autograd"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, key), \
                (qual, key)
        assert (build.CSRC / f"{src}.cu").exists()
    registered = {n for n in torch._C._dispatch_get_all_op_names()
                  if n.startswith("dupl::")}
    assert set(build.digests()) == registered == {f"dupl::{n}"
                                                  for n in build.OPS}


def test_exp_attention_exports_as_op():
    """A module that calls the max-free attention (K1) on CPU tensors
    exports with ``dupl::exp_attention`` in its graph, and its sealed
    program equals the eager call."""
    class Attend(torch.nn.Module):
        def forward(self, q, k, v):
            return attention.exp_attention(q, k, v, scale=0.125)

    q, k, v = (_randn(2, 130, 2, 64, seed=i) for i in range(3))
    with torch.no_grad():
        exported = torch.export.export(Attend(), (q, k, v))
        targets = {str(n.target) for n in exported.graph.nodes}
        assert "dupl.exp_attention.default" in targets
        assert torch.equal(exported.module()(q, k, v),
                           attention.exp_attention(q, k, v, scale=0.125))


def test_export_leaves_eager_constants_real():
    """``ops/image.py`` caches its device constants; a constant first made
    while ``torch.export`` traces is a fake tensor, which a cache would hand
    to every later eager call.  Trace the serving program with the caches
    empty, then call ``prepare_inputs`` and ``resize_bicubic`` eagerly: real
    tensors, equal to those of before the trace."""
    cfg = voc_config(model=ModelConfig(backbone="test_tiny_patch16",
                                       compute_dtype="float32"),
                     data=DataConfig(crop_size=64))
    rs = np.random.RandomState(0)
    imgs = torch.from_numpy(rs.randint(0, 255, (2, 64, 64, 3)).astype(np.uint8))
    table = torch.from_numpy(rs.randn(1, 14, 14, 8).astype(np.float32))
    before = (*image.prepare_inputs(imgs), image.resize_bicubic(table, (4, 4)))
    image._imagenet_stats.cache_clear()
    image._bicubic_weights_on.cache_clear()
    program = ServingProgram(cfg, DualStudent(cfg.model).eval(),
                             scales=(1.0,), crf=False)
    with torch.no_grad():       # 4 x 4 patches: the table is resized
        torch.export.export(program, (imgs,))
    after = (*image.prepare_inputs(imgs), image.resize_bicubic(table, (4, 4)))
    cached = (*image._imagenet_stats(torch.float32, torch.device("cpu")),
              image._bicubic_weights_on(14, 4, torch.float32,
                                        torch.device("cpu")))
    for t in (*after, *cached):
        assert type(t) is torch.Tensor, type(t)
    for a, b in zip(before, after):
        assert torch.equal(a, b)
