"""Port parity: dupl_tpu_torch.ops.image against dupl_tpu.ops.image on the
same numpy inputs (CPU, float32).  Tolerance: atol 1e-5 — both sides compute
the same interpolation weights in fp32; only summation order differs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dupl_tpu.ops import image as jimg
from dupl_tpu_torch.ops import image as timg

torch.set_num_threads(2)
ATOL = 1e-5


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


@pytest.mark.parametrize("size", [(12, 10), (36, 30)])  # 0.5x down, 1.5x up
@pytest.mark.parametrize("batch_dims", [1, 2])
def test_resize_bilinear_and_nearest(size, batch_dims):
    rs = np.random.RandomState(0)
    shape = (2, 3, 24, 20, 5)[2 - batch_dims:]
    x = rs.randn(*shape).astype(np.float32)
    for tf, jf in ((timg.resize_bilinear, jimg.resize_bilinear),
                   (timg.resize_nearest, jimg.resize_nearest)):
        _close(tf(torch.from_numpy(x), size, batch_dims=batch_dims),
               jf(jnp.asarray(x), size, batch_dims=batch_dims))


@pytest.mark.parametrize("out", [28, 42])
def test_resize_bicubic(out):
    rs = np.random.RandomState(1)
    x = rs.randn(1, 14, 14, 8).astype(np.float32)
    _close(timg.resize_bicubic(torch.from_numpy(x), (out, out)),
           jimg.resize_bicubic(jnp.asarray(x), (out, out)))


def test_normalize_and_prepare_inputs():
    rs = np.random.RandomState(2)
    u8 = rs.randint(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    x01 = rs.rand(2, 8, 8, 3).astype(np.float32)
    _close(timg.normalize(torch.from_numpy(x01)),
           jimg.normalize(jnp.asarray(x01)))
    _close(timg.denormalize(torch.from_numpy(x01)),
           jimg.denormalize(jnp.asarray(x01)))
    for t, j in zip(timg.prepare_inputs(torch.from_numpy(u8)),
                    jimg.prepare_inputs(jnp.asarray(u8))):
        _close(t, j)
    xn = rs.randn(2, 8, 8, 3).astype(np.float32)
    for t, j in zip(timg.prepare_inputs(torch.from_numpy(xn)),
                    jimg.prepare_inputs(jnp.asarray(xn))):
        _close(t, j)
