"""Port parity: dupl_tpu_torch.ops.crf / crf_cuda against dupl_tpu.ops.crf /
crf_pallas on the same numpy inputs (CPU, float32)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dupl_tpu.ops import crf as jcrf
from dupl_tpu.ops import crf_pallas
from dupl_tpu_torch.config import CrfConfig
from dupl_tpu_torch.ops import crf as tcrf
from dupl_tpu_torch.ops import crf_cuda

torch.set_num_threads(2)


def test_kernel_apply_twin_matches_pallas():
    """K5's twin against the reference Pallas kernel (interpret mode), at
    unaligned sizes.  Tolerance 2e-3 of the output's scale: both round the
    same fp32 kernel entries to bf16, and fp32 summation order may flip the
    rounding of an entry (2^-8 of it)."""
    rs = np.random.RandomState(0)
    n, ns, v = 700, 300, 22
    basis = (rs.standard_normal((n, 11)) * 2.0).astype(np.float32)
    coef = (rs.standard_normal((11, ns)) * 0.1).astype(np.float32)
    logc = -np.abs(rs.standard_normal(ns)).astype(np.float32)
    vals = rs.standard_normal((ns, v)).astype(np.float32)
    want = np.asarray(crf_pallas.kernel_apply(
        jnp.asarray(basis), jnp.asarray(coef), jnp.asarray(logc),
        jnp.asarray(vals), interpret=True))
    got = crf_cuda.kernel_apply(*(torch.from_numpy(a)[None] for a in
                                  (basis, coef, logc, vals)), block_rows=256)
    assert got.shape == (1, n, v) and got.dtype == torch.float32
    err = np.abs(got[0].numpy() - want).max()
    assert err <= 2e-3 * np.abs(want).max(), err


def test_kernel_wrapper_rejects_cpu_tensors():
    z = torch.zeros(1, 64, 11)
    with pytest.raises(ValueError, match="CUDA"):
        crf_cuda.kernel_apply_cuda(z, torch.zeros(1, 11, 8), torch.zeros(1, 8),
                                   torch.zeros(1, 8, 3))
    assert crf_cuda.kernel_apply_cuda.launches == 0


def _scene(rs, b, h, w, c):
    """Piecewise-constant colour regions with noisy unaries: the CRF has
    something to clean up and labels to move."""
    regions = rs.randint(0, c, (b, h // 16, w // 16))
    labels = regions.repeat(16, 1).repeat(16, 2)
    palette = rs.rand(c, 3).astype(np.float32)
    img = palette[labels] + 0.05 * rs.randn(b, h, w, 3).astype(np.float32)
    logits = 2.0 * np.eye(c, dtype=np.float32)[labels] + rs.randn(
        b, h, w, c).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return np.clip(img, 0, 1).astype(np.float32), probs.astype(np.float32)


@pytest.mark.parametrize("c", [5, 21])
@pytest.mark.parametrize("fast", [True, False])
def test_mean_field_crf_matches_jax(c, fast):
    """B = 2, 64x64; fast mode compares logits (magnitude up to ~10), full
    mode marginals (in [0, 1]).  A bf16 kernel entry may round differently
    where fp32 sums differ in order, moving a message by 2^-8 of that entry;
    iterations and bi_w = 4 amplify it.  Bounds: logits within 1e-2 (~1e-3
    of their scale), marginals within 2e-3; labels at least 99.9% equal."""
    rs = np.random.RandomState(c)
    img, probs = _scene(rs, 2, 64, 64, c)
    kw = dict(iters=4, downsample=8, row_chunk=16, fast=fast,
              return_logits=fast)
    want = np.asarray(jcrf.mean_field_crf(jnp.asarray(img), jnp.asarray(probs),
                                          **kw))
    got = tcrf.mean_field_crf(torch.from_numpy(img), torch.from_numpy(probs),
                              **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2 if fast else 2e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def test_crf_from_config_matches_jax():
    rs = np.random.RandomState(3)
    img, probs = _scene(rs, 1, 48, 48, 5)
    cfg = CrfConfig()
    want = np.asarray(jcrf.crf_from_config(
        jnp.asarray(img), jnp.asarray(probs), cfg, fast=True,
        return_logits=True))
    got = tcrf.crf_from_config(torch.from_numpy(img), torch.from_numpy(probs),
                               cfg, fast=True, return_logits=True).numpy()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999
    assert tcrf._auto_tile(48, 56) == jcrf._auto_tile(48, 56) == 48
