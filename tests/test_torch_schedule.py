"""The port's schedules (dupl_tpu_torch/ops/schedule.py) against the JAX
package's on the same arguments."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dupl_tpu.ops import schedule as jschedule
from dupl_tpu_torch.ops import schedule

torch.set_num_threads(2)
_LR = dict(base_lr=6e-5, warmup_iters=1500, warmup_ratio=1e-6,
           max_iters=20000, power=0.9)


@pytest.mark.parametrize("step", [0, 1, 750, 1499, 1500, 1501, 10000, 19999,
                                  20000, 20001])
def test_poly_warmup_schedule(step):
    """Python double arithmetic against jax's float32: 1e-6 relative, or
    2e-7 of the base LR where jax's ``1 - step/max_iters`` cancels in
    float32 (one ulp of a multiplier near 1, through the 0.9 power)."""
    want = float(jschedule.poly_warmup_schedule(step, **_LR))
    got = schedule.poly_warmup_schedule(step, **_LR)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-6, abs=2e-7 * _LR["base_lr"])
    if step >= 20000:
        assert got == 0.0


@pytest.mark.parametrize("step,num", [(-5, 100), (0, 100), (1, 100),
                                      (50, 100), (99, 100), (100, 100),
                                      (7000, 18000), (30000, 18000)])
def test_cosine_descent(step, num):
    hi = np.full((20,), 0.7, np.float32)
    lo = np.asarray([0.7, 0.55] * 10, np.float32)
    want = np.asarray(jschedule.cosine_descent(jnp.asarray(hi), jnp.asarray(lo),
                                               step, num))
    got = schedule.cosine_descent(torch.from_numpy(hi), torch.from_numpy(lo),
                                  step, num)
    assert got.dtype == torch.float32 and got.shape == (20,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_per_sample_high_thre():
    rs = np.random.RandomState(0)
    thr = rs.uniform(0.5, 0.7, 20).astype(np.float32)
    cls = (rs.rand(6, 20) > 0.8).astype(np.float32)
    cls[0] = 0                              # no class present: -inf, as jax
    cls[1, 3] = 1
    want = np.asarray(jschedule.per_sample_high_thre(jnp.asarray(thr),
                                                     jnp.asarray(cls)))
    got = schedule.per_sample_high_thre(torch.from_numpy(thr),
                                        torch.from_numpy(cls)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == -np.inf
