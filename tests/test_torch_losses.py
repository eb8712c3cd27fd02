"""The port's losses (dupl_tpu_torch/ops/losses.py) against the JAX
package's: values, and gradients with respect to the logits or feature maps,
float32 on both sides, rtol 1e-5 (sums of a few thousand fp32 terms in
different orders)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.ops import losses as jlosses
from dupl_tpu_torch.ops import losses

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-7


def _both(jfn, tfn, diff, const=()):
    """Value and gradient w.r.t. the arrays ``diff`` on both sides."""
    jval, jgrads = jax.value_and_grad(
        lambda *a: jfn(*a, *map(jnp.asarray, const)),
        argnums=tuple(range(len(diff))))(*map(jnp.asarray, diff))
    leaves = [torch.from_numpy(a).requires_grad_() for a in diff]
    tval = tfn(*leaves, *map(torch.from_numpy, const))
    tgrads = torch.autograd.grad(tval, leaves)
    np.testing.assert_allclose(tval.item(), float(jval), rtol=RTOL)
    for tg, jg in zip(tgrads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=RTOL,
                                   atol=ATOL + 1e-5 * np.abs(jg).max())


def _labels(rs, shape, num_classes):
    lab = rs.randint(0, num_classes, shape).astype(np.int32)
    lab[rs.rand(*shape) < 0.2] = 255
    return lab


def test_multilabel_soft_margin_loss():
    rs = np.random.RandomState(0)
    logits = rs.standard_normal((4, 20)).astype(np.float32) * 3
    y = (rs.rand(4, 20) > 0.8).astype(np.float32)
    _both(jlosses.multilabel_soft_margin_loss,
          losses.multilabel_soft_margin_loss, (logits,), (y,))


@pytest.mark.parametrize("classes", [21, 81])
def test_cross_entropy_map(classes):
    rs = np.random.RandomState(1)
    logits = rs.standard_normal((2, 16, 16, classes)).astype(np.float32) * 2
    lab = _labels(rs, (2, 16, 16), classes)
    want = np.asarray(jlosses.cross_entropy_map(jnp.asarray(logits),
                                                jnp.asarray(lab)))
    got = losses.cross_entropy_map(torch.from_numpy(logits),
                                   torch.from_numpy(lab)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    assert (got[lab == 255] == 0).all() and (got[lab != 255] > 0).all()
    _both(lambda x, l: jlosses.cross_entropy_map(x, l).sum(),
          lambda x, l: losses.cross_entropy_map(x, l).sum(), (logits,), (lab,))


@pytest.mark.parametrize("case", ["mixed", "no_fg", "all_ignored"])
def test_seg_loss(case):
    rs = np.random.RandomState(2)
    logits = rs.standard_normal((2, 16, 16, 21)).astype(np.float32)
    lab = _labels(rs, (2, 16, 16), 21)
    if case == "no_fg":
        lab[(lab != 0) & (lab != 255)] = 0
    elif case == "all_ignored":
        lab[:] = 255
    _both(jlosses.seg_loss, losses.seg_loss, (logits,), (lab,))


def test_masked_ptc_loss():
    rs = np.random.RandomState(3)
    fmap = rs.standard_normal((2, 6, 6, 32)).astype(np.float32)
    aff = rs.choice([0, 1, 255], size=(2, 36, 36)).astype(np.int32)
    _both(jlosses.masked_ptc_loss, losses.masked_ptc_loss, (fmap,), (aff,))


def test_discrepancy_loss():
    """Differentiated w.r.t. both maps: the first is detached, so its
    gradient is zero on both sides."""
    rs = np.random.RandomState(4)
    a = rs.standard_normal((2, 6, 6, 32)).astype(np.float32)
    b = (a + 0.5 * rs.standard_normal((2, 6, 6, 32))).astype(np.float32)
    want = float(jlosses.discrepancy_loss(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = losses.discrepancy_loss(ta, tb)
    np.testing.assert_allclose(got.item(), want, rtol=RTOL)
    got.backward()
    assert ta.grad is None
    jg = np.asarray(jax.grad(jlosses.discrepancy_loss, argnums=1)(
        jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(tb.grad.numpy(), jg, rtol=RTOL,
                               atol=1e-5 * np.abs(jg).max())
