"""The port's GMM noise filter (dupl_tpu_torch/ops/gmm.py) against the JAX
package's on the same draws: fitted parameters within 1e-4 (fixed-count EM
in float32, sums in different orders), filtered labels equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dupl_tpu.ops import gmm as jgmm
from dupl_tpu_torch.ops import gmm

torch.set_num_threads(2)


def _draw(case, rs):
    if case == "bimodal":
        parts = (rs.normal(0.3, 0.05, 1500), rs.normal(2.5, 0.2, 500))
    elif case == "overlapping":
        parts = (rs.normal(0.6, 0.25, 1400), rs.normal(1.6, 0.45, 600))
    else:   # one mode: the tol freeze stops early
        parts = (rs.normal(1.0, 0.1, 2000),)
    return np.abs(np.concatenate(parts)).astype(np.float32)


@pytest.mark.parametrize("case", ["bimodal", "overlapping", "unimodal"])
def test_fit_gmm2_matches_jax(case):
    rs = np.random.RandomState(0)
    x = np.stack([_draw(case, rs), _draw(case, rs)[::-1].copy()])
    mask = rs.rand(*x.shape) > 0.1
    mask[1, :50] = False
    want = jgmm.fit_gmm2(jnp.asarray(x), jnp.asarray(mask))
    got = gmm.fit_gmm2(torch.from_numpy(x), torch.from_numpy(mask))
    for name in ("means", "var", "weights", "count"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    post_w = np.asarray(jgmm.posterior(want, jnp.asarray(x)))
    post_g = gmm.posterior(got, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(post_g, post_w, atol=2e-3)


def test_kmeans_init_matches_jax():
    rs = np.random.RandomState(1)
    x = _draw("overlapping", rs)[None]
    w = (rs.rand(*x.shape) > 0.3).astype(np.float32)
    want = np.asarray(jgmm._weighted_kmeans_init(jnp.asarray(x), jnp.asarray(w)))
    got = gmm._weighted_kmeans_init(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # an empty mask keeps the seeds finite on both sides
    zero = np.zeros_like(w)
    want0 = np.asarray(jgmm._weighted_kmeans_init(jnp.asarray(x),
                                                  jnp.asarray(zero)))
    got0 = gmm._weighted_kmeans_init(torch.from_numpy(x),
                                     torch.from_numpy(zero))
    np.testing.assert_allclose(got0.numpy(), want0)


def _filter_case(case, rs):
    """(loss_map, label, kwargs): the cases of tests/test_gmm.py."""
    h = w = 48
    label = np.ones((2, h, w), np.int32)
    label[1] = rs.randint(0, 4, (h, w))
    label[1, :, :6] = 255
    loss = rs.normal(0.4, 0.05, size=(2, h, w)).astype(np.float32)
    kw = {}
    if case == "bimodal":          # a block of high-loss pixels is marked
        loss[:, :10] = rs.normal(3.0, 0.3, size=(2, 10, w))
    elif case == "min_pixels":     # too few pixels above the floor: gate
        loss[:, :10] = rs.normal(3.0, 0.3, size=(2, 10, w))
        kw = dict(min_pixels=5000)
    elif case == "mean_gap":       # means closer than valid_thre: gate
        loss[:, :10] = rs.normal(0.9, 0.05, size=(2, 10, w))
    elif case == "overlapping":
        loss = np.abs(np.where(rs.rand(2, h, w) < 0.3,
                               rs.normal(1.9, 0.45, (2, h, w)),
                               rs.normal(0.6, 0.25, (2, h, w)))
                      ).astype(np.float32)
    return loss, label, kw


@pytest.mark.parametrize("case", ["bimodal", "min_pixels", "mean_gap",
                                  "overlapping"])
def test_gmm_filter_labels_equal_jax(case):
    rs = np.random.RandomState(2)
    loss, label, kw = _filter_case(case, rs)
    want = np.asarray(jgmm.gmm_filter_labels(jnp.asarray(loss),
                                             jnp.asarray(label), **kw))
    got = gmm.gmm_filter_labels(torch.from_numpy(loss),
                                torch.from_numpy(label).long(), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    marked = (got == 255) & (label != 255)
    if case in ("min_pixels", "mean_gap"):
        assert not marked.any()
    else:
        assert marked.any()
    assert not marked[label == 0].any()     # background is never marked
