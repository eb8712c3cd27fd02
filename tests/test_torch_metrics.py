"""Port parity: dupl_tpu_torch.utils.metrics against dupl_tpu.utils.metrics
on the same numpy inputs.  Everything is integer counting or float64 on the
host, so the comparisons are exact."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dupl_tpu.utils import metrics as jm
from dupl_tpu_torch.utils import metrics as tm

torch.set_num_threads(2)


def _labels(seed, n=5000, nc=21):
    rs = np.random.RandomState(seed)
    gt = rs.randint(0, nc, n).astype(np.int32)
    gt[rs.rand(n) < 0.1] = 255                    # ignore
    gt[:3] = -1
    pred = rs.randint(0, nc, n).astype(np.int32)
    pred[rs.rand(n) < 0.5] = gt[rs.rand(n) < 0.5][0] % nc
    return gt, pred


@pytest.mark.parametrize("nc", [21, 5])
def test_fast_hist_matches_jax(nc):
    gt, pred = _labels(nc, nc=nc)
    pred[:10] = nc + 3                            # clipped into range
    want = np.asarray(jm.fast_hist(jnp.asarray(gt), jnp.asarray(pred), nc))
    got = tm.fast_hist(torch.from_numpy(gt), torch.from_numpy(pred), nc)
    assert got.shape == (nc, nc) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum().item() == ((gt >= 0) & (gt < nc)).sum()


def test_add_hist_and_scores_match_jax():
    hj = np.zeros((21, 21), np.float64)
    ht = np.zeros((21, 21), np.float64)
    pairs = [_labels(s) for s in range(3)]
    for gt, pred in pairs:
        jm.add_hist(hj, gt.reshape(50, 100), pred.reshape(50, 100))
        tm.add_hist(ht, gt.reshape(50, 100), pred.reshape(50, 100))
    np.testing.assert_array_equal(ht, hj)
    # the uint8 label maps the evaluator copies off the device count alike
    h8 = np.zeros((21, 21), np.float64)
    for gt, pred in pairs:
        tm.add_hist(h8, gt, pred.astype(np.uint8))
    np.testing.assert_array_equal(h8, hj)
    sj, st = jm.scores_from_hist(hj), tm.scores_from_hist(ht)
    for k in ("pAcc", "mAcc", "miou"):
        assert st[k] == sj[k]
    np.testing.assert_array_equal(list(st["iou"].values()),
                                  list(sj["iou"].values()))
    s2j = jm.scores([g for g, _ in pairs], [p for _, p in pairs])
    s2t = tm.scores([g for g, _ in pairs], [p for _, p in pairs])
    assert s2t["miou"] == s2j["miou"] == st["miou"]
    names = ["a", "b"]
    classes = [f"c{i}" for i in range(21)]
    assert (tm.format_score_table([st, s2t], names, classes)
            == jm.format_score_table([sj, s2j], names, classes))


def test_scores_of_an_empty_or_partial_hist():
    """Classes absent from the ground truth are left out of the mean, as in
    the reference; an empty matrix gives nan, not an error."""
    h = np.zeros((4, 4))
    assert np.isnan(tm.scores_from_hist(h)["miou"])
    h[1, 1], h[1, 2], h[2, 2] = 5, 5, 10
    st, sj = tm.scores_from_hist(h), jm.scores_from_hist(h)
    assert st["miou"] == sj["miou"] == pytest.approx((0.5 + 10 / 15) / 2)


def test_resize_logits_host_matches_jax():
    rs = np.random.RandomState(0)
    logits = rs.randn(23, 31, 5).astype(np.float32)
    for size in ((46, 62), (37, 50), (10, 12)):
        np.testing.assert_array_equal(tm.resize_logits_host(logits, size),
                                      jm.resize_logits_host(logits, size))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multilabel_f1_matches_jax(seed):
    rs = np.random.RandomState(seed)
    yt = (rs.rand(20) > 0.7).astype(np.float32)
    yp = (rs.rand(20) > 0.6).astype(np.int32)
    assert tm.multilabel_f1(yt, yp) == jm.multilabel_f1(yt, yp)
    assert tm.multilabel_f1(np.zeros(20), np.zeros(20)) == 0.0
