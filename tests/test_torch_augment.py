"""The port's strong augmentation (dupl_tpu_torch/ops/augment.py) against
the JAX package's: each op, the batched forms, and ``rand_augment`` with the
op indices that ``jax.random`` draws for the same key.  Bound: 1e-3 on the
0-255 scale (float32 on both sides; the ops are a few multiply-adds a pixel,
equalize is integer arithmetic and must agree to that bound as well)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.ops import augment as jaugment
from dupl_tpu_torch.ops import augment

torch.set_num_threads(2)
ATOL = 1e-3
VALS = augment.magnitudes(10)


def _images(b=3, h=40, w=56, seed=0):
    rs = np.random.RandomState(seed)
    img = rs.rand(b, 5, 7, 3).astype(np.float32)
    img = np.kron(img, np.ones((1, h // 5, w // 7, 1), np.float32))
    img = np.clip(img * 255 + rs.randn(b, h, w, 3) * 12, 0, 255)
    img[1] = np.round(img[1])          # one uint8-valued image
    img[2, ..., 1] = 77.0              # one flat channel: step == 0
    return img.astype(np.float32)


def test_magnitudes_match_jax_table():
    assert len(VALS) == len(jaugment._OPS) == augment.NUM_OPS == 7
    want = [(10 / 30.0) * (hi - lo) + lo for lo, hi in jaugment._RANGES]
    assert list(VALS) == want
    assert [f.__name__ for f in augment.OPS] == [
        f.__name__ for f in jaugment._OPS]


@pytest.mark.parametrize("i", range(7))
def test_single_image_op_matches_jax(i):
    img = _images()
    for k in range(img.shape[0]):
        want = np.asarray(jaugment._OPS[i](jnp.asarray(img[k]), VALS[i]))
        got = augment.OPS[i](torch.from_numpy(img[k]), VALS[i]).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_batched_ops_match_jax():
    img = _images(seed=1)
    want = np.asarray(jaugment._batched_ops(jnp.asarray(img),
                                            jnp.asarray(VALS, jnp.float32)))
    for i, (op, v) in enumerate(zip(augment.OPS, VALS)):
        got = op(torch.from_numpy(img), v).numpy()
        np.testing.assert_allclose(got, want[i], atol=ATOL, rtol=0,
                                   err_msg=op.__name__)


def test_equalize_is_exact_against_jax_batched():
    """Integer histogram, integer LUT: equal, not merely close."""
    img = np.round(_images(seed=2))
    want = np.asarray(jaugment._equalize_batched(jnp.asarray(img)))
    got = augment.equalize(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[2, ..., 1] == 77.0).all()


def _jax_ops(key, n, b):
    """The indices ``jaugment.rand_augment`` draws from ``key``."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (b,), 0, 7)))
    return np.stack(out).astype(np.int64)


def _jax_chain(img01, ops, m=10):
    """``jaugment.rand_augment``'s loop with given indices, not drawn."""
    img = jnp.asarray(img01) * 255.0
    vals = jnp.asarray(augment.magnitudes(m), jnp.float32)
    for round_ops in ops:
        every = jnp.clip(jaugment._batched_ops(img, vals), 0.0, 255.0)
        sel = jax.nn.one_hot(jnp.asarray(round_ops), 7, axis=0,
                             dtype=img.dtype)[..., None, None, None]
        img = jnp.sum(every * sel, axis=0)
    return np.asarray(img / 255.0)


@pytest.mark.parametrize("seed", [0, 7])
def test_rand_augment_matches_jax_with_its_draws(seed):
    """Five chained ops.  Equalize and posterize quantise (truncate to an
    integer level, floor to a step), so after a float op a value within
    float error of a level may land one level away, and equalize's
    histogram then moves a few LUT entries: at most 4 of 255 levels on any
    value, 0.25 on average, on chains that hold such an op (measured: max
    3.0, mean 0.07)."""
    img01 = _images(b=4, seed=seed) / 255.0
    key = jax.random.PRNGKey(seed)
    ops = _jax_ops(key, 5, 4)
    assert len(np.unique(ops)) >= 4
    want = np.asarray(jaugment.rand_augment(key, jnp.asarray(img01), 5, 10))
    np.testing.assert_allclose(want, _jax_chain(img01, ops), atol=1e-6)
    got = augment.rand_augment(torch.from_numpy(img01), torch.from_numpy(ops),
                               10).numpy()
    diff = np.abs(got - want) * 255
    assert diff.max() <= 4.0 and diff.mean() <= 0.25, (diff.max(), diff.mean())
    want_s = np.asarray(jaugment.strong_augment(key, jnp.asarray(img01), 5, 10))
    got_s = augment.strong_augment(torch.from_numpy(img01),
                                   torch.from_numpy(ops), 10).numpy()
    np.testing.assert_array_equal(got_s, got[:, :, ::-1])
    np.testing.assert_array_equal(want_s, want[:, :, ::-1])


def test_rand_augment_chains_without_quantising_ops():
    """Chains of the five float ops (and of a quantising op first, on the
    clean input) agree to 1e-3 of the 0-255 scale."""
    img01 = _images(b=4, seed=5) / 255.0
    ops = np.asarray([[0, 1, 2, 6], [3, 4, 5, 5], [4, 6, 3, 0], [5, 0, 6, 3],
                      [6, 3, 4, 4]], np.int64)
    want = _jax_chain(img01, ops)
    got = augment.rand_augment(torch.from_numpy(img01), torch.from_numpy(ops),
                               10).numpy()
    np.testing.assert_allclose(got * 255, want * 255, atol=ATOL, rtol=0)


def test_every_op_is_selected_per_image():
    """Image b goes through exactly ``ops[:, b]``: a batch whose images
    take different ops equals each image augmented alone."""
    img01 = torch.from_numpy(_images(b=7, seed=3) / 255.0)
    ops = torch.arange(7)[None].repeat(2, 1)
    ops[1] = ops[1].flip(0)
    got = augment.rand_augment(img01, ops, 10)
    for b in range(7):
        x = img01[b] * 255.0
        for i in ops[:, b].tolist():
            x = augment.OPS[i](x, VALS[i]).clamp(0, 255)
        torch.testing.assert_close(got[b], x / 255.0, atol=1e-6, rtol=0)


def test_draw_ops_and_shape_check():
    gen = torch.Generator().manual_seed(0)
    ops = augment.draw_ops(gen, 5, 4)
    assert ops.shape == (5, 4) and ops.dtype == torch.int64
    assert int(ops.min()) >= 0 and int(ops.max()) < 7
    again = augment.draw_ops(torch.Generator().manual_seed(0), 5, 4)
    assert torch.equal(ops, again)
    with pytest.raises(ValueError, match="ops must be"):
        augment.rand_augment(torch.zeros(3, 8, 8, 3), ops)
