"""Port parity: dupl_tpu_torch.ops.crf / crf_cuda against dupl_tpu.ops.crf /
crf_pallas on the same numpy inputs (CPU, float32)."""

import functools

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


@pytest.mark.parametrize("v", [22, 82])
def test_kernel_apply_twin_matches_pallas(v):
    """K5's twin against the reference Pallas kernel (interpret mode), at
    unaligned sizes, at VOC's V 22 and COCO's fast-mode V 82 (81 classes
    and the cell count).  Tolerance 2e-3 of the output's
    scale: both round the same fp32 kernel entries to bf16, and fp32
    summation order may flip the rounding of an entry (2^-8 of it)."""
    rs = np.random.RandomState(0)
    n, ns = 700, 300
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


@functools.lru_cache(maxsize=None)
def _k5_phase4_inputs(v):
    """Phase 4's K5 operands scaled to 224^2: the pivot lattice of a smooth
    image and its vertical flip (N 50,176, Ns 784), values in [0, 2) with a
    cell-count column of 64, and the twin's output on them."""
    rs = np.random.RandomState(v)
    yy, xx = np.meshgrid(np.linspace(0, 1, 224), np.linspace(0, 1, 224),
                         indexing="ij")
    img = np.stack([np.sin(6 * xx) * 0.5 + 0.5, yy, xx * yy], -1)
    img = np.stack([img, img[::-1]])
    img = np.clip(img + 0.03 * rs.standard_normal(img.shape), 0, 1)
    basis, coef, logc, _, _ = tcrf.pivot_lattice(
        torch.tensor(img, dtype=torch.float32), 8, 121.0, 5.0)
    vals = torch.tensor(rs.rand(2, coef.shape[2], v) * 2.0,
                        dtype=torch.float32)
    vals[..., -1] = 64.0
    return basis, coef, logc, vals, crf_cuda.kernel_apply_ref(
        basis, coef, logc, vals)


def _kernel_apply_reversed(basis, coef, logc, vals, block_rows=25088):
    """K5's function with the 11-wide score summed from its last term to its
    first (another order of the same fp32 sums, as a kernel may take)."""
    vb = vals.to(torch.bfloat16).float()
    out = []
    for lo in range(0, basis.shape[1], block_rows):
        f = basis[:, lo:lo + block_rows]
        s = f[..., 10:11] * coef[:, 10:11, :]
        for d in range(9, -1, -1):
            s = s + f[..., d:d + 1] * coef[:, d:d + 1, :]
        k = torch.exp(torch.minimum(s, logc[:, None, :]))
        out.append(k.to(torch.bfloat16).float() @ vb)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("kind", ["reversed", "k_fp32", "vals_fp32",
                                  "exp_bf16"])
@pytest.mark.parametrize("v", [22, 82])
def test_k5_bounds_tell_wrong_twins(kind, v):
    """The bounds K5 is held to on the card (per column: the largest error
    2e-3 of its scale, the mean error 2e-5) at phase 4's inputs scaled to
    224^2: the function with the score summed in reverse order lies inside
    them, and each wrong twin of chip_smoke.py's ``crf_apply_wrong`` (kernel
    entries in fp32, values in fp32, the exp of the bf16-rounded score) lies
    outside."""
    from chip_smoke import K5_MAX, K5_MEAN, crf_apply_err, crf_apply_wrong

    basis, coef, logc, vals, want = _k5_phase4_inputs(v)
    assert basis.shape == (2, 50176, 11) and coef.shape == (2, 11, 784)
    got = (_kernel_apply_reversed(basis, coef, logc, vals) if kind == "reversed"
           else crf_apply_wrong(basis, coef, logc, vals, kind))
    worst, mean = crf_apply_err(got, want)
    inside = worst <= K5_MAX and mean <= K5_MEAN
    assert inside == (kind == "reversed"), (kind, worst, mean)


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


@pytest.mark.parametrize("c", [5, 21, 81])
@pytest.mark.parametrize("fast", [True, False])
def test_mean_field_crf_matches_jax(c, fast):
    """B = 2, 64x64 (48x48 for COCO's 81 classes, which hand the kernel
    V 82 in fast mode and 81 in full mode); fast mode compares logits
    (magnitude up to ~10), full mode marginals (in [0, 1]).  A bf16 kernel
    entry may round differently where fp32 sums differ in order, moving a
    message by 2^-8 of that entry; iterations and bi_w = 4 amplify it.
    Bounds: logits within 1e-2 (~1e-3 of their scale), marginals within
    2e-3; labels at least 99.9% equal."""
    rs = np.random.RandomState(c)
    size = 48 if c == 81 else 64
    img, probs = _scene(rs, 2, size, size, c)
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


@pytest.mark.parametrize("class_budget", [None, 3, 5, 8])
def test_crf_labels_from_config_matches_jax(class_budget):
    """Argmax labels of the full mean field, with the class axis compacted
    to each image's ``class_budget`` heaviest classes (top-k over the mass,
    one-hot matmul back to class ids) or not (None, and a budget >= C).
    Labels at least 99.9% equal: the bf16 kernel entries may round
    differently where fp32 sums differ in order."""
    rs = np.random.RandomState(11)
    img, probs = _scene(rs, 2, 48, 64, 6)
    cfg = CrfConfig(iter_max=3)
    want = np.asarray(jcrf.crf_labels_from_config(
        jnp.asarray(img), jnp.asarray(probs), cfg, class_budget=class_budget))
    got = tcrf.crf_labels_from_config(torch.from_numpy(img),
                                      torch.from_numpy(probs), cfg,
                                      class_budget=class_budget)
    assert got.shape == (2, 48, 64) and got.dtype == torch.int64
    assert (got.numpy() == want).mean() >= 0.999
    assert len(np.unique(want)) > 2
    if class_budget == 3:   # only the three heaviest classes of each image
        mass = probs.sum((1, 2))
        for b in range(2):
            assert set(np.unique(got[b].numpy())) <= set(
                np.argsort(-mass[b])[:3])


def test_native_crf_bridge_matches_jax(tmp_path, monkeypatch):
    """The port's ctypes bridge builds ``native/densecrf`` into the build
    folder (never beside the sources) and gives the bits of the JAX
    package's bridge to the same sources."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build native/densecrf")
    from dupl_tpu.ops import crf_native as jnative
    from dupl_tpu_torch.ops import crf_native as tnative

    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    before = sorted(p.name for p in tnative.NATIVE_DIR.iterdir()
                    if p.name != "libdensecrf.so")   # the JAX bridge's own
    rs = np.random.RandomState(5)
    img, probs = _scene(rs, 1, 32, 48, 4)
    image = (img[0] * 255).astype(np.uint8)
    pm = probs[0].transpose(2, 0, 1)
    cfg = CrfConfig(iter_max=3)
    got = tnative.DenseCRF.from_config(cfg)(image, pm)
    want = jnative.DenseCRF.from_config(cfg)(image, pm)
    assert got.shape == want.shape == (4, 32, 48) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    libs = list((tmp_path / "build").glob("densecrf-*.so"))
    assert len(libs) == 1 and tnative.build() == libs[0]
    assert sorted(p.name for p in tnative.NATIVE_DIR.iterdir()
                  if p.name != "libdensecrf.so") == before
    outs = tnative.crf_batch([image, image], [pm, pm], cfg, workers=2)
    np.testing.assert_array_equal(outs[0], want)
    np.testing.assert_array_equal(outs[1], want)
    with pytest.raises(ValueError, match="does not match"):
        tnative.DenseCRF()(image[:, :40], pm)
