"""Port parity: dupl_tpu_torch.ops.{par,par_cuda} against dupl_tpu.ops.par and
the Pallas kernels of dupl_tpu.ops.par_pallas run in interpret mode, on the
same numpy inputs (CPU, float32 unless stated)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dupl_tpu.ops import image as jimg
from dupl_tpu.ops import par as jpar
from dupl_tpu.ops.par_pallas import affinity_pallas, propagate_pallas
from dupl_tpu_torch.ops import image as timg
from dupl_tpu_torch.ops import par as tpar
from dupl_tpu_torch.ops import par_cuda

torch.set_num_threads(2)
DIL = (1, 2, 4, 8, 12, 24)
# Uniform-noise inputs: every formulation computes the same fp32 operations
# in slightly different orders, so values agree to a few fp32 ulps.
RTOL, ATOL = 1e-5, 1e-6
# Smooth images: var = sum x^2 - K mean^2 cancels in fp32 where a neighbourhood
# is nearly flat, and the summation order moves the affinity there by up to
# ~4e-4 (measured fp32 against fp64 on a smooth uint8-quantised 224^2 image).
SMOOTH_ATOL = 5e-4


def _noise(shape, seed=0):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _smooth_u8(b, h, w, seed=0):
    """Smooth gradients plus a flat patch, quantised to uint8 / 255."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    imgs = []
    for _ in range(b):
        f = rs.rand(3, 3) * 4
        img = np.stack([0.5 + 0.4 * np.sin(f[c, 0] * xx + f[c, 1] * yy + f[c, 2])
                        for c in range(3)], -1)
        img[h // 4:h // 2, w // 4:w // 2] = rs.rand(3)
        imgs.append(img)
    return (np.round(np.stack(imgs) * 255) / 255).astype(np.float32)


def test_position_affinity_matches_jax():
    """float64 on the host (as affinity_pallas) against the XLA path's fp32:
    agree to fp32 precision (the smallest constants are ~4e-32)."""
    got = np.asarray(tpar.position_affinity(DIL))
    want = np.asarray(jpar.position_affinity(DIL))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    assert abs(got.sum() - 0.01) < 1e-9


def test_dilated_neighbors_matches_jax():
    x = _noise((2, 10, 13, 3))
    got = timg.dilated_neighbors(torch.from_numpy(x), DIL)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jimg.dilated_neighbors(x, DIL)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rgb_affinity_matches_jax(dtype, tmp_path):
    """Taps-last layout against the XLA path; the port computes in fp32
    whatever float dtype the image arrives in.  This comparison failed once
    under six parallel workers and never again; a failure leaves the input
    and both results on disk, named in the message."""
    x = _noise((2, 24, 20, 3), seed=1)
    got = tpar.rgb_affinity(torch.from_numpy(x.astype(dtype)), DIL)
    want = jpar.rgb_affinity(jnp.asarray(x), DIL)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 20, 48)
    got, want = got.numpy(), np.asarray(want)
    if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
        dump = tmp_path / f"rgb_affinity_{dtype}.npz"
        np.savez(dump, image=x, got=got, want=want)
        np.testing.assert_allclose(
            got, want, rtol=RTOL, atol=ATOL,
            err_msg=f"input and both results saved to {dump}")


def test_affinity_ref_matches_pallas_and_xla_on_noise():
    """K3's twin against ``affinity_pallas`` (interpret mode) and the XLA
    ``rgb_affinity``, with row-band tiling on the Pallas side."""
    x = _noise((2, 64, 48, 3))
    got = par_cuda.affinity_ref(torch.from_numpy(x), DIL).numpy()
    assert got.shape == (2, 48, 64, 48)
    pallas = np.asarray(affinity_pallas(jnp.asarray(x), DIL, row_tile=32,
                                        interpret=True))
    xla = np.moveaxis(np.asarray(jpar.rgb_affinity(jnp.asarray(x), DIL)), -1, 1)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)


def test_affinity_ref_on_smooth_quantised_image():
    """Flat neighbourhoods: absolute bound SMOOTH_ATOL on values in
    [0, 1.01], and the labels PAR propagates from the two affinities agree
    on at least 99.9% of the pixels."""
    x = _smooth_u8(2, 64, 64)
    got = par_cuda.affinity_ref(torch.from_numpy(x), DIL)
    pallas = np.asarray(affinity_pallas(jnp.asarray(x), DIL, row_tile=32,
                                        interpret=True))
    xla = np.moveaxis(np.asarray(jpar.rgb_affinity(jnp.asarray(x), DIL)), -1, 1)
    assert np.abs(got.numpy() - pallas).max() <= SMOOTH_ATOL
    assert np.abs(got.numpy() - xla).max() <= SMOOTH_ATOL

    logits = np.random.RandomState(3).randn(2, 64, 64, 6).astype(np.float32)
    masks = torch.softmax(torch.from_numpy(logits) * 3, dim=-1)
    lab_t = par_cuda.propagate_ref(masks, got, DIL, 10).argmax(-1).numpy()
    lab_j = np.asarray(propagate_pallas(jnp.asarray(masks.numpy()),
                                        jnp.asarray(pallas), DIL, 10,
                                        interpret=True, aff_layout="bkhw")
                       ).argmax(-1)
    assert (lab_t == lab_j).mean() >= 0.999


@pytest.mark.parametrize("shape,iters", [((2, 48, 48, 21), 3),
                                         ((1, 20, 12, 5), 4)])
def test_propagate_ref_f32_matches_pallas_and_neighbors(shape, iters):
    """K4's twin, fp32: against ``propagate_pallas`` (interpret mode, which
    sums taps in groups of 8), the XLA ``propagate``, and the
    ``dilated_neighbors`` formulation sum_k neighbours[..., k, :] * aff_k,
    applied ``iters`` times."""
    b, h, w, c = shape
    masks = _noise(shape, seed=4)
    imgs = _noise((b, h, w, 3), seed=5)
    aff = par_cuda.affinity_ref(torch.from_numpy(imgs), DIL)      # (B, K, H, W)
    got = par_cuda.propagate_ref(torch.from_numpy(masks), aff, DIL, iters)
    pallas = propagate_pallas(jnp.asarray(masks), jnp.asarray(aff.numpy()),
                              DIL, iters, interpret=True, aff_layout="bkhw")
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=RTOL,
                               atol=ATOL)
    aff_last = aff.permute(0, 2, 3, 1)
    xla = jpar.propagate(jnp.asarray(masks), jnp.asarray(aff_last.numpy()),
                         DIL, iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=RTOL,
                               atol=ATOL)
    m = torch.from_numpy(masks)
    for _ in range(iters):
        m = (timg.dilated_neighbors(m, DIL) * aff_last[..., None]).sum(3)
    np.testing.assert_allclose(got.numpy(), m.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        tpar.propagate(torch.from_numpy(masks), aff_last, DIL, iters).numpy(),
        got.numpy(), rtol=RTOL, atol=ATOL)


def test_propagate_ref_bf16_matches_pallas():
    """bf16 mode on peaked posteriors, as tests/test_par_pallas.py builds
    them, held to that test's bounds (q99.9 error < 0.02, max < 0.08,
    argmax >= 99.5%) against ``propagate_pallas(compute_dtype="bfloat16")``
    and against the fp32 twin.  The twin and the Pallas kernel round the
    same operations to bf16, but XLA may keep fused bf16 intermediates in
    fp32: after one round they differ by up to 2.2e-3, after ten by 4.2e-2
    (measured on these inputs)."""
    rs = np.random.RandomState(6)
    b, h, w, c = 2, 48, 48, 21
    region = (np.add.outer(np.arange(h) // 16, np.arange(w) // 16) % c)
    logits = rs.rand(b, h, w, c).astype(np.float32) * 2
    for bi in range(b):
        logits[bi, np.arange(h)[:, None], np.arange(w)[None, :], region] += 4.0
    masks = torch.softmax(torch.from_numpy(logits), dim=-1)
    aff = par_cuda.affinity_ref(torch.from_numpy(_noise((b, h, w, 3), 7)), DIL)
    got = par_cuda.propagate_ref(masks, aff, DIL, 10,
                                 compute_dtype="bfloat16").numpy()
    pallas = np.asarray(propagate_pallas(
        jnp.asarray(masks.numpy()), jnp.asarray(aff.numpy()), DIL, 10,
        compute_dtype="bfloat16", interpret=True, aff_layout="bkhw"))
    f32 = par_cuda.propagate_ref(masks, aff, DIL, 10).numpy()
    for ref in (pallas, f32):
        err = np.abs(got - ref)
        assert np.quantile(err, 0.999) < 0.02 and err.max() < 0.08
        assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.995


@pytest.mark.parametrize("shape", [(2, 32, 40, 7),    # C not a multiple of 8
                                   (1, 12, 20, 5),    # H, W < 24: taps clamp
                                   (1, 40, 24, 16)])
def test_par_refine_matches_jax(shape):
    """The port's par_refine (CPU: the twins of K3 and K4) against
    ``par_refine(use_pallas=False)``: full dilations, 10 rounds."""
    b, h, w, c = shape
    imgs = _noise((b, h, w, 3), seed=8)
    masks = torch.softmax(torch.from_numpy(_noise(shape, seed=9)) * 4, -1)
    got = tpar.par_refine(torch.from_numpy(imgs), masks, DIL, num_iter=10)
    want = jpar.par_refine(jnp.asarray(imgs), jnp.asarray(masks.numpy()), DIL,
                           num_iter=10, use_pallas=False)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_dispatch_by_device():
    """CPU tensors take the twins and launch nothing; other devices and
    unknown compute dtypes raise."""
    imgs = torch.from_numpy(_noise((1, 16, 16, 3)))
    masks = torch.from_numpy(_noise((1, 16, 16, 3), seed=1))
    n0 = (par_cuda.affinity_cuda.launches, par_cuda.propagate_cuda.launches)
    aff = par_cuda.affinity(imgs, DIL)
    torch.testing.assert_close(aff, par_cuda.affinity_ref(imgs, DIL),
                               rtol=0, atol=0)
    par_cuda.propagate(masks, aff, DIL, 2)
    assert (par_cuda.affinity_cuda.launches,
            par_cuda.propagate_cuda.launches) == n0
    with pytest.raises(ValueError, match="unsupported device"):
        par_cuda.affinity(imgs.to("meta"), DIL)
    with pytest.raises(ValueError, match="unsupported device"):
        par_cuda.propagate(masks.to("meta"), aff.to("meta"), DIL, 2)
    par_cuda.propagate(masks, aff, DIL, 2, compute_dtype="float16")
    assert par_cuda.propagate_cuda.launches == n0[1]
    with pytest.raises(ValueError, match="compute_dtype"):
        par_cuda.propagate(masks, aff, DIL, 2, compute_dtype="float64")
    with pytest.raises(ValueError, match="CUDA"):
        par_cuda.affinity_cuda(imgs, DIL)
    with pytest.raises(ValueError, match="CUDA"):
        par_cuda.propagate_cuda(masks.permute(0, 3, 1, 2).contiguous(), aff,
                                DIL, 2)


def _phase7_images(b, h, seed=0):
    """chip_smoke.py phase 7's ``smooth`` and ``uint8`` images at (b, h, h):
    smooth gradients plus 0.002 noise, and the same quantised to uint8 / 255
    (flat neighbourhoods, where the variance cancels in fp32)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, h),
                         indexing="ij")
    smooth = np.stack([0.5 + 0.4 * np.sin(5 * xx + 3 * yy), yy,
                       0.3 + 0.5 * xx * yy], -1)[None]
    smooth = np.clip(smooth + 0.002 * np.random.RandomState(seed).randn(
        b, h, h, 3), 0, 1).astype(np.float32)
    return {"smooth": smooth,
            "uint8": (np.round(smooth * 255) / 255).astype(np.float32)}


@pytest.mark.parametrize("image", ["smooth", "uint8"])
@pytest.mark.parametrize("kind", ["w2_half", "reflect_pad", "biased_std",
                                  "fma_var"])
def test_affinity_bound_tells_wrong_twins(image, kind):
    """K3's card bound (1e-5 absolute, chip_smoke.py phase 7) tells each
    wrong twin of chip_smoke.py's ``par_affinity_wrong`` apart from the
    function on phase 7's images at 2 x 96^2: every one lies outside it."""
    from chip_smoke import par_affinity_wrong

    x = torch.from_numpy(_phase7_images(2, 96)[image])
    want = par_cuda.affinity_ref(x, DIL)
    err = (par_affinity_wrong(x, kind, DIL) - want).abs().max().item()
    assert err > 1e-5, (kind, image, err)


@pytest.mark.parametrize("dilations", [(1, 2, 4, 8, 12, 24, 48), (2, 64)],
                         ids=["seven", "two_to_64"])
def test_par_refine_past_the_kernel_cap_matches_jax(dilations):
    """Dilation sets past the shared-memory instantiations of K3 and K4 (7
    dilations; one of 64, past the halo of 40), which the card takes by
    their global-memory instantiations: the port's par_refine (CPU: the
    twins) against ``par_refine(use_pallas=False)``, 10 rounds, and K3's
    twin against the XLA ``rgb_affinity`` at the noise bounds and against
    ``affinity_pallas`` (interpret mode) at ``SMOOTH_ATOL``: the taps of 48
    and 64 reach past the 56^2 image and clamp onto its edges, so repeated
    values enter the variance, whose cancellation shows the summation order
    as on a smooth image (the Pallas kernel's order 4.6e-6 from the twin's
    at (2, 64), the twin 6.6e-7 from XLA's)."""
    assert not par_cuda.within_cap(dilations)
    imgs = _noise((1, 56, 56, 3), seed=10)
    masks = torch.softmax(torch.from_numpy(_noise((1, 56, 56, 6), seed=11))
                          * 4, -1)
    got = tpar.par_refine(torch.from_numpy(imgs), masks, dilations,
                          num_iter=10)
    want = jpar.par_refine(jnp.asarray(imgs), jnp.asarray(masks.numpy()),
                           dilations, num_iter=10, use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    aff = par_cuda.affinity_ref(torch.from_numpy(imgs), dilations).numpy()
    pallas = np.asarray(affinity_pallas(jnp.asarray(imgs), dilations,
                                        interpret=True))
    xla = np.moveaxis(np.asarray(jpar.rgb_affinity(jnp.asarray(imgs),
                                                   dilations)), -1, 1)
    assert aff.shape == pallas.shape == (1, 8 * len(dilations), 56, 56)
    np.testing.assert_allclose(aff, xla, rtol=RTOL, atol=ATOL)
    assert np.abs(aff - pallas).max() <= SMOOTH_ATOL
