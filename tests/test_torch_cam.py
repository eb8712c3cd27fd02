"""Port parity: dupl_tpu_torch.ops.cam, the CAM heads of
dupl_tpu_torch.models.network and the leftovers of dupl_tpu_torch.ops.image
against their dupl_tpu counterparts, on the same numpy inputs and the same
weights (the tiny ViT through the weight bridge; CPU, float32)."""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu.models.network import Student as JStudent
from dupl_tpu.ops import cam as jcam
from dupl_tpu.ops import image as jimg
from dupl_tpu.ops import par as jpar
from dupl_tpu_torch.config import ModelConfig
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import cam as tcam
from dupl_tpu_torch.ops import image as timg
from dupl_tpu_torch.ops import par as tpar

torch.set_num_threads(2)
_KW = dict(backbone="test_tiny_patch16", compute_dtype="float32")
# Model outputs agree to 1e-4 at magnitudes ~1-10 (fp32 summation order,
# tests/test_torch_models.py); min-max normalised CAMs lie in [0, 1].
CAM_ATOL = 1e-4


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """JAX-initialised tiny dual student and the port loaded from its
    exported weights."""
    jmodel = JDualStudent(JModelConfig(**_KW))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    model = DualStudent(ModelConfig(**_KW))
    model.load_state_dict(load_weights(path))
    return jmodel, params, model.eval()


def _close(t, j, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def _boxes(b, h, w):
    return np.asarray([[2, h - 3, 1, w - 4], [0, h, 0, w], [5, h // 2, 3, w],
                       [0, h - 1, w // 3, w - 2]][:b], np.int32)


# -- image leftovers -----------------------------------------------------------

def test_box_mask_scale_box_and_minmax_norm():
    box = _boxes(4, 20, 24)
    np.testing.assert_array_equal(
        timg.box_mask(torch.from_numpy(box), 20, 24).numpy(),
        np.asarray(jimg.box_mask(jnp.asarray(box), 20, 24)))
    np.testing.assert_array_equal(
        timg.scale_box(torch.from_numpy(box), 3, 7).numpy(),
        np.asarray(jimg.scale_box(jnp.asarray(box), 3, 7)))
    cam = np.random.RandomState(0).randn(2, 3, 9, 11, 5).astype(np.float32)
    cam[0, 0, ..., 1] = 0.25                       # a flat plane: eps matters
    _close(timg.spatial_minmax_norm(torch.from_numpy(cam)),
           jimg.spatial_minmax_norm(jnp.asarray(cam)), 1e-6)


# -- label banding ---------------------------------------------------------------

@pytest.mark.parametrize("high", ["scalar", "per_sample"])
@pytest.mark.parametrize("ignore_mid,with_box", [(True, True), (False, False)])
def test_cam_to_label_matches_jax(high, ignore_mid, with_box):
    rs = np.random.RandomState(1)
    b, h, w, c = 4, 12, 14, 6
    cam = rs.rand(b, h, w, c).astype(np.float32)
    cls = (rs.rand(b, c) > 0.5).astype(np.float32)
    cls[:, 0] = 1
    high_thre = (0.7 if high == "scalar"
                 else rs.uniform(0.55, 0.8, b).astype(np.float32))
    box = _boxes(b, h, w) if with_box else None
    kw = dict(bkg_thre=0.5, ignore_mid=ignore_mid, low_thre=0.25,
              ignore_index=255)
    tv, tl = tcam.cam_to_label(
        torch.from_numpy(cam), torch.from_numpy(cls),
        img_box=None if box is None else torch.from_numpy(box),
        high_thre=(torch.from_numpy(high_thre) if high != "scalar"
                   else high_thre), **kw)
    jv, jl = jcam.cam_to_label(jnp.asarray(cam), jnp.asarray(cls),
                               img_box=None if box is None else jnp.asarray(box),
                               high_thre=high_thre, **kw)
    _close(tv, jv, 0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert set(np.unique(tl.numpy())) > {0}


def test_label_to_aff_mask_matches_jax():
    lab = np.random.RandomState(2).choice([0, 1, 3, 255], (2, 5, 6)).astype(
        np.int32)
    got = tcam.label_to_aff_mask(torch.from_numpy(lab).long())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcam.label_to_aff_mask(lab)))


# -- CAM heads and multi-scale fusion ----------------------------------------------

def _image(b, size, seed=3):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(
        np.float32)


def test_cam_only_and_forward_with_cams_match_jax(bridged):
    """``Student.cam_only`` / ``forward_with_cams`` per branch and the
    branch-stacked ``DualStudent`` counterparts."""
    jmodel, params, model = bridged
    x = _image(2, 48)
    with torch.no_grad():
        t_cams = model.cam_only(torch.from_numpy(x))
        t_out, *t_fc = model.forward_with_cams(torch.from_numpy(x))
        t_fwd = model(torch.from_numpy(x))
    j_cams = jmodel.cam_only(params, jnp.asarray(x))
    j_out, *j_fc = jax.vmap(lambda p: jmodel.module.apply(
        p, jnp.asarray(x), method=JStudent.forward_with_cams))(params)
    assert t_cams[0].shape == (2, 2, 3, 3, 20)
    for t, j in zip((*t_cams, *t_fc), (*j_cams, *j_fc)):
        _close(t, j, CAM_ATOL)
    for name in t_out._fields:
        _close(getattr(t_out, name), getattr(j_out, name), CAM_ATOL)
        torch.testing.assert_close(getattr(t_out, name), getattr(t_fwd, name),
                                   rtol=0, atol=0)
    assert not t_cams[0].requires_grad


def _student_fns(jmodel, params, model, i):
    pb = jmodel.branch(params, i)
    s = model.student(i)

    def j_full(z):
        return jmodel.module.apply(pb, z, method=JStudent.forward_with_cams)

    def j_cam(z):
        return jmodel.module.apply(pb, z, method=JStudent.cam_only)

    return j_full, j_cam, s.forward_with_cams, s.cam_only


@pytest.mark.parametrize("merge", [None, (16, 16)])
def test_multi_scale_cam_matches_jax(bridged, merge):
    jmodel, params, model = bridged
    x = _image(2, 32)
    _, j_cam, _, t_cam = _student_fns(jmodel, params, model, 1)
    with torch.no_grad():
        got = tcam.multi_scale_cam(t_cam, torch.from_numpy(x),
                                   (1.0, 0.5, 1.5), merge_size=merge)
    want = jcam.multi_scale_cam(j_cam, jnp.asarray(x), (1.0, 0.5, 1.5),
                                merge_size=merge)
    for t, j in zip(got, want):
        assert t.shape == j.shape
        _close(t, j, CAM_ATOL)


@pytest.mark.parametrize("with_aux,merge,split_flip", [
    (True, None, False), (False, (16, 16), False), (True, (16, 16), True)])
def test_multi_scale_cam_with_outputs_matches_jax(bridged, with_aux, merge,
                                                  split_flip):
    jmodel, params, model = bridged
    x = _image(2, 32, seed=4)
    j_full, j_cam, t_full, t_cam = _student_fns(jmodel, params, model, 0)
    kw = dict(with_aux=with_aux, merge_size=merge, split_flip=split_flip)
    with torch.no_grad():
        tc, ta, tout = tcam.multi_scale_cam_with_outputs(
            t_full, t_cam, torch.from_numpy(x), (1.0, 0.5, 1.5), **kw)
    jc, ja, jout = jcam.multi_scale_cam_with_outputs(
        j_full, j_cam, jnp.asarray(x), (1.0, 0.5, 1.5), **kw)
    _close(tc, jc, CAM_ATOL)
    assert (ta is None) == (ja is None) == (not with_aux)
    if with_aux:
        _close(ta, ja, CAM_ATOL)
    for name in tout._fields:
        assert getattr(tout, name).shape[0] == 2
        _close(getattr(tout, name), getattr(jout, name), CAM_ATOL)


# -- PAR refinement into pseudo-labels ------------------------------------------------

DIL = (1, 2, 4, 8, 12, 24)


def _refine_inputs(v, fallback, seed=5):
    """Peaked CAMs over 2 images of 32 x 40 (refined at 16 x 20), masked by
    the class labels.  ``fallback`` gives image 1 eleven present classes, so
    a class budget of 10 takes the full class axis."""
    rs = np.random.RandomState(seed)
    b, h, w, c = 2, 32, 40, 20
    cls = np.zeros((b, c), np.float32)
    cls[0, [2, 7, 11]] = 1
    cls[1, [0, 5]] = 1
    if fallback:
        cls[1, :11] = 1
    yy, xx = np.mgrid[0:h, 0:w]
    cams = rs.rand(v, b, h, w, c).astype(np.float32) * 0.3
    for k in range(c):   # each class peaks in its own blob
        cams[..., k] += np.exp(-((yy - 4 - 3 * (k % 8)) ** 2
                                 + (xx - 5 - 2 * k) ** 2) / 400.0)
    cams = (cams / cams.max(axis=(2, 3), keepdims=True)) * cls[None, :, None,
                                                               None, :]
    images = rs.rand(b, h, w, 3).astype(np.float32)
    return images, cams, cls, _boxes(b, h, w)


@pytest.mark.parametrize("v", [1, 2])
@pytest.mark.parametrize("budget,fallback", [(None, False), (10, False),
                                             (10, True)])
def test_refine_cams_with_bkg_matches_jax(v, budget, fallback):
    """Labels against JAX's (``par_refine(use_pallas=False)``): the two
    PAR formulations differ by fp32 ulps, so an argmax near a tie may flip;
    at least 99.9% of labels are equal (measured: all)."""
    images, cams, cls, box = _refine_inputs(v, fallback)
    if v == 1:
        cams = cams[0]
    kw = dict(high_thre=0.55, low_thre=0.25, ignore_index=255, down_scale=2,
              class_budget=budget)
    got = tcam.refine_cams_with_bkg(
        functools.partial(tpar.par_refine, dilations=DIL, num_iter=10),
        torch.from_numpy(images), torch.from_numpy(cams),
        torch.from_numpy(cls), img_box=torch.from_numpy(box), **kw)
    want = np.asarray(jcam.refine_cams_with_bkg(
        lambda i, m: jpar.par_refine(i, m, DIL, 10, use_pallas=False),
        jnp.asarray(images), jnp.asarray(cams), jnp.asarray(cls),
        img_box=jnp.asarray(box), **kw))
    assert got.shape == want.shape == cams.shape[:-1]
    assert (got.numpy() == want).mean() >= 0.999
    labels = set(np.unique(want).tolist())
    assert 255 in labels                     # the ignore band
    assert labels - {0, 255} <= {k + 1 for k in np.flatnonzero(cls.any(0))}
    assert len(labels - {0, 255}) >= 4      # several present classes won


def test_refine_with_budget_equals_full_axis():
    """The class-budget compaction is exact: the same labels as the full
    class axis (port only, both on the CPU twins)."""
    images, cams, cls, box = _refine_inputs(2, False, seed=6)
    args = (functools.partial(tpar.par_refine, dilations=DIL, num_iter=10),
            torch.from_numpy(images), torch.from_numpy(cams),
            torch.from_numpy(cls))
    kw = dict(high_thre=torch.tensor([0.6, 0.5]), low_thre=0.25,
              img_box=torch.from_numpy(box))
    full = tcam.refine_cams_with_bkg(*args, class_budget=None, **kw)
    compact = tcam.refine_cams_with_bkg(*args, class_budget=4, **kw)
    torch.testing.assert_close(compact, full, rtol=0, atol=0)


def test_fits_class_budget_decides_the_branch():
    """The host-side budget decision: background plus present classes must
    fit the slots.  A caller's answer is used as given, and either branch
    gives the same labels where the budget fits (compaction is exact)."""
    cls = torch.zeros(2, 20)
    cls[0, :9] = 1                          # 9 + background = 10 slots
    assert tcam.fits_class_budget(cls, 10)
    assert not tcam.fits_class_budget(cls, 9)
    assert not tcam.fits_class_budget(cls, None)
    cls[1, :10] = 1                         # 11 slots
    assert not tcam.fits_class_budget(cls, 10)

    images, cams, cls_np, box = _refine_inputs(2, False, seed=7)
    args = (functools.partial(tpar.par_refine, dilations=DIL, num_iter=10),
            torch.from_numpy(images), torch.from_numpy(cams),
            torch.from_numpy(cls_np))
    kw = dict(high_thre=0.55, low_thre=0.25, img_box=torch.from_numpy(box),
              class_budget=4)
    assert tcam.fits_class_budget(args[3], 4)
    decided = tcam.refine_cams_with_bkg(*args, **kw)
    compact = tcam.refine_cams_with_bkg(*args, fits_budget=True, **kw)
    full = tcam.refine_cams_with_bkg(*args, fits_budget=False, **kw)
    torch.testing.assert_close(compact, decided, rtol=0, atol=0)
    torch.testing.assert_close(full, decided, rtol=0, atol=0)
