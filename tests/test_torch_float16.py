"""float16 compute in the port against the JAX package: the GELUs of
``ops/gelu.py`` bit for bit against jitted ``jax.nn.gelu`` (both forms)
and their ``jax.vjp`` on every finite f16 input, PAR's f16 propagation
against ``propagate_pallas`` (interpret mode), and the f16 Mlp (both
GELUs, forward and input gradient), the tiny dual student (exact GELU, and
int8 on an f16 stream) and the pseudo-label factory at f16 against the JAX
package run un-jitted.

The jitted JAX model cannot run f16 on the CPU: XLA folds the attention's
f16 -> f32 converts into its dot, whose F16_F16_F32 form the CPU backend
refuses.  So the model-level comparisons call the JAX functions without
``jax.jit`` (their own jitted parts, ``jax.nn.gelu`` among them, still
compile as units), and the op-level ones the jitted functions, which run.
The jitted f16 GELUs' roundings are those of XLA's CPU code on an x86 host
with AVX512-FP16 (``ops/gelu.py``'s module docstring)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dupl_tpu.config import DataConfig as JDataConfig
from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.config import ParConfig as JParConfig
from dupl_tpu.config import voc_config as j_voc_config
from dupl_tpu.data.pipeline import synthetic_batch
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.engine.export import make_pseudo_label_fn as j_make_pseudo_label_fn
from dupl_tpu.engine.train import Trainer as JTrainer
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu.models.vit import Mlp as JMlp
from dupl_tpu.ops.par_pallas import propagate_pallas
from dupl_tpu_torch.config import DataConfig, ModelConfig, ParConfig, voc_config
from dupl_tpu_torch.engine.export import make_pseudo_label_fn
from dupl_tpu_torch.models.convert import init_weights, state_dict_to_jax
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.models.vit import Mlp
from dupl_tpu_torch.ops import gelu, par_cuda

torch.set_num_threads(2)
F16 = torch.float16
TINY, CROP = "test_tiny_patch16", 64
DIL = (1, 2, 4, 8, 12, 24)


def _finite_f16():
    """Every finite f16 value (63,488 of them)."""
    bits = np.arange(65536, dtype=np.uint16).view(np.float16)
    return bits[np.isfinite(bits)]


def _cotangent(n, seed=0):
    """A seeded f16 cotangent grid: magnitudes 2^U(-24, 15) (subnormals to
    ~2^15) times U(1, 2), random signs, and ±0, ±inf, NaN among them."""
    rs = np.random.RandomState(seed)
    g = (np.exp2(rs.uniform(-24, 15, n)) * rs.uniform(1, 2, n)
         * np.where(rs.rand(n) < 0.5, -1, 1))
    g[::4096] = 0.0
    g[1::4096] = -0.0
    g[2::8192], g[3::8192], g[4::8192] = np.inf, -np.inf, np.nan
    return g.astype(np.float16)


def _unequal(got, want):
    """Elements of two f16 arrays whose bits differ, NaNs equal."""
    got, want = np.asarray(got, np.float16), np.asarray(want, np.float16)
    same = got.view(np.uint16) == want.view(np.uint16)
    return ~(same | (np.isnan(got) & np.isnan(want)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


_J_TANH = jax.jit(partial(jax.nn.gelu, approximate=True))
_J_ERF = jax.jit(partial(jax.nn.gelu, approximate=False))
_J_ERF_VJP = jax.jit(lambda x, g: jax.vjp(_J_ERF, x)[1](g)[0])
_J_TANH_VJP = jax.jit(lambda x, g: jax.vjp(_J_TANH, x)[1](g)[0])


@pytest.fixture(scope="module")
def jax_gelus():
    """The jitted JAX GELUs and their VJPs on every finite f16 x."""
    x = _finite_f16()
    g = _cotangent(x.size)
    xj, gj = jnp.asarray(x), jnp.asarray(g)
    return x, g, {"tanh": np.asarray(_J_TANH(xj)),
                  "erf": np.asarray(_J_ERF(xj)),
                  "erf_vjp": np.asarray(_J_ERF_VJP(xj, gj)),
                  "tanh_vjp": np.asarray(_J_TANH_VJP(xj, gj))}


def _grad(fn, x, g):
    """The input gradient of ``fn`` at ``x`` for the cotangent ``g``."""
    x = x.clone().requires_grad_(True)
    return torch.autograd.grad(fn(x), x, g)[0]


@pytest.mark.parametrize("fn", ["tanh", "erf", "erf_vjp", "tanh_vjp"])
def test_gelus_bit_equal_to_jitted_jax(jax_gelus, fn):
    """``gelu_tanh``, ``gelu_erf_ref``, ``gelu_erf_bwd_ref`` and the
    backward of ``gelu_tanh`` (autograd) on every finite f16 x (the VJPs
    with the seeded cotangent grid): 0 unequal, f16 subnormals included
    (XLA's f16 arithmetic keeps them, as the twins do).  Before the f16
    recipe, ``gelu_tanh`` (nine f16 operations with ``torch.tanh``)
    differed on 46 of these x, by 1 to 264 ulps, and its autograd backward
    on 10,419."""
    x, g, want = jax_gelus
    xt = _t(x)
    got = {"tanh": lambda: gelu.gelu_tanh(xt),
           "erf": lambda: gelu.gelu_erf_ref(xt),
           "erf_vjp": lambda: gelu.gelu_erf_bwd_ref(xt, _t(g)),
           "tanh_vjp": lambda: _grad(gelu.gelu_tanh, xt, _t(g))}[fn]()
    assert got.dtype == F16
    assert not _unequal(got.numpy(), want[fn]).any()


def _wrong(kind, x, g):
    """Wrong f16 twins: kernel G's of ``chip_smoke.gelu_f16_wrong`` (the
    f32 GELU rounded once; the erfc of the unrounded f32 ``-x s``, bf16's
    recipe; the VJP's last product and sum rounded on their own), the tanh
    GELU's cubic without its FMA, the former tanh GELU (``torch.tanh`` on
    f16) and its autograd backward, and the tanh GELU's VJP with each of its
    three FMAs rounded as a product and a sum."""
    from chip_smoke import gelu_f16_wrong, gelu_tanh_f16_nine_ops

    c = partial(torch.tensor, dtype=F16)
    if kind == "tanh_vjp_torch":
        return _grad(partial(_wrong, "tanh_torch", g=None), x, g)
    if kind == "tanh_vjp_no_fma":
        xx, t = gelu._tanh_f16(x)
        d = ((x * g) * 0.5) * (1.0 - t)
        d = d + d * t
        dx = g * ((t + 1.0) * 0.5) + d * gelu._TANH_F16_S
        return dx + (d * gelu._TANH_F16_CS) * (xx * 3.0)
    if kind == "tanh_no_fma":
        v = (x + ((x * x) * x) * c(0.044715)) * c(0.7978845608)
        return x * ((gelu._tanh_xla(v.float()).half() + c(1.0)) * c(0.5))
    if kind == "tanh_torch":
        return gelu_tanh_f16_nine_ops(x)
    return gelu_f16_wrong(x, kind, g)


@pytest.mark.parametrize("kind,fn,least", [
    ("one_rounding", "erf", 5000), ("z_unrounded", "erf", 100),
    ("bwd_no_fma", "erf_vjp", 100), ("tanh_no_fma", "tanh", 10),
    ("tanh_torch", "tanh", 10), ("tanh_vjp_torch", "tanh_vjp", 5000),
    ("tanh_vjp_no_fma", "tanh_vjp", 3000)])
def test_wrong_twins_differ(jax_gelus, kind, fn, least):
    """Each wrong twin of :func:`_wrong` differs from the jitted function
    on at least ``least`` finite f16 inputs."""
    x, g, want = jax_gelus
    got = _wrong(kind, _t(x), _t(g)).numpy()
    assert _unequal(got, want[fn]).sum() >= least


# ---------------------------------------------------------- the f16 Mlp
# Error over the output's (or the input gradient's) largest magnitude,
# (max, mean).  Both GELUs and their VJPs give the JAX package's bits; the
# f16 products differ in their last bits (the port's CPU matmul and XLA's
# sum in other orders), which the GELU and fc2 carry.  Read: exact GELU
# forward 0 / 0 (bit-equal on these inputs), input gradient 6.8e-4 /
# 4.4e-5; tanh GELU forward 1.5e-4 / 4.7e-6, input gradient 6.8e-4 /
# 1.2e-4.
MLP_REL = (2e-3, 2e-4)


@pytest.mark.parametrize("approximate", [False, True])
def test_mlp_f16_matches_jax(approximate):
    """The f16 Mlp with the exact GELU (G's f16 mode) or the tanh GELU
    against the JAX Mlp applied without jit, forward and the input gradient
    (``jax.vjp``: the jitted GELU's VJP, its f16 FMAs included)."""
    rs = np.random.RandomState(0)
    dim, hidden = 32, 128
    jm = JMlp(hidden, dim, dtype=jnp.float16, gelu_approximate=approximate)
    x = rs.randn(2, 9, dim).astype(np.float32)
    params = jax.tree.map(
        lambda a: np.asarray(rs.randn(*a.shape) * 0.2, np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), x))
    g = rs.randn(2, 9, dim).astype(np.float16)
    x16 = x.astype(np.float16)
    y, vjp = jax.vjp(lambda z: jm.apply(params, z), jnp.asarray(x16))
    (dx,) = vjp(jnp.asarray(g))
    tm = Mlp(dim, hidden, F16, gelu_approximate=approximate)
    p = params["params"]
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(tm, name).weight.copy_(_t(p[name]["kernel"].T))
            getattr(tm, name).bias.copy_(_t(p[name]["bias"]))
    xt = _t(x16).requires_grad_(True)
    yt = tm(xt)
    yt.backward(_t(g))
    assert yt.dtype == xt.grad.dtype == F16
    for got, want in ((yt.detach(), y), (xt.grad, dx)):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want) / np.abs(want).max()
        assert err.max() <= MLP_REL[0] and err.mean() <= MLP_REL[1], (
            err.max(), err.mean())


# ------------------------------------------------- the tiny dual student
@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded random weights of the tiny dual student: the port's
    ``init_weights``, written as the JAX package's weights file and read
    into its parameter tree (``jax.eval_shape`` of its init: no compile)."""
    cfg = voc_config(model=ModelConfig(backbone=TINY),
                     data=DataConfig(crop_size=CROP))
    net = DualStudent(cfg.model)
    init_weights(net, torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    np.savez(path, **state_dict_to_jax(net.state_dict()))
    jmodel = JDualStudent(JModelConfig(backbone=TINY))
    template = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, CROP, CROP, 3), jnp.float32))
    return net.state_dict(), ckpt.load_weights(path, template)


def _pair(sd, **model):
    m = dict(backbone=TINY, compute_dtype="float16", **model)
    net = DualStudent(voc_config(model=ModelConfig(**m)).model)
    net.load_state_dict(sd)
    return net.eval(), JDualStudent(JModelConfig(**m))


# Error over each output's largest magnitude, (max, mean), over seg, cls
# and both CAMs.  Exact GELU: both sides round the GELU alike; the f16
# products, the attention (bf16 on both sides) and the fp32 LayerNorms sum
# in other orders.  Read: 8.2e-4 / 8.7e-5 at the worst.  int8 on an f16
# stream: the bounds of tests/test_torch_quant.py's fp32 int8 comparison
# (read 2.2e-3 / 2.2e-5): a value that rounds to the next int8 level moves
# its product by a 127th of its row's scale.
MODEL_REL = {"erf": (3e-3, 5e-4), "int8": (2e-2, 1e-3)}


@pytest.mark.parametrize("path", ["erf", "int8"])
def test_dual_student_f16_matches_jax(weights, path):
    """``compute_dtype="float16"`` with the exact GELU, and the int8 path on
    an f16 stream (``ops/quant.py`` casts to f32, as ``QDense`` does),
    against the JAX dual student applied without jit on the same seeded
    weights and images."""
    sd, params = weights
    net, jmodel = _pair(sd, quantized_inference=path == "int8")
    x = np.random.RandomState(1).randn(2, CROP, CROP, 3).astype(np.float32)
    out = jmodel.apply(params, jnp.asarray(x))
    jcam = jmodel.cam_only(params, jnp.asarray(x))
    with torch.no_grad():
        got = net(_t(x))
        cam = net.cam_only(_t(x))
    pairs = [(got.seg, out.seg), (got.cls, out.cls), (cam[0], jcam[0]),
             (cam[1], jcam[1])]
    for t, j in pairs:
        j = np.asarray(jnp.asarray(j).astype(jnp.float32))
        t = t.float().numpy()
        assert t.shape == j.shape and np.isfinite(t).all()
        err = np.abs(t - j) / np.abs(j).max()
        bound = MODEL_REL[path]
        assert err.max() <= bound[0] and err.mean() <= bound[1], (
            err.max(), err.mean())


# --------------------------------------------------------------- PAR f16
def test_propagate_ref_f16_matches_pallas():
    """PAR's f16 mode on the peaked posteriors of
    ``tests/test_torch_par.py``'s bf16 test: the twin rounds every product
    and partial sum of a group of 8 taps to f16, as ``_kernel``'s
    operations say; XLA's CPU compiles the interpret-mode kernel with f16
    FMAs for some of them, so the two are not bit-equal: after one round
    they differ by at most one f16 ulp of 1 (read 9.8e-4, 34% equal), after
    ten by 1.95e-3 (q99.9 8.2e-4), against the fp32 twin by 4.7e-3 (q99.9
    1.6e-3).  Bounds well inside the bf16 test's (q99.9 0.02, max 0.08,
    argmax 99.5%)."""
    rs = np.random.RandomState(6)
    b, h, w, c = 2, 48, 48, 21
    region = (np.add.outer(np.arange(h) // 16, np.arange(w) // 16) % c)
    logits = rs.rand(b, h, w, c).astype(np.float32) * 2
    for bi in range(b):
        logits[bi, np.arange(h)[:, None], np.arange(w)[None, :], region] += 4.0
    masks = torch.softmax(_t(logits), dim=-1)
    aff = par_cuda.affinity_ref(_t(np.random.RandomState(7).rand(
        b, h, w, 3).astype(np.float32)), DIL)

    def pallas(iters):
        return np.asarray(propagate_pallas(
            jnp.asarray(masks.numpy()), jnp.asarray(aff.numpy()), DIL, iters,
            compute_dtype="float16", interpret=True, aff_layout="bkhw"))

    one = par_cuda.propagate_ref(masks, aff, DIL, 1, compute_dtype="float16")
    assert np.abs(one.numpy() - pallas(1)).max() <= 2.0 ** -10
    got = par_cuda.propagate_ref(masks, aff, DIL, 10,
                                 compute_dtype="float16").numpy()
    f32 = par_cuda.propagate_ref(masks, aff, DIL, 10).numpy()
    for ref, (q, top) in ((pallas(10), (2e-3, 5e-3)), (f32, (4e-3, 1e-2))):
        err = np.abs(got - ref)
        assert np.quantile(err, 0.999) < q and err.max() < top
        assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.999


# ------------------------------------------------ the pseudo-label factory
def test_pseudo_label_fn_f16_matches_jax(weights):
    """``make_pseudo_label_fn`` at f16 (the model's compute and PAR's
    propagation; one CAM scale to keep the un-jitted JAX run short) against
    the JAX factory called without jit.  The JAX package's CPU PAR is its
    XLA route, whose affinity also rounds to f16; the port's is the Pallas
    route's (fp32 affinity, f16 propagation).  Refined labels (each branch)
    agree on at least 99.5% of the pixels (read 99.94%, 99.93%), the CRF's
    on 99% (read 99.61%), and each on at least 95% of the pixels that
    either side does not ignore (read 99.2%, 96.8%, 99.6%)."""
    sd, params = weights
    kw = dict(backbone=TINY, compute_dtype="float16")
    over = dict(cam_scales=(1.0,))
    tcfg = voc_config(model=ModelConfig(**kw), data=DataConfig(crop_size=CROP),
                      par=ParConfig(compute_dtype="float16"), **over)
    jcfg = j_voc_config(model=JModelConfig(**kw),
                        data=JDataConfig(crop_size=CROP),
                        par=JParConfig(compute_dtype="float16"), **over)
    net = DualStudent(tcfg.model)
    net.load_state_dict(sd)
    batch = synthetic_batch(2, crop=CROP, num_fg=20)
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    images = np.round(np.clip(batch["image"] * std + mean, 0, 1)
                      * 255).astype(np.uint8)
    args = (images, batch["cls_label"], batch["img_box"])
    j_ref, j_crf = map(np.asarray, j_make_pseudo_label_fn(
        jcfg, JTrainer(jcfg))(params, *map(jnp.asarray, args)))
    t_ref, t_crf = make_pseudo_label_fn(tcfg, net.eval())(*map(_t, args))
    assert t_ref.shape == j_ref.shape == (2, 2, CROP, CROP)
    ign = tcfg.ignore_index
    for got, want, share in [(t_ref[0], j_ref[0], 0.995),
                             (t_ref[1], j_ref[1], 0.995),
                             (t_crf, j_crf, 0.99)]:
        got = got.numpy()
        assert (got == want).mean() >= share
        kept = (got != ign) | (want != ign)
        assert kept.any() and (got == want)[kept].mean() >= 0.95
