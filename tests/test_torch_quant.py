"""The int8 inference path (``dupl_tpu_torch/ops/quant.py``, kernels Q1 and
Q2's plain twins) against the jitted JAX package
(``dupl_tpu/ops/quant.py:quantized_matmul``, ``QDense(quant=True)``): the
quantization of both operands (and of fc2's input through the GELU) and
the product bit for bit, wrong twins that are not, the int8 ``Mlp`` bit for
bit with either GELU, one Q1 call a product and no GELU op between fc1
and fc2, the ``quantized_inference`` dual student against the JAX one on
the same weights, ``tools/bench_components_torch.py --int8``, the sealed
int8 serving program, Q1's two passes (any row width) composed against its
one-launch twin, and the refusal of training."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dupl_tpu.config import DataConfig as JDataConfig
from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.config import voc_config as j_voc_config
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu.models.vit import Mlp as JMlp
from dupl_tpu.ops.quant import quantized_matmul as j_quantized_matmul
from dupl_tpu_torch.config import DataConfig, ModelConfig, voc_config
from dupl_tpu_torch.engine import export
from dupl_tpu_torch.engine.train import Trainer
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.models.vit import Mlp
from dupl_tpu_torch.ops import quant
from dupl_tpu_torch.utils import flops

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TINY = "test_tiny_patch16"
CROP = 64

_J_QMM = jax.jit(j_quantized_matmul)
_J_QMM_BIAS = jax.jit(lambda x, w, b: j_quantized_matmul(x, w) + b)


def _quantize(x):
    """The activation quantization of ``dupl_tpu/ops/quant.py:36-38``:
    (x8, s_a)."""
    x2 = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    s_a = jnp.max(jnp.abs(x2), axis=1, keepdims=True) / 127.0
    s_a = jnp.maximum(s_a, 1e-8)
    return jnp.clip(jnp.round(x2 / s_a), -127, 127).astype(jnp.int8), s_a


_j_quantize = jax.jit(_quantize)
# fc2's input: the GELU of fc1's fp32 output, then its quantization, in one
# jitted function as the JAX Mlp runs them
_J_GELU_QUANTIZE = {a: jax.jit(lambda h, a=a: _quantize(jax.nn.gelu(
    h, approximate=a))) for a in (True, False)}
_J_GELU_QMM_BIAS = {a: jax.jit(lambda h, w, b, a=a: j_quantized_matmul(
    jax.nn.gelu(h, approximate=a), w) + b) for a in (True, False)}


# (M, K, N): ragged M, K a multiple of 32 as the card's kernels take it;
# one row, 63 rows, K 96, and the widths of ViT-B's products (768, 3072)
SHAPES = [(50, 64, 96), (130, 128, 32), (257, 256, 64), (1, 768, 64),
          (63, 3072, 32), (70, 96, 40)]


def _operands(m, k, n, dtype, seed=0):
    """x (M, K) with a zero row past M 3 (the 1e-8 floor) and rows of
    other scales, in ``dtype``; w (K, N) fp32 as JAX holds it; bias
    (N,)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype(np.float32) * rs.uniform(0.1, 4, (m, 1))
    if m > 3:
        x[3] = 0.0
    x = x.astype(np.float32)
    w = (rs.randn(k, n) * 0.05).astype(np.float32)
    w[:, 5] = 0.0                                   # a zero weight column
    b = rs.randn(n).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    return xj, xt, w, b


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bit_equal_to_jitted_jax(shape, dtype):
    """quantize_pair (the activations, bf16 or fp32, and the fp32 weight as
    nn.Linear's (N, K)), gelu_quantize_pair (fc2's fp32 input through
    either GELU) and quantized_matmul with and without the GELU and the
    bias equal the jitted JAX functions bit for bit."""
    m, k, n = shape
    xj, xt, w, b = _operands(m, k, n, dtype)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    q, s, qw, sw = quant.quantize_pair(xt, wt)
    jq, js = _j_quantize(xj)
    assert q.dtype == torch.int8 and s.shape == (m, 1)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    if m > 3:
        assert s[3].item() == np.float32(1e-8) and not q[3].any()
    jqw, jsw = _j_quantize(jnp.asarray(w.T))
    assert np.array_equal(qw.numpy(), np.asarray(jqw))
    assert np.array_equal(sw.numpy(), np.asarray(jsw))
    got = quant.quantized_matmul(xt, wt)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(_J_QMM(xj, jnp.asarray(w))))
    got = quant.quantized_matmul(xt[None], wt, torch.from_numpy(b))[0]
    want = _J_QMM_BIAS(xj, jnp.asarray(w), jnp.asarray(b))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # fc2's entry: h is fc1's fp32 output (here the draws in fp32)
    h, hj = xt.float(), xj.astype(jnp.float32)
    for approximate in (True, False):
        gq, gs, gqw, gsw = quant.gelu_quantize_pair(h, wt, approximate)
        jgq, jgs = _J_GELU_QUANTIZE[approximate](hj)
        assert np.array_equal(gq.numpy(), np.asarray(jgq))
        assert np.array_equal(gs.numpy(), np.asarray(jgs))
        assert torch.equal(gqw, qw) and torch.equal(gsw, sw)
        got = quant.quantized_matmul(
            h, wt, torch.from_numpy(b),
            gelu="tanh" if approximate else "erf")
        want = _J_GELU_QMM_BIAS[approximate](hj, jnp.asarray(w),
                                             jnp.asarray(b))
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_rows_past_the_cap_are_refused(dtype):
    """Rows past Q1's one-launch cap (24,576 bytes, :data:`quant.MAX_ROW_BYTES`),
    which it refused until its two-pass entries took them: K 8192 in fp32
    and 16,384 in bf16 (32 kB rows).  ``quantized_matmul`` with and without
    the bias, and the product of each GELU of fp32 h (K 16,384 in fp32 for
    the bf16 case: 64 kB rows), equal the jitted JAX functions bit for bit;
    the one-launch op itself still refuses such rows (its kernel holds 24,576
    bytes a row), so they take ``row_absmax_pair`` and
    ``quantize_pair_given``; and a K off the multiple of 8, or a GELU input
    that is not fp32, is refused."""
    k = 8192 if dtype == jnp.float32 else 16_384
    xj, xt, w, b = _operands(6, k, 16, dtype, seed=7)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    assert not quant._one_launch(xt, wt)
    with pytest.raises(ValueError, match="one-launch"):
        torch.ops.dupl.quantize_pair(xt, wt)
    got = quant.quantized_matmul(xt, wt)
    assert np.array_equal(got.numpy(), np.asarray(_J_QMM(xj, jnp.asarray(w))))
    got = quant.quantized_matmul(xt, wt, torch.from_numpy(b))
    want = _J_QMM_BIAS(xj, jnp.asarray(w), jnp.asarray(b))
    assert np.array_equal(got.numpy(), np.asarray(want))
    h, hj = xt.float(), xj.astype(jnp.float32)
    for approximate in (True, False):
        got = quant.quantized_matmul(h, wt, torch.from_numpy(b),
                                     gelu="tanh" if approximate else "erf")
        want = _J_GELU_QMM_BIAS[approximate](hj, jnp.asarray(w),
                                             jnp.asarray(b))
        assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(TypeError, match="float32"):
        quant.gelu_quantize_pair(torch.randn(3, 64).bfloat16(),
                                 torch.randn(4, 64), True)
    with pytest.raises(ValueError, match="multiple of 8"):
        quant.quantize_pair(torch.randn(3, 60), torch.randn(4, 60))


@pytest.mark.parametrize("dtype,gelu", [(torch.bfloat16, None),
                                        (torch.float32, None),
                                        (torch.float32, "tanh"),
                                        (torch.float32, "erf")],
                         ids=["bf16", "fp32", "fp32-tanh", "fp32-erf"])
def test_two_passes_compose_to_the_one_launch_twin(dtype, gelu):
    """Q1's two-pass twins (``row_absmax_pair_ref``, then
    ``quantize_pair_given_ref`` on those maxima) give
    ``quantize_rows_ref``'s bits (through the GELU with ``gelu``: fp32 x
    only), at a width the one-launch entry holds and one past it, with a
    zero row (the 1e-8 floor); maxima raised above a row's own give that
    row other scales (what a model group's all-reduced maxima do)."""
    rs = np.random.RandomState(5)
    for k in (96, 13_000 if dtype == torch.float32 else 16_000):
        x = torch.from_numpy(rs.randn(9, k).astype(np.float32)
                             * rs.uniform(0.1, 4, (9, 1))).to(dtype)
        x[4] = 0
        w = torch.from_numpy(rs.randn(5, k).astype(np.float32) * 0.05)
        amax = quant.row_absmax_pair(x, w, gelu)
        assert [a.shape for a in amax] == [(9,), (5,)]
        got = quant.quantize_pair_given(x, w, *amax, gelu)
        g = x if gelu is None else quant._gelu_of(x, gelu)
        want = quant.quantize_pair_ref(g, w)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        if gelu is None:
            assert all(torch.equal(a, b) for a, b in zip(
                quant.quantize_pair(x, w), want))
        raised = quant.quantize_pair_given(x, w, amax[0] * 2, amax[1], gelu)
        live = torch.arange(9) != 4          # the zero row keeps the floor
        assert torch.equal(raised[1][live], want[1][live] * 2)
        assert not torch.equal(raised[0], want[0])


@pytest.mark.parametrize("kind", ["divide_by_127", "rescale_once",
                                  "last_k_tile_dropped", "k_stage_read_twice",
                                  "row_scale_shifted", "n_tiles_swapped",
                                  "scale_one_ulp_off", "max_over_half_row",
                                  "tanhf"])
def test_wrong_twins_are_not_bit_equal(kind):
    """At M 1000, K 768, N 256 in bf16, each wrong twin of
    ``chip_smoke.quant_wrong`` (the ones phase 30 holds on the card: the
    JAX source read literally; Q2's own faults: a K stage read twice, the
    row scales of 8-row halves exchanged, two 128-column output tiles
    exchanged; Q1's: the scale one ulp off, the maximum over half the row)
    differs from the jitted JAX product on many elements; so does the
    fused fc2 entry's ``tanhf`` (torch's tanh in the GELU) on fp32 h from
    the jitted product of the GELU of h."""
    from chip_smoke import quant_wrong

    dtype = jnp.float32 if kind == "tanhf" else jnp.bfloat16
    xj, xt, w, b = _operands(1000, 768, 256, dtype, seed=1)
    if kind == "tanhf":
        want = np.asarray(_J_GELU_QMM_BIAS[True](xj, jnp.asarray(w),
                                                 jnp.zeros_like(b)))
    else:
        want = np.asarray(_J_QMM(xj, jnp.asarray(w)))
    got = quant_wrong(xt, torch.from_numpy(np.ascontiguousarray(w.T)), kind)
    assert (got.numpy() != want).sum() > 100


def test_flop_formulas():
    """Q2 counts the products' 2 M N K (what a matmul of the same shapes
    counts), Q1's entries nothing; the int8 ops refuse nothing on the
    CPU."""
    xt = torch.randn(70, 64)
    wt = torch.randn(48, 64)
    qa, sa, qw, sw = quant.quantize_pair(xt, wt)
    assert flops.count_flops(quant.quantize_pair, xt, wt) == 0
    assert flops.count_flops(quant.gelu_quantize_pair, xt, wt, True) == 0
    assert flops.count_flops(quant.int8_linear, qa, sa, qw, sw) == \
        2 * 70 * 48 * 64 == flops.count_flops(torch.matmul, xt, wt.t())


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_int8_mlp_bit_equal_to_jax(approximate):
    """A float32 int8 ``Mlp`` (width 64, hidden 256, 2048 rows, biases
    drawn) equals the JAX package's jitted ``Mlp(quant=True)`` on the same
    weights bit for bit with either GELU (with torch's f32 tanh in the
    tanh GELU, 20.7% of the outputs differed)."""
    d, hidden, rows = 64, 256, 2048
    rs = np.random.RandomState(11)
    x = rs.randn(rows, d).astype(np.float32)
    jm = JMlp(hidden, d, jnp.float32, approximate, quant=True)
    p = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    for name, n in (("fc1", hidden), ("fc2", d)):
        p[name]["bias"] = (rs.randn(n) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)({"params": p}, jnp.asarray(x)))
    mlp = Mlp(d, hidden, torch.float32, approximate, quant=True)
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            lin = getattr(mlp, name)
            lin.weight.copy_(torch.from_numpy(p[name]["kernel"].T.copy()))
            lin.bias.copy_(torch.from_numpy(p[name]["bias"]))
        got = mlp(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("approximate", [True, False], ids=["tanh", "erf"])
def test_int8_block_quantizes_once_a_product(approximate):
    """A quantized ``Block`` runs Q1 once a product (three
    ``dupl::quantize_pair``, one ``dupl::gelu_quantize_pair``) beside four
    ``dupl::int8_linear``; between fc1's product and fc2's it runs the GELU
    entry and views alone, and no op of its own computes a GELU."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from dupl_tpu_torch.models.vit import Block

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func._schema.name)
            return func(*args, **(kwargs or {}))

    block = Block(64, 4, 4.0, torch.float32, approximate, quant=True).eval()
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 20, 64)
                         .astype(np.float32))
    with torch.no_grad(), Record() as rec:
        block(x)
    ops = rec.ops
    count = {name: ops.count(f"dupl::{name}") for name in (
        "quantize_pair", "gelu_quantize_pair", "int8_linear", "gelu_erf")}
    assert count == {"quantize_pair": 3, "gelu_quantize_pair": 1,
                     "int8_linear": 4, "gelu_erf": 0}, count
    products = [i for i, name in enumerate(ops) if name == "dupl::int8_linear"]
    between = set(ops[products[2] + 1:products[3]])
    assert between - {"aten::view", "aten::_unsafe_view", "aten::reshape",
                      "aten::alias"} == {"dupl::gelu_quantize_pair"}, between
    assert not {"aten::tanh", "aten::erf", "aten::erfc",
                "aten::gelu"} & set(ops)


# ------------------------------------------------ the dual student, int8
def _cfgs(**model):
    m = {"backbone": TINY, "compute_dtype": "float32",
         "quantized_inference": True, **model}
    return (voc_config(model=ModelConfig(**m), data=DataConfig(crop_size=CROP)),
            j_voc_config(model=JModelConfig(**m),
                         data=JDataConfig(crop_size=CROP)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    _, jcfg = _cfgs()
    jmodel = JDualStudent(jcfg.model)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, CROP, CROP, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    return params, path


def _port(path, **model):
    cfg, _ = _cfgs(**model)
    net = DualStudent(cfg.model)
    net.load_state_dict(load_weights(path))
    return net.eval()


def _image(seed=0, batch=2, size=CROP):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(
        np.float32)


# The int8 dual student against the jitted JAX one on the same weights:
# error over each output's largest magnitude, (max, mean).  Both sides
# quantize alike (bit for bit above), but the fp32 LayerNorm, attention
# and GELU outputs that feed a quantization differ in their last bits
# between the frameworks, a value that rounds to the next int8 level moves
# its product by a 127th of its row's scale, and that grows over the
# blocks.  Read over cam, cam_aux, the fused pass's cams, seg and cls:
# fp32 compute 7.3e-3 / 3.6e-4 at the worst, bf16 compute with a bf16
# stream 1.5e-2 / 3.2e-3.
INT8_REL = {"float32": (2e-2, 1e-3), "bfloat16": (5e-2, 1e-2)}


@pytest.mark.parametrize("compute", ["float32", "bfloat16", "bench"])
def test_int8_dual_student_matches_jax(weights, compute):
    """``bench``: bench_config's model (bf16 compute and stream, the tanh
    GELU, fused into fc2's quantization), held to the bf16 bounds."""
    params, path = weights
    over = {"float32": {},
            "bfloat16": dict(compute_dtype="bfloat16",
                             stream_dtype="bfloat16"),
            "bench": dict(compute_dtype="bfloat16", stream_dtype="bfloat16",
                          gelu_approximate=True)}[compute]
    _, jcfg = _cfgs(**over)
    jmodel = JDualStudent(jcfg.model)
    x = _image()
    net = _port(path, **over)
    with torch.no_grad():
        cam, cam_aux = net.cam_only(torch.from_numpy(x))
        out, fcam, fcam_aux = net.forward_with_cams(torch.from_numpy(x))
    jcam, jcam_aux = jax.jit(jmodel.cam_only)(params, jnp.asarray(x))

    def fwc(p, z):
        return jax.vmap(lambda pb: jmodel.module.apply(
            pb, z, method=type(jmodel.module).forward_with_cams))(p)
    jout, jfcam, jfcam_aux = jax.jit(fwc)(params, jnp.asarray(x))
    pairs = [(cam, jcam), (cam_aux, jcam_aux), (fcam, jfcam),
             (fcam_aux, jfcam_aux), (out.seg, jout.seg), (out.cls, jout.cls)]
    for got, want in pairs:
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        assert got.shape == want.shape
        err = np.abs(got - want) / np.abs(want).max()
        bound = INT8_REL["float32" if compute == "float32" else "bfloat16"]
        assert err.max() <= bound[0], err.max()
        assert err.mean() <= bound[1], err.mean()
    # the scale-1.0 pass and the fused one share features exactly
    assert torch.equal(cam, fcam) and torch.equal(cam_aux, fcam_aux)


def test_int8_forward_counts_the_bf16_forwards_flops(weights):
    """The quantized products count 2 M N K each, as the unquantized ones:
    a forward counts the same FLOPs either way (the card's route counts
    its ops' formulas, so card and CPU agree; held on the card by
    chip_smoke.py phase 30)."""
    _, path = weights
    x = torch.from_numpy(_image())
    with torch.no_grad():
        q = flops.count_flops(_port(path), x)
        plain = flops.count_flops(_port(path, quantized_inference=False), x)
    assert q == plain > 0


def test_training_and_tensor_parallel_refuse_int8(weights):
    """Training with ``quantized_inference`` is refused; tensor parallelism
    is not (it was until int8 inference was ported to it): over a gloo
    process group of one, a column-parallel and a row-parallel int8 layer
    (its maxima and int32 sums all-reduced) give the plain layer's bits,
    with the GELU inside fc2's quantization too (tests/test_torch_int8_tp.py
    holds two ranks to one process)."""
    from dupl_tpu_torch.parallel import dryrun, mesh

    _, path = weights
    cfg, _ = _cfgs()
    trainer = Trainer(cfg, model=_port(path), device="cpu")
    state = trainer.init_state(init=False)
    with pytest.raises(ValueError, match="inference only"):
        trainer.grad_step(state, {})
    blk = _port(path).branch1.encoder.blocks[0]
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(2, 5, blk.attn.qkv.in_features)
                         .astype(np.float32))
    h = torch.from_numpy(rs.randn(2, 5, blk.mlp.fc2.in_features)
                         .astype(np.float32))
    with torch.no_grad():
        want = [blk.attn.qkv(x), blk.attn.proj(x), blk.mlp.fc2(h, gelu="erf")]
    d = mesh.init_group(0, 1, "cpu",
                        init_method=f"tcp://127.0.0.1:{dryrun.free_port()}")
    try:
        for lin, role in ((blk.attn.qkv, "column"), (blk.attn.proj, "row"),
                          (blk.mlp.fc2, "row")):
            lin.tp, lin.tp_role = d, role
        with torch.no_grad():
            got = [blk.attn.qkv(x), blk.attn.proj(x),
                   blk.mlp.fc2(h, gelu="erf")]
    finally:
        d.close()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bench_components_int8_on_cpu(capsys):
    """``--int8`` runs the JAX tool's rows with ``quantized_inference``."""
    spec = importlib.util.spec_from_file_location(
        "_bench_components_q", ROOT / "tools/bench_components_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rep = mod.run(["--device", "cpu", "--backbone", TINY, "--crop", "32",
                   "--batch", "2", "--iters", "1", "--int8"])
    assert {"multi_scale_cam_full", "par_refine", "crf_fast", "pipeline",
            "eval_protocol"} <= set(rep)
    assert all(v > 0 for v in rep.values() if not isinstance(v, tuple))
    assert "pipeline" in capsys.readouterr().out


def test_sealed_int8_serving_matches_live(weights, tmp_path):
    """export_serving of the int8 model, written and read back: the live
    program's labels bit for bit, with Q1's two entries and Q2 in the
    sealed graph and no GELU op of its own."""
    _, path = weights
    cfg, _ = _cfgs()
    exported, meta = export.export_serving(
        cfg, _port(path), batch_size=2, scales=(1.0,), crf=True,
        device="cpu")
    targets = {str(n.target) for n in exported.graph.nodes}
    assert {"dupl.quantize_pair.default", "dupl.gelu_quantize_pair.default",
            "dupl.int8_linear.default"} <= targets
    assert "dupl.gelu_erf.default" not in targets
    art = str(tmp_path / "int8.duplsrv")
    export.save_artifact(art, exported, meta)
    loaded, _ = export.load_artifact(art)
    imgs = torch.from_numpy(np.random.RandomState(3).randint(
        0, 255, (2, CROP, CROP, 3)).astype(np.uint8))
    with torch.no_grad():
        got = loaded.module()(imgs)
    want = export.make_serving_fn(cfg, _port(path), scales=(1.0,),
                                  crf=True)(imgs)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
