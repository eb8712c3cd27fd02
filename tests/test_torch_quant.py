"""The int8 inference path (``dupl_tpu_torch/ops/quant.py``, kernels Q1 and
Q2's plain twins) against the jitted JAX package
(``dupl_tpu/ops/quant.py:quantized_matmul``, ``QDense(quant=True)``): the
quantization and the product bit for bit, wrong twins that are not, the
``quantized_inference`` dual student against the JAX one on the same
weights, ``tools/bench_components_torch.py --int8``, the sealed int8
serving program, and the refusals (training, tensor parallelism)."""

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
from dupl_tpu.ops.quant import quantized_matmul as j_quantized_matmul
from dupl_tpu_torch.config import DataConfig, ModelConfig, voc_config
from dupl_tpu_torch.engine import export
from dupl_tpu_torch.engine.train import Trainer
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import quant
from dupl_tpu_torch.utils import flops

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TINY = "test_tiny_patch16"
CROP = 64

_J_QMM = jax.jit(j_quantized_matmul)
_J_QMM_BIAS = jax.jit(lambda x, w, b: j_quantized_matmul(x, w) + b)


@jax.jit
def _j_quantize(x):
    """The activation quantization of ``dupl_tpu/ops/quant.py:36-38``,
    jitted: (x8, s_a)."""
    x2 = x.reshape(-1, x.shape[-1]).astype(jnp.float32)
    s_a = jnp.max(jnp.abs(x2), axis=1, keepdims=True) / 127.0
    s_a = jnp.maximum(s_a, 1e-8)
    return jnp.clip(jnp.round(x2 / s_a), -127, 127).astype(jnp.int8), s_a


# (M, K, N): ragged M, K a multiple of 32 as the card's kernels take it
SHAPES = [(50, 64, 96), (130, 128, 32), (257, 256, 64)]


def _operands(m, k, n, dtype, seed=0):
    """x (M, K) with a zero row (the 1e-8 floor) and rows of other scales,
    in ``dtype``; w (K, N) fp32 as JAX holds it; bias (N,)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(m, k).astype(np.float32) * rs.uniform(0.1, 4, (m, 1))
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
    """quantize_rows (activations, and weights as nn.Linear's (N, K)) and
    quantized_matmul, with and without the bias, equal the jitted JAX
    functions bit for bit."""
    m, k, n = shape
    xj, xt, w, b = _operands(m, k, n, dtype)
    q, s = quant.quantize_rows(xt)
    jq, js = _j_quantize(xj)
    assert q.dtype == torch.int8 and s.shape == (m, 1)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert s[3].item() == np.float32(1e-8) and not q[3].any()
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    qw, sw = quant.quantize_rows(wt)
    jqw, jsw = _j_quantize(jnp.asarray(w.T))
    assert np.array_equal(qw.numpy(), np.asarray(jqw))
    assert np.array_equal(sw.numpy(), np.asarray(jsw))
    got = quant.quantized_matmul(xt, wt)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(_J_QMM(xj, jnp.asarray(w))))
    got = quant.quantized_matmul(xt[None], wt, torch.from_numpy(b))[0]
    want = _J_QMM_BIAS(xj, jnp.asarray(w), jnp.asarray(b))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["divide_by_127", "rescale_once",
                                  "last_k_tile_dropped", "k_stage_read_twice",
                                  "row_scale_shifted", "n_tiles_swapped"])
def test_wrong_twins_are_not_bit_equal(kind):
    """At M 1000, K 768, N 256 in bf16, each wrong twin of
    ``chip_smoke.quant_wrong`` (the ones phase 30 holds on the card: the
    JAX source read literally, and Q2's own faults: a K stage read twice,
    the row scales of 8-row halves exchanged, two 128-column output tiles
    exchanged) differs from the jitted JAX product on many elements."""
    from chip_smoke import quant_wrong

    xj, xt, w, _ = _operands(1000, 768, 256, jnp.bfloat16, seed=1)
    want = np.asarray(_J_QMM(xj, jnp.asarray(w)))
    got = quant_wrong(xt, torch.from_numpy(np.ascontiguousarray(w.T)), kind)
    assert (got.numpy() != want).sum() > 100


def test_flop_formulas():
    """Q2 counts the products' 2 M N K (what a matmul of the same shapes
    counts), Q1 nothing; the int8 ops refuse nothing on the CPU."""
    xt = torch.randn(70, 64)
    wt = torch.randn(48, 64)
    qa, sa = quant.quantize_rows(xt)
    qw, sw = quant.quantize_rows(wt)
    assert flops.count_flops(quant.quantize_rows, xt) == 0
    assert flops.count_flops(quant.int8_linear, qa, sa, qw, sw) == \
        2 * 70 * 48 * 64 == flops.count_flops(torch.matmul, xt, wt.t())


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


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_int8_dual_student_matches_jax(weights, compute):
    params, path = weights
    over = ({} if compute == "float32" else
            dict(compute_dtype="bfloat16", stream_dtype="bfloat16"))
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
        assert err.max() <= INT8_REL[compute][0], err.max()
        assert err.mean() <= INT8_REL[compute][1], err.mean()
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
    _, path = weights
    cfg, _ = _cfgs()
    trainer = Trainer(cfg, model=_port(path), device="cpu")
    state = trainer.init_state(init=False)
    with pytest.raises(ValueError, match="inference only"):
        trainer.grad_step(state, {})
    lin = _port(path).branch1.encoder.blocks[0].attn.qkv
    lin.tp, lin.tp_role = object(), "column"
    with pytest.raises(ValueError, match="--model-parallel"):
        lin(torch.zeros(1, 4, lin.in_features))


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
    program's labels bit for bit, with Q1 and Q2 in the sealed graph."""
    _, path = weights
    cfg, _ = _cfgs()
    exported, meta = export.export_serving(
        cfg, _port(path), batch_size=2, scales=(1.0,), crf=True,
        device="cpu")
    targets = {str(n.target) for n in exported.graph.nodes}
    assert {"dupl.quantize_rows.default",
            "dupl.int8_linear.default"} <= targets
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
