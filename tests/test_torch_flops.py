"""FLOP counting of the port (dupl_tpu_torch/utils/flops.py and the flop
formulas of the seven ``dupl::`` ops, ops/library.py): each op counts on
the CPU what ``FlopCounterMode`` counts for its plain twin, or for exact
softmax attention and its autograd backward; ``register`` refuses an op
without a formula; the peak table and the MFU arithmetic, as
tests/test_flops.py holds the JAX package's; and a tiny dual student's
count beside XLA's cost model of the same forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import flop_registry

from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu.utils import flops as jflops
from dupl_tpu_torch.config import ModelConfig
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import attention, crf_cuda, library, par_cuda
from dupl_tpu_torch.utils import flops

torch.set_num_threads(2)

OPS = ("exp_attention", "exp_attention_bwd", "flash_attention",
       "flash_attention_bwd", "crf_apply", "par_affinity", "par_propagate")
DILATIONS = [1, 2, 4]


def _bf16(rs, *shape):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        torch.bfloat16)


def _softmax_counts(q, k, v):
    """What the counter counts for exact softmax attention forward, and for
    its autograd backward alone."""
    qf, kf, vf = (x.float().requires_grad_() for x in (q, k, v))
    fwd = flops.count_flops(attention.softmax_attention, qf, kf, vf,
                            scale=0.125)

    def both():
        attention.softmax_attention(qf, kf, vf, scale=0.125).sum().backward()
    return fwd, flops.count_flops(both) - fwd


ATTN_SHAPES = [(2, 50, 3, 16), (1, 130, 2, 32)]   # (B, N, H, D)


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=["n50", "n130"])
@pytest.mark.parametrize("op", OPS)
def test_op_counts_what_its_twin_counts(op, shape):
    """Exact integer equality on CPU tensors; for the attention ops the
    reference is softmax attention (4 B H N^2 D forward, 8 backward), for
    K5 its tiled twin (two products), for K3 and K4 their twins (no product:
    0).  The attention ops' own twins count 10 B H N^2 D backward (the
    scores recomputed): not model FLOPs."""
    rs = np.random.RandomState(sum(shape))
    b, n, h, d = shape
    q, k, v, g = (_bf16(rs, b, n, h, d) for _ in range(4))
    fwd, bwd = _softmax_counts(q, k, v)
    if op == "exp_attention":
        got, want = flops.count_flops(torch.ops.dupl.exp_attention, q, k, v), fwd
    elif op == "exp_attention_bwd":
        got = flops.count_flops(torch.ops.dupl.exp_attention_bwd, q, k, v, g)
        want = bwd
    elif op == "flash_attention":
        got = flops.count_flops(torch.ops.dupl.flash_attention, q, k, v, 0.125)
        want = fwd
    elif op == "flash_attention_bwd":
        out, lse = torch.ops.dupl.flash_attention(q, k, v, 0.125)
        got = flops.count_flops(torch.ops.dupl.flash_attention_bwd, q, k, v,
                                out, lse, g, 0.125)
        want = bwd
    elif op == "crf_apply":
        npix, ns, nv = 8 * n, n // 2, 2 * h + 1
        basis = torch.from_numpy(rs.randn(b, npix, 11).astype(np.float32))
        coef = torch.from_numpy(rs.randn(b, 11, ns).astype(np.float32) * 0.1)
        logc = torch.from_numpy(rs.randn(b, ns).astype(np.float32))
        vals = torch.from_numpy(rs.rand(b, ns, nv).astype(np.float32))
        got = flops.count_flops(torch.ops.dupl.crf_apply, basis, coef, logc,
                                vals, 3 * n)
        want = flops.count_flops(crf_cuda.kernel_apply_ref, basis, coef, logc,
                                 vals, block_rows=3 * n)
        assert want == 2 * b * npix * ns * (11 + nv)
    elif op == "par_affinity":
        imgs = torch.from_numpy(rs.rand(b, n // 2, d, 3).astype(np.float32))
        got = flops.count_flops(torch.ops.dupl.par_affinity, imgs, DILATIONS,
                                0.3, 0.01)
        want = flops.count_flops(par_cuda.affinity_ref, imgs, DILATIONS)
    else:
        masks = torch.from_numpy(rs.rand(b, h, n // 2, d).astype(np.float32))
        aff = torch.from_numpy(
            rs.rand(b, 8 * len(DILATIONS), n // 2, d).astype(np.float32))
        got = flops.count_flops(torch.ops.dupl.par_propagate, masks, aff,
                                DILATIONS, 2)
        want = flops.count_flops(par_cuda._propagate_twin, masks, aff,
                                 DILATIONS, 2)
    assert got == want
    if "attention" in op:
        assert want == (8 if op.endswith("bwd") else 4) * b * h * n * n * d


@pytest.mark.parametrize("route", ["exp_attention", "flash_attention"])
def test_kernel_route_counts_the_softmax_route(route):
    """The autograd pairs of the card route (K1 + K2, L1f + L1b; on CPU
    tensors their ops run the twins) count forward plus backward exactly as
    the CPU route's softmax attention does."""
    rs = np.random.RandomState(3)
    q, k, v = (_bf16(rs, 2, 130, 2, 16) for _ in range(3))
    fwd, bwd = _softmax_counts(q, k, v)
    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))

    def both():
        getattr(attention, route)(qf, kf, vf, scale=0.125).float().sum() \
            .backward()
    assert flops.count_flops(both) == fwd + bwd


def test_every_op_has_a_formula_and_register_refuses_one_without():
    registered = {str(k) for k in flop_registry}
    for op in OPS:
        assert str(getattr(torch.ops.dupl, op)) in registered, op
    with pytest.raises(TypeError, match="flop formula"):
        library.register("no_formula(Tensor x) -> Tensor",
                         cuda=lambda x: x, cpu=lambda x: x.clone(),
                         fake=lambda x: torch.empty_like(x), flops=None)
    assert not hasattr(torch.ops.dupl, "no_formula")


def test_peak_table_and_mfu(monkeypatch):
    """By the CUDA device name (faked here: no card); the CPU and unknown
    cards have no peak, and then no MFU."""
    assert flops.device_rates("NVIDIA H100 80GB HBM3")["bf16"] == 989e12
    assert flops.device_rates("NVIDIA H100 PCIe")["bf16"] == 756e12
    assert flops.device_rates("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
    assert flops.device_rates("NVIDIA A100-SXM4-80GB") is None
    rates = flops.device_rates("NVIDIA H100 80GB HBM3")
    assert rates["sfu"] == 67e12 / 16 and rates["fp32_instr"] == 67e12 / 2
    assert rates["int8"] == 1979e12
    assert flops.device_rates("NVIDIA H100 PCIe")["int8"] == 1513e12
    assert flops.peak_flops_per_device("cpu") is None
    name = {"name": "NVIDIA H100 80GB HBM3"}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: name["name"])
    dev = torch.device("cuda:0")
    assert flops.peak_flops_per_device(dev) == 989e12
    assert np.isclose(flops.mfu(989e12 / 2, 2, 1.0, dev), 1.0)
    assert flops.mfu(None, 1, 1.0, dev) is None
    assert flops.mfu(1e12, 1, 0.0, dev) is None
    assert flops.mfu(1e12, 1, 1.0, "cpu") is None
    name["name"] = "NVIDIA H100 PCIe"
    assert flops.peak_flops_per_device("cuda") == 756e12
    name["name"] = "NVIDIA GeForce RTX 3090"
    assert flops.peak_flops_per_device(dev) is None


@pytest.fixture(scope="module")
def tiny_pair(tmp_path_factory):
    """A JAX-initialised tiny dual student and the port's copy, fp32."""
    kw = dict(backbone="test_tiny_patch16", compute_dtype="float32")
    jmodel = JDualStudent(JModelConfig(**kw))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    model = DualStudent(ModelConfig(**kw))
    model.load_state_dict(load_weights(path))
    return jmodel, params, model.eval()


def _in_bounds_taps(size: int, dilation: int) -> int:
    """Output positions times kernel taps that read inside a size x size
    map, for a 3x3 conv of this dilation padded by it."""
    reach = [max(0, size - abs(k * dilation)) for k in (-1, 0, 1)]
    return sum(reach) ** 2


@pytest.mark.parametrize("size", [64, 224])
def test_dual_student_count_against_xla_cost_model(tiny_pair, size):
    """A tiny dual student's forward on a batch of 2: the encoder's count
    is at most XLA's cost model of the compiled JAX encoder (XLA also
    counts elementwise work).  The whole forward's count is not: XLA counts
    a convolution's taps that land in its zero padding as no work, and
    LargeFOV's 3x3 convs of dilation 5 on a 4 x 4 or 14 x 14 map read
    mostly padding, while the counter counts every tap (the conventional
    count).  With those taps left out of the counter's count, the whole
    forward is at most XLA's too.  The ratios are printed (PERF.md)."""
    jmodel, params, model = tiny_pair
    x = np.random.RandomState(size).randn(2, size, size, 3).astype(np.float32)
    enc_xla = jflops.compiled_flops(
        jax.jit(lambda p, z: jmodel.module.apply(
            p, z, method=lambda m, y: m.encoder(y))),
        jmodel.branch(params, 0), jnp.asarray(x))
    xla = jflops.compiled_flops(jax.jit(jmodel.apply), params,
                                jnp.asarray(x))
    if xla is None or enc_xla is None:
        pytest.skip("this JAX backend exposes no cost model")
    with torch.no_grad():
        enc = flops.count_flops(model.branch1.encoder, torch.from_numpy(x))
        got = flops.count_flops(model, torch.from_numpy(x))
    dec = model.branch1.decoder
    grid = size // 16
    macs = sum(c.in_channels * c.out_channels for c in (dec.conv6, dec.conv7))
    padding = 2 * 2 * 2 * macs * (9 * grid * grid - _in_bounds_taps(grid, 5))
    print(f"size {size}: encoder {enc} / XLA {enc_xla:.0f} = "
          f"{enc / enc_xla:.4f}; dual student {got} / XLA {xla:.0f} = "
          f"{got / xla:.4f}, {(got - padding) / xla:.4f} without the "
          f"padding taps")
    assert 0 < enc <= enc_xla
    assert 0 < got - padding <= xla < got
