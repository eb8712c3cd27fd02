"""Port parity of the experiment kernels' plain twins
(dupl_tpu_torch/ops/experiments.py) against the JAX tools' own Pallas
kernels, run in interpret mode on the CPU, on the same numpy inputs; and the
port's four experiment tools on the CPU at small shapes.

The JAX tools take no ``interpret`` flag: ``pl.pallas_call`` is patched with
``interpret=True`` around each call (nothing under ``tools/`` changes), and
for the rate probe the module's tile constants are patched to a small tile.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dupl_tpu_torch.ops import crf_cuda, experiments

torch.set_num_threads(2)

TOOLS = Path(__file__).resolve().parents[1] / "tools"


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pl.pallas_call`` made while this fixture lives runs in
    interpret mode."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _row_ulp(got, want):
    """|got - want| in bf16 ulps at the scale of each output row."""
    scale = np.abs(want).max(-1, keepdims=True).clip(1e-30)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(scale)) - 7)


def _qkv(shape, seed, q_mult=1.0):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    return q * q_mult, k, v


# ------------------------------------------------------------------- P1
@pytest.mark.parametrize("n,q_mult", [(197, 0.125), (256, 0.125),
                                      (197, 5.0)])  # ragged, whole, clamped
def test_ones_twin_matches_jax_kernel(interpret, n, q_mult):
    """P1's twin against ``exp_attention_ones`` in interpret mode, within
    one bf16 ulp of the row: both round q, k, v and e to bf16 and contract
    in fp32; only the fp32 summation order differs, which can flip the
    rounding of an e entry or of the output."""
    tool = _load("exp_attn_experiment")
    q, k, v = _qkv((3, n, 64), seed=n, q_mult=q_mult)
    want = np.asarray(tool.exp_attention_ones(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))), np.float32)
    got = experiments.exp_attention_ones(_bf16(q), _bf16(k), _bf16(v))
    assert got.dtype == torch.bfloat16 and got.shape == (3, n, 64)
    if q_mult > 1:   # scores beyond the clamp exist, and the result is finite
        s = _bf16(q).float() @ _bf16(k).float().transpose(-1, -2)
        assert s.max() > 60 and np.isfinite(want).all()
    assert _row_ulp(got.float().numpy(), want).max() <= 1.0


def test_ones_twin_differs_from_fp32_row_sum():
    """What makes P1 P1: its denominator sums the bf16-rounded e, so it is
    not the exp-attention twin, whose denominator sums the fp32 e."""
    from dupl_tpu_torch.ops import attention

    q, k, v = (_bf16(x) for x in _qkv((2, 197, 64), seed=5, q_mult=0.125))
    a = experiments.exp_attention_ones_ref(q, k, v)
    b = attention.exp_attention_ref(q, k, v)
    assert not torch.equal(a, b)
    assert (a - b).abs().max() <= 2 ** -7 * b.abs().max()


# P1's and P2's bounds on the card (chip_smoke.py phases 18-19 and the card
# tests): within 2 bf16 ulps of the row at the maximum and 1e-3 on average
# of the twin rounded to bf16.
def _inside_p12_bounds(got, want):
    u = _row_ulp(got.float().numpy(), want.to(torch.bfloat16).float().numpy())
    return u.max() <= 2.0 and u.mean() <= 1e-3, (u.max(), u.mean())


def _exp_attention_by_tiles(qs, k, v, ones):
    """The exp attention of pre-scaled (..., N, D) operands with both sums
    taken 128 keys at a time, the last tile first: the kernels' tiling with
    another order of sums.  ``ones``: the denominator sums bf16(e) (P1),
    else the fp32 e (K1, P2)."""
    qf, kf, vf = (x.float() for x in (qs, k, v))
    num = den = 0.0
    for lo in reversed(range(0, k.shape[-2], 128)):
        e = torch.exp(torch.clamp(qf @ kf[..., lo:lo + 128, :].transpose(-1, -2),
                                  max=60.0))
        eb = e.to(torch.bfloat16).float()
        num = num + eb @ vf[..., lo:lo + 128, :]
        den = den + (eb if ones else e).sum(-1, keepdim=True)
    return (num / den).to(torch.bfloat16)


@pytest.mark.parametrize("kind", ["by_tiles", "fp32_row_sum", "pad_counted"])
def test_ones_bounds_tell_wrong_twins(kind):
    """P1's bounds at a ragged length (N 197, 59 keys short of the second
    128-key tile): its function with the sums in another order lies inside
    them, and each wrong twin of chip_smoke.py's ``exp_attn_ones_wrong``
    (the fp32 row sum; keys past N counted by the ones column) outside."""
    from chip_smoke import exp_attn_ones_wrong

    q, k, v = (_bf16(x) for x in _qkv((4, 197, 64), seed=11, q_mult=0.125))
    want = experiments.exp_attention_ones_ref(q, k, v)
    got = (_exp_attention_by_tiles(q, k, v, ones=True) if kind == "by_tiles"
           else exp_attn_ones_wrong(q, k, v, kind))
    inside, err = _inside_p12_bounds(got, want)
    assert inside == (kind == "by_tiles"), (kind, err)


# ------------------------------------------------------------------- P2
@pytest.mark.parametrize("n,scale,q_mult", [(197, 0.125, 1.0),
                                            (256, 0.11, 1.0),
                                            (197, 0.125, 40.0)])
def test_bnhd_twin_matches_jax_kernel(interpret, n, scale, q_mult):
    """P2's twin against ``exp_attention_bnhd`` in interpret mode, within
    one bf16 ulp of the row; a scale bf16 does not represent (0.11) checks
    that the twin rounds the scale and the product as jax does."""
    tool = _load("exp_attn_layout_experiment")
    q, k, v = _qkv((2, n, 3, 64), seed=n + 1, q_mult=q_mult)
    want = np.asarray(tool.exp_attention_bnhd(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), scale=scale),
        np.float32)
    got = experiments.exp_attention_bnhd(_bf16(q), _bf16(k), _bf16(v), scale)
    assert got.dtype == torch.bfloat16 and got.shape == (2, n, 3, 64)
    assert np.isfinite(want).all()
    assert _row_ulp(got.float().numpy(), want).max() <= 1.0


def test_bnhd_twin_rounds_the_scale():
    """With the scale left in fp32 the scaled q rounds differently."""
    q, k, v = (_bf16(x) for x in _qkv((1, 130, 2, 64), seed=9))
    a = experiments.exp_attention_bnhd_ref(q, k, v, 0.11)
    qs = (q.float() * 0.11).to(torch.bfloat16)
    from dupl_tpu_torch.ops import attention
    b = attention._from_bhnd(attention.exp_attention_ref(
        *(attention._to_bhnd(x) for x in (qs, k, v))), 1)
    assert not torch.allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["by_tiles", "fp32_scale", "scale_on_scores"])
def test_bnhd_bounds_tell_wrong_twins(kind):
    """P2's bounds at N 197 and a scale bf16 does not hold (0.11): its
    function with the sums in another order lies inside them, and each wrong
    twin of chip_smoke.py's ``exp_attn_bnhd_wrong`` (q * 0.11 in fp32 rounded
    once; the fp32 scale on the fp32 scores) outside."""
    from chip_smoke import exp_attn_bnhd_wrong

    from dupl_tpu_torch.ops import attention

    q, k, v = (_bf16(x) for x in _qkv((2, 197, 3, 64), seed=12))
    want = experiments.exp_attention_bnhd_ref(q, k, v, 0.11)
    if kind == "by_tiles":
        qs = q * experiments.bf16_scale(0.11)
        got = attention._from_bhnd(_exp_attention_by_tiles(
            *(attention._to_bhnd(x) for x in (qs, k, v)), ones=False), 2)
    else:
        got = exp_attn_bnhd_wrong(q, k, v, 0.11, kind)
    inside, err = _inside_p12_bounds(got, want)
    assert inside == (kind == "by_tiles"), (kind, err)


# ------------------------------------------------------------------- P3
def _crf_operands(batch, n, ns, v, seed, inf_every=5):
    rs = np.random.RandomState(seed)
    basis = rs.randn(batch, n, 11).astype(np.float32)
    coef = (rs.randn(batch, 11, ns) * 0.1).astype(np.float32)
    logc = -np.abs(rs.randn(batch, ns)).astype(np.float32)
    logc[:, ::inf_every] = -np.inf          # pivots that must give exactly 0
    vals = rs.randn(batch, ns, v).astype(np.float32)
    return basis, coef, logc, vals


@pytest.mark.parametrize("n,ns,v", [(512, 128, 22), (700, 200, 5),
                                    (384, 160, 40)])
def test_apply_bf16_twin_matches_jax_kernel(interpret, n, ns, v):
    """P3's twin against ``pallas16`` in interpret mode.  Bound, per output
    column c: |err[i, c]| <= 2^-7 * sum_j k[i, j] |vals[j, c]|, two bf16
    ulps of every kernel entry k propagated through the value product (the
    fp32 score sums in another order, which can move a score across a bf16
    rounding boundary, and the exp of the bf16 value rounds to bf16 again)."""
    tool = _load("crf_apply_experiment")
    ops = _crf_operands(2, n, ns, v, seed=n)
    want = np.asarray(tool.pallas16(*(jnp.asarray(x) for x in ops),
                                    block_rows=256))
    t = [torch.from_numpy(x) for x in ops]
    got = experiments.kernel_apply_bf16(*t).numpy()
    assert got.shape == (2, n, v) and np.isfinite(got).all()
    s = torch.minimum(torch.matmul(t[0], t[1]), t[2][:, None])
    k = torch.exp(s.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    bound = 2.0 ** -7 * torch.matmul(
        k, t[3].to(torch.bfloat16).float().abs()).numpy()
    assert (np.abs(got - want) <= bound + 1e-6).all()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_apply_bf16_inf_pivots_give_zero():
    basis, coef, logc, vals = (torch.from_numpy(x) for x in _crf_operands(
        1, 64, 32, 3, seed=2))
    logc[:] = -np.inf
    assert experiments.kernel_apply_bf16(basis, coef, logc, vals).abs().max() == 0
    # and the bf16 exp is not the fp32 exp
    logc = -torch.rand(1, 32) * 4
    a = experiments.kernel_apply_bf16_ref(basis, coef, logc, vals)
    b = crf_cuda.kernel_apply_ref(basis, coef, logc, vals)
    assert not torch.equal(a, b)


def _split3(x):
    """fp32 -> three bf16 parts (as fp32 values) with x = a0 + a1 + a2 up to
    ~2^-24 |x|: each remainder is exact in fp32, as in the kernel."""
    a0 = x.to(torch.bfloat16).float()
    a1 = (x - a0).to(torch.bfloat16).float()
    return a0, a1, (x - a0 - a1).to(torch.bfloat16).float()


def _split_score(basis, coef):
    """P3's score as the kernel takes it on the tensor cores: basis and coef
    split into bf16 parts, the six products that matter (bf16 x bf16 is
    exact in fp32) summed in fp32, smallest first."""
    a, b = _split3(basis), _split3(coef)
    s = None
    for i, j in ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)):
        p = torch.matmul(a[i], b[j])
        s = p if s is None else s + p
    return s


def _apply(score, logc, vals, bf16_score=True):
    """The kernel-apply on a given score: P3's roundings (the clamped score
    rounded to bf16 before the exp), or K5's (``bf16_score=False``)."""
    x = torch.minimum(score, logc[:, None, :])
    if bf16_score:
        x = x.to(torch.bfloat16).float()
    k = torch.exp(x).to(torch.bfloat16).float()
    return torch.matmul(k, vals.to(torch.bfloat16).float())


def _column_err(got, want):
    """(max, mean) over output columns of the largest and of the mean
    absolute error, each over the column's scale, as phase 20 reads P3."""
    err = (got - want).abs().flatten(0, 1)
    scale = want.abs().flatten(0, 1).amax(0)
    return ((err.amax(0) / scale).max().item(),
            (err.mean(0) / scale).max().item())


def _crf_shaped_operands(v, n_pix=16384):
    """The fast CRF's operands: ``ops.crf.pivot_lattice`` of one synthetic
    448^2 image at the VOC config's bilateral widths (xy 121, rgb 5), whose
    colour f^2 terms reach ~2,600 and cancel to scores of order 1; values as
    phase 4's (uniform in [0, 2], the last column the cell count 64); the
    output at a seeded sample of ``n_pix`` pixels."""
    from dupl_tpu_torch.ops import crf

    rs = np.random.RandomState(v)
    yy, xx = np.meshgrid(np.linspace(0, 1, 448), np.linspace(0, 1, 448),
                         indexing="ij")
    img = np.stack([np.sin(6 * xx) * 0.5 + 0.5, yy, xx * yy], -1)[None]
    img = np.clip(img + 0.03 * rs.randn(*img.shape), 0, 1).astype(np.float32)
    basis, coef, logc, _, _ = crf.pivot_lattice(torch.from_numpy(img), 8,
                                                121.0, 5.0)
    basis = basis[:, torch.from_numpy(rs.permutation(basis.shape[1])[:n_pix])]
    vals = torch.from_numpy(rs.rand(1, coef.shape[2], v).astype(np.float32)) * 2
    vals[..., -1] = 64.0
    return basis.contiguous(), coef, logc, vals


@pytest.mark.parametrize("operands,v", [("tool", 22), ("crf", 22), ("crf", 82)])
def test_apply_bf16_split_score_emulation(operands, v):
    """The gate of a tensor-core score for P3: the CPU emulation of a score
    split into bf16 parts (``_split_score``) against the twin (fp32 score),
    beside the fp32 FMA chain summed term by term (the kernel's score, in
    another order than the CPU's matrix product).  The split is as exact as
    an fp32 sum: mean error within half of P3's mean bound (1e-4 of a
    column's scale), where the fp32-exp wrong twin lies outside it, and the
    largest error within 2x of the chain's.  Printed: whether the largest
    error is within half of P3's maximum bound (5e-4): on both operand sets
    neither the split nor the chain is (one flipped bf16 rounding of a score
    near -1 moves an entry by up to e^-1 2^-7), so only a score summed in
    the twin's own order holds it, and P3 keeps the fp32 chain that the
    card's matrix product also sums; and whether K5's bounds (2e-3, 2e-5)
    would hold for a K5 on the split score."""
    from chip_smoke import K5_MAX, K5_MEAN

    if operands == "tool":
        tool = _load("crf_apply_experiment_torch")
        basis, coef, logc, vals = tool.make_inputs(1, 16384, 3136, "cpu", v=v)
    else:
        basis, coef, logc, vals = _crf_shaped_operands(v)
    assert coef.shape == (1, 11, 3136)
    fp32 = torch.matmul(basis, coef)
    chain = basis[..., :1] * coef[:, :1]
    for d in range(1, 11):
        chain = chain + basis[..., d:d + 1] * coef[:, d:d + 1]
    split = _split_score(basis, coef)
    want = _apply(fp32, logc, vals)
    got = _column_err(_apply(split, logc, vals), want)
    ref = _column_err(_apply(chain, logc, vals), want)
    wrong = _column_err(_apply(fp32, logc, vals, bf16_score=False), want)
    k5 = _column_err(_apply(split, logc, vals, bf16_score=False),
                     _apply(fp32, logc, vals, bf16_score=False))
    print(f"{operands} V {v}: (max, mean) split {got}, fp32 chain {ref}, "
          f"fp32-exp twin {wrong}; split max within half of 5e-4: "
          f"{got[0] <= 2.5e-4}; K5 on the split score {k5}, inside K5's "
          f"bounds: {k5[0] <= K5_MAX and k5[1] <= K5_MEAN}")
    assert got[1] <= 0.5e-4, got
    assert got[0] <= 2 * ref[0], (got, ref)
    assert wrong[1] > 1e-4, wrong


# ------------------------------------------------------------------- P4
_ROWS, _COLS, _ITER = 8, 128, 48


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["mul", "exp", "exp2", "exp_min", "tanh"])
def test_rate_twin_matches_jax_kernel(interpret, monkeypatch, name, dtype):
    """P4's twin against the tool's kernel in interpret mode on an (8, 128)
    tile, 48 passes.  fp32: 1e-5 * iters relative to the largest result
    (the passes' roundings accumulate).  bf16: every operation rounds to
    bf16 on both sides, so the trajectories agree but where an exp or tanh
    of the two libraries differs in the last fp32 bit at a bf16 rounding
    boundary: within 2 bf16 ulps (2^-7 relative) of the largest result (but
    exp2, see below)."""
    tool = _load("exp_rate_experiment")
    monkeypatch.setattr(tool, "ROWS", _ROWS)
    monkeypatch.setattr(tool, "COLS", _COLS)
    monkeypatch.setattr(tool, "ITER", _ITER)
    x = (np.random.RandomState(3).randn(_ROWS, _COLS) - 1.0).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(tool.run(jx, name=name)[0], np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = experiments.exp_rate(tx, name, _ITER)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = 1e-5 * _ITER if dtype == "float32" else 2.0 ** -7
    if (name, dtype) == ("exp2", "bfloat16"):
        # jax lowers exp2 to exp(x * ln 2) with the constant and the product
        # rounded to bf16; the port's exp2 is the base-2 exponential the
        # card's instruction computes.  With jax's formula the trajectories
        # agree as the other functions' do; the true exp2 differs by the
        # rounding of the argument, up to |x| ln 2 * 2^-7 (6% at |x| = 5) of
        # a pass's term.
        ln2 = torch.tensor(np.log(2.0), dtype=torch.bfloat16)
        acc = torch.zeros_like(tx)
        for _ in range(_ITER):
            acc = acc + torch.exp((tx + acc * torch.tensor(
                1e-9, dtype=torch.bfloat16)) * ln2)
        assert np.abs(acc.float().numpy() - want).max() <= tol * np.abs(want).max()
        tol = 6e-2
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


def test_rate_rejects_unknown_function():
    with pytest.raises(ValueError, match="must be one of"):
        experiments.exp_rate(torch.zeros(4), "sin", 2)


# ------------------------------------------------------------------- tools
def test_attn_tool_runs_on_cpu(capsys):
    tool = _load("exp_attn_experiment_torch")
    recs = tool.run("cpu", bh=4, ns=(50, 197), iters=1)
    assert [r["n"] for r in recs] == [50, 197]
    assert all(0 < r["max_rel_diff"] < 1e-2 for r in recs)
    out = capsys.readouterr().out
    assert "N=197: current" in out and "ones-col" in out and "max-rel-diff" in out


def test_layout_tool_runs_on_cpu(capsys):
    tool = _load("exp_attn_layout_experiment_torch")
    recs = tool.run("cpu", b=2, ns=(130,), iters=1)
    assert recs[0]["max_rel_diff"] == 0.0   # same products on both arms
    assert "bnhd" in capsys.readouterr().out


def test_crf_tool_runs_on_cpu(capsys):
    tool = _load("crf_apply_experiment_torch")
    rec, = tool.run("cpu", batch=2, size=32, stride=8, iters=1)
    assert (rec["n"], rec["ns"]) == (1024, 16)
    assert rec["fp32_max_rel"] == 0.0 and 0 < rec["bf16_max_rel"] < 2e-2
    assert "bf16 exp" in capsys.readouterr().out


def test_rate_tool_runs_on_cpu(capsys):
    tool = _load("exp_rate_experiment_torch")
    recs = tool.run("cpu", rows=8, cols=128, iters=4, reps=1)
    assert len(recs) == 11      # 6 functions in fp32, 5 in bf16
    assert all(r["gops"] > 0 for r in recs)
    assert "Gop/s" in capsys.readouterr().out


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper never falls back: handed a CPU tensor it raises."""
    x = torch.zeros(1, 130, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        experiments.exp_attention_ones_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        experiments.exp_attention_bnhd_cuda(x, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        experiments.kernel_apply_bf16_cuda(
            torch.zeros(1, 8, 11), torch.zeros(1, 11, 4), torch.zeros(1, 4),
            torch.zeros(1, 4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        experiments.exp_rate_cuda(torch.zeros(8), "exp", 2)
