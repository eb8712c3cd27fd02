"""The JAX side's measurement programs on the port: ``bench.py``'s
configuration (tanh GELU, bf16 residual stream, bf16 PAR) held to the JAX
package, and ``bench_torch.py``, ``tools/bench_components_torch.py``,
``tools/encoder_dissect_torch.py`` and ``tools/train_dissect_torch.py``
against the compositions of ``bench.py``, ``tools/bench_components.py`` and
``tools/train_dissect.py`` on carried weights (tiny ViT, CPU), and as
command lines on the CPU."""

import ast
import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.config import ParConfig as JParConfig
from dupl_tpu.config import coco_config as jcoco_config
from dupl_tpu.config import voc_config as jvoc_config
from dupl_tpu.data.pipeline import synthetic_batch
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.engine.train import Trainer as JTrainer
from dupl_tpu.models.vit import Block as JBlock
from dupl_tpu.ops import image as jimage_ops
from dupl_tpu.ops import losses as jloss_ops
from dupl_tpu_torch.config import bench_config
from dupl_tpu_torch.engine.train import Trainer
from dupl_tpu_torch.models.convert import load_weights, state_dict_from_jax
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.models.vit import Block, gelu_tanh

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TINY = "test_tiny_patch16"
CROP, BATCH = 64, 2


def _load(path):
    spec = importlib.util.spec_from_file_location(
        f"_bench_{Path(path).stem}", ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_torch = _load("bench_torch.py")
components = _load("tools/bench_components_torch.py")
encoder_dissect = _load("tools/encoder_dissect_torch.py")
train_dissect = _load("tools/train_dissect_torch.py")


def _plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def _jax_bench_config(dataset, backbone="deit_base_patch16", int8=False,
                      **model):
    """The configuration as ``bench.py:105-109`` (VOC) and
    ``tools/bench_components.py:74-81`` build it."""
    if dataset == "voc" and not int8:
        return jvoc_config(model=JModelConfig(**{
            "backbone": backbone, "gelu_approximate": True,
            "stream_dtype": "bfloat16", **model}),
                           par=JParConfig(compute_dtype="bfloat16",
                                          class_budget=10))
    mk = jvoc_config if dataset == "voc" else jcoco_config
    nc = 21 if dataset == "voc" else 81
    budget = 10 if dataset == "voc" else 16
    return mk(model=JModelConfig(**{
        "backbone": backbone, "num_classes": nc, "gelu_approximate": True,
        "stream_dtype": "bfloat16", "quantized_inference": int8, **model}),
              par=JParConfig(compute_dtype="bfloat16", class_budget=budget))


# ------------------------------------------------------------ (1) configuration
@pytest.mark.parametrize("dataset,int8", [("voc", False), ("coco", False),
                                          ("voc", True)])
def test_bench_config_equals_the_jax_tools(dataset, int8):
    want = _plain(_jax_bench_config(dataset, int8=int8))
    got = _plain(bench_config(dataset, quantized_inference=int8))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert got["model"]["num_classes"] == (21 if dataset == "voc" else 81)
    assert got["par"]["class_budget"] == (10 if dataset == "voc" else 16)


# -------------------------------------------------------- (2) the bf16 Block
def test_gelu_tanh_rounds_as_jax_in_bf16():
    """Bit for bit against ``jax.nn.gelu(approximate=True)`` on bf16 (the
    configuration's hidden activations), op by op and jitted."""
    x = (np.random.RandomState(0).randn(20000) * 3).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda a: jax.nn.gelu(a, approximate=True))(xb)
                      .astype(jnp.float32))
    with jax.disable_jit():
        eager = np.asarray(jax.nn.gelu(xb, approximate=True)
                           .astype(jnp.float32))
    got = gelu_tanh(torch.tensor(np.asarray(xb.astype(jnp.float32)))
                    .to(torch.bfloat16)).float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, eager)


def _blocks(stream, gelu_approximate=True):
    """The JAX ``Block`` of ``bench.py``'s model (bf16 compute, tanh GELU;
    the exact GELU with ``gelu_approximate=False``) on ``stream`` and the
    port's on the same weights (perturbed LayerNorm parameters, so that
    they count), D 64, 4 heads."""
    d, heads = 64, 4
    jdt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[stream]
    jb = JBlock(d, heads, 4.0, jnp.bfloat16, gelu_approximate,
                stream_dtype=jdt)
    x = np.random.RandomState(0).randn(3, 50, d).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    params = jb.init(jax.random.PRNGKey(0), xj)
    params = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(
        jax.random.PRNGKey(1), a.shape), params)
    p = jax.tree.map(np.asarray, params["params"])
    sd = {}
    for n in ("norm1", "norm2"):
        sd[f"{n}.weight"], sd[f"{n}.bias"] = p[n]["scale"], p[n]["bias"]
    for mod, leaf in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
                      ("mlp", "fc2")):
        sd[f"{mod}.{leaf}.weight"] = p[mod][leaf]["kernel"].T
        sd[f"{mod}.{leaf}.bias"] = p[mod][leaf]["bias"]
    tb = Block(d, heads, 4.0, torch.bfloat16, gelu_approximate)
    tb.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in sd.items()})
    tx = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, stream))
    return jb, params, xj, tb, tx


# Bounds over the output's largest magnitude s (8 here): op by op, at most
# one bf16 ulp of s anywhere, 1e-5 * s on average, 1% of elements not equal
# (read: bf16 stream 0.125 ulp, 8.1e-7 * s, 0.15%; fp32 stream 0.5 ulp,
# 3.0e-6 * s, 0.40%); with torch's one-rounding tanh GELU the bf16 stream
# read 4.4e-4 * s on average and 34% unequal.  Jitted, XLA keeps the
# residual sum unrounded into the next LayerNorm (excess precision), so 2
# ulps and 2e-3 * s (read 1 ulp, 6.8e-4 * s).
@pytest.mark.parametrize("stream", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["op_by_op", "jit"])
def test_block_matches_jax(stream, mode):
    jb, params, xj, tb, tx = _blocks(stream)
    if mode == "jit":
        want = jax.jit(jb.apply)(params, xj)
    else:
        with jax.disable_jit():
            want = jb.apply(params, xj)
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        got = tb(tx)
    assert got.dtype == getattr(torch, stream)
    got = got.float().numpy()
    s = np.abs(want).max()
    ulp = 2.0 ** (np.floor(np.log2(s)) - 7)
    err = np.abs(got - want)
    if mode == "jit":
        assert err.max() <= 2 * ulp and err.mean() <= 2e-3 * s
    else:
        assert err.max() <= ulp and err.mean() <= 1e-5 * s
        assert (err > 0).mean() <= 0.01


# ------------------------------------ (3) bench_torch against export.py
def test_pipeline_equals_make_pseudo_label_fn(tmp_path):
    """On the same inputs the benchmark's composition gives what the
    port's pseudo-label program gives, bit for bit."""
    from dupl_tpu_torch.engine.export import make_pseudo_label_fn

    cfg = bench_config("voc", backbone=TINY)
    tt = bench_torch.build(cfg, 3, "cpu")
    batch = tt.put(synthetic_batch(BATCH, crop=CROP))
    with torch.inference_mode():
        ref, lab = bench_torch.cam_par_pipeline(tt, batch)
    live = make_pseudo_label_fn(cfg, tt.model)(
        batch["image"], batch["cls_label"], batch["img_box"])
    assert torch.equal(ref.to(torch.uint8), live[0])
    assert torch.equal(lab.to(torch.uint8), live[1])


# ------------------------------------------------------------ (5) dense labels
def test_dense_labels_equal_the_jax_tools_draws():
    """The ``--density dense`` block of ``tools/bench_components.py``, run
    from its source, against ``dense_labels``."""
    tree = ast.parse((ROOT / "tools/bench_components.py").read_text())
    block, = [n for n in ast.walk(tree) if isinstance(n, ast.If)
              and "dense" in ast.unparse(n.test)]
    code = compile(ast.Module(body=block.body, type_ignores=[]), "dense",
                   "exec")
    for b, nc in ((16, 81), (3, 21)):
        scope = {"b": b, "nc": nc, "batch": {}}
        exec(code, scope)
        want = scope["batch"]["cls_label"]
        got = components.dense_labels(b, nc - 1)
        assert got.dtype == want.dtype and got.shape == (b, nc - 1)
        np.testing.assert_array_equal(got, want)
        assert (got.sum(1) == 20).all()


# ---------------------------------------------------- (6) train_dissect's loss
def test_dissect_loss_and_gradients_match_jax(tmp_path):
    """``dissect_loss`` against ``tools/train_dissect.py:65-72``'s loss in
    fp32 on the same weights and PTC targets: the loss within 1e-6 of
    itself and every gradient leaf within 1e-5 of its largest entry (read
    0 and 1.7e-6; the co-run's re-anchored steps hold 1e-5)."""
    from dupl_tpu_torch.config import voc_config

    # tools/train_dissect.py's recipe, on the tiny ViT in fp32
    over = dict(backbone=TINY, compute_dtype="float32",
                cam_stream_dtype="bfloat16")
    jcfg = jvoc_config(model=JModelConfig(**over), cam_merge_downscale=2)
    tcfg = voc_config(model=dataclasses.replace(voc_config().model, **over),
                      cam_merge_downscale=2)
    assert _plain(tcfg) == _plain(jcfg)
    jt = JTrainer(jcfg)
    params = jt.model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path / "w.npz")
    ckpt.export_weights(path, params)
    model = DualStudent(tcfg.model)
    model.load_state_dict(load_weights(path))
    tt = Trainer(tcfg, model=model, device="cpu")

    batch = synthetic_batch(BATCH, crop=CROP)
    inputs, cls_label = jnp.asarray(batch["image"]), jnp.asarray(
        batch["cls_label"])
    tb = tt.put(batch)
    # one set of PTC targets for both sides (the tool's own, as it times it)
    _, cams_aux = tt._multi_scale_cams(tb["image"])
    t_aff = tt._ptc_targets(cams_aux, tb["cls_label"], tb["img_box"],
                            CROP // 16, high_thre=None, dynamic=False)
    aff = jnp.asarray(t_aff.numpy())

    def loss_fn(p):
        out = jt.model.apply(p, inputs)
        cls_l, ptc_l, sim_l = jt._common_losses(out, cls_label, aff)
        segs_up = jimage_ops.resize_bilinear(out.seg, (CROP, CROP),
                                             batch_dims=2)
        seg_l = jloss_ops.seg_loss(
            segs_up[0], jnp.zeros((BATCH, CROP, CROP), jnp.int32), 255)
        return cls_l + 0.2 * ptc_l + 0.1 * sim_l + 0.2 * seg_l

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    t_loss = train_dissect.dissect_loss(tt, tb["image"], tb["cls_label"],
                                        t_aff)
    model.zero_grad(set_to_none=True)
    t_loss.backward()
    assert abs(t_loss.item() - float(j_loss)) <= 1e-6 * abs(float(j_loss))
    flat = {"/".join(getattr(k, "key", getattr(k, "name", str(k)))
                     for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(j_grads)[0]}
    want = state_dict_from_jax(flat)
    grads = {n: p.grad for n, p in model.named_parameters()}
    worst = 0.0
    for name, w in want.items():
        if "pos_embed" in name:       # frozen in JAX by the optimizer mask
            continue
        g = grads[name]
        assert g is not None, name
        scale = max(w.abs().max().item(), 1e-12)
        worst = max(worst, (g - w).abs().max().item() / scale)
    assert worst <= 1e-5, worst


# ----------------------------------------------------------- (7), (8) the CLIs
CPU = ["--device", "cpu", "--backbone", TINY]


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_bench_torch_cli_on_cpu(capsys):
    assert bench_torch.main(CPU + ["--crop", "32", "--batch", "1"]) == 0
    line = _last_json(capsys.readouterr().out)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "cam_par_crf_inference_voc_vitb"
    assert line["unit"] == "img/s" and line["value"] > 0
    assert abs(line["vs_baseline"] - line["value"] / 2.6) <= 0.01


def test_bench_components_cli_on_cpu(capsys):
    report = components.run(CPU + ["--crop", "32", "--batch", "2",
                                   "--iters", "1"])
    out = capsys.readouterr().out
    keys = {"cam_fwd_scale1.0", "cam_fwd_scale0.5", "cam_fwd_scale1.5",
            "multi_scale_cam_full", "par_refine", "crf_fast", "pipeline",
            "eval_protocol"}          # the JAX tool's report
    assert keys <= set(_last_json(out)) == set(report)
    for row in ("cam_only scale=1.5", "PAR refine", "par propagate (2,16,16,40)",
                "CRF fast", "end-to-end pipeline", "component sum",
                "eval protocol"):
        assert row in out, row


def test_dissect_clis_on_cpu(capsys):
    enc = encoder_dissect.run(CPU + ["--seqs", "2", "--size", "32",
                                     "--iters", "1"])
    out = capsys.readouterr().out
    assert _last_json(out) == enc and enc["mlp_roofline"] is None
    assert "12x Block" in out and "12x exp_attention" in out
    assert enc["mlp_train"] > 0 and "12x Mlp forward and backward" in out
    trd = train_dissect.run(CPU + ["--crop", "32", "--batch", "2",
                                   "--iters", "1"])
    out = capsys.readouterr().out
    assert _last_json(out) == trd and set(trd) == {
        "msc", "strong_augment", "refine", "ptc_targets", "grad", "gmm",
        "optimizer", "full_step"}
    assert "it/s" in out and all(v > 0 for v in trd.values())


def test_bench_torch_without_a_card_exits_nonzero():
    r = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert r.returncode != 0
    line = _last_json(r.stdout)
    assert line["value"] is None and "CUDA" in line["error"]
    assert line["metric"] == "cam_par_crf_inference_voc_vitb"
