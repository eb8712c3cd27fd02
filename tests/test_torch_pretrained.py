"""Port parity for pretrained and reference checkpoints:
``dupl_tpu_torch.models.pretrained`` against ``dupl_tpu.models.pretrained``
on the same synthetic ``.pth`` files (CPU, fp32).  The JAX side's weights go
through its ``export_weights`` and the port's ``load_weights``; the two
packages must give the same bits, accept the same files and refuse the same
files."""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.engine import checkpoint as jckpt
from dupl_tpu.models import pretrained as jpre
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu_torch.config import ModelConfig
from dupl_tpu_torch.models import pretrained as tpre
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
_KW = dict(backbone="test_tiny_patch16", compute_dtype="float32")
D, DEPTH, P, G = 32, 4, 16, 14        # test_tiny_patch16, pretrained grid 14


def timm_state(depth=DEPTH, seed=0):
    """A DeiT-layout state dict of the tiny backbone, with the classifier
    head a DeiT release carries."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    state = {"cls_token": r(1, 1, D), "pos_embed": r(1, G * G + 1, D),
             "patch_embed.proj.weight": r(D, 3, P, P) * 0.05,
             "patch_embed.proj.bias": r(D) * 0.1,
             "norm.weight": 1 + 0.1 * r(D), "norm.bias": 0.1 * r(D),
             "head.weight": r(1000, D), "head.bias": r(1000)}
    for i in range(depth):
        b = f"blocks.{i}."
        state.update({
            b + "norm1.weight": 1 + 0.1 * r(D), b + "norm1.bias": 0.1 * r(D),
            b + "attn.qkv.weight": r(3 * D, D) * D ** -0.5,
            b + "attn.qkv.bias": 0.1 * r(3 * D),
            b + "attn.proj.weight": r(D, D) * D ** -0.5,
            b + "attn.proj.bias": 0.1 * r(D),
            b + "norm2.weight": 1 + 0.1 * r(D), b + "norm2.bias": 0.1 * r(D),
            b + "mlp.fc1.weight": r(4 * D, D) * D ** -0.5,
            b + "mlp.fc1.bias": 0.1 * r(4 * D),
            b + "mlp.fc2.weight": r(D, 4 * D) * (4 * D) ** -0.5,
            b + "mlp.fc2.bias": 0.1 * r(D)})
    return state


def _variant(state, kind):
    """The layouts ``normalize_vit_state_dict`` folds into DeiT naming."""
    s = dict(state)
    if kind == "module":
        return {"module." + k: v for k, v in s.items()}
    if kind == "backbone":
        return {"backbone." + k: v for k, v in s.items()}
    if kind == "encoder":
        return {"encoder." + k: v for k, v in s.items()}
    if kind == "distilled":        # DeiT-distilled heads and token
        g = torch.Generator().manual_seed(5)
        s.update({"dist_token": torch.randn(1, 1, D, generator=g),
                  "head_dist.weight": torch.randn(1000, D, generator=g),
                  "head_dist.bias": torch.randn(1000, generator=g)})
        return s
    if kind == "in21k":            # pre_logits, 21k head, 2-D patch kernel
        g = torch.Generator().manual_seed(6)
        s.pop("head.weight"), s.pop("head.bias")
        s.update({"pre_logits.fc.weight": torch.randn(D, D, generator=g),
                  "pre_logits.fc.bias": torch.randn(D, generator=g),
                  "head.weight": torch.randn(21843, D, generator=g),
                  "head.bias": torch.randn(21843, generator=g),
                  "patch_embed.proj.weight":
                      s["patch_embed.proj.weight"].reshape(D, 3 * P * P)})
        return s
    assert kind == "plain"
    return s


def _wrap(state, wrapper):
    return {"bare": state, "model": {"model": state},
            "state_dict": {"state_dict": state}}[wrapper]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A JAX-initialised tiny dual student, exported: both sides start from
    these weights, so decoder and classifiers are equal too."""
    jmodel = JDualStudent(JModelConfig(**_KW))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("base") / "w.npz")
    jckpt.export_weights(path, params)
    return jmodel, params, path


def _port_model(path):
    model = DualStudent(ModelConfig(**_KW))
    model.load_state_dict(load_weights(path))
    return model.eval()


def _both(base, pth, tmp_path, depth=DEPTH):
    """The port's model after its install, and the JAX params after the JAX
    install as the port reads them back."""
    jmodel, params, path = base
    jparams = jpre.install_pretrained_encoder(
        params, jpre.load_deit_checkpoint(pth, depth))
    out = str(tmp_path / "jax.npz")
    jckpt.export_weights(out, jparams)
    model = _port_model(path)
    tpre.install_pretrained_encoder(model,
                                    tpre.load_deit_checkpoint(pth, depth))
    return model, load_weights(out), jparams


def _assert_bit_equal(model, want):
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("wrapper", ["bare", "model", "state_dict"])
@pytest.mark.parametrize("kind", ["plain", "module", "backbone", "encoder",
                                  "distilled", "in21k"])
def test_deit_checkpoint_matches_jax(base, tmp_path, wrapper, kind):
    """Every wrapper and layout variant: the port's weights equal the JAX
    package's bit for bit, both students carry the file's encoder, and the
    decoder and classifiers are untouched."""
    pth = str(tmp_path / "deit.pth")
    torch.save(_wrap(_variant(timm_state(), kind), wrapper), pth)
    model, want, _ = _both(base, pth, tmp_path)
    _assert_bit_equal(model, want)
    enc = tpre.load_deit_checkpoint(pth, DEPTH)
    assert "head.weight" not in enc and "dist_token" not in enc
    assert enc["patch_embed.proj.weight"].shape == (D, 3, P, P)
    ref = timm_state()
    for student in (model.branch1, model.branch2):
        sd = student.encoder.state_dict()
        assert sorted(sd) == sorted(enc)
        for k, v in sd.items():
            assert torch.equal(v, ref[k]), k
    untouched = _port_model(base[2]).state_dict()
    for k, v in model.state_dict().items():
        if ".encoder." not in k:
            assert torch.equal(v, untouched[k]), k


def test_pretrained_logits_match_jax(base, tmp_path):
    """The installed weights drive both models to the same outputs, within
    tests/test_torch_models.py's fp32 tolerance (atol 1e-4)."""
    pth = str(tmp_path / "deit.pth")
    torch.save({"model": timm_state(seed=3)}, pth)
    model, _, jparams = _both(base, pth, tmp_path)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    want = base[0].apply(jparams, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for name in ("cls", "seg", "cls_aux"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_deeper_checkpoint_into_a_shallower_backbone(base, tmp_path):
    """Six blocks in the file, four in the backbone: both loaders take
    blocks 0-3 and ignore the rest."""
    pth = str(tmp_path / "deep.pth")
    torch.save({"model": timm_state(depth=6)}, pth)
    model, want, _ = _both(base, pth, tmp_path)
    _assert_bit_equal(model, want)
    assert tpre.infer_vit_depth(tpre.normalize_vit_state_dict(
        timm_state(depth=6))) == jpre.infer_vit_depth(
        {k: v.numpy() for k, v in timm_state(depth=6).items()}) == 6


@pytest.mark.parametrize("case", ["missing_key", "too_shallow", "not_vit"])
def test_refuses_what_jax_refuses(base, tmp_path, case):
    """A missing key, a file shallower than the backbone and a dict of no
    ViT raise ``KeyError`` in both packages, naming the same key."""
    state = timm_state()
    if case == "missing_key":
        del state["blocks.2.attn.qkv.bias"]
    elif case == "not_vit":
        state = {"fc.weight": torch.zeros(4, 4)}
    pth = str(tmp_path / "bad.pth")
    torch.save({"model": state}, pth)
    depth = 6 if case == "too_shallow" else DEPTH
    with pytest.raises(KeyError) as want:
        jpre.load_deit_checkpoint(pth, depth)
    with pytest.raises(KeyError) as got:
        tpre.load_deit_checkpoint(pth, depth)
    assert got.value.args == want.value.args
    if case == "not_vit":
        for infer in (jpre.infer_vit_depth, tpre.infer_vit_depth):
            with pytest.raises(ValueError, match="not a ViT"):
                infer(state)


def test_install_refuses_an_unknown_name_or_shape(base):
    model = _port_model(base[2])
    with pytest.raises(KeyError):
        tpre.install_pretrained_encoder(model, {"blocks.9.norm1.weight":
                                                torch.zeros(D)})
    with pytest.raises(ValueError, match="shape"):
        tpre.install_pretrained_encoder(model, {"cls_token":
                                                torch.zeros(1, 1, 2 * D)})


def _siamese(base):
    """A reference-layout ``siamese_network.state_dict()``: the port's
    names are the reference's; the reference encoder's unused head rides
    along."""
    sd = {k: v.clone() for k, v in _port_model(base[2]).state_dict().items()}
    sd["branch1.encoder.head.weight"] = torch.zeros(1000, D)
    sd["branch2.encoder.head.weight"] = torch.zeros(1000, D)
    return sd


@pytest.mark.parametrize("layout", ["plain", "module", "model"])
def test_reference_checkpoint_matches_jax(base, tmp_path, layout):
    """A trained-checkpoint ``.pth`` as DDP saves it (``module.``), plain,
    or wrapped: the port's state dict equals the JAX conversion bit for
    bit and loads strictly."""
    sd = _siamese(base)
    obj = {"plain": sd, "module": {"module." + k: v for k, v in sd.items()},
           "model": {"model": sd}}[layout]
    pth = str(tmp_path / "ref.pth")
    torch.save(obj, pth)
    got = tpre.load_reference_checkpoint(pth)
    out = str(tmp_path / "j.npz")
    jckpt.export_weights(out, jpre.load_reference_checkpoint(pth))
    want = load_weights(out)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = DualStudent(ModelConfig(**_KW))
    model.load_state_dict(got)


def test_reference_checkpoint_refusals(base):
    """No ``branchN.*`` keys: both raise ``ValueError`` naming the branch;
    a branch without its classifier: both raise ``KeyError``."""
    enc = {k: v.numpy() for k, v in timm_state().items()}
    with pytest.raises(ValueError, match="branch1"):
        jpre.convert_siamese_state_dict(enc)
    with pytest.raises(ValueError, match="branch1"):
        tpre.siamese_state_dict(timm_state())
    sd = _siamese(base)
    del sd["branch2.aux_classifier.weight"]
    with pytest.raises(KeyError):
        jpre.convert_siamese_state_dict({k: v.numpy() for k, v in sd.items()})
    with pytest.raises(KeyError):
        tpre.siamese_state_dict(sd)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_converter_tools_write_the_same_npz(base, tmp_path, capsys):
    """``tools/convert_ref_checkpoint.py`` and its port write ``.npz`` files
    equal key for key; the printed summaries agree up to the class count,
    which the JAX tool reads off the branch-stacked kernel's second axis
    (the embed dim, here 32 + 1) and the port off the classifier's rows."""
    pth = str(tmp_path / "ref.pth")
    torch.save({"module." + k: v for k, v in _siamese(base).items()}, pth)
    a, b = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    _tool("convert_ref_checkpoint").convert(pth, a)
    _tool("convert_ref_checkpoint_torch").main(["--input", pth,
                                                "--output", b])
    lines = capsys.readouterr().out.splitlines()
    summary = [line.replace(p_, "X").rsplit(",", 1) for line, p_ in
               zip(lines, (a, b))]
    assert summary[0][0] == summary[1][0]
    assert summary[1][1] == " 21 classes"
    with np.load(a) as ja, np.load(b) as tb:
        assert sorted(ja.files) == sorted(tb.files)
        for k in ja.files:
            assert ja[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(ja[k], tb[k], err_msg=k)


def test_converter_tool_round_trips(base, tmp_path):
    """The port's converter returns the state dict it wrote: the ``.npz``
    reads back through ``load_weights`` bit for bit, with no temp file
    left."""
    pth = str(tmp_path / "ref.pth")
    torch.save(_siamese(base), pth)
    out = str(tmp_path / "w.npz")
    sd = _tool("convert_ref_checkpoint_torch").convert(pth, out,
                                                       verbose=False)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ref.pth", "w.npz"]
    back = load_weights(out)
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
