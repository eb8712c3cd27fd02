"""The port's sealed artifacts (``dupl_tpu_torch/engine/export.py``), the
counterpart of ``tests/test_export.py``: the sealed serving and
pseudo-label programs against the port's live functions (bit for bit, CPU,
float32), against the JAX package (its live pseudo-label function, its
sealed serving artifact), the unbaked signature, the ``.npz`` path, and the
artifacts ``load_artifact`` refuses.  Tiny ViT, crop 64, weights written by
the JAX package."""

import json
import struct

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.config import DataConfig as JDataConfig
from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.config import voc_config as j_voc_config
from dupl_tpu.data.pipeline import synthetic_batch
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.engine import export as jexport
from dupl_tpu.engine.train import Trainer
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu_torch.config import DataConfig, ModelConfig, voc_config
from dupl_tpu_torch.engine import export
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent

torch.set_num_threads(2)

_MODEL = dict(backbone="test_tiny_patch16", compute_dtype="float32")
CROP, BATCH = 64, 2
SCALES = (1.0, 0.5)            # tests/test_export.py's round trip
# tests/test_torch_pseudo_label.py's bound: argmaxes over fp32 values that
# the two frameworks round in different orders may flip near a tie
AGREE = 0.995


def _cfgs():
    return (voc_config(model=ModelConfig(**_MODEL),
                       data=DataConfig(crop_size=CROP)),
            j_voc_config(model=JModelConfig(**_MODEL),
                         data=JDataConfig(crop_size=CROP)))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """JAX-initialised weights, written as the JAX package writes them."""
    _, jcfg = _cfgs()
    jmodel = JDualStudent(jcfg.model)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, CROP, CROP, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    return jmodel, params, path


def _model(path):
    cfg, _ = _cfgs()
    model = DualStudent(cfg.model)
    model.load_state_dict(load_weights(path))
    return model.eval()


def _images(n=BATCH, seed=0):
    """Smooth colour fields with blocks, so the CRF has edges to follow."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:CROP, 0:CROP] / CROP
    out = []
    for _ in range(n):
        img = np.stack([np.sin(6 * xx * rs.rand() + rs.rand() * 6),
                        np.cos(5 * yy * rs.rand() + rs.rand() * 6),
                        xx * yy], -1)
        y0, x0 = rs.randint(0, CROP // 2, 2)
        img[y0:y0 + 24, x0:x0 + 24] = rs.rand(3)
        out.append(np.clip(127.5 * (img + 1) + 10 * rs.randn(CROP, CROP, 3),
                           0, 255))
    return np.stack(out).astype(np.uint8)


@pytest.fixture(scope="module")
def sealed(weights, tmp_path_factory):
    """Sealed serving programs by (branch, crf) at ``SCALES``, each exported
    once, written and read back: -> (loaded module, metadata, path,
    exported program)."""
    _, _, path = weights
    cfg, _ = _cfgs()
    out_dir = tmp_path_factory.mktemp("art")
    cache = {}

    def get(branch, crf):
        key = (branch, crf)
        if key not in cache:
            exported, meta = export.export_serving(
                cfg, _model(path), batch_size=BATCH, scales=SCALES,
                branch=branch, crf=crf, device="cpu")
            art = str(out_dir / f"{len(cache)}.duplsrv")
            export.save_artifact(art, exported, meta)
            loaded, meta2 = export.load_artifact(art)
            assert meta2 == meta
            cache[key] = (loaded.module(), meta, art, exported)
        return cache[key]

    return get


def _live(path, **kw):
    cfg, _ = _cfgs()
    return export.make_serving_fn(cfg, _model(path), **kw)


def _dupl_ops(exported):
    """The ``dupl::`` ops of a program's graph, its ``torch.cond`` branches
    included."""
    return {str(n.target) for m in exported.graph_module.modules()
            if isinstance(m, torch.fx.GraphModule) for n in m.graph.nodes
            if str(n.target).startswith("dupl.")}


@pytest.mark.parametrize("branch", [1, "ensemble"])
@pytest.mark.parametrize("crf", [True, False])
def test_sealed_serving_matches_live(weights, sealed, branch, crf):
    """Exported, written, read back and called: the live function's labels
    bit for bit (same program, same device)."""
    _, _, path = weights
    program, meta, _, exported = sealed(branch, crf)
    imgs = torch.from_numpy(_images())
    with torch.no_grad():
        got = program(imgs)
    want = _live(path, scales=SCALES, branch=branch, crf=crf)(imgs)
    assert got.dtype == torch.uint8 and got.shape == (BATCH, CROP, CROP)
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 1
    assert meta["runtime"] == "torch" and meta["platforms"] == ["cpu"]
    assert meta["kind"] == "segmentation" and meta["branch"] == branch
    assert ("dupl.crf_apply.default" in _dupl_ops(exported)) == crf
    # the position tables' bicubic weights and the ImageNet statistics are
    # constants of the program, not rebuilt (and copied) on every call
    targets = {str(n.target) for n in exported.graph.nodes}
    assert "aten.index_put_.default" not in targets
    assert {tuple(c.shape) for c in exported.constants.values()} >= {(3,)}


def test_unbaked_signature_matches_baked(weights, sealed):
    """``bake_params=False``: a ``(params, images)`` program with no weights
    of its own, called with the ``.npz``'s weights, equals the baked one."""
    _, _, path = weights
    cfg, _ = _cfgs()
    exported, meta = export.export_serving(
        cfg, _model(path), batch_size=BATCH, scales=SCALES, branch=1,
        crf=False, device="cpu", bake_params=False)
    assert meta["bake_params"] is False and not exported.state_dict
    imgs = torch.from_numpy(_images(seed=3))
    with torch.no_grad():
        got = exported.module()(load_weights(path), imgs)
        want = sealed(1, False)[0](imgs)
    assert torch.equal(got, want)


def test_branch_differs_from_ensemble(sealed):
    imgs = torch.from_numpy(_images(seed=4))
    with torch.no_grad():
        one = sealed(1, False)[0](imgs)
        both = sealed("ensemble", False)[0](imgs)
    assert not torch.equal(one, both)
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="branch"):
        export.export_serving(cfg, DualStudent(cfg.model), branch=3,
                              device="cpu")


def test_unported_options_refused():
    cfg, _ = _cfgs()
    model = DualStudent(cfg.model)
    with pytest.raises(ValueError, match="platform"):
        export.export_serving(cfg, model, platform="tpu", device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        export.export_pseudo_labeler(cfg, model, mesh=object(), device="cpu")


def test_export_from_config(weights, tmp_path):
    """The ``.npz`` -> ``.duplsrv`` path of tools/export_model_torch.py."""
    _, _, path = weights
    cfg, _ = _cfgs()
    out = str(tmp_path / "m.duplsrv")
    meta = export.export_from_config(cfg, path, out, batch_size=BATCH,
                                     scales=(1.0,), branch=2, crf=False,
                                     device="cpu")
    assert meta["branch"] == 2 and meta["num_classes"] == cfg.num_classes
    loaded, _ = export.load_artifact(out)
    imgs = torch.from_numpy(_images(seed=5))
    with torch.no_grad():
        got = loaded.module()(imgs)
    assert torch.equal(got, _live(path, scales=(1.0,), branch=2,
                                  crf=False)(imgs))


def test_sealed_serving_matches_jax_artifact(weights, sealed, tmp_path):
    """The port's sealed serving program against the JAX package's sealed
    artifact (export_serving -> save_artifact -> load_artifact -> call) on
    the same weights and images, ensemble and CRF: at least 99.5% of labels
    equal (``test_serving_fn_matches_jax``'s bound).  The JAX artifact is
    then refused by the port's loader."""
    jmodel, params, _ = weights
    _, jcfg = _cfgs()
    imgs = _images(seed=6)
    jexp, jmeta = jexport.export_serving(jcfg, jmodel, params,
                                         batch_size=BATCH, scales=SCALES)
    jpath = str(tmp_path / "jax.duplsrv")
    jexport.save_artifact(jpath, jexp, jmeta)
    want = np.asarray(jax.jit(jexport.load_artifact(jpath)[0].call)(
        jnp.asarray(imgs)))
    program = sealed("ensemble", True)[0]
    with torch.no_grad():
        got = program(torch.from_numpy(imgs)).numpy()
    assert got.shape == want.shape == (BATCH, CROP, CROP)
    assert (got == want).mean() >= 0.995
    assert len(np.unique(want)) > 1
    with pytest.raises(ValueError, match="runtime"):
        export.load_artifact(jpath)


def _rewrite_meta(src, dst, change):
    with open(src, "rb") as f:
        magic = f.read(8)
        (n,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(n))
        payload = f.read()
    change(meta)
    blob = json.dumps(meta, sort_keys=True).encode()
    with open(dst, "wb") as f:
        f.write(magic + struct.pack("<Q", len(blob)) + blob + payload)


def test_load_artifact_refusals(sealed, tmp_path):
    junk = str(tmp_path / "junk.duplsrv")
    with open(junk, "wb") as f:
        f.write(b"NOTDUPL!" + b"\0" * 32)
    with pytest.raises(ValueError, match="not a DuPL serving artifact"):
        export.load_artifact(junk)

    art = sealed(1, False)[2]
    stale = str(tmp_path / "stale.duplsrv")

    def other_kernel(meta):
        meta["kernels"]["dupl::crf_apply"] = "0" * 16

    _rewrite_meta(art, stale, other_kernel)
    with pytest.raises(ValueError, match="dupl::crf_apply"):
        export.load_artifact(stale)
    _rewrite_meta(art, stale, lambda meta: meta.pop("runtime"))
    with pytest.raises(ValueError, match="runtime"):
        export.load_artifact(stale)


@pytest.fixture(scope="module")
def labeler(weights, tmp_path_factory):
    """The sealed pseudo-label program at batch 4 (written and read back),
    the live one, the JAX package's, and their inputs (uint8 wire format
    as tests/test_torch_pseudo_label.py quantises them)."""
    _, _, path = weights
    cfg, jcfg = _cfgs()
    exported, meta = export.export_pseudo_labeler(cfg, _model(path),
                                                  batch_size=4, device="cpu")
    art = str(tmp_path_factory.mktemp("pl") / "pl.duplsrv")
    export.save_artifact(art, exported, meta)
    loaded, _ = export.load_artifact(art)
    batch = synthetic_batch(4, crop=CROP, num_fg=20)
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    image01 = np.clip(batch["image"] * std + mean, 0.0, 1.0)
    img_box = batch["img_box"].astype(np.int32)
    img_box[1] = [0, CROP, 0, CROP]
    img_box[2] = [6, 50, 14, CROP]
    trainer = Trainer(jcfg)
    return dict(exported=exported, meta=meta, program=loaded.module(),
                live=export.make_pseudo_label_fn(cfg, _model(path)),
                jfn=jax.jit(jexport.make_pseudo_label_fn(jcfg, trainer)),
                params=weights[1], cls=batch["cls_label"], img_box=img_box,
                images=np.round(image01 * 255.0).astype(np.uint8))


@pytest.mark.parametrize("fallback", [False, True])
def test_sealed_pseudo_labeler(labeler, fallback):
    """Both class-budget routes sealed in one program (``torch.cond``): the
    live port's labels bit for bit, and the JAX package's at ``AGREE``."""
    cls = labeler["cls"].copy()
    if fallback:       # 12 present foreground classes: past class_budget 10
        cls[0, :12] = 1
    args = (labeler["images"], cls, labeler["img_box"])
    targs = tuple(map(torch.from_numpy, args))
    with torch.no_grad():
        s_ref, s_crf = labeler["program"](*targs)
    l_ref, l_crf = labeler["live"](*targs)
    assert s_ref.dtype == s_crf.dtype == torch.uint8
    assert s_ref.shape == (2, 4, CROP, CROP) and s_crf.shape == (4, CROP, CROP)
    assert torch.equal(s_ref, l_ref) and torch.equal(s_crf, l_crf)
    j_ref, j_crf = map(np.asarray, labeler["jfn"](labeler["params"],
                                                  *map(jnp.asarray, args)))
    for br in range(2):
        assert (s_ref[br].numpy() == j_ref[br]).mean() >= AGREE
    assert (s_crf.numpy() == j_crf).mean() >= AGREE
    assert (s_ref.numpy() == 255).any()


def test_pseudo_labeler_graph_and_meta(labeler):
    assert {"dupl.par_affinity.default", "dupl.par_propagate.default",
            "dupl.crf_apply.default"} <= _dupl_ops(labeler["exported"])
    assert any("cond" in str(n.target)
               for n in labeler["exported"].graph.nodes)
    meta = labeler["meta"]
    assert meta["kind"] == "pseudo_labeler" and meta["ignore_index"] == 255
    assert meta["runtime"] == "torch" and meta["batch_size"] == 4
    assert meta["input"].startswith("uint8[4,64,64,3]")
