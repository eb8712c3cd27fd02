"""The port's own copy of the recipe dataclasses (dupl_tpu_torch/config.py)
against the JAX package's (dupl_tpu/config.py): same fields, same defaults,
same recipes, so the copy cannot drift unnoticed."""

import dataclasses

import pytest

import dupl_tpu.config as jcfg
import dupl_tpu_torch.config as tcfg

CLASSES = ("ModelConfig", "OptimConfig", "ParConfig", "GmmConfig",
           "CrfConfig", "DataConfig", "TrainConfig")


def _plain(x):
    """Dataclass instances of either module -> nested plain dicts."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_equal(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    assert tc.__module__ == "dupl_tpu_torch.config"
    jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(jf, tf):
        assert str(a.type) == str(b.type), a.name
        assert _plain(a.default) == _plain(b.default), a.name
    assert _plain(tc()) == _plain(jc())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(tc(), tf[0].name, None)


@pytest.mark.parametrize("recipe", ["voc_config", "coco_config"])
def test_recipes_equal_field_by_field(recipe):
    j, t = getattr(jcfg, recipe)(), getattr(tcfg, recipe)()
    jp, tp = _plain(j), _plain(t)
    assert tp.keys() == jp.keys()
    for key in jp:
        assert tp[key] == jp[key], key
    assert t.num_classes == j.num_classes
    assert t.model.num_fg == j.model.num_fg and t.model.grid == j.model.grid
    # overrides go through dataclasses.replace on both sides
    j2 = getattr(jcfg, recipe)(cam_merge_downscale=2, max_iters=7)
    t2 = getattr(tcfg, recipe)(cam_merge_downscale=2, max_iters=7)
    assert _plain(t2) == _plain(j2)


def test_constants_equal():
    assert tcfg.VOC_CLASS_LIST == jcfg.VOC_CLASS_LIST
    assert tcfg.COCO_CLASS_LIST == jcfg.COCO_CLASS_LIST
    assert tcfg.VOC_HIGH_THRE_TARGETS == jcfg.VOC_HIGH_THRE_TARGETS
    assert len(tcfg.COCO_CLASS_LIST) == 81 and len(tcfg.VOC_CLASS_LIST) == 21


@pytest.mark.parametrize("n_data", [1, 2, 3, 4, 8, 16])
def test_resolve_samples_per_device(n_data):
    for recipe in ("voc_config", "coco_config"):
        jc, jw = jcfg.resolve_samples_per_device(getattr(jcfg, recipe)(), n_data)
        tc, tw = tcfg.resolve_samples_per_device(getattr(tcfg, recipe)(), n_data)
        assert tc.samples_per_device == jc.samples_per_device
        assert tw == jw
    t = tcfg.voc_config(global_batch=None)
    assert tcfg.resolve_samples_per_device(t, n_data) == (t, None)


def test_copy_does_not_load_the_jax_package_config():
    """The module is plain source of its own: no importlib loading, no
    reference to the JAX package's directory."""
    import inspect
    src = inspect.getsource(tcfg)
    assert "importlib" not in src and "spec_from_file_location" not in src
    assert not hasattr(tcfg, "_load")
