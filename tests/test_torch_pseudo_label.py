"""The pseudo-label slice as a whole: the port's ``make_pseudo_label_fn``
(multi-scale CAM of both students -> PAR -> pseudo-labels, fast CRF) against
the JAX package's on the same weights and inputs (tiny ViT, crop 128,
batch 4, CPU, float32), and the ``engine/train.py`` refine entry against
``Trainer._refine``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.config import DataConfig as JDataConfig
from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.config import voc_config as jvoc_config
from dupl_tpu.data.pipeline import synthetic_batch
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.engine.export import make_pseudo_label_fn as jmake_pseudo_label_fn
from dupl_tpu.engine.train import Trainer
from dupl_tpu_torch.config import DataConfig, ModelConfig, voc_config
from dupl_tpu_torch.engine import train as ttrain
from dupl_tpu_torch.engine.export import make_pseudo_label_fn
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent

torch.set_num_threads(2)
CROP, BATCH = 128, 4
_KW = dict(backbone="test_tiny_patch16", compute_dtype="float32")
# Labels come from argmaxes over fp32 values that the two frameworks round
# in different orders (ViT, PAR, CRF), so a pixel near a tie may flip.
AGREE = 0.995


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = jvoc_config(model=JModelConfig(**_KW),
                       data=JDataConfig(crop_size=CROP))
    tcfg = voc_config(model=ModelConfig(**_KW), data=DataConfig(crop_size=CROP))
    trainer = Trainer(jcfg)
    params = trainer.model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    model = DualStudent(tcfg.model)
    model.load_state_dict(load_weights(path))
    model.eval()

    batch = synthetic_batch(BATCH, crop=CROP, num_fg=20)
    # uint8 wire format, quantised as tests/test_export.py does
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    image01 = np.clip(batch["image"] * std + mean, 0.0, 1.0)
    images = np.round(image01 * 255.0).astype(np.uint8)
    img_box = batch["img_box"].copy()
    img_box[1] = [0, CROP, 0, CROP]                 # one full, one partial box
    img_box[2] = [10, 90, 30, CROP]
    return dict(jcfg=jcfg, tcfg=tcfg, trainer=trainer, params=params,
                model=model, images=images, cls=batch["cls_label"],
                img_box=img_box, jfn=jax.jit(jmake_pseudo_label_fn(jcfg,
                                                                   trainer)))


def _cls(setup, fallback):
    cls = setup["cls"].copy()
    if fallback:   # 12 present foreground classes: past class_budget 10
        cls[0, :12] = 1
    return cls


@pytest.mark.parametrize("fallback", [False, True])
def test_pseudo_label_fn_matches_jax(setup, fallback):
    cls = _cls(setup, fallback)
    args = (setup["images"], cls, setup["img_box"])
    j_ref, j_crf = map(np.asarray, setup["jfn"](setup["params"],
                                                *map(jnp.asarray, args)))
    fn = make_pseudo_label_fn(setup["tcfg"], setup["model"])
    t_ref, t_crf = fn(*map(torch.from_numpy, args))
    assert t_ref.dtype == t_crf.dtype == torch.uint8
    assert t_ref.shape == j_ref.shape == (2, BATCH, CROP, CROP)
    assert t_crf.shape == j_crf.shape == (BATCH, CROP, CROP)
    ign = setup["tcfg"].ignore_index
    assert (j_ref == ign).any() and (t_ref.numpy() == ign).any()
    assert int(t_crf.max()) <= 20
    for br in range(2):
        agree = (t_ref[br].numpy() == j_ref[br]).mean()
        assert agree >= AGREE, (br, agree)
    assert (t_crf.numpy() == j_crf).mean() >= AGREE


def test_refine_entry_matches_trainer(setup):
    """``engine/train.py:refine`` against ``Trainer._refine`` on the same
    branch-stacked CAMs, with a per-sample high threshold."""
    rs = np.random.RandomState(0)
    cls = _cls(setup, False)
    cams = rs.rand(2, BATCH, CROP // 2, CROP // 2, 20).astype(np.float32)
    cams[..., 3] += np.linspace(0, 1, CROP // 2, dtype=np.float32)[:, None]
    image01 = setup["images"].astype(np.float32) / 255.0
    high = np.asarray([0.7, 0.6, 0.65, 0.55], np.float32)
    want = np.asarray(setup["trainer"]._refine(
        jnp.asarray(cams), jnp.asarray(image01), jnp.asarray(cls),
        jnp.asarray(setup["img_box"]), high_thre=jnp.asarray(high)))
    got = ttrain.refine(setup["tcfg"], torch.from_numpy(cams),
                        torch.from_numpy(image01), torch.from_numpy(cls),
                        torch.from_numpy(setup["img_box"]),
                        high_thre=torch.from_numpy(high))
    assert got.shape == want.shape == (2, BATCH, CROP, CROP)
    assert (got.numpy() == want).mean() >= 0.999
    assert (want == 255).any()


def test_profile_helpers():
    """The profiling module's inputs and its reading of a trace: device
    busy time is the union of the device intervals, host ops excluded."""
    from dupl_tpu_torch.engine.profile import (device_busy_us, kernel_table,
                                               pseudo_label_inputs)

    images, cls, box = pseudo_label_inputs(4, 64, seed=1)
    assert images.shape == (4, 64, 64, 3) and images.dtype == np.uint8
    assert cls.shape == (4, 20) and set(cls.sum(1)) <= {1.0, 2.0, 3.0}
    assert (box[0::2] == [0, 64, 0, 64]).all()
    assert (box[1::2] != [0, 64, 0, 64]).any(axis=1).all()
    events = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 10},
              {"ph": "X", "cat": "kernel", "name": "b", "ts": 5, "dur": 10},
              {"ph": "X", "cat": "kernel", "name": "a", "ts": 40, "dur": 2},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30,
               "dur": 5},
              {"ph": "X", "cat": "cpu_op", "name": "d", "ts": 0, "dur": 100}]
    assert device_busy_us(events) == (22, 0, 42)
    assert device_busy_us([]) == (0.0, 0.0, 0.0)
    assert kernel_table(events) == {"a": [0.012, 2], "b": [0.01, 1]}
    # names that differ only past the 90th character are one row
    long = [{"ph": "X", "cat": "kernel", "name": "k" * 90 + s, "ts": 0,
             "dur": d} for s, d in (("x", 3), ("y", 4))]
    assert kernel_table(long) == {"k" * 90: [0.007, 2]}
