"""The port's checkpointing (dupl_tpu_torch/engine/checkpoint.py) and the
weight bridge's way back (models/convert.py:state_dict_to_jax): the full
training state round-trips, and an exported ``.npz`` loads in both
packages."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.engine import checkpoint as jckpt
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu_torch import config as tconfig
from dupl_tpu_torch.data.pipeline import synthetic_batch
from dupl_tpu_torch.engine import checkpoint as ckpt
from dupl_tpu_torch.engine.train import Trainer
from dupl_tpu_torch.models.convert import (load_model, load_weights,
                                           state_dict_from_jax,
                                           state_dict_to_jax)
from dupl_tpu_torch.ops import augment

torch.set_num_threads(2)

_KW = dict(backbone="test_tiny_patch16", compute_dtype="float32")


def _cfg(**over):
    base = tconfig.voc_config()
    return tconfig.voc_config(
        model=dataclasses.replace(base.model, **_KW),
        optim=tconfig.OptimConfig(lr=1e-4, warmup_iters=2, warmup_ratio=0.1),
        par=dataclasses.replace(base.par, num_iter=2),
        cam_iters=1, gmm_iters=2, max_iters=20, cam_merge_downscale=2, **over)


@pytest.fixture(scope="module")
def trained():
    """A tiny trainer after three steps (warm-up, seg, full): every
    parameter group has moments, the decoder's count lags the encoder's,
    and the generator has drawn once."""
    cfg = _cfg()
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    batch = synthetic_batch(2, crop=64)
    for _ in range(3):
        trainer.train_step(state, batch)
    return cfg, trainer, state, batch


def test_full_state_round_trip(trained, tmp_path):
    cfg, trainer, state, batch = trained
    path = ckpt.save_state(str(tmp_path), state)
    assert os.path.basename(path) == "step_3.pt"
    assert ckpt.latest_step(str(tmp_path)) == 3

    fresh_trainer = Trainer(cfg, device="cpu")
    fresh = fresh_trainer.init_state(seed=123)    # other weights, step 0
    assert not torch.equal(fresh.model.branch1.classifier.weight,
                           state.model.branch1.classifier.weight)
    restored = ckpt.restore_state(str(tmp_path), fresh)
    assert restored is fresh and restored.step == 3
    assert restored.optimizer.global_step == 3
    for (n, p), q in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        assert torch.equal(p, q), n
    want = state.optimizer.state_dict()["state"]
    got = restored.optimizer.state_dict()["state"]
    assert want.keys() == got.keys() and len(want) > 0
    for i in want:
        assert got[i]["step"] == want[i]["step"]
        assert torch.equal(got[i]["exp_avg"], want[i]["exp_avg"])
        assert torch.equal(got[i]["exp_avg_sq"], want[i]["exp_avg_sq"])
    dec = restored.model.branch1.decoder.conv8.weight
    enc = restored.model.branch1.encoder.cls_token
    assert restored.optimizer.state[dec]["step"] == 2
    assert restored.optimizer.state[enc]["step"] == 3
    # the next draw of the strong view's ops, and the next step, are equal
    a = augment.draw_ops(state.rng, cfg.aug_n, 2)
    b = augment.draw_ops(restored.rng, cfg.aug_n, 2)
    assert torch.equal(a, b)
    _, m1 = trainer.train_step(state, batch)
    _, m2 = fresh_trainer.train_step(restored, batch)
    assert torch.equal(m1["loss"], m2["loss"])


def test_prune_temp_names_and_latest_step(trained, tmp_path):
    _, _, state, _ = trained
    d = str(tmp_path / "ck")
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore_state(d, state)
    keep_step = state.step
    try:
        for step in (2, 5, 9, 12):
            state.step = step
            ckpt.save_state(d, state, keep=3)
    finally:
        state.step = keep_step
    assert sorted(os.listdir(d)) == ["step_12.pt", "step_5.pt", "step_9.pt"]
    # what an interrupted save leaves behind, and strangers, are ignored
    for junk in ("step_500.pt.tmp-4242", "step_.pt", "step_7.txt", "weights.npz"):
        open(os.path.join(d, junk), "w").close()
    assert ckpt._step_of("step_500.pt.tmp-4242") is None
    assert ckpt._step_of("step_12.pt") == 12
    assert ckpt.latest_step(d) == 12
    state.step = 13
    try:
        ckpt.save_state(d, state, keep=1)
    finally:
        state.step = keep_step
    assert {e for e in os.listdir(d) if ckpt._step_of(e) is not None} == {
        "step_13.pt"}
    assert os.path.exists(os.path.join(d, "step_500.pt.tmp-4242"))
    with pytest.raises(ValueError, match="keep"):
        ckpt.save_state(d, state, keep=0)


@pytest.fixture(scope="module")
def jax_params():
    jmodel = JDualStudent(JModelConfig(**_KW))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    return jmodel, params


def _flat(params):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["/".join(getattr(k, "key", getattr(k, "name", str(k)))
                     for k in kp)] = np.asarray(leaf)
    return out


def test_bridge_back_is_the_inverse(jax_params):
    flat = _flat(jax_params[1])
    back = state_dict_to_jax(state_dict_from_jax(flat))
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype and back[k].shape == flat[k].shape
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    with pytest.raises(KeyError, match="not a DualStudent"):
        state_dict_to_jax({"encoder.cls_token": torch.zeros(1)})


def test_exported_weights_load_in_both_packages(trained, jax_params, tmp_path):
    """export_weights -> the JAX package's ``load_weights`` -> JAX logits
    equal the port's within atol 1e-4 (fp32 summation order; the tolerance
    of tests/test_torch_models.py); and the port's own ``load_model`` reads
    the file back exactly."""
    cfg, _, state, _ = trained
    jmodel, template = jax_params
    path = str(tmp_path / "weights.npz")
    ckpt.export_weights(path, state.model.state_dict())
    assert os.listdir(tmp_path) == ["weights.npz"]      # no temp file left
    params = jckpt.load_weights(path, template)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    j_out = jmodel.apply(params, jnp.asarray(x))
    state.model.eval()
    with torch.no_grad():
        t_out = state.model(torch.from_numpy(x))
    for name in ("cls", "seg", "fmap", "cls_aux"):
        np.testing.assert_allclose(getattr(t_out, name).numpy(),
                                   np.asarray(getattr(j_out, name)), rtol=0,
                                   atol=1e-4, err_msg=name)
    again = load_model(cfg, path, "cpu")
    for (n, p), q in zip(state.model.named_parameters(), again.parameters()):
        assert torch.equal(p, q), n
    assert load_weights(path).keys() == state.model.state_dict().keys()
