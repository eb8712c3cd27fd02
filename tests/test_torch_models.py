"""Port parity: dupl_tpu_torch.models against dupl_tpu.models through the
weight bridge, on the same numpy inputs (CPU).  The JAX package initialises
the weights; ``checkpoint.export_weights`` writes them; the port loads them
with ``models.convert.load_weights``."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu.models.pretrained import convert_siamese_state_dict
from dupl_tpu_torch.config import ModelConfig
from dupl_tpu_torch.models.convert import init_weights, load_weights
from dupl_tpu_torch.models.network import DualStudent

torch.set_num_threads(2)

_KW = dict(backbone="test_tiny_patch16", compute_dtype="float32")


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    """JAX-initialised tiny dual student, exported and loaded by the port."""
    jmodel = JDualStudent(JModelConfig(**_KW))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    return jmodel, params, path


def _port(path, **over):
    model = DualStudent(ModelConfig(**{**_KW, **over}))
    model.load_state_dict(load_weights(path))
    return model.eval()


def test_weight_bridge_round_trip(bridged):
    """JAX params -> .npz -> port state_dict -> convert_siamese_state_dict
    (the reference-checkpoint converter) -> the same JAX params, exactly."""
    _, params, path = bridged
    sd = {k: v.numpy() for k, v in _port(path).state_dict().items()}
    back = convert_siamese_state_dict(sd)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for kp, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[kp]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(kp))


def _image(size, seed=0, batch=2):
    return np.random.RandomState(seed).randn(batch, size, size, 3).astype(
        np.float32)


@pytest.mark.parametrize("size", [64, 224])  # 224: N = 197 tokens
def test_vit_and_dual_student_match_jax(bridged, size):
    """fp32 on both sides, exact-softmax attention on both sides (CPU);
    atol 1e-4 on outputs of magnitude ~1-10 (fp32 summation order)."""
    jmodel, params, path = bridged
    x = _image(size)
    model = _port(path)
    with torch.no_grad():
        t_vit = model.branch1.encoder(torch.from_numpy(x))
        t_out = model(torch.from_numpy(x))
    b1 = jmodel.branch(params, 0)
    j_vit = jmodel.module.apply(b1, jnp.asarray(x),
                                method=lambda m, z: m.encoder(z))
    j_out = jmodel.apply(params, jnp.asarray(x))
    for t, j in zip(t_vit, j_vit):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-4)
    for name in ("cls", "seg", "fmap", "cls_aux"):
        t, j = getattr(t_out, name), getattr(j_out, name)
        assert t.shape == j.shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_bf16_compute_matches_jax(bridged):
    """compute_dtype bf16 on both sides: the frameworks round matmul outputs,
    GELU and attention probabilities at slightly different places, so
    seg logits agree to 5e-2 of their scale, not to fp32 accuracy."""
    _, params, path = bridged
    x = _image(64, seed=1)
    jmodel = JDualStudent(JModelConfig(**{**_KW, "compute_dtype": "bfloat16"}))
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)).seg)
    with torch.no_grad():
        got = _port(path, compute_dtype="bfloat16")(torch.from_numpy(x)).seg
    err = np.abs(got.numpy() - want).max()
    assert err <= 5e-2 * np.abs(want).max(), (err, np.abs(want).max())


def test_seeded_init_is_deterministic_and_scaled():
    cfg = ModelConfig(**_KW)
    a, b = DualStudent(cfg), DualStudent(cfg)
    init_weights(a, torch.Generator().manual_seed(0))
    init_weights(b, torch.Generator().manual_seed(0))
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    w = a.branch1.encoder.blocks[0].mlp.fc1.weight       # lecun: var 1/fan_in
    assert abs(w.std().item() - w.shape[1] ** -0.5) < 0.2 * w.shape[1] ** -0.5
    assert a.branch1.encoder.norm.weight.eq(1).all()
    assert a.branch1.encoder.blocks[0].attn.qkv.bias.eq(0).all()
    assert not torch.equal(a.branch1.encoder.pos_embed,
                           a.branch2.encoder.pos_embed)
