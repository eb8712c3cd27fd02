"""The port's PolyWarmupAdamW (dupl_tpu_torch/engine/optimizer.py) against
the JAX package's optax transform on shared gradients: three updates across
the warm-up boundary from equal parameters; parameters, moments and counts
equal to 1e-6 relative (float32 elementwise arithmetic), and each parameter
within 2e-5 of its group's step size besides: jax evaluates the bias
correction ``1 - 0.999 ** t`` in float32, where it cancels to a relative
error of 1.3e-5; the port evaluates it in Python doubles, as torch's AdamW
does."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from dupl_tpu.config import ModelConfig as JModelConfig
from dupl_tpu.config import OptimConfig as JOptimConfig
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.engine import optimizer as joptimizer
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu_torch.config import ModelConfig, OptimConfig
from dupl_tpu_torch.engine import optimizer
from dupl_tpu_torch.models.convert import (load_weights,
                                           optimizer_state_from_jax,
                                           state_dict_from_jax)
from dupl_tpu_torch.models.network import DualStudent

torch.set_num_threads(2)
_KW = dict(backbone="test_tiny_patch16", compute_dtype="float32")
_OPT = dict(lr=1e-3, warmup_iters=2, warmup_ratio=0.1)
MAX_ITERS = 20
RTOL = 1e-6


def flat(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(getattr(k, "key", getattr(k, "name", str(k)))
                       for k in kp)
        out[key] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jmodel = JDualStudent(JModelConfig(**_KW))
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 32, 32, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    ckpt.export_weights(path, params)
    rs = np.random.RandomState(0)
    # three shared gradient trees; tiny entries keep Adam out of its
    # sign-like regime's ties, zeros test the eps path
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rs.standard_normal(p.shape).astype(np.float32)
        * (rs.rand(*p.shape) > 0.1)), params) for _ in range(3)]
    return params, path, grads


def _run_jax(params, grads, warmup_steps):
    jopt = JOptimConfig(**_OPT)
    tx = joptimizer.make_optimizer(jopt, params, MAX_ITERS)
    tx_warm = joptimizer.make_optimizer(jopt, params, MAX_ITERS,
                                        inactive=("decoder",))
    state = tx.init(params)
    track = []
    for i, g in enumerate(grads):
        upd, state = (tx_warm if i < warmup_steps else tx).update(
            g, state, params)
        params = optax.apply_updates(params, upd)
        track.append((params, state))
    return track


def _torch_model(path):
    model = DualStudent(ModelConfig(**_KW))
    model.load_state_dict(load_weights(path))
    return model


def _assert_state_equal(model, opt, jparams, jstate, step):
    want_p = state_dict_from_jax(flat(jparams))
    want_m = state_dict_from_jax(flat(jstate.mu))
    want_v = state_dict_from_jax(flat(jstate.nu))
    counts = flat(jstate.count)
    assert opt.global_step == int(jstate.step) == step
    seen = 0
    lr_max = _OPT["lr"]      # the schedule's peak; every step is below it
    for name, p in model.named_parameters():
        mult = 1.0 if optimizer.group_of(name) == "base" else 10.0
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=RTOL, atol=2e-5 * lr_max * mult,
                                   err_msg=name)
        st = opt.state.get(p, {})
        m = st["exp_avg"].numpy() if st else np.zeros(p.shape, np.float32)
        v = st["exp_avg_sq"].numpy() if st else np.zeros(p.shape, np.float32)
        # an entry where b1*m and (1-b1)*g nearly cancel carries the
        # rounding of its terms: 1e-6 of the leaf's scale
        for got, want in ((m, want_m[name].numpy()), (v, want_v[name].numpy())):
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=name,
                                       atol=RTOL * np.abs(want).max())
        seen += 1
    assert seen == len(want_p)
    return counts


def test_three_updates_across_the_warmup_boundary(setup):
    params, path, grads = setup
    track = _run_jax(params, grads, warmup_steps=2)
    model = _torch_model(path)
    opt = optimizer.PolyWarmupAdamW(model, OptimConfig(**_OPT), MAX_ITERS)
    pos0 = model.branch1.encoder.pos_embed.detach().clone()
    dec0 = {n: p.detach().clone() for n, p in model.named_parameters()
            if ".decoder." in n}
    assert dec0 and not model.branch1.encoder.pos_embed.requires_grad
    for i, g in enumerate(grads):
        tg = state_dict_from_jax(flat(g))
        opt.zero_grad(set_to_none=True)
        for name, p in model.named_parameters():
            warm_decoder = i < 2 and ".decoder." in name
            if p.requires_grad and not warm_decoder:
                p.grad = tg[name].clone()
        opt.step()
        jparams, jstate = track[i]
        counts = _assert_state_equal(model, opt, jparams, jstate, i + 1)
        for name, p in model.named_parameters():
            st = opt.state.get(p, {})
            if ".decoder." in name:
                # untouched, no moments and no count during warm-up
                assert st.get("step", 0) == max(0, i - 1), name
                if i < 2:
                    assert torch.equal(p.detach(), dec0[name]) and not st
            elif p.requires_grad:
                assert st["step"] == i + 1
        key = "params/decoder/conv6/kernel"
        assert int(counts[key]) == max(0, i - 1)
        assert int(counts["params/encoder/cls_token"]) == i + 1
    assert torch.equal(model.branch1.encoder.pos_embed.detach(), pos0)
    assert model.branch2.encoder.pos_embed.grad is None


def test_groups_and_lr_multipliers():
    model = DualStudent(ModelConfig(**_KW))
    opt = optimizer.PolyWarmupAdamW(model, OptimConfig(), 20000)
    groups = {g["name"]: g for g in opt.param_groups}
    assert list(groups) == ["base", "head", "decoder"]
    assert groups["base"]["lr_mult"] == 1.0
    assert groups["head"]["lr_mult"] == groups["decoder"]["lr_mult"] == 10.0
    assert sorted(groups["head"]["names"]) == sorted(
        f"branch{b}.{h}.weight" for b in (1, 2)
        for h in ("classifier", "aux_classifier"))
    assert all(".decoder." in n for n in groups["decoder"]["names"])
    every = sum((g["names"] for g in opt.param_groups), [])
    assert not any("pos_embed" in n for n in every)
    assert len(every) == len(dict(model.named_parameters())) - 2
    assert optimizer.group_of("branch1.encoder.norm.weight") == "base"
    assert optimizer.group_of("branch2.encoder.pos_embed") == "frozen"


@pytest.mark.parametrize("step", [0, 1, 1499, 1500, 19999, 20000])
def test_lr_schedule_matches_jax(step):
    jlr = float(joptimizer.current_lr(JOptimConfig(), step, 20000))
    tlr = optimizer.current_lr(OptimConfig(), step, 20000)
    assert tlr == pytest.approx(jlr, rel=1e-6, abs=2e-7 * 6e-5)
    model = DualStudent(ModelConfig(**_KW))
    opt = optimizer.PolyWarmupAdamW(model, OptimConfig(), 20000)
    opt.global_step = step
    assert opt.lr == tlr


def test_optimizer_state_from_jax_continues_the_run(setup):
    """A JAX state after two updates, carried into the port, takes the
    third update to the same place; and the port's own ``state_dict`` round
    trip keeps the schedule step."""
    params, path, grads = setup
    track = _run_jax(params, grads, warmup_steps=2)
    jparams, jstate = track[1]
    model = DualStudent(ModelConfig(**_KW))
    model.load_state_dict(state_dict_from_jax(flat(jparams)))
    opt = optimizer.PolyWarmupAdamW(model, OptimConfig(**_OPT), MAX_ITERS)
    opt.load_state_dict(optimizer_state_from_jax(
        opt, int(jstate.step), flat(jstate.count), flat(jstate.mu),
        flat(jstate.nu)))
    assert opt.global_step == 2
    tg = state_dict_from_jax(flat(grads[2]))
    for name, p in model.named_parameters():
        if p.requires_grad:
            p.grad = tg[name].clone()
    opt.step()
    _assert_state_equal(model, opt, *track[2], 3)

    sd = opt.state_dict()
    assert sd["global_step"] == 3
    model2 = DualStudent(ModelConfig(**_KW))
    model2.load_state_dict(model.state_dict())
    opt2 = optimizer.PolyWarmupAdamW(model2, OptimConfig(**_OPT), MAX_ITERS)
    opt2.load_state_dict(sd)
    assert opt2.global_step == 3
    for (n, p), (_, p2) in zip(model.named_parameters(),
                               model2.named_parameters()):
        if p.requires_grad:
            assert opt2.state[p2]["step"] == opt.state[p]["step"], n
            assert torch.equal(opt2.state[p2]["exp_avg"],
                               opt.state[p]["exp_avg"])


def test_step_takes_no_closure():
    model = DualStudent(ModelConfig(**_KW))
    opt = optimizer.PolyWarmupAdamW(model, OptimConfig(), 10)
    with pytest.raises(ValueError, match="closure"):
        opt.step(lambda: None)
