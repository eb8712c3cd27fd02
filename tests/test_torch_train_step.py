"""The training slice as a whole: the port's ``Trainer`` (engine/train.py)
against the JAX package's on the same weights and one synthetic batch (tiny
ViT, crop 64, batch 2, CPU, float32): per phase the discrete intermediates,
every loss term and every gradient leaf; a 6-step trajectory across both
phase boundaries; remat; the shared parameters of the bf16-stream CAM
pass."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu import config as jconfig
from dupl_tpu.data.pipeline import synthetic_batch as jsynthetic_batch
from dupl_tpu.engine import checkpoint as ckpt
from dupl_tpu.engine.train import Trainer as JTrainer
from dupl_tpu_torch import config as tconfig
from dupl_tpu_torch.data.pipeline import synthetic_batch
from dupl_tpu_torch.engine import train as ttrain
from dupl_tpu_torch.engine.train import Trainer
from dupl_tpu_torch.models.convert import load_weights, state_dict_from_jax
from dupl_tpu_torch.models.network import DualStudent

torch.set_num_threads(2)
CROP, BATCH = 64, 2
LOSS_KEYS = ("loss", "cls_loss", "ptc_loss", "seg_loss", "sim_loss",
             "reg_loss", "cls_score")


def _cfg(mod, recipe, **over):
    """The same tiny recipe from either config module.  ``min_pixels`` is
    lowered so that images pass the GMM gate at this crop, and
    ``reg_conf_thre`` so that the consistency term has pixels (random
    weights are never 0.9 confident)."""
    kw = dict(
        model=dataclasses.replace(
            getattr(mod, recipe)().model, backbone="test_tiny_patch16",
            compute_dtype="float32"),
        optim=mod.OptimConfig(lr=1e-4, warmup_iters=2, warmup_ratio=0.1),
        par=dataclasses.replace(getattr(mod, recipe)().par, num_iter=2),
        gmm=mod.GmmConfig(min_pixels=10, valid_thre=0.05),
        cam_iters=2, gmm_iters=6 if recipe == "coco_config" else 4,
        max_iters=20, reg_conf_thre=0.02, cam_merge_downscale=2)
    if recipe == "coco_config":
        kw["refine_switch_iters"] = 4
    kw.update(over)
    return getattr(mod, recipe)(**kw)


def flat(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(getattr(k, "key", getattr(k, "name", str(k)))
                       for k in kp)
        out[key] = np.asarray(leaf)
    return out


def jax_aug_ops(seed, step, n, b):
    """The strong view's op indices as the JAX trainer draws them at
    ``step``: ``fold_in(PRNGKey(seed), step)``, then one split a round."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (b,), 0, 7)))
    return torch.from_numpy(np.stack(out).astype(np.int64))


class Pair:
    """A JAX trainer and the port's on the same weights and batch."""

    def __init__(self, recipe, tmp):
        self.jcfg = _cfg(jconfig, recipe)
        self.tcfg = _cfg(tconfig, recipe)
        num_fg = self.jcfg.model.num_fg
        self.batch = synthetic_batch(BATCH, crop=CROP, num_fg=num_fg)
        self.jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.jtrainer = JTrainer(self.jcfg)
        self.jstate = self.jtrainer.init_state(jax.random.PRNGKey(0),
                                               self.jbatch["image"][:1])
        self.path = str(tmp / f"{recipe}.npz")
        ckpt.export_weights(self.path, self.jstate.params)
        self._jgrads = {}

    def port(self, **over):
        cfg = dataclasses.replace(self.tcfg, **over) if over else self.tcfg
        model = DualStudent(cfg.model)
        model.load_state_dict(load_weights(self.path))
        trainer = Trainer(cfg, model=model, device="cpu")
        return trainer, trainer.init_state(init=False)

    def jax_grad_step(self, step):
        if step not in self._jgrads:
            state = self.jstate._replace(step=jnp.int32(step))
            fn = jax.jit(functools.partial(self.jtrainer.grad_step, step=step))
            grads, metrics = fn(state, self.jbatch)
            self._jgrads[step] = (state_dict_from_jax(flat(grads)),
                                  {k: float(v) for k, v in metrics.items()})
        return self._jgrads[step]


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    return Pair("voc_config", tmp_path_factory.mktemp("voc"))


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return Pair("coco_config", tmp_path_factory.mktemp("coco"))


def test_synthetic_batch_equals_jax():
    for kw in (dict(batch=2, crop=64), dict(batch=3, crop=128, num_fg=80,
                                            seed=5)):
        want, got = jsynthetic_batch(**kw), synthetic_batch(**kw)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
    want, got = (f(2, crop=64, style="photo")
                 for f in (jsynthetic_batch, synthetic_batch))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("step,phase", [(0, "warmup"), (1, "warmup"),
                                        (2, "seg"), (3, "seg"), (4, "full"),
                                        (19, "full")])
def test_phase_tables_match_jax(step, phase):
    from dupl_tpu.engine import train as jtrain
    for recipe in ("voc_config", "coco_config"):
        j, t = _cfg(jconfig, recipe), _cfg(tconfig, recipe)
        assert ttrain.phase_of(t, step) == jtrain.phase_of(j, step)
        assert tuple(ttrain.loss_weights(t, step)) == tuple(
            jtrain.loss_weights(j, step))
    assert ttrain.phase_of(_cfg(tconfig, "voc_config"), step) == phase
    full = tconfig.coco_config()
    assert ttrain.phase_of(full, 9000) == "seg_static"
    assert ttrain.loss_weights(full, 9000) == (1.0, 0.0, 0.2, 0.05, 0.0)


def test_full_phase_discrete_intermediates_equal(voc):
    """Refined and GMM-filtered labels, the intermediates that can flip on
    a last-bit difference, are equal pixel for pixel: the gradient
    comparison below means something."""
    step = 5
    want_r, want_f = map(np.asarray, jax.jit(functools.partial(
        voc.jtrainer.full_phase_labels, step=step))(voc.jstate.params,
                                                    voc.jbatch))
    trainer, _ = voc.port()
    got_r, got_f = trainer.full_phase_labels(voc.batch, step)
    assert got_r.shape == want_r.shape == (2, BATCH, CROP, CROP)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    ign = voc.tcfg.ignore_index
    noise = (want_f == ign) & (want_r != ign)
    assert noise.any(), "the GMM filter marked nothing: it is not tested"
    assert (want_r == ign).any() and (want_r == 0).any()


def _check_step(pair, step, phase, active):
    """One ``grad_step`` on both sides: loss terms within 1e-4 relative
    (float32 reductions in different orders), every gradient leaf within
    rtol 1e-3 and 1e-5 of its leaf's largest entry."""
    assert ttrain.phase_of(pair.tcfg, step) == phase
    jgrads, jmetrics = pair.jax_grad_step(step)
    trainer, state = pair.port()
    ops = jax_aug_ops(pair.jcfg.seed, step, pair.jcfg.aug_n, BATCH)
    grads, metrics = trainer.grad_step(state, pair.batch, step=step,
                                       aug_ops=ops)
    assert set(metrics) == set(LOSS_KEYS) == set(jmetrics)
    for k in LOSS_KEYS:
        assert metrics[k].dim() == 0 and not metrics[k].requires_grad
        assert metrics[k].item() == pytest.approx(jmetrics[k], rel=1e-4,
                                                  abs=1e-6), k
    for k in ("seg_loss", "reg_loss"):
        assert (jmetrics[k] > 0) == (k in active), (k, jmetrics[k])
    params = dict(state.model.named_parameters())
    for name, p in params.items():
        want = jgrads[name].numpy()
        if "pos_embed" in name:
            assert name not in grads and p.grad is None   # frozen
            continue
        if phase == "warmup" and ".decoder." in name:
            # outside the graph: None here, zeros in jax
            assert name not in grads and p.grad is None
            assert not want.any()
            continue
        np.testing.assert_allclose(
            grads[name].numpy(), want, rtol=1e-3,
            atol=1e-5 * np.abs(want).max(), err_msg=name)
    return grads


def test_warmup_step_matches_jax(voc):
    grads = _check_step(voc, 0, "warmup", active=())
    assert any(".classifier." in n for n in grads)


def test_seg_step_matches_jax(voc):
    grads = _check_step(voc, 2, "seg", active=("seg_loss",))
    assert grads["branch1.decoder.conv8.weight"].abs().max() > 0


def test_full_step_matches_jax(voc):
    _check_step(voc, 5, "full", active=("seg_loss", "reg_loss"))


def test_coco_warmup_step_matches_jax(coco):
    _check_step(coco, 1, "warmup", active=())


def test_coco_seg_static_step_matches_jax(coco):
    _check_step(coco, 3, "seg_static", active=("seg_loss",))


def test_trajectory_across_both_phase_boundaries(voc):
    """Six optimizer steps (2 warm-up, 2 seg, 2 full) from equal weights,
    as tests/test_golden_trajectory.py: every loss within 1e-3.  Adam's
    first steps are sign-like, so single weights may differ by 2 lr where a
    gradient is near zero; the losses are what is held."""
    jstate = jax.tree.map(jnp.copy, voc.jstate)
    trainer, state = voc.port()
    lrs = []
    for step in range(6):
        jstate, jm = voc.jtrainer.train_step(jstate, voc.jbatch, step=step)
        ops = jax_aug_ops(voc.jcfg.seed, step, voc.jcfg.aug_n, BATCH)
        lrs.append(state.optimizer.lr)
        state, tm = trainer.train_step(state, voc.batch, aug_ops=ops)
        assert state.step == step + 1 == state.optimizer.global_step
        for k in ("loss", "cls_loss", "ptc_loss", "seg_loss", "sim_loss",
                  "reg_loss"):
            assert tm[k].item() == pytest.approx(float(jm[k]), rel=1e-3,
                                                 abs=1e-3), (step, k)
    assert lrs[0] < lrs[1] < lrs[2] and lrs[2] > lrs[3] > lrs[5] > 0
    # the decoder's Adam count started at the first seg step
    dec = state.model.branch1.decoder.conv8.weight
    enc = state.model.branch1.encoder.cls_token
    assert state.optimizer.state[dec]["step"] == 4
    assert state.optimizer.state[enc]["step"] == 6


def test_every_phase_updates_all_but_the_frozen(voc):
    trainer, state = voc.port()
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    state, _ = trainer.train_step(state, voc.batch)           # warm-up
    for n, p in state.model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        assert same == ("pos_embed" in n or ".decoder." in n), n
    state.step = 4
    state, m = trainer.train_step(state, voc.batch)   # full, own aug draws
    assert all(torch.isfinite(v) for v in m.values())
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), before[n]) == ("pos_embed" in n), n


def test_remat_gives_the_same_gradients(voc):
    trainer, state = voc.port()
    rtrainer, rstate = voc.port(model=dataclasses.replace(
        voc.tcfg.model, remat=True))
    assert rstate.model.branch1.encoder.remat
    ops = jax_aug_ops(0, 5, voc.tcfg.aug_n, BATCH)
    grads, m = trainer.grad_step(state, voc.batch, step=5, aug_ops=ops)
    rgrads, rm = rtrainer.grad_step(rstate, voc.batch, step=5, aug_ops=ops)
    assert grads.keys() == rgrads.keys()
    assert torch.equal(m["loss"], rm["loss"])
    for name in grads:
        torch.testing.assert_close(rgrads[name], grads[name], rtol=1e-5,
                                   atol=1e-7, msg=name)


def test_bf16_cam_stream_shares_the_parameters(voc):
    """``cam_stream_dtype='bfloat16'`` runs the no-grad CAM passes on a
    bf16 residual stream of the same module: no second copy of any weight,
    and the labels stay close to the fp32 stream's."""
    trainer, state = voc.port(model=dataclasses.replace(
        voc.tcfg.model, cam_stream_dtype="bfloat16"))
    assert trainer.cam_stream_dtype == torch.bfloat16
    student = trainer.model.branch1
    seen = []
    hook = student.encoder.blocks[0].register_forward_hook(
        lambda mod, args, out: seen.append(
            (args[0].dtype, mod.attn.qkv.weight.data_ptr())))
    x = torch.from_numpy(voc.batch["image"])
    cam, cam_aux = trainer._cam_fn(student)(x)
    student.forward_with_cams(x)
    hook.remove()
    assert [s[0] for s in seen] == [torch.bfloat16, torch.float32]
    assert seen[0][1] == seen[1][1] == student.encoder.blocks[
        0].attn.qkv.weight.data_ptr()
    assert cam.dtype == torch.float32 and not cam.requires_grad
    assert len(list(trainer.model.parameters())) == len(
        list(DualStudent(voc.tcfg.model).parameters()))
    ref_trainer, _ = voc.port()
    assert ref_trainer.cam_stream_dtype is None
    got, _ = trainer.full_phase_labels(voc.batch, 5)
    want, _ = ref_trainer.full_phase_labels(voc.batch, 5)
    assert (got == want).float().mean().item() >= 0.97
    _, m = trainer.grad_step(state, voc.batch, step=5)
    assert torch.isfinite(m["loss"])


def test_multi_scale_cams_match_jax(voc):
    want = voc.jtrainer._multi_scale_cams(voc.jstate.params,
                                          voc.jbatch["image"])
    trainer, _ = voc.port()
    got = trainer._multi_scale_cams(torch.from_numpy(voc.batch["image"]))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, BATCH, CROP // 2, CROP // 2, 20)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


def test_put_decides_the_class_budget_on_the_host(voc):
    trainer, _ = voc.port()
    b = trainer.put(voc.batch)
    assert b["fits_budget"] is True and b["image"].dtype == torch.float32
    crowded = dict(voc.batch, cls_label=np.ones_like(voc.batch["cls_label"]))
    assert trainer.put(crowded)["fits_budget"] is False
    assert trainer.put(b)["fits_budget"] is True       # idempotent


def test_stage_hook_sees_every_stage_in_order(voc):
    """The profiler's hook is called once per stage, after the stage's work
    was queued; without a hook a step does the same work."""
    trainer, state = voc.port()
    seen = []
    trainer.stage_hook = seen.append
    state.step = 4
    ops = jax_aug_ops(0, 4, voc.tcfg.aug_n, BATCH)
    _, with_hook = trainer.train_step(state, voc.batch, aug_ops=ops)
    assert seen == ["strong_view", "cam_and_forward", "labels",
                    "strong_forward", "losses", "backward", "optimizer"]
    del seen[:]
    state.step = 0
    trainer.train_step(state, voc.batch)
    assert seen == ["cam_and_forward", "labels", "losses", "backward",
                    "optimizer"]
    plain, pstate = voc.port()
    pstate.step = 4
    _, without = plain.train_step(pstate, voc.batch, aug_ops=ops)
    assert torch.equal(with_hook["loss"], without["loss"])


@pytest.mark.parametrize("dataset,starts", [
    ("voc", {"warmup": 0, "seg": 2000, "full": 8000}),
    ("coco", {"warmup": 0, "seg_static": 8000, "seg": 12000, "full": 32000})])
def test_production_config_and_phase_start(dataset, starts):
    """The production recipe is the dataset's own with a bf16 CAM stream
    and the half-size CAM merge (what the JAX package's train entry point
    builds), and each phase starts where ``phase_of`` says it does."""
    cfg = ttrain.production_config(dataset)
    base = getattr(tconfig, f"{dataset}_config")()
    assert cfg.model == dataclasses.replace(base.model,
                                            cam_stream_dtype="bfloat16")
    assert cfg.cam_merge_downscale == 2
    assert dataclasses.replace(cfg, model=base.model,
                               cam_merge_downscale=None) == base
    assert ttrain.production_config(dataset, max_iters=7).max_iters == 7
    for phase, step in starts.items():
        assert ttrain.phase_start(cfg, phase) == step
        assert ttrain.phase_of(cfg, step) == phase
        assert step == 0 or ttrain.phase_of(cfg, step - 1) != phase
    with pytest.raises(ValueError, match="phase"):
        ttrain.phase_start(cfg, "seg_static" if dataset == "voc" else "x")
