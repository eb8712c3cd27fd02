"""Tensor parallelism of the port (dupl_tpu_torch/parallel/tensor_parallel.py,
the data x model grid of parallel/mesh.py): the layout of each rank's share
and its inverse without a process group; what tensor parallelism refuses;
spawned gloo CPU ranks (parallel/dryrun.py:run_spawned) at data 1 x model
2 and data 2 x model 2, plain and FSDP, against one process at the same
global batch at the tolerances of tests/test_parallel.py:143
(``test_tp_matches_dp_numerically``); the port's step at model 2 against
the JAX package's step on a ``make_mesh(n_data=1, n_model=2)`` mesh; and
checkpoints across the grid."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dupl_tpu.parallel import make_mesh, shard_batch
from dupl_tpu.parallel import shard_state as jshard_state
from dupl_tpu_torch import config as tconfig
from dupl_tpu_torch.data.pipeline import synthetic_batch
from dupl_tpu_torch.models import vit
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.models.vit import ViTSpec
from dupl_tpu_torch.parallel import dryrun, mesh, tensor_parallel
from dupl_tpu_torch.parallel.mesh import Dist
from test_torch_multiproc import (_assert_matches_jax, _assert_same_state,
                                  _cfg, _jax_aug_ops, _job, start)

torch.set_num_threads(2)
assert start  # the JAX package's initial weights (a module fixture)
# tests/test_parallel.py:143's tolerances: metrics, updated parameters
METRIC_TOL = dict(rtol=2e-4, atol=1e-5)
PARAM_TOL = dict(rtol=5e-4, atol=2e-5)
# a gradient leaf against one process's: rtol, and atol as a share of the
# leaf's largest entry (tests/test_torch_multiproc.py's)
GRAD_TOL = (1e-3, 1e-5)


def _quad(monkeypatch):
    """A tiny recipe whose ViT has 4 heads (64 wide, 2 blocks), so that
    both 2 and 4 model ranks divide its heads, MLP and decoder."""
    monkeypatch.setitem(vit.VIT_CONFIGS, "test_quad_patch16",
                        ViTSpec(embed_dim=64, depth=2, num_heads=4))
    base = tconfig.voc_config()
    return dataclasses.replace(base.model, backbone="test_quad_patch16",
                               compute_dtype="float32")


@pytest.mark.parametrize("n", [2, 4], ids=["n=2", "n=4"])
def test_shard_then_gather_is_the_identity(monkeypatch, n):
    """Each model rank's share of each tensor-parallel leaf is the right
    rows or columns of the full tensor: q, k and v of its heads, fc1's
    rows, proj's and fc2's columns, conv6's output and conv7's input
    channels; replicated leaves are unchanged; the shares joined in rank
    order give ``state_dict()`` back bit for bit.  No process group: the
    slicing communicates nothing."""
    mcfg = _quad(monkeypatch)
    torch.manual_seed(0)
    full = DualStudent(mcfg).state_dict()
    c, hidden, dec = 64, 256, mcfg.decoder_dim
    shares = []
    for r in range(n):
        model = DualStudent(mcfg)
        model.load_state_dict(full)
        d = Dist(rank=r, world=n, n_model=n)
        tensor_parallel.shard_model(model, d)
        assert model.tp is d and model.branch2.encoder.blocks[1].attn.tp is d
        blk0 = model.branch1.encoder.blocks[0]
        assert [(m.tp, m.tp_role) for m in (blk0.attn.qkv, blk0.attn.proj,
                                            blk0.mlp.fc1, blk0.mlp.fc2)] == [
            (d, "column"), (d, "row"), (d, "column"), (d, "row")]
        dec6, dec7 = model.branch2.decoder.conv6, model.branch2.decoder.conv7
        assert [(dec6.tp, dec6.tp_role), (dec7.tp, dec7.tp_role)] == [
            (d, "column"), (d, "row")]
        assert not hasattr(model.branch2.decoder.conv8, "tp")
        assert blk0.norm1.weight.numel() == c
        shares.append(model.state_dict())
        blk = "branch1.encoder.blocks.1."
        q, k, v = full[blk + "attn.qkv.weight"].split(c)
        rows = slice(r * c // n, (r + 1) * c // n)   # heads r H/n ...
        assert torch.equal(shares[r][blk + "attn.qkv.weight"],
                           torch.cat([q[rows], k[rows], v[rows]]))
        qb, kb, vb = full[blk + "attn.qkv.bias"].split(c)
        assert torch.equal(shares[r][blk + "attn.qkv.bias"],
                           torch.cat([qb[rows], kb[rows], vb[rows]]))
        h = slice(r * hidden // n, (r + 1) * hidden // n)
        assert torch.equal(shares[r][blk + "mlp.fc1.weight"],
                           full[blk + "mlp.fc1.weight"][h])
        assert torch.equal(shares[r][blk + "mlp.fc1.bias"],
                           full[blk + "mlp.fc1.bias"][h])
        assert torch.equal(shares[r][blk + "mlp.fc2.weight"],
                           full[blk + "mlp.fc2.weight"][:, h])
        assert torch.equal(shares[r][blk + "attn.proj.weight"],
                           full[blk + "attn.proj.weight"][:, rows])
        ch = slice(r * dec // n, (r + 1) * dec // n)
        for b in ("branch1", "branch2"):
            assert torch.equal(shares[r][f"{b}.decoder.conv6.weight"],
                               full[f"{b}.decoder.conv6.weight"][ch])
            assert torch.equal(shares[r][f"{b}.decoder.conv7.weight"],
                               full[f"{b}.decoder.conv7.weight"][:, ch])
        for key, t in full.items():
            if tensor_parallel.spec_of(key) is None:
                assert torch.equal(shares[r][key], t), key
            else:
                assert shares[r][key].numel() * n == t.numel(), key
    for key, t in full.items():
        spec = tensor_parallel.spec_of(key)
        got = (shares[0][key] if spec is None else tensor_parallel.join_shards(
            [s[key] for s in shares], *spec))
        assert got.dtype == t.dtype and torch.equal(got, t), key
    assert sum(tensor_parallel.spec_of(k) is not None for k in full) == 2 * (
        2 * 6 + 2)


def test_tp_refuses_what_does_not_divide(monkeypatch):
    """``deit_tiny_patch16`` (3 heads) at 2 model ranks, and a world that
    the model group does not divide, before any rendezvous."""
    base = tconfig.voc_config()
    model = DualStudent(dataclasses.replace(
        base.model, backbone="deit_tiny_patch16", compute_dtype="float32"))
    with pytest.raises(ValueError, match="3 attention heads .* divide by 2"):
        tensor_parallel.shard_model(model, Dist(rank=0, world=2, n_model=2))
    mcfg = _quad(monkeypatch)
    with pytest.raises(ValueError, match="decoder width"):
        tensor_parallel.shard_model(
            DualStudent(dataclasses.replace(mcfg, decoder_dim=510)),
            Dist(rank=0, world=4, n_model=4))
    with pytest.raises(ValueError, match="does not divide the 3 ranks"):
        mesh.check_grid(3, 2)
    for k, v in dict(WORLD_SIZE="3", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="model-parallel size 2"):
        mesh.init_from_env("cpu", n_model=2)
    monkeypatch.setenv("WORLD_SIZE", "0")
    with pytest.raises(ValueError, match="does not divide the 1 ranks"):
        mesh.init_from_env("cpu", n_model=2)


def _assert_like_one(one, ranks, n_model, fsdp=False):
    """Every rank's logged metrics and updated parameters within
    tests/test_parallel.py:143's tolerances of one process's, and its
    gathered Adam moments within the gradients' (``GRAD_TOL``; exp_avg_sq,
    a square, at twice it): a first Adam step moves a weight by about lr
    sign(g), which does not see the gradient's scale, and the moments do;
    the ranks log the same metrics; the ranks hold each tensor-parallel
    leaf once over a data rank's model group (and, under FSDP, once over
    all ranks)."""
    world = len(ranks)
    n_data = world // n_model
    for r in ranks:
        for m1, m2 in zip(one["metrics"], r["metrics"]):
            assert m1.keys() == m2.keys()
            for k in m1:
                np.testing.assert_allclose(m2[k], m1[k], **METRIC_TOL,
                                           err_msg=k)
        assert r["weights"].keys() == one["weights"].keys()
        for k, w in one["weights"].items():
            np.testing.assert_allclose(r["weights"][k], w, **PARAM_TOL,
                                       err_msg=k)
        assert r["moments"].keys() == one["moments"].keys()
        for k, (count, avg, avg_sq) in one["moments"].items():
            got = r["moments"][k]
            assert float(got[0]) == float(count), k
            for i, (want, scale) in enumerate(((avg, 1), (avg_sq, 2)), 1):
                np.testing.assert_allclose(
                    got[i], want, rtol=scale * GRAD_TOL[0],
                    atol=scale * GRAD_TOL[1] * np.abs(want).max(),
                    err_msg=f"{k} {('exp_avg', 'exp_avg_sq')[i - 1]}")
        assert r["metrics"] == ranks[0]["metrics"]
        assert np.array_equal(r["rng"], one["rng"])
    for k, w in one["weights"].items():
        copies = (n_model if fsdp else world) if \
            tensor_parallel.spec_of(k) is None else (1 if fsdp else n_data)
        assert sum(r["local_param_numel"][k] for r in ranks) == \
            w.size * copies, k


def test_tp_two_ranks_equal_one_process(start):
    """Data 1 x model 2 over gloo, one step of each phase (warm-up at 0,
    seg at 2, full at 3) in fp32, against one process."""
    job = dataclasses.replace(_job(start[2], [0, 2, 3]), n_model=2)
    one = dryrun.run_rank(job, Dist())
    ranks = dryrun.run_spawned(2, job)
    _assert_like_one(one, ranks, 2)
    assert [m["seg_loss"] > 0 for m in one["metrics"]] == [False, True, True]
    assert one["metrics"][2]["reg_loss"] > 0
    for r in ranks:
        for k, g in one["grads"].items():
            np.testing.assert_allclose(r["grads"][k], g, rtol=GRAD_TOL[0],
                                       atol=GRAD_TOL[1] * np.abs(g).max(),
                                       err_msg=k)


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp_tp", "fsdp_tp"])
def test_dp_tp_and_fsdp_tp_equal_one_process(start, fsdp):
    """Four ranks, data 2 x model 2, plain and FSDP, one full-phase step on
    a global batch of 4 against one process (the port's
    ``test_tp_matches_dp_numerically``)."""
    job = dataclasses.replace(_job(start[2], [3]), n_model=2, fsdp=fsdp)
    one = dryrun.run_rank(job, Dist())
    ranks = dryrun.run_spawned(4, job)
    _assert_like_one(one, ranks, 2, fsdp)
    assert one["metrics"][0]["reg_loss"] > 0


def test_tp_step_matches_jax_dp_tp(start):
    """One full-phase step of the port at data 1 x model 2 against the JAX
    trainer's ``grad_step`` on a ``make_mesh(n_data=1, n_model=2)`` mesh
    (its ``_param_spec`` shardings), with the same weights, batch and
    strong-view ops: every loss term within 1e-4 relative, every gradient
    leaf within rtol 1e-3 and 1e-5 of its largest entry (the template of
    tests/test_torch_multiproc.py:test_two_rank_full_step_matches_jax)."""
    jtrainer, jstate, weights = start
    step = 5
    batch = synthetic_batch(4, crop=64, seed=11)
    ops = _jax_aug_ops(0, step, jtrainer.cfg.aug_n, 4)
    job = dryrun.Job(_cfg(tconfig), weights, [batch], [step], [ops],
                     n_model=2)
    ranks = dryrun.run_spawned(2, job)
    jmesh = make_mesh(n_data=1, n_model=2)
    with jmesh:
        placed = jshard_state(jmesh, jstate._replace(step=jnp.int32(step)))
        jbatch = shard_batch(jmesh, {k: np.asarray(v)
                                     for k, v in batch.items()})
        jgrads, jm = jax.jit(lambda s, b: jtrainer.grad_step(
            s, b, step=step))(placed, jbatch)
    from dupl_tpu_torch.models.convert import state_dict_from_jax

    flat = {"/".join(getattr(k, "key", getattr(k, "name", str(k)))
                     for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    want = {k: v.numpy() for k, v in state_dict_from_jax(flat).items()}
    for r in ranks:
        _assert_matches_jax(r, want, {k: float(v) for k, v in jm.items()})


def test_tp_checkpoint_resumes_at_one_process_and_back(start, tmp_path):
    """Two steps at data 1 x model 2 saved, then restored in one process:
    weights, moments, counts and generator bit for bit; and a one-process
    checkpoint restored at model 2 gathers back to it bit for bit."""
    weights = start[2]
    at_tp = tmp_path / "tp"
    ranks = dryrun.run_spawned(2, dataclasses.replace(
        _job(weights, range(2, 4), save_dir=str(at_tp)), n_model=2))
    resumed = dryrun.run_rank(_job(weights, [], resume_dir=str(at_tp)),
                              Dist())
    for r in ranks:
        _assert_same_state(r, resumed)
    at_one = tmp_path / "one"
    saved = dryrun.run_rank(_job(weights, range(2, 4),
                                 save_dir=str(at_one)), Dist())
    back = dryrun.run_spawned(2, dataclasses.replace(
        _job(weights, [], resume_dir=str(at_one)), n_model=2))
    for r in back:
        _assert_same_state(saved, r)
        assert sum(r["local_moment_numel"].values()) < sum(
            m.size for _, m, _ in saved["moments"].values())
