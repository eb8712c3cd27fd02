"""Data-parallel and fully-sharded training across processes: spawned gloo
CPU ranks (dupl_tpu_torch/parallel/dryrun.py:run_spawned, the environment
torchrun gives a rank) against one process at the same global batch, the
template of tests/test_multihost.py.

Two ranks at batch 2 each train as one process at batch 4 through warm-up,
seg and full, plain and with ``fsdp`` (the moments of a rank are its share
of each leaf); warm-up leaves the decoder untouched under both and under
tensor parallelism; a
checkpoint written at one world size resumes at the other bit for bit; one
full step of two ranks gives the JAX package's gradients of the global
batch; the training tool under two ranks writes one run's files, also as
one model group (``--model-parallel 2``), and a signal to one rank stops
them all at the same step.
"""

import dataclasses
import glob
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu import config as jconfig
from dupl_tpu.engine import checkpoint as jckpt
from dupl_tpu.engine.train import Trainer as JTrainer
from dupl_tpu_torch import config as tconfig
from dupl_tpu_torch.data.pipeline import synthetic_batch
from dupl_tpu_torch.data.voc import write_synthetic_voc
from dupl_tpu_torch.models.convert import load_weights, state_dict_from_jax
from dupl_tpu_torch.parallel import dryrun
from dupl_tpu_torch.parallel.mesh import Dist

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
LOSSES = ("cls_loss", "ptc_loss", "seg_loss", "sim_loss")


def _cfg(mod, **over):
    """The tiny recipe at the recipe's own optimizer (as the JAX template's
    command line runs it): warm-up at steps 0-1, seg at 2, full from 3."""
    base = mod.voc_config()
    kw = dict(model=dataclasses.replace(base.model,
                                        backbone="test_tiny_patch16",
                                        compute_dtype="float32"),
              par=dataclasses.replace(base.par, num_iter=2),
              gmm=mod.GmmConfig(min_pixels=10, valid_thre=0.05),
              cam_iters=2, gmm_iters=3, max_iters=20, reg_conf_thre=0.02,
              cam_merge_downscale=2)
    kw.update(over)
    return mod.voc_config(**kw)


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """The JAX package's initial weights (exported and loaded as the port's
    state dict), so that every run here, and the JAX trainer, start
    equal."""
    jcfg = _cfg(jconfig)
    jtrainer = JTrainer(jcfg)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path_factory.mktemp("w") / "w.npz")
    jckpt.export_weights(path, jstate.params)
    weights = {k: v.numpy() for k, v in load_weights(path).items()}
    return jtrainer, jstate, weights


def _job(weights, steps, **kw):
    batches = [synthetic_batch(4, crop=64, seed=s) for s in steps]
    return dryrun.Job(_cfg(tconfig), weights, batches, list(steps),
                      [None] * len(steps), **kw)


@pytest.fixture(scope="module")
def one_process(start):
    """One process at batch 4, four steps: the oracle of both arms."""
    return dryrun.run_rank(_job(start[2], range(4)), Dist())


def _assert_weights_match(want, got, tol, floor):
    """tests/test_multihost.py's per-leaf bound."""
    gap = dryrun.max_rel_gap(want, got, tol, floor)
    print(f"worst leaf at {gap:.3g} of the bound")
    assert gap <= 1.0


def _assert_equal_to_one(one, ranks, tol, floor):
    """Every rank's weights within the bound of one process's; the logged
    losses within 2e-2 (the JAX template) and the last step's gradients
    within 1e-4 of each leaf's largest entry, so that a wrong reduction (a
    mean, a missing rank) cannot hide behind Adam's scale invariance."""
    for r in ranks:
        _assert_weights_match(one["weights"], r["weights"], tol, floor)
        for s, (m1, m2) in enumerate(zip(one["metrics"], r["metrics"])):
            for k in LOSSES:
                assert abs(m1[k] - m2[k]) <= 2e-2 * max(1.0, abs(m1[k])), (
                    s, k, m1[k], m2[k])
        assert dryrun.max_rel_gap(one["grads"], r["grads"]) <= 1e-4
        assert np.array_equal(r["rng"], one["rng"])
        assert r["global_step"] == 4
    assert one["metrics"][2]["seg_loss"] > 0
    assert one["metrics"][3]["reg_loss"] > 0


def test_two_ranks_equal_one_process(start, one_process):
    ranks = dryrun.run_spawned(2, _job(start[2], range(4)))
    _assert_equal_to_one(one_process, ranks, tol=1e-5, floor=1e-7)
    for r in ranks:       # replicated moments
        for name, (_, m, _) in r["moments"].items():
            assert r["local_moment_numel"][name] == m.size


def test_fsdp_two_ranks_equal_one_process(start, one_process):
    """Under FSDP each rank holds dim-0 chunk ``rank`` of every moment
    (torch's chunk split of the JAX package's ``_add_fsdp_axis``)."""
    ranks = dryrun.run_spawned(2, _job(start[2], range(4), fsdp=True))
    _assert_equal_to_one(one_process, ranks, tol=2e-4, floor=5e-6)
    for name, (_, m, v) in ranks[0]["moments"].items():
        rows = m.shape[0]
        split = [len(c) for c in torch.arange(rows).chunk(2)] + [0]
        want = [n * (m.size // rows) for n in split[:2]]
        assert [r["local_moment_numel"][name] for r in ranks] == want, name
        if rows % 2 == 0:
            assert want == [m.size // 2] * 2


@pytest.mark.parametrize("fsdp,n_model", [(False, 1), (True, 1), (False, 2)],
                         ids=["dp", "fsdp", "tp"])
def test_warmup_leaves_the_decoder_untouched(start, fsdp, n_model, tmp_path):
    """Two warm-up steps across two ranks (data parallel, FSDP, or one
    model group of two): the decoder's weights are the initial ones and it
    has no moments and no count, its sharded convs included; every other
    trained parameter has count 2.  Under FSDP and tensor parallelism the
    step-2 checkpoint then resumes in one process bit for bit (weights,
    moments, counts, generator)."""
    weights = start[2]
    ranks = dryrun.run_spawned(2, _job(weights, range(2), fsdp=fsdp,
                                       n_model=n_model,
                                       save_dir=str(tmp_path)))
    for r in ranks:
        for name, w in r["weights"].items():
            if ".decoder." in name or "pos_embed" in name:
                assert np.array_equal(w, weights[name]), name
                assert name not in r["moments"]
            else:
                assert not np.array_equal(w, weights[name]), name
                assert r["moments"][name][0] == 2, name
    if fsdp or n_model > 1:
        resumed = dryrun.run_rank(_job(weights, [], resume_dir=str(tmp_path)),
                                  Dist())
        _assert_same_state(ranks[0], resumed)


def _assert_same_state(a, b):
    assert a["weights"].keys() == b["weights"].keys()
    for k in a["weights"]:
        assert np.array_equal(a["weights"][k], b["weights"][k]), k
    assert a["moments"].keys() == b["moments"].keys()
    for k, (t, m, v) in a["moments"].items():
        assert b["moments"][k][0] == t
        assert np.array_equal(b["moments"][k][1], m), k
        assert np.array_equal(b["moments"][k][2], v), k
    assert a["global_step"] == b["global_step"]
    assert np.array_equal(a["rng"], b["rng"])


def test_one_process_checkpoint_resumes_sharded(start, tmp_path):
    """The reverse: a world-1 checkpoint restored into two FSDP ranks
    gathers back to the saved state bit for bit."""
    saved = dryrun.run_rank(_job(start[2], range(3),
                                 save_dir=str(tmp_path)), Dist())
    ranks = dryrun.run_spawned(2, _job(start[2], [], fsdp=True,
                                       resume_dir=str(tmp_path)))
    for r in ranks:
        _assert_same_state(saved, r)
        assert sum(r["local_moment_numel"].values()) < sum(
            m.size for _, m, _ in saved["moments"].values())


def _jax_aug_ops(seed, step, n, b):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (b,), 0, 7)))
    return np.stack(out).astype(np.int64)


def _jax_grad_step(start, batch, step):
    """The JAX trainer's ``grad_step`` on the global ``batch`` at ``step``:
    its gradients as the port's state dict, and its metrics."""
    jtrainer, jstate, _ = start
    jgrads, jm = jax.jit(lambda s, b: jtrainer.grad_step(s, b, step=step))(
        jstate._replace(step=jnp.int32(step)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    flat = {"/".join(getattr(k, "key", getattr(k, "name", str(k)))
                     for k in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    want = {k: v.numpy() for k, v in state_dict_from_jax(flat).items()}
    return want, {k: float(v) for k, v in jm.items()}


def _off_leaves(got, want):
    """The gradient leaves outside tests/test_torch_train_step.py's bound
    (rtol 1e-3 and 1e-5 of the leaf's largest entry)."""
    return [k for k, g in got.items()
            if not np.allclose(g, want[k], rtol=1e-3,
                               atol=1e-5 * np.abs(want[k]).max())]


def _assert_matches_jax(run, want, jm):
    """Every loss term within 1e-4 relative, every gradient leaf within
    ``_off_leaves``' bound."""
    for k in ("loss",) + LOSSES + ("reg_loss",):
        assert run["metrics"][0][k] == pytest.approx(
            jm[k], rel=1e-4, abs=1e-6), k
    assert jm["reg_loss"] > 0 and jm["seg_loss"] > 0
    got = run["grads"]
    assert set(got) == {k for k in want if "pos_embed" not in k}
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=1e-3,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_two_rank_full_step_matches_jax(start):
    """One full-phase step of two ranks (batch 2 each) against the JAX
    trainer's ``grad_step`` on the global batch of 4, with the same weights
    and strong-view ops, at the step and tolerance of
    tests/test_torch_train_step.py's full step (step 5, its ops): every
    loss term within 1e-4 relative, every gradient leaf within rtol 1e-3
    and 1e-5 of its largest entry."""
    step = 5
    batch = synthetic_batch(4, crop=64, seed=11)
    ops = _jax_aug_ops(0, step, start[0].cfg.aug_n, 4)
    job = dryrun.Job(_cfg(tconfig), start[2], [batch], [step], [ops])
    ranks = dryrun.run_spawned(2, job)
    _assert_matches_jax(ranks[0], *_jax_grad_step(start, batch, step))


def _exact_equalize_batched(img255):
    """``jaugment._equalize_batched`` with exact integer histograms (PIL's
    rule, as the port computes it)."""
    b, h, w, _ = img255.shape
    q = jnp.swapaxes(jnp.clip(img255, 0, 255).astype(jnp.int32)
                     .reshape(b, h * w, 3), 1, 2)                # (B, 3, N)
    idx = jnp.arange(256)
    hist = jnp.sum(q[..., None] == idx, axis=2, dtype=jnp.int32)
    last = jnp.max(jnp.where(hist > 0, idx, -1), axis=-1, keepdims=True)
    h_last = jnp.take_along_axis(hist, jnp.maximum(last, 0), axis=-1)
    step = (hist.sum(-1, keepdims=True) - h_last) // 255
    lut = jnp.clip((step // 2 + jnp.cumsum(hist, -1) - hist)
                   // jnp.maximum(step, 1), 0, 255).astype(jnp.float32)
    out = jnp.where(step > 0, jnp.take_along_axis(lut, q, axis=-1),
                    q.astype(jnp.float32))
    return jnp.swapaxes(out, 1, 2).reshape(b, h, w, 3)


def test_first_full_step_matches_jax_once_its_histogram_is_exact(
        start, monkeypatch):
    """The first full step (step 3, whose strong view equalizes) of one
    process against the JAX trainer.  As the JAX package stands, some
    gradient leaves are off its bound: its batched equalize counts each
    4096-pixel chunk in bf16 and rounds counts above 256
    (tests/test_torch_augment.py, ROADMAP.md).  With that histogram made
    exact, and nothing else changed, every loss term and leaf is within
    the bound: the port's step has no fault of its own there."""
    from dupl_tpu.ops import augment as jaugment

    step = 3
    batch = synthetic_batch(4, crop=64, seed=11)
    ops = _jax_aug_ops(0, step, start[0].cfg.aug_n, 4)
    one = dryrun.run_rank(dryrun.Job(_cfg(tconfig), start[2], [batch],
                                     [step], [ops]), Dist())
    want, _ = _jax_grad_step(start, batch, step)
    assert _off_leaves(one["grads"], want)
    # jax keeps the traced step: drop it before and after the exact run,
    # so that no other test reads a step traced with the replacement
    monkeypatch.setattr(jaugment, "_equalize_batched",
                        _exact_equalize_batched)
    jax.clear_caches()
    try:
        exact = _jax_grad_step(start, batch, step)
    finally:
        monkeypatch.undo()
        jax.clear_caches()
    _assert_matches_jax(one, *exact)


def _tool_argv(tmp_path, *more):
    root, lists = write_synthetic_voc(str(tmp_path / "voc"), [(60, 80)] * 2,
                                      seed=3, train_sizes=[(70, 90)] * 8)
    return [sys.executable, str(ROOT / "tools" / "train_torch.py"),
            "--device", "cpu", "--data-folder", root, "--list-folder", lists,
            "--work-dir", str(tmp_path / "run"), "--backbone",
            "test_tiny_patch16", "--crop-size", "64", "--cam-iters", "1",
            "--gmm-iters", "2", "--samples-per-device", "1",
            "--num-workers", "1", *more]


def _start_ranks(argv, cwd, world=2):
    """``argv`` as torchrun starts it on each of ``world`` ranks."""
    port = dryrun.free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(argv, env=env, cwd=cwd,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, timeout=300):
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_training_tool_under_two_ranks(tmp_path):
    """``tools/train_torch.py`` as torchrun starts it, twice: rank 0 alone
    writes the run's train.log, metrics.jsonl and weights.npz and
    validates, the other rank logs to its console and waits."""
    argv = _tool_argv(tmp_path, "--max-iters", "3", "--eval-iters", "3",
                      "--log-iters", "1")
    outs = _finish(_start_ranks(argv, tmp_path))
    _assert_one_run(tmp_path, outs)
    log = next((tmp_path / "run").glob("*/train.log")).read_text()
    assert "global batch 2" in log


def _assert_one_run(tmp_path, outs):
    work = tmp_path / "run"
    runs = os.listdir(work)
    assert len(runs) == 1
    run = work / runs[0]
    assert sorted(glob.glob(str(work / "*" / "train.log"))) == [
        str(run / "train.log")]
    assert (run / "metrics.jsonl").exists()
    assert sorted(os.listdir(run / "checkpoints")) == ["step_3.pt",
                                                       "weights.npz"]
    log = (run / "train.log").read_text()
    assert log.count("validating at iter") == 1
    assert "rank 0 of 2" in log
    assert "validating" not in outs[1] and "rank 1 of 2" in outs[1]
    return run


def test_training_tool_under_two_ranks_model_parallel(tmp_path):
    """``--model-parallel 2`` under two ranks: one model group that trains
    the recipe's global batch of 1 together, rank 0 validates a plain copy
    with the gathered weights (the other rank joins the gather and waits),
    and the checkpoint and ``weights.npz`` hold the one-device layout,
    which a one-process model loads."""
    from dupl_tpu_torch.engine import checkpoint as ckpt
    from dupl_tpu_torch.models.network import DualStudent

    argv = _tool_argv(tmp_path, "--max-iters", "3", "--eval-iters", "3",
                      "--log-iters", "1", "--model-parallel", "2")
    run = _assert_one_run(tmp_path, _finish(_start_ranks(argv, tmp_path)))
    log = (run / "train.log").read_text()
    assert "model rank 0 of 2" in log and "global batch 1" in log
    recs = [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs if r["event"] == "train"] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs if r["event"] == "train")
    assert [r["step"] for r in recs if r["event"] == "val"] == [3]
    cfg = _cfg(tconfig)
    payload = torch.load(run / "checkpoints" / "step_3.pt",
                         weights_only=True)
    model = DualStudent(cfg.model)
    model.load_state_dict(payload["model"])          # the one-device shapes
    exported = load_weights(str(run / "checkpoints" / "weights.npz"))
    full = ckpt.full_model_state(model)
    assert exported.keys() == full.keys()
    for k, v in exported.items():
        assert torch.equal(v, full[k]), k


def test_sigterm_on_one_rank_stops_every_rank(tmp_path):
    """SIGTERM to rank 1 alone: the ranks agree on it at the next log
    boundary, checkpoint there together and exit 0; rank 0 records the
    signal."""
    argv = _tool_argv(tmp_path, "--max-iters", "400", "--eval-iters",
                      "1000", "--log-iters", "3")
    procs = _start_ranks(argv, tmp_path)
    work = tmp_path / "run"
    try:
        deadline = time.time() + 240
        metrics = None
        while time.time() < deadline and all(p.poll() is None
                                             for p in procs):
            runs = os.listdir(work) if work.exists() else []
            if runs and (work / runs[0] / "metrics.jsonl").exists():
                metrics = work / runs[0] / "metrics.jsonl"
                break       # the first log boundary has passed
            time.sleep(0.2)
        assert metrics is not None, procs[0].stdout.read()[-2000:]
        procs[1].send_signal(signal.SIGTERM)
    finally:
        _finish(procs, timeout=120)
    recs = [json.loads(line) for line in metrics.read_text().splitlines()]
    last = recs[-1]
    assert last["event"] == "preempted" and last["signal"] == signal.SIGTERM
    step = last["step"]
    assert step % 3 == 0 and 3 <= step < 400
    assert os.listdir(metrics.parent / "checkpoints") == [f"step_{step}.pt"]
