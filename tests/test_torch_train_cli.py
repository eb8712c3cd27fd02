"""The training run as a whole (tools/train_torch.py and the modules under
it): three loader-fed steps of both packages side by side, and the command
line in-process on the CPU at a tiny size: files, validation, resume,
preemption."""

import dataclasses
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dupl_tpu import config as jconfig
from dupl_tpu.data import pipeline as jpipe
from dupl_tpu.data import voc as jvoc
from dupl_tpu.engine import checkpoint as jckpt
from dupl_tpu.engine.train import Trainer as JTrainer
from dupl_tpu.utils.logging import AverageMeter as JAverageMeter
from dupl_tpu_torch import config as tconfig
from dupl_tpu_torch.data import pipeline as tpipe
from dupl_tpu_torch.data import voc as tvoc
from dupl_tpu_torch.engine.train import Trainer, phase_of
from dupl_tpu_torch.models.convert import load_weights
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import cam as cam_ops
from dupl_tpu_torch.utils.logging import AverageMeter, cal_eta, setup_logger

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TRAIN_SIZES = [(70, 90), (64, 64), (90, 70), (80, 80), (66, 99), (75, 75),
               (100, 60), (64, 96)]
LOSSES = ("loss", "cls_loss", "ptc_loss", "seg_loss", "sim_loss", "reg_loss")


def _tool():
    spec = importlib.util.spec_from_file_location(
        "_train_torch", ROOT / "tools" / "train_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    return tvoc.write_synthetic_voc(root, [(60, 80)] * 3, seed=2,
                                    train_sizes=TRAIN_SIZES)


def _cfg(mod):
    base = mod.voc_config()
    return mod.voc_config(
        model=dataclasses.replace(base.model, backbone="test_tiny_patch16",
                                  compute_dtype="float32"),
        data=dataclasses.replace(base.data, crop_size=64),
        optim=mod.OptimConfig(lr=1e-4, warmup_iters=2, warmup_ratio=0.1),
        par=dataclasses.replace(base.par, num_iter=2),
        gmm=mod.GmmConfig(min_pixels=10, valid_thre=0.05),
        cam_iters=1, gmm_iters=2, max_iters=20, reg_conf_thre=0.02,
        cam_merge_downscale=2)


def _jax_aug_ops(seed, step, n, b):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (b,), 0, 7)))
    return torch.from_numpy(np.stack(out).astype(np.int64))


def test_three_loader_fed_steps_match_jax(tree, tmp_path):
    """Warm-up, seg and full step (cam_iters 1, gmm_iters 2) with each
    package's own dataset, loader and meter feeding its own trainer, from
    the same weights: the batches are equal, and the metered losses agree
    within the trajectory tolerance of tests/test_torch_train_step.py
    (1e-3 relative, 1e-3 absolute).  The strong view's op indices are
    jax's: the two generators draw different numbers from one seed."""
    root, lists = tree
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    kw = dict(crop_size=64, transfer_dtype="float32")
    jloader = jpipe.PrefetchLoader(jvoc.VocClsDataset(root, lists, **kw), 2,
                                   seed=jcfg.seed, num_workers=2)
    tloader = tpipe.PrefetchLoader(tvoc.VocClsDataset(root, lists, **kw), 2,
                                   seed=tcfg.seed, num_workers=2)
    feeder = tpipe.DeviceFeeder(
        tloader, "cpu", keys=("image", "cls_label", "img_box"),
        host_fn=lambda b: {"fits_budget": cam_ops.fits_class_budget(
            torch.as_tensor(b["cls_label"]), tcfg.par.class_budget)})

    jtrainer = JTrainer(jcfg)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path / "w.npz")
    jckpt.export_weights(path, jstate.params)
    model = DualStudent(tcfg.model)
    model.load_state_dict(load_weights(path))
    trainer = Trainer(tcfg, model=model, device="cpu")
    state = trainer.init_state(init=False)

    jmeter, tmeter = JAverageMeter(), AverageMeter()
    phases = []
    for step, jbatch, (host, dev) in zip(range(3), jloader, feeder):
        assert host["name"] == jbatch["name"]
        np.testing.assert_array_equal(dev["image"].numpy(), jbatch["image"])
        jstate, jm = jtrainer.train_step(
            jstate, {k: jnp.asarray(jbatch[k])
                     for k in ("image", "cls_label", "img_box")}, step=step)
        state, tm = trainer.train_step(
            state, dev, step=step,
            aug_ops=_jax_aug_ops(jcfg.seed, step, jcfg.aug_n, 2))
        phases.append(phase_of(tcfg, step))
        jmeter.add(jm)
        tmeter.add(tm)
        for k in LOSSES:   # the window of one step, popped as the loop does
            assert tmeter.pop(k) == pytest.approx(jmeter.pop(k), rel=1e-3,
                                                  abs=1e-3), (step, k)
    jloader.stop()
    feeder.stop()
    assert phases == ["warmup", "seg", "full"]


def test_meter_eta_and_logger(tmp_path):
    m = AverageMeter()
    m.add({"a": torch.tensor(1.0), "b": 2.0})
    m.add({"a": torch.tensor(3.0), "b": 4.0})
    assert m.get("a") == 2.0 and m.pop("b") == 3.0 and m.pop("b") == 0.0
    assert m.pop("a") == 2.0 and m.get("missing") == 0.0
    import datetime
    start = datetime.datetime.now() - datetime.timedelta(seconds=10)
    elapsed, eta = cal_eta(start, 5, 10)
    assert elapsed.startswith("0:00:1") and eta.startswith("0:00:")
    assert cal_eta(start, 0, 10)[1] == "0:00:00"
    log = setup_logger(str(tmp_path / "x.log"))
    log.info("hello %d", 3)
    for h in list(log.handlers):
        h.close()
        log.removeHandler(h)
    assert "hello 3" in (tmp_path / "x.log").read_text()


def _argv(tree, work_dir, *more):
    root, lists = tree
    return ["--device", "cpu", "--data-folder", root, "--list-folder", lists,
            "--work-dir", str(work_dir), "--backbone", "test_tiny_patch16",
            "--crop-size", "64", "--cam-iters", "2", "--gmm-iters", "4",
            "--log-iters", "1", "--samples-per-device", "2",
            "--num-workers", "2", *more]


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def straight(tree, tmp_path_factory):
    """Six steps in one run, checkpoints at 3 and 6."""
    work = tmp_path_factory.mktemp("straight")
    assert _tool().main(_argv(tree, work, "--max-iters", "6",
                              "--eval-iters", "3")) == 0
    run_dir, = (os.path.join(work, d) for d in os.listdir(work))
    return run_dir


def test_cli_writes_its_files(straight):
    ck = os.path.join(straight, "checkpoints")
    assert sorted(os.listdir(ck)) == ["step_3.pt", "step_6.pt", "weights.npz"]
    assert "Iter: 6;" in open(os.path.join(straight, "train.log")).read()
    recs = _records(straight)
    train = [r for r in recs if r["event"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3, 4, 5, 6]
    assert [r["phase"] for r in train] == ["warmup"] * 2 + ["seg"] * 2 + ["full"] * 2
    assert all(np.isfinite(r[k]) for r in train for k in LOSSES)
    assert train[2]["seg_loss"] > 0 and train[0]["seg_loss"] == 0
    val = [r for r in recs if r["event"] == "val"]
    assert [r["step"] for r in val] == [3, 6]
    assert all(0 <= val[0][f"{k}_miou"] <= 1 for k in
               ("cam_1", "cam_2", "cam_aux_1", "cam_aux_2", "seg_1", "seg_2"))
    assert val[0]["ckpt_mb"] > 0
    assert recs[-1]["event"] == "done" and recs[-1]["step"] == 6
    assert load_weights(os.path.join(ck, "weights.npz"))


def test_cli_resume_equals_the_straight_run(straight, tree, tmp_path):
    """A run resumed from the step-3 checkpoint, over a metrics file whose
    last line is torn, ends with the weights of the uninterrupted run and a
    metrics file with one record a step."""
    run_dir = str(tmp_path / "resumed")
    shutil.copytree(straight, run_dir)
    ck = os.path.join(run_dir, "checkpoints")
    os.remove(os.path.join(ck, "step_6.pt"))
    os.remove(os.path.join(ck, "weights.npz"))
    with open(os.path.join(run_dir, "metrics.jsonl"), "a") as f:
        f.write('{"event": "train", "step": 7, "lo')       # a torn last line
    assert _tool().main(_argv(tree, run_dir, "--resume", "--max-iters", "6",
                              "--eval-iters", "3")) == 0
    assert "resumed from step 3" in open(
        os.path.join(run_dir, "train.log")).read()
    a = np.load(os.path.join(straight, "checkpoints", "weights.npz"))
    b = np.load(os.path.join(ck, "weights.npz"))
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    recs = _records(run_dir)            # every line parses again
    keys = [(r["event"], r["step"]) for r in recs]
    assert len(keys) == len(set(keys))
    assert [s for e, s in keys if e == "train"] == [1, 2, 3, 4, 5, 6]
    want = {r["step"]: r["loss"] for r in _records(straight)
            if r["event"] == "train"}
    got = {r["step"]: r["loss"] for r in recs if r["event"] == "train"}
    assert got == want


@pytest.mark.parametrize("flags,error,message", [
    (("--train-records", "x.duplrec"), SystemExit, "go together"),
    (("--val-records", "x.duplrec"), SystemExit, "go together"),
    (("--model-parallel", "2"), SystemExit, "does not divide the 1 ranks"),
    (("--fsdp", "--model-parallel", "2"), SystemExit,
     "--model-parallel 2: model-parallel size 2"),
    (("--multihost",), SystemExit, "torchrun's environment"),
    (("--no-data",), SystemExit, "either --data-folder")],
    ids=["flags1", "flags2", "flags3", "flags4", "flags5", "no_data"])
def test_cli_refuses_what_is_not_ported(tree, tmp_path, flags, error,
                                        message):
    """What the tool refuses, as the JAX tool does: a model-parallel size
    that does not divide the world (one process here, with or without
    ``--fsdp``), one record flag without the other, ``--multihost`` outside
    a cluster's environment (here torchrun's), and no input at all
    (``--no-data`` stands for leaving out ``--data-folder``).  Nothing is
    written."""
    if flags == ("--no-data",):
        argv = _argv(tree, tmp_path)
        i = argv.index("--data-folder")
        del argv[i:i + 2]
    else:
        argv = _argv(tree, tmp_path, *flags)
    with pytest.raises(error, match=message):
        _tool().main(argv)
    assert not os.listdir(tmp_path)


def test_cli_needs_a_card_unless_told_cpu(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would start")
    argv = [a for a in _argv(tree, tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(SystemExit, match="--device cpu"):
        _tool().main(argv)


def test_sigterm_checkpoints_and_exits_zero(tree, tmp_path):
    """SIGTERM mid-run: a full checkpoint at the step the loop had reached,
    a ``preempted`` record, exit code 0; ``--resume`` goes on from there."""
    work = tmp_path / "run"
    cmd = [sys.executable, str(ROOT / "tools" / "train_torch.py"),
           *_argv(tree, work, "--max-iters", "400", "--eval-iters", "1000")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=tmp_path)
    try:
        deadline = time.time() + 240
        run_dir = None
        while time.time() < deadline and proc.poll() is None:
            if run_dir is None and work.exists() and os.listdir(work):
                run_dir = os.path.join(work, os.listdir(work)[0])
            if run_dir and os.path.exists(os.path.join(run_dir, "metrics.jsonl")):
                break       # the first step has been logged
            time.sleep(0.2)
        assert proc.poll() is None, proc.stdout.read()[-2000:]
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-2000:]
    last = _records(run_dir)[-1]
    assert last["event"] == "preempted" and last["signal"] == signal.SIGTERM
    step = last["step"]
    assert 1 <= step < 400
    assert os.listdir(os.path.join(run_dir, "checkpoints")) == [f"step_{step}.pt"]
    assert _tool().main(_argv(tree, run_dir, "--resume", "--max-iters",
                              str(step + 1), "--eval-iters", "1000")) == 0
    recs = _records(run_dir)
    assert recs[-1] == {**recs[-1], "event": "done", "step": step + 1}
    assert recs[-2]["event"] == "train" and recs[-2]["step"] == step + 1
