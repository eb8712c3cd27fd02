"""The port's command-line tools on COCO, packed records and pretrained
weights, in-process on the CPU at a tiny size (``test_tiny_patch16``, crop
64): a records-fed training run equals the directory-fed one bit for bit,
``--pretrained`` puts the file's encoder in both students, the COCO
evaluation reads records as it reads the tree and agrees with the JAX
package's evaluator, and the CRF width probe runs."""

import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dupl_tpu.config import CrfConfig as JCrfConfig
from dupl_tpu.config import DataConfig as JDataConfig
from dupl_tpu.config import coco_config as j_coco_config
from dupl_tpu.data.coco import CocoSegDataset as JCocoSegDataset
from dupl_tpu.engine import checkpoint as jckpt
from dupl_tpu.engine import eval_seg as jeval
from dupl_tpu.models.network import DualStudent as JDualStudent
from dupl_tpu_torch.config import CrfConfig, DataConfig, ModelConfig, coco_config
from dupl_tpu_torch.data import records
from dupl_tpu_torch.data.coco import write_synthetic_coco
from dupl_tpu_torch.engine import eval_seg as teval
from dupl_tpu_torch.engine import train as train_mod
from dupl_tpu_torch.models.convert import load_model, load_weights
from dupl_tpu_torch.models.network import DualStudent

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
TRAIN = [(70, 90), (64, 64), (90, 70), (80, 80), (66, 99), (75, 75)]
VAL = [(60, 80), (64, 64), (80, 60)]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A COCO tree, its two splits packed in two shards each, and a DeiT
    ``.pth`` of the tiny backbone (with the classifier head and the
    distillation token a release carries)."""
    out = tmp_path_factory.mktemp("coco")
    root, lists = write_synthetic_coco(str(out / "tree"), VAL, TRAIN, seed=7)
    shards = {}
    for split in ("train", "val_part"):
        records.pack_coco(root, lists, split, str(out / f"{split}.duplrec"),
                          shards=2)
        shards[split] = str(out / f"{split}-*.duplrec")
    model = DualStudent(ModelConfig(backbone="test_tiny_patch16"))
    g = torch.Generator().manual_seed(3)
    enc = {k: torch.randn(v.shape, generator=g) * 0.05
           for k, v in model.branch1.encoder.state_dict().items()}
    pth = str(out / "deit.pth")
    torch.save({"model": {**enc, "head.weight": torch.zeros(1000, 32),
                          "head.bias": torch.zeros(1000),
                          "dist_token": torch.zeros(1, 1, 32)}}, pth)
    return dict(root=root, lists=lists, shards=shards, pth=pth, enc=enc)


def _train_argv(work, *more):
    return ["--device", "cpu", "--dataset", "coco", "--work-dir", str(work),
            "--backbone", "test_tiny_patch16", "--crop-size", "64",
            "--cam-iters", "1", "--refine-switch-iters", "2",
            "--gmm-iters", "3", "--max-iters", "4", "--eval-iters", "4",
            "--log-iters", "1", "--samples-per-device", "2",
            "--num-workers", "2", *more]


def _run_dir(work):
    (d,) = os.listdir(work)
    return os.path.join(work, d)


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """The same four steps (warm-up, seg_static, seg, full) from the same
    pretrained encoder, fed from the tree and from the shards; the encoder
    each step starts from is kept."""
    tool = _tool("train_torch")
    starts = []
    plain = train_mod.Trainer.train_step

    def keeping(self, state, batch, step=None, aug_ops=None):
        starts.append({k: v.clone() for k, v in state.model.state_dict().items()
                       if ".encoder." in k})
        return plain(self, state, batch, step, aug_ops)

    out = {}
    train_mod.Trainer.train_step = keeping
    try:
        for feed, more in (
                ("tree", ["--data-folder", inputs["root"], "--list-folder",
                          inputs["lists"]]),
                ("records", ["--train-records", inputs["shards"]["train"],
                             "--val-records", inputs["shards"]["val_part"]])):
            work = tmp_path_factory.mktemp(feed)
            del starts[:]
            assert tool.main(_train_argv(work, "--pretrained", inputs["pth"],
                                         *more)) == 0
            out[feed] = dict(dir=_run_dir(work), first=starts[0])
    finally:
        train_mod.Trainer.train_step = plain
    return out


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_records_fed_run_equals_the_tree_fed_run(runs):
    """Losses of every step and the exported weights, bit for bit."""
    a, b = (_metrics(runs[k]["dir"]) for k in ("tree", "records"))
    train = [r for r in a if r["event"] == "train"]
    assert [r["phase"] for r in train] == ["warmup", "seg_static", "seg",
                                           "full"]
    keys = ("loss", "cls_loss", "ptc_loss", "seg_loss", "sim_loss",
            "reg_loss", "cls_f1")
    assert [[r[k] for k in keys] for r in a if r["event"] == "train"] == [
        [r[k] for k in keys] for r in b if r["event"] == "train"]
    assert all(np.isfinite(r["loss"]) for r in train)
    va, vb = ([r for r in m if r["event"] == "val"] for m in (a, b))
    assert len(va) == len(vb) == 1
    assert {k: v for k, v in va[0].items() if k.endswith(("miou", "f1_1",
                                                          "f1_2"))} == {
        k: v for k, v in vb[0].items() if k.endswith(("miou", "f1_1", "f1_2"))}
    wa, wb = (np.load(os.path.join(runs[k]["dir"], "checkpoints",
                                   "weights.npz")) for k in ("tree", "records"))
    assert sorted(wa.files) == sorted(wb.files)
    for k in wa.files:
        np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)


def test_pretrained_encoder_before_the_first_step(runs, inputs):
    """Both students start from the file's encoder bit for bit; the run's
    log names the file."""
    for feed in ("tree", "records"):
        first = runs[feed]["first"]
        for k, v in inputs["enc"].items():
            for b in ("branch1", "branch2"):
                assert torch.equal(first[f"{b}.encoder.{k}"], v), (feed, b, k)
        with open(os.path.join(runs[feed]["dir"], "train.log")) as f:
            assert f"loaded pretrained encoder from {inputs['pth']}" in f.read()


def test_resume_wins_over_pretrained(runs, inputs):
    """``--resume`` that finds a checkpoint restores it and ignores
    ``--pretrained``, as the JAX tool does."""
    run_dir = runs["tree"]["dir"]
    with open(os.path.join(run_dir, "train.log")) as f:
        before = f.read()
    assert _tool("train_torch").main(_train_argv(
        run_dir, "--resume", "--pretrained", inputs["pth"], "--data-folder",
        inputs["root"], "--list-folder", inputs["lists"])) == 0
    with open(os.path.join(run_dir, "train.log")) as f:
        added = f.read()[len(before):]
    assert "resumed from step 4" in added
    assert "loaded pretrained encoder" not in added


def _eval_argv(weights, *more):
    return ["--device", "cpu", "--dataset", "coco", "--weights", weights,
            "--backbone", "test_tiny_patch16", "--crop-size", "64",
            "--batch-size", "2", *more]


def test_eval_cli_reads_records_as_it_reads_the_tree(runs, inputs, capsys):
    """``tools/eval_seg_torch.py --dataset coco``: the COCO protocol (split
    val_part, fixed crop, scales 1.0 / 1.25 / 1.5 summed at the decoder
    grid, device CRF) from the shards prints the tree's table and
    histograms; the histograms count every labelled pixel."""
    tool = _tool("eval_seg_torch")
    weights = os.path.join(runs["tree"]["dir"], "checkpoints", "weights.npz")
    tables, results = [], []
    for more in (["--data-folder", inputs["root"], "--list-folder",
                  inputs["lists"]],
                 ["--records", inputs["shards"]["val_part"]]):
        capsys.readouterr()
        results.append(tool.main(_eval_argv(weights, *more)))
        tables.append([line for line in capsys.readouterr().out.splitlines()
                       if not line[:4].isdigit()])     # not a log line
    a, b = results
    for k in ("hist_1", "hist_2", "crf_hist"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].shape == (81, 81)
        assert a[k].sum() == sum(h * w - 4 for h, w in VAL)
    assert a["branch"] == b["branch"]
    assert tables[0] == tables[1]
    assert "mIoU" in "".join(tables[0]) and "+CRF" in "".join(tables[0])


def test_coco_protocol_matches_jax(inputs, tmp_path):
    """The evaluator as the COCO command line sets it up, fp32 on both
    sides, on the same JAX-initialised weights: the port on the shards,
    the JAX package on the tree; within tests/test_torch_eval.py's bounds
    (0.1% of pixels moved, mIoU within 2e-3, the same branch)."""
    model_kw = dict(backbone="test_tiny_patch16", compute_dtype="float32")
    cfg = coco_config(model=dataclasses.replace(coco_config().model,
                                                **model_kw),
                      data=DataConfig(crop_size=64), crf=CrfConfig(iter_max=2))
    jcfg = j_coco_config(model=dataclasses.replace(j_coco_config().model,
                                                   **model_kw),
                         data=JDataConfig(crop_size=64),
                         crf=JCrfConfig(iter_max=2))
    jmodel = JDualStudent(jcfg.model)
    params = jmodel.init(jax.random.PRNGKey(1),
                         jnp.zeros((1, 64, 64, 3), jnp.float32))
    path = str(tmp_path / "w.npz")
    jckpt.export_weights(path, params)
    ev_kw = dict(scales=(1.0, 1.25, 1.5), merge="sum", input_mode="fixed",
                 merge_at="decoder")
    got = teval.SegEvaluator(cfg, load_model(cfg, path, "cpu"), **ev_kw).run(
        records.RecordCocoSegDataset(inputs["shards"]["val_part"]),
        batch_size=2, crf="device")
    want = jeval.SegEvaluator(jcfg, jmodel, **ev_kw).run(
        params, JCocoSegDataset(inputs["root"], inputs["lists"]),
        batch_size=2, crf="device")
    assert got["branch"] == want["branch"]
    for k in ("hist_1", "hist_2", "crf_hist"):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.sum() == w.sum() > 0, k
        assert np.abs(g - w).sum() / 2 <= 1e-3 * w.sum(), k
    for k in ("seg_score_1", "seg_score_2", "crf_score"):
        assert abs(got[k]["miou"] - want[k]["miou"]) <= 2e-3, k
    assert load_weights(path)["branch1.classifier.weight"].shape[0] == 80


def test_crf_width_probe_runs_on_the_cpu(capsys):
    rows = _tool("crf_width_probe_torch").main(
        ["--device", "cpu", "--batch", "1", "--size", "32"])
    assert [(r["classes"], r["pos_w"]) for r in rows] == [
        (c, w) for c in (21, 32, 81) for w in (1.0, 0.0)]
    assert all(r["ms"] > 0 for r in rows)
    assert "C= 81 pos_w=0.0" in capsys.readouterr().out
