"""Data parallelism of the port in one process (dupl_tpu_torch/parallel,
the global-batch losses of ops/losses.py and engine/train.py): one
process's ``Dist`` is the identity and its step the bare trainer's, bit for
bit, also through a process group of one; the losses of a batch split in
two, with the halves' counts summed, add up to the JAX package's loss of the
whole batch, value and gradient; a rank's strong-view ops are its columns of
the global batch's draw; a model-parallel size must divide the world.  The ranks
themselves run in tests/test_torch_multiproc.py."""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dupl_tpu.ops import losses as jlosses
from dupl_tpu_torch.data.pipeline import synthetic_batch
from dupl_tpu_torch.engine.train import Trainer
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.ops import augment as augment_ops
from dupl_tpu_torch.ops import losses
from dupl_tpu_torch.parallel import data_parallel, dryrun, mesh
from dupl_tpu_torch.parallel.mesh import Dist
from dupl_tpu_torch.utils.logging import AverageMeter

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-7
LOSS_KEYS = ("loss", "cls_loss", "ptc_loss", "seg_loss", "sim_loss",
             "reg_loss", "cls_score")


def _cfg(**over):
    """The tiny recipe with a phase boundary at steps 1 and 2, a seg step
    with PAR labels and a full step whose consistency term has pixels."""
    return dataclasses.replace(dryrun.tiny_config(), cam_iters=1,
                               gmm_iters=2, reg_conf_thre=0.02, **over)


@pytest.fixture(scope="module")
def weights():
    return Trainer(_cfg(), device="cpu").init_state(seed=0).model.state_dict()


def _steps(cfg, weights, d, batch, n=3):
    """``n`` train steps from ``weights``: (metrics, grads, params)."""
    model = DualStudent(cfg.model)
    model.load_state_dict(weights)
    trainer = Trainer(cfg, model=model, device="cpu", dist=d)
    state = trainer.init_state(init=False)
    out = []
    for step in range(n):
        state, m = trainer.train_step(state, batch, step=step)
        out.append(({k: v.clone() for k, v in m.items()},
                    {k: p.grad.clone() for k, p in
                     state.model.named_parameters() if p.grad is not None}))
    return out, dict(state.model.named_parameters())


def test_one_process_dist_is_the_identity(monkeypatch):
    d = Dist()
    assert not d.active and d.is_main and d.unit == 1.0
    x = torch.arange(4.0)
    assert d.sum_(x) is x and torch.equal(x, torch.arange(4.0))
    counts = [torch.tensor(3), torch.tensor(2.0)]
    assert d.sum_counts(counts) == counts
    assert d.batch_slice(4) == slice(0, 4)
    assert d.broadcast_object("stamp") == "stamp"
    assert d.max_(15) == 15 and d.max_(0) == 0
    d.barrier()
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert mesh.init_from_env("cpu") == (Dist(), torch.device("cpu"))
    with pytest.raises(SystemExit, match="torchrun"):
        mesh.init_from_env("cpu", multihost=True)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.init_from_env("cpu") == (Dist(), torch.device("cpu"))
    meter = AverageMeter()
    meter.add({k: torch.tensor(float(i)) for i, k in enumerate(LOSS_KEYS)})
    meter.add({k: torch.tensor(2.0 * i) for i, k in enumerate(LOSS_KEYS)})
    assert data_parallel.reduce_window(meter, d, LOSS_KEYS) == {
        k: 1.5 * i for i, k in enumerate(LOSS_KEYS)}


def test_world1_steps_are_the_bare_trainers_bit_for_bit(weights):
    """Warm-up, seg and full through ``Trainer(dist=Dist())`` and through a
    gloo process group of one (every count, gradient and metric reduction
    runs, over one rank) give the bare trainer's losses, gradients and
    weights bit for bit."""
    cfg, batch = _cfg(), synthetic_batch(2, crop=64)
    bare, bare_params = _steps(cfg, weights, None, batch)
    assert bare[2][0]["reg_loss"] > 0 and bare[1][0]["seg_loss"] > 0
    plain, plain_params = _steps(cfg, weights, Dist(), batch)
    d = mesh.init_group(0, 1, "cpu",
                        init_method=f"tcp://127.0.0.1:{dryrun.free_port()}")
    try:
        assert d.active and d.world == 1
        grouped, grouped_params = _steps(cfg, weights, d, batch)
    finally:
        d.close()
    for other, params in ((plain, plain_params), (grouped, grouped_params)):
        for (m, g), (bm, bg) in zip(other, bare):
            for k in LOSS_KEYS:
                assert torch.equal(m[k], bm[k]), k
            assert g.keys() == bg.keys()
            for k in g:
                assert torch.equal(g[k], bg[k]), k
        for k, p in params.items():
            assert torch.equal(p, bare_params[k]), k
    assert set(grouped[0][0]) == set(LOSS_KEYS) | set(
        data_parallel.F1_COUNTS)
    assert set(plain[0][0]) == set(LOSS_KEYS)


def _halves(arrays, counts_fn=None):
    """Each array split in two along the batch, and the halves' counts
    summed (None without ``counts_fn``)."""
    halves = [[torch.from_numpy(a[:len(a) // 2]).requires_grad_(
        a.dtype == np.float32) for a in arrays],
        [torch.from_numpy(a[len(a) // 2:]).requires_grad_(
            a.dtype == np.float32) for a in arrays]]
    if counts_fn is None:
        return halves, None
    per = [counts_fn(*h) for h in halves]
    return halves, tuple(a + b for a, b in zip(*per))


def _check_split(jfn, share, arrays, counts_fn=None):
    """The sum of the two halves' shares (rank 0 holds the constant) equals
    ``jfn`` of the whole batch, and so do the concatenated gradients."""
    diff = [i for i, a in enumerate(arrays) if a.dtype == np.float32]
    jval, jgrads = jax.value_and_grad(
        lambda *d: jfn(*[d[diff.index(i)] if i in diff else jnp.asarray(a)
                         for i, a in enumerate(arrays)]),
        argnums=tuple(range(len(diff))))(
            *[jnp.asarray(arrays[i]) for i in diff])
    halves, counts = _halves(arrays, counts_fn)
    total = sum(share(*h, counts, unit, len(arrays[0]))
                for h, unit in zip(halves, (1.0, 0.0)))
    np.testing.assert_allclose(total.item(), float(jval), rtol=RTOL)
    total.backward()
    for j, i in enumerate(diff):
        got = torch.cat([torch.zeros_like(h[i]) if h[i].grad is None
                         else h[i].grad for h in halves]).numpy()
        jg = np.asarray(jgrads[j])
        np.testing.assert_allclose(got, jg, rtol=RTOL,
                                   atol=ATOL + 1e-5 * np.abs(jg).max())


def test_global_count_losses_sum_to_the_jax_loss():
    rs = np.random.RandomState(0)
    logits = rs.randn(4, 20).astype(np.float32) * 3
    targets = (rs.rand(4, 20) < 0.2).astype(np.float32)
    _check_split(jlosses.multilabel_soft_margin_loss,
                 lambda x, y, c, u, b: losses.multilabel_soft_margin_loss(
                     x, y, batch=b), [logits, targets])

    seg = rs.randn(4, 8, 8, 21).astype(np.float32)
    lab = rs.randint(0, 21, (4, 8, 8)).astype(np.int64)
    lab[rs.rand(4, 8, 8) < 0.3] = 0
    lab[rs.rand(4, 8, 8) < 0.2] = 255
    lab[2:] = np.where(lab[2:] == 0, 255, lab[2:])  # a half without bg
    _check_split(jlosses.seg_loss,
                 lambda x, y, c, u, b: losses.seg_loss(x, y, 255, c),
                 [seg, lab], lambda x, y: losses.seg_counts(y, 255))

    fmap = rs.randn(4, 4, 4, 16).astype(np.float32)
    aff = rs.choice([0, 1, 255], size=(4, 16, 16)).astype(np.uint8)
    _check_split(jlosses.masked_ptc_loss,
                 lambda x, y, c, u, b: losses.masked_ptc_loss(x, y, c, u),
                 [fmap, aff], lambda x, y: losses.ptc_counts(y))

    fmap_b = rs.randn(4, 4, 4, 16).astype(np.float32)
    _check_split(jlosses.discrepancy_loss,
                 lambda x, y, c, u, b: losses.discrepancy_loss(
                     x, y, batch=b, unit=u), [fmap, fmap_b])


def test_a_rank_takes_its_columns_of_the_global_draw(weights, monkeypatch):
    """Rank 1 of 2 draws the strong view's (aug_n, global B) ops from its
    generator and takes columns 2-3, so the generators of all ranks stay in
    step with one process at the global batch; given ops are global too."""
    cfg = _cfg()
    seen = []
    plain = augment_ops.strong_augment
    monkeypatch.setattr(augment_ops, "strong_augment",
                        lambda x, ops, m: seen.append(ops) or plain(x, ops, m))
    model = DualStudent(cfg.model)
    model.load_state_dict(weights)
    trainer = Trainer(cfg, model=model, device="cpu",
                      dist=Dist(rank=1, world=2))
    state = trainer.init_state(init=False)
    batch = synthetic_batch(2, crop=64)
    trainer.grad_step(state, batch, step=2)
    ref = torch.Generator().manual_seed(cfg.seed)
    want = augment_ops.draw_ops(ref, cfg.aug_n, 4)
    assert torch.equal(seen[0], want[:, 2:4])
    assert torch.equal(state.rng.get_state(), ref.get_state())
    given = torch.arange(4 * cfg.aug_n).reshape(cfg.aug_n, 4) % 7
    trainer.grad_step(state, batch, step=2, aug_ops=given)
    assert torch.equal(seen[1], given[:, 2:4])


def test_gradient_buckets_and_set_digest():
    grads = [torch.zeros(n, dtype=dt) for n, dt in
             ((3, torch.float32), (5, torch.float32), (2, torch.bfloat16),
              (1, torch.float32))]
    old = data_parallel.BUCKET_ELEMS
    try:
        data_parallel.BUCKET_ELEMS = 6
        sizes = [[g.numel() for g in b]
                 for b in data_parallel._buckets(grads)]
    finally:
        data_parallel.BUCKET_ELEMS = old
    assert sizes == [[3], [5], [2], [1]]
    assert [len(b) for b in data_parallel._buckets(grads)] == [2, 1, 1]
    params = [torch.nn.Parameter(torch.zeros(2)) for _ in range(4)]
    empty = data_parallel.grad_set_digest(params)
    params[1].grad = torch.zeros(2)
    one = data_parallel.grad_set_digest(params)
    params[1].grad, params[2].grad = None, torch.zeros(2)
    assert len({empty, one, data_parallel.grad_set_digest(params)}) == 3


def test_model_parallel_must_divide_the_world(tmp_path, monkeypatch):
    """``--model-parallel`` runs the data x model grid under torchrun; one
    that does not divide the world exits with a message before any
    rendezvous (here one process, and three ranks at 2), with or without
    ``--fsdp`` and ``--multihost``."""
    spec = importlib.util.spec_from_file_location(
        "_train_torch", ROOT / "tools" / "train_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert not hasattr(tool, "refuse_unported")
    assert tool.parse_args(["--model-parallel", "2"]).model_parallel == 2
    base = ["--device", "cpu", "--data-folder", str(tmp_path),
            "--work-dir", str(tmp_path / "w")]
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="does not divide the 1 ranks"):
        tool.main(base + ["--model-parallel", "2"])
    for k, v in dict(WORLD_SIZE="3", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit, match="does not divide the 3 ranks"):
        tool.main(base + ["--model-parallel", "2", "--fsdp", "--multihost"])
    assert not (tmp_path / "w").exists()
    # the grid's order is make_mesh's: the model axis innermost
    d = Dist(rank=5, world=8, n_model=2)
    assert (d.n_data, d.data_rank, d.model_rank, d.unit) == (4, 2, 1, 0.0)
    assert d.batch_slice(3) == slice(6, 9)
    assert Dist(rank=1, world=8, n_model=2).unit == 1.0
