"""Training steps across spawned gloo CPU processes, beside one process on
the same global batches (counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m dupl_tpu_torch.parallel.dryrun [N]

spawns N processes (default 2) that run one phase-3 (``full``) step of
``test_tiny_patch16`` at crop 64, plain data parallel and then ``fsdp`` at
N x 1, and at an even N of 4 or more the tensor-parallel arms of the JAX
dry run, dp x tp and fsdp x tp at N / 2 x 2; each data rank trains 2
samples of the global batch.  It runs the same step in this process, prints
each arm's loss, gradient and parameter gaps to it, and fails beyond their
bounds.  :func:`run_spawned` and :func:`run_rank` are the machinery: the
CPU tests hold the ranks to one process with them.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from dupl_tpu_torch import config as config_lib
from dupl_tpu_torch.data.pipeline import synthetic_batch
from dupl_tpu_torch.engine import checkpoint as ckpt
from dupl_tpu_torch.engine.train import Trainer
from dupl_tpu_torch.models.network import DualStudent
from dupl_tpu_torch.parallel.data_parallel import METRIC_KEYS, reduce_window
from dupl_tpu_torch.parallel.mesh import Dist, init_from_env, shard_state
from dupl_tpu_torch.utils.logging import AverageMeter


@dataclasses.dataclass
class Job:
    """Steps every rank runs.  ``batches`` are global batches (numpy, one a
    step) of which a rank trains its slice; ``aug_ops`` the strong view's
    (aug_n, global B) op indices of each step, or None to draw them from the
    state's generator.  ``n_model``: ranks a model group (tensor
    parallelism).  ``resume_dir``: restore its latest checkpoint into the
    placed state first; ``save_dir``: save after the last step."""

    cfg: object
    weights: Dict[str, np.ndarray]
    batches: List[Dict[str, np.ndarray]]
    steps: List[int]
    aug_ops: List[Optional[np.ndarray]]
    fsdp: bool = False
    n_model: int = 1
    resume_dir: Optional[str] = None
    save_dir: Optional[str] = None


def _numpy(tensors, model) -> Dict[str, np.ndarray]:
    """Tensors keyed by parameter name, gathered to the one-device layout
    (a collective when ``model`` is sharded), as numpy."""
    return {k: v.detach().cpu().numpy()
            for k, v in ckpt.full_state(tensors, model).items()}


def run_rank(job: Job, d: Dist) -> Dict:
    """Run ``job`` as rank ``d.rank`` on the CPU.  Returns the metrics of
    every step summed over the data ranks (what one process at the global
    batch logs), the last step's gradients (summed over the data ranks),
    the full weights and Adam moments (gathered) and this rank's local
    moment and parameter sizes."""
    model = DualStudent(job.cfg.model)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in job.weights.items()})
    trainer = Trainer(job.cfg, model=model, device="cpu", dist=d)
    state = shard_state(trainer.init_state(init=False), d, fsdp=job.fsdp)
    if job.resume_dir:
        state = ckpt.restore_state(job.resume_dir, state)
    meter, metrics = AverageMeter(), []
    for step, batch, ops in zip(job.steps, job.batches, job.aug_ops):
        b = len(batch["image"]) // d.n_data
        local = {k: v[d.batch_slice(b)] for k, v in batch.items()}
        ops = None if ops is None else torch.from_numpy(ops)
        state, m = trainer.train_step(state, local, step=step, aug_ops=ops)
        meter.add(m)
        metrics.append(reduce_window(meter, d, METRIC_KEYS))
    if job.save_dir:
        ckpt.save_state(job.save_dir, state)
    model, opt = state.model, state.optimizer
    names = {p: n for n, p in model.named_parameters()}

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    moments = {k: _numpy({names[p]: st[k] for p, st in opt.state.items()},
                         model) for k in ("exp_avg", "exp_avg_sq")}
    return {
        "metrics": metrics,
        "weights": _numpy(model.state_dict(), model),
        "moments": {names[p]: (st["step"], moments["exp_avg"][names[p]],
                               moments["exp_avg_sq"][names[p]])
                    for p, st in opt.state.items()},
        "local_moment_numel": {names[p]: local(st["exp_avg"]).numel()
                               for p, st in opt.state.items()},
        "local_param_numel": {n: local(p).numel()
                              for n, p in model.named_parameters()},
        "global_step": opt.global_step,
        "rng": state.rng.get_state().numpy(),
        "grads": _numpy({n: p.grad for n, p in model.named_parameters()
                         if p.grad is not None}, model),
    }


def _worker(rank: int, world: int, port: int, results, job: Job) -> None:
    torch.set_num_threads(1)
    # the environment torchrun gives a rank
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    d, _ = init_from_env("cpu", n_model=job.n_model)
    try:
        results.put((rank, run_rank(job, d) if isinstance(job, Job)
                     else job.run(d)))
    finally:
        d.close()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_spawned(world: int, job, timeout: float = 600.0) -> List:
    """Run ``job`` in ``world`` spawned gloo CPU processes; their
    :func:`run_rank` results in rank order.  ``job`` may also be any
    picklable object with ``n_model`` and ``run(d)``, whose results are
    returned instead (an inference job)."""
    return spawn_ranks(_worker, world, (job,), timeout)


def spawn_ranks(target, world: int, args=(), timeout: float = 600.0) -> List:
    """Start ``target(rank, world, port, results, *args)`` in ``world``
    spawned processes (``port``: a free port on this host for the group's
    rendezvous) and return what each put on ``results`` as ``(rank,
    value)``, in rank order.  A rank that fails raises here (the others are
    stopped)."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").Queue()
    ctx = mp.start_processes(target, args=(world, free_port(), results,
                                           *args),
                             nprocs=world, join=False, start_method="spawn")
    out, deadline = {}, time.monotonic() + timeout
    try:
        # drain the queue before joining: a rank blocks on a full pipe
        while len(out) < world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish in "
                                   f"{timeout} s")
            try:
                rank, res = results.get(timeout=0.5)
                out[rank] = res
            except queue.Empty:
                ctx.join(timeout=0)        # raises if a rank failed
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError("the ranks did not exit")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=10)
    return [out[r] for r in range(world)]


def max_rel_gap(want: Dict[str, np.ndarray], got: Dict[str, np.ndarray],
                rel: float = 1.0, floor: float = 0.0) -> float:
    """The largest over leaves of |got - want|max / max(rel |want|max,
    floor): with the defaults the largest relative gap; with
    ``tests/test_multihost.py``'s bound (``rel`` 1e-5, ``floor`` 1e-7) at
    most 1 where every leaf is inside it."""
    if set(want) != set(got):
        raise ValueError(f"different leaves: {sorted(set(want) ^ set(got))}")
    return max(float(np.abs(got[k] - w).max())
               / max(rel * float(np.abs(w).max()), floor, 1e-30)
               for k, w in want.items())


def tiny_config():
    """The dry run's recipe (``__graft_entry__.py``'s): the tiny ViT in
    float32, 2 PAR rounds, the GMM gate at 10 pixels, every step in the
    full phase."""
    base = config_lib.voc_config()
    return config_lib.voc_config(
        model=dataclasses.replace(base.model, backbone="test_tiny_patch16",
                                  compute_dtype="float32"),
        par=dataclasses.replace(base.par, num_iter=2),
        gmm=config_lib.GmmConfig(min_pixels=10), cam_iters=0, gmm_iters=0,
        max_iters=10)


# The dry run's bounds: the loss and every
# gradient leaf within float32 reduction-order noise of one process (the
# ranks sum partial sums in another order), the updated parameters within
# tests/test_multihost.py's bound.  A tensor-parallel arm also splits the
# row-parallel layers' sums, so a value within that noise of zero can
# leave a ReLU on the other side: at these sizes one such element moves a
# decoder leaf's gradient by up to ~10% of its largest entry.  Its
# parameters are held to tests/test_parallel.py:143's bound instead
# (``TP_PARAM_TOL``: rtol, atol) and its gradient to ``TP_GRAD_REL``: sound
# arms read 9.2% there, a replicated leaf's gradient summed over the model
# group (twice its value) reads 100%.
LOSS_REL, GRAD_REL, TP_GRAD_REL = 1e-5, 1e-4, 0.3
TP_PARAM_TOL = (5e-4, 2e-5)


def dryrun_multichip(n: int = 2) -> Dict[str, Dict[str, float]]:
    """One full-phase step on ``n`` spawned ranks, data parallel and FSDP,
    and at an even ``n`` of 4 or more dp x tp and fsdp x tp at ``n / 2`` x
    2, beside one process; prints each arm's gaps and raises beyond the
    bounds."""
    cfg = tiny_config()
    trainer = Trainer(cfg, device="cpu")
    weights = _numpy(trainer.init_state(seed=0).model.state_dict(),
                     trainer.model)
    arms = [("data parallel", 1, False), ("fsdp", 1, True)]
    if n % 2 == 0 and n >= 4:
        arms += [("dp x tp", 2, False), ("fsdp x tp", 2, True)]
    gaps = {}
    for arm, n_model, fsdp in arms:
        n_data = n // n_model
        job = Job(cfg, weights, [synthetic_batch(2 * n_data, crop=64)], [0],
                  [None], fsdp=fsdp, n_model=n_model)
        one = run_rank(job, Dist())
        ranks = run_spawned(n, job)
        want, got = one["metrics"][0]["loss"], ranks[0]["metrics"][0]["loss"]
        tp = n_model > 1
        gaps[arm] = g = {
            "loss": abs(got - want) / abs(want),
            "grad": max_rel_gap(one["grads"], ranks[0]["grads"]),
            "param": max_rel_gap(one["weights"], ranks[0]["weights"]),
            "param_bound": max_rel_gap(one["weights"], ranks[0]["weights"],
                                       *(TP_PARAM_TOL if tp else (1e-5, 1e-7)))}
        print(f"dryrun_multichip({n}): {arm}, {n} gloo processes as "
              f"{n_data} x {n_model} (data x model), batch 2 a data rank, "
              f"against one process at batch {2 * n_data} | loss "
              f"{got:.6f} ({want:.6f}), relative gap {g['loss']:.3g} (bound "
              f"{LOSS_REL}) | largest relative gradient gap {g['grad']:.3g} "
              f"(bound {TP_GRAD_REL if tp else GRAD_REL}) | largest relative "
              f"parameter gap {g['param']:.3g}, {g['param_bound']:.3g} of "
              f"the bound", flush=True)
        if not (g["loss"] <= LOSS_REL and g["param_bound"] <= 1.0
                and g["grad"] <= (TP_GRAD_REL if tp else GRAD_REL)):
            raise RuntimeError(f"dryrun_multichip({n}) {arm}: outside the "
                               f"bounds {g}")
    return gaps


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
