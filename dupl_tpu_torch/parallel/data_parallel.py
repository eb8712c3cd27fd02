"""The gradient and metric reductions of data-parallel training.

``DistributedDataParallel`` does not fit the trainer: a step runs three
differentiated forwards (each student's ``forward_with_cams`` and the strong
view's ``DualStudent.forward``) and the no-grad CAM passes before one
``backward()``, and DDP only knows the calls that go through its wrapper.
And it averages the gradients of per-rank losses, where the JAX package's
loss is one ratio of global sums.  So the trainer computes each rank's share
of the global loss and, after ``backward()``, :func:`reduce_gradients` sums
the gradients of exactly the parameters that have one.  A parameter outside
the phase's graph (the decoder in warm-up) keeps ``grad is None`` on every
rank, and the optimizer skips it, as in one process.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from dupl_tpu_torch.parallel.mesh import Dist

# Elements of one flat all-reduce: 64 MiB of fp32 (a ViT-B/16 dual student
# has ~184 M parameters, so about a dozen buckets).
BUCKET_ELEMS = 1 << 24
# F1 counts of a step's branch-1 classifier, summed over the ranks at a log
# boundary (``Trainer._metrics``)
F1_COUNTS = ("cls_tp", "cls_fp", "cls_fn")
# the metrics a log line reads
METRIC_KEYS = ("cls_loss", "ptc_loss", "seg_loss", "sim_loss", "reg_loss",
               "loss", "cls_score")


def _buckets(grads: List[torch.Tensor]) -> Iterable[List[torch.Tensor]]:
    """Consecutive gradients of one dtype, at most ``BUCKET_ELEMS`` a
    bucket (a larger gradient alone)."""
    bucket, n = [], 0
    for g in grads:
        if bucket and (g.dtype != bucket[0].dtype
                       or n + g.numel() > BUCKET_ELEMS):
            yield bucket
            bucket, n = [], 0
        bucket.append(g)
        n += g.numel()
    if bucket:
        yield bucket


@torch.no_grad()
def reduce_gradients(params: Sequence[torch.nn.Parameter], d: Dist) -> None:
    """Sum over the data ranks, in place, the ``.grad`` of every parameter
    that has one, in flat buckets; one process: nothing.  Under tensor
    parallelism a sharded leaf's gradient is already whole on its rank and
    a replicated leaf's the same on every rank of a model group
    (``tensor_parallel.sync_replicated_gradients``), so the data group is
    all that sums."""
    if not d.active:
        return
    grads = [p.grad for p in params if p.grad is not None]
    for bucket in _buckets(grads):
        flat = d.sum_(_flatten_dense_tensors(bucket))
        for g, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(r)


def grad_set_digest(params: Sequence[torch.nn.Parameter]) -> int:
    """A digest of which parameters have a gradient (a polynomial over
    their positions, modulo the Mersenne prime 2^61 - 1)."""
    prime, h = (1 << 61) - 1, 0
    for i, p in enumerate(params):
        if p.grad is not None:
            h = (h + pow(3, i + 1, prime)) % prime
    return h


@torch.no_grad()
def check_same_grad_set(params: Sequence[torch.nn.Parameter], d: Dist,
                        device) -> None:
    """Fail unless every rank of the world has a gradient on the same
    parameters (the buckets of :func:`reduce_gradients` would not line
    up).  The digest is
    compared on the device, and a mismatch fails a device-side assert, so
    the host does not wait for the step."""
    if not d.active:
        return
    h = grad_set_digest(params)
    t = torch.stack([torch.full((), h, dtype=torch.int64, device=device),
                     torch.full((), -h, dtype=torch.int64, device=device)])
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX,
                                 group=d.group)
    torch._assert_async(t[0] == -t[1], "the ranks have gradients on "
                        "different sets of parameters")


def reduce_window(meter, d: Dist, keys: Sequence[str]) -> Dict[str, float]:
    """Pop a log window's metrics from ``meter``: the mean of each of
    ``keys`` over the window's steps, as one process at the global batch
    logs them.  One process: ``meter.pop`` of each key.  A data-parallel
    rank: the means of the loss shares summed over the data ranks, and
    ``cls_score`` the window's mean of each step's F1 from its counts summed
    over them (every rank of a model group holds the same shares); one
    collective, read on the host."""
    if not d.active:
        return {k: meter.pop(k) for k in keys}
    means = [k for k in keys if k != "cls_score"]
    meter.pop_values("cls_score")      # the rank's own F1: replaced below
    window = {k: meter.pop_values(k) for k in means + list(F1_COUNTS)}
    steps = len(window[F1_COUNTS[0]])
    flat = torch.cat(
        [torch.stack([torch.stack([v.double() for v in window[k]]).mean()
                      for k in means])]
        + [torch.stack([v.double() for v in window[k]]) for k in F1_COUNTS])
    flat = d.sum_(flat).cpu()
    out = {k: float(v) for k, v in zip(means, flat[:len(means)])}
    tp, fp, fn = flat[len(means):].reshape(3, steps)
    if "cls_score" in keys:
        out["cls_score"] = float(
            (2 * tp / (2 * tp + fp + fn).clamp_min(1)).mean())
    return out
