"""Process groups and parameter sharding (counterpart of
``dupl_tpu/parallel/mesh.py``: its ``data`` and ``model`` axes and FSDP).

The JAX package shards one global batch over a mesh's ``data`` axis, the
Megatron layers over its ``model`` axis, and lets XLA insert the
collectives.  Here each rank is one process with one device, started by
``torchrun`` (one node or several).  The ranks form a grid of ``n_data`` x
``n_model``, ordered as ``make_mesh`` reshapes its devices: ``rank =
data_rank * n_model + model_rank``, so the model axis is innermost (the
ranks of one model group are neighbours, on one node's NVLink).  A data
rank holds its contiguous slice of the global batch (``PrefetchLoader(
shard=data_rank, num_shards=n_data)``); the ranks of one model group hold
the same samples and each its share of the tensor-parallel layers
(``parallel/tensor_parallel.py``).  :class:`Dist` says who the process is
and carries the groups; with no group (one process) every reduction is the
identity and the trainer runs its one-device code.

``shard_state(..., fsdp=True)`` shards the parameters and both Adam moments
over the data ranks with FSDP2's ``fully_shard`` (dim 0 of each tensor,
torch's chunk split; the JAX package picks the largest divisible dim, which
gives the same numbers and the same memory share).  Each ViT block, the
patch embedding, each decoder and each ``Student`` is one unit.  The
``Student``s are the roots: the trainer calls their ``forward_with_cams``
and ``cam_only`` directly, and FSDP2 requires a root's first forward to go
through the root, which a wrapped ``DualStudent`` (it owns no parameter)
would not see.  Gradients are reduce-scattered as plain sums: each data
rank's loss is its share of the global batch's loss (``engine/train.py``),
so the sum is the global gradient.  Under tensor parallelism FSDP shards
each rank's tensor-parallel share over its data group.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import warnings
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Rank 0 validates alone at an evaluation boundary while the other ranks
# wait at a barrier of the host group: long enough for a VOC validation.
HOST_TIMEOUT = datetime.timedelta(hours=2)


@dataclasses.dataclass(frozen=True)
class Dist:
    """Who this process is among the training processes.  ``group`` is None
    for one process: then nothing is reduced and nothing waits.
    ``host_group`` is a gloo group over the same ranks (``group`` itself
    when that is gloo) for barriers and host values (the run directory's
    name, the preemption signal), so that they never touch the card.
    ``n_model`` ranks form one model group (tensor parallelism);
    ``model_group`` is this rank's (None at ``n_model`` 1), ``data_group``
    the ranks of this model rank in every model group, over which the batch,
    the losses' counts and the gradients are reduced (``group`` itself at
    ``n_model`` 1)."""

    rank: int = 0
    world: int = 1
    group: Optional[dist.ProcessGroup] = None
    host_group: Optional[dist.ProcessGroup] = None
    n_model: int = 1
    model_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None

    @property
    def active(self) -> bool:
        return self.group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def n_data(self) -> int:
        return self.world // self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def unit(self) -> float:
        """A loss's constant term on this rank: all of it on data rank 0
        (every model rank of it), none elsewhere, so that the data ranks'
        shares sum to it once."""
        return 1.0 if self.data_rank == 0 else 0.0

    def batch_slice(self, local_batch: int) -> slice:
        """This rank's samples of a global batch of ``local_batch *
        n_data`` (the loader's per-global-batch contiguous split, by data
        rank)."""
        r = self.data_rank
        return slice(r * local_batch, (r + 1) * local_batch)

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the data ranks in place; the identity for one
        process and at ``n_data`` 1."""
        if self.data_group is not None and self.n_data > 1:
            dist.all_reduce(x, group=self.data_group)
        return x

    def sum_counts(self, counts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """0-d counts summed over the data ranks in one collective, each
        back in its own dtype (exact: float64 holds integers up to 2^53).
        One process: the counts as given."""
        if self.group is None:
            return list(counts)
        flat = self.sum_(torch.stack([c.double() for c in counts]))
        return [f.to(c.dtype) for f, c in zip(flat, counts)]

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank (over the host group)."""
        if self.host_group is None:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]

    def max_(self, value: int) -> int:
        """The largest of the ranks' ``value`` (over the host group)."""
        if self.host_group is None:
            return value
        t = torch.tensor([value])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return int(t.item())

    def barrier(self) -> None:
        if self.host_group is not None:
            dist.barrier(group=self.host_group)

    def close(self) -> None:
        """Tear down the process group this process formed."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()


def check_grid(world: int, n_model: int) -> None:
    """Raise ``ValueError`` unless ``n_model`` ranks a model group divide
    the ``world`` (``make_mesh``'s rule: every device is used)."""
    if n_model < 1 or world % n_model:
        raise ValueError(
            f"model-parallel size {n_model} does not divide the {world} "
            "ranks; choose a divisor of the world size")


def _subgroups(rank: int, lists, **kw) -> dist.ProcessGroup:
    """This rank's group among ``lists`` of ranks (every rank creates every
    group, in the same order)."""
    groups = [dist.new_group(ranks, **kw) for ranks in lists]
    return next(g for ranks, g in zip(lists, groups) if rank in ranks)


def init_group(rank: int, world: int, device: torch.device, *,
               backend: Optional[str] = None,
               init_method: str = "env://", n_model: int = 1) -> Dist:
    """Join the process group of ``world`` ranks: NCCL for a card, gloo for
    the CPU unless ``backend`` says otherwise (gloo also reduces CUDA
    tensors, through the host).  An NCCL group gets a gloo group over the
    same ranks for host values; a gloo group serves for both.  At
    ``n_model`` above 1 the ranks form the data x model grid (the module
    docstring) with a model group and a data group each, on the world's
    backend; ``ValueError`` unless ``n_model`` divides ``world``."""
    check_grid(world, n_model)
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    gloo = backend == "gloo"
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        device_id=None if gloo else device,
        timeout=HOST_TIMEOUT if gloo else None)
    # a gloo group is its own host group
    host = (dist.group.WORLD if gloo
            else dist.new_group(backend="gloo", timeout=HOST_TIMEOUT))
    if n_model == 1:
        return Dist(rank, world, dist.group.WORLD, host,
                    data_group=dist.group.WORLD)
    n_data = world // n_model
    kw = {"timeout": HOST_TIMEOUT} if gloo else {}
    model = _subgroups(rank, [list(range(i * n_model, (i + 1) * n_model))
                              for i in range(n_data)], **kw)
    data = _subgroups(rank, [list(range(m, world, n_model))
                             for m in range(n_model)], **kw)
    return Dist(rank, world, dist.group.WORLD, host, n_model, model, data)


def init_from_env(device, multihost: bool = False, n_model: int = 1
                  ) -> Tuple[Dist, torch.device]:
    """The process group of a ``torchrun`` launch (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and this rank's device,
    ``cuda:LOCAL_RANK`` on a card.  Without that environment, or at
    ``WORLD_SIZE=1`` unless ``multihost``, no group: ``(Dist(), device)``.
    ``multihost`` requires the environment, as ``jax.distributed.initialize``
    requires a cluster.  ``n_model`` ranks form a model group;
    ``ValueError`` unless it divides the world (checked before any
    rendezvous)."""
    device = torch.device(device)
    env = os.environ
    world = int(env.get("WORLD_SIZE", "0"))
    check_grid(max(world, 1), n_model)
    if world == 0:
        if multihost:
            raise SystemExit("--multihost needs torchrun's environment (RANK, "
                             "WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                             "MASTER_PORT): launch with torchrun")
        return Dist(), device
    if world == 1 and not multihost:
        return Dist(), device
    local_rank = int(env.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    return init_group(int(env["RANK"]), world, device,
                      n_model=n_model), device


def broadcast_module(module: torch.nn.Module, d: Dist) -> None:
    """Rank 0's parameters and buffers on every rank (of the world)."""
    if d.group is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0, group=d.group)


def is_sharded(model: torch.nn.Module) -> bool:
    """Whether :func:`param_sharding` sharded ``model``."""
    from torch.distributed.fsdp import FSDPModule

    return any(isinstance(m, FSDPModule) for m in model.modules())


def param_sharding(model: torch.nn.Module, d: Dist) -> None:
    """Shard a ``DualStudent``'s parameters over the data ranks in place
    (FSDP2, see the module docstring); a gradient is reduce-scattered as a
    sum."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.fsdp import (FSDPModule, fully_shard,
                                        register_fsdp_forward_method)

    # FSDP2 warns when a unit returns a view (the patch embedding's
    # transpose, the decoder's permute, the student's reshaped feature map),
    # since an in-place op on it would skip the unit's backward hook.  No
    # caller writes into these outputs.
    warnings.filterwarnings("ignore", message="FSDP2-wrapped module .* "
                            "returned a view tensor")
    device = next(model.parameters()).device
    mesh = DeviceMesh.from_group(d.data_group, device.type)
    for student in (model.branch1, model.branch2):
        for unit in (*student.encoder.blocks, student.encoder.patch_embed,
                     student.decoder):
            fully_shard(unit, mesh=mesh)
        fully_shard(student, mesh=mesh)
        for method in ("forward_with_cams", "cam_only"):
            register_fsdp_forward_method(student, method)
    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.set_gradient_divide_factor(1.0)
            m.set_force_sum_reduction_for_comms(True)


def shard_like(ref: torch.Tensor, full: torch.Tensor) -> torch.Tensor:
    """``full`` laid out as ``ref`` is: this rank's shard of it when ``ref``
    is sharded (from this rank's own copy, no communication), else as is."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(ref, DTensor):
        return full
    return distribute_tensor(full.to(ref.device), ref.device_mesh,
                             ref.placements, src_data_rank=None)


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """A sharded tensor gathered from every rank (a collective), or ``t``."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def shard_state(state, d: Dist, fsdp: bool = False):
    """Place a ``TrainState`` on the ranks (counterpart of
    ``mesh.shard_state``): rank 0's weights on every rank; under tensor
    parallelism each rank then keeps its share of the tensor-parallel leaves
    (``tensor_parallel.shard_model``, no communication); with ``fsdp`` the
    parameters and both Adam moments sharded over the data ranks (a fresh
    optimizer over the sharded parameters takes the old one's moments,
    counts and schedule step).  Call it after any pretrained load and
    before a restore.  One process: ``state`` unchanged."""
    if not d.active:
        return state
    broadcast_module(state.model, d)
    old = state.optimizer
    names = {p: n for n, p in state.model.named_parameters()}
    if d.n_model > 1:
        from dupl_tpu_torch.parallel import tensor_parallel

        tensor_parallel.shard_model(state.model, d)
        for p, st in old.state.items():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = tensor_parallel.shard_like_model(names[p], st[k], d)
    if not fsdp:
        return state
    moments = {names[p]: st for p, st in old.state.items()}
    param_sharding(state.model, d)
    opt = type(old)(state.model, old.cfg, old.max_iters)
    opt.global_step = old.global_step
    for n, p in state.model.named_parameters():
        st = moments.get(n)
        if st:
            opt.state[p] = {"step": st["step"],
                            "exp_avg": shard_like(p, st["exp_avg"]),
                            "exp_avg_sq": shard_like(p, st["exp_avg_sq"])}
    state.optimizer = opt
    return state
