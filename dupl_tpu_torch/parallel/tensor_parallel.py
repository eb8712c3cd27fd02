"""Megatron tensor parallelism of the dual student (counterpart of the
``model`` axis of ``dupl_tpu/parallel/mesh.py``, its ``_param_spec``).

The JAX package declares a partition spec for each weight and lets XLA place
the collectives.  Here the weights are sliced in place into plain local
tensors, each rank of a model group keeping its share, and the layers run
the two collectives of Megatron's layers themselves, as autograd functions
(:func:`parallel_linear`, :func:`parallel_conv`):

* a column-parallel layer: the identity on its replicated input forward, an
  all-reduce over the model group of the input's gradient backward (the
  sum of the ranks' partial gradients);
* a row-parallel layer: an all-reduce of the ranks' partial products
  forward, the identity on the output's gradient backward.

Each collective is fused with its layer's product so that it sums fp32
partials, which are rounded to the compute dtype once, after the sum: the
one-device layer rounds its product and its input gradient once, and a
rounding on each rank before the sum would add one.

The layers (:data:`SPECS`):

* ``attn.qkv``: column-parallel by head.  Rank r keeps the rows of q, of k
  and of v for heads ``[r H / n, (r + 1) H / n)`` and the same entries of
  the bias, so its q, k and v are strided views of its local product, as
  the one-device model's are of its own, and K1 and K2 run on the rank's
  H / n heads;
* ``mlp.fc1``: column-parallel (rows of ``weight``, entries of ``bias``);
* ``attn.proj`` and ``mlp.fc2``: row-parallel (columns of ``weight``); the
  bias is replicated and added once, after the all-reduce;
* ``decoder.conv6``: the output channels; ``decoder.conv7``: the input
  channels, all-reduced before its ReLU;
* everything else (the patch embedding, ``pos_embed``, ``cls_token``, the
  norms, ``conv8``, the classifiers) is replicated.

With int8 inference (``ModelConfig.quantized_inference``) the products are
w8a8 (``ops/quant.py``) and computed as the one-device product is, bit for
bit, as the JAX package's GSPMD partitions ``QDense(quant=True)``: a
column-parallel layer quantizes its replicated input and its rows of the
weight over the whole K, so its share of the output is the one-device
product's; a row-parallel layer (:func:`quantized_row_parallel`) takes the
maxima of its shares of K, all-reduces them (MAX) in one collective,
quantizes its shares by them, multiplies them into int32 sums,
all-reduces those (SUM, exact) and only then rescales and adds the bias.

Activations are replicated at block boundaries, so every rank of a model group runs the
CAM fusion, PAR, the GMM and the losses on the same values, as the JAX
package's replicated activations do.  The layout differs from the JAX
spec's contiguous column split of ``qkv`` (not aligned to heads); the
gathered tensors, and so the checkpoints, are the same.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from dupl_tpu_torch.ops import quant
from dupl_tpu_torch.parallel.data_parallel import _buckets

# (name suffix, split dim, blocks): a leaf whose name ends with the suffix is
# split over the model ranks along the dim, each of its ``blocks`` equal
# blocks along it split alike (qkv: q, k and v, so that a rank's share is
# whole heads of each).  The one table of the layout: a layer whose weight
# is split along dim 0 (its outputs) is column-parallel, along dim 1 (its
# inputs) row-parallel (:func:`role_of`).
SPECS = (
    ("attn.qkv.weight", 0, 3), ("attn.qkv.bias", 0, 3),
    ("mlp.fc1.weight", 0, 1), ("mlp.fc1.bias", 0, 1),
    ("attn.proj.weight", 1, 1), ("mlp.fc2.weight", 1, 1),
    ("decoder.conv6.weight", 0, 1), ("decoder.conv7.weight", 1, 1),
)
ROLES = ("column", "row")            # by split dim
# the other modules that read the model group: attention, its head count
_MODULES = (".attn",)


def spec_of(name: str) -> Optional[Tuple[int, int]]:
    """(dim, blocks) of a tensor-parallel leaf, None for a replicated one."""
    for suffix, dim, blocks in SPECS:
        if name.endswith(suffix):
            return dim, blocks
    return None


def role_of(layer: str) -> Optional[str]:
    """"column" or "row" for a tensor-parallel layer (by module name), None
    for a replicated one."""
    spec = spec_of(layer + ".weight")
    return None if spec is None else ROLES[spec[0]]


def local_shard(full: torch.Tensor, dim: int, blocks: int, n: int,
                r: int) -> torch.Tensor:
    """Model rank ``r``'s share of ``full`` (of ``n``), contiguous."""
    size = full.shape[dim]
    x = full.unflatten(dim, (blocks, n, size // (blocks * n)))
    return x.select(dim + 1, r).flatten(dim, dim + 1).contiguous()


def join_shards(shards, dim: int, blocks: int) -> torch.Tensor:
    """The full tensor from the ``n`` ranks' shards, in model-rank order
    (the inverse of :func:`local_shard`)."""
    parts = [s.unflatten(dim, (blocks, s.shape[dim] // blocks))
             for s in shards]
    return torch.stack(parts, dim + 1).flatten(dim, dim + 2)


# ------------------------------------------------------------- collectives
def _mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-d tensors of one dtype, accumulated and returned
    in fp32 (a 16-bit product is not rounded to its dtype)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _conv_input_fp32(shape, w, g, conv):
    """The input gradient of a convolution, from the fp32 values of its
    (rounded) weight and cotangent, accumulated in fp32."""
    return torch.nn.grad.conv2d_input(shape, w.float(), g.float(), **conv)


class _ColumnParallel(torch.autograd.Function):
    """A column-parallel layer on this rank's output features, with
    Megatron's backward collective: ``x`` (replicated, any dtype) is cast
    to ``w``'s compute dtype and multiplied (``conv`` None) or convolved
    (``conv``: its padding and dilation) by this rank's rows ``w``.  The
    forward is the one-device layer's on these rows.  Backward, the ranks'
    partial gradients of ``x`` are summed over the model group in fp32 and
    rounded to the compute dtype once, as the one-device layer's whole
    input gradient is rounded once (a per-rank rounding before the sum would
    add a rounding it does not have); the weight's gradient is the
    one-device layer's on these rows."""

    @staticmethod
    def forward(ctx, x, w, group, conv):
        xc = x.to(w.dtype)
        ctx.save_for_backward(xc, w)
        ctx.group, ctx.conv, ctx.x_dtype = group, conv, x.dtype
        return F.linear(xc, w) if conv is None else F.conv2d(xc, w, **conv)

    @staticmethod
    def backward(ctx, g):
        xc, w = ctx.saved_tensors
        conv, gx, gw = ctx.conv, None, None
        if ctx.needs_input_grad[0]:
            gx = (_mm_fp32(g.reshape(-1, g.shape[-1]), w).reshape(xc.shape)
                  if conv is None else _conv_input_fp32(xc.shape, w, g, conv))
            dist.all_reduce(gx, group=ctx.group)
            gx = gx.to(w.dtype).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            gw = (g.reshape(-1, g.shape[-1]).t() @ xc.reshape(-1, xc.shape[-1])
                  if conv is None else torch.nn.grad.conv2d_weight(
                      xc, w.shape, g, **conv))
        return gx, gw, None, None


class _RowParallel(torch.autograd.Function):
    """A row-parallel layer on this rank's input features ``x`` (in the
    compute dtype) and its columns ``w``, without a bias: the partial
    product (``conv`` None) or convolution is accumulated in fp32, summed
    over the model group in fp32 and rounded to the compute dtype once, as
    the one-device layer's output is rounded once.  Backward, the
    one-device layer's gradients on these features (their reductions run
    over the whole output, which every rank holds)."""

    @staticmethod
    def forward(ctx, x, w, group, conv):
        ctx.save_for_backward(x, w)
        ctx.conv = conv
        if conv is None:
            y = _mm_fp32(x.reshape(-1, x.shape[-1]), w.t()).reshape(
                *x.shape[:-1], w.shape[0])
        else:
            y = F.conv2d(x.float(), w.float(), **conv)
        dist.all_reduce(y, group=group)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        conv, gx, gw = ctx.conv, None, None
        if conv is None:
            g2 = g.reshape(-1, g.shape[-1])
            if ctx.needs_input_grad[0]:
                gx = (g2 @ w).reshape(x.shape)
            if ctx.needs_input_grad[1]:
                gw = g2.t() @ x.reshape(-1, x.shape[-1])
        else:
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, g, **conv)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, g, **conv)
        return gx, gw, None, None


def parallel_linear(x: torch.Tensor, w: torch.Tensor, d,
                    role: str) -> torch.Tensor:
    """A linear layer's product without its bias on this rank's share:
    ``role`` "column" (``x`` replicated, any dtype; this rank's output
    features) or "row" (``x`` this rank's input features; the output summed
    over the model group).  ``w``: this rank's weight in the compute
    dtype."""
    if role == "column":
        return _ColumnParallel.apply(x, w, d.model_group, None)
    return _RowParallel.apply(x.to(w.dtype), w, d.model_group, None)


def parallel_conv(x: torch.Tensor, w: torch.Tensor, conv: torch.nn.Conv2d,
                  d, role: str) -> torch.Tensor:
    """``conv``'s convolution (its padding and dilation, no bias) on this
    rank's share, NCHW, as :func:`parallel_linear` for ``role``."""
    kw = {"padding": conv.padding, "dilation": conv.dilation}
    if role == "column":
        return _ColumnParallel.apply(x, w, d.model_group, kw)
    return _RowParallel.apply(x.to(w.dtype), w, d.model_group, kw)


@torch.no_grad()
def quantized_row_parallel(x: torch.Tensor, w: torch.Tensor,
                           bias: Optional[torch.Tensor], d,
                           gelu: Optional[str] = None) -> torch.Tensor:
    """The int8 product of a row-parallel layer (inference only): ``x``
    (..., K / n) this rank's input features (fc2: fc1's fp32 output, whose
    ``gelu`` is taken inside the quantization), ``w`` (N, K / n) its
    columns, ``bias`` (N,) replicated -> (..., N) float32 on every rank of
    the model group, the bits of ``quant.quantized_matmul`` on the whole K.
    The activation's row maxima and the weight's are all-reduced together
    (MAX), each rank quantizes its shares by them, and the int32 partial
    sums are all-reduced (SUM) before the rescale and the bias: a rescale or
    a bias before the sum would round each rank's share on its own."""
    x2, wq, b = quant.product_operands(x, w, bias, gelu)
    amax_x, amax_w = quant.row_absmax_pair(x2, wq, gelu)
    amax = torch.cat([amax_x, amax_w])
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=d.model_group)
    m = x2.shape[0]
    qa, sa, qw, sw = quant.quantize_pair_given(x2, wq, amax[:m], amax[m:],
                                               gelu)
    acc = quant.int8_matmul_i32(qa, qw)
    dist.all_reduce(acc, group=d.model_group)
    y = quant.int8_rescale(acc, sa, sw, b)
    return y.reshape(*x.shape[:-1], w.shape[0])


# ------------------------------------------------------------------ layout
def check_divides(model: torch.nn.Module, n: int) -> None:
    """Raise ``ValueError`` naming the dimension unless ``n`` model ranks
    divide both students' heads, MLP hidden width and decoder width."""
    student = model.branch1
    enc = student.encoder
    dims = (("attention heads", enc.spec.num_heads),
            ("MLP hidden width", enc.blocks[0].mlp.fc1.out_features),
            ("decoder width (decoder_dim)", student.decoder.conv6.out_channels))
    for what, size in dims:
        if size % n:
            raise ValueError(
                f"tensor parallelism over {n} ranks: the {size} {what} of "
                f"the model ({model.cfg.backbone}) do not divide by {n}")


def shard_model(model: torch.nn.Module, d) -> torch.nn.Module:
    """Slice a ``DualStudent``'s tensor-parallel leaves to this rank's
    share in place (no communication: every rank holds the full weights
    first), give each tensor-parallel layer ``d`` and its role (``tp``,
    ``tp_role``: :func:`role_of`) and each attention ``d`` (its head
    count); ``model.tp`` is ``d`` too.  The parameters stay the same objects,
    so an optimizer over them keeps them.  The identity at ``n_model`` 1."""
    n = d.n_model
    if n == 1:
        return model
    check_divides(model, n)
    with torch.no_grad():
        for name, p in model.named_parameters():
            spec = spec_of(name)
            if spec is not None:
                p.data = local_shard(p.data, *spec, n, d.model_rank)
                p.grad = None
    for name, m in model.named_modules():
        role = role_of(name)
        if role is not None:
            m.tp, m.tp_role = d, role
        elif name.endswith(_MODULES):
            m.tp = d
    model.tp = d
    return model


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes as integers that every backend sums (int32 for 4-byte
    dtypes, int64 for 8-byte ones, uint8 else)."""
    kind = {4: torch.int32, 8: torch.int64}.get(x.element_size(), torch.uint8)
    return x.contiguous().reshape(-1).view(kind)


@torch.no_grad()
def gather(t: torch.Tensor, dim: int, blocks: int, d) -> torch.Tensor:
    """The full tensor of which every rank of ``d``'s model group holds its
    share ``t`` (a collective), bit for bit: each rank writes its share's
    bits into a zero buffer of all shares and the buffers are summed as
    integers over the group (which gloo also does on CUDA tensors)."""
    bits = _bits(t)
    buf = torch.zeros((d.n_model, bits.numel()), dtype=bits.dtype,
                      device=t.device)
    buf[d.model_rank] = bits
    dist.all_reduce(buf, group=d.model_group)
    shards = [row.view(t.dtype).reshape(t.shape) for row in buf]
    return join_shards(shards, dim, blocks)


def gather_model_state(tensors: Dict[str, torch.Tensor],
                       d) -> Dict[str, torch.Tensor]:
    """``tensors`` keyed by parameter name (a state dict, gradients,
    moments; unsharded by FSDP) in the one-device layout: every
    tensor-parallel leaf gathered over the model group (a collective:
    every rank calls it with the same names), the rest as given.  The
    identity without tensor parallelism."""
    if d is None or d.n_model == 1:
        return dict(tensors)
    out = {}
    for name, t in tensors.items():
        spec = spec_of(name)
        out[name] = t if spec is None else gather(t, *spec, d)
    return out


def shard_like_model(name: str, full: torch.Tensor, d) -> torch.Tensor:
    """This rank's share of the one-device tensor ``full`` of parameter
    ``name`` (no communication); ``full`` itself for a replicated leaf or
    without tensor parallelism."""
    spec = spec_of(name)
    if d is None or d.n_model == 1 or spec is None:
        return full
    return local_shard(full, *spec, d.n_model, d.model_rank)


@torch.no_grad()
def sync_replicated_gradients(model: torch.nn.Module, d) -> None:
    """Model rank 0's gradient of every replicated leaf on every rank of
    its model group (a broadcast, in flat buckets).  The ranks compute these
    gradients from the same values, but a backward kernel that accumulates
    with atomics (the card's bilinear resize) need not give the same bits
    twice, and replicas that drift apart would feed the CAMs, PAR and the
    GMM different values.  Nothing without tensor parallelism."""
    if d.n_model == 1:
        return
    grads = [p.grad.to_local() if hasattr(p.grad, "to_local") else p.grad
             for name, p in model.named_parameters()
             if p.grad is not None and spec_of(name) is None]
    src = d.data_rank * d.n_model
    for bucket in _buckets(grads):
        flat = _flatten_dense_tensors(bucket)
        dist.broadcast(flat, src=src, group=d.model_group)
        for g, r in zip(bucket, _unflatten_dense_tensors(flat, bucket)):
            g.copy_(r)
