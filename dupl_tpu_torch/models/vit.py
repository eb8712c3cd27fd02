"""ViT/DeiT backbone (counterpart of ``dupl_tpu/models/vit.py``).

``ViT.forward`` returns ``(cls_token, patch_tokens, aux_tokens)``: patch
tokens after the final LayerNorm, aux tokens tapped from block
``aux_layer % depth`` (the normed output when that is the last block).
Positional embeddings are bicubic-resized from the pretraining grid to the
input's patch grid on every call.

Dtypes follow the reference: matmuls run in ``compute_dtype`` (inputs and
weights cast, bias added in the output dtype), parameters stay float32, and
the residual stream runs in ``stream_dtype``; LayerNorm statistics are fp32.
``quant=True`` (``ModelConfig.quantized_inference``, inference only) makes
the four products of every block w8a8 (``ops/quant.py``: kernels Q1 and Q2
on the card), fp32 out with the bias added in fp32, as the reference's
``QDense``; fc2's quantization then takes the GELU of fc1's fp32 output
itself (one kernel on the card).  The exact GELU
rounds as the jitted reference does (``ops/gelu.py``: kernel G on the card).
``ViT.forward(x, stream_dtype=...)`` runs the same parameters with another
stream dtype (the trainer's no-grad CAM passes run a bf16 stream beside the
fp32 stream of the differentiated pass).  ``remat=True`` recomputes each
block in the backward pass (``torch.utils.checkpoint``).
Module and parameter names follow timm's DeiT (``blocks.i.attn.qkv`` ...),
which is what the reference's ``siamese_network.state_dict()`` holds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dupl_tpu_torch.ops.attention import dot_attention
from dupl_tpu_torch.ops.gelu import gelu_erf, gelu_tanh
from dupl_tpu_torch.ops.image import resize_bicubic
from dupl_tpu_torch.ops.quant import quantized_matmul
from dupl_tpu_torch.parallel import tensor_parallel


@dataclasses.dataclass(frozen=True)
class ViTSpec:
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    pretrained_grid: int = 14  # 224 / 16


VIT_CONFIGS = {
    "deit_tiny_patch16": ViTSpec(embed_dim=192, depth=12, num_heads=3),
    "deit_small_patch16": ViTSpec(embed_dim=384, depth=12, num_heads=6),
    "deit_base_patch16": ViTSpec(embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch16": ViTSpec(embed_dim=1024, depth=24, num_heads=16),
    "vit_huge_patch16": ViTSpec(embed_dim=1280, depth=32, num_heads=16),
    "test_tiny_patch16": ViTSpec(embed_dim=32, depth=4, num_heads=2),
}


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype``: input and weight cast,
    the product rounded to that dtype, then the bias added in it.  ``tp``
    and ``tp_role`` (``parallel/tensor_parallel.py``) make it column- or
    row-parallel on this rank's share; a row-parallel product is summed
    over the model group before the bias.  ``quant`` (the reference's
    ``QDense(quant=True)``): the dynamic int8 product
    (``ops/quant.py:quantized_matmul``), fp32 out, the bias added in fp32.
    Under tensor parallelism a column-parallel layer takes that product on
    its rows of the weight (the whole K: its share of the one-device
    output); a row-parallel one all-reduces the maxima of its shares of K
    before it quantizes them and the int32 sums before the rescale and the
    bias (``tensor_parallel.quantized_row_parallel``), so that the model
    group's output is the one-device product's, bit for bit.  With
    ``quant``, ``gelu`` ("tanh" or "erf") takes the GELU of the float32
    input inside the input's quantization (fc2 of an int8 ``Mlp``: one
    kernel on the card, or one a pass)."""

    tp = None
    tp_role = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 quant: bool = False):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype
        self.quant = quant

    def forward(self, x: torch.Tensor,
                gelu: Optional[str] = None) -> torch.Tensor:
        cd = self.compute_dtype
        if self.quant:
            if self.tp_role == "row":
                return tensor_parallel.quantized_row_parallel(
                    x, self.weight, self.bias, self.tp, gelu)
            return quantized_matmul(x, self.weight, self.bias, gelu=gelu)
        if gelu is not None:
            raise ValueError("Linear: gelu is taken only with quant")
        if self.tp is None:
            y = F.linear(x.to(cd), self.weight.to(cd))
        else:
            y = tensor_parallel.parallel_linear(x, self.weight.to(cd),
                                                self.tp, self.tp_role)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class LayerNorm(nn.LayerNorm):
    """eps 1e-6; statistics in fp32, output in the input's dtype: the
    residual stream's (as flax's ``LayerNorm(dtype=stream_dtype)``)."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, compute_dtype: torch.dtype,
                 gelu_approximate: bool, quant: bool = False):
        super().__init__()
        self.fc1 = Linear(dim, hidden, compute_dtype=compute_dtype,
                          quant=quant)
        self.fc2 = Linear(hidden, dim, compute_dtype=compute_dtype,
                          quant=quant)
        self.gelu_approximate = gelu_approximate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if self.fc2.quant:      # the GELU inside fc2's quantization
            return self.fc2(h, gelu="tanh" if self.gelu_approximate else "erf")
        return self.fc2(gelu_tanh(h) if self.gelu_approximate else gelu_erf(h))


class Attention(nn.Module):
    """``tp``: qkv column-parallel by head, proj row-parallel
    (``parallel/tensor_parallel.py``); the rank runs its ``num_heads /
    n_model`` heads, at the full model's head dim and scale."""

    tp = None

    def __init__(self, dim: int, num_heads: int, compute_dtype: torch.dtype,
                 quant: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.qkv = Linear(dim, dim * 3, compute_dtype=compute_dtype,
                          quant=quant)
        self.proj = Linear(dim, dim, compute_dtype=compute_dtype, quant=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        heads = self.num_heads // (1 if self.tp is None else self.tp.n_model)
        qkv = self.qkv(x)
        c = qkv.shape[-1] // 3
        hd = c // heads
        # contiguous column ranges, viewed as (B, N, H, D) without copies
        q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, heads, hd)
                   .to(self.compute_dtype) for i in range(3))
        x = dot_attention(q, k, v, scale=hd ** -0.5)
        return self.proj(x.reshape(b, n, c))


class Block(nn.Module):
    """Pre-LN residual block; the residual stream keeps the dtype of the
    block's input."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float,
                 compute_dtype: torch.dtype, gelu_approximate: bool,
                 quant: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, compute_dtype, quant)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), compute_dtype,
                       gelu_approximate, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x)).to(x.dtype)
        return x + self.mlp(self.norm2(x)).to(x.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, compute_dtype: torch.dtype):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) -> (B, h*w, D) in row-major patch order."""
        cd = self.compute_dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(cd), self.proj.weight.to(cd),
                     stride=self.proj.stride)
        y = y + self.proj.bias.to(cd)[None, :, None, None]
        return y.flatten(2).transpose(1, 2)


class ViT(nn.Module):
    def __init__(self, spec: ViTSpec, aux_layer: int = -3,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 gelu_approximate: bool = False, quant: bool = False,
                 remat: bool = False,
                 stream_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.remat = remat
        self.spec = spec
        self.aux_layer = aux_layer
        self.stream_dtype = stream_dtype
        d = spec.embed_dim
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, spec.pretrained_grid ** 2 + 1, d))
        self.patch_embed = PatchEmbed(spec.patch_size, d, compute_dtype)
        self.blocks = nn.ModuleList([
            Block(d, spec.num_heads, spec.mlp_ratio, compute_dtype,
                  gelu_approximate, quant)
            for _ in range(spec.depth)])
        self.norm = LayerNorm(d)

    def interpolated_pos_embed(self, h: int, w: int) -> torch.Tensor:
        """Bicubic-resize the patch position table to an (h, w) grid and
        re-attach the cls position."""
        g, d = self.spec.pretrained_grid, self.spec.embed_dim
        cls_pos = self.pos_embed[:, :1]
        patch_pos = self.pos_embed[:, 1:].reshape(1, g, g, d)
        if (h, w) != (g, g):
            patch_pos = resize_bicubic(patch_pos, (h, w))
        return torch.cat([cls_pos, patch_pos.reshape(1, h * w, d)], dim=1)

    def forward(self, x: torch.Tensor,
                stream_dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, H, W, 3) -> (cls (B, D), patch tokens (B, hw, D), aux tokens
        (B, hw, D)).  ``stream_dtype`` overrides the model's residual-stream
        dtype for this call; the parameters are the same."""
        b, hh, ww, _ = x.shape
        p = self.spec.patch_size
        h, w = hh // p, ww // p
        tokens = self.patch_embed(x).float()
        cls = self.cls_token.expand(b, 1, self.spec.embed_dim)
        x = torch.cat([cls, tokens], dim=1)
        x = (x + self.interpolated_pos_embed(h, w)).to(
            stream_dtype or self.stream_dtype)

        aux_idx = self.aux_layer % self.spec.depth
        aux = None
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
            if i == aux_idx:
                aux = x
        x = self.norm(x)
        if aux_idx == self.spec.depth - 1:
            aux = x
        return x[:, 0], x[:, 1:], aux[:, 1:]
