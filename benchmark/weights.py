"""The dual student's weights, drawn from the seed on the device.

The init families are those ``dupl_tpu_torch/models/convert.py:
init_weights`` documents (flax's defaults): lecun-normal kernels (a normal
truncated at two standard deviations, scaled to variance 1 / fan_in),
zero biases, unit LayerNorm scales, truncated-normal(0.02) class token and
position table.  Every truncated-normal leaf comes out of ONE uniform draw
of a generator on the device, turned into the truncated normal in place
(inverse CDF) and scaled leaf by leaf, so set-up is a few device calls.
The names and shapes follow the configuration's file alone (timm's DeiT
names, the reference's ``siamese_network`` keys), so the program and the
plain reference take the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_TRUNC = 0.87962566103423978     # std of a standard normal cut at +-2
_ERF_SQRT2 = math.erf(math.sqrt(2.0))


def param_specs(config: dict) -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, family, std) of every leaf of the dual student:
    family "trunc" (std given), "one" or "zero"."""
    d, depth = config["embed_dim"], config["depth"]
    hid, p, grid = config["mlp_dim"], config["patch_size"], \
        config["pretrained_grid"]
    dec, ncls = config["decoder_dim"], config["num_classes"]
    out = []

    def lecun(name, shape, fan_in):
        out.append((name, shape, "trunc", math.sqrt(1.0 / fan_in) / _TRUNC))

    for br in ("branch1", "branch2"):
        e = f"{br}.encoder"
        out.append((f"{e}.cls_token", (1, 1, d), "trunc", 0.02))
        out.append((f"{e}.pos_embed", (1, grid * grid + 1, d), "trunc", 0.02))
        lecun(f"{e}.patch_embed.proj.weight", (d, 3, p, p), 3 * p * p)
        out.append((f"{e}.patch_embed.proj.bias", (d,), "zero", 0.0))
        for i in range(depth):
            b = f"{e}.blocks.{i}"
            for ln in ("norm1", "norm2"):
                out.append((f"{b}.{ln}.weight", (d,), "one", 0.0))
                out.append((f"{b}.{ln}.bias", (d,), "zero", 0.0))
            for name, n_out, n_in in (("attn.qkv", 3 * d, d),
                                      ("attn.proj", d, d),
                                      ("mlp.fc1", hid, d),
                                      ("mlp.fc2", d, hid)):
                lecun(f"{b}.{name}.weight", (n_out, n_in), n_in)
                out.append((f"{b}.{name}.bias", (n_out,), "zero", 0.0))
        out.append((f"{e}.norm.weight", (d,), "one", 0.0))
        out.append((f"{e}.norm.bias", (d,), "zero", 0.0))
        lecun(f"{br}.decoder.conv6.weight", (dec, d, 3, 3), d * 9)
        lecun(f"{br}.decoder.conv7.weight", (dec, dec, 3, 3), dec * 9)
        lecun(f"{br}.decoder.conv8.weight", (ncls, dec, 1, 1), dec)
        lecun(f"{br}.classifier.weight", (ncls - 1, d, 1, 1), d)
        lecun(f"{br}.aux_classifier.weight", (ncls - 1, d, 1, 1), d)
    return out


@torch.no_grad()
def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed`` as float32 tensors on ``device`` (the type
    the program holds its parameters in).  The same seed gives the same
    tensors; the truncated-normal leaves are views of one buffer."""
    specs = param_specs(config)
    n = sum(math.prod(s) for _, s, fam, _ in specs if fam == "trunc")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    flat = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    # uniform [0, 1) -> standard normal cut at +-2, in place
    flat.mul_(2.0).sub_(1.0).mul_(_ERF_SQRT2).erfinv_().mul_(math.sqrt(2.0))
    out, at = {}, 0
    for name, shape, fam, std in specs:
        if fam == "trunc":
            k = math.prod(shape)
            out[name] = flat[at:at + k].view(shape).mul_(std)
            at += k
        else:
            fill = 1.0 if fam == "one" else 0.0
            out[name] = torch.full(shape, fill, dtype=torch.float32,
                                   device=device)
    return out
