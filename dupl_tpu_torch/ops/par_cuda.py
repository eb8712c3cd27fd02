"""PAR affinity and propagation kernels (counterpart of
``dupl_tpu/ops/par_pallas.py``).

* ``affinity``: the 48-tap RGB affinity of (B, H, W, 3) images as
  (B, K, H, W) float32, the channels-first layout propagation reads, by the
  registered op ``dupl::par_affinity``.  CUDA tensors launch kernel K3
  (``csrc/par_affinity.cu``); CPU tensors run the plain twin
  :func:`affinity_ref`, which follows ``affinity_pallas``.
* ``propagate``: ``num_iter`` rounds of ``m <- sum_k shift_k(m) * aff_k``
  with edge replication, masks (B, H, W, C), affinity (B, K, H, W), by the
  registered op ``dupl::par_propagate``.  CUDA tensors launch kernel K4
  (``csrc/par_propagate.cu``) once per round; CPU tensors run the rounds of
  :func:`propagate_ref`, which follows ``propagate_pallas``:
  fp32, or with ``compute_dtype="bfloat16"`` (``"float16"``) taps and
  affinities in bf16 (f16), products summed in that type within groups of
  8 taps, group sums in fp32.

K3 and K4 stage a tile's haloed input in shared memory and hold a pixel's
taps in registers, for 1 to 6 dilations of at most 40 (every recipe's set
is (1, 2, 4, 8, 12, 24)); any other set of positive integer dilations
takes each kernel's second instantiation, which reads the taps from global
memory at clamped coordinates and loops over any number of 8-tap groups.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from dupl_tpu_torch.ops.attention import _raw_stream, _require_cuda
from dupl_tpu_torch.ops import library
from dupl_tpu_torch.ops.image import shift_clamped
from dupl_tpu_torch.ops.par import position_affinity, tap_offsets

_MAX_DILATIONS = 6     # taps held in registers: 8 per dilation
_MAX_DILATION = 40     # K3's and K4's haloed tiles fit shared memory up to here
_GROUP = 8             # 16-bit modes: taps summed in the type before fp32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
# K4's mode code (csrc/par_propagate.cu): its affinity's type
_MODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_dilations(dilations: Sequence[int]) -> None:
    if not dilations or not all(isinstance(d, int) and d >= 1
                                for d in dilations):
        raise ValueError(f"PAR kernels take one or more positive integer "
                         f"dilations, got {dilations}")


def within_cap(dilations: Sequence[int]) -> bool:
    """Whether K3's and K4's shared-memory instantiations take the set (1
    to 6 dilations, each at most 40); others take the global-memory ones."""
    return len(dilations) <= _MAX_DILATIONS and max(dilations) <= _MAX_DILATION


def _compute_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"PAR compute_dtype must be one of {sorted(_DTYPES)}, "
                         f"got {name!r}")
    return _DTYPES[name]


def affinity_ref(imgs: torch.Tensor, dilations: Sequence[int] = (1, 2, 4, 8, 12, 24),
                 w1: float = 0.3, w2: float = 0.01) -> torch.Tensor:
    """Plain twin of K3, ``affinity_pallas``'s formula: per-channel
    unbiased std over the taps (sum x, sum x^2), logits
    ``-mean_c((|t - x| * (1/w1) / (std + 1e-8))^2)``, max-subtracted
    softmax over the taps, plus the position constants.  (B, H, W, 3) ->
    (B, K, H, W) float32."""
    x = imgs.float().permute(0, 3, 1, 2)                       # (B, 3, H, W)
    offs = tap_offsets(dilations)
    k = len(offs)
    s1 = torch.zeros_like(x)
    s2 = torch.zeros_like(x)
    for dy, dx in offs:
        t = shift_clamped(x, dy, dx, axis=2)
        s1 = s1 + t
        s2 = s2 + t * t
    mean = s1 * (1.0 / k)
    var = torch.clamp(s2 - k * mean * mean, min=0.0) * (1.0 / (k - 1))
    inv_w1 = torch.tensor(1.0 / w1, dtype=torch.float32, device=x.device)
    inv = inv_w1 / (torch.sqrt(var) + 1e-8)   # a true division, as the kernel
    logits = []
    for dy, dx in offs:
        z = (shift_clamped(x, dy, dx, axis=2) - x).abs() * inv
        logits.append(-(z * z).mean(dim=1))
    sc = torch.stack(logits, dim=1)                            # (B, K, H, W)
    e = torch.exp(sc - sc.amax(dim=1, keepdim=True))
    pos = torch.tensor(position_affinity(dilations, w1, w2),
                       dtype=torch.float32, device=x.device)
    return e / e.sum(dim=1, keepdim=True) + pos[None, :, None, None]


def propagate_ref(masks: torch.Tensor, aff: torch.Tensor,
                  dilations: Sequence[int] = (1, 2, 4, 8, 12, 24),
                  num_iter: int = 10,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """Plain twin of K4.  masks (B, H, W, C), aff (B, K, H, W) ->
    (B, H, W, C) float32.  fp32: taps accumulated one by one in tap order.
    bf16 (f16): each round rounds the mask and the affinity to bf16 (f16),
    rounds every product and partial sum within a group of 8 taps to it,
    and adds the group sums in fp32, as ``propagate_pallas``'s
    ``_kernel``."""
    m = masks.float().permute(0, 3, 1, 2)                      # (B, C, H, W)
    out = _propagate_bchw(m, aff.to(_compute_dtype(compute_dtype)), dilations,
                          num_iter)
    return out.permute(0, 2, 3, 1)


def _propagate_bchw(m: torch.Tensor, a: torch.Tensor,
                    dilations: Sequence[int], num_iter: int) -> torch.Tensor:
    """:func:`propagate_ref`'s rounds on masks (B, C, H, W) float32 and the
    affinity (B, K, H, W) in the compute type (float32, bfloat16 or
    float16)."""
    cdt = a.dtype
    offs = tap_offsets(dilations)
    for _ in range(num_iter):
        cur = m.to(cdt)
        if cdt == torch.float32:
            out = torch.zeros_like(m)
            for i, (dy, dx) in enumerate(offs):
                out = out + shift_clamped(cur, dy, dx, axis=2) * a[:, i:i + 1]
        else:
            out = None
            for g0 in range(0, len(offs), _GROUP):
                acc = None
                for i in range(g0, g0 + _GROUP):       # K = 8 per dilation
                    term = shift_clamped(cur, *offs[i], axis=2) * a[:, i:i + 1]
                    acc = term if acc is None else acc + term
                out = acc.float() if out is None else out + acc.float()
        m = out
    return m


@functools.lru_cache(maxsize=None)
def _entries():
    """The C entry points of ``csrc/par_affinity.cu`` and
    ``csrc/par_propagate.cu``, built on first use."""
    from dupl_tpu_torch.kernels import build

    aff_types = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p])
    prop_types = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    out = {}
    for lib, name, types in (("par_affinity", "affinity", aff_types),
                             ("par_propagate", "propagate", prop_types)):
        for entry in (name, f"{name}_any"):   # past the cap: any dilations
            fn = getattr(build.load(lib), f"dupl_par_{entry}")
            fn.restype, fn.argtypes = ctypes.c_int, types
            out[entry] = fn
    return out


@functools.lru_cache(maxsize=None)
def _device_args(dilations: Tuple[int, ...], device: torch.device,
                 w1=None, w2=None):
    """The past-the-cap kernels' arguments for a dilation set: the
    dilations (int32) and, given ``w1`` and ``w2``, K3's position
    constants (fp32) as device arrays, made once a set and device."""
    dil = torch.tensor(dilations, dtype=torch.int32, device=device)
    if w1 is None:
        return dil, None
    return dil, torch.tensor(position_affinity(dilations, w1, w2),
                             dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _affinity_args(dilations: Tuple[int, ...], w1: float, w2: float):
    """K3's host arguments for a dilation set: the dilations and the
    position constants as C arrays (made once, not every call)."""
    k = 8 * len(dilations)
    return ((ctypes.c_int * len(dilations))(*dilations),
            (ctypes.c_float * k)(*position_affinity(dilations, w1, w2)))


def _check_cuda(x: torch.Tensor, name: str, dtypes, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what}: {name} must be on a CUDA device, got "
                         f"{x.device}")
    if x.dtype not in dtypes:
        raise TypeError(f"{what}: {name} must be {' or '.join(map(str, dtypes))}"
                        f", got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def _affinity_kernel(imgs: torch.Tensor, dilations: Sequence[int],
                     w1: float, w2: float) -> torch.Tensor:
    """``dupl::par_affinity`` on CUDA tensors: launch kernel K3 on the
    current stream: (B, H, W, 3) float32 contiguous -> (B, K, H, W)
    float32."""
    from dupl_tpu_torch.kernels import build

    _check_cuda(imgs, "imgs", (torch.float32,), "par affinity")
    _check_dilations(dilations)
    if imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"par affinity: want imgs (B, H, W, 3), got "
                         f"{tuple(imgs.shape)}")
    b, h, w, _ = imgs.shape
    out = torch.empty((b, 8 * len(dilations), h, w), dtype=torch.float32,
                      device=imgs.device)
    dilations = tuple(dilations)
    with torch.cuda.device(imgs.device):
        if within_cap(dilations):
            dil, pos = _affinity_args(dilations, float(w1), float(w2))
            entry = _entries()["affinity"]
        else:
            dil, pos = (t.data_ptr() for t in _device_args(
                dilations, imgs.device, float(w1), float(w2)))
            entry = _entries()["affinity_any"]
        status = entry(imgs.data_ptr(), out.data_ptr(), b, h, w,
                       len(dilations), dil, pos, 1.0 / w1,
                       _raw_stream(imgs.device))
    build.check(status, "par_affinity")
    affinity_cuda.launches += 1
    return out


def _propagate_kernel(masks: torch.Tensor, aff: torch.Tensor,
                      dilations: Sequence[int], num_iter: int) -> torch.Tensor:
    """``dupl::par_propagate`` on CUDA tensors: launch kernel K4 once per
    round on the current stream.  masks (B, C, H, W) float32, aff
    (B, K, H, W) float32 (fp32 mode), bfloat16 (bf16 mode) or float16 (f16
    mode), both contiguous -> (B, C, H, W) float32."""
    from dupl_tpu_torch.kernels import build

    _check_cuda(masks, "masks", (torch.float32,), "par propagate")
    _check_cuda(aff, "aff", tuple(_DTYPES.values()), "par propagate")
    _check_dilations(dilations)
    if masks.device != aff.device:
        raise ValueError(f"par propagate: masks on {masks.device}, aff on "
                         f"{aff.device}")
    b, c, h, w = masks.shape
    k = 8 * len(dilations)
    if aff.shape != (b, k, h, w):
        raise ValueError(f"par propagate: want aff (B, {k}, H, W) = "
                         f"{(b, k, h, w)}, got {tuple(aff.shape)}")
    if num_iter < 0:
        raise ValueError(f"par propagate: num_iter must be >= 0, got {num_iter}")
    if num_iter == 0:
        return masks.clone()
    if within_cap(dilations):
        dil = (ctypes.c_int * len(dilations))(*dilations)
        entry = _entries()["propagate"]
    else:
        dil = _device_args(tuple(dilations), masks.device)[0].data_ptr()
        entry = _entries()["propagate_any"]
    bufs = [torch.empty_like(masks) for _ in range(min(num_iter, 2))]
    src = masks
    with torch.cuda.device(masks.device):
        stream = torch.cuda.current_stream().cuda_stream
        for i in range(num_iter):       # ping-pong: round i reads round i-1
            dst = bufs[i % 2]
            status = entry(src.data_ptr(), aff.data_ptr(), dst.data_ptr(),
                           b, c, h, w, len(dilations), dil,
                           _MODE[aff.dtype], stream)
            build.check(status, "par_propagate")
            propagate_cuda.launches += 1
            propagate_cuda.launches_f16 += aff.dtype == torch.float16
            src = dst
    return src


def _propagate_twin(masks, aff, dilations, num_iter):
    out = _propagate_bchw(masks, aff, dilations, num_iter)
    return out.clone() if out is masks else out.contiguous()


def _affinity_fake(imgs, dilations, w1, w2):
    b, h, w, _ = imgs.shape
    return imgs.new_empty((b, 8 * len(dilations), h, w), dtype=torch.float32)


# K3 and K4 as the ops dupl::par_affinity and dupl::par_propagate
# (``ops/library.py``): the launchers above on CUDA tensors, the plain twins
# on CPU tensors.  K4's compute type is its affinity operand's.  Their flop
# formulas are 0: the twins run no matmul, einsum or convolution, so
# ``FlopCounterMode`` counts nothing for them.
_K3 = library.register(
    "par_affinity(Tensor imgs, int[] dilations, float w1, float w2) -> Tensor",
    cuda=_affinity_kernel, cpu=affinity_ref, fake=_affinity_fake,
    flops=lambda imgs, dilations, w1, w2: 0)
_K4 = library.register(
    "par_propagate(Tensor masks, Tensor aff, int[] dilations, int num_iter) "
    "-> Tensor",
    cuda=_propagate_kernel, cpu=_propagate_twin,
    fake=lambda masks, aff, dilations, num_iter: torch.empty_like(
        masks, memory_format=torch.contiguous_format),
    flops=lambda masks, aff, dilations, num_iter: 0)


def affinity_cuda(imgs: torch.Tensor, dilations: Sequence[int] = (1, 2, 4, 8, 12, 24),
                  w1: float = 0.3, w2: float = 0.01) -> torch.Tensor:
    """Kernel K3 on CUDA tensors, through ``dupl::par_affinity``; raises
    for any other device.  ``affinity_cuda.launches`` counts K3's launches
    by any route that reaches the op (a sealed program included)."""
    _require_cuda("par affinity", imgs)
    return _K3(imgs, list(dilations), float(w1), float(w2))


affinity_cuda.launches = 0


def propagate_cuda(masks: torch.Tensor, aff: torch.Tensor,
                   dilations: Sequence[int] = (1, 2, 4, 8, 12, 24),
                   num_iter: int = 10) -> torch.Tensor:
    """Kernel K4 on CUDA tensors, through ``dupl::par_propagate``; raises
    for any other device.  Counts one launch a round in
    ``propagate_cuda.launches``, the f16 mode's also in
    ``propagate_cuda.launches_f16``."""
    _require_cuda("par propagate", masks)
    return _K4(masks, aff, list(dilations), num_iter)


propagate_cuda.launches = propagate_cuda.launches_f16 = 0


def affinity(imgs: torch.Tensor, dilations: Sequence[int] = (1, 2, 4, 8, 12, 24),
             w1: float = 0.3, w2: float = 0.01) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> (B, K, H, W) float32 affinity."""
    if imgs.device.type == "cpu":
        return _K3(imgs, list(dilations), float(w1), float(w2))
    if imgs.device.type != "cuda":
        raise ValueError(f"par affinity: unsupported device {imgs.device}")
    return affinity_cuda(imgs.float().contiguous(), dilations, w1, w2)


def propagate(masks: torch.Tensor, aff: torch.Tensor,
              dilations: Sequence[int] = (1, 2, 4, 8, 12, 24),
              num_iter: int = 10,
              compute_dtype: str = "float32") -> torch.Tensor:
    """masks (B, H, W, C), aff (B, K, H, W) -> (B, H, W, C) float32."""
    if masks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"par propagate: unsupported device {masks.device}")
    m = masks.float().permute(0, 3, 1, 2).contiguous()
    a = aff.to(_compute_dtype(compute_dtype)).contiguous()
    run = _K4 if masks.device.type == "cpu" else propagate_cuda
    return run(m, a, list(dilations), num_iter).permute(0, 2, 3, 1)
