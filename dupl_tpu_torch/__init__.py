"""dupl_tpu_torch — the PyTorch/CUDA port of DuPL-TPU's segmentation serving
path for NVIDIA Hopper.

The JAX package ``dupl_tpu`` is the reference; this package mirrors its
layout (``ops/``, ``models/``, ``engine/``, ``utils/``) so each module has an
obvious counterpart.  Public functions keep the reference's NHWC layout.
Every Pallas TPU kernel on the ported path is a hand-written CUDA kernel
under ``csrc/`` (built by :mod:`dupl_tpu_torch.kernels.build`) with a plain
PyTorch twin beside it: CPU tensors take the twin, CUDA tensors the kernel.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
