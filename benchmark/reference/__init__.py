"""Plain PyTorch references of the benchmark's configurations.  They import
neither JAX, nor the JAX package, nor anything of ``dupl_tpu_torch``."""
