"""dupl_tpu_torch.kernels."""
