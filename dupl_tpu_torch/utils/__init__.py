"""dupl_tpu_torch.utils."""
