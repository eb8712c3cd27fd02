"""dupl_tpu_torch.engine."""
