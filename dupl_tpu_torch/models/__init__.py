"""dupl_tpu_torch.models."""
