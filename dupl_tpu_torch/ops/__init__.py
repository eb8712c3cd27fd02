"""dupl_tpu_torch.ops."""
