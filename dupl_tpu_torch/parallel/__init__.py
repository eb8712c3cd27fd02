"""dupl_tpu_torch.parallel: data-parallel and fully-sharded training across
processes (counterpart of ``dupl_tpu/parallel``)."""
