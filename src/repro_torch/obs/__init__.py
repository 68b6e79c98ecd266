"""repro_torch.obs — cardinality accounting used by ``explain``."""
