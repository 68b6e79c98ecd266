"""repro_torch.analysis — cost models for the executor's step kernels."""
