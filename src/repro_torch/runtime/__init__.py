"""Training runtime of the port: `repro_torch.runtime.compression` (int8
gradient exchange with error feedback)."""
