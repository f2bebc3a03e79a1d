"""Launch entry points of the port: `repro_torch.launch.serve` (wave-based
batched decode)."""
