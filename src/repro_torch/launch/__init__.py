"""Launch entry points of the port: `repro_torch.launch.serve` (wave-based
batched decode) and `repro_torch.launch.train` (the trainer, with
`repro_torch.launch.steps` for its step)."""
