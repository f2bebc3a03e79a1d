"""Input data of the port: `repro_torch.data.pipeline` (synthetic tokens)."""
