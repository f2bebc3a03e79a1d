"""Training runtime of the port: `repro_torch.runtime.compression` (int8
gradient exchange with error feedback) and
`repro_torch.runtime.fault_tolerance` (failure injection, restarts from
checkpoints, straggler tracking)."""
