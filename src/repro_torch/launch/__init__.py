"""Launch entry points of the port: `repro_torch.launch.serve` (wave-based
batched decode), `repro_torch.launch.train` (the trainer, with
`repro_torch.launch.steps` for its step), and the launch tooling: device
meshes (`mesh`), sharding rules (`sharding`), meta-tensor input specs
(`specs`), the ATen operation counter (`op_cost`), the H100 roofline
(`roofline`), the dry-run (`dryrun`), the perf driver (`perf`) and its
tables (`report`)."""
