"""PyTorch/CUDA port of the K-core OCS coflow scheduler.

A second package beside the JAX reference (`repro`): the offline ``ours``
pipeline -- batched ordering LP, inter-core allocation, pair-space circuit
calendar -- on an NVIDIA GPU, through hand-written CUDA kernels
(`repro_torch.kernels`).  It imports neither ``jax`` nor ``repro``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``::

    from repro_torch.experiments import solve_ensemble_lp
    from repro_torch.pipeline import get_pipeline
    from repro_torch.traffic import paper_default_instance

    ens = [paper_default_instance(seed=s) for s in range(32)]
    sols = solve_ensemble_lp(ens)
    results = get_pipeline("ours").run_batch(ens, lp_solutions=sols)
"""
