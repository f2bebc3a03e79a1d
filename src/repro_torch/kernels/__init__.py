"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

* `repro_torch.kernels.pair_resolve` -- the pair-space calendar round
  reduction (from ``repro/kernels/event_resolve``);
* `repro_torch.kernels.event_resolve` -- the flow-space calendar round, both
  disciplines in f64 (from ``repro/kernels/event_resolve``);
* `repro_torch.kernels.port_stats` -- per-port loads and counts (from
  ``repro/kernels/port_stats``);
* `repro_torch.kernels.lp_terms` -- the LP's hard-max terms (from
  ``repro/kernels/lp_terms``);
* `repro_torch.kernels.flash_attention` -- GQA attention with causal and
  sliding-window masks, the serving path's kernel (from
  ``repro/kernels/flash_attention``);
* `repro_torch.kernels.mlstm_chunk` -- the chunkwise mLSTM forward with a
  carried (Dh, Dh) state, the xLSTM serving path's kernel (from
  ``repro/kernels/mlstm_chunk``).

Each wrapper launches its kernel for CUDA tensors, takes the plain twin for
CPU tensors, and counts its launches in its module's ``LAUNCHES``.  The
modules keep their functions' names, so import the functions from the
modules.
"""
