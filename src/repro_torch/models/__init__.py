"""Decoder models of the port (`repro.models`: the dense part, xLSTM and
RG-LRU).

* `repro_torch.models.layers` -- RMSNorm, RoPE, GQA attention on the
  flash kernel, the gated FFN;
* `repro_torch.models.xlstm` -- mLSTM blocks on the `mlstm_chunk` kernel
  with a carried state, sLSTM blocks as a loop over positions;
* `repro_torch.models.rglru` -- RG-LRU blocks (a log-depth scan over the
  sequence, a carried h and conv window);
* `repro_torch.models.model` -- `build_model` and the `Model` it returns.
"""

from repro_torch.models.model import Model, build_model, param_bytes, param_count

__all__ = ["Model", "build_model", "param_bytes", "param_count"]
