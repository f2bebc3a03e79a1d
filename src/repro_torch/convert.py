"""Carry objects of the JAX package over into the port.

The scheduler has data where a model has weights: the tests hand both
packages the same instances and LP solutions through `from_reference`, and
the same model weights through `params_from_reference`.  Both read the
reference's objects by their fields only (NumPy arrays and floats) and
import nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.allocation import Allocation
from repro_torch.core.coflow import CoflowInstance
from repro_torch.core.lp import LP_ARRAY_NAMES, LPSolution
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model

__all__ = ["from_reference", "params_from_reference"]


def from_reference(obj: Any, device: str | torch.device) -> Any:
    """The port's counterpart of a JAX-package object.

    * ``CoflowInstance`` -> `repro_torch.core.coflow.CoflowInstance`;
    * ``LPSolution`` -> `repro_torch.core.lp.LPSolution`;
    * ``Allocation`` -> `repro_torch.core.allocation.Allocation`;
    * the ``pack_lp_arrays`` dict -> the same dict of tensors on ``device``.

    The NumPy-valued results live on the host; ``device`` places tensors.
    """
    device = resolve_device(device)
    kind = type(obj).__name__
    if kind == "CoflowInstance":
        return CoflowInstance(
            demands=np.array(obj.demands), weights=np.array(obj.weights),
            releases=np.array(obj.releases), rates=np.array(obj.rates),
            delta=float(obj.delta),
        )
    if kind == "LPSolution":
        return LPSolution(
            completion=np.array(obj.completion, dtype=np.float64),
            precedence=np.array(obj.precedence, dtype=np.float64),
            objective=float(obj.objective), method=str(obj.method),
            iterations=int(obj.iterations),
        )
    if kind == "Allocation":
        return Allocation(
            **{
                f: np.array(getattr(obj, f))
                for f in (
                    "coflow", "src", "dst", "size", "core", "rho_ports",
                    "tau_ports", "prefix_lb",
                )
            }
        )
    if isinstance(obj, dict) and set(obj) == set(LP_ARRAY_NAMES):
        return {
            k: torch.from_numpy(np.array(obj[k])).to(device)
            for k in LP_ARRAY_NAMES
        }
    raise TypeError(f"from_reference: no counterpart for {kind}")


def params_from_reference(
    params: dict, cfg: ModelConfig, device: str | torch.device, masters: bool = False
) -> dict:
    """The port's per-layer parameters from the reference's parameter tree.

    ``params`` is ``repro.models.model.build_model(cfg).init(key)``'s nested
    dict, its leaves as arrays NumPy can read: layer ``i`` of a config with
    a unit of ``u`` kinds repeated ``reps`` times sits at ``units[i % u]``,
    row ``i // u`` of every stacked leaf (the expert stacks, 4-D there,
    give (E, ., .) leaves), for ``i < reps * u``, and at ``rem[i - reps *
    u]`` after that.  Each layer's blocks keep their names (``attn`` for
    attention and MLA, ``cross`` beside it in a cross layer, ``ffn`` for
    the FFN or the experts, ``mix`` for mLSTM, sLSTM and RG-LRU); the
    top-level leaves keep theirs (``final_norm``, and ``embed`` or
    ``embed_{c}`` per codebook).  Matrices, expert stacks and embeddings
    are held in the compute dtype, vectors, sLSTM's ``r`` and RG-LRU's
    ``w_r`` and ``w_i`` in f32, on ``device`` (all in f32 with
    ``masters``).  The reference's gradient trees map the same way.
    """
    model = build_model(cfg, device)
    u = len(tuple(cfg.layer_unit))
    reps = cfg.num_layers // u

    def layer(i: int) -> dict:
        if i < reps * u:
            tree, pick = params["units"][i % u], lambda a: np.asarray(a)[i // u]
        else:
            tree, pick = params["rem"][i - reps * u], np.asarray
        return {
            blk: {name: torch.from_numpy(np.array(pick(a))) for name, a in p.items()}
            for blk, p in tree.items()
        }

    top = {k: torch.from_numpy(np.array(v)) for k, v in params.items()
           if k not in ("units", "rem")}
    return model.cast({"layers": [layer(i) for i in range(cfg.num_layers)], **top}, masters)
