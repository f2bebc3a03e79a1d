"""Device selection for the port's entry points.

Entry points default to ``device="cuda"`` and raise when no card is
present; the host runs them only when the caller asks for the CPU.  The
``meta`` device (shapes and dtypes, no values) is taken only where the
caller names it and the callee says it runs there (`build_model`).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device, meta: bool = False) -> torch.device:
    """``torch.device`` for ``device``; raises if it names an absent card,
    or ``meta`` where the callee does not take it (``meta=False``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on an NVIDIA GPU by "
                "default; pass device='cpu' to run its plain PyTorch "
                "versions on the host"
            )
    elif dev.type == "meta":
        if not meta:
            raise ValueError(f"unsupported device {device!r}: this entry point needs values")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
