"""Where the port runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device with no card present
    raises rather than drifting to the CPU: the CPU runs only when the
    caller names it (as the tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"paddle_tpu_torch was asked for device {str(dev)!r} but no "
            "CUDA device is available — run on a machine with a card, or "
            "pass device='cpu' explicitly")
    return dev
