"""Device resolution for the port's entry points: no silent CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    ``"cuda"`` (the default everywhere) needs a card and raises without one;
    the CPU is used only when the caller asks for it. ``"meta"`` gives
    shapes without storage (the registry's plans of full-size models).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(dev)!r}; use cuda, cpu "
                         "or meta")
    return dev
