"""Device selection for the port's entry points: the card unless asked."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`torch.device` for an entry point's `device=` argument.

    Raises when a CUDA device is asked for (the default) and none is
    available — the port never falls back to the CPU on its own; callers
    that want the CPU pass `device="cpu"`."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "intrinsic3d_torch: a CUDA device was requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run on the CPU"
        )
    return dev


def check_on(dev: torch.device, **tensors) -> None:
    """Raise unless every named tensor lies on `dev` (index checked when given)."""
    for name, t in tensors.items():
        if t.device.type != dev.type or (
            dev.index is not None and t.device.index != dev.index
        ):
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
