"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → the CUDA card (raises when there is none); else as given.

    The port never falls back to the CPU on its own: a caller that wants the
    plain PyTorch paths on the CPU says so with ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch paths on the CPU")
        return torch.device("cuda")
    return torch.device(device)
