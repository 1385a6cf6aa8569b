"""Device resolution: every entry point runs on the card unless the caller
asks for another device (the CPU tests pass ``device="cpu"``)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``, raising when no card is present; anything else
    is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(data, device: torch.device) -> torch.Tensor:
    """numpy array -> uint8 tensor on ``device``; a tensor must already lie
    on ``device`` (the codecs never move device-resident data silently)."""
    if isinstance(data, torch.Tensor):
        if data.device.type != device.type or (
                device.index is not None and data.device != device):
            raise ValueError(
                f"tensor on {data.device}, codec on {device}")
        return data
    return torch.from_numpy(data).to(device)
