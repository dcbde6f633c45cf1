"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The torch device an entry point runs on.

    The default is the card. Without one this raises instead of falling back:
    the caller asks for the CPU (`device="cpu"`) to run the plain versions.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return device
