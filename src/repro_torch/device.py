"""Device resolution shared by every entry point of the port.

The port runs on the GPU. A caller who wants the CPU (the tests, a laptop
demo) says so with ``device="cpu"``; nothing here ever falls back to the
CPU on its own, so a missing card is an error, not a silent slowdown.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a visible card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev

