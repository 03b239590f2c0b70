"""Device selection for the port's entry points.

Every entry point runs on ``cuda`` unless its caller passes ``device="cpu"``.
Nothing falls back to the CPU when no card is found: asking for ``cuda``
without one raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """Config dtype name (``"bfloat16"``, ``"float32"``, ...) -> torch dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "int8": torch.int8}[name]
