"""Device selection shared by the entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The torch.device to run on; raises when CUDA is asked for and there is no card.

    There is no silent fallback: running on the CPU takes ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run the plain PyTorch path"
        )
    return dev
