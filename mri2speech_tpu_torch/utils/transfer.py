"""Device->host transfers for sites that fetch several outputs at once.

Counterpart of `mri2speech_tpu/utils/transfer.py::prefetch_to_host`: every
copy is started before the first one is waited for, so the copies queue
back to back behind the work that produces them and the host waits once.
Unlike the JAX version, a failed copy raises: falling back to blocking
copies would hide a device fault.
"""
from __future__ import annotations

from typing import List

import torch

__all__ = ["prefetch_to_host"]


def prefetch_to_host(*tensors: torch.Tensor) -> List[torch.Tensor]:
    """Host copies of `tensors`, in order; CPU tensors come back as they are.

    Each CUDA tensor is copied `non_blocking` into pinned host memory on its
    device's current stream; then each of those streams is synchronised once,
    before any copy is returned for reading.
    """
    out, streams = [], {}
    for t in tensors:
        if t.device.type == "cpu":
            out.append(t)
            continue
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        out.append(host)
        streams.setdefault(t.device, torch.cuda.current_stream(t.device))
    for stream in streams.values():
        stream.synchronize()
    return out
