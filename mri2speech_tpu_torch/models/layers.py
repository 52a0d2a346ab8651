"""Conv building blocks of the vocoder, in PyTorch's (B, C, T) layout.

Counterpart of `mri2speech_tpu/models/layers.py:72-226`. The fork's
ResBlock convs are causal (left pad ``d*(k-1)``, then a VALID conv);
`conv_pre`/`conv_post` pad right by ``(0, k-1)``. Weights are plain (weight
norm is folded when loading, `weights.py::fold_weight_norm`).

Also here: :class:`DerivedWeights`, the cache of a module's weights in a
kernel's layout.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Tuple, TypeVar

import torch
import torch.nn.functional as F
from torch import nn

V = TypeVar("V")


class Conv1d(nn.Conv1d):
    """nn.Conv1d with explicit (left, right) zero padding before a VALID conv."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, *,
                 dilation: int = 1, pad: Tuple[int, int] = (0, 0)) -> None:
        super().__init__(in_channels, out_channels, kernel_size, dilation=dilation)
        self.pad = tuple(pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.pad(x, self.pad))


def causal_conv1d(channels: int, kernel_size: int, dilation: int = 1) -> Conv1d:
    """Causal conv: output t sees inputs t - d*(k-1) .. t."""
    return Conv1d(channels, channels, kernel_size, dilation=dilation,
                  pad=(dilation * (kernel_size - 1), 0))


def module_tensors(module: nn.Module) -> List[torch.Tensor]:
    """A module's parameters and buffers, its submodules' included.

    Read straight from the modules' dicts: a fraction of the host time of
    ``parameters()`` and ``buffers()``, which a forward pass pays on every call.
    """
    out = [t for d in (module._parameters, module._buffers) for t in d.values() if t is not None]
    for child in module._modules.values():
        if child is not None:
            out += module_tensors(child)
    return out


class DerivedWeights:
    """A value computed from some tensors (their copy in a kernel's layout).

    :meth:`get` rebuilds it, under ``no_grad``, whenever one of the tensors
    was replaced (``load_state_dict(assign=True)``), moved (``.to``) or
    changed in place (``load_state_dict``, ``copy_``), so no stale copy
    survives. It holds references to the tensors it was built from, which
    keeps their ids unique while it compares them.
    """

    def __init__(self) -> None:
        self._key = None
        self._tensors = ()
        self._value = None

    def get(self, tensors: Iterable[torch.Tensor], build: Callable[[], V]) -> V:
        tensors = tuple(tensors)
        key = (tuple(map(id, tensors)), tuple(
            (t.device, t.data_ptr(), 0 if t.is_inference() else t._version) for t in tensors))
        if key != self._key:
            with torch.no_grad():
                self._value = build()
            self._key, self._tensors = key, tensors
        return self._value
