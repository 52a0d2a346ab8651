"""Conv building blocks of the vocoder, in PyTorch's (B, C, T) layout.

Counterpart of `mri2speech_tpu/models/layers.py:72-226`. The fork's
ResBlock convs are causal (left pad ``d*(k-1)``, then a VALID conv);
`conv_pre`/`conv_post` pad right by ``(0, k-1)``. Weights are plain (weight
norm is folded when loading, `weights.py::fold_weight_norm`).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn


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
