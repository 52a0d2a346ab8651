"""Acoustic model: frame-wise CNN encoder + BiLSTM (sum merge) + linear head.

Counterpart of `mri2speech_tpu/models/acoustic.py:36-143`: (B, T, 1, H, W)
frames -> EfficientNetV2-B2 features (global average pool, 208-d) -> BiLSTM
(hidden 640, directions summed) -> Dropout -> Linear(n_mels). Public methods
keep the JAX layouts: `cnn_features` returns (B*T, h, w, C).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mri2speech_tpu_torch.models.effnetv2 import (
    EFFNETV2_B2_SPEC,
    EFFNETV2_B2_STEM,
    EffNetV2Features,
    StageSpec,
)
from mri2speech_tpu_torch.models.lstm import BiLSTMSumMerge


class AcousticModel(nn.Module):
    """CNN-BiLSTM; input (B, T, 1, H, W) or (B, T, H, W) -> (B, T, n_mels).

    lstm_impl: "kernel" (serving: `ops/bilstm.py`) or "scan" (plain loop).
    fuse_ir: the eligible ir blocks through the MBConv kernel (`models/effnetv2.py`).
    """

    def __init__(
        self,
        n_mels: int = 64,
        rnn_hidden: int = 640,
        dropout: float = 0.5,
        cnn_spec: Optional[Sequence[StageSpec]] = None,
        cnn_stem: Optional[int] = None,
        lstm_impl: str = "kernel",
        fuse_ir: bool = False,
    ) -> None:
        super().__init__()
        self.cnn = EffNetV2Features(
            EFFNETV2_B2_SPEC if cnn_spec is None else tuple(cnn_spec),
            EFFNETV2_B2_STEM if cnn_stem is None else cnn_stem,
            fuse_ir=fuse_ir,
        )
        self.rnn = BiLSTMSumMerge(self.cnn.out_channels, rnn_hidden, impl=lstm_impl)
        self.drop = nn.Dropout(dropout)
        self.head = nn.Linear(rnn_hidden, n_mels)

    @staticmethod
    def _to_frames(x: torch.Tensor):
        """(B, T, [1,] H, W) -> (B*T, 3, H, W), the 1->3 channel broadcast."""
        if x.dim() == 4:
            x = x[:, :, None]
        if x.dim() != 5:
            raise ValueError(f"Expected (B,T,1,H,W) or (B,T,H,W), got {tuple(x.shape)}")
        B, T = x.shape[:2]
        frames = x.reshape(B * T, *x.shape[2:]).float()
        if frames.shape[1] == 1:
            frames = frames.expand(-1, 3, -1, -1)
        return frames, B, T

    def _pooled(self, x: torch.Tensor) -> torch.Tensor:
        frames, B, T = self._to_frames(x)
        return self.cnn(frames).mean(dim=(2, 3)).reshape(B, T, -1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.head_from_pooled(self._pooled(x), mask)

    def cnn_features(self, x: torch.Tensor) -> torch.Tensor:
        """Frames -> pre-pool CNN feature maps (B*T, h, w, C)."""
        frames, _, _ = self._to_frames(x)
        return self.cnn(frames).permute(0, 2, 3, 1)

    def head_from_features(self, feats: torch.Tensor, batch: int, timesteps: int) -> torch.Tensor:
        """(B*T, h, w, C) feature maps -> (B, T, n_mels)."""
        pooled = feats.mean(dim=(1, 2)).reshape(batch, timesteps, -1)
        return self.head_from_pooled(pooled)

    def head_from_pooled(
        self, pooled: torch.Tensor, mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """(B, T, C) pooled features -> (B, T, n_mels)."""
        y = self.drop(self.rnn(pooled, mask))
        return self.head(y).float()

    def forward_with_features(self, x: torch.Tensor):
        """(pred (B, T, n_mels), feats (B*T, h, w, C)) in one pass."""
        frames, B, T = self._to_frames(x)
        feats = self.cnn(frames).permute(0, 2, 3, 1)
        return self.head_from_features(feats, B, T), feats
