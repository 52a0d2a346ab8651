"""Per-mel-bin z-score scaler (the scaler.json contract).

Counterpart of `mri2speech_tpu/ops/scaler.py:20-64`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Union

import numpy as np


@dataclass(frozen=True)
class MelScaler:
    """mean/std per mel bin, float32, 1-D each."""

    mean: np.ndarray
    std: np.ndarray

    def __post_init__(self) -> None:
        if self.mean.ndim != 1 or self.std.ndim != 1:
            raise ValueError("Scaler mean/std must be 1-D lists")
        if self.mean.shape != self.std.shape:
            raise ValueError("Scaler mean/std length mismatch")

    @property
    def n_mels(self) -> int:
        return int(self.mean.shape[0])

    @classmethod
    def load(cls, path: Union[str, Path]) -> "MelScaler":
        with open(path, "r", encoding="utf-8") as f:
            stats = json.load(f)
        if "mean" not in stats or "std" not in stats:
            raise KeyError("Scaler JSON must contain 'mean' and 'std' lists")
        return cls(
            mean=np.asarray(stats["mean"], dtype=np.float32),
            std=np.asarray(stats["std"], dtype=np.float32),
        )

    def save(self, path: Union[str, Path], count_frames: int = 0) -> None:
        stats = {
            "mean": self.mean.astype(np.float64).tolist(),
            "std": self.std.astype(np.float64).tolist(),
            "count_frames": int(count_frames),
        }
        with open(path, "w", encoding="utf-8") as f:
            json.dump(stats, f, indent=2)
