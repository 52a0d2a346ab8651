"""Configuration: the vocoder JSON schema (`config_custom.json`) as an AttrDict.

Counterpart of `mri2speech_tpu/config.py`; the schema is the same, so one
config file serves both packages.
"""
from __future__ import annotations

import json
from typing import Any


class AttrDict(dict):
    """Dict with attribute access."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.__dict__ = self


def load_config(path: str) -> AttrDict:
    """Load a JSON config file into an AttrDict."""
    with open(path, "r", encoding="utf-8") as f:
        return AttrDict(json.load(f))


# Default vocoder hyperparameters (`config_custom.json`). sr=11413 with a hop
# of 420 gives one mel frame per ~27.2 fps rtMRI video frame.
DEFAULT_VOCODER_CONFIG: dict = {
    "resblock": "1",
    "num_gpus": 1,
    "batch_size": 16,
    "learning_rate": 5e-05,
    "adam_b1": 0.8,
    "adam_b2": 0.99,
    "lr_decay": 0.999,
    "seed": 1234,
    "upsample_rates": [10, 7, 3, 2],
    "upsample_kernel_sizes": [20, 15, 7, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "segment_size": 8400,
    "num_mels": 64,
    "num_freq": 1025,
    "n_fft": 2048,
    "hop_size": 420,
    "win_size": 2048,
    "sampling_rate": 11413,
    "fmin": 0,
    "fmax": 8000,
    "fmax_for_loss": None,
    "num_workers": 4,
}


def default_vocoder_config(**overrides: Any) -> AttrDict:
    cfg = dict(DEFAULT_VOCODER_CONFIG)
    cfg.update(overrides)
    return AttrDict(cfg)
