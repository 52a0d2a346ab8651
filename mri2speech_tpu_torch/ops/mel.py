"""Mel-domain bridge between the acoustic model and the vocoder.

Counterpart of `mri2speech_tpu/ops/mel.py:351-359`. The STFT and filterbank
are not needed on the inference path and come with a later slice.
"""
from __future__ import annotations

import torch


def mel_db_to_log_power(mel_db: torch.Tensor) -> torch.Tensor:
    """power = 10^(dB/10); log = ln(max(power, 1e-5))."""
    mel_power = torch.pow(10.0, mel_db / 10.0)
    return torch.log(torch.clamp(mel_power, min=1e-5))
