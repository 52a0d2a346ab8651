"""Vocoder checkpoint loading for inference.

Counterpart of `mri2speech_tpu/infer/vocoder_io.py:18-35`: read a
`g_XXXXXXXX` flax msgpack checkpoint, fold weight norm, and load the result
into the port's Generator.
"""
from __future__ import annotations

from typing import Union

import torch

from mri2speech_tpu_torch.config import load_config
from mri2speech_tpu_torch.device import resolve_device
from mri2speech_tpu_torch.models.vocoder import Generator
from mri2speech_tpu_torch.train import checkpoint as ckpt_io
from mri2speech_tpu_torch.weights import generator_from_jax


def load_generator(
    config_path: str,
    checkpoint_path: str,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Generator:
    """The Generator of `config_path` with the checkpoint's weights (folded), in eval mode."""
    dev = resolve_device(device)
    h = load_config(config_path)
    obj = ckpt_io.load_checkpoint_raw(checkpoint_path)
    if "generator" not in obj:
        raise KeyError("HiFi-GAN checkpoint missing 'generator' state")
    return generator_from_jax(obj["generator"], h).to(dev)
