"""HiFi-GAN generator (the fork's semantics), inference side.

Counterpart of `mri2speech_tpu/models/vocoder.py:44-99, 168-182, 264-455`:
mel (B, n_mels, T) -> waveform (B, 1, T * prod(upsample_rates)).

``fuse_mode`` picks, per upsample stage, how its MRF branches run (a string
for every stage, or one entry per stage, as in the JAX package):

* ``"none"``, ``"dense"``, ``"grouped"``: the three ResBlocks, unfused, in
  fp32. The JAX package's dense and grouped fusions are TPU lane-packing
  rewrites with the same output, so they run the same code here.
* ``"pallas"`` / ``"pallas2"``: the whole stage through the MRF kernel
  (`ops/mrf.py`), its v1 entry point on the branch-tiled state or its v2
  entry point on the compact one, with bf16 operands as on the TPU. An
  inference transform: it raises in training mode.

:data:`FUSED_MODE` is the fused serving configuration: v1 on the two wide
stages, v2 on the two narrow ones. The state_dict keys are the same in every
mode (``resblocks.{i*3+j}.convs{1,2}.{u}``); the fused stages convert their
weights to the kernel's layout on first use and again whenever they change.
"""
from __future__ import annotations

from typing import List, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from mri2speech_tpu_torch.models.layers import (
    Conv1d,
    DerivedWeights,
    causal_conv1d,
    module_tensors,
)
from mri2speech_tpu_torch.ops import mrf

LRELU_SLOPE = 0.1
FUSE_MODES = ("none", "dense", "grouped", "pallas", "pallas2")
KERNEL_MODES = ("pallas", "pallas2")
FUSED_MODE = ("pallas", "pallas", "pallas2", "pallas2")


def normalize_fuse_modes(mode: Union[str, Sequence[str]], num_stages: int) -> List[str]:
    """Per-stage MRF mode list from a string (every stage) or a sequence (one per stage)."""
    if isinstance(mode, str):
        return [mode] * num_stages
    modes = list(mode)
    if len(modes) != num_stages:
        raise ValueError(f"fuse_mode needs {num_stages} entries, got {len(modes)}")
    return modes


class ResBlock1(nn.Module):
    """3 units of leaky -> causal dilated conv -> leaky -> causal conv -> residual."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)) -> None:
        super().__init__()
        self.convs1 = nn.ModuleList(causal_conv1d(channels, kernel_size, d) for d in dilation)
        self.convs2 = nn.ModuleList(causal_conv1d(channels, kernel_size, 1) for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
        return x


class ResBlock2(nn.Module):
    """Lighter MRF block: leaky -> causal dilated conv -> residual, dilations (1, 3)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3)) -> None:
        super().__init__()
        self.convs = nn.ModuleList(causal_conv1d(channels, kernel_size, d) for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class Generator(nn.Module):
    """conv_pre (right pad 6) -> per stage [leaky -> ConvTranspose -> mean of MRF
    ResBlocks] -> leaky(0.01) -> conv_post (right pad 6) -> tanh.

    fuse_mode: None (every stage unfused) or as :func:`normalize_fuse_modes` takes it.
    """

    def __init__(self, h: dict, fuse_mode: Union[None, str, Sequence[str]] = None) -> None:
        super().__init__()
        self.h = dict(h)
        n_mels = int(h.get("num_mels", 64))
        c0 = int(h["upsample_initial_channel"])
        self.num_kernels = len(h["resblock_kernel_sizes"])
        num_stages = len(h["upsample_rates"])
        modes = normalize_fuse_modes("none" if fuse_mode is None else fuse_mode, num_stages)
        unknown = sorted(set(modes) - set(FUSE_MODES))
        if unknown:
            raise ValueError(f"unknown fuse modes {unknown}; expected some of {FUSE_MODES}")
        self.fuse_modes = tuple(modes)
        self.mrf_dils = tuple(h["resblock_dilation_sizes"][0])
        if any(m in KERNEL_MODES for m in modes) and (
            str(h["resblock"]) != "1"
            or any(tuple(d) != self.mrf_dils for d in h["resblock_dilation_sizes"])
        ):
            raise ValueError(
                "the MRF kernel takes resblock '1' with one dilation set for all branches")
        self._mrf_weights = [DerivedWeights() for _ in range(num_stages)]
        resblock = ResBlock1 if str(h["resblock"]) == "1" else ResBlock2
        self.conv_pre = Conv1d(n_mels, c0, 7, pad=(0, 6))
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = c0
        for i, (u, k) in enumerate(zip(h["upsample_rates"], h["upsample_kernel_sizes"])):
            cin, ch = ch, c0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(cin, ch, k, stride=u, padding=(k - u) // 2))
            for rk, rd in zip(h["resblock_kernel_sizes"], h["resblock_dilation_sizes"]):
                self.resblocks.append(resblock(ch, rk, tuple(rd)))
        self.conv_post = Conv1d(ch, 1, 7, pad=(0, 6))

    def stage_weights(self, i: int) -> mrf.MRFStageWeights:
        """Stage i's taps for the MRF kernel (rebuilt when its parameters change)."""
        blocks = list(self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels])
        units = range(len(self.mrf_dils))

        def build():
            convs = [[[getattr(b, f"convs{c + 1}")[u] for b in blocks] for c in range(2)]
                     for u in units]
            return mrf.MRFStageWeights(
                [[[m.weight for m in per_c] for per_c in per_u] for per_u in convs],
                [[[m.bias for m in per_c] for per_c in per_u] for per_u in convs],
                self.h["resblock_kernel_sizes"], self.mrf_dils,
            )

        return self._mrf_weights[i].get([t for b in blocks for t in module_tensors(b)], build)

    def _fused_stage(self, i: int, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("fused MRF stages are an inference transform; call .eval() first")
        w = self.stage_weights(i)
        kw = dict(channels=w.channels, kernels=w.kernels, dils=w.dils, layout="bct")
        if self.fuse_modes[i] == "pallas":
            return mrf.mrf_stage_pallas(x.repeat(1, self.num_kernels, 1), w, **kw)
        return mrf.mrf_stage_pallas_v2(x, w, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(x)
        nk = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            if self.fuse_modes[i] in KERNEL_MODES:
                x = self._fused_stage(i, x)
                continue
            xs = self.resblocks[i * nk](x)
            for j in range(1, nk):
                xs = xs + self.resblocks[i * nk + j](x)
            x = xs / nk
        x = F.leaky_relu(x, 0.01)  # fork quirk: torch's default slope before conv_post
        return torch.tanh(self.conv_post(x))


def generator_receptive_field(h: dict):
    """Exact dependency cone of the Generator, in mel frames.

    Returns ``(left, right)``: audio sample ``t`` depends only on mel frames
    ``[t // hop - left, t // hop + right]``, with hop = prod(upsample_rates).
    Integer interval arithmetic backward through every layer:

    * causal conv (left pad ``d*(k-1)``): ``in = [lo - d*(k-1), hi]``
    * right-pad conv_pre/conv_post (pad ``(0, 6)``): ``in = [lo, hi + 6]``
    * ConvTranspose (stride ``u``, pad ``p``):
      ``in = [ceil((lo + p - k + 1)/u), floor((hi + p)/u)]``
    """
    rb_kernels = tuple(h["resblock_kernel_sizes"])
    rb_dils = tuple(tuple(d) for d in h["resblock_dilation_sizes"])
    two_convs_per_unit = str(h["resblock"]) == "1"
    hop = 1
    for u in h["upsample_rates"]:
        hop *= u

    N = 1 << 20  # far from either edge
    lo, hi = N * hop, (N + 1) * hop - 1

    def mrf(lo, hi):
        best_lo = lo
        for k, dils in zip(rb_kernels, rb_dils):
            unit_tail = (k - 1) if two_convs_per_unit else 0
            best_lo = min(best_lo, lo - sum(d * (k - 1) + unit_tail for d in dils))
        return best_lo, hi

    hi += 6  # conv_post
    for u, k in zip(reversed(h["upsample_rates"]), reversed(h["upsample_kernel_sizes"])):
        lo, hi = mrf(lo, hi)
        p = (k - u) // 2
        lo = -((-(lo + p - k + 1)) // u)  # ceil div
        hi = (hi + p) // u
    hi += 6  # conv_pre
    return N - lo, hi - N
