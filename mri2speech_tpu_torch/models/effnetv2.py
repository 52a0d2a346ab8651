"""EfficientNetV2-B2 feature extractor (timm `tf_efficientnetv2_b2` names).

Counterpart of `mri2speech_tpu/models/effnetv2.py:43-170, 451-514`, in
PyTorch's NCHW layout. TF-SAME padding is computed per input size (PyTorch's
``padding="same"`` is symmetric and refuses stride 2): a stride-2 3x3 conv on
an even input pads (0, 1). BatchNorm eps 1e-3. The SE reduced width is the
block's input channels x 0.25.

``fuse_ir=True`` runs every stride-1, channel-preserving, 3x3 SE block of
an ``ir`` stage (17 of the 20 in B2) as :class:`FusedMBConv`: BatchNorm
folded, the whole block through the MBConv kernel (`ops/mbconv.py`) with
bf16 operands, as the JAX package's `_FusedMBConv` does on the TPU. The
parameters and state_dict keys do not change.

Not ported: the JAX package's `stem_s2d` and `pad_ir` (exact TPU rewrites
over the same parameters; `pad_ir` takes precedence over `fuse_ir` there,
so compare with ``pad_ir=False``). The stem runs on the 1->3 channel
broadcast.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mri2speech_tpu_torch.models.layers import DerivedWeights, module_tensors
from mri2speech_tpu_torch.ops import mbconv


@dataclasses.dataclass(frozen=True)
class StageSpec:
    block: str  # "cn" | "er" | "ir"
    kernel: int
    stride: int
    expand: int
    channels: int
    repeats: int
    se_ratio: float = 0.0


EFFNETV2_B2_SPEC: Tuple[StageSpec, ...] = (
    StageSpec("cn", 3, 1, 1, 16, 2),
    StageSpec("er", 3, 2, 4, 32, 3),
    StageSpec("er", 3, 2, 4, 56, 3),
    StageSpec("ir", 3, 2, 4, 104, 4, 0.25),
    StageSpec("ir", 3, 1, 6, 120, 6, 0.25),
    StageSpec("ir", 3, 2, 6, 208, 10, 0.25),
)

EFFNETV2_B2_STEM = 32
EFFNETV2_B2_FEATURE_DIM = EFFNETV2_B2_SPEC[-1].channels  # 208


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF-SAME (lo, hi) padding of one spatial axis."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """Bias-free nn.Conv2d with TF-SAME padding (asymmetric where needed)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> None:
        super().__init__(cin, cout, k, stride=stride, groups=groups, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        if k > 1:
            ph = _same_pad(x.shape[-2], k, s)
            pw = _same_pad(x.shape[-1], k, s)
            x = F.pad(x, (*pw, *ph))
        return super().forward(x)


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-3)


class ConvBnAct(nn.Module):
    """'cn' block: conv kxk + BN + SiLU, identity skip when shapes allow."""

    def __init__(self, cin: int, cout: int, k: int, stride: int) -> None:
        super().__init__()
        self.conv = Conv2dSame(cin, cout, k, stride)
        self.bn1 = _bn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.bn1(self.conv(x)))
        return y + x if self.has_skip else y


class EdgeResidual(nn.Module):
    """Fused-MBConv ('er'): conv kxk expand + BN + SiLU -> 1x1 project + BN."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, expand: int) -> None:
        super().__init__()
        mid = cin * expand
        self.conv_exp = Conv2dSame(cin, mid, k, stride)
        self.bn1 = _bn(mid)
        self.conv_pwl = Conv2dSame(mid, cout, 1)
        self.bn2 = _bn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.bn1(self.conv_exp(x)))
        y = self.bn2(self.conv_pwl(y))
        return y + x if self.has_skip else y


class SqueezeExcite(nn.Module):
    """GAP -> 1x1 reduce -> SiLU -> 1x1 expand -> sigmoid gate."""

    def __init__(self, channels: int, reduced: int) -> None:
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class InvertedResidual(nn.Module):
    """MBConv ('ir'): 1x1 expand -> depthwise kxk -> SE -> 1x1 project."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, expand: int,
                 se_ratio: float) -> None:
        super().__init__()
        mid = cin * expand
        self.conv_pw = Conv2dSame(cin, mid, 1)
        self.bn1 = _bn(mid)
        self.conv_dw = Conv2dSame(mid, mid, k, stride, groups=mid)
        self.bn2 = _bn(mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * se_ratio))) if se_ratio > 0 else None
        self.conv_pwl = Conv2dSame(mid, cout, 1)
        self.bn3 = _bn(cout)
        self.has_skip = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = F.silu(self.bn2(self.conv_dw(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.has_skip else y


class FusedMBConv(InvertedResidual):
    """A stride-1, channel-preserving 3x3 SE block through the MBConv kernel.

    The same submodules as :class:`InvertedResidual`, so it loads the same
    state_dict. The forward folds the BatchNorms (once, and again whenever a
    weight or statistic changes) and runs `ops/mbconv.py` with bf16
    operands. An inference transform: it raises in training mode.
    """

    def __init__(self, channels: int, expand: int, se_ratio: float) -> None:
        super().__init__(channels, channels, 3, 1, expand, se_ratio)
        self._folded = DerivedWeights()

    def folded_weights(self) -> mbconv.MBConvWeights:
        """The BN-folded weights (rebuilt when a parameter or buffer changes)."""
        return self._folded.get(module_tensors(self), lambda: mbconv.MBConvWeights.from_block(self))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise RuntimeError("FusedMBConv is an inference transform; call .eval() first")
        return mbconv.mbconv_block_pallas(x.contiguous(), self.folded_weights(), layout="nchw")


def _fusable(st: StageSpec, cin: int, stride: int) -> bool:
    """Where the JAX package's fuse_ir puts `_FusedMBConv` (`effnetv2.py:495-502`)."""
    return (st.block == "ir" and stride == 1 and cin == st.channels and st.kernel == 3
            and st.se_ratio > 0)


class EffNetV2Backbone(nn.Module):
    """Stem + stages; (N, 3, H, W) -> last-stage map (N, C, H/32, W/32)."""

    def __init__(self, spec: Sequence[StageSpec] = EFFNETV2_B2_SPEC,
                 stem_channels: int = EFFNETV2_B2_STEM, in_channels: int = 3,
                 fuse_ir: bool = False) -> None:
        super().__init__()
        self.conv_stem = Conv2dSame(in_channels, stem_channels, 3, 2)
        self.bn1 = _bn(stem_channels)
        self.blocks = nn.ModuleList()
        cin = stem_channels
        for st in spec:
            stage = nn.ModuleList()
            for bi in range(st.repeats):
                stride = st.stride if bi == 0 else 1
                if st.block == "cn":
                    blk = ConvBnAct(cin, st.channels, st.kernel, stride)
                elif st.block == "er":
                    blk = EdgeResidual(cin, st.channels, st.kernel, stride, st.expand)
                elif fuse_ir and _fusable(st, cin, stride):
                    blk = FusedMBConv(st.channels, st.expand, st.se_ratio)
                elif st.block == "ir":
                    blk = InvertedResidual(
                        cin, st.channels, st.kernel, stride, st.expand, st.se_ratio
                    )
                else:
                    raise ValueError(f"unknown block kind {st.block!r}")
                stage.append(blk)
                cin = st.channels
            self.blocks.append(stage)
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.silu(self.bn1(self.conv_stem(x)))
        for stage in self.blocks:
            for blk in stage:
                y = blk(y)
        return y


class EffNetV2Features(nn.Module):
    """Wrapper whose `backbone` carries the timm names (`cnn.backbone.*`)."""

    def __init__(self, spec: Sequence[StageSpec] = EFFNETV2_B2_SPEC,
                 stem_channels: int = EFFNETV2_B2_STEM, fuse_ir: bool = False) -> None:
        super().__init__()
        self.backbone = EffNetV2Backbone(spec, stem_channels, fuse_ir=fuse_ir)

    @property
    def out_channels(self) -> int:
        return self.backbone.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)
