"""One fused stride-1 SE-MBConv block: CUDA kernel, entry point and plain version.

Counterpart of `mri2speech_tpu/ops/pallas_mbconv.py` (K4,
`mbconv_block_pallas` :128). The kernel is `csrc/mbconv_block.cu`; the
source says what bounds it.

The block, with BatchNorm folded (:func:`fold_bn`, eps 1e-3, in the JAX
package's order, so the rounded weights match it bit for bit):

    a = SiLU(x @ w1 + b1) -> d = SiLU(depthwise3x3(a) + bd)
      -> g = sigmoid(SiLU(mean_hw(d) @ wr + br) @ we + be) -> x + (d * g) @ w3 + b3

Where JAX rounds to ``mxu_dtype`` the port rounds: x before the expansion,
the per-frame mean and the SE hidden before the SE products, d * g before
the projection. The depthwise taps, every elementwise step and the residual
(the unrounded x) stay fp32. ``mxu_dtype=torch.float32`` gives the fp32
block.

:func:`mbconv_block_pallas` keeps the JAX signature and the (N, H, W, C)
layout; ``layout="nchw"`` takes and returns the backbone's (N, C, H, W)
with no copy. ``params`` is the JAX package's folded dict (w1 (C, E), b1,
wd (3, 3, E), bd, wr (E, R), br, we (R, E), be, w3 (E, C), b3) or an
:class:`MBConvWeights`, which caches the kernel's operands per type and
device. Input and output are fp32.

A CUDA tensor launches the kernel, or raises. A CPU tensor runs
:func:`mbconv_block_reference`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mri2speech_tpu_torch.ops import _build

MXU_DTYPES = (torch.bfloat16, torch.float32)
NAMES = ("w1", "b1", "wd", "bd", "wr", "br", "we", "be", "w3", "b3")
PRODUCT_WEIGHTS = ("w1", "wr", "we", "w3")  # held in the operand type
MAX_PIXELS = 256  # pixels of a frame the kernel's first pass holds in one block

# Calls of the CUDA kernel (one per block, whatever its internal launches);
# the plain version is never counted.
launches = 0


def fold_bn(scale, bias, mean, var, eps: float = 1e-3):
    """BatchNorm (inference) -> (mul, add) with y = x * mul + add.

    The square root is taken in float64 and rounded once: that is the
    correctly rounded fp32 root XLA computes, where torch's fp32 sqrt on
    the CPU can be one ulp off, and it keeps the folded weights bit-equal.
    """
    mul = scale / torch.sqrt((var + eps).double()).float()
    return mul, bias - mean * mul


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


@dataclasses.dataclass
class MBConvWeights:
    """One block's BN-folded weights, fp32, in the kernel's layout.

    w1 (E, C), b1 (E), wd (9, E) with tap dh*3 + dw, bd (E), wr (R, E),
    br (R), we (E, R), be (E), w3 (C, E), b3 (C).
    """

    w1: torch.Tensor
    b1: torch.Tensor
    wd: torch.Tensor
    bd: torch.Tensor
    wr: torch.Tensor
    br: torch.Tensor
    we: torch.Tensor
    be: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    _operands: Dict[tuple, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def dims(self) -> Tuple[int, int, int]:
        """(C, E, R)."""
        return self.w1.shape[1], self.w1.shape[0], self.wr.shape[0]

    @classmethod
    def from_jax(cls, params: dict) -> "MBConvWeights":
        """From the JAX package's folded dict (`pallas_mbconv.py:141-144` layout)."""
        p = {k: _t(v) for k, v in params.items()}
        E = p["w1"].shape[1]
        return cls(
            w1=p["w1"].t().contiguous(), b1=p["b1"].reshape(-1),
            wd=p["wd"].reshape(9, E), bd=p["bd"].reshape(-1),
            wr=p["wr"].t().contiguous(), br=p["br"].reshape(-1),
            we=p["we"].t().contiguous(), be=p["be"].reshape(-1),
            w3=p["w3"].t().contiguous(), b3=p["b3"].reshape(-1),
        )

    @classmethod
    def from_block(cls, block) -> "MBConvWeights":
        """Fold the BatchNorms of an `InvertedResidual`-shaped module (conv_pw, bn1,
        conv_dw, bn2, se.conv_reduce/conv_expand, conv_pwl, bn3)."""

        def bn(m):
            return fold_bn(m.weight, m.bias, m.running_mean, m.running_var, m.eps)

        with torch.no_grad():
            m1, a1 = bn(block.bn1)
            m2, a2 = bn(block.bn2)
            m3, a3 = bn(block.bn3)
            E, C = block.conv_pw.weight.shape[:2]
            R = block.se.conv_reduce.weight.shape[0]
            return cls(
                w1=block.conv_pw.weight.reshape(E, C) * m1[:, None], b1=a1,
                wd=(block.conv_dw.weight.reshape(E, 9) * m2[:, None]).t().contiguous(), bd=a2,
                wr=block.se.conv_reduce.weight.reshape(R, E).detach(),
                br=block.se.conv_reduce.bias.detach(),
                we=block.se.conv_expand.weight.reshape(E, R).detach(),
                be=block.se.conv_expand.bias.detach(),
                w3=block.conv_pwl.weight.reshape(C, E) * m3[:, None], b3=a3,
            )

    def operands(self, dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
        """The kernel's arguments, built once per (dtype, device): the product
        weights (w1, wr, we, w3) in ``dtype``, the rest fp32, all contiguous."""
        key = (dtype, torch.device(device))
        if key not in self._operands:
            self._operands[key] = {
                name: getattr(self, name).to(
                    device=device, dtype=dtype if name in PRODUCT_WEIGHTS else torch.float32
                ).contiguous()
                for name in NAMES
            }
        return self._operands[key]


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if dtype == torch.float32 else t.to(dtype).float()


def mbconv_block_reference(
    x: torch.Tensor, w: MBConvWeights, mxu_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N, C, H, W) -> (N, C, H, W), fp32."""
    N, C, H, W = x.shape
    E = w.w1.shape[0]
    p = {k: getattr(w, k).to(x.device) for k in NAMES}
    x0 = x.float()
    a = torch.matmul(_round(p["w1"], mxu_dtype), _round(x0, mxu_dtype).reshape(N, C, H * W))
    a = F.silu(a + p["b1"][:, None]).reshape(N, E, H, W)
    d = F.conv2d(a, p["wd"].t().reshape(E, 1, 3, 3), p["bd"], padding=1, groups=E)
    d = F.silu(d)
    s = d.mean(dim=(2, 3))
    g = F.silu(_round(s, mxu_dtype) @ _round(p["wr"], mxu_dtype).t() + p["br"])
    g = torch.sigmoid(_round(g, mxu_dtype) @ _round(p["we"], mxu_dtype).t() + p["be"])
    dg = _round(d * g[:, :, None, None], mxu_dtype).reshape(N, E, H * W)
    y = torch.matmul(_round(p["w3"], mxu_dtype), dg) + p["b3"][:, None]
    return x0 + y.reshape(N, C, H, W)


def _mbconv_block_cuda(x, w: MBConvWeights, mxu_dtype, layout):
    global launches
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if layout == "nhwc":
        N, H, W, C = x.shape
    else:
        N, C, H, W = x.shape
    _, E, R = w.dims
    HW = H * W
    if HW % 32 or HW > MAX_PIXELS:
        raise ValueError(f"the kernel takes frames of H*W <= {MAX_PIXELS} pixels, a multiple "
                         f"of 32; got {H}x{W}")
    out = torch.empty_like(x)
    if N == 0:
        return out
    ops = w.operands(mxu_dtype, x.device)
    # fp32 scratch: the depthwise output and the per-frame channel means (freed on return
    # while the kernels may still run: the caching allocator reuses it only for work queued
    # later on this stream)
    d = torch.empty((N, E, HW), dtype=torch.float32, device=x.device)
    s = torch.empty((N, E), dtype=torch.float32, device=x.device)
    if layout == "nhwc":
        strides = (x.stride(0), x.stride(3), x.stride(2))  # (n, c, p = h*W + w)
    else:
        strides = (x.stride(0), x.stride(1), x.stride(3))
    fn = _build.load("mbconv_block").mbconv_block_f32
    fn.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), *strides, out.data_ptr(), *strides,
            *(ops[k].data_ptr() for k in NAMES),
            d.data_ptr(), s.data_ptr(), N, H, W, C, E, R,
            int(mxu_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"mbconv_block kernel launch failed: cudaError {err}")
    launches += 1
    return out


def mbconv_block_pallas(
    x: torch.Tensor,
    params,
    *,
    mxu_dtype: torch.dtype = torch.bfloat16,
    layout: str = "nhwc",
) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W, C): one fused stride-1 SE-MBConv block.

    layout="nchw": (N, C, H, W) in and out.
    """
    w = params if isinstance(params, MBConvWeights) else MBConvWeights.from_jax(params)
    if mxu_dtype not in MXU_DTYPES:
        raise TypeError(f"mxu_dtype must be torch.bfloat16 or torch.float32, got {mxu_dtype}")
    if layout not in ("nhwc", "nchw"):
        raise ValueError(f"layout must be 'nhwc' or 'nchw', got {layout!r}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    C, E, R = w.dims
    if x.dim() != 4 or x.shape[3 if layout == "nhwc" else 1] != C:
        raise ValueError(f"x must be {layout.upper()} with C={C}, got {tuple(x.shape)}")
    if x.is_cuda:
        return _mbconv_block_cuda(x, w, mxu_dtype, layout)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    if layout == "nchw":
        return mbconv_block_reference(x, w, mxu_dtype)
    y = mbconv_block_reference(x.permute(0, 3, 1, 2), w, mxu_dtype)
    return y.permute(0, 2, 3, 1).contiguous()
