"""One fused stride-1 SE-MBConv block: CUDA kernel, entry point and plain version.

Counterpart of `mri2speech_tpu/ops/pallas_mbconv.py` (K4,
`mbconv_block_pallas` :128). The kernel is `csrc/mbconv_block.cu`; the
source says what bounds it and how it is laid out. Its tile plan, which
pixels each CTA owns and how launch 1 splits E, is chosen here
(:func:`tile_plan`), so the CPU tests reach it.

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
device. x is fp32 or bf16; the block computes in fp32 and returns x's type,
as the JAX function does (the residual adds the unrounded x).

A CUDA tensor launches the kernel, or raises. A CPU tensor runs
:func:`mbconv_block_reference`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mri2speech_tpu_torch.ops import _build

MXU_DTYPES = (torch.bfloat16, torch.float32)
NAMES = ("w1", "b1", "wd", "bd", "wr", "br", "we", "be", "w3", "b3")
PRODUCT_WEIGHTS = ("w1", "wr", "we", "w3")  # held in the operand type
KERNEL_OPERANDS = ("w1", "vec", "wr", "br", "we", "be", "w3", "b3")  # the C entry's order
IO_DTYPES = (torch.float32, torch.bfloat16)

# The kernel's tiling (csrc/mbconv_block.cu), mirrored for the tile plan.
SMS = 132              # streaming multiprocessors of an H100 SXM: one wave of CTAs
THREADS = 512          # 16 warps
M_CAP = 256            # pw rows (owned pixels + halo) of a CTA: 8 warps x 2 blocks of 16
MAX_C = 256            # the projection's (pixels x C) accumulator lives in registers
SMEM_LIMIT = 232448    # shared memory a block may use
CHUNK = {torch.bfloat16: 64, torch.float32: 32}  # E channels per chunk (bf16: wgmma; fp32: FMAs)
CTA_OVERHEAD = 32      # tile plan cost of a CTA beyond its pixels (weights, SE gate), in pixels

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
    _pointers: Dict[tuple, Tuple[int, ...]] = dataclasses.field(
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
        """The kernel's arguments, built once per (dtype, device), all contiguous:
        the product weights (w1, wr, we, w3) in ``dtype``, the rest fp32.

        w1 and w3 are laid out as the kernel streams them, one E chunk (EC
        channels) per bulk copy, each chunk already in the kernel's shared
        layout (csrc/mbconv_block.cu Layout<T>): w1 as Ep / EC chunks of EC
        rows x Kp, w3 as Ep / EC chunks of Cw rows x EC, zero-padded (Kp = C
        rounded up to 16, Ep = E rounded up to whole chunks, Cw = the
        projection's columns). ``vec`` holds each chunk's taps, bd and b1
        (Ep / EC, 11, EC); we is transposed to (R, E). wd, bd and b1 stay as
        they are too.
        """
        key = (dtype, torch.device(device))
        if key not in self._operands:
            C, E, _ = self.dims
            ec = CHUNK[dtype]
            kp, ep, cw = _round_up(C, 16), _round_up(E, ec), _projection_columns(C)
            nch = ep // ec
            w1 = F.pad(self.w1, (0, kp - C, 0, ep - E)).reshape(nch, ec, kp)
            w3 = F.pad(self.w3, (0, ep - E, 0, cw - C)).reshape(cw, nch, ec).transpose(0, 1)
            vec = torch.cat([F.pad(self.wd, (0, ep - E)).reshape(9, nch, ec).transpose(0, 1),
                             F.pad(self.bd, (0, ep - E)).reshape(nch, 1, ec),
                             F.pad(self.b1, (0, ep - E)).reshape(nch, 1, ec)], dim=1)
            layout = {"w1": _shared_layout(w1, dtype), "w3": _shared_layout(w3, dtype),
                      "we": self.we.t(), "vec": vec}
            self._operands[key] = {
                name: layout.get(name, getattr(self, name, None)).to(
                    device=device, dtype=dtype if name in PRODUCT_WEIGHTS else torch.float32
                ).contiguous()
                for name in NAMES + ("vec",)
            }
        return self._operands[key]

    def operand_pointers(self, dtype: torch.dtype, device: torch.device) -> Tuple[int, ...]:
        """Device addresses of :meth:`operands` in the C entry's order (cached with them)."""
        key = (dtype, device)
        ptrs = self._pointers.get(key)
        if ptrs is None:
            ops = self.operands(dtype, device)
            ptrs = self._pointers[key] = tuple(ops[k].data_ptr() for k in KERNEL_OPERANDS)
        return ptrs


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _projection_columns(C: int) -> int:
    """Cw: the projection's output columns, C rounded up to 64, 128 or 256 (the w3 tile rows)."""
    kp = _round_up(C, 16)
    return 64 if kp <= 64 else 128 if kp <= 128 else 256


def _shared_layout(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(chunks, rows, K) in the kernel's shared layout: bf16 in wgmma's core matrices
    (8 rows x 8 of K contiguous, the core matrices of 8 rows side by side along K);
    fp32 row-major with rows K + 4 apart."""
    n, rows, k = t.shape
    if dtype == torch.bfloat16:
        return t.reshape(n, rows // 8, 8, k // 8, 8).permute(0, 1, 3, 2, 4)
    return F.pad(t, (0, 4))


def _extent(size: int, t: int) -> int:
    """Largest pw extent along an axis of ``size`` cut into tiles of ``t``: a tile plus
    its 1-pixel halo, clipped to the frame."""
    return max(min(s + t + 1, size) - max(s - 1, 0) for s in range(0, size, t))


def owned_cap(C: int) -> int:
    """Most pixels a CTA of launch 3 may own: its (pixels x Cw) projection accumulator
    is at most 32 fp32 registers a thread."""
    cp = _round_up(C, 16)
    return 256 if cp <= 64 else 128 if cp <= 128 else 64


def smem_bytes(th: int, tw: int, H: int, W: int, C: int, E: int, R: int,
               mxu_dtype: torch.dtype, project: bool) -> int:
    """Shared memory of launch 1 (pool) or 3 (project) for tiles th x tw (see the kernel's Smem).

    Operand tiles (rows x K): bf16 in wgmma's core-matrix layout, rows padded to
    64; fp32 rows K + 4 apart, padded to 16.
    """
    ec = CHUNK[mxu_dtype]
    bf16 = mxu_dtype == torch.bfloat16
    size, row_pad, k_pad = (2, 64, 0) if bf16 else (4, 16, 4)
    kp, cw = _round_up(C, 16), _projection_columns(C)
    mext = _round_up(_extent(H, th) * _extent(W, tw), row_pad)
    tile = lambda rows, k: rows * (k + k_pad)  # noqa: E731
    n = 16 + size * (tile(mext, kp) + 2 * tile(ec, kp)) + 4 * (
        2 * 12 * ec + (th + 2) * (tw + 2) * (ec + 8) + 2 * mext)
    if project:
        return n + size * (2 * tile(cw, ec) + tile(_round_up(th * tw, row_pad), ec))
    return n + 4 * 2 * THREADS


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How a launch of the kernel cuts N frames of H x W: owned rectangles of th
    x tw pixels (the last row and column of tiles may be smaller), one CTA each
    per E part, E in ``e_splits`` parts (launch 1 only; launch 3 has 1)."""

    H: int
    W: int
    th: int
    tw: int
    e_splits: int

    @property
    def tiles(self) -> int:
        return -(-self.H // self.th) * -(-self.W // self.tw)

    def rectangles(self) -> List[Tuple[Tuple[int, int, int, int], Tuple[int, int, int, int]]]:
        """Per tile, in the kernel's order: the owned (h0, w0, th, tw) and the pw
        rectangle (row, column, height, width): owned + 1-pixel halo, clipped."""
        out = []
        for h0 in range(0, self.H, self.th):
            for w0 in range(0, self.W, self.tw):
                th, tw = min(self.th, self.H - h0), min(self.tw, self.W - w0)
                r0, c0 = max(h0 - 1, 0), max(w0 - 1, 0)
                out.append(((h0, w0, th, tw),
                            (r0, c0, min(h0 + th + 1, self.H) - r0, min(w0 + tw + 1, self.W) - c0)))
        return out


@functools.lru_cache(maxsize=None)
def tile_plan(N: int, H: int, W: int, C: int, E: int, R: int,
              mxu_dtype: torch.dtype = torch.bfloat16, pool: bool = False) -> TilePlan:
    """The tiles that fill the card best for N frames of H x W, for launch 3
    (project) or, with ``pool``, launch 1.

    Every rectangle th x tw that the launch takes (pw rows <= M_CAP, shared
    memory within SMEM_LIMIT, and for launch 3 owned pixels <= owned_cap(C)) is
    costed as waves of SMS CTAs x the E chunks a CTA runs x one chunk's work
    (pw rows + owned pixels + CTA_OVERHEAD); the cheapest wins, and of equal
    costs the one with fewer CTAs. Launch 1, which has no projection, may own a
    whole frame and splits E across CTAs until its grid fills one wave.
    """
    if C > MAX_C:
        raise ValueError(f"the kernel takes C <= {MAX_C}, got {C}")
    if 4 * (E + R) > SMEM_LIMIT:
        raise ValueError(f"the kernel's SE gate takes E + R <= {SMEM_LIMIT // 4}, got {E + R}")
    cap = M_CAP if pool else owned_cap(C)
    chunks = -(-E // CHUNK[mxu_dtype])
    best = None
    for th in range(1, H + 1):
        ext_h = _extent(H, th)
        for tw in range(1, W + 1):
            ext = ext_h * _extent(W, tw)
            if th * tw > cap or ext > M_CAP:
                continue
            if smem_bytes(th, tw, H, W, C, E, R, mxu_dtype, not pool) > SMEM_LIMIT:
                continue
            ctas = max(N, 1) * -(-H // th) * -(-W // tw)
            splits = max(1, min(chunks, SMS // ctas)) if pool else 1
            cost = (-(-ctas * splits // SMS) * -(-chunks // splits)
                    * (_round_up(ext, 16) + _round_up(th * tw, 16) + CTA_OVERHEAD))
            if best is None or (cost, ctas) < best[0]:
                best = ((cost, ctas), th, tw, splits)
    if best is None:
        raise ValueError(f"no tile of a {H}x{W} frame fits the kernel at C={C}, E={E}, R={R}")
    _, th, tw, splits = best
    return TilePlan(H, W, th, tw, splits)


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if dtype == torch.float32 else t.to(dtype).float()


def mbconv_block_reference(
    x: torch.Tensor, w: MBConvWeights, mxu_dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (N, C, H, W) -> (N, C, H, W), fp32 (x fp32 or bf16)."""
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


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry `mbconv_block`, built and typed once."""
    fn = _build.load("mbconv_block").mbconv_block
    fn.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p]
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return fn


def _mbconv_block_cuda(x, w: MBConvWeights, mxu_dtype, layout):
    global launches
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if layout == "nhwc":
        N, H, W, C = x.shape
    else:
        N, C, H, W = x.shape
    _, E, R = w.dims
    out = torch.empty_like(x)
    if N == 0:
        return out
    plan = tile_plan(N, H, W, C, E, R, mxu_dtype)
    pool = tile_plan(N, H, W, C, E, R, mxu_dtype, pool=True)
    device = x.device
    # fp32 scratch: per-tile channel sums of d (launch 1's tiles, launch 1 -> 2), then at a 16-byte aligned
    # offset each frame's SE gate (N, Ep) (launch 2 -> 3). Freed on return while the kernels
    # may still run: the caching allocator reuses it only for work queued later on this stream
    n_part = _round_up(N * pool.tiles * E, 4)
    scratch = torch.empty(n_part + N * _round_up(E, CHUNK[mxu_dtype]), dtype=torch.float32,
                          device=device)
    if layout == "nhwc":
        strides = (x.stride(0), x.stride(3), x.stride(2))  # (n, c, p = h*W + w)
    else:
        strides = (x.stride(0), x.stride(1), x.stride(3))
    base = scratch.data_ptr()
    args = (x.data_ptr(), *strides, out.data_ptr(), *strides,
            *w.operand_pointers(mxu_dtype, device), base, base + 4 * n_part,
            N, H, W, C, E, R, plan.th, plan.tw, pool.th, pool.tw, pool.e_splits,
            int(mxu_dtype == torch.bfloat16), int(x.dtype == torch.bfloat16))
    fn = _entry()
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
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

    layout="nchw": (N, C, H, W) in and out. x fp32 or bf16; the output takes x's type.
    """
    w = params if isinstance(params, MBConvWeights) else MBConvWeights.from_jax(params)
    if mxu_dtype not in MXU_DTYPES:
        raise TypeError(f"mxu_dtype must be torch.bfloat16 or torch.float32, got {mxu_dtype}")
    if layout not in ("nhwc", "nchw"):
        raise ValueError(f"layout must be 'nhwc' or 'nchw', got {layout!r}")
    if x.dtype not in IO_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    C, E, R = w.dims
    if x.dim() != 4 or x.shape[3 if layout == "nhwc" else 1] != C:
        raise ValueError(f"x must be {layout.upper()} with C={C}, got {tuple(x.shape)}")
    if x.is_cuda:
        return _mbconv_block_cuda(x, w, mxu_dtype, layout)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    if layout == "nchw":
        return mbconv_block_reference(x, w, mxu_dtype).to(x.dtype)
    y = mbconv_block_reference(x.permute(0, 3, 1, 2), w, mxu_dtype)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
