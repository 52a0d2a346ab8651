"""One whole MRF stage of the generator: CUDA kernel, entry points and plain version.

Counterpart of `mri2speech_tpu/ops/pallas_mrf.py`: K3a `mrf_stage_pallas_v2`
(:259, compact ``(B, T, C)`` input: every branch starts from the same x) and
K3b `mrf_stage_pallas` (:352, branch-tiled ``(B, T, nb*C)`` input: branch j
starts from its own slice). One kernel, `csrc/mrf_stage.cu`, serves both;
the source says what bounds it.

A stage is ``nb`` ResBlock1 branches (kernels 3/7/11), each ``len(dils)``
units of leaky -> causal dilated conv -> leaky -> causal conv -> residual
add, then the branch mean. The numbers are the TPU kernel's: activations
are rounded to ``mxu_dtype`` right after leaky, just before each product,
the weights are held in ``mxu_dtype``, and the accumulation, bias, residual
and mean are fp32. ``mxu_dtype=torch.float32`` gives the fp32 stage. The
plain version, :func:`mrf_stage_reference`, runs each branch with
``F.conv1d`` on the same rounded operands; it is not the unfused fp32 stack.

The entry points keep the JAX signatures and the ``(B, T, C)`` layout;
``layout="bct"`` takes and returns the generator's ``(B, C, T)`` instead, with
no copy. ``packed`` is the JAX package's per-tap block-diagonal layout
(:func:`pack_mrf_stage_params`), or an :class:`MRFStageWeights`, which holds
the per-branch taps and caches the kernel's layout per operand type and
device, so the conversion stays out of the call. x is fp32 or bf16: the
stage computes in fp32 and returns x's type, as the JAX functions do (the
wrapper casts; the kernel reads and writes fp32).

A CUDA tensor launches the kernel, or raises. A CPU tensor runs the plain
version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from mri2speech_tpu_torch.ops import _build

LRELU_SLOPE = 0.1
MXU_DTYPES = (torch.bfloat16, torch.float32)
IO_DTYPES = (torch.float32, torch.bfloat16)

# Calls of the CUDA kernel per entry point (one per stage, whatever its internal
# launches); the plain version is never counted.
launches = {"mrf_stage_pallas": 0, "mrf_stage_pallas_v2": 0}


def stage_receptive_field(kernels: Sequence[int], dils: Sequence[int]) -> int:
    """Left context consumed by one branch's full unit chain (max over branches)."""
    return max(sum((k - 1) * d + (k - 1) for d in dils) for k in kernels)


def pack_mrf_stage_params(
    resblocks: Sequence[dict], kernels: Sequence[int], dils: Sequence[int]
) -> dict:
    """Per-branch ResBlock1 params -> the JAX per-tap block-diagonal layout.

    resblocks[j] = {"convs1_u": {"w": (k_j, C, C), "b": (C,)}, "convs2_u": ...}
    (the weight-norm-folded JAX layout, (tap, in, out)). Returns, per unit u
    and conv c, "u{u}_c{c}_w" (k_max, nb*C, nb*C), whose tap m holds branch j's
    W_j[k_j-1-m] on diagonal block j while m < k_j, and "u{u}_c{c}_b" (1, nb*C).
    """
    nb = len(kernels)
    k_max = max(kernels)
    C = np.asarray(resblocks[0]["convs1_0"]["w"]).shape[1]
    packed = {}
    for u in range(len(dils)):
        for c, conv_list in ((1, "convs1"), (2, "convs2")):
            w_p = np.zeros((k_max, nb * C, nb * C), np.float32)
            b_p = np.zeros((1, nb * C), np.float32)
            for j, k in enumerate(kernels):
                p = resblocks[j][f"{conv_list}_{u}"]
                w = np.asarray(p["w"], np.float32)
                for m in range(k):
                    w_p[m, j * C:(j + 1) * C, j * C:(j + 1) * C] = w[k - 1 - m]
                b_p[0, j * C:(j + 1) * C] = np.asarray(p["b"], np.float32)
            packed[f"u{u}_c{c}_w"] = w_p
            packed[f"u{u}_c{c}_b"] = b_p
    return packed


def unpack_mrf_stage_params(
    packed: dict, kernels: Sequence[int], dils: Sequence[int]
) -> List[dict]:
    """Inverse of :func:`pack_mrf_stage_params`: W_j[t] = packed[k_j-1-t] on diagonal block j.

    Raises ValueError if an off-diagonal block, or a tap m >= k_j of branch j,
    is non-zero: such a packing is no stage of separate branches.
    """
    nb = len(kernels)
    k_max = max(kernels)
    out: List[dict] = [{} for _ in kernels]
    for u in range(len(dils)):
        for c, conv_list in ((1, "convs1"), (2, "convs2")):
            w_p = np.asarray(packed[f"u{u}_c{c}_w"], np.float32)
            b_p = np.asarray(packed[f"u{u}_c{c}_b"], np.float32).reshape(-1)
            if w_p.ndim != 3 or w_p.shape[0] != k_max or w_p.shape[1] != w_p.shape[2] \
                    or w_p.shape[1] % nb or b_p.shape != (w_p.shape[1],):
                raise ValueError(
                    f"u{u}_c{c}: expected w (k_max={k_max}, nb*C, nb*C) and b (1, nb*C) "
                    f"for nb={nb}, got {w_p.shape} and {b_p.shape}"
                )
            C = w_p.shape[1] // nb
            rest = w_p.copy()
            for j, k in enumerate(kernels):
                blk = slice(j * C, (j + 1) * C)
                out[j][f"{conv_list}_{u}"] = {
                    "w": np.stack([w_p[k - 1 - t, blk, blk] for t in range(k)]),
                    "b": b_p[blk].copy(),
                }
                rest[:k, blk, blk] = 0.0
            if np.any(rest):
                m, r, q = np.argwhere(rest)[0]
                raise ValueError(
                    f"u{u}_c{c}: non-zero entry at tap {m}, row {r}, column {q} outside "
                    f"the diagonal blocks of branches with kernels {tuple(kernels)}"
                )
    return out


class MRFStageWeights:
    """The taps of one stage, per branch, and their kernel layout per operand type.

    weights[u][c][j] is the torch conv weight (C, C, k_j) of unit u, conv c
    (0: the dilated conv, 1: the d=1 conv), branch j; biases[u][c][j] is (C,).
    """

    def __init__(self, weights, biases, kernels: Sequence[int], dils: Sequence[int]) -> None:
        self.kernels = tuple(int(k) for k in kernels)
        self.dils = tuple(int(d) for d in dils)
        self.weights = [[[w.detach().float() for w in per_c] for per_c in per_u]
                        for per_u in weights]
        self.biases = [[[b.detach().float() for b in per_c] for per_c in per_u]
                       for per_u in biases]
        self.channels = int(self.weights[0][0][0].shape[0])
        for u, per_u in enumerate(self.weights):
            for c, per_c in enumerate(per_u):
                for j, w in enumerate(per_c):
                    want = (self.channels, self.channels, self.kernels[j])
                    if tuple(w.shape) != want:
                        raise ValueError(f"unit {u} conv {c} branch {j}: weight "
                                         f"{tuple(w.shape)}, expected {want}")
        if len(self.weights) != len(self.dils):
            raise ValueError(f"{len(self.weights)} units of weights for dilations {self.dils}")
        self._kernel: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def from_resblocks(cls, resblocks: Sequence[dict], kernels, dils) -> "MRFStageWeights":
        """From the JAX per-branch layout {"convs{1,2}_u": {"w": (k, in, out), "b": (C,)}}."""

        def convs(key):  # [u][c][j] of the (k, in, out) -> (out, in, k) weights, or of the biases
            return [[[torch.from_numpy(np.array(
                blk[f"convs{c + 1}_{u}"][key], np.float32).T.copy()) for blk in resblocks]
                for c in range(2)] for u in range(len(dils))]

        return cls(convs("w"), convs("b"), kernels, dils)

    @classmethod
    def from_packed(cls, packed: dict, kernels, dils) -> "MRFStageWeights":
        return cls.from_resblocks(unpack_mrf_stage_params(packed, kernels, dils), kernels, dils)

    def conv(self, u: int, c: int, j: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.weights[u][c][j].to(device), self.biases[u][c][j].to(device)

    def kernel_layout(self, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(taps, biases) as `csrc/mrf_stage.cu` reads them, built once per (dtype, device).

        Taps in ``dtype``, conv q = 2u + c of branch j laid out [m][co][ci] with
        tap m applied to input row t - m*d; biases fp32 (2 * units, nb, C).
        """
        key = (dtype, torch.device(device))
        if key not in self._kernel:
            ws, bs = [], []
            for per_u_w, per_u_b in zip(self.weights, self.biases):
                for per_c_w, per_c_b in zip(per_u_w, per_u_b):
                    for w, b in zip(per_c_w, per_c_b):
                        ws.append(w.flip(-1).permute(2, 0, 1).reshape(-1))
                        bs.append(b)
            self._kernel[key] = (
                torch.cat(ws).to(device=device, dtype=dtype).contiguous(),
                torch.cat(bs).to(device=device, dtype=torch.float32).contiguous(),
            )
        return self._kernel[key]


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if dtype == torch.float32 else t.to(dtype).float()


def _leaky(t: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(t, LRELU_SLOPE)


def mrf_stage_reference(
    xs: Union[torch.Tensor, Sequence[torch.Tensor]],
    weights: MRFStageWeights,
    mxu_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel in the generator's layout.

    xs: one (B, C, T) tensor that every branch starts from, or one per branch.
    Returns the branch mean (B, C, T), fp32.
    """
    nb = len(weights.kernels)
    if isinstance(xs, torch.Tensor):
        xs = [xs] * nb
    acc = None
    for j, k in enumerate(weights.kernels):
        cur = xs[j].float()
        for u, d in enumerate(weights.dils):
            w1, b1 = weights.conv(u, 0, j, cur.device)
            w2, b2 = weights.conv(u, 1, j, cur.device)
            a = F.pad(_round(_leaky(cur), mxu_dtype), (d * (k - 1), 0))
            y = F.conv1d(a, _round(w1, mxu_dtype), b1, dilation=d)
            a = F.pad(_round(_leaky(y), mxu_dtype), (k - 1, 0))
            cur = cur + F.conv1d(a, _round(w2, mxu_dtype), b2)
        acc = cur if acc is None else acc + cur
    return acc * (1.0 / nb)


def _mrf_stage_cuda(name, x, weights, tiled, layout, mxu_dtype, B, C, T):
    nb, nu = len(weights.kernels), len(weights.dils)
    w_flat, b_flat = weights.kernel_layout(mxu_dtype, x.device)
    if layout == "btc":
        out = torch.empty((B, T, C), dtype=torch.float32, device=x.device)
        (xb, xt, xc), (ob, ot, oc) = x.stride(), out.stride()
    else:
        out = torch.empty((B, C, T), dtype=torch.float32, device=x.device)
        (xb, xc, xt), (ob, oc, ot) = x.stride(), out.stride()
    xj = C * xc if tiled else 0
    if T == 0:
        return out
    # fp32 scratch: the branches' residual streams and the dilated convs' outputs. It may
    # be freed on return while the kernels still run: the caching allocator hands it only
    # to work queued later on this stream
    cur = torch.empty((nb, B, C, T), dtype=torch.float32, device=x.device)
    y = torch.empty_like(cur)
    fn = _build.load("mrf_stage").mrf_stage_f32
    int_p = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 4
        + [int_p, ctypes.c_int, int_p, ctypes.c_int] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    ks = (ctypes.c_int * nb)(*weights.kernels)
    ds = (ctypes.c_int * nu)(*weights.dils)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), xb, xj, xc, xt, out.data_ptr(), ob, oc, ot,
            cur.data_ptr(), y.data_ptr(), w_flat.data_ptr(), b_flat.data_ptr(),
            ks, nb, ds, nu, B, C, T, int(mxu_dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    launches[name] += 1
    return out


def _mrf_stage(name, x, packed, channels, kernels, dils, mxu_dtype, layout, tiled):
    kernels, dils = tuple(int(k) for k in kernels), tuple(int(d) for d in dils)
    weights = (packed if isinstance(packed, MRFStageWeights)
               else MRFStageWeights.from_packed(packed, kernels, dils))
    if (weights.kernels, weights.dils, weights.channels) != (kernels, dils, channels):
        raise ValueError(
            f"weights are for kernels {weights.kernels}, dilations {weights.dils}, "
            f"{weights.channels} channels; called with {kernels}, {dils}, {channels}"
        )
    if mxu_dtype not in MXU_DTYPES:
        raise TypeError(f"mxu_dtype must be torch.bfloat16 or torch.float32, got {mxu_dtype}")
    if layout not in ("btc", "bct"):
        raise ValueError(f"layout must be 'btc' or 'bct', got {layout!r}")
    if x.dtype not in IO_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    nb, C = len(kernels), channels
    width = nb * C if tiled else C
    if x.dim() != 3 or x.shape[2 if layout == "btc" else 1] != width:
        want = "(B, T, {0})" if layout == "btc" else "(B, {0}, T)"
        raise ValueError(f"x must be {want.format(width)}, got {tuple(x.shape)}")
    B, T = x.shape[0], x.shape[1 if layout == "btc" else 2]
    if x.is_cuda:
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        y = _mrf_stage_cuda(name, x.float(), weights, tiled, layout, mxu_dtype, B, C, T)
        return y.to(x.dtype)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    xt = x.transpose(1, 2) if layout == "btc" else x  # (B, width, T)
    xs = [xt[:, j * C:(j + 1) * C] for j in range(nb)] if tiled else xt
    y = mrf_stage_reference(xs, weights, mxu_dtype).to(x.dtype)
    return y.transpose(1, 2).contiguous() if layout == "btc" else y


def mrf_stage_pallas_v2(
    x: torch.Tensor,
    packed,
    *,
    channels: int,
    kernels: Tuple[int, ...] = (3, 7, 11),
    dils: Tuple[int, ...] = (1, 3, 5),
    mxu_dtype: torch.dtype = torch.bfloat16,
    layout: str = "btc",
) -> torch.Tensor:
    """K3a: (B, T, C) -> (B, T, C), every branch starting from x (layout="bct": (B, C, T))."""
    return _mrf_stage("mrf_stage_pallas_v2", x, packed, channels, kernels, dils, mxu_dtype,
                      layout, tiled=False)


def mrf_stage_pallas(
    x: torch.Tensor,
    packed,
    *,
    channels: int,
    kernels: Tuple[int, ...] = (3, 7, 11),
    dils: Tuple[int, ...] = (1, 3, 5),
    mxu_dtype: torch.dtype = torch.bfloat16,
    layout: str = "btc",
) -> torch.Tensor:
    """K3b: branch-tiled (B, T, nb*C) -> branch mean (B, T, C).

    layout="bct": (B, nb*C, T) -> (B, C, T).
    """
    return _mrf_stage("mrf_stage_pallas", x, packed, channels, kernels, dils, mxu_dtype,
                      layout, tiled=True)
