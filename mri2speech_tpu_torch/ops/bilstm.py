"""Fused bidirectional LSTM recurrence: CUDA kernel and its plain version.

Counterpart of `mri2speech_tpu/ops/pallas_lstm.py` (the serving path's
`bilstm_sum_pallas` -> `bilstm_recurrence_pallas_chunked`). The kernel is
`csrc/bilstm_recurrence.cu`; the source says what bounds it.

Masking is the TPU kernel's gate freeze (`pallas_lstm.py:64-78`): on padded
steps the pre-activations are overwritten with (i, f, g, o) = (-30, +30, 0,
-30) before the recurrence. Real frames are then exact. Padded positions are
not held: the forward cell still adds ``h @ w_hh`` there, and the backward
cell, which meets the trailing padding first, stays at exact zero. The plain
version computes the same thing, not the scan's hold semantics
(`models/lstm.py::lstm_direction`), because the mels at padded frames reach
the last real frames of audio through the generator's right context.

A CUDA tensor launches the kernel, or raises. A CPU tensor runs
:func:`bilstm_recurrence_reference`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mri2speech_tpu_torch.ops import _build

GATE_FREEZE = (-30.0, 30.0, 0.0, -30.0)  # (i, f, g, o) pre-activations

# Calls of the CUDA kernel (one per BiLSTM, whatever T); never counts the
# plain version.
launches = 0


def freeze_padded_steps(xg: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Overwrite the pre-activations of padded steps; xg (T, B, 4H), mask (T, B) 1=valid."""
    if mask is None:
        return xg
    H = xg.shape[-1] // 4
    row = torch.tensor(GATE_FREEZE, dtype=xg.dtype, device=xg.device).repeat_interleave(H)
    return torch.where((mask > 0)[..., None], xg, row)


def _cell(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def bilstm_recurrence_reference(
    xg_f: torch.Tensor, xg_b: torch.Tensor, w_hh_f: torch.Tensor, w_hh_b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel on already-frozen streams.

    xg_* (T, B, 4H), w_hh_* (H, 4H) -> h (T, B, H) per direction.
    """
    T, B, G = xg_f.shape
    H = G // 4
    out_f = xg_f.new_empty((T, B, H))
    out_b = xg_b.new_empty((T, B, H))
    h_f = c_f = h_b = c_b = xg_f.new_zeros((B, H))
    for s in range(T):
        tb = T - 1 - s
        h_f, c_f = _cell(xg_f[s] + h_f @ w_hh_f, c_f)
        h_b, c_b = _cell(xg_b[tb] + h_b @ w_hh_b, c_b)
        out_f[s] = h_f
        out_b[tb] = h_b
    return out_f, out_b


def _check_cuda_inputs(xg_f, xg_b, w_f, w_b) -> None:
    T, B, G = xg_f.shape
    H = G // 4
    for name, x, shape in (
        ("xg_f", xg_f, (T, B, G)), ("xg_b", xg_b, (T, B, G)),
        ("w_hh_f^T", w_f, (G, H)), ("w_hh_b^T", w_b, (G, H)),
    ):
        if x.device != xg_f.device:
            raise ValueError(f"{name} is on {x.device}, expected {xg_f.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _bilstm_recurrence_cuda(xg_f, xg_b, w_hh_f, w_hh_b):
    global launches
    T, B, G = xg_f.shape
    H = G // 4
    # the kernel reads w_hh as (4H, H) rows; free when w_hh is the transposed
    # view of an nn.LSTM-layout weight, as BiLSTMSumMerge passes it
    w_f = w_hh_f.t().contiguous()
    w_b = w_hh_b.t().contiguous()
    _check_cuda_inputs(xg_f, xg_b, w_f, w_b)
    fn = _build.load("bilstm_recurrence").bilstm_recurrence_f32
    # 7 device pointers, T, B, H, the stream
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out_f = torch.empty((T, B, H), dtype=torch.float32, device=xg_f.device)
    out_b = torch.empty_like(out_f)
    # scratch and inputs may be freed on return while the kernels still run:
    # the caching allocator hands them only to work queued later on this stream
    c_state = torch.empty((2, B, H), dtype=torch.float32, device=xg_f.device)
    if T == 0:
        return out_f, out_b
    with torch.cuda.device(xg_f.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            xg_f.data_ptr(), xg_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
            out_f.data_ptr(), out_b.data_ptr(), c_state.data_ptr(), T, B, H, stream,
        )
    if err != 0:
        raise RuntimeError(f"bilstm_recurrence kernel launch failed: cudaError {err}")
    launches += 1
    return out_f, out_b


def bilstm_recurrence(
    xg_f: torch.Tensor,
    xg_b: torch.Tensor,
    w_hh_f: torch.Tensor,
    w_hh_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both LSTM directions over (T, B, 4H) pre-activations -> (T, B, H) each.

    w_hh_* (H, 4H) in the JAX layout, gate order (i, f, g, o); mask (T, B),
    1 = valid, applied as the gate freeze. Forward output t is the forward
    cell after time t; backward output t the backward cell after time t.
    """
    if xg_f.dim() != 3 or xg_f.shape[-1] % 4:
        raise ValueError(f"xg must be (T, B, 4H), got {tuple(xg_f.shape)}")
    xg_f = freeze_padded_steps(xg_f, mask)
    xg_b = freeze_padded_steps(xg_b, mask)
    if xg_f.is_cuda:
        return _bilstm_recurrence_cuda(xg_f.contiguous(), xg_b.contiguous(), w_hh_f, w_hh_b)
    if xg_f.device.type != "cpu":
        raise ValueError(f"unsupported device {xg_f.device}")
    return bilstm_recurrence_reference(xg_f, xg_b, w_hh_f, w_hh_b)


def bilstm_sum(
    x: torch.Tensor, params: dict, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Full BiLSTM-sum forward: (B, T, C) -> (B, T, H).

    params: {w_ih_fwd (C, 4H), w_hh_fwd (H, 4H), b_fwd (4H,), and *_bwd} in the
    `models/lstm.py` layout; mask (B, T). Both input projections run as
    matmuls outside the recurrence.
    """
    xg_f = torch.matmul(x, params["w_ih_fwd"]) + params["b_fwd"]
    xg_b = torch.matmul(x, params["w_ih_bwd"]) + params["b_bwd"]
    m = None if mask is None else mask.transpose(0, 1)
    ys_f, ys_b = bilstm_recurrence(
        xg_f.transpose(0, 1), xg_b.transpose(0, 1),
        params["w_hh_fwd"], params["w_hh_bwd"], m,
    )
    return (ys_f + ys_b).transpose(0, 1)
