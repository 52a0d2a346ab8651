"""LSTM recurrences: one CUDA kernel, its entry points and their plain version.

Counterparts of `mri2speech_tpu/ops/pallas_lstm.py`, all on one kernel,
`csrc/bilstm_recurrence.cu` (the source says what bounds it):

* K1 `bilstm_recurrence_pallas_chunked` (:304), the serving path's BiLSTM
  -> :func:`bilstm_recurrence`;
* K2b `bilstm_recurrence_pallas` (:167) -> :func:`bilstm_recurrence_pallas`,
  the same function (the chunking of K1 is a TPU detail);
* K2a `lstm_recurrence_pallas` (:82), one direction -> :func:`lstm_recurrence_pallas`,
  and `lstm_direction_pallas` (:408) on top of it;
* the scan of `models/lstm.py::lstm_direction` (hold mask, seed state, final
  state), which online streaming runs -> :func:`lstm_recurrence`.

Masking. K1, K2a and K2b take the TPU kernels' gate freeze
(`pallas_lstm.py:64-78`): on padded steps the pre-activations are
overwritten with (i, f, g, o) = (-30, +30, 0, -30) before the recurrence.
Real frames are then exact. Padded positions are not held: the forward cell
still adds ``h @ w_hh`` there, and a backward cell that meets the trailing
padding first stays at exact zero. The serving path wants exactly that,
because the mels at padded frames reach the last real frames of audio
through the generator's right context. :func:`lstm_recurrence` holds
instead: a padded step keeps (h, c) and writes the held h, as the scan does.

Types. ``xg`` is fp32 or bf16; the recurrence runs in fp32 and the outputs
come back in ``xg``'s type, as the JAX functions do (`pallas_lstm.py:104-106`,
`:185-188`, `:324-327`). ``w_hh`` is taken as fp32.

A CUDA tensor launches the kernel, or raises. A CPU tensor runs the plain
version, :func:`lstm_recurrence_reference` (one direction per call).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mri2speech_tpu_torch.ops import _build

GATE_FREEZE = (-30.0, 30.0, 0.0, -30.0)  # (i, f, g, o) pre-activations
XG_DTYPES = (torch.float32, torch.bfloat16)

# Calls of the CUDA kernel per C entry point (one per call, whatever T): both
# directions, `bilstm_recurrence_f32` (K1, K2b), and one direction,
# `lstm_recurrence_f32` (K2a, the hold route). The plain version is never counted.
launches = {"bilstm_recurrence": 0, "lstm_recurrence": 0}

State = Tuple[torch.Tensor, torch.Tensor]


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


def lstm_recurrence_reference(
    xg: torch.Tensor,
    w_hh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
    h0: Optional[torch.Tensor] = None,
    c0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, State]:
    """Plain PyTorch version of one direction of the kernel.

    xg (T, B, 4H) (already frozen, in freeze mode), w_hh (H, 4H). mask (T, B),
    1 = valid, holds (h, c) on padded steps (None: every step runs); h0, c0
    (B, H) seed the state (None: zeros). Returns (out (T, B, H), (h_T, c_T)).
    """
    T, B, G = xg.shape
    H = G // 4
    out = xg.new_empty((T, B, H))
    h = xg.new_zeros((B, H)) if h0 is None else h0
    c = xg.new_zeros((B, H)) if c0 is None else c0
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h1, c1 = _cell(xg[t] + h @ w_hh, c)
        if mask is None:
            h, c = h1, c1
        else:
            valid = (mask[t] > 0)[:, None]
            h, c = torch.where(valid, h1, h), torch.where(valid, c1, c)
        out[t] = h
    return out, (h, c)


def bilstm_recurrence_reference(
    xg_f: torch.Tensor, xg_b: torch.Tensor, w_hh_f: torch.Tensor, w_hh_b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of both directions on already-frozen streams.

    xg_* (T, B, 4H), w_hh_* (H, 4H) -> h (T, B, H) per direction.
    """
    out_f, _ = lstm_recurrence_reference(xg_f, w_hh_f)
    out_b, _ = lstm_recurrence_reference(xg_b, w_hh_b, reverse=True)
    return out_f, out_b


def _check_xg(*xgs: torch.Tensor) -> torch.dtype:
    """Check the xg streams; their common type, which the outputs come back in."""
    for x in xgs:
        if x.dim() != 3 or x.shape[-1] % 4:
            raise ValueError(f"xg must be (T, B, 4H), got {tuple(x.shape)}")
        if x.dtype not in XG_DTYPES:
            raise TypeError(f"xg must be float32 or bfloat16, got {x.dtype}")
        if x.dtype != xgs[0].dtype:
            raise TypeError(f"xg streams differ in type: {xgs[0].dtype} and {x.dtype}")
    return xgs[0].dtype


def _check_cuda_inputs(device, named) -> None:
    """named: (name, tensor, shape) triples the kernel reads or writes."""
    for name, x, shape in named:
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, expected {device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _entry(name: str, n_ints: int):
    """The C entry point `name` of the built kernel, its argument types set."""
    fn = getattr(_build.load("bilstm_recurrence"), name)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch(counter: str, c_name: str, device, ptrs, ints) -> None:
    fn = _entry(c_name, len(ints))
    with torch.cuda.device(device):
        err = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{c_name} kernel launch failed: cudaError {err}")
    launches[counter] += 1


def _bilstm_recurrence_cuda(xg_f, xg_b, w_hh_f, w_hh_b):
    T, B, G = xg_f.shape
    H = G // 4
    # the kernel reads w_hh as (4H, H) rows; free when w_hh is the transposed
    # view of an nn.LSTM-layout weight, as BiLSTMSumMerge passes it
    w_f = w_hh_f.t().contiguous()
    w_b = w_hh_b.t().contiguous()
    _check_cuda_inputs(xg_f.device, (
        ("xg_f", xg_f, (T, B, G)), ("xg_b", xg_b, (T, B, G)),
        ("w_hh_f^T", w_f, (G, H)), ("w_hh_b^T", w_b, (G, H)),
    ))
    out_f = torch.empty((T, B, H), dtype=torch.float32, device=xg_f.device)
    out_b = torch.empty_like(out_f)
    # scratch and inputs may be freed on return while the kernels still run:
    # the caching allocator hands them only to work queued later on this stream
    c_state = torch.empty((2, B, H), dtype=torch.float32, device=xg_f.device)
    if T == 0:
        return out_f, out_b
    _launch("bilstm_recurrence", "bilstm_recurrence_f32", xg_f.device,
            [xg_f.data_ptr(), xg_b.data_ptr(), w_f.data_ptr(), w_b.data_ptr(),
             out_f.data_ptr(), out_b.data_ptr(), c_state.data_ptr()], [T, B, H])
    return out_f, out_b


def _lstm_recurrence_cuda(xg, w_hh, mask, reverse, h0, c0):
    T, B, G = xg.shape
    H = G // 4
    w = w_hh.t().contiguous()
    named = [("xg", xg, (T, B, G)), ("w_hh^T", w, (G, H))]
    for name, x, shape in (("mask", mask, (T, B)), ("h0", h0, (B, H)), ("c0", c0, (B, H))):
        if x is not None:
            named.append((name, x, shape))
    _check_cuda_inputs(xg.device, named)
    out = torch.empty((T, B, H), dtype=torch.float32, device=xg.device)
    c_state = torch.empty((B, H), dtype=torch.float32, device=xg.device)  # c_T on return
    if T == 0:
        zeros = torch.zeros((B, H), dtype=torch.float32, device=xg.device)
        return out, (zeros if h0 is None else h0, zeros if c0 is None else c0)
    _launch("lstm_recurrence", "lstm_recurrence_f32", xg.device,
            [xg.data_ptr(), w.data_ptr(), out.data_ptr(), c_state.data_ptr(),
             _ptr(h0), _ptr(c0), _ptr(mask)], [T, B, H, int(reverse)])
    return out, (out[0 if reverse else T - 1], c_state)


def _bilstm(xg_f, xg_b, w_hh_f, w_hh_b, mask):
    dtype = _check_xg(xg_f, xg_b)
    xg_f = freeze_padded_steps(xg_f.float(), mask)
    xg_b = freeze_padded_steps(xg_b.float(), mask)
    w_hh_f, w_hh_b = w_hh_f.float(), w_hh_b.float()
    if xg_f.is_cuda:
        out = _bilstm_recurrence_cuda(xg_f.contiguous(), xg_b.contiguous(),
                                      w_hh_f, w_hh_b)
    elif xg_f.device.type == "cpu":
        out = bilstm_recurrence_reference(xg_f, xg_b, w_hh_f, w_hh_b)
    else:
        raise ValueError(f"unsupported device {xg_f.device}")
    return out[0].to(dtype), out[1].to(dtype)


def _lstm(xg, w_hh, mask, reverse, h0, c0):
    """One direction in fp32: (out, (h_T, c_T)), through the kernel or the plain version."""
    if xg.is_cuda:
        if mask is not None:
            mask = mask.float().contiguous()
        h0 = None if h0 is None else h0.float().contiguous()
        c0 = None if c0 is None else c0.float().contiguous()
        return _lstm_recurrence_cuda(xg.contiguous(), w_hh, mask, reverse, h0, c0)
    if xg.device.type != "cpu":
        raise ValueError(f"unsupported device {xg.device}")
    h0 = None if h0 is None else h0.float()
    c0 = None if c0 is None else c0.float()
    return lstm_recurrence_reference(xg, w_hh, mask, reverse=reverse, h0=h0, c0=c0)


def bilstm_recurrence(
    xg_f: torch.Tensor,
    xg_b: torch.Tensor,
    w_hh_f: torch.Tensor,
    w_hh_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: both LSTM directions over (T, B, 4H) pre-activations -> (T, B, H) each.

    w_hh_* (H, 4H) in the JAX layout, gate order (i, f, g, o); mask (T, B),
    1 = valid, applied as the gate freeze. Forward output t is the forward
    cell after time t; backward output t the backward cell after time t.
    """
    return _bilstm(xg_f, xg_b, w_hh_f, w_hh_b, mask)


def bilstm_recurrence_pallas(
    xg_fwd: torch.Tensor,
    xg_bwd: torch.Tensor,
    w_hh_fwd: torch.Tensor,
    w_hh_bwd: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2b: the unchunked fused bidirectional loop; the same function and launch as K1."""
    return _bilstm(xg_fwd, xg_bwd, w_hh_fwd, w_hh_bwd, mask)


def lstm_recurrence_pallas(
    xg: torch.Tensor,
    w_hh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
) -> torch.Tensor:
    """K2a: one direction, (T, B, 4H) pre-activations -> (T, B, H), zero initial state.

    mask (T, B), 1 = valid, applied as the gate freeze.
    """
    dtype = _check_xg(xg)
    xg = freeze_padded_steps(xg.float(), mask)
    out, _ = _lstm(xg, w_hh.float(), None, reverse, None, None)
    return out.to(dtype)


def lstm_recurrence(
    xg: torch.Tensor,
    w_hh: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    *,
    reverse: bool = False,
    init_state: Optional[State] = None,
) -> Tuple[torch.Tensor, State]:
    """One direction with the scan's semantics: (T, B, 4H) -> ((T, B, H), (h_T, c_T)).

    mask (T, B), 1 = valid: a padded step holds (h, c) and outputs the held
    h. init_state ((B, H), (B, H)) seeds (h, c) instead of zeros. The state
    returned is the one after the last step in processing order. The CUDA
    route of `models/lstm.py::lstm_direction`.
    """
    dtype = _check_xg(xg)
    h0, c0 = (None, None) if init_state is None else init_state
    out, (h, c) = _lstm(xg.float(), w_hh.float(), mask, reverse, h0, c0)
    return out.to(dtype), (h.to(dtype), c.to(dtype))


def lstm_direction_pallas(
    x_seq: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T, C) -> (B, T, H): the input projection as a matmul, then K2a.

    w_ih (C, 4H), w_hh (H, 4H), bias (4H,) in the JAX layout; mask (B, T).
    Real frames equal `models/lstm.py::lstm_direction`'s; padded positions
    carry the freeze, not the hold.
    """
    xg = torch.matmul(x_seq, w_ih.to(x_seq.dtype)) + bias.to(x_seq.dtype)
    m = None if mask is None else mask.transpose(0, 1)
    ys = lstm_recurrence_pallas(xg.transpose(0, 1), w_hh, m, reverse=reverse)
    return ys.transpose(0, 1)


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
