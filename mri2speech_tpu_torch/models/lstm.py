"""Bidirectional LSTM with the two directions summed.

Counterpart of `mri2speech_tpu/models/lstm.py:47-185`. Gate order (i, f, g,
o) and the nn.LSTM parameter names (`weight_ih_l0`, `weight_hh_l0`,
`bias_ih_l0`, `bias_hh_l0` and `*_reverse`), so reference checkpoints load
as they are; only the sum ``bias_ih + bias_hh`` enters the math.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mri2speech_tpu_torch.ops.bilstm import bilstm_sum


def lstm_direction(
    x_seq: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    bias: torch.Tensor,
    *,
    reverse: bool = False,
    mask: Optional[torch.Tensor] = None,
    init_state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    return_state: bool = False,
):
    """One LSTM direction over (B, T, C) -> (B, T, H), as a plain per-step loop.

    w_ih (C, 4H), w_hh (H, 4H), bias (4H,) in the JAX layout. `mask` (B, T),
    1 = valid: padded steps hold (h, c) unchanged. `init_state` ((B, H), (B, H))
    seeds (h, c); `return_state=True` also returns the final (h, c).
    """
    B, T, _ = x_seq.shape
    H = w_hh.shape[0]
    xg = torch.matmul(x_seq, w_ih) + bias  # input projection for all steps
    if init_state is None:
        h = c = x_seq.new_zeros((B, H))
    else:
        h, c = init_state[0].to(x_seq.dtype), init_state[1].to(x_seq.dtype)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        i, f, g, o = (xg[:, t] + h @ w_hh).chunk(4, dim=-1)
        c1 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h1 = torch.sigmoid(o) * torch.tanh(c1)
        if mask is None:
            h, c = h1, c1
        else:
            m = mask[:, t, None].to(x_seq.dtype)
            h = m * h1 + (1.0 - m) * h
            c = m * c1 + (1.0 - m) * c
        ys[t] = h
    out = torch.stack(ys, dim=1) if T else x_seq.new_zeros((B, 0, H))
    if return_state:
        return out, (h, c)
    return out


class _LSTMParams(nn.Module):
    """Holds the nn.LSTM-named parameters of one bidirectional layer."""

    def __init__(self, input_size: int, hidden_size: int) -> None:
        super().__init__()
        G = 4 * hidden_size
        for sfx in ("l0", "l0_reverse"):
            self.register_parameter(f"weight_ih_{sfx}", nn.Parameter(torch.empty(G, input_size)))
            self.register_parameter(f"weight_hh_{sfx}", nn.Parameter(torch.empty(G, hidden_size)))
            self.register_parameter(f"bias_ih_{sfx}", nn.Parameter(torch.empty(G)))
            self.register_parameter(f"bias_hh_{sfx}", nn.Parameter(torch.empty(G)))


class BiLSTMSumMerge(nn.Module):
    """1-layer BiLSTM, forward + backward outputs summed: (B, T, C) -> (B, T, H).

    impl="kernel" (serving): the recurrence goes through `ops/bilstm.py` (the
    CUDA kernel on a card, its plain version on the CPU), gate-freeze masking.
    impl="scan": the plain per-step loop of :func:`lstm_direction`, mask-hold.
    """

    def __init__(self, input_size: int, hidden_size: int = 640, impl: str = "kernel") -> None:
        super().__init__()
        if impl not in ("kernel", "scan"):
            raise ValueError(f"impl must be 'kernel' or 'scan', got {impl!r}")
        self.hidden_size = hidden_size
        self.impl = impl
        self.lstm = _LSTMParams(input_size, hidden_size)

    def jax_layout_params(self) -> dict:
        """{w_ih_fwd (C, 4H), w_hh_fwd (H, 4H), b_fwd (4H,), *_bwd} as views."""
        p = self.lstm
        out = {}
        for d, sfx in (("fwd", "l0"), ("bwd", "l0_reverse")):
            out[f"w_ih_{d}"] = getattr(p, f"weight_ih_{sfx}").t()
            out[f"w_hh_{d}"] = getattr(p, f"weight_hh_{sfx}").t()
            out[f"b_{d}"] = getattr(p, f"bias_ih_{sfx}") + getattr(p, f"bias_hh_{sfx}")
        return out

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        params = self.jax_layout_params()
        if self.impl == "kernel":
            return bilstm_sum(x, params, mask)
        fwd = lstm_direction(x, params["w_ih_fwd"], params["w_hh_fwd"], params["b_fwd"], mask=mask)
        bwd = lstm_direction(
            x, params["w_ih_bwd"], params["w_hh_bwd"], params["b_bwd"], reverse=True, mask=mask
        )
        return fwd + bwd
