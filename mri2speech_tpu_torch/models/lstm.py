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

from mri2speech_tpu_torch.ops.bilstm import bilstm_sum, lstm_recurrence


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
    """One LSTM direction over (B, T, C) -> (B, T, H).

    w_ih (C, 4H), w_hh (H, 4H), bias (4H,) in the JAX layout. `mask` (B, T),
    1 = valid: padded steps hold (h, c) unchanged. `init_state` ((B, H), (B, H))
    seeds (h, c); `return_state=True` also returns the final (h, c). The input
    projection is one matmul; the recurrence is `ops/bilstm.py::lstm_recurrence`
    (the CUDA kernel on a card, its per-step plain version on the CPU).
    """
    xg = torch.matmul(x_seq, w_ih) + bias  # input projection for all steps
    m = None if mask is None else mask.transpose(0, 1)
    ys, state = lstm_recurrence(
        xg.transpose(0, 1), w_hh, m, reverse=reverse, init_state=init_state
    )
    out = ys.transpose(0, 1)
    if return_state:
        return out, state
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
    impl="scan": two :func:`lstm_direction` calls, mask-hold (two kernel launches
    on a card).
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
