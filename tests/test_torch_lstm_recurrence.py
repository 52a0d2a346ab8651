"""The port's single-direction and unchunked recurrence entry points against the JAX kernels.

K2a (`ops/bilstm.py::lstm_recurrence_pallas`, `lstm_direction_pallas`) and
K2b (`bilstm_recurrence_pallas`) on the CPU run their plain version; the JAX
side runs the Pallas kernels in interpret mode. Inputs come from numpy with
a seed and go to both packages as numpy arrays.

Tolerances:
* fp32 ``xg``: 2e-5 absolute on outputs of size < 1, as `test_torch_bilstm.py`
  (recurrent sums in another order, compounded over T steps; ~1e-7 seen).
  Padded positions are compared too: both sides freeze, neither holds.
* bf16 ``xg``: both sides run the recurrence in fp32 and round the result
  to bf16, so an fp32 difference of ~1e-7 can flip one rounding. The limit
  is one bf16 step at |h| < 1, 2^-8, and at most 1% of the values may differ
  at all (none did at these sizes).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mri2speech_tpu.ops import pallas_lstm as jax_lstm
from mri2speech_tpu_torch.ops import bilstm

torch.set_num_threads(1)

ATOL = 2e-5
BF16_STEP = 2.0 ** -8
MAX_FLIPPED = 0.01
LENGTHS = {1: [18], 3: [23, 17, 9]}  # ragged trailing padding at T = 23


def _inputs(seed, T, B, H, n=1):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((T, B, 4 * H)) * 0.8).astype(np.float32) for _ in range(n)]
    ws = [(rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32) for _ in range(n)]
    return xs, ws


def _mask(T, lengths):
    m = np.zeros((T, len(lengths)), np.float32)
    for b, n in enumerate(lengths):
        m[:n, b] = 1.0
    return m


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("B", [1, 3])
def test_lstm_recurrence_pallas_matches_jax_kernel(B, reverse, masked):
    T, H = 23, 16
    (x,), (w,) = _inputs(B + 2 * reverse, T, B, H)
    mask = _mask(T, LENGTHS[B]) if masked else None
    ref = np.asarray(jax_lstm.lstm_recurrence_pallas(
        x, w, None if mask is None else jnp.asarray(mask), reverse=reverse, interpret=True))
    got = bilstm.lstm_recurrence_pallas(_t(x), _t(w), _t(mask), reverse=reverse)
    assert got.dtype == torch.float32 and got.shape == (T, B, H)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)  # every position


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_bilstm_recurrence_pallas_matches_jax_kernel(masked):
    T, B, H = 23, 3, 16
    xs, ws = _inputs(7, T, B, H, n=2)
    mask = _mask(T, LENGTHS[B]) if masked else None
    rf, rb = jax_lstm.bilstm_recurrence_pallas(
        *xs, *ws, None if mask is None else jnp.asarray(mask), interpret=True)
    gf, gb = bilstm.bilstm_recurrence_pallas(*map(_t, xs), *map(_t, ws), _t(mask))
    np.testing.assert_allclose(gf.numpy(), np.asarray(rf), atol=ATOL, rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(rb), atol=ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_lstm_direction_pallas_matches_jax(reverse):
    B, T, C, H = 3, 19, 10, 16
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w_ih = (rng.standard_normal((C, 4 * H)) * 0.3).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = (rng.standard_normal(4 * H) * 0.1).astype(np.float32)
    mask = _mask(T, [19, 12, 5]).T.copy()  # (B, T)
    for m in (None, mask):
        ref = np.asarray(jax_lstm.lstm_direction_pallas(
            jnp.asarray(x), w_ih, w_hh, b, reverse=reverse,
            mask=None if m is None else jnp.asarray(m), interpret=True))
        got = bilstm.lstm_direction_pallas(_t(x), _t(w_ih), _t(w_hh), _t(b),
                                           reverse=reverse, mask=_t(m))
        np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def _bf16_close(got: torch.Tensor, ref) -> None:
    assert got.dtype == torch.bfloat16
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    g = got.float().numpy()
    np.testing.assert_allclose(g, ref, atol=BF16_STEP, rtol=0)
    assert np.mean(g != ref) <= MAX_FLIPPED


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def test_bf16_xg_through_every_entry_matches_jax():
    """bf16 pre-activations: fp32 recurrence, bf16 out, as the JAX kernels (K1, K2a, K2b)."""
    T, B, H = 21, 2, 16
    xs, ws = _inputs(13, T, B, H, n=2)
    mask = _mask(T, [21, 14])
    xb = [_bf16(x) for x in xs]
    xj = [jnp.asarray(x, jnp.bfloat16) for x in xs]
    assert xj[0].dtype == jnp.bfloat16

    k1 = bilstm.bilstm_recurrence(*xb, *map(_t, ws), _t(mask))
    k1_ref = jax_lstm.bilstm_recurrence_pallas_chunked(*xj, *ws, jnp.asarray(mask), chunk=8,
                                                       interpret=True)
    k2b = bilstm.bilstm_recurrence_pallas(*xb, *map(_t, ws), _t(mask))
    k2b_ref = jax_lstm.bilstm_recurrence_pallas(*xj, *ws, jnp.asarray(mask), interpret=True)
    for got, ref in zip((*k1, *k2b), (*k1_ref, *k2b_ref)):
        assert ref.dtype == jnp.bfloat16
        _bf16_close(got, ref)
    for reverse in (False, True):
        got = bilstm.lstm_recurrence_pallas(xb[0], _t(ws[0]), _t(mask), reverse=reverse)
        ref = jax_lstm.lstm_recurrence_pallas(xj[0], ws[0], jnp.asarray(mask), reverse=reverse,
                                              interpret=True)
        _bf16_close(got, ref)
    # the bf16 result is the fp32 recurrence on the same inputs, rounded once
    f32 = bilstm.bilstm_recurrence(*(x.float() for x in xb), *map(_t, ws), _t(mask))
    assert torch.equal(k1[0], f32[0].to(torch.bfloat16))


def test_entries_reject_what_the_kernel_does_not_take():
    x = torch.zeros(4, 1, 32)
    w = torch.zeros(8, 32)
    with pytest.raises(TypeError):
        bilstm.lstm_recurrence_pallas(x.double(), w)
    with pytest.raises(TypeError):
        bilstm.bilstm_recurrence_pallas(x, x.to(torch.bfloat16), w, w)
    with pytest.raises(ValueError):
        bilstm.lstm_recurrence(torch.zeros(4, 30), w)


def test_hold_entry_seeds_holds_and_returns_state():
    """lstm_recurrence: a fully padded stream returns its seed, a real step moves it."""
    T, B, H = 5, 2, 8
    (x,), (w,) = _inputs(17, T, B, H)
    rng = np.random.default_rng(18)
    h0, c0 = (torch.from_numpy(rng.standard_normal((B, H)).astype(np.float32)) for _ in "hc")
    mask = torch.from_numpy(_mask(T, [0, 3]))
    for reverse in (False, True):
        out, (h, c) = bilstm.lstm_recurrence(_t(x), _t(w), mask, reverse=reverse,
                                             init_state=(h0, c0))
        assert torch.equal(out[:, 0], h0[0].expand(T, H))  # row 0: every step held
        assert torch.equal(h[0], h0[0]) and torch.equal(c[0], c0[0])
        last = 2 if not reverse else 0  # row 1: the last real step in processing order
        assert torch.equal(h[1], out[last, 1]) and not torch.equal(c[1], c0[1])
        ref, (hr, cr) = bilstm.lstm_recurrence_reference(_t(x)[:3, 1:], _t(w),
                                                          h0=h0[1:], c0=c0[1:], reverse=reverse)
        torch.testing.assert_close(c[1:], cr, atol=ATOL, rtol=0)
        torch.testing.assert_close(out[:3, 1:], ref, atol=ATOL, rtol=0)
