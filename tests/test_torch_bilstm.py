"""The port's BiLSTM (ops/bilstm.py, models/lstm.py) against the JAX package.

Inputs come from numpy with a seed and go to both packages as numpy arrays.
Tolerances: fp32 with the recurrent sums taken in another order, compounded
over T steps; 2e-5 absolute on outputs of size <= 1 leaves a margin of about
100x over the differences seen (~1e-7).
"""
import numpy as np
import pytest
import torch

from mri2speech_tpu.models import lstm as jax_lstm
from mri2speech_tpu.ops.pallas_lstm import (
    bilstm_recurrence_pallas_chunked,
    bilstm_sum_pallas,
)
from mri2speech_tpu_torch.models.lstm import BiLSTMSumMerge, lstm_direction
from mri2speech_tpu_torch.ops import bilstm

torch.set_num_threads(1)

ATOL = 2e-5


def _streams(seed, T, B, H):
    rng = np.random.default_rng(seed)
    xf = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    xb = rng.standard_normal((T, B, 4 * H)).astype(np.float32)
    wf = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    wb = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    return xf, xb, wf, wb


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B", [1, 3])
def test_reference_matches_pallas_kernel_real_and_padded(B):
    """T=70 with ragged masked tails: chunk 32 -> 3 chunks on the JAX side."""
    T, H = 70, 16
    xf, xb, wf, wb = _streams(0, T, B, H)
    mask = np.ones((T, B), np.float32)
    for b in range(B):
        mask[T - 6 - 11 * b:, b] = 0.0
    jf, jb = bilstm_recurrence_pallas_chunked(xf, xb, wf, wb, mask, chunk=32, interpret=True)
    pf, pb = bilstm.bilstm_recurrence(*_t(xf, xb, wf, wb, mask))
    real = mask.astype(bool)
    for j, p in ((jf, pf), (jb, pb)):
        j, p = np.asarray(j), p.numpy()
        np.testing.assert_allclose(p[real], j[real], atol=ATOL, rtol=0)
        np.testing.assert_allclose(p[~real], j[~real], atol=ATOL, rtol=0)
    # backward cell meets the trailing padding first, from zero state: exact zero
    assert np.all(pb.numpy()[~real] == 0.0)


def test_reference_matches_pallas_kernel_unmasked():
    T, B, H = 33, 2, 8
    xf, xb, wf, wb = _streams(1, T, B, H)
    jf, jb = bilstm_recurrence_pallas_chunked(xf, xb, wf, wb, None, interpret=True)
    pf, pb = bilstm.bilstm_recurrence(*_t(xf, xb, wf, wb))
    np.testing.assert_allclose(pf.numpy(), np.asarray(jf), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=ATOL, rtol=0)


def _lstm_params(seed, C, H):
    rng = np.random.default_rng(seed)
    b = 1.0 / np.sqrt(H)
    p = {}
    for d in ("fwd", "bwd"):
        p[f"w_ih_{d}"] = rng.uniform(-b, b, (C, 4 * H)).astype(np.float32)
        p[f"w_hh_{d}"] = rng.uniform(-b, b, (H, 4 * H)).astype(np.float32)
        p[f"b_{d}"] = rng.uniform(-2 * b, 2 * b, (4 * H,)).astype(np.float32)
    return p


def test_bilstm_sum_matches_jax_sum_wrapper():
    B, T, C, H = 2, 21, 12, 16
    p = _lstm_params(2, C, H)
    x = np.random.default_rng(3).standard_normal((B, T, C)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, 15:] = 0.0
    ref = np.asarray(bilstm_sum_pallas(x, p, mask, interpret=True))
    got = bilstm.bilstm_sum(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_direction_mask_state(reverse):
    """Mask-hold semantics, init_state and return_state against the JAX scan."""
    B, T, C, H = 3, 11, 6, 8
    p = _lstm_params(4, C, H)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, 7:] = 0.0
    mask[2, 3:] = 0.0
    h0 = rng.standard_normal((B, H)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((B, H)).astype(np.float32) * 0.5
    args = (p["w_ih_fwd"], p["w_hh_fwd"], p["b_fwd"])
    ys_j, (hj, cj) = jax_lstm.lstm_direction(
        x, *args, reverse=reverse, mask=mask, init_state=(h0, c0), return_state=True
    )
    ys_p, (hp, cp) = lstm_direction(
        *_t(x, *args), reverse=reverse, mask=torch.from_numpy(mask),
        init_state=tuple(_t(h0, c0)), return_state=True,
    )
    np.testing.assert_allclose(ys_p.numpy(), np.asarray(ys_j), atol=ATOL, rtol=0)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), atol=ATOL, rtol=0)
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), atol=ATOL, rtol=0)
    # no mask, no state: plain run
    ys_j = jax_lstm.lstm_direction(x, *args, reverse=reverse)
    ys_p = lstm_direction(*_t(x, *args), reverse=reverse)
    np.testing.assert_allclose(ys_p.numpy(), np.asarray(ys_j), atol=ATOL, rtol=0)


def _module_from(p, C, H, impl):
    m = BiLSTMSumMerge(C, H, impl=impl)
    sd = {}
    for d, sfx in (("fwd", "l0"), ("bwd", "l0_reverse")):
        sd[f"lstm.weight_ih_{sfx}"] = torch.from_numpy(p[f"w_ih_{d}"].T.copy())
        sd[f"lstm.weight_hh_{sfx}"] = torch.from_numpy(p[f"w_hh_{d}"].T.copy())
        sd[f"lstm.bias_ih_{sfx}"] = torch.from_numpy(p[f"b_{d}"])
        sd[f"lstm.bias_hh_{sfx}"] = torch.zeros(4 * H)
    m.load_state_dict(sd, strict=True)
    return m


@pytest.mark.parametrize("impl,jax_impl", [("kernel", "pallas"), ("scan", "scan")])
def test_bilstm_module_matches_jax_module(impl, jax_impl):
    """Both impls against their JAX counterparts, padded positions included."""
    B, T, C, H = 2, 19, 10, 16
    p = _lstm_params(6, C, H)
    x = np.random.default_rng(7).standard_normal((B, T, C)).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, 12:] = 0.0
    ref = jax_lstm.BiLSTMSumMerge(H, impl=jax_impl).apply({"params": p}, x, mask)
    with torch.no_grad():
        got = _module_from(p, C, H, impl)(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_cpu_tensor_leaves_launch_counter():
    before = dict(bilstm.launches)
    T, B, H = 9, 2, 8
    xf, xb, wf, wb = _streams(8, T, B, H)
    bilstm.bilstm_recurrence(*_t(xf, xb, wf, wb))
    p = _lstm_params(9, 5, H)
    with torch.no_grad():
        _module_from(p, 5, H, "kernel")(torch.zeros(1, 4, 5))
    assert bilstm.launches == before == dict.fromkeys(before, 0)


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    from mri2speech_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("bilstm_recurrence")


def test_kernel_build_raises_when_nvcc_fails(monkeypatch, tmp_path):
    from mri2speech_tpu_torch.ops import _build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: no such target' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed for bilstm_recurrence.cu"):
        _build.load("bilstm_recurrence")
    assert not list((tmp_path / "build").glob("*.so"))
