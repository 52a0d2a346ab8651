"""Card-only tests of the port: each kernel against its plain version on the card.

These skip without a CUDA card. The file imports neither JAX nor the JAX
package, so on a machine with a card and no JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda

Tolerances:
* K1 (BiLSTM) and the single-direction entries of the same kernel (K2a,
  hold mode, K2b) 1e-4: fp32 dot products summed in another order, carried
  through T steps of contractive gates (differences of ~2e-7 are seen at
  H=640). The held steps and the final state are exact in both versions.
* K3 (MRF stage) and K4 (MBConv block) with fp32 operands: 1e-4 absolute on
  outputs of size ~1-5 (fp32 FMAs against cuDNN/cuBLAS fp32 with TF32 off,
  summed in another order).
* K3 and K4 with bf16 operands: the smaller of 2e-4 x max|ref| and half the
  control, the kernel with fp32 operands held against the bf16 plain
  version, as in chip_smoke.py. Kernel and plain version round the same
  activations to bf16, but a sum taken in another order can flip a rounding
  (one bf16 ulp, 2^-8 relative), which then travels through the remaining
  products. Seen on the H100: K3 2.9e-6 to 4.1e-5 x max|ref| against
  controls 6.0e-5 to 2.0e-4; K4 6.3e-8 to 3.0e-5 against 4.2e-4 to 5.7e-4.
* bf16 x into K3 and K4 (the output then is bf16): the limit above plus
  half a bf16 ulp of the plain version's fp32 output, which the kernel's
  output was rounded from; and bit for bit the kernel's fp32-x output
  rounded (the kernel reads the same values either way and rounds only when
  it stores).
* K3 twice on one input: bit for bit (no atomics).
* the tiny fused pipeline, card vs CPU: mel_db 1e-2 dB, mel_log 2.5e-3,
  audio 1e-4, as chip_smoke.py's fp32 card-vs-CPU check.
* the tiny online stream, card vs CPU: audio 1e-5, mel_db 1e-3 dB, as the
  tiny pipeline; fused, as the tiny fused pipeline.
"""
import numpy as np
import pytest
import torch

from mri2speech_tpu_torch.config import default_vocoder_config
from mri2speech_tpu_torch.infer.online import OnlineVideoToSpeech
from mri2speech_tpu_torch.infer.pipeline import VideoToSpeechPipeline
from mri2speech_tpu_torch.models.effnetv2 import StageSpec
from mri2speech_tpu_torch.models.vocoder import FUSED_MODE
from mri2speech_tpu_torch.ops import bilstm, mbconv, mrf
from mri2speech_tpu_torch.ops.scaler import MelScaler
from mri2speech_tpu_torch.weights import (
    acoustic_model_from_jax,
    generator_from_jax,
    random_acoustic_params,
    random_generator_params,
)

torch.set_num_threads(1)

ATOL = 1e-4
BF16_REL = 2e-4
CONTROL_SHARE = 0.5
MRF_KERNELS, MRF_DILS = (3, 7, 11), (1, 3, 5)
TINY_SPEC = (
    StageSpec("cn", 3, 1, 1, 8, 1),
    StageSpec("er", 3, 2, 2, 8, 1),
    StageSpec("ir", 3, 2, 2, 16, 1, 0.25),
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H", [(70, 1, 640), (37, 3, 48), (5, 6, 640)])
def test_kernel_matches_plain_version_on_card(cuda_device, T, B, H):
    rng = np.random.default_rng(10)
    xs = [rng.standard_normal((T, B, 4 * H)).astype(np.float32) for _ in range(2)]
    ws = [(rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32) for _ in range(2)]
    mask = np.ones((T, B), np.float32)
    mask[T - 3:, 0] = 0.0
    xf, xb, wf, wb, m = [torch.from_numpy(a).to(cuda_device) for a in (*xs, *ws, mask)]
    before = bilstm.launches["bilstm_recurrence"]
    kf, kb = bilstm.bilstm_recurrence(xf, xb, wf, wb, m)
    torch.cuda.synchronize()
    assert bilstm.launches["bilstm_recurrence"] == before + 1
    rf, rb = bilstm.bilstm_recurrence_reference(
        bilstm.freeze_padded_steps(xf, m), bilstm.freeze_padded_steps(xb, m), wf, wb
    )
    torch.testing.assert_close(kf, rf, atol=ATOL, rtol=0)
    torch.testing.assert_close(kb, rb, atol=ATOL, rtol=0)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    x = torch.zeros(4, 1, 32, device=cuda_device)
    w = torch.zeros(8, 32, device=cuda_device)
    with pytest.raises(TypeError):
        bilstm.bilstm_recurrence(x.double(), x.double(), w.double(), w.double())
    with pytest.raises(ValueError):
        bilstm.bilstm_recurrence(x, x, w, w.cpu())
    with pytest.raises(ValueError):
        bilstm.bilstm_recurrence(x, x, w[:, :16], w[:, :16])


def _lengths(T, B):
    return [T - 5] if B == 1 else [T, T - 6, T - 13][:B]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("T,B,H", [(16, 1, 640), (32, 1, 640), (23, 3, 48)])
def test_single_direction_kernel_matches_plain_version_on_card(cuda_device, T, B, H, reverse):
    """Freeze mode (K2a) and hold mode with seed and final state (the scan's CUDA route)."""
    rng = np.random.default_rng(T + B)
    x = torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy((rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32))
    w = w.to(cuda_device)
    h0, c0 = (torch.from_numpy((rng.standard_normal((B, H)) * 0.5).astype(np.float32))
              .to(cuda_device) for _ in "hc")
    mask = torch.zeros(T, B, device=cuda_device)
    for b, n in enumerate(_lengths(T, B)):
        mask[:n, b] = 1.0
    before = dict(bilstm.launches)
    frozen = bilstm.lstm_recurrence_pallas(x, w, mask, reverse=reverse)
    held, (h, c) = bilstm.lstm_recurrence(x, w, mask, reverse=reverse, init_state=(h0, c0))
    torch.cuda.synchronize()
    # both entries launch the single-direction C entry
    assert bilstm.launches == dict(before, lstm_recurrence=before["lstm_recurrence"] + 2)
    ref, _ = bilstm.lstm_recurrence_reference(bilstm.freeze_padded_steps(x, mask), w,
                                              reverse=reverse)
    torch.testing.assert_close(frozen, ref, atol=ATOL, rtol=0)
    ref, (hr, cr) = bilstm.lstm_recurrence_reference(x, w, mask, reverse=reverse, h0=h0, c0=c0)
    torch.testing.assert_close(held, ref, atol=ATOL, rtol=0)
    torch.testing.assert_close(h, hr, atol=ATOL, rtol=0)
    torch.testing.assert_close(c, cr, atol=ATOL, rtol=0)
    pad = mask == 0
    if reverse:  # trailing padding comes first: held at the seed, exactly
        assert torch.equal(held[pad], h0[None].expand(T, B, H)[pad])


@pytest.mark.cuda
def test_unchunked_bilstm_entry_matches_plain_version_on_card(cuda_device):
    """K2b, and bf16 pre-activations through the K1 entry (fp32 inside, bf16 out)."""
    T, B, H = 70, 2, 640
    rng = np.random.default_rng(12)
    xs = [torch.from_numpy(rng.standard_normal((T, B, 4 * H)).astype(np.float32)).to(cuda_device)
          for _ in range(2)]
    ws = [torch.from_numpy((rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32))
          .to(cuda_device) for _ in range(2)]
    mask = torch.ones(T, B, device=cuda_device)
    mask[50:, 1] = 0.0
    before = bilstm.launches["bilstm_recurrence"]
    kf, kb = bilstm.bilstm_recurrence_pallas(*xs, *ws, mask)
    torch.cuda.synchronize()
    assert bilstm.launches["bilstm_recurrence"] == before + 1  # K1's C entry
    rf, rb = bilstm.bilstm_recurrence_reference(
        *(bilstm.freeze_padded_steps(x, mask) for x in xs), *ws)
    torch.testing.assert_close(kf, rf, atol=ATOL, rtol=0)
    torch.testing.assert_close(kb, rb, atol=ATOL, rtol=0)
    xb = [x.to(torch.bfloat16) for x in xs]
    bf = bilstm.bilstm_recurrence(*xb, *ws, mask)
    f32 = bilstm.bilstm_recurrence(*(x.float() for x in xb), *ws, mask)
    assert bf[0].dtype == torch.bfloat16
    assert torch.equal(bf[0], f32[0].to(torch.bfloat16))


@pytest.mark.cuda
def test_single_direction_wrappers_reject_bad_inputs(cuda_device):
    x = torch.zeros(4, 1, 32, device=cuda_device)
    w = torch.zeros(8, 32, device=cuda_device)
    with pytest.raises(TypeError):
        bilstm.lstm_recurrence_pallas(x.double(), w)
    with pytest.raises(ValueError):
        bilstm.lstm_recurrence_pallas(x, w.cpu())
    with pytest.raises(ValueError):
        bilstm.lstm_recurrence(x, w, torch.ones(4, 1))  # mask on the CPU
    with pytest.raises(ValueError):
        bilstm.lstm_recurrence(x, w, init_state=(torch.zeros(2, 8, device=cuda_device),) * 2)


@pytest.mark.cuda
def test_tiny_online_stream_card_matches_cpu(cuda_device):
    """The online path on the card: two single-direction launches per mel chunk, no K1."""
    params, stats = random_acoustic_params(seed=47, spec=TINY_SPEC, stem_channels=8,
                                           rnn_hidden=16)
    h = dict(default_vocoder_config(upsample_initial_channel=16))
    gen_params = random_generator_params(h, seed=48)
    scaler = MelScaler(mean=np.linspace(-40, -10, 64).astype(np.float32),
                       std=np.full(64, 5.0, np.float32))
    frames = (np.random.default_rng(49).random((37, 64, 64)) * 255).astype(np.uint8)

    def stream(device):
        model = acoustic_model_from_jax(params, stats, rnn_hidden=16, cnn_spec=TINY_SPEC,
                                        cnn_stem=8)
        online = OnlineVideoToSpeech(model, generator_from_jax(gen_params, h), scaler,
                                     chunk=8, lookahead=8, input_norm="zscore_minmax",
                                     device=device)
        pieces = [online.push(frames[i:i + 5]) for i in range(0, len(frames), 5)]
        pieces.append(online.flush())
        return (np.concatenate([a for a, _ in pieces]),
                np.concatenate([m for _, m in pieces if m.size])), online

    before = dict(bilstm.launches)
    card, online = stream(cuda_device)
    assert bilstm.launches == dict(before, lstm_recurrence=before["lstm_recurrence"]
                                   + 2 * online._n_mel_chunks)
    cpu, _ = stream("cpu")
    assert card[0].shape == cpu[0].shape == (37 * 420,)
    for name, c, r, tol in zip(("audio", "mel_db"), card, cpu, (1e-5, 1e-3)):
        np.testing.assert_allclose(c, r, atol=tol, rtol=0, err_msg=name)


@pytest.mark.cuda
def test_tiny_pipeline_card_matches_cpu(cuda_device):
    """Same weights on the card and on the CPU; the card goes through K1 once per request."""
    params, stats = random_acoustic_params(seed=41, spec=TINY_SPEC, stem_channels=8,
                                           rnn_hidden=16)
    h = dict(default_vocoder_config(upsample_initial_channel=16))
    gen_params = random_generator_params(h, seed=42)
    scaler = MelScaler(mean=np.linspace(-40, -10, 64).astype(np.float32),
                       std=np.full(64, 5.0, np.float32))

    def pipe(device):
        model = acoustic_model_from_jax(params, stats, rnn_hidden=16, cnn_spec=TINY_SPEC,
                                        cnn_stem=8)
        return VideoToSpeechPipeline(model, generator_from_jax(gen_params, h), scaler,
                                     frame_bucket=8, input_norm="zscore_minmax", device=device)

    frames = (np.random.default_rng(43).random((13, 64, 64)) * 255).astype(np.uint8)
    before = bilstm.launches["bilstm_recurrence"]
    card = pipe(cuda_device)(frames)
    assert bilstm.launches["bilstm_recurrence"] == before + 1
    cpu = pipe("cpu")(frames)
    for name, c, r, tol in zip(("audio", "mel_db", "mel_log"), card, cpu, (1e-5, 1e-3, 1e-4)):
        np.testing.assert_allclose(c, r, atol=tol, rtol=0, err_msg=name)


def _mrf_weights(C, seed):
    """Taps N(0, 0.01), the generator's own init scale. At larger scales each
    conv's gain passes 1, and a bf16 rounding flipped by a reordered sum grows
    through the 18 convs until it is as large as the fp32-vs-bf16 difference."""
    rng = np.random.default_rng(seed)
    resblocks = [
        {f"{n}_{u}": {"w": (rng.standard_normal((k, C, C)) * 0.01).astype(np.float32),
                      "b": (rng.standard_normal(C) * 0.05).astype(np.float32)}
         for u in range(3) for n in ("convs1", "convs2")}
        for k in MRF_KERNELS
    ]
    return mrf.MRFStageWeights.from_resblocks(resblocks, MRF_KERNELS, MRF_DILS)


def _tol(run, dtype, ref):
    """The limit on max|kernel - plain| for run(dtype) against ref, the plain version's output."""
    if dtype == torch.float32:
        return ATOL
    control = (run(torch.float32) - ref).abs().max().item()
    return min(BF16_REL * ref.abs().max().item(), CONTROL_SHARE * control)


MRF_SHAPES = [  # (entry, B, T, C)
    ("v1", 2, 300, 40), ("v2", 2, 300, 40), ("v1", 1, 1000, 96), ("v2", 1, 1000, 96),
    # T below the receptive field (120) and just above it; both modes (chain: C <= 64)
    ("v2", 1, 1, 32), ("v1", 1, 7, 40), ("v2", 2, 119, 64), ("v1", 1, 121, 32),
    ("v1", 1, 119, 256), ("v2", 1, 7, 128),
    # T no multiple of the time tile, at each entry and in each mode
    ("v1", 2, 1000, 128), ("v2", 1, 3001, 32),
    # widths that are no power of two, B = 3
    ("v2", 3, 300, 48), ("v1", 3, 300, 96),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("entry,B,T,C", MRF_SHAPES)
def test_mrf_stage_matches_plain_version_on_card(cuda_device, entry, B, T, C, dtype):
    """Ragged multi-tile T, T below the receptive field, partial output-channel blocks,
    widths that are no power of two, both entry points, modes and layouts."""
    w = _mrf_weights(C, seed=C)
    tiled = entry == "v1"
    x = torch.from_numpy((np.random.default_rng(T).standard_normal(
        (B, T, 3 * C if tiled else C)) * 0.5).astype(np.float32)).to(cuda_device)
    fn = mrf.mrf_stage_pallas if tiled else mrf.mrf_stage_pallas_v2
    kw = dict(channels=C, kernels=MRF_KERNELS, dils=MRF_DILS, mxu_dtype=dtype)
    name = fn.__name__
    before = mrf.launches[name]
    got = fn(x, w, **kw)
    got_bct = fn(x.transpose(1, 2).contiguous(), w, layout="bct", **kw)
    torch.cuda.synchronize()
    assert mrf.launches[name] == before + 2
    xt = x.transpose(1, 2)
    xs = [xt[:, j * C:(j + 1) * C] for j in range(3)] if tiled else xt
    ref = mrf.mrf_stage_reference(xs, w, dtype).transpose(1, 2)
    tol = _tol(lambda dt: fn(x, w, **dict(kw, mxu_dtype=dt)), dtype, ref)
    torch.testing.assert_close(got, ref, atol=tol, rtol=0)
    torch.testing.assert_close(got_bct.transpose(1, 2), ref, atol=tol, rtol=0)


def _mbconv_weights(C, E, R, seed):
    rng = np.random.default_rng(seed)

    def a(*shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    return mbconv.MBConvWeights.from_jax({
        "w1": a(C, E, scale=C ** -0.5), "b1": a(E, scale=0.1), "wd": a(3, 3, E, scale=0.3),
        "bd": a(E, scale=0.1), "wr": a(E, R, scale=E ** -0.5), "br": a(R, scale=0.1),
        "we": a(R, E, scale=R ** -0.5), "be": a(E, scale=0.1), "w3": a(E, C, scale=E ** -0.5),
        "b3": a(C, scale=0.1),
    })


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("N,H,W,C,E,R", [(3, 8, 8, 16, 64, 4), (2, 16, 16, 24, 144, 6),
                                         (5, 4, 8, 40, 100, 10)])
def test_mbconv_block_matches_plain_version_on_card(cuda_device, N, H, W, C, E, R, dtype):
    w = _mbconv_weights(C, E, R, seed=E)
    x = torch.from_numpy((np.random.default_rng(N).standard_normal((N, H, W, C)) * 0.5)
                         .astype(np.float32)).to(cuda_device)
    before = mbconv.launches
    got = mbconv.mbconv_block_pallas(x, w, mxu_dtype=dtype)
    got_nchw = mbconv.mbconv_block_pallas(x.permute(0, 3, 1, 2).contiguous(), w,
                                          mxu_dtype=dtype, layout="nchw")
    torch.cuda.synchronize()
    assert mbconv.launches == before + 2
    ref = mbconv.mbconv_block_reference(x.permute(0, 3, 1, 2), w, dtype).permute(0, 2, 3, 1)
    tol = _tol(lambda dt: mbconv.mbconv_block_pallas(x, w, mxu_dtype=dt), dtype, ref)
    torch.testing.assert_close(got, ref, atol=tol, rtol=0)
    torch.testing.assert_close(got_nchw.permute(0, 2, 3, 1), ref, atol=tol, rtol=0)


def _assert_bf16_close(got, ref, tol):
    """got (bf16, rounded from the kernel's fp32) against ref (fp32): within tol + half an ulp."""
    assert got.dtype == torch.bfloat16
    half_ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 8)
    assert ((got.float() - ref).abs() <= tol + half_ulp).all(), (got.float() - ref).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_mrf_stage_bf16_input_on_card(cuda_device, entry):
    """bf16 x: the stage runs in fp32 and returns bf16, as the JAX entry points. The
    kernel reads and writes bf16 itself: its output is the fp32-x output rounded, bit for
    bit (chain mode at C=40, unit mode at C=128; both layouts)."""
    for C, B, T in ((40, 2, 300), (128, 1, 500)):
        w = _mrf_weights(C, seed=C)
        tiled = entry == "v1"
        x = torch.from_numpy((np.random.default_rng(T).standard_normal(
            (B, T, 3 * C if tiled else C)) * 0.5).astype(np.float32)).to(cuda_device)
        xb = x.to(torch.bfloat16)
        fn = mrf.mrf_stage_pallas if tiled else mrf.mrf_stage_pallas_v2
        kw = dict(channels=C, kernels=MRF_KERNELS, dils=MRF_DILS)
        before = mrf.launches[fn.__name__]
        got = fn(xb, w, **kw)
        torch.cuda.synchronize()
        assert mrf.launches[fn.__name__] == before + 1
        xt = xb.float().transpose(1, 2)
        xs = [xt[:, j * C:(j + 1) * C] for j in range(3)] if tiled else xt
        ref = mrf.mrf_stage_reference(xs, w, torch.bfloat16).transpose(1, 2)
        tol = _tol(lambda dt: fn(xb.float(), w, **dict(kw, mxu_dtype=dt)), torch.bfloat16, ref)
        _assert_bf16_close(got, ref, tol)
        assert torch.equal(got, fn(xb.float(), w, **kw).to(torch.bfloat16))
        bct = fn(xb.transpose(1, 2).contiguous(), w, layout="bct", **kw)
        assert bct.dtype == torch.bfloat16 and torch.equal(bct.transpose(1, 2), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("entry,B,T,C", [("v2", 2, 3001, 32), ("v1", 1, 1000, 128),
                                         ("v1", 1, 480, 256), ("v2", 3, 300, 48)])
def test_mrf_stage_repeats_bit_for_bit_on_card(cuda_device, entry, B, T, C, dtype):
    """The branch mean is summed in a fixed order, with no atomics: two calls on one
    input give the same bits."""
    w = _mrf_weights(C, seed=C)
    tiled = entry == "v1"
    x = torch.from_numpy((np.random.default_rng(T).standard_normal(
        (B, 3 * C if tiled else C, T)) * 0.5).astype(np.float32)).to(cuda_device)
    fn = mrf.mrf_stage_pallas if tiled else mrf.mrf_stage_pallas_v2
    kw = dict(channels=C, kernels=MRF_KERNELS, dils=MRF_DILS, mxu_dtype=dtype, layout="bct")
    first = fn(x, w, **kw)
    second = fn(x, w, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("N,H,W,C,E,R", [(1, 5, 5, 40, 100, 10), (3, 7, 3, 40, 100, 10),
                                         (2, 32, 32, 40, 100, 10), (300, 8, 8, 40, 100, 10),
                                         (2, 6, 6, 200, 300, 50)])
def test_mbconv_block_any_frame_size_on_card(cuda_device, N, H, W, C, E, R, dtype):
    """Frames of any size and batch (tiles with halos on both axes; one tile per frame;
    many tiles; C past 128), NHWC and NCHW."""
    w = _mbconv_weights(C, E, R, seed=E + H)
    x = torch.from_numpy((np.random.default_rng(N + W).standard_normal((N, H, W, C)) * 0.5)
                         .astype(np.float32)).to(cuda_device)
    before = mbconv.launches
    got = mbconv.mbconv_block_pallas(x, w, mxu_dtype=dtype)
    got_nchw = mbconv.mbconv_block_pallas(x.permute(0, 3, 1, 2).contiguous(), w,
                                          mxu_dtype=dtype, layout="nchw")
    torch.cuda.synchronize()
    assert mbconv.launches == before + 2
    ref = mbconv.mbconv_block_reference(x.permute(0, 3, 1, 2), w, dtype).permute(0, 2, 3, 1)
    tol = _tol(lambda dt: mbconv.mbconv_block_pallas(x, w, mxu_dtype=dt), dtype, ref)
    torch.testing.assert_close(got, ref, atol=tol, rtol=0)
    torch.testing.assert_close(got_nchw.permute(0, 2, 3, 1), ref, atol=tol, rtol=0)
    assert torch.equal(mbconv.mbconv_block_pallas(x, w, mxu_dtype=dtype), got)  # repeats


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_mbconv_block_bf16_input_on_card(cuda_device, dtype):
    """bf16 x read and written by the kernel itself; the residual adds the unrounded x."""
    N, H, W, C, E, R = 4, 16, 16, 24, 144, 6
    w = _mbconv_weights(C, E, R, seed=E)
    xb = torch.from_numpy((np.random.default_rng(N).standard_normal((N, C, H, W)) * 0.5)
                          .astype(np.float32)).to(cuda_device).to(torch.bfloat16)
    got = mbconv.mbconv_block_pallas(xb, w, mxu_dtype=dtype, layout="nchw")
    ref = mbconv.mbconv_block_reference(xb, w, dtype)
    tol = _tol(lambda dt: mbconv.mbconv_block_pallas(xb.float(), w, mxu_dtype=dt, layout="nchw"),
               dtype, ref)
    _assert_bf16_close(got, ref, tol)
    nhwc = mbconv.mbconv_block_pallas(xb.permute(0, 2, 3, 1).contiguous(), w, mxu_dtype=dtype)
    torch.testing.assert_close(nhwc.permute(0, 3, 1, 2), got, atol=0, rtol=0)


@pytest.mark.cuda
def test_mrf_and_mbconv_wrappers_reject_bad_inputs(cuda_device):
    w = _mrf_weights(32, seed=1)
    x = torch.zeros(1, 50, 32, device=cuda_device)
    with pytest.raises(TypeError):
        mrf.mrf_stage_pallas_v2(x.double(), w, channels=32)
    with pytest.raises(ValueError):
        mrf.mrf_stage_pallas_v2(x[:, ::2], w, channels=32)  # not contiguous
    with pytest.raises(ValueError):
        mrf.mrf_stage_pallas(x, w, channels=32)  # v1 takes 3C channels
    mw = _mbconv_weights(16, 64, 4, seed=2)
    # a 5x5 frame, refused until the kernel took frames of any size, computes
    x5 = torch.from_numpy((np.random.default_rng(5).standard_normal((1, 5, 5, 16)) * 0.5)
                          .astype(np.float32)).to(cuda_device)
    ref = mbconv.mbconv_block_reference(x5.permute(0, 3, 1, 2), mw, torch.float32)
    torch.testing.assert_close(mbconv.mbconv_block_pallas(x5, mw, mxu_dtype=torch.float32),
                               ref.permute(0, 2, 3, 1), atol=ATOL, rtol=0)
    with pytest.raises(TypeError):
        mbconv.mbconv_block_pallas(torch.zeros(1, 8, 8, 16, device=cuda_device).double(), mw)


FUSED_SPEC = (
    StageSpec("cn", 3, 1, 1, 8, 1),
    StageSpec("er", 3, 2, 2, 8, 1),
    StageSpec("ir", 3, 2, 2, 16, 2, 0.25),  # b1 fuses
)


@pytest.mark.cuda
def test_tiny_fused_pipeline_card_matches_cpu(cuda_device):
    """The fused configuration: per request K1 once, K3 once per stage, K4 once per fused block."""
    params, stats = random_acoustic_params(seed=44, spec=FUSED_SPEC, stem_channels=8,
                                           rnn_hidden=16)
    h = dict(default_vocoder_config(upsample_initial_channel=64))
    gen_params = random_generator_params(h, seed=45)
    scaler = MelScaler(mean=np.linspace(-40, -10, 64).astype(np.float32),
                       std=np.full(64, 5.0, np.float32))

    def pipe(device):
        model = acoustic_model_from_jax(params, stats, rnn_hidden=16, cnn_spec=FUSED_SPEC,
                                        cnn_stem=8, fuse_ir=True)
        gen = generator_from_jax(gen_params, h, fuse_mode=FUSED_MODE)
        return VideoToSpeechPipeline(model, gen, scaler, frame_bucket=8,
                                     input_norm="zscore_minmax", device=device)

    frames = (np.random.default_rng(46).random((13, 64, 64)) * 255).astype(np.uint8)
    before = (bilstm.launches["bilstm_recurrence"], dict(mrf.launches), mbconv.launches)
    card = pipe(cuda_device)(frames)
    assert (bilstm.launches["bilstm_recurrence"], mbconv.launches) == (before[0] + 1,
                                                                      before[2] + 1)
    # stages 0-1 through the v1 entry point, 2-3 through v2
    assert mrf.launches == {k: n + 2 for k, n in before[1].items()}
    cpu = pipe("cpu")(frames)
    for name, c, r, tol in zip(("audio", "mel_db", "mel_log"), card, cpu, (1e-4, 1e-2, 2.5e-3)):
        np.testing.assert_allclose(c, r, atol=tol, rtol=0, err_msg=name)


@pytest.mark.cuda
def test_tiny_fused_online_stream_card_matches_cpu(cuda_device):
    """The fused online path: per mel chunk two single-direction launches; per
    generator window K3 once per stage; per CNN chunk K4 once per fused block."""
    params, stats = random_acoustic_params(seed=50, spec=FUSED_SPEC, stem_channels=8,
                                           rnn_hidden=16)
    h = dict(default_vocoder_config(upsample_initial_channel=64))
    gen_params = random_generator_params(h, seed=51)
    scaler = MelScaler(mean=np.linspace(-40, -10, 64).astype(np.float32),
                       std=np.full(64, 5.0, np.float32))
    frames = (np.random.default_rng(52).random((37, 64, 64)) * 255).astype(np.uint8)

    def stream(device):
        model = acoustic_model_from_jax(params, stats, rnn_hidden=16, cnn_spec=FUSED_SPEC,
                                        cnn_stem=8, fuse_ir=True)
        online = OnlineVideoToSpeech(model, generator_from_jax(gen_params, h,
                                                               fuse_mode=FUSED_MODE),
                                     scaler, chunk=8, lookahead=8,
                                     input_norm="zscore_minmax", device=device)
        calls = {"cnn": 0, "gen": 0}
        for name in calls:
            def counted(*args, _fn=getattr(online, "_" + name), _name=name, **kwargs):
                calls[_name] += 1
                return _fn(*args, **kwargs)
            setattr(online, "_" + name, counted)
        pieces = [online.push(frames[i:i + 5]) for i in range(0, len(frames), 5)]
        pieces.append(online.flush())
        return (np.concatenate([a for a, _ in pieces]),
                np.concatenate([m for _, m in pieces if m.size])), online, calls

    before = (dict(bilstm.launches), dict(mrf.launches), mbconv.launches)
    card, online, calls = stream(cuda_device)
    assert bilstm.launches == dict(before[0], lstm_recurrence=before[0]["lstm_recurrence"]
                                   + 2 * online._n_mel_chunks)
    assert mrf.launches == {k: n + 2 * calls["gen"] for k, n in before[1].items()}
    assert mbconv.launches == before[2] + calls["cnn"]
    cpu, _, _ = stream("cpu")
    assert card[0].shape == cpu[0].shape == (37 * 420,)
    for name, c, r, tol in zip(("audio", "mel_db"), card, cpu, (1e-4, 1e-2)):
        np.testing.assert_allclose(c, r, atol=tol, rtol=0, err_msg=name)
