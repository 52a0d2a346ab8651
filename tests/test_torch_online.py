"""The port's online streaming (infer/online.py) on the CPU.

The first seven tests mirror `tests/test_online.py` at its tiny size
(TINY_SPEC, BiLSTM 16, generator 16 channels), against the port's own
offline pipeline, with that file's tolerances: mel 1e-4 absolute / 1e-5
relative and audio 1e-5 absolute except the last 6 samples (conv_post's
right-pad boundary, see the module doc). Differences seen at full
lookahead: mel 1.9e-6; audio 7.4e-6 at the 7th sample from the end (still
the boundary's reach) and ~2e-7 before it.

Then the port against the JAX package's `OnlineVideoToSpeech` on the same
weights, carried across by `weights.py`, at a finite lookahead (chunk 8,
lookahead 8, T = 37): the lookahead approximation itself is held to the
reference, audio to its last sample. fp32 under the same limits (3.8e-6 and
4.5e-8 seen); the fused configuration (fuse_ir, FUSED_MODE; Pallas in
interpret mode on the JAX side) under the fused pipeline test's limits,
mel_db 2e-5 dB and audio 5e-7 (3.8e-6 and 1.1e-8 seen), with the port's fp32
configuration as the control that must fail the mel limit (2.2e-4 dB).
"""
import json

import numpy as np
import pytest
import torch

from mri2speech_tpu.config import default_vocoder_config as jax_default_config
from mri2speech_tpu.infer.online import OnlineVideoToSpeech as JaxOnline
from mri2speech_tpu.models.acoustic import AcousticModel as JaxAcousticModel
from mri2speech_tpu.models.effnetv2 import StageSpec as JaxStageSpec
from mri2speech_tpu.models.layers import fold_weight_norm as jax_fold_weight_norm
from mri2speech_tpu.models.vocoder import Generator as JaxGenerator
from mri2speech_tpu.models.vocoder import fuse_mrf_params
from mri2speech_tpu.ops.scaler import MelScaler as JaxMelScaler
from mri2speech_tpu.train import checkpoint as jax_ckpt
from mri2speech_tpu_torch.infer import online as port_online
from mri2speech_tpu_torch.infer.online import OnlineVideoToSpeech
from mri2speech_tpu_torch.infer.pipeline import VideoToSpeechPipeline
from mri2speech_tpu_torch.models.effnetv2 import StageSpec
from mri2speech_tpu_torch.models.vocoder import FUSED_MODE, generator_receptive_field
from mri2speech_tpu_torch.ops import bilstm, mbconv, mrf
from mri2speech_tpu_torch.ops.scaler import MelScaler
from mri2speech_tpu_torch.weights import (
    acoustic_model_from_jax,
    generator_from_jax,
    random_acoustic_params,
    random_generator_params,
)

torch.set_num_threads(1)

JAX_TINY_SPEC = (
    JaxStageSpec("cn", 3, 1, 1, 8, 1),
    JaxStageSpec("er", 3, 2, 2, 8, 1),
    JaxStageSpec("ir", 3, 2, 2, 16, 1, 0.25),
)
JAX_FUSED_SPEC = JAX_TINY_SPEC[:2] + (JaxStageSpec("ir", 3, 2, 2, 16, 2, 0.25),)  # b1 fuses
TINY_SPEC = tuple(StageSpec(**vars(s)) for s in JAX_TINY_SPEC)
FUSED_SPEC = tuple(StageSpec(**vars(s)) for s in JAX_FUSED_SPEC)
MEL = dict(atol=1e-4, rtol=1e-5)
AUDIO = dict(atol=1e-5, rtol=0)
FUSED_TOL = {"mel_db": 2e-5, "audio": 5e-7}
MEAN = np.linspace(-40, -10, 64).astype(np.float32)
STD = np.full(64, 5.0, dtype=np.float32)


def _port_models(spec=TINY_SPEC, fused=False, seed=0):
    params, stats = random_acoustic_params(seed, spec=spec, stem_channels=8, rnn_hidden=16)
    h = dict(jax_default_config(upsample_initial_channel=16))
    gen_params = random_generator_params(h, seed + 1)
    model = acoustic_model_from_jax(params, stats, rnn_hidden=16, cnn_spec=spec, cnn_stem=8,
                                    fuse_ir=fused)
    gen = generator_from_jax(gen_params, h, fuse_mode=FUSED_MODE if fused else None)
    return model, gen, (params, stats, gen_params, h)


@pytest.fixture(scope="module")
def tiny_setup():
    model, gen, _ = _port_models()
    return model, gen, MelScaler(mean=MEAN, std=STD), gen.h


def _online(tiny_setup, **kw):
    model, gen, scaler, _ = tiny_setup
    return OnlineVideoToSpeech(model, gen, scaler, device="cpu", **kw)


def _offline(tiny_setup, **kw):
    model, gen, scaler, _ = tiny_setup
    return VideoToSpeechPipeline(model, gen, scaler, frame_bucket=1, device="cpu", **kw)


def _stream(online, frames, step=None):
    """Push `frames` (all at once, or `step` at a time), flush; (audio, mel_db)."""
    step = step or max(len(frames), 1)
    pieces = [online.push(frames[i:i + step]) for i in range(0, len(frames), step)]
    pieces.append(online.flush())
    audio = np.concatenate([a for a, _ in pieces])
    mel = np.concatenate([m for _, m in pieces if m.size], axis=0)
    return audio, mel


def test_receptive_field_bounds_true_cone(tiny_setup):
    """Perturb one mel frame; every changed audio sample's frame index lies
    within [t0 - right, t0 + left]: the computed cone bounds the port
    generator's true dependencies."""
    _, gen, _, h = tiny_setup
    left, right = generator_receptive_field(h)
    hop = int(np.prod(h["upsample_rates"]))
    T = left + right + 12
    t0 = left + 5
    mel = np.random.default_rng(0).standard_normal((1, 64, T)).astype(np.float32)
    mel2 = mel.copy()
    mel2[:, :, t0] += 100.0  # large: the N(0, 0.01)-init stack attenuates hard
    with torch.no_grad():
        base = gen(torch.from_numpy(mel)).numpy()
        pert = gen(torch.from_numpy(mel2)).numpy()
    changed = np.nonzero((base != pert)[0, 0])[0]  # ANY bitwise change counts
    assert changed.size > 0
    frames = changed // hop
    assert frames.min() >= t0 - right
    assert frames.max() <= t0 + left


@pytest.mark.parametrize("T", [40, 37])
def test_online_exact_with_full_lookahead(tiny_setup, T):
    """lookahead >= stream length: online == offline, except the final <= 6
    audio samples. All of them, the last 6 included, are the offline
    generator run on the offline mel_log followed by zero frames, which the
    final window's masked chunks are (3.0e-8 seen: convs of another length
    sum in another order)."""
    _, gen, _, _ = tiny_setup
    frames = np.random.default_rng(3).random((T, 32, 32)).astype(np.float32)
    offline = _offline(tiny_setup)
    audio_ref, mel_ref, mel_log = offline(frames)
    audio, mel = _stream(_online(tiny_setup, chunk=8, lookahead=T + 8), frames)
    assert mel.shape == mel_ref.shape
    assert audio.shape == audio_ref.shape
    np.testing.assert_allclose(mel, mel_ref, **MEL)
    np.testing.assert_allclose(audio[:-6], audio_ref[:-6], **AUDIO)
    padded = np.concatenate([mel_log, np.zeros((32, mel_log.shape[1]), np.float32)])
    with torch.no_grad():
        ref = gen(torch.from_numpy(padded.T[None].copy()))[0, 0, :T * offline.hop_total]
    np.testing.assert_allclose(audio, ref.numpy(), **AUDIO)


def test_online_incremental_equals_bulk(tiny_setup):
    """Frame-by-frame pushes produce bit-identical output to one big push."""
    frames = np.random.default_rng(5).random((60, 32, 32)).astype(np.float32)
    kw = dict(chunk=8, lookahead=8)
    audio_bulk, mel_bulk = _stream(_online(tiny_setup, **kw), frames)
    inc = _online(tiny_setup, **kw)
    pieces = [inc.push(frames[i:i + 1]) for i in range(frames.shape[0])]
    pieces.append(inc.flush())
    np.testing.assert_array_equal(np.concatenate([a for a, _ in pieces]), audio_bulk)
    np.testing.assert_array_equal(
        np.concatenate([m for _, m in pieces if m.size], axis=0), mel_bulk)
    # outputs stream with bounded latency: something must arrive mid-stream
    assert any(a.size for a, _ in pieces[:-1])


def test_online_bounded_inflight_equals_unbounded(tiny_setup):
    """max_inflight_chunks is a scheduling knob only: a whole-video push
    crossing 4 group boundaries is bit-identical to the unbounded default."""
    frames = np.random.default_rng(7).random((80, 32, 32)).astype(np.float32)
    kw = dict(chunk=8, lookahead=8)
    ref = _stream(_online(tiny_setup, **kw), frames)
    got = _stream(_online(tiny_setup, max_inflight_chunks=2, **kw), frames)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_online_finite_lookahead_tail_exact(tiny_setup):
    """A finite lookahead is approximate mid-stream but exact for the final
    chunks, and more lookahead never increases the error."""
    T, W = 56, 8
    frames = np.random.default_rng(7).random((T, 32, 32)).astype(np.float32)
    _, mel_ref, _ = _offline(tiny_setup)(frames)
    errs = {}
    for lk in (8, 32):
        online = _online(tiny_setup, chunk=W, lookahead=lk)
        _, mel = _stream(online, frames)
        assert mel.shape == mel_ref.shape
        assert np.all(np.isfinite(mel))
        errs[lk] = np.max(np.abs(mel - mel_ref))
        # emission of chunk j uses frames through (j + r + 1) * W
        exact_from = (T // W - online.r) * W
        np.testing.assert_allclose(mel[exact_from:], mel_ref[exact_from:], **MEL)
    assert errs[32] <= errs[8] + 1e-6


def test_online_uint8_zscore_matches_offline(tiny_setup):
    """from_pipeline inherits the pipeline's on-device input normalisation:
    raw uint8 frames through the online path == the offline uint8 pipeline."""
    T = 24
    frames = (np.random.default_rng(11).random((T, 32, 32)) * 255).astype(np.uint8)
    offline = _offline(tiny_setup, input_norm="zscore_minmax")
    audio_ref, mel_ref, _ = offline(frames)
    online = OnlineVideoToSpeech.from_pipeline(offline, chunk=8, lookahead=T + 8)
    assert online.input_norm == "zscore_minmax" and online.device == offline.device
    audio, mel = _stream(online, frames)
    np.testing.assert_allclose(mel, mel_ref, **MEL)
    np.testing.assert_allclose(audio[:-6], audio_ref[:-6], **AUDIO)


def test_online_rejects_bad_inputs(tiny_setup):
    online = _online(tiny_setup, chunk=8, lookahead=8)
    with pytest.raises(ValueError):
        online.push(np.zeros((4, 32)))
    online.push(np.zeros((4, 32, 32), np.float32))
    with pytest.raises(ValueError):
        online.push(np.zeros((4, 16, 16), np.float32))
    online.flush()
    with pytest.raises(RuntimeError):
        online.push(np.zeros((4, 32, 32), np.float32))
    # empty stream flush
    online2 = _online(tiny_setup, chunk=8)
    a, m = online2.flush()
    assert a.size == 0 and m.size == 0
    assert online2.latency_frames == (online2.r + online2.g + 1) * 8
    for kw in (dict(chunk=0), dict(lookahead=-1), dict(max_inflight_chunks=0),
               dict(input_norm="minmax")):
        with pytest.raises(ValueError):
            _online(tiny_setup, **kw)


def _jax_online(weights, fused, **kw):
    params, stats, gen_params, h = weights
    spec = JAX_FUSED_SPEC if fused else JAX_TINY_SPEC
    acoustic = JaxAcousticModel(n_mels=64, rnn_hidden=16, cnn_spec=spec, cnn_stem=8,
                                fuse_ir=fused, pad_ir=False)
    folded = jax_fold_weight_norm(gen_params)
    if fused:
        gen = JaxGenerator(h=h, use_weight_norm=False, fuse_mrf=True, fuse_mode=FUSED_MODE)
        folded = fuse_mrf_params(folded, h, mode=FUSED_MODE)
    else:
        gen = JaxGenerator(h=h, use_weight_norm=False)
    return JaxOnline(acoustic, {"params": params, "batch_stats": stats}, gen, folded,
                     JaxMelScaler(mean=MEAN, std=STD), **kw)


def _counts():
    return dict(bilstm.launches), dict(mrf.launches), mbconv.launches


def test_online_matches_jax_online_finite_lookahead():
    """The lookahead approximation itself, against the JAX package's online path."""
    model, gen, weights = _port_models(seed=30)
    frames = np.random.default_rng(31).random((37, 32, 32)).astype(np.float32)
    kw = dict(chunk=8, lookahead=8)
    counts = _counts()
    audio, mel = _stream(
        OnlineVideoToSpeech(model, gen, MelScaler(mean=MEAN, std=STD), device="cpu", **kw),
        frames)
    assert _counts() == counts  # CPU tensors run the plain versions
    audio_ref, mel_ref = _stream(_jax_online(weights, False, **kw), frames)
    assert audio.shape == audio_ref.shape == (37 * 420,) and mel.shape == mel_ref.shape
    np.testing.assert_allclose(mel, mel_ref, **MEL)
    np.testing.assert_allclose(audio, audio_ref, **AUDIO)


def test_fused_online_matches_jax_fused_online():
    """The fused configuration on both sides; the port's fp32 one is the control."""
    model, gen, weights = _port_models(spec=FUSED_SPEC, fused=True, seed=32)
    fp32_model, fp32_gen, _ = _port_models(spec=FUSED_SPEC, seed=32)
    frames = np.random.default_rng(33).random((37, 32, 32)).astype(np.float32)
    kw = dict(chunk=8, lookahead=8)
    scaler = MelScaler(mean=MEAN, std=STD)
    audio, mel = _stream(OnlineVideoToSpeech(model, gen, scaler, device="cpu", **kw), frames)
    audio_ref, mel_ref = _stream(_jax_online(weights, True, **kw), frames)
    np.testing.assert_allclose(mel, mel_ref, atol=FUSED_TOL["mel_db"], rtol=0)
    np.testing.assert_allclose(audio, audio_ref, atol=FUSED_TOL["audio"], rtol=0)
    _, mel_fp32 = _stream(
        OnlineVideoToSpeech(fp32_model, fp32_gen, scaler, device="cpu", **kw), frames)
    assert np.abs(mel_fp32 - mel_ref).max() > FUSED_TOL["mel_db"]


def test_forks_interleaved_equal_sequential(tiny_setup):
    """Two forks pushed in turns give what each stream gives on its own."""
    rng = np.random.default_rng(13)
    videos = [rng.random((T, 32, 32)).astype(np.float32) for T in (45, 29)]
    base = _online(tiny_setup, chunk=8, lookahead=8)
    solo = [_stream(base.fork(), v, step=5) for v in videos]
    forks = [base.fork(), base.fork()]
    pieces = [[], []]
    for i in range(0, max(len(v) for v in videos), 5):
        for k, (f, v) in enumerate(zip(forks, videos)):
            if i < len(v):
                pieces[k].append(f.push(v[i:i + 5]))
    for k, f in enumerate(forks):
        pieces[k].append(f.flush())
        np.testing.assert_array_equal(np.concatenate([a for a, _ in pieces[k]]), solo[k][0])
        np.testing.assert_array_equal(
            np.concatenate([m for _, m in pieces[k] if m.size], axis=0), solo[k][1])


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A cv2-written AVI and checkpoints written by the JAX package's save_checkpoint:
    the full-width B2 encoder and BiLSTM the CLI builds, a 16-channel generator."""
    import cv2

    d = tmp_path_factory.mktemp("online_cli")
    w = cv2.VideoWriter(str(d / "utt.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 27.17, (64, 64))
    assert w.isOpened()
    rng = np.random.default_rng(34)
    for _ in range(21):
        w.write((rng.random((64, 64, 3)) * 255).astype(np.uint8))
    w.release()
    params, stats = random_acoustic_params(seed=35)
    jax_ckpt.save_checkpoint(str(d / "acoustic.ckpt"), {"params": params, "batch_stats": stats})
    h = dict(jax_default_config(upsample_initial_channel=16))
    jax_ckpt.save_checkpoint(str(d / "g_00000001"), {"generator": random_generator_params(h, 36)})
    (d / "config.json").write_text(json.dumps(h))
    JaxMelScaler(mean=MEAN, std=STD).save(d / "scaler.json")
    return d


def _cli_args(d, out, *extra):
    return [
        "--video", str(d / "utt.avi"), "--mri-checkpoint", str(d / "acoustic.ckpt"),
        "--scaler-json", str(d / "scaler.json"), "--hifigan-config", str(d / "config.json"),
        "--hifigan-checkpoint", str(d / "g_00000001"), "--output-dir", str(out),
        "--chunk", "8", "--lookahead", "8", *extra,
    ]


def test_online_cli_on_cpu(cli_files, tmp_path, capsys):
    from scipy.io import wavfile

    port_online.main(_cli_args(cli_files, tmp_path, "--device", "cpu"))
    report = capsys.readouterr().out
    assert "[DONE]" in report and "Latency" in report
    sr, audio = wavfile.read(tmp_path / "utt_online.wav")
    assert sr == 11413 and audio.shape == (21 * 420,) and audio.dtype == np.float32
    assert np.all(np.isfinite(audio))


def test_online_cli_refuses_to_run_without_a_card(cli_files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_online.main(_cli_args(cli_files, tmp_path))
    model, gen, _ = _port_models()
    with pytest.raises(RuntimeError, match="cuda"):
        OnlineVideoToSpeech(model, gen, MelScaler(mean=MEAN, std=STD))
    assert not (tmp_path / "utt_online.wav").exists()
