"""The port's video -> speech pipeline on the CPU against the JAX serving path.

The JAX side is built as it serves on a TPU: BiLSTM through the Pallas kernel
(interpret mode here), stem_s2d and pad_ir on, the generator in
`default_fuse_mode` with polyphase upsampling. Frames are uint8 with the
on-device "zscore_minmax" normalisation and T is not a bucket multiple, so
the padded tail and the generator's right context over it are compared too.

Tolerances, each well above the fp32 reordering differences seen: mel_db
1e-3 dB (values -40..-10 dB; ~4e-6 seen), mel_log 1e-4 (ln-power; ~1.4e-6
seen), audio 1e-5 absolute (tanh output up to ~0.13; ~3e-8 seen).
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mri2speech_tpu.config import default_vocoder_config as jax_default_config
from mri2speech_tpu.infer.pipeline import VideoToSpeechPipeline as JaxPipeline
from mri2speech_tpu.models.acoustic import AcousticModel as JaxAcousticModel
from mri2speech_tpu.models.effnetv2 import StageSpec as JaxStageSpec
from mri2speech_tpu.models.layers import fold_weight_norm
from mri2speech_tpu.models.vocoder import Generator as JaxGenerator
from mri2speech_tpu.models.vocoder import default_fuse_mode, fuse_mrf_params
from mri2speech_tpu.ops.scaler import MelScaler as JaxMelScaler
from mri2speech_tpu.train import checkpoint as jax_ckpt
from mri2speech_tpu_torch.infer import pipeline as port_pipeline
from mri2speech_tpu_torch.infer.vocoder_io import load_generator
from mri2speech_tpu_torch.models.effnetv2 import StageSpec
from mri2speech_tpu_torch.ops import bilstm
from mri2speech_tpu_torch.ops.mel import mel_db_to_log_power
from mri2speech_tpu_torch.ops.scaler import MelScaler
from mri2speech_tpu_torch.weights import (
    acoustic_model_from_jax,
    generator_from_jax,
    random_acoustic_params,
    random_generator_params,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
JAX_TINY_SPEC = (
    JaxStageSpec("cn", 3, 1, 1, 8, 1),
    JaxStageSpec("er", 3, 2, 2, 8, 1),
    JaxStageSpec("ir", 3, 2, 2, 16, 1, 0.25),
)
TINY_SPEC = tuple(StageSpec(**vars(s)) for s in JAX_TINY_SPEC)
TOL = {"audio": 1e-5, "mel_db": 1e-3, "mel_log": 1e-4}


@pytest.fixture(scope="module")
def weights():
    params, stats = random_acoustic_params(
        seed=21, spec=TINY_SPEC, stem_channels=8, rnn_hidden=16
    )
    h = dict(jax_default_config(upsample_initial_channel=16))
    gen_params = random_generator_params(h, seed=22)
    mean = np.linspace(-40, -10, 64).astype(np.float32)
    std = np.full(64, 5.0, dtype=np.float32)
    return params, stats, h, gen_params, mean, std


@pytest.fixture(scope="module")
def pipelines(weights):
    params, stats, h, gen_params, mean, std = weights
    jm = JaxAcousticModel(
        n_mels=64, rnn_hidden=16, cnn_spec=JAX_TINY_SPEC, cnn_stem=8,
        lstm_impl="pallas", stem_s2d=True, pad_ir=True,
    )
    mode = default_fuse_mode(h)
    jgen = JaxGenerator(h=h, use_weight_norm=False, fuse_mrf=True, fuse_mode=mode)
    jparams = fuse_mrf_params(fold_weight_norm(gen_params), h, mode=mode)
    jax_pipe = JaxPipeline(
        jm, {"params": params, "batch_stats": stats}, jgen, jparams,
        JaxMelScaler(mean=mean, std=std), frame_bucket=8, input_norm="zscore_minmax",
    )
    model = acoustic_model_from_jax(
        params, stats, rnn_hidden=16, cnn_spec=TINY_SPEC, cnn_stem=8, lstm_impl="kernel"
    )
    port = port_pipeline.VideoToSpeechPipeline(
        model, generator_from_jax(gen_params, h), MelScaler(mean=mean, std=std),
        frame_bucket=8, input_norm="zscore_minmax", device="cpu",
    )
    return jax_pipe, port


def _video(seed, T):
    return (np.random.default_rng(seed).random((T, 64, 64)) * 255).astype(np.uint8)


def _close(name, got, ref):
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL[name], rtol=0, err_msg=name)


def test_pipeline_call_matches_jax_serving_path(pipelines):
    jax_pipe, port = pipelines
    frames = _video(23, 13)  # pads to 16: three masked replicate frames
    launches = dict(bilstm.launches)
    got = port(frames)
    ref = jax_pipe(frames)
    assert got[0].shape == (13 * 420,) and got[1].shape == (13, 64)
    for name, g, r in zip(("audio", "mel_db", "mel_log"), got, ref):
        _close(name, g, r)
    # the tail: the last real frame's audio, which sees the padded mels
    _close("audio", got[0][-420:], ref[0][-420:])
    np.testing.assert_allclose(port.infer_audio(frames), got[0], atol=0, rtol=0)
    assert bilstm.launches == launches  # CPU tensors never reach the kernel


def test_pipeline_infer_batch_matches_jax(pipelines):
    jax_pipe, port = pipelines
    videos = [_video(24, 13), _video(25, 6)]
    audios, mels = port.infer_batch(videos, batch_multiple=3)
    ref_audios, ref_mels = jax_pipe.infer_batch(videos, batch_multiple=3)
    assert [len(a) for a in audios] == [13 * 420, 6 * 420]
    for a, r in zip(audios, ref_audios):
        _close("audio", a, r)
    for m, r in zip(mels, ref_mels):
        _close("mel_db", m, r)
    assert port.infer_batch([]) == ([], [])


def test_normalize_frames_matches_jax():
    rng = np.random.default_rng(26)
    frames = (rng.random((1, 4, 1, 9, 7)) * 255).astype(np.uint8)
    frames[0, 2] = 17  # constant frame -> 0
    ref = np.asarray(JaxPipeline._normalize_frames(frames))
    got = port_pipeline.VideoToSpeechPipeline._normalize_frames(torch.from_numpy(frames))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    assert np.all(got.numpy()[0, 2] == 0.0)


def test_mel_bridge_matches_jax():
    from mri2speech_tpu.ops.mel import mel_db_to_log_power as jax_bridge

    db = np.linspace(-80, 20, 257).astype(np.float32)
    got = mel_db_to_log_power(torch.from_numpy(db)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_bridge(db)), atol=1e-5, rtol=1e-6)


def _write_avi(path: Path, n_frames: int, hw=(64, 64)):
    import cv2

    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 27.17, (hw[1], hw[0]))
    assert w.isOpened()
    rng = np.random.default_rng(27)
    for _ in range(n_frames):
        w.write((rng.random((hw[0], hw[1], 3)) * 255).astype(np.uint8))
    w.release()


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    """A cv2-written AVI and checkpoints written by the JAX package's save_checkpoint.

    The CLI builds the full-width EfficientNetV2-B2 encoder, so its checkpoint
    has B2 shapes; the BiLSTM (16) and the generator (16 channels) are tiny.
    """
    d = tmp_path_factory.mktemp("cli")
    _write_avi(d / "utt.avi", 5)
    params, stats = random_acoustic_params(seed=28, rnn_hidden=16)
    jax_ckpt.save_checkpoint(str(d / "acoustic.ckpt"), {"params": params, "batch_stats": stats})
    h = dict(jax_default_config(upsample_initial_channel=16))
    jax_ckpt.save_checkpoint(str(d / "g_00000001"), {"generator": random_generator_params(h, 29)})
    (d / "config.json").write_text(json.dumps(h))
    JaxMelScaler(
        mean=np.linspace(-40, -10, 64).astype(np.float32), std=np.full(64, 5.0, np.float32)
    ).save(d / "scaler.json")
    return d


def _cli_args(d, out, *extra):
    return [
        "--video", str(d / "utt.avi"), "--mri-checkpoint", str(d / "acoustic.ckpt"),
        "--scaler-json", str(d / "scaler.json"), "--hifigan-config", str(d / "config.json"),
        "--hifigan-checkpoint", str(d / "g_00000001"), "--output-dir", str(out),
        "--rnn-hidden", "16", "--frame-bucket", "8", *extra,
    ]


def test_main_cli_on_cpu(cli_files, tmp_path, capsys):
    from scipy.io import wavfile

    port_pipeline.main(_cli_args(cli_files, tmp_path, "--device", "cpu"))
    assert "[DONE]" in capsys.readouterr().out
    sr, audio = wavfile.read(tmp_path / "utt_generated.wav")
    mel_db = np.load(tmp_path / "utt_mel.npy")
    mel_log = np.load(tmp_path / "utt_mel_log.npy")
    assert sr == 11413 and audio.shape == (5 * 420,) and audio.dtype == np.float32
    assert mel_db.shape == mel_log.shape == (5, 64)
    assert (tmp_path / "utt_mel.png").is_file()
    assert np.all(np.isfinite(audio)) and np.all(np.isfinite(mel_db))
    np.testing.assert_allclose(
        mel_log, mel_db_to_log_power(torch.from_numpy(mel_db)).numpy(), atol=1e-6
    )


def test_entry_points_refuse_to_run_without_a_card(cli_files, weights, tmp_path, monkeypatch):
    """No card and no device="cpu": every entry point raises, nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params, stats, h, gen_params, mean, std = weights
    model = acoustic_model_from_jax(params, stats, rnn_hidden=16, cnn_spec=TINY_SPEC, cnn_stem=8)
    gen = generator_from_jax(gen_params, h)
    with pytest.raises(RuntimeError, match="cuda"):
        port_pipeline.VideoToSpeechPipeline(model, gen, MelScaler(mean=mean, std=std))
    files = [str(cli_files / n) for n in ("acoustic.ckpt", "scaler.json", "config.json",
                                          "g_00000001")]
    with pytest.raises(RuntimeError, match="cuda"):
        port_pipeline.build_pipeline_from_checkpoints(*files, rnn_hidden=16)
    with pytest.raises(RuntimeError, match="cuda"):
        load_generator(files[2], files[3])
    with pytest.raises(RuntimeError, match="cuda"):
        port_pipeline.main(_cli_args(cli_files, tmp_path))
    assert not (tmp_path / "utt_generated.wav").exists()


def test_unported_modes_raise(cli_files, tmp_path):
    for extra in (["--streaming"], ["--int8"], ["--num-devices", "2"]):
        with pytest.raises(NotImplementedError):
            port_pipeline.main(_cli_args(cli_files, tmp_path, "--device", "cpu", *extra))


def test_port_imports_no_jax():
    """Every port module plus chip_smoke.py, in a fresh interpreter: no jax, no JAX package."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import mri2speech_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mri2speech_tpu', 'tools'))\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
