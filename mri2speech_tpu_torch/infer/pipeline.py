"""End-to-end rtMRI video -> speech inference on one device.

Counterpart of `mri2speech_tpu/infer/pipeline.py:36-664`: frames (per-frame
z-score -> min-max, optionally on the device) -> acoustic model -> scaler
denormalisation -> dB -> ln-power bridge -> HiFi-GAN generator -> waveform
and mel artifacts. Frame counts are padded up to a multiple of
`frame_bucket` by repeating the last frame; the BiLSTM masks the padded
steps with the gate freeze of `ops/bilstm.py`, so the mels of real frames
do not depend on the padding, and the padded mels reach only the last few
frames of audio through the generator's right context.

Not yet ported: the streaming upload, the device mesh, sequence-parallel
serving and the int8 vocoder; asking for them raises NotImplementedError.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Tuple, Union

import numpy as np
import torch

from mri2speech_tpu_torch.data.audio_io import (
    load_video_frames_for_inference,
    write_wav_float,
)
from mri2speech_tpu_torch.device import resolve_device
from mri2speech_tpu_torch.models.acoustic import AcousticModel
from mri2speech_tpu_torch.models.vocoder import Generator
from mri2speech_tpu_torch.ops.mel import mel_db_to_log_power
from mri2speech_tpu_torch.ops.scaler import MelScaler


def _not_ported(streaming, mesh, sequence_parallel, quantize=False) -> None:
    for flag, name in (
        (streaming, "streaming"), (mesh is not None, "mesh"),
        (sequence_parallel, "sequence_parallel"), (quantize, "int8 quantization"),
    ):
        if flag:
            raise NotImplementedError(f"{name} is not ported to mri2speech_tpu_torch yet")


class VideoToSpeechPipeline:
    """Acoustic model + vocoder over padded frame buckets, on one device."""

    def __init__(
        self,
        acoustic_model: AcousticModel,
        generator: Generator,
        scaler: MelScaler,
        *,
        hop_total: int = 420,
        frame_bucket: int = 64,
        input_norm: str = "none",
        device: Union[str, torch.device] = "cuda",
        streaming: bool = False,
        mesh=None,
        sequence_parallel: bool = False,
    ) -> None:
        """input_norm: "none" (frames arrive normalised) or "zscore_minmax" (the
        inference normalisation runs on the device, so frames may be raw uint8)."""
        if input_norm not in ("none", "zscore_minmax"):
            raise ValueError(
                f"input_norm must be 'none' or 'zscore_minmax', got {input_norm!r}"
            )
        _not_ported(streaming, mesh, sequence_parallel)
        self.device = resolve_device(device)
        self.acoustic_model = acoustic_model.to(self.device).eval()
        self.generator = generator.to(self.device).eval()
        self.mean = torch.as_tensor(scaler.mean, dtype=torch.float32, device=self.device)
        self.std = torch.as_tensor(scaler.std, dtype=torch.float32, device=self.device)
        self.hop_total = hop_total
        self.frame_bucket = max(1, int(frame_bucket))
        self.input_norm = input_norm

    @staticmethod
    def _normalize_frames(frames: torch.Tensor) -> torch.Tensor:
        """Per-frame z-score -> min-max [0, 1] over the last two axes; a constant frame -> 0."""
        f = frames.float()
        mean = f.mean(dim=(-2, -1), keepdim=True)
        std = f.std(dim=(-2, -1), keepdim=True, correction=0)
        g = (f - mean) / torch.where(std > 0, std, torch.ones_like(std))
        lo = g.amin(dim=(-2, -1), keepdim=True)
        hi = g.amax(dim=(-2, -1), keepdim=True)
        span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
        return torch.where(hi > lo, (g - lo) / span, torch.zeros_like(g))

    @torch.inference_mode()
    def _forward(self, frames: torch.Tensor, mask: torch.Tensor):
        """frames (B, Tp, 1, H, W), mask (B, Tp) -> (audio (B, 1, Tp*hop), mel_db, mel_log)."""
        if self.input_norm == "zscore_minmax":
            frames = self._normalize_frames(frames)
        else:
            frames = frames.float()
        pred_norm = self.acoustic_model(frames, mask)  # (B, Tp, n_mels)
        mel_db = pred_norm * self.std + self.mean
        mel_log = mel_db_to_log_power(mel_db)
        audio = self.generator(mel_log.transpose(1, 2))
        return audio, mel_db, mel_log

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _run_device(self, frames: np.ndarray):
        f, mask = self.prepare_inputs(frames)
        return self._forward(self._upload(f), self._upload(mask))

    def __call__(self, frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """frames (T, H, W) -> (audio (T*hop,), mel_db (T, n_mels), mel_log (T, n_mels))."""
        audio, mel_db, mel_log = self._run_device(frames)
        T = frames.shape[0]
        return (
            audio[0, 0, : T * self.hop_total].cpu().numpy(),
            mel_db[0, :T].cpu().numpy(),
            mel_log[0, :T].cpu().numpy(),
        )

    def infer_audio(self, frames: np.ndarray) -> np.ndarray:
        """Serving path: frames -> waveform; only the audio comes back to the host."""
        audio, _, _ = self._run_device(frames)
        return audio[0, 0, : frames.shape[0] * self.hop_total].cpu().numpy()

    def infer_batch(self, videos, batch_multiple: int = 1):
        """N videos -> (N waveforms, N mel_db arrays) in one batched forward.

        Every video is replicate-padded to the batch's padded length and
        masked; each output is trimmed to its own length. A video's last
        fraction of a second sees the batch's padding instead of its solo
        run's, within the generator's receptive field. `batch_multiple` pads
        the batch with fully masked copies of the last video.
        """
        videos = list(videos)
        if not videos:
            return [], []
        Ts = [int(v.shape[0]) for v in videos]
        hw = videos[0].shape[1:]
        tm = self.frame_bucket
        Tp = ((max(Ts) + tm - 1) // tm) * tm
        bm = max(1, int(batch_multiple))
        B = ((len(videos) + bm - 1) // bm) * bm
        dt = np.result_type(*[v.dtype for v in videos])
        fb = np.empty((B, Tp, 1) + hw, dtype=dt)
        mb = np.zeros((B, Tp), dtype=np.float32)
        for i, v in enumerate(videos):
            if v.shape[1:] != hw:
                raise ValueError(
                    f"all videos in a batch must share the frame size; got "
                    f"{v.shape[1:]} vs {hw}"
                )
            fb[i, : Ts[i], 0] = v
            fb[i, Ts[i]:, 0] = v[-1]  # replicate-pad (masked in the BiLSTM)
            mb[i, : Ts[i]] = 1.0
        fb[len(videos):] = fb[len(videos) - 1]
        audio, mel_db, _ = self._forward(self._upload(fb), self._upload(mb))
        audio = audio.cpu().numpy()
        mel_db = mel_db.cpu().numpy()
        return (
            [audio[i, 0, : t * self.hop_total] for i, t in enumerate(Ts)],
            [mel_db[i, :t] for i, t in enumerate(Ts)],
        )

    def prepare_inputs(self, frames: np.ndarray):
        """Pad (T, H, W) frames to the bucket as (1, Tp, 1, H, W) and build the (1, Tp) mask."""
        T = frames.shape[0]
        tm = self.frame_bucket
        Tp = ((T + tm - 1) // tm) * tm
        if Tp == T:
            f = frames.reshape(1, T, 1, *frames.shape[1:])
        else:
            f = np.empty((1, Tp, 1) + frames.shape[1:], dtype=frames.dtype)
            f[0, :T, 0] = frames
            f[0, T:, 0] = frames[-1]  # replicate-pad (masked in the BiLSTM)
        mask = np.zeros((1, Tp), dtype=np.float32)
        mask[0, :T] = 1.0
        return f, mask

    def timed_run(self, frames: np.ndarray, sr: int = 11413, warmup: bool = True):
        """(audio, stats) with device-synchronised wall time and RTF."""
        T = frames.shape[0]
        if warmup:
            self.infer_audio(frames)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        audio = self.infer_audio(frames)  # the copy to the host waits for the device
        dt = time.perf_counter() - t0
        duration = len(audio) / sr
        return audio, {
            "frames": T,
            "seconds_audio": duration,
            "seconds_compute": dt,
            "rtf": dt / duration if duration > 0 else float("inf"),
        }


def build_pipeline_from_checkpoints(
    mri_checkpoint: str,
    scaler_json: str,
    hifigan_config: str,
    hifigan_checkpoint: str,
    *,
    n_mels: int = 64,
    rnn_hidden: int = 640,
    dropout: float = 0.5,
    frame_bucket: int = 64,
    input_norm: str = "none",
    device: Union[str, torch.device] = "cuda",
    streaming: bool = False,
    quantize: bool = False,
    mesh=None,
    sequence_parallel: bool = False,
) -> VideoToSpeechPipeline:
    """Pipeline from the JAX package's checkpoint files (flax msgpack) and scaler.json."""
    from mri2speech_tpu_torch.infer.vocoder_io import load_generator
    from mri2speech_tpu_torch.train import checkpoint as ckpt_io
    from mri2speech_tpu_torch.weights import acoustic_model_from_jax

    _not_ported(streaming, mesh, sequence_parallel, quantize)
    dev = resolve_device(device)
    scaler = MelScaler.load(scaler_json)
    if scaler.n_mels != n_mels:
        raise ValueError("Scaler mean/std length does not match n_mels")
    obj = ckpt_io.load_checkpoint_raw(mri_checkpoint)
    params = obj.get("params", obj.get("model_state_dict", obj))
    model = acoustic_model_from_jax(
        params, obj.get("batch_stats", {}), n_mels=n_mels, rnn_hidden=rnn_hidden,
        dropout=dropout, lstm_impl="kernel",
    )
    generator = load_generator(hifigan_config, hifigan_checkpoint, device=dev)
    hop_total = int(np.prod(generator.h["upsample_rates"]))
    return VideoToSpeechPipeline(
        model, generator, scaler, hop_total=hop_total, frame_bucket=frame_bucket,
        input_norm=input_norm, device=dev,
    )


def save_outputs(audio, mel_db, output_dir: Path, sampling_rate: int, stem: str):
    """wav + mel .npy + mel .png artifact bundle."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    output_dir.mkdir(parents=True, exist_ok=True)
    audio_path = output_dir / f"{stem}_generated.wav"
    write_wav_float(str(audio_path), audio, sampling_rate)
    mel_path = output_dir / f"{stem}_mel.npy"
    np.save(mel_path, mel_db)

    plt.figure(figsize=(12, 4))
    plt.imshow(mel_db.T, aspect="auto", origin="lower", cmap="viridis")
    plt.colorbar()
    plt.title(f"Generated Mel Spectrogram - {stem}")
    plt.xlabel("Time")
    plt.ylabel("Mel bins")
    plt.tight_layout()
    fig_path = output_dir / f"{stem}_mel.png"
    plt.savefig(fig_path, dpi=150)
    plt.close()
    return audio_path, mel_path, fig_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="rtMRI -> Speech inference (acoustic model + HiFi-GAN, PyTorch/CUDA)"
    )
    parser.add_argument("--video", required=True)
    parser.add_argument("--mri-checkpoint", required=True)
    parser.add_argument("--scaler-json", required=True)
    parser.add_argument("--hifigan-config", required=True)
    parser.add_argument("--hifigan-checkpoint", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--n-mels", type=int, default=64)
    parser.add_argument("--rnn-hidden", type=int, default=640)
    parser.add_argument("--dropout", type=float, default=0.5)
    parser.add_argument("--frame-bucket", type=int, default=64)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu runs the plain versions)")
    parser.add_argument("--streaming", action="store_true", help="not ported yet")
    parser.add_argument("--int8", action="store_true", help="not ported yet")
    parser.add_argument("--num-devices", type=int, default=1, help="not ported yet beyond 1")
    parser.add_argument("--model-devices", type=int, default=1, help="not ported yet beyond 1")
    args = parser.parse_args(argv)

    if args.num_devices > 1 or args.model_devices > 1:
        raise NotImplementedError("multi-device serving is not ported to mri2speech_tpu_torch yet")
    dev = resolve_device(args.device)
    video_path = Path(args.video)
    if not video_path.exists():
        raise FileNotFoundError(f"Video file not found: {video_path}")

    pipeline = build_pipeline_from_checkpoints(
        args.mri_checkpoint, args.scaler_json, args.hifigan_config,
        args.hifigan_checkpoint, n_mels=args.n_mels, rnn_hidden=args.rnn_hidden,
        dropout=args.dropout, frame_bucket=args.frame_bucket, device=dev,
        streaming=args.streaming, quantize=args.int8,
    )
    frames = load_video_frames_for_inference(video_path, max_frames=args.max_frames)
    with open(args.hifigan_config, "r", encoding="utf-8") as f:
        sr = json.load(f)["sampling_rate"]
    # the first pass warms up and fetches the mel artifacts; the timed pass skips its warmup
    audio, mel_db, mel_log = pipeline(frames)
    audio, stats = pipeline.timed_run(frames, sr=sr, warmup=False)
    stem = video_path.stem
    output_dir = Path(args.output_dir)
    audio_path, mel_path, fig_path = save_outputs(audio, mel_db, output_dir, sr, stem)
    log_mel_path = output_dir / f"{stem}_mel_log.npy"
    np.save(log_mel_path, mel_log)

    print("[DONE] Inference complete.")
    print(f"  Device: {dev}")
    print(f"  RTF   : {stats['rtf']:.4f} ({stats['seconds_compute']:.2f}s for {stats['seconds_audio']:.2f}s audio)")
    print(f"  Audio : {audio_path}")
    print(f"  Mel   : {mel_path}")
    print(f"  LogMel: {log_mel_path}")
    print(f"  Figure: {fig_path}")


if __name__ == "__main__":
    main()
