"""Online (bounded-latency) streaming video -> speech inference.

Counterpart of `mri2speech_tpu/infer/online.py:67-573`. Frames are pushed
incrementally and audio is emitted incrementally with a bounded,
configurable algorithmic latency, while staying faithful to the offline
pipeline (`infer/pipeline.py`):

* **CNN**: frame-wise, so chunked evaluation is exact.
* **Forward LSTM**: the (h, c) carry is threaded across chunks
  (`models/lstm.py::lstm_direction(init_state=..., return_state=True)`).
* **Backward LSTM**: the only non-causal part of the model, approximated
  with an R-frame lookahead: each emitted chunk's backward recurrence starts
  from the zero state R frames in the future. The error decays about
  exponentially in R (forget-gate products); R >= the stream length gives the
  offline output, and the final chunks of any stream are exact whatever R,
  because the drain's masked frames hold the zero carry until the last real
  frame (the offline boundary condition).
* **Generator**: windowed with the exact dependency cone
  (`models/vocoder.py::generator_receptive_field`), so every emitted sample
  is computed from the same mel taps as offline. The exception is the end
  of the stream: the final window runs the generator over the mel followed
  by masked (zero) frames, which offline does not have (there each conv
  pads its own input with zeros, and conv_pre's bias is not added beyond
  the last frame). So the last frame's samples equal the generator run on
  the mel padded with zero frames, and differ from offline, most in the
  last 6 samples (conv_post's right pad).

On a card, both recurrences of a mel chunk run through the single-direction
kernel in hold mode (`ops/bilstm.py::lstm_recurrence`): two launches per
emitted chunk. The fused configuration (`fuse_ir`, `FUSED_MODE`) adds K4 on
every CNN chunk and K3 on every generator window. The JAX package's jitted
programs are plain methods here, run under `torch.inference_mode()`; its
fusion of a mel step with a generator window into one program has no
counterpart (it saves a dispatch there, not work). `push` uploads each
group of up to `max_inflight_chunks` chunks from pinned host memory before
processing it, and all host fetches wait for `_collect`, so a multi-chunk
push queues every chunk's work back to back.

Worst-case algorithmic latency = (r + g + 1) chunks, r and g the lookahead
and generator-right-cone chunk counts (`latency_frames`).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from mri2speech_tpu_torch.data.audio_io import (
    load_video_frames_for_inference,
    write_wav_float,
)
from mri2speech_tpu_torch.device import resolve_device
from mri2speech_tpu_torch.infer.pipeline import (
    VideoToSpeechPipeline,
    build_pipeline_from_checkpoints,
)
from mri2speech_tpu_torch.models.acoustic import AcousticModel
from mri2speech_tpu_torch.models.lstm import lstm_direction
from mri2speech_tpu_torch.models.vocoder import Generator, generator_receptive_field
from mri2speech_tpu_torch.ops.mel import mel_db_to_log_power
from mri2speech_tpu_torch.ops.scaler import MelScaler
from mri2speech_tpu_torch.utils.transfer import prefetch_to_host


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class OnlineVideoToSpeech:
    """Incremental rtMRI-video -> speech with bounded latency.

    Usage::

        online = OnlineVideoToSpeech(model, generator, scaler, chunk=16, lookahead=16)
        for block in frame_source:          # (n, H, W) arrays, any n
            audio, mel_db = online.push(block)
            play(audio)
        audio, mel_db = online.flush()      # drain; exact tail
    """

    def __init__(
        self,
        acoustic_model: AcousticModel,
        generator: Generator,
        scaler: MelScaler,
        *,
        chunk: int = 16,
        lookahead: int = 16,
        input_norm: str = "none",
        max_inflight_chunks: int = 64,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if lookahead < 0:
            raise ValueError("lookahead must be >= 0")
        if max_inflight_chunks < 1:
            raise ValueError("max_inflight_chunks must be >= 1")
        if input_norm not in ("none", "zscore_minmax"):
            raise ValueError(
                f"input_norm must be 'none' or 'zscore_minmax', got {input_norm!r}"
            )
        # the JAX package refuses an int8 generator here (its activation scales
        # depend on the window); the port has none yet (ROADMAP item 16)
        self.device = resolve_device(device)
        self.acoustic_model = acoustic_model.to(self.device).eval()
        self.generator = generator.to(self.device).eval()
        self.mean = torch.as_tensor(scaler.mean, dtype=torch.float32, device=self.device)
        self.std = torch.as_tensor(scaler.std, dtype=torch.float32, device=self.device)
        self.input_norm = input_norm

        # bounds device memory on bulk pushes: push() uploads a group of chunks
        # before processing it and defers host fetches, so without a cap a
        # whole-video push would hold every frame chunk and output on the device
        self.max_inflight_chunks = int(max_inflight_chunks)
        self.W = int(chunk)
        self.r = _ceil_div(int(lookahead), self.W)  # backward-LSTM lookahead chunks
        left, right = generator_receptive_field(generator.h)
        self.l = _ceil_div(left, self.W)   # generator left-context chunks
        self.g = _ceil_div(right, self.W)  # generator lookahead chunks
        self.K = self.l + 1 + self.g       # generator window, in chunks
        self.hop = int(np.prod(generator.h["upsample_rates"]))
        self.reset()

    @classmethod
    def from_pipeline(cls, pipeline: VideoToSpeechPipeline, **kwargs) -> "OnlineVideoToSpeech":
        """Build on an offline `VideoToSpeechPipeline`: its models, scaler, device
        and (unless given) its input normalisation."""
        scaler = MelScaler(mean=pipeline.mean.cpu().numpy(), std=pipeline.std.cpu().numpy())
        kwargs.setdefault("input_norm", pipeline.input_norm)
        return cls(pipeline.acoustic_model, pipeline.generator, scaler,
                   device=pipeline.device, **kwargs)

    def fork(self) -> "OnlineVideoToSpeech":
        """A fresh stream over the same models.

        All mutable stream state lives in the fields that `reset()` sets, so
        forks are independent streams that share the modules and their
        weights: a server can run many sessions on one set of weights.
        """
        new = object.__new__(type(self))
        new.__dict__.update(self.__dict__)
        new.reset()
        return new

    # -- properties --------------------------------------------------------
    @property
    def latency_frames(self) -> int:
        """Worst-case frames between pushing frame f and receiving its audio
        (steady state; the very first emission also waits for the
        generator's left context to fill)."""
        return (self.r + self.g + 1) * self.W

    # -- lifecycle ---------------------------------------------------------
    def reset(self) -> None:
        H = self.acoustic_model.rnn.hidden_size
        self._h = torch.zeros((1, H), dtype=torch.float32, device=self.device)
        self._c = torch.zeros((1, H), dtype=torch.float32, device=self.device)
        self._pending: list = []        # raw frames not yet forming a chunk
        self._pending_count = 0
        self._feat_chunks: list = []    # [(device (1,W,C), np mask (W,))]
        self._mel_chunks: list = []     # device (1,W,M) masked mel_log
        self._mel_base = 0              # absolute chunk index of _mel_chunks[0]
        self._n_mel_chunks = 0
        self._n_audio_chunks = 0        # audio emitted through chunk index-1
        self._t_real = 0                # real frames pushed so far
        self._mel_frames_out = 0        # valid mel frames already returned
        self._audio_samples_out = 0     # valid audio samples already returned
        self._frame_hw: Optional[tuple] = None
        self._frame_dtype = None
        self._finished = False

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; on a card from pinned memory, non-blocking."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- the programs -------------------------------------------------
    @torch.inference_mode()
    def _cnn(self, frames: torch.Tensor) -> torch.Tensor:
        """(1, W, 1, H, W') frames -> (1, W, C) pooled features (frame-wise)."""
        if self.input_norm == "zscore_minmax":
            frames = VideoToSpeechPipeline._normalize_frames(frames)
        return self.acoustic_model._pooled(frames)

    @torch.inference_mode()
    def _mel_step(self, feat_chunks, mask, h, c):
        """Emit mels for the OLDEST chunk of an (r+1)-chunk feature window.

        feat_chunks: (r+1) tensors (1, W, C); mask (1, (r+1)*W) 1=real.
        Forward runs the first W frames from the carried (h, c); backward
        runs the whole window from the zero state (the R-frame lookahead
        approximation, exact under drain masks). Returns (mel_db (1,W,M),
        masked mel_log (1,W,M), h', c').
        """
        p = self.acoustic_model.rnn.jax_layout_params()
        feats = torch.cat(tuple(feat_chunks), dim=1)
        W = self.W
        fwd, (h2, c2) = lstm_direction(
            feats[:, :W], p["w_ih_fwd"], p["w_hh_fwd"], p["b_fwd"],
            mask=mask[:, :W], init_state=(h, c), return_state=True,
        )
        bwd = lstm_direction(
            feats, p["w_ih_bwd"], p["w_hh_bwd"], p["b_bwd"], reverse=True, mask=mask,
        )
        y = fwd + bwd[:, :W]
        pred = self.acoustic_model.head(y).float()
        mel_db = pred * self.std + self.mean
        mel_log = mel_db_to_log_power(mel_db) * mask[:, :W, None]
        return mel_db, mel_log, h2, c2

    @torch.inference_mode()
    def _gen(self, mel_chunks, *, prefix: bool) -> torch.Tensor:
        """K-chunk mel_log window -> audio slice.

        prefix=True: the window IS the stream start (the generator's own left
        zero padding is the true boundary condition) -> emit chunks [0, l+1).
        prefix=False: emit the window's (l+1)-th chunk only; its dependency
        cone lies strictly inside the window.
        """
        mel = torch.cat(tuple(mel_chunks), dim=1)  # (1, K*W, M)
        audio = self.generator(mel.transpose(1, 2))
        s = self.W * self.hop
        if prefix:
            return audio[:, :, : (self.l + 1) * s]
        return audio[:, :, self.l * s : (self.l + 1) * s]

    # -- streaming engine --------------------------------------------------
    def _process_chunk(self, frames, mask_np: np.ndarray, out) -> None:
        """One W-frame chunk through CNN -> (maybe) mel emission -> (maybe)
        audio emission(s); outputs are appended to `out` as device tensors
        (host fetches wait for `_collect`, so multi-chunk pushes queue).

        frames: (W, H, W') host array, or an already uploaded device tensor
        of shape (1, W, 1, H, W') (`push` uploads a group of chunks first).
        """
        if isinstance(frames, np.ndarray):
            frames = self._to_device(frames[None, :, None])
        feats = self._cnn(frames)
        self._feat_chunks.append((feats, mask_np))

        if len(self._feat_chunks) >= self.r + 1:
            window = tuple(f for f, _ in self._feat_chunks)
            masks = np.concatenate([m for _, m in self._feat_chunks])
            mel_db, mel_log, self._h, self._c = self._mel_step(
                window, self._to_device(masks[None]), self._h, self._c,
            )
            emitted_mask = self._feat_chunks[0][1]
            self._feat_chunks.pop(0)
            self._mel_chunks.append(mel_log)
            self._n_mel_chunks += 1
            # return the valid rows of this chunk (real frames are a prefix
            # of the stream, so valid rows are wherever mask==1)
            n_valid = int(emitted_mask.sum())
            if n_valid:
                out["mel"].append(mel_db[0, :n_valid])
                self._mel_frames_out += n_valid

        self._emit_audio(out)
        # drop mel chunks no longer needed as left context
        while self._mel_base < self._n_audio_chunks - self.l:
            self._mel_chunks.pop(0)
            self._mel_base += 1

    def _emit_audio(self, out) -> None:
        while True:
            j = self._n_audio_chunks
            if j == 0:
                if self._n_mel_chunks < self.K:
                    return
                audio = self._gen(tuple(self._mel_chunks[: self.K]), prefix=True)
                emitted_through = self.l + 1
            else:
                if self._n_mel_chunks < j + self.g + 1:
                    return
                lo = j - self.l - self._mel_base
                audio = self._gen(tuple(self._mel_chunks[lo : lo + self.K]), prefix=False)
                emitted_through = j + 1
            self._n_audio_chunks = emitted_through
            # this emission's global sample span; trim to real frames
            span_lo = (
                emitted_through - (self.l + 1 if j == 0 else 1)
            ) * self.W * self.hop
            end = min(emitted_through * self.W, self._t_real) * self.hop
            if end > self._audio_samples_out:
                out["audio"].append(audio[0, 0, self._audio_samples_out - span_lo : end - span_lo])
                self._audio_samples_out = end

    @torch.inference_mode()
    def push(self, frames: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Feed (n, H, W) frames (any n >= 0); returns (audio, mel_db) newly
        available, possibly empty arrays while the lookahead fills."""
        if self._finished:
            raise RuntimeError("stream finished; call reset() first")
        frames = np.asarray(frames)
        if frames.ndim != 3:
            raise ValueError(f"expected (n, H, W) frames, got {frames.shape}")
        if self._frame_hw is None:
            self._frame_hw = frames.shape[1:]
            self._frame_dtype = frames.dtype
        elif frames.shape[1:] != self._frame_hw:
            raise ValueError(
                f"frame size changed mid-stream: {frames.shape[1:]} vs {self._frame_hw}"
            )
        out = {"audio": [], "mel": []}
        self._t_real += frames.shape[0]
        if self._pending_count + frames.shape[0] < self.W:
            if frames.shape[0]:
                self._pending.append(frames)
                self._pending_count += frames.shape[0]
            return self._collect(out)
        # one concat, then slice W-frame chunks out of it (no O(n^2) recopy
        # of the remainder on bulk pushes)
        buf = np.concatenate(self._pending + [frames], axis=0)
        self._pending, self._pending_count = [], 0
        ones = np.ones(self.W, np.float32)
        # upload a group of chunks before processing it: the copies are
        # non-blocking, so chunk i+1's upload is queued while chunk i's work
        # runs. Groups of max_inflight_chunks bound what a whole-video push
        # holds on the device at once.
        n_chunks = buf.shape[0] // self.W
        G = self.max_inflight_chunks
        for g0 in range(0, n_chunks, G):
            devs = [
                self._to_device(buf[i * self.W : (i + 1) * self.W][None, :, None])
                for i in range(g0, min(g0 + G, n_chunks))
            ]
            for d in devs:
                self._process_chunk(d, ones, out)
            if g0 + G < n_chunks:
                # group boundary: bring the outputs to the host, releasing the
                # group's device buffers before the next group uploads
                self._fetch(out)
        pos = n_chunks * self.W
        if pos < buf.shape[0]:
            self._pending = [buf[pos:]]
            self._pending_count = buf.shape[0] - pos
        return self._collect(out)

    @torch.inference_mode()
    def flush(self) -> Tuple[np.ndarray, np.ndarray]:
        """Drain the stream: emits everything remaining. The drain's masked
        chunks make the final frames' backward LSTM exact (see module doc)."""
        if self._finished:
            return np.zeros((0,), np.float32), np.zeros((0, 0), np.float32)
        out = {"audio": [], "mel": []}
        if self._pending_count:
            buf = np.concatenate(self._pending, axis=0)
            pad = self.W - buf.shape[0]
            chunk = np.concatenate([buf, np.repeat(buf[-1:], pad, axis=0)], axis=0)
            mask = np.concatenate(
                [np.ones(buf.shape[0], np.float32), np.zeros(pad, np.float32)]
            )
            self._pending, self._pending_count = [], 0
            self._process_chunk(chunk, mask, out)
        if self._t_real:
            limit = self.r + self.g + self.K + 2
            zeros = np.zeros((self.W,) + self._frame_hw, dtype=self._frame_dtype)
            for _ in range(limit):
                if (
                    self._audio_samples_out >= self._t_real * self.hop
                    and self._mel_frames_out >= self._t_real
                ):
                    break
                self._process_chunk(zeros, np.zeros(self.W, np.float32), out)
        self._finished = True
        return self._collect(out)

    @staticmethod
    def _fetch(out) -> None:
        """Replace the device tensors in `out` by host copies, with one wait."""
        n = len(out["audio"])
        host = prefetch_to_host(*out["audio"], *out["mel"])
        out["audio"], out["mel"] = host[:n], host[n:]

    def _collect(self, out) -> Tuple[np.ndarray, np.ndarray]:
        """Fetch the push's outputs (audio slices (S,), mel_db rows (n, M)) at
        the end: deferring the wait to here lets a multi-chunk push queue
        every chunk before the host waits."""
        self._fetch(out)
        audio = (torch.cat(out["audio"]).numpy() if out["audio"]
                 else np.zeros((0,), np.float32))
        mel = (torch.cat(out["mel"]).numpy() if out["mel"]
               else np.zeros((0, int(self.mean.shape[0])), np.float32))
        return audio, mel


def main(argv=None) -> None:
    """CLI: stream a video file through the online path as if in real time;
    writes the wav and reports per-push wall time against the real-time
    budget (the offline surface is `infer.pipeline:main`)."""
    ap = argparse.ArgumentParser(
        description="rtMRI -> Speech ONLINE streaming inference "
        "(bounded-latency incremental emission, PyTorch/CUDA)"
    )
    ap.add_argument("--video", required=True)
    ap.add_argument("--mri-checkpoint", required=True)
    ap.add_argument("--scaler-json", required=True)
    ap.add_argument("--hifigan-config", required=True)
    ap.add_argument("--hifigan-checkpoint", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--chunk", type=int, default=16, help="frames per push")
    ap.add_argument(
        "--lookahead", type=int, default=16,
        help="backward-LSTM lookahead frames (exactness/latency trade)",
    )
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    video = Path(args.video)
    if not video.exists():
        raise FileNotFoundError(f"Video file not found: {video}")
    frames = load_video_frames_for_inference(video, max_frames=args.max_frames)

    pipe = build_pipeline_from_checkpoints(
        args.mri_checkpoint, args.scaler_json, args.hifigan_config,
        args.hifigan_checkpoint, device=dev,
    )
    online = OnlineVideoToSpeech.from_pipeline(
        pipe, chunk=args.chunk, lookahead=args.lookahead, input_norm="none"
    )
    with open(args.hifigan_config, "r", encoding="utf-8") as f:
        sr = json.load(f)["sampling_rate"]
    budget = args.chunk * online.hop / sr

    # warm up (enough chunks that the prefix AND the steady generator windows
    # both run), then stream for real
    warm_n = min(len(frames), online.latency_frames + (online.l + 1) * online.W)
    online.push(frames[:warm_n])
    online.flush()
    online.reset()

    pieces, times = [], []
    for i in range(0, frames.shape[0], args.chunk):
        t0 = time.perf_counter()
        audio, _ = online.push(frames[i : i + args.chunk])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)  # a push that emits nothing returns before its work ends
        times.append(time.perf_counter() - t0)
        pieces.append(audio)
    audio, _ = online.flush()
    pieces.append(audio)
    wav = np.concatenate(pieces)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    wav_path = out_dir / f"{video.stem}_online.wav"
    write_wav_float(str(wav_path), wav, sr)

    med = float(np.median(times))
    print("[DONE] Online streaming inference complete.")
    print(f"  Device   : {dev}")
    print(f"  Audio    : {wav_path} ({wav.size / sr:.2f}s)")
    print(f"  Chunk    : {args.chunk} frames ({budget * 1000:.0f} ms budget)")
    print(f"  Median   : {med * 1000:.1f} ms/chunk -> steady RTF {med / budget:.3f}")
    print(f"  Worst    : {max(times) * 1000:.1f} ms/chunk")
    print(f"  Latency  : {online.latency_frames} frames "
          f"({online.latency_frames * online.hop / sr:.2f}s algorithmic)")


if __name__ == "__main__":
    main()
