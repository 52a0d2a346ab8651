#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card; hold each kernel against its plain version.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
builds every kernel from `mri2speech_tpu_torch/csrc/`, then:

1. prints the card's name and power limit and the build time;
2. compares each kernel with its plain PyTorch version on the card at the
   shapes the main path gives it, and times kernel, plain version and a
   library call that computes the same function (a yardstick only);
3. serves a few requests through the full-width video -> speech pipeline
   (EfficientNetV2-B2, BiLSTM 640, HiFi-GAN 512 / rates 10,7,3,2; random
   weights from a seed, made in the JAX layout and carried across by
   `weights.py`), with every kernel's launch count set to 0 just before and
   read just after;
4. runs one request on the card and on the CPU (plain versions) and compares;
5. prints a JSON line of kernels and, last, {"ok": true, "device": {...}}.

Any failed check raises and the script exits non-zero. Without a card, or
without the package beside it, it exits non-zero and prints no result.
TF32 is off for matmuls and convolutions, so every number is fp32.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SR = 11413
H = 640            # BiLSTM hidden size at serving width
C_FEAT = 208       # EfficientNetV2-B2 feature width (BiLSTM input)
FRAME_BUCKET = 64
K1_TOL = 1e-4      # fp32 kernel vs plain: length-640 dot products summed in another
                   # order, carried through T steps of contractive gates
MEL_DB_TOL = 1e-2  # card vs CPU, dB: fp32 through ~60 conv layers summed in another order
MEL_LOG_TOL = 2.5e-3
AUDIO_TOL = 1e-4
FP32_PEAK = 67e12  # H100 SXM fp32 FLOP/s outside the tensor cores (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def k1_bound(T: int, B: int):
    """Least time for the BiLSTM recurrence on this card: (ms, "bytes" | "operations").

    Operations: the recurrent products, 2 directions x T x B x (4H x H) MACs.
    Bytes: xg read once, w_hh read once, h written once, the cell state
    written once. The T steps are dependent; the bound ignores that.
    """
    ops = 2 * T * B * 4 * H * H * 2
    nbytes = 4 * (2 * T * B * 4 * H + 2 * 4 * H * H + 2 * T * B * H + 2 * B * H)
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_k1(torch, bilstm):
    """K1 against its plain version at H=640; times at the main path's shapes."""
    g = torch.Generator(device="cpu").manual_seed(1)
    b = 1.0 / H ** 0.5
    # w_hh as BiLSTMSumMerge passes it: the (H, 4H) view of an (4H, H) nn.LSTM weight
    w_rows = [((torch.rand(4 * H, H, generator=g) * 2 - 1) * b).cuda() for _ in range(2)]
    w = [r.t() for r in w_rows]
    cases = []
    for T, lengths in ((70, [64]), (256, [256]), (128, [128, 101, 77, 40])):
        B = len(lengths)
        xf = torch.randn(T, B, 4 * H, generator=g).cuda()
        xb = torch.randn(T, B, 4 * H, generator=g).cuda()
        mask = torch.zeros(T, B)
        for i, n in enumerate(lengths):
            mask[:n, i] = 1.0
        mask = mask.cuda()
        kf, kb = bilstm.bilstm_recurrence(xf, xb, w[0], w[1], mask)
        ff, fb = bilstm.freeze_padded_steps(xf, mask), bilstm.freeze_padded_steps(xb, mask)
        rf, rb = bilstm.bilstm_recurrence_reference(ff, fb, w[0], w[1])
        torch.cuda.synchronize()
        real = (mask > 0)[..., None].expand(T, B, H)
        err_real = max((kf - rf).abs()[real].max().item(), (kb - rb).abs()[real].max().item())
        pad = ~real
        err_pad = (
            max((kf - rf).abs()[pad].max().item(), (kb - rb).abs()[pad].max().item())
            if pad.any() else 0.0
        )
        check(err_real <= K1_TOL, f"K1 T={T} B={B}: real-frame error {err_real} > {K1_TOL}")
        check(err_pad <= K1_TOL, f"K1 T={T} B={B}: padded-position error {err_pad} > {K1_TOL}")
        check(bool(torch.isfinite(kf).all() and torch.isfinite(kb).all()), "K1 output not finite")

        kernel_ms = cuda_ms(lambda: bilstm.bilstm_recurrence(xf, xb, w[0], w[1], mask))
        plain_ms = cuda_ms(
            lambda: bilstm.bilstm_recurrence_reference(
                bilstm.freeze_padded_steps(xf, mask), bilstm.freeze_padded_steps(xb, mask),
                w[0], w[1],
            )
        )
        lstm = torch.nn.LSTM(C_FEAT, H, bidirectional=True).cuda().eval()
        x_in = torch.randn(T, B, C_FEAT, generator=g).cuda()
        with torch.no_grad():
            library_ms = cuda_ms(lambda: lstm(x_in))
        bound_ms, bound_by = k1_bound(T, B)
        case = dict(T=T, B=B, lengths=lengths, err_real=err_real, err_pad=err_pad,
                    kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound_ms, bound_by=bound_by)
        cases.append(case)
        print(f"[k1] T={T} B={B} lengths={lengths}: max|err| real {err_real:.3e} "
              f"padded {err_pad:.3e} (tol {K1_TOL:g}); kernel {kernel_ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, cuDNN nn.LSTM {library_ms:.4f} ms "
              f"(includes the input projection); bound {bound_ms:.6f} ms ({bound_by})",
              flush=True)
    return cases


def build_pipeline(device: str, seed: int):
    """Full-width pipeline with random JAX-layout weights carried across by weights.py."""
    from mri2speech_tpu_torch.config import default_vocoder_config
    from mri2speech_tpu_torch.infer.pipeline import VideoToSpeechPipeline
    from mri2speech_tpu_torch.ops.scaler import MelScaler
    from mri2speech_tpu_torch.weights import (
        acoustic_model_from_jax,
        generator_from_jax,
        random_acoustic_params,
        random_generator_params,
    )

    h = dict(default_vocoder_config())
    params, stats = random_acoustic_params(seed, rnn_hidden=H)
    model = acoustic_model_from_jax(params, stats, rnn_hidden=H, lstm_impl="kernel")
    gen = generator_from_jax(random_generator_params(h, seed + 1), h)
    scaler = MelScaler(mean=np.linspace(-40, -10, 64).astype(np.float32),
                       std=np.full(64, 5.0, np.float32))
    hop = int(np.prod(h["upsample_rates"]))
    return VideoToSpeechPipeline(model, gen, scaler, hop_total=hop, frame_bucket=FRAME_BUCKET,
                                 input_norm="zscore_minmax", device=device)


def video(rng, T: int) -> np.ndarray:
    return rng.integers(0, 256, size=(T, 256, 256), dtype=np.uint8)


def stage_ms(torch, pipe, frames, reps: int = 3):
    """Device time of each stage of one warm request (CUDA events, median of `reps`)."""
    from mri2speech_tpu_torch.ops.mel import mel_db_to_log_power

    f, mask = pipe.prepare_inputs(frames)
    x, m = pipe._upload(f), pipe._upload(mask)
    names = ("normalize", "cnn", "bilstm_head", "vocoder")
    runs = {n: [] for n in names}
    with torch.inference_mode():
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
            ev[0].record()
            xn = pipe._normalize_frames(x)
            ev[1].record()
            pooled = pipe.acoustic_model._pooled(xn)
            ev[2].record()
            pred = pipe.acoustic_model.head_from_pooled(pooled, m)
            ev[3].record()
            pipe.generator(mel_db_to_log_power(pred * pipe.std + pipe.mean).transpose(1, 2))
            ev[4].record()
            ev[4].synchronize()
            for i, n in enumerate(names):
                runs[n].append(ev[i].elapsed_time(ev[i + 1]))
    return {n: statistics.median(v) for n, v in runs.items()}


def phase_pipeline(torch, bilstm, pipe, rng):
    """Serve requests through the port's main path; K1 must launch once per request.

    Each single-video request runs twice: the first call meets a new padded
    length (cold: cuDNN picks algorithms for the new shapes), the second is warm.
    """
    pipe(video(rng, 32))  # warm-up: CUDA context, allocator, the 64-frame bucket
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bilstm.launches = 0
    n_requests = 0
    for T in (250, 180, 64):
        frames = video(rng, T)
        walls = []
        for _ in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            audio, mel_db, mel_log = pipe(frames)
            walls.append(time.perf_counter() - t0)
            n_requests += 1
            check(audio.shape == (T * pipe.hop_total,), f"audio shape {audio.shape} for T={T}")
            check(mel_db.shape == mel_log.shape == (T, 64), f"mel shape {mel_db.shape}")
            for name, a in (("audio", audio), ("mel_db", mel_db), ("mel_log", mel_log)):
                check(bool(np.isfinite(a).all()), f"{name} not finite for T={T}")
            check(bilstm.launches == n_requests, f"K1 launches {bilstm.launches} != {n_requests}")
        seconds_audio = len(audio) / SR
        print(f"[pipeline] __call__ T={T}: cold {walls[0] * 1e3:.2f} ms, warm "
              f"{walls[1] * 1e3:.2f} ms wall (device-synchronised); warm RTF "
              f"{walls[1] / seconds_audio:.5f} at sr={SR}; max|audio| {np.abs(audio).max():.4f}",
              flush=True)
    lengths = (200, 120)
    videos = [video(rng, T) for T in lengths]
    walls = []
    for _ in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        audios, mels = pipe.infer_batch(videos)
        walls.append(time.perf_counter() - t0)
        n_requests += 1
        for T, a, m in zip(lengths, audios, mels):
            check(a.shape == (T * pipe.hop_total,) and m.shape == (T, 64), "infer_batch shapes")
            check(bool(np.isfinite(a).all() and np.isfinite(m).all()), "infer_batch not finite")
    launches = bilstm.launches
    check(launches == n_requests, f"K1 launches {launches} != {n_requests}")
    seconds_audio = sum(lengths) * pipe.hop_total / SR
    print(f"[pipeline] infer_batch T={list(lengths)}: cold {walls[0] * 1e3:.2f} ms, warm "
          f"{walls[1] * 1e3:.2f} ms wall; warm RTF {walls[1] / seconds_audio:.5f} over "
          f"{seconds_audio:.2f} s of audio", flush=True)
    print(f"[pipeline] torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"K1 launches on the main path: {launches} for {n_requests} requests", flush=True)
    stages = stage_ms(torch, pipe, video(rng, 250))
    print("[pipeline] device time by stage, T=250 (bucket 256), warm: " + ", ".join(
        f"{n} {v:.3f} ms" for n, v in stages.items()) + f"; sum {sum(stages.values()):.3f} ms",
        flush=True)
    return launches


def phase_card_vs_cpu(torch, pipe, rng):
    """One 70-frame request through the same weights on the card and on the CPU."""
    frames = video(rng, 70)
    a_gpu, db_gpu, log_gpu = pipe(frames)
    t0 = time.perf_counter()
    a_cpu, db_cpu, log_cpu = build_pipeline("cpu", seed=0)(frames)
    cpu_s = time.perf_counter() - t0
    diffs = {
        "mel_db": (float(np.abs(db_gpu - db_cpu).max()), MEL_DB_TOL),
        "mel_log": (float(np.abs(log_gpu - log_cpu).max()), MEL_LOG_TOL),
        "audio": (float(np.abs(a_gpu - a_cpu).max()), AUDIO_TOL),
    }
    for name, (d, tol) in diffs.items():
        print(f"[card-vs-cpu] T=70 max|{name} card - {name} cpu| = {d:.3e} (tol {tol:g})",
              flush=True)
        check(d <= tol, f"card vs CPU {name}: {d} > {tol}")
    print(f"[card-vs-cpu] max|audio| {np.abs(a_cpu).max():.4f}; CPU request "
          f"(build included) {cpu_s:.1f} s", flush=True)
    return diffs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    if not (REPO / "mri2speech_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no mri2speech_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from mri2speech_tpu_torch.ops import _build, bilstm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          "TF32 off for matmul and cuDNN (all fp32)", flush=True)

    t0 = time.perf_counter()
    sources = _build.all_sources()
    _build.build(sources)
    for name in sources:
        _build.load(name)
    print(f"[build] {', '.join(s + '.cu' for s in sources)} built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cases = phase_k1(torch, bilstm)
    rng = np.random.default_rng(0)
    pipe = build_pipeline("cuda", seed=0)
    launches = phase_pipeline(torch, bilstm, pipe, rng)
    phase_card_vs_cpu(torch, pipe, rng)

    main_case = next(c for c in cases if c["T"] == 256)  # the 250-frame request's bucket
    kernels = [{
        "name": "bilstm_recurrence",
        "route": "cuda",
        "source": "mri2speech_tpu_torch/csrc/bilstm_recurrence.cu",
        "replaces": "mri2speech_tpu/ops/pallas_lstm.py:304",
        "launches": launches,
        "max_abs_err": max(max(c["err_real"], c["err_pad"]) for c in cases),
        "ms": main_case["kernel_ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shape": {"T": main_case["T"], "B": main_case["B"], "H": H},
    }]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
