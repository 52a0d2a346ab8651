"""Host-side audio/video IO of the inference path.

Counterpart of `mri2speech_tpu/data/audio_io.py:69-74, 164-212`. OpenCV is
imported inside the functions that read video, so the rest of the package
runs without it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def write_wav_float(path: str, data: np.ndarray, sr: int) -> None:
    """Write float audio as float32 PCM."""
    from scipy.io.wavfile import write

    write(path, sr, data.astype(np.float32))


def preprocess_inference_frame(frame: np.ndarray, target_size=(256, 256)) -> np.ndarray:
    """Gray, resize, per-frame z-score (population std) -> min-max to [0, 1]."""
    import cv2

    gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame
    if gray.shape[::-1] != tuple(target_size):
        gray = cv2.resize(gray, tuple(target_size), interpolation=cv2.INTER_LINEAR)
    gray = gray.astype(np.float32)
    mean, std = gray.mean(), gray.std()
    gray = (gray - mean) / std if std > 0 else gray - mean
    lo, hi = gray.min(), gray.max()
    if hi > lo:
        return (gray - lo) / (hi - lo)
    return np.zeros_like(gray)


def load_video_frames_for_inference(
    video_path: Path, target_size=(256, 256), max_frames: Optional[int] = None
) -> np.ndarray:
    """(T, H, W) float32 frames with the inference normalisation."""
    import cv2

    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise ValueError(f"Unable to open video: {video_path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if max_frames is not None:
            total = min(total, max_frames)
        frames = []
        for _ in range(total):
            ret, frame = cap.read()
            if not ret:
                break
            frames.append(preprocess_inference_frame(frame, target_size))
    finally:
        cap.release()
    if not frames:
        raise ValueError("No frames could be read from video")
    return np.asarray(frames, dtype=np.float32)
