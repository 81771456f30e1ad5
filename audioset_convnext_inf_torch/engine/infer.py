"""Inference front ends: single-clip tagging, long-audio sliding windows,
embedding extraction.

The port's counterpart of the JAX package's ``engine/infer.py``: the
reference's demo_convnext.py (tagging at a probability threshold) and
extract_embeddings.py (per-file logits or embeddings), plus long audio
split into 10-s windows that run as one batch shape. Results are numpy.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from audioset_convnext_inf_torch.config import CLIP_SAMPLES, SAMPLE_RATE
from audioset_convnext_inf_torch.data.audio_io import pad_or_truncate, read_wav
from audioset_convnext_inf_torch.labels import read_audioset_label_tags


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def load_clip(path: str, clip_samples: int = CLIP_SAMPLES,
              sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """A file read, resampled and padded or cropped to one (1, clip_samples)
    f32 clip (demo_convnext.py:52-69)."""
    wav, _ = read_wav(path, target_sr=sample_rate)
    return pad_or_truncate(wav, clip_samples)[None, :].astype(np.float32)


def tag_clip(model, waveform: np.ndarray, threshold: float = 0.25,
             labels_csv: Optional[str] = None) -> Dict[str, object]:
    """Tag one clip: the classes above ``threshold`` (demo_convnext.py:85-92)."""
    out = model.forward(waveform)
    probs = _numpy(out["clipwise_output"])[0]
    idx = np.where(probs > threshold)[0]
    lm = read_audioset_label_tags(labels_csv)
    return {
        "probs": probs,
        "logits": _numpy(out["clipwise_logits"])[0],
        "indexes": idx,
        "labels": [lm.ix_to_lb[int(i)] for i in idx],
    }


def sliding_windows(waveform: np.ndarray, window_samples: int = CLIP_SAMPLES,
                    hop_samples: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """(N,) audio -> ((num_windows, window_samples), num_windows), the tail
    zero-padded. int16 PCM stays int16 (the model decodes it on the card);
    anything else becomes float32."""
    hop = hop_samples or window_samples
    n = len(waveform)
    num_windows = max(1, -(-max(n - window_samples, 0) // hop) + 1)
    total = (num_windows - 1) * hop + window_samples
    if waveform.dtype != np.int16:
        waveform = waveform.astype(np.float32)
    padded = np.pad(waveform, (0, max(0, total - n)))
    return (
        np.stack([padded[i * hop: i * hop + window_samples] for i in range(num_windows)]),
        num_windows,
    )


def _batches(windows: np.ndarray, batch_size: int):
    """(chunk padded to batch_size, real count) over the windows: one batch
    shape for any length of audio."""
    for start in range(0, len(windows), batch_size):
        chunk = windows[start: start + batch_size]
        k = len(chunk)
        if k < batch_size:
            chunk = np.pad(chunk, ((0, batch_size - k), (0, 0)))
        yield chunk, k


def tag_long_audio(model, waveform: np.ndarray, window_samples: int = CLIP_SAMPLES,
                   hop_samples: Optional[int] = None, batch_size: int = 32,
                   reduce: str = "max") -> Dict[str, np.ndarray]:
    """Window -> batch -> forward -> reduce ('max' or 'mean' over windows).
    Returns {'windowwise_output' (W, 527), 'clipwise_output' (527,)}."""
    windows, n = sliding_windows(waveform, window_samples, hop_samples)
    outs: List[np.ndarray] = [_numpy(model.forward(chunk)["clipwise_output"])
                              for chunk, _ in _batches(windows, batch_size)]
    windowwise = np.concatenate(outs)[:n]
    clipwise = windowwise.max(axis=0) if reduce == "max" else windowwise.mean(axis=0)
    return {"windowwise_output": windowwise, "clipwise_output": clipwise}


def embed_long_audio(model, waveform: np.ndarray, window_samples: int = CLIP_SAMPLES,
                     batch_size: int = 32) -> Dict[str, np.ndarray]:
    """Non-overlapping 10-s windows through one batch shape; the per-window
    frame embeddings (C, 31, 7) join along the time axis -> (C, 31*W, 7).
    They differ from a whole-clip forward by receptive-field edge effects
    at the window boundaries.

    Returns {'frame_embeddings' (C, 31*W, 7), 'windowwise_scene' (W, C),
    'scene_embedding' (C,), the mean over windows}.
    """
    windows, n = sliding_windows(waveform, window_samples)
    frames: List[np.ndarray] = []
    scenes: List[np.ndarray] = []
    for chunk, k in _batches(windows, batch_size):
        frames.append(_numpy(model.forward_frame_embeddings(chunk))[:k])
        scenes.append(_numpy(model.forward_scene_embeddings(chunk))[:k])
    fr = np.concatenate(frames)[:n]  # (W, C, T, F)
    windowwise_scene = np.concatenate(scenes)[:n]
    return {
        "frame_embeddings": np.concatenate(list(fr), axis=1),  # time-axis stitch
        "windowwise_scene": windowwise_scene,
        "scene_embedding": windowwise_scene.mean(axis=0),
    }


def extract_embeddings_to_hdf5(model, wav_paths: Sequence[str], out_hdf5: str,
                               kind: str = "logits", sample_rate: int = SAMPLE_RATE) -> int:
    """Forward each file (padded or cropped to 10 s) and store one vector per
    file id in an HDF5 file (extract_embeddings.py:57-99); ``kind`` is
    'logits' or 'scene'. A file that cannot be read is logged and skipped,
    not swallowed; a failing forward raises. Returns the number of vectors
    written."""
    import h5py

    n_ok = 0
    errors: List[Tuple[str, str]] = []
    with h5py.File(out_hdf5, "w") as hf:
        for path in wav_paths:
            try:
                clip = load_clip(path, sample_rate=sample_rate)
            except Exception as e:  # an unreadable file (scipy raises several types)
                errors.append((path, repr(e)))
                continue
            if kind == "scene":
                vec = _numpy(model.forward_scene_embeddings(clip))[0]
            else:
                vec = _numpy(model.forward(clip)["clipwise_logits"])[0]
            hf[os.path.splitext(os.path.basename(path))[0]] = vec
            n_ok += 1
    for path, err in errors:
        logging.warning("embedding extraction failed for %s: %s", path, err)
    return n_ok
