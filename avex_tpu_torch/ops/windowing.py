"""Windowed batch inference over long recordings.

Port of ``avex_tpu/ops/windowing.py``, in numpy as there. Clips are cropped
to a fixed length for the models; a long recording is cut into windows of
that length at a fixed hop (one shape a call, so the serving buckets and any
CUDA graph see one batch shape), batched through a model function, and the
per-window results come back in window order with their start offsets. The
command line's ``embed --windowed`` cuts its recordings with
:func:`window_waveform`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

__all__ = ["window_waveform", "windowed_apply"]


def window_waveform(
    wav: np.ndarray,
    window_samples: int,
    hop_samples: Optional[int] = None,
    pad_final: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Slice one waveform into ``(num_windows, window_samples)`` + offsets.

    Args:
        wav: 1-D waveform.
        window_samples: window length (the model's clip length).
        hop_samples: stride between windows (default: non-overlapping).
        pad_final: zero-pad the trailing partial window instead of dropping it.

    Returns:
        ``(windows, start_offsets)``, the offsets in samples for each window.
    """
    wav = np.asarray(wav, np.float32).reshape(-1)
    hop = hop_samples or window_samples
    if len(wav) <= window_samples:
        out = np.zeros((1, window_samples), np.float32)
        out[0, : len(wav)] = wav
        return out, np.zeros(1, np.int64)
    starts = list(range(0, len(wav) - window_samples + 1, hop))
    rows = [wav[s : s + window_samples] for s in starts]
    tail_start = starts[-1] + hop
    # The hop-aligned, zero-padded tail window: only when samples remain
    # uncovered and the next hop position still lands inside the waveform
    # (with hop > window the gaps between windows are skipped by design).
    if pad_final and starts[-1] + window_samples < len(wav) and tail_start < len(wav):
        tail = np.zeros(window_samples, np.float32)
        tail[: len(wav) - tail_start] = wav[tail_start:]
        rows.append(tail)
        starts.append(tail_start)
    windows = np.stack(rows)
    return windows.astype(np.float32), np.asarray(starts, np.int64)


def windowed_apply(
    fn: Callable,
    wav: np.ndarray,
    window_samples: int,
    hop_samples: Optional[int] = None,
    batch_size: int = 32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply a batched model function over all windows of a long recording.

    Windows go to ``fn`` in chunks of ``batch_size``; the last chunk is padded
    with zero windows to the same shape, so every call has one shape, and
    its padding rows are dropped. ``fn`` may return a tensor (on any device)
    or an array.

    Returns:
        ``(outputs, start_offsets)`` with ``outputs.shape[0] == num_windows``.
    """
    windows, offsets = window_waveform(wav, window_samples, hop_samples)
    n = windows.shape[0]
    outputs = []
    for start in range(0, n, batch_size):
        chunk = windows[start : start + batch_size]
        valid = chunk.shape[0]
        if valid < batch_size:
            chunk = np.concatenate(
                [chunk, np.zeros((batch_size - valid,) + chunk.shape[1:], np.float32)]
            )
        out = fn(chunk)
        if hasattr(out, "detach"):  # a tensor: to host memory
            out = out.detach().float().cpu().numpy()
        outputs.append(np.asarray(out)[:valid])
    return np.concatenate(outputs, axis=0), offsets
