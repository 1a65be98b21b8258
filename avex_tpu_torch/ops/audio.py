"""Waveform cropping and padding on the host (numpy).

Counterpart of the numpy helpers of ``avex_tpu/ops/audio.py:32-75``
(``window_start``, ``pad_or_window_np``; reference
``avex/data/audio_utils.py:16-73``). Mask convention as the reference:
``True`` marks padded (invalid) samples.
"""

from __future__ import annotations

from typing import Literal, Optional, Tuple

import numpy as np

__all__ = ["pad_or_window_np", "window_start"]


def window_start(
    length: int,
    target_len: int,
    window_selection: str,
    rng: Optional[np.random.Generator] = None,
) -> int:
    """Crop-start offset for one window selection mode (random, center, start)."""
    if window_selection == "random":
        rng = rng or np.random.default_rng()
        return int(rng.integers(0, length - target_len + 1))
    if window_selection == "center":
        return (length - target_len) // 2
    if window_selection == "start":
        return 0
    raise ValueError(f"Unknown window selection: {window_selection!r}")


def pad_or_window_np(
    wav: np.ndarray,
    target_len: int,
    window_selection: Literal["random", "center", "start"] = "random",
    rng: Optional[np.random.Generator] = None,
    invert: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Crop or right-pad a waveform to ``target_len``.

    A crop selects a window (random / center / start); padding is zeros on
    the right. Returns ``(wav, mask)`` where, with ``invert=True`` (default),
    ``True`` marks padded samples.
    """
    wav_len = wav.shape[-1]
    mask = np.ones(target_len, dtype=bool)
    if wav_len > target_len:
        start = window_start(wav_len, target_len, window_selection, rng=rng)
        wav = wav[..., start : start + target_len]
    elif wav_len < target_len:
        pad = [(0, 0)] * (wav.ndim - 1) + [(0, target_len - wav_len)]
        wav = np.pad(wav, pad)
        mask[wav_len:] = False
    if invert:
        mask = ~mask
    return wav, mask
