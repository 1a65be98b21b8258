"""Energy-based acoustic activity detection (port of
``avex_tpu/preprocessing/activity_detector.py``).

Short-time log energy against an adaptive noise floor, and a window selector
that anchors a fixed-length crop on the most active region. All numpy,
host-side before collation, deterministic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["ActivityDetector", "frame_energy", "select_active_window"]


def frame_energy(wav: np.ndarray, frame: int = 400, hop: int = 160) -> np.ndarray:
    """Short-time log energy per frame (dB scale)."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    if len(wav) < frame:
        wav = np.pad(wav, (0, frame - len(wav)))
    n_frames = 1 + (len(wav) - frame) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
    energy = np.mean(wav[idx] ** 2, axis=1)
    return 10.0 * np.log10(np.maximum(energy, 1e-10))


class ActivityDetector:
    """Frame-level activity mask: a frame is active when its energy exceeds
    the noise floor (the ``floor_percentile`` of frame energies) by
    ``threshold_db``."""

    def __init__(self, frame: int = 400, hop: int = 160, threshold_db: float = 6.0,
                 floor_percentile: float = 10.0) -> None:
        self.frame = frame
        self.hop = hop
        self.threshold_db = threshold_db
        self.floor_percentile = floor_percentile

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        """Boolean activity mask per frame (True = active)."""
        energy = frame_energy(wav, self.frame, self.hop)
        floor = np.percentile(energy, self.floor_percentile)
        return energy > floor + self.threshold_db

    def activity_ratio(self, wav: np.ndarray) -> float:
        """Fraction of frames flagged active."""
        mask = self(wav)
        return float(mask.mean()) if mask.size else 0.0


def select_active_window(wav: np.ndarray, target_len: int,
                         detector: Optional[ActivityDetector] = None) -> Tuple[np.ndarray, int]:
    """Crop ``target_len`` samples at the most active region; a clip no
    longer than that comes back zero-padded. Returns ``(window, start)``."""
    detector = detector or ActivityDetector()
    wav = np.asarray(wav, np.float32).reshape(-1)
    if len(wav) <= target_len:
        out = np.zeros(target_len, np.float32)
        out[: len(wav)] = wav
        return out, 0
    energy = frame_energy(wav, detector.frame, detector.hop)
    win_frames = max(1, (target_len - detector.frame) // detector.hop + 1)
    # Sliding sum of the energy over window-long spans of frames.
    cumulative = np.concatenate([[0.0], np.cumsum(energy)])
    spans = cumulative[win_frames:] - cumulative[:-win_frames]
    best = int(np.argmax(spans))
    start = min(best * detector.hop, len(wav) - target_len)
    return wav[start: start + target_len], start
