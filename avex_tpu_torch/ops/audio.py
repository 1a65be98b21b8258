"""Waveform cropping and padding, and padding-mask propagation.

Counterpart of ``avex_tpu/ops/audio.py`` (reference
``avex/data/audio_utils.py:16-73`` and ``:187-341``):

- on the host, in numpy: ``window_start`` and ``pad_or_window_np``, which
  the collater uses;
- on tensors, on whatever device they lie: ``pad_or_window``,
  ``waveform_to_frame_mask``, ``sync_crop_or_pad_time`` and
  ``frame_mask_to_patch_mask``. Where the JAX versions draw a random crop
  from a ``jax.random`` key, ``pad_or_window`` takes a ``torch.Generator``.

Mask convention as the reference: ``True`` marks padded (invalid) samples.
"""

from __future__ import annotations

from typing import Literal, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "frame_mask_to_patch_mask",
    "pad_or_window",
    "pad_or_window_np",
    "sync_crop_or_pad_time",
    "waveform_to_frame_mask",
    "window_start",
]


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


def pad_or_window(
    wav: torch.Tensor,
    target_len: int,
    window_selection: Literal["random", "center", "start"] = "center",
    generator: Optional[torch.Generator] = None,
    invert: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop or right-pad ``(..., T)`` to ``(..., target_len)`` on the tensor's
    device. ``random`` draws the crop start from ``generator`` (required).
    Returns ``(wav, mask)``; with ``invert=True``, ``True`` marks padding."""
    wav_len = wav.shape[-1]
    if wav_len > target_len:
        if window_selection == "random":
            if generator is None:
                raise ValueError("random window selection requires a generator")
            start = int(torch.randint(0, wav_len - target_len + 1, (), generator=generator,
                                      device=generator.device))
        elif window_selection == "center":
            start = (wav_len - target_len) // 2
        elif window_selection == "start":
            start = 0
        else:
            raise ValueError(f"Unknown window selection: {window_selection!r}")
        wav = wav[..., start:start + target_len]
    elif wav_len < target_len:
        wav = torch.nn.functional.pad(wav, (0, target_len - wav_len))
    valid = torch.arange(target_len, device=wav.device) < min(wav_len, target_len)
    return wav, (~valid if invert else valid)


def waveform_to_frame_mask(padding_mask: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Sample-level ``(B, T)`` → frame-level padding mask: a frame is padded
    only when all of its samples are (BEATs' ``forward_padding_mask``);
    trailing samples that do not fill a hop are dropped."""
    if padding_mask.ndim != 2:
        raise ValueError("Expected padding_mask of shape (B, T)")
    bsz, n = padding_mask.shape
    frames = n // hop_length
    return padding_mask[:, :frames * hop_length].reshape(bsz, frames, hop_length).all(dim=-1)


def sync_crop_or_pad_time(
    spec: torch.Tensor,
    frame_mask: Optional[torch.Tensor],
    target_len: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Center-crop or right-pad a ``(B, T, F)`` spectrogram and its frame
    mask together; padded frames are ``True`` in the mask."""
    bsz, t, _ = spec.shape
    if t == target_len:
        return spec, frame_mask
    if t > target_len:
        start = (t - target_len) // 2
        spec = spec[:, start:start + target_len, :]
        return spec, None if frame_mask is None else frame_mask[:, start:start + target_len]
    pad = target_len - t
    spec = torch.nn.functional.pad(spec, (0, 0, 0, pad))
    if frame_mask is not None:
        frame_mask = torch.cat([frame_mask, frame_mask.new_ones((bsz, pad))], dim=1)
    return spec, frame_mask


def frame_mask_to_patch_mask(frame_mask: torch.Tensor, patch_size_time: int, n_freq_bins: int) -> torch.Tensor:
    """Frame mask → the flattened patch-token mask of a conv patch embedding:
    time-patch-major, each time patch's mask repeated over the frequency
    patches."""
    if frame_mask.ndim != 2:
        raise ValueError("Expected frame_mask of shape (B, T_frames)")
    bsz, t_frames = frame_mask.shape
    if t_frames % patch_size_time:
        raise ValueError("Time dimension must be divisible by patch size")
    time_mask = frame_mask.reshape(bsz, t_frames // patch_size_time, patch_size_time).all(dim=-1)
    return time_mask.repeat_interleave(n_freq_bins // patch_size_time, dim=1)
