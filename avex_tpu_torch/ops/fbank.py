"""Kaldi-compatible log-mel filterbank, always in full fp32.

Port of ``avex_tpu/ops/fbank.py``. Every per-frame step before the power
spectrum (DC removal, pre-emphasis, window, zero-padding, real DFT) is linear
in the frame, so it folds into one constant ``[win, 2K]`` matrix built in
float64 with numpy. The frontend is then framing (``Tensor.unfold``, the same
frames as the JAX gcd-block framing), one matmul, the power spectrum, one
matmul with the mel bank and a log. The matmuls run in full fp32 on the card
(never TF32), as the JAX code pins ``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from avex_tpu_torch.ops._precision import full_fp32

__all__ = ["KaldiFbank", "beats_fbank", "eat_fbank", "kaldi_mel_banks", "kaldi_window", "num_frames"]

_F32_EPS = float(np.finfo(np.float32).eps)


def kaldi_window(win_length: int, window_type: str = "povey") -> np.ndarray:
    """Kaldi feature window (float64); ``povey`` = symmetric hann ** 0.85."""
    n = np.arange(win_length, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win_length - 1))
    if window_type == "povey":
        return hann**0.85
    if window_type == "hanning":
        return hann
    if window_type == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (win_length - 1))
    if window_type == "rectangular":
        return np.ones(win_length, dtype=np.float64)
    raise ValueError(f"Unknown Kaldi window type: {window_type!r}")


def kaldi_mel_banks(
    n_fft: int,
    num_mel_bins: int,
    sample_rate: float,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Triangular Kaldi mel filterbank, shape ``[n_fft//2 + 1, num_mel_bins]``.

    mel = 1127 ln(1 + f/700); uniform bins in mel space between ``low_freq``
    and ``high_freq`` (``<= 0`` means Nyquist + high_freq); the Nyquist FFT
    bin row is zero, as in kaldi.
    """
    if high_freq <= 0.0:
        high_freq = sample_rate / 2.0 + high_freq

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    num_bins = n_fft // 2
    fft_bin_width = sample_rate / n_fft
    mel_low, mel_high = mel(low_freq), mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_mel_bins + 1)

    bin_idx = np.arange(num_mel_bins, dtype=np.float64)[:, None]
    left = mel_low + bin_idx * mel_delta
    center = left + mel_delta
    right = center + mel_delta

    bin_mels = mel(fft_bin_width * np.arange(num_bins, dtype=np.float64))[None, :]
    up = (bin_mels - left) / (center - left)
    down = (right - bin_mels) / (right - center)
    fb = np.maximum(0.0, np.minimum(up, down))  # [num_mel_bins, num_bins]
    fb = np.concatenate([fb, np.zeros((num_mel_bins, 1))], axis=1)
    return fb.T  # [n_fft//2 + 1, num_mel_bins]


def _fused_frame_matrices(
    win_length: int,
    n_fft: int,
    window_type: str,
    preemphasis: float,
    remove_dc_offset: bool,
) -> np.ndarray:
    """Fold DC-removal → pre-emphasis → window → rDFT into one matrix.

    Returns ``[win_length, 2 * (n_fft//2 + 1)]``: the cos branch followed by
    the sin branch, so ``frames @ M`` yields concatenated (Re, Im) spectra.
    """
    eye = np.eye(win_length, dtype=np.float64)
    m = eye
    if remove_dc_offset:
        m = m - np.full((win_length, win_length), 1.0 / win_length)
    if preemphasis != 0.0:
        # y[i] = x[i] - c * x[i-1], with replicate padding (y[0] uses x[0]).
        shift = np.zeros((win_length, win_length), dtype=np.float64)
        shift[np.arange(1, win_length), np.arange(win_length - 1)] = 1.0
        shift[0, 0] = 1.0
        m = (eye - preemphasis * shift) @ m
    m = np.diag(kaldi_window(win_length, window_type)) @ m

    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    n = np.arange(win_length, dtype=np.float64)[:, None]
    angle = 2.0 * np.pi * k * n / n_fft
    dft_cos = np.cos(angle)  # [win, K]
    dft_sin = -np.sin(angle)
    # frames @ (M^T @ dft) == dft^T @ (M @ x) per frame.
    return np.concatenate([m.T @ dft_cos, m.T @ dft_sin], axis=1)


@functools.lru_cache(maxsize=16)
def _fbank_constants(key: Tuple) -> Tuple[np.ndarray, np.ndarray]:
    """Per-config cached (frame kernel ``[2K, 1, win]``, mel bank ``[K, M]``), float32."""
    (n_mels, sr, win, _hop, wtype, preemph, dc, lo, hi) = key
    n_fft = 1
    while n_fft < win:
        n_fft *= 2
    frame_mat = _fused_frame_matrices(win, n_fft, wtype, preemph, dc)
    mel_fb = kaldi_mel_banks(n_fft, n_mels, sr, lo, hi)
    kernel = frame_mat.T[:, None, :].astype(np.float32)
    return kernel, mel_fb.astype(np.float32)


def num_frames(num_samples: int, win_length: int, hop_length: int) -> int:
    """Frame count under ``snip_edges=True`` framing."""
    if num_samples < win_length:
        return 0
    return 1 + (num_samples - win_length) // hop_length


class KaldiFbank:
    """Batched Kaldi fbank matching ``torchaudio.compliance.kaldi.fbank``
    (``use_energy=False, dither=0.0, snip_edges=True``) for the supported
    windows. The constants are cached per configuration and per device."""

    def __init__(
        self,
        num_mel_bins: int = 128,
        sample_frequency: float = 16000.0,
        frame_length_ms: float = 25.0,
        frame_shift_ms: float = 10.0,
        window_type: str = "povey",
        preemphasis_coefficient: float = 0.97,
        remove_dc_offset: bool = True,
        low_freq: float = 20.0,
        high_freq: float = 0.0,
    ) -> None:
        self.num_mel_bins = num_mel_bins
        self.sample_frequency = sample_frequency
        self.win_length = int(sample_frequency * frame_length_ms / 1000.0)
        self.hop_length = int(sample_frequency * frame_shift_ms / 1000.0)
        n_fft = 1
        while n_fft < self.win_length:
            n_fft *= 2
        self.n_fft = n_fft
        self._key = (
            num_mel_bins,
            sample_frequency,
            self.win_length,
            self.hop_length,
            window_type,
            preemphasis_coefficient,
            remove_dc_offset,
            low_freq,
            high_freq,
        )
        self._device_constants = {}

    def output_frames(self, num_samples: int) -> int:
        """Number of output frames for a given waveform length."""
        return num_frames(num_samples, self.win_length, self.hop_length)

    def constants(self) -> Tuple[np.ndarray, np.ndarray]:
        """(frame kernel ``[2K, 1, win]``, mel bank ``[K, M]``) numpy constants."""
        return _fbank_constants(self._key)

    def _constants_on(self, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        found = self._device_constants.get(device)
        if found is None:
            kernel_np, mel_np = self.constants()
            found = (
                torch.from_numpy(np.ascontiguousarray(kernel_np[:, 0, :].T)).to(device),
                torch.from_numpy(mel_np).to(device),
            )
            self._device_constants[device] = found
        return found

    def __call__(self, waveforms: torch.Tensor) -> torch.Tensor:
        """``[B, T]`` (or ``[T]``) waveform → ``[B, frames, num_mel_bins]`` float32 log-mel."""
        squeeze = waveforms.ndim == 1
        if squeeze:
            waveforms = waveforms[None]
        x = waveforms.float()
        b, t = x.shape
        f = num_frames(t, self.win_length, self.hop_length)
        if f <= 0:
            out = x.new_zeros((b, 0, self.num_mel_bins))
            return out[0] if squeeze else out
        kernel2d, mel_fb = self._constants_on(x.device)  # [win, 2K], [K, M]
        frames = x.unfold(1, self.win_length, self.hop_length)  # [B, F, win]
        with full_fp32():
            spec = torch.matmul(frames, kernel2d)  # [B, F, 2K]
            k = self.n_fft // 2 + 1
            power = spec[..., :k].square() + spec[..., k:].square()
            mel = torch.matmul(power, mel_fb)
        out = torch.log(torch.clamp_min(mel, _F32_EPS))
        return out[0] if squeeze else out


def beats_fbank(
    waveforms: torch.Tensor,
    fbank_mean: float = 15.41663,
    fbank_std: float = 6.55582,
    fbank: Optional[KaldiFbank] = None,
) -> torch.Tensor:
    """BEATs frontend: 2**15 scaling + Kaldi fbank + dataset normalisation, in fp32."""
    if fbank is None:
        fbank = KaldiFbank()
    feats = fbank(waveforms.float() * 32768.0)
    return (feats - fbank_mean) / (2.0 * fbank_std)


def eat_fbank(
    waveforms: torch.Tensor,
    target_length: int = 1024,
    norm_mean: float = -4.268,
    norm_std: float = 4.569,
    fbank: Optional[KaldiFbank] = None,
) -> torch.Tensor:
    """EAT frontend, in fp32: per-clip DC removal, Hann-window Kaldi fbank,
    pad or truncate to ``target_length`` frames, ``(mel - mean) / (2 std)``;
    ``[B, T]`` → ``[B, num_mel_bins, target_length]`` (``[T]`` → ``[M, F]``)."""
    if fbank is None:
        fbank = KaldiFbank(window_type="hanning")
    squeeze = waveforms.ndim == 1
    if squeeze:
        waveforms = waveforms[None]
    wav = waveforms.float()
    mel = fbank(wav - wav.mean(dim=-1, keepdim=True))  # [B, F, M]
    frames = mel.shape[1]
    if frames < target_length:
        mel = torch.nn.functional.pad(mel, (0, 0, 0, target_length - frames))
    else:
        mel = mel[:, :target_length, :]
    out = ((mel - norm_mean) / (norm_std * 2.0)).transpose(1, 2)
    return out[0] if squeeze else out
