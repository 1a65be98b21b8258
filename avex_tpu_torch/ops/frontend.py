"""Generic spectrogram frontend (raw / spectrogram / mel_spectrogram).

Port of ``avex_tpu/ops/frontend.py``: ``torch.stft``-compatible power
spectrogram → optional HTK mel bank → ``log(x + 1e-6)`` → per-sample min-max
normalisation. The windowed real DFT is one constant ``[n_fft, 2K]`` matrix
built in float64 with numpy, so a spectrogram is framing
(``Tensor.unfold``: the same frames as the JAX package's gcd-block framing)
and one ``[B·frames, n_fft] × [n_fft, 2K]`` product; the mel projection is
one further product. Both are plain matrix products, left to
``torch.matmul`` as the JAX package left them to XLA.

Two precisions, as in JAX:

- ``"highest"`` (the parity default): fp32 operands, full fp32 on the card
  (never TF32, ``ops/_precision.full_fp32``);
- ``"default"`` (JAX's ``Precision.DEFAULT``, the frontend of bf16 models):
  the waveform and the DFT matrix rounded to bf16, the product accumulated
  and returned in fp32. JAX casts the operands explicitly there
  (``frontend.py:124-127``), so the port computes the bf16-rounded operands'
  product in fp32 sums: in TF32 on the card's tensor cores
  (``ops/_precision.tf32_matmul``), which holds every bf16 value exactly, so
  each product is exact and only the order of the fp32 sums differs. The mel
  product keeps fp32 operands in both: JAX passes ``DEFAULT`` to an fp32
  einsum there, a TPU pass-count hint that is fp32 on the CPU, where the
  packages are compared.

The DFT matrix and the mel bank are built once per shape (and window,
precision) and device, and kept there.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from avex_tpu_torch.configs import AudioConfig
from avex_tpu_torch.ops._precision import full_fp32, tf32_matmul

__all__ = ["AudioProcessor", "htk_mel_banks", "mel_product", "stft_power"]

_PRECISIONS = ("highest", "default")


def _periodic_window(win_length: int, window: str) -> np.ndarray:
    """torch-compatible periodic analysis windows (float64)."""
    n = np.arange(win_length, dtype=np.float64)
    if window == "hann":
        return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    if window == "hamming":
        return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)
    raise ValueError(f"Unknown window type: {window!r}")


def htk_mel_banks(
    n_freqs: int,
    n_mels: int,
    sample_rate: float,
    f_min: float = 0.0,
    f_max: Optional[float] = None,
) -> np.ndarray:
    """HTK-scale triangular mel bank matching ``torchaudio.transforms.MelScale``.

    Returns float64 ``[n_freqs, n_mels]`` (no area normalisation, mel = 2595
    log10(1 + f/700)).
    """
    f_max = f_max if f_max is not None else sample_rate / 2.0

    def to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def from_mel(m):
        return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    f_pts = from_mel(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))  # [n_freqs, n_mels]


@functools.lru_cache(maxsize=16)
def _stft_kernel(n_fft: int, win_length: int, window: str) -> np.ndarray:
    """Windowed-rDFT matrix ``[n_fft, 2K]`` (cos columns, then -sin), float32.

    When ``win_length < n_fft`` the window is centred inside the frame, as
    ``torch.stft`` does.
    """
    win = _periodic_window(win_length, window)
    full = np.zeros(n_fft, dtype=np.float64)
    start = (n_fft - win_length) // 2
    full[start : start + win_length] = win
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    angle = 2.0 * np.pi * k * n / n_fft
    mat = np.concatenate([full[:, None] * np.cos(angle), full[:, None] * -np.sin(angle)], axis=1)
    return mat.astype(np.float32)


def _device_constant(fn):
    """Cache a function's device tensor per argument tuple. Only plain
    tensors are kept: one made while a tracing mode is on (``torch.export``'s
    fake tensors) belongs to that trace, so the next call builds it again."""
    cache: dict = {}

    @functools.wraps(fn)
    def cached(*key):
        found = cache.get(key)
        if found is None:
            found = fn(*key)
            if type(found) is torch.Tensor:
                cache[key] = found
        return found

    return cached


@_device_constant
def _dft_matrix(n_fft: int, win_length: int, window: str, precision: str, device: torch.device) -> torch.Tensor:
    """:func:`_stft_kernel` on ``device``, rounded to bf16 values for ``"default"``."""
    kernel = torch.from_numpy(_stft_kernel(n_fft, win_length, window)).to(device)
    return kernel.bfloat16().float() if precision == "default" else kernel


def _check_precision(precision: str) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")


def stft_power(
    waveform: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    window: str = "hann",
    center: bool = True,
    precision: str = "highest",
) -> torch.Tensor:
    """Power spectrogram ``[B, n_fft//2+1, frames]`` float32, matching ``torch.stft``.

    ``center=True`` reflect-pads by ``n_fft // 2`` on both sides (torch's
    default padding mode), giving ``1 + T // hop`` frames. ``precision``:
    ``"highest"`` (fp32 operands) or ``"default"`` (bf16-rounded operands,
    fp32 sums); see the module docstring.
    """
    _check_precision(precision)
    x = waveform.float()
    if x.ndim == 1:
        x = x[None]
    if center:
        x = F.pad(x, (n_fft // 2, n_fft // 2), mode="reflect")
    kernel = _dft_matrix(n_fft, win_length, window, precision, x.device)
    if precision == "default":
        x = x.bfloat16().float()
    frames = x.unfold(1, n_fft, hop_length)  # [B, frames, n_fft]
    with full_fp32() if precision == "highest" else tf32_matmul():
        spec = torch.matmul(frames, kernel)  # [B, frames, 2K]
    k = n_fft // 2 + 1
    power = spec[..., :k].square() + spec[..., k:].square()
    return power.transpose(1, 2)


@_device_constant
def _mel_matrix(
    n_freqs: int, n_mels: int, sample_rate: float, f_min: float, f_max: Optional[float], device: torch.device
) -> torch.Tensor:
    """:func:`htk_mel_banks` as float32 on ``device``."""
    return torch.from_numpy(htk_mel_banks(n_freqs, n_mels, sample_rate, f_min, f_max).astype(np.float32)).to(device)


def mel_product(
    power: torch.Tensor, n_mels: int, sample_rate: float, f_min: float = 0.0, f_max: Optional[float] = None
) -> torch.Tensor:
    """``einsum("bkf,km->bmf")`` of a power spectrogram ``[B, K, frames]`` and
    the HTK mel bank ``[K, n_mels]`` (:func:`htk_mel_banks`), fp32."""
    mel_fb = _mel_matrix(power.shape[1], n_mels, sample_rate, f_min, f_max, power.device)
    with full_fp32():
        return torch.matmul(power.transpose(1, 2), mel_fb).transpose(1, 2)


class AudioProcessor:
    """Raw-audio → model-input transform configured by :class:`AudioConfig`.

    Output shapes follow the reference: ``raw`` → ``(B, T)`` unchanged;
    ``spectrogram`` / ``mel_spectrogram`` → ``(B, F, T')`` float32, with
    ``log`` and per-sample min-max normalisation when ``normalize``.
    ``precision`` is the DFT product's (see :func:`stft_power`).
    """

    def __init__(self, cfg: AudioConfig, precision: str = "highest") -> None:
        _check_precision(precision)
        if cfg.representation not in ("raw", "spectrogram", "mel_spectrogram"):
            raise ValueError(f"Unknown representation: {cfg.representation!r}")
        self.cfg = cfg
        self.precision = precision
        self.sr = cfg.sample_rate
        self.n_fft = cfg.n_fft
        self.hop_length = cfg.hop_length or self.n_fft // 4
        self.win_length = cfg.win_length or self.n_fft
        self.window_type = cfg.window
        self.n_mels = cfg.n_mels
        self.representation = cfg.representation
        self.normalize = cfg.normalize
        self.center = cfg.center

    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        if waveform.ndim == 1:
            waveform = waveform[None]
        if self.representation == "raw":
            return waveform
        out = stft_power(
            waveform, n_fft=self.n_fft, hop_length=self.hop_length, win_length=self.win_length,
            window=self.window_type, center=self.center, precision=self.precision,
        )
        if self.representation == "mel_spectrogram":
            out = mel_product(out, self.n_mels, self.sr)
        return self._normalize(out) if self.normalize else out

    @staticmethod
    def _normalize(x: torch.Tensor) -> torch.Tensor:
        """log, then per-sample min-max to [0, 1]."""
        x = torch.log(x + 1e-6)
        lo = x.amin(dim=(-2, -1), keepdim=True)
        hi = x.amax(dim=(-2, -1), keepdim=True)
        return (x - lo) / (hi - lo + 1e-8)
