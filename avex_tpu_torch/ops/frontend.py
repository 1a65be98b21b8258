"""Raw-audio frontend of the port (``AudioProcessor``, ``raw`` representation).

Port of the ``raw`` branch of ``avex_tpu/ops/frontend.py``: the official
BEATs specs feed the waveform unchanged. The spectrogram representations wait
for ROADMAP queue 1, item "CNN families and the generic frontend".
"""

from __future__ import annotations

import torch

from avex_tpu_torch.configs import AudioConfig

__all__ = ["AudioProcessor"]


class AudioProcessor:
    """Raw-audio → model-input transform configured by :class:`AudioConfig`."""

    def __init__(self, cfg: AudioConfig) -> None:
        if cfg.representation != "raw":
            raise NotImplementedError(
                f"AudioProcessor representation {cfg.representation!r} is not ported yet "
                "(ROADMAP queue 1: CNN families and the generic frontend); only 'raw' is"
            )
        self.cfg = cfg
        self.sr = cfg.sample_rate
        self.representation = cfg.representation

    def __call__(self, waveform: torch.Tensor) -> torch.Tensor:
        """``[T]`` or ``[B, T]`` → ``[B, T]`` unchanged."""
        if waveform.ndim == 1:
            waveform = waveform[None]
        return waveform
