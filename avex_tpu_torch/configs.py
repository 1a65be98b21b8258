"""Model and audio configuration of the port, as dataclasses.

Counterparts of ``avex_tpu.configs.ModelSpec`` and ``AudioConfig`` with the
fields that the BEATs, EAT and AVES paths read. Unknown fields raise
``TypeError`` as the dataclass constructor does.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

__all__ = ["AudioConfig", "ModelSpec"]

_REPRESENTATIONS = ("spectrogram", "mel_spectrogram", "raw")
_COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass
class AudioConfig:
    """How raw audio becomes the model input (≈ ``avex_tpu.configs.AudioConfig``)."""

    sample_rate: int = 16000
    representation: str = "mel_spectrogram"
    normalize: bool = True
    target_length_seconds: Optional[float] = None
    window_selection: str = "random"

    def __post_init__(self) -> None:
        if self.representation not in _REPRESENTATIONS:
            raise ValueError(
                f"representation must be one of {_REPRESENTATIONS}, got {self.representation!r}"
            )
        if self.window_selection not in ("random", "center"):
            raise ValueError(f"window_selection must be 'random' or 'center', got "
                             f"{self.window_selection!r}")

    @property
    def target_length_samples(self) -> Optional[int]:
        """Target clip length in samples (sample_rate x target_length_seconds)."""
        if self.target_length_seconds is None:
            return None
        return int(round(self.target_length_seconds * self.sample_rate))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ModelSpec:
    """Architecture + weights selector consumed by the model factory.

    ``device`` defaults to ``cuda``: the port runs on the card unless the
    caller asks for the CPU.
    """

    name: str
    pretrained: bool = True
    device: str = "cuda"
    audio_config: Optional[Union[AudioConfig, Dict[str, Any]]] = None
    # EAT
    eat_norm_mean: Optional[float] = None
    eat_norm_std: Optional[float] = None
    # BEATs
    use_naturelm: Optional[bool] = None
    fine_tuned: Optional[bool] = None
    init_config: Optional[Dict[str, Any]] = None
    # numeric policy of the backbone compute
    compute_dtype: str = "float32"

    def __post_init__(self) -> None:
        if isinstance(self.audio_config, dict):
            self.audio_config = AudioConfig(**self.audio_config)
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {_COMPUTE_DTYPES}, got {self.compute_dtype!r}"
            )

    def replace(self, **changes: Any) -> "ModelSpec":
        """A copy with ``changes`` applied (≈ pydantic ``model_copy(update=...)``)."""
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
