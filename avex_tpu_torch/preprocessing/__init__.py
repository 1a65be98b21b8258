"""Audio preprocessing: energy-based activity detection (numpy, on the host)."""

from avex_tpu_torch.preprocessing.activity_detector import (
    ActivityDetector,
    frame_energy,
    select_active_window,
)

__all__ = ["ActivityDetector", "frame_energy", "select_active_window"]
