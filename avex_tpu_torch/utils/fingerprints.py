"""Output fingerprints for reproducibility tests (port of
``avex_tpu/utils/fingerprints.py``).

A fingerprint is the SHA-256 of ``np.round(output, 4)`` as float32 bytes on
a deterministic input, keyed by a numerics profile of the installed torch
version (``torch_<major>_<minor>``).
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch

__all__ = ["fingerprint", "numerics_profile"]


def numerics_profile() -> str:
    """Profile key of the installed torch version, e.g. ``torch_2_5``."""
    major, minor = torch.__version__.split("+")[0].split(".")[:2]
    return f"torch_{major}_{minor}"


def fingerprint(output: Any, decimals: int = 4) -> str:
    """SHA-256 of the ``decimals``-rounded output's float32 bytes; a tensor is
    read on the host first."""
    if isinstance(output, torch.Tensor):
        output = output.detach().cpu().double().numpy()
    arr = np.asarray(output, dtype=np.float64)
    return hashlib.sha256(np.round(arr, decimals).astype(np.float32).tobytes()).hexdigest()
