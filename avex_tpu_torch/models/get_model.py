"""Deprecated static model factory (port of ``avex_tpu/models/get_model.py``).

Kept for the reference's API; new code calls
:func:`avex_tpu_torch.models.factory.build_model_from_spec`.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional

from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models.factory import build_model_from_spec

__all__ = ["get_model"]


def get_model(spec: ModelSpec, num_classes: Optional[int] = None, **overrides: Any):
    """Build a model from a spec (a deprecated alias of the registry factory)."""
    warnings.warn("get_model is deprecated; use build_model_from_spec", DeprecationWarning, stacklevel=2)
    return build_model_from_spec(spec, num_classes=num_classes, **overrides)
