"""Model factory of the port: spec → wrapper instance.

Counterpart of ``avex_tpu/models/factory.py``: looks up the architecture
class by ``spec.name``, forwards the spec's model fields, and filters the
kwargs against the class's ``__init__`` signature so each architecture only
receives what it understands.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Dict, Optional

from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models.registry import get_model_class, get_model_spec

logger = logging.getLogger(__name__)

#: ModelSpec fields forwarded to model constructors.
_SPEC_FORWARD_FIELDS = ("use_naturelm", "fine_tuned", "init_config", "compute_dtype")


def build_model_from_spec(
    spec: ModelSpec,
    device: Optional[str] = None,
    num_classes: Optional[int] = None,
    **overrides: Any,
):
    """Instantiate the wrapper class selected by ``spec.name``."""
    cls = get_model_class(spec.name)

    kwargs: Dict[str, Any] = {
        "device": device or spec.device,
        "num_classes": num_classes,
        "pretrained": spec.pretrained,
        "audio_config": spec.audio_config.to_dict() if spec.audio_config else None,
    }
    for field in _SPEC_FORWARD_FIELDS:
        value = getattr(spec, field, None)
        if value is not None:
            kwargs[field] = value
    kwargs.update(overrides)

    signature = inspect.signature(cls.__init__)
    accepts_var_kw = any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in signature.parameters.values()
    )
    if not accepts_var_kw:
        dropped = [k for k in kwargs if k not in signature.parameters]
        for key in dropped:
            kwargs.pop(key)
        if dropped:
            logger.debug("Dropped unsupported kwargs for %s: %s", spec.name, dropped)

    model = cls(**kwargs)
    model.spec = spec
    return model


def build_model(
    name: str,
    device: Optional[str] = None,
    num_classes: Optional[int] = None,
    **overrides: Any,
):
    """Registry-key convenience wrapper over :func:`build_model_from_spec`."""
    spec = get_model_spec(name)
    if "pretrained" in overrides:
        spec = spec.replace(pretrained=overrides.pop("pretrained"))
    return build_model_from_spec(spec, device=device, num_classes=num_classes, **overrides)
