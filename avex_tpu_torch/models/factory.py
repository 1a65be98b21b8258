"""Model factory of the port: spec → wrapper instance.

Counterpart of ``avex_tpu/models/factory.py``: looks up the architecture
class by ``spec.name``, forwards the spec's model fields, expands an
``init_config`` dict into constructor arguments for a class that takes its
architecture as direct arguments (EAT's ``depth``, AVES's ``aves_cfg``),
passes ``spec.name`` as ``variant`` (one ResNet class serves three names), and
filters the kwargs against the class's ``__init__`` signature so each
architecture only receives what it understands.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Dict, Optional

from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models.registry import get_model_class, get_model_spec

logger = logging.getLogger(__name__)

#: ModelSpec fields forwarded to model constructors.
_SPEC_FORWARD_FIELDS = (
    "text_model_name",
    "projection_dim",
    "temperature",
    "eat_cfg",
    "pretraining_mode",
    "handle_padding",
    "fairseq_weights_path",
    "eat_norm_mean",
    "eat_norm_std",
    "efficientnet_variant",
    "use_naturelm",
    "fine_tuned",
    "init_config",
    "language",
    "model_id",
    "extra_config",
    "compute_dtype",
)


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
    # resnet18/50/152 share one class that takes the concrete variant name.
    kwargs.setdefault("variant", spec.name)
    kwargs.update(overrides)

    signature = inspect.signature(cls.__init__)
    # A class without an ``init_config`` parameter takes its architecture
    # knobs as direct constructor arguments; expand the dict for it.
    if "init_config" not in signature.parameters and isinstance(kwargs.get("init_config"), dict):
        for key, value in kwargs.pop("init_config").items():
            kwargs.setdefault(key, value)
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
