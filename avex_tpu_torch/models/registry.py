"""Model registry of the port: named specs and architecture classes.

Counterpart of ``avex_tpu/models/registry.py``. ``_MODEL_REGISTRY`` maps a
registry key to a :class:`ModelSpec` (with checkpoint and label-map URIs);
``_MODEL_CLASSES`` maps an architecture name to its wrapper class, imported
lazily through ``_ARCH_MODULES`` (the class is the module's ``Model``, or the
attribute ``_ARCH_CLASS_ATTR`` names). Only architectures the port has are in
``_ARCH_MODULES``, and only the official entries of those architectures are
registered at import.
"""

from __future__ import annotations

import copy
import importlib
from typing import Any, Dict, List, Optional, Type, Union

from avex_tpu_torch.api.official_models import OFFICIAL_MODELS
from avex_tpu_torch.configs import ModelSpec

_MODEL_REGISTRY: Dict[str, ModelSpec] = {}
_CHECKPOINT_PATHS: Dict[str, Optional[str]] = {}
_LABEL_MAP_PATHS: Dict[str, Optional[str]] = {}
_MODEL_CLASSES: Dict[str, Type] = {}

#: architecture name → module that defines its ``Model`` class (lazy import).
_ARCH_MODULES: Dict[str, str] = {
    "beats": "avex_tpu_torch.models.beats",
    "eat_hf": "avex_tpu_torch.models.eat",
    "aves_bio": "avex_tpu_torch.models.aves",
    "birdmae": "avex_tpu_torch.models.birdmae",
    "atst": "avex_tpu_torch.models.atst",
    "efficientnet": "avex_tpu_torch.models.efficientnet",
    "resnet18": "avex_tpu_torch.models.resnet",
    "resnet50": "avex_tpu_torch.models.resnet",
    "resnet152": "avex_tpu_torch.models.resnet",
    "perch": "avex_tpu_torch.models.perch",
    "surfperch": "avex_tpu_torch.models.perch",
    "birdnet": "avex_tpu_torch.models.birdnet",
    "clip": "avex_tpu_torch.models.clip",
}

#: architecture name → class attribute when it is not the module's ``Model``.
_ARCH_CLASS_ATTR: Dict[str, str] = {"surfperch": "SurfPerchModel"}


def register_model(
    name: str,
    spec: Union[ModelSpec, Dict[str, Any]],
    checkpoint_path: Optional[str] = None,
    class_mapping_path: Optional[str] = None,
    overwrite: bool = False,
) -> None:
    """Register a named model spec."""
    if name in _MODEL_REGISTRY and not overwrite:
        raise ValueError(f"Model '{name}' is already registered")
    if isinstance(spec, dict):
        spec = ModelSpec(**spec)
    _MODEL_REGISTRY[name] = spec
    _CHECKPOINT_PATHS[name] = checkpoint_path
    _LABEL_MAP_PATHS[name] = class_mapping_path


def get_model_spec(name: str) -> ModelSpec:
    """A copy of a registered spec; raises with the available names on a miss."""
    if name not in _MODEL_REGISTRY:
        raise KeyError(
            f"Model '{name}' not found in registry. Available: {sorted(_MODEL_REGISTRY)}"
        )
    return copy.deepcopy(_MODEL_REGISTRY[name])


def get_checkpoint_path(name: str) -> Optional[str]:
    """Default checkpoint URI of a registered model."""
    if name not in _MODEL_REGISTRY:
        raise KeyError(f"Model '{name}' not found in registry")
    return _CHECKPOINT_PATHS.get(name)


def get_class_mapping_path(name: str) -> Optional[str]:
    """Label-map URI registered for a model, if any."""
    if name not in _MODEL_REGISTRY:
        raise KeyError(f"Model '{name}' not found in registry")
    return _LABEL_MAP_PATHS.get(name)


def register_model_class(name: str, cls: Type) -> None:
    """Register an architecture class under ``spec.name`` (plugin API)."""
    _MODEL_CLASSES[name] = cls


def get_model_class(name: str) -> Type:
    """Resolve an architecture class, importing its module on first use."""
    if name not in _MODEL_CLASSES:
        module_path = _ARCH_MODULES.get(name)
        if module_path is None:
            raise KeyError(
                f"No model class registered for architecture '{name}'. "
                f"Known: {sorted(set(_MODEL_CLASSES) | set(_ARCH_MODULES))}"
            )
        _MODEL_CLASSES[name] = getattr(importlib.import_module(module_path), _ARCH_CLASS_ATTR.get(name, "Model"))
    return _MODEL_CLASSES[name]


def list_model_classes() -> List[str]:
    """All architecture names resolvable to a Model class."""
    return sorted(set(_MODEL_CLASSES) | set(_ARCH_MODULES))


def list_models(verbose: bool = True) -> Dict[str, Dict[str, Any]]:
    """Tabulate registered models as ``{name: {architecture, pretrained, checkpoint, label_map}}``."""
    info: Dict[str, Dict[str, Any]] = {}
    for name in sorted(_MODEL_REGISTRY):
        spec = _MODEL_REGISTRY[name]
        info[name] = {
            "architecture": spec.name,
            "pretrained": spec.pretrained,
            "checkpoint": _CHECKPOINT_PATHS.get(name),
            "label_map": _LABEL_MAP_PATHS.get(name),
        }
    if verbose:
        width = max((len(n) for n in info), default=10) + 2
        print(f"{'model':<{width}}{'architecture':<16}{'checkpoint'}")
        print("-" * (width + 50))
        for name, row in info.items():
            print(f"{name:<{width}}{row['architecture']:<16}{row['checkpoint'] or '-'}")
    return info


def describe_model(name: str) -> Dict[str, Any]:
    """Full registry record for one model."""
    spec = get_model_spec(name)
    return {
        "name": name,
        "model_spec": spec.to_dict(),
        "checkpoint_path": _CHECKPOINT_PATHS.get(name),
        "class_mapping_path": _LABEL_MAP_PATHS.get(name),
    }


def list_model_layers(name: str, **build_kwargs: Any) -> List[str]:
    """Build the model (random weights) and report its embedding layer names."""
    from avex_tpu_torch.models.factory import build_model

    model = build_model(name, pretrained=False, **build_kwargs)
    return model.get_model_layers()


def _auto_register_official_models() -> None:
    for name, entry in OFFICIAL_MODELS.items():
        if name in _MODEL_REGISTRY or entry["model_spec"]["name"] not in _ARCH_MODULES:
            continue
        register_model(
            name,
            ModelSpec(**entry["model_spec"]),
            checkpoint_path=entry.get("checkpoint_path"),
            class_mapping_path=entry.get("class_mapping_path"),
        )


_auto_register_official_models()
