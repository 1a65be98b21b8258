"""Probe factory and registry (port of ``avex_tpu/probes/factory.py``).

``build_probe_from_config`` checks the online (``base_model``) XOR offline
(``input_dim``) contract, registers the capture layers on the backbone and
hands each probe type only the head arguments it takes. It accepts a
:class:`ProbeConfig` or its dict; ``load_probe_config`` reads YAML and
imports PyYAML only when it is called.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Type, Union

import torch

from avex_tpu_torch.configs import ProbeConfig
from avex_tpu_torch.probes.base import HEAD_CLASSES, Probe

__all__ = ["build_probe_from_config", "get_probe_class", "list_probe_classes", "load_probe_config",
           "register_probe_class"]

logger = logging.getLogger(__name__)

_PROBE_REGISTRY: Dict[str, Type[Probe]] = {}

#: the head arguments each probe type takes
_HEAD_KWARG_FIELDS: Dict[str, Tuple[str, ...]] = {
    "linear": (),
    "mlp": ("hidden_dims", "dropout_rate", "activation"),
    "lstm": ("lstm_hidden_size", "num_layers", "bidirectional", "dropout_rate", "max_sequence_length"),
    "attention": ("num_heads", "num_layers", "dropout_rate", "max_sequence_length", "use_positional_encoding"),
    "transformer": ("num_heads", "num_layers", "attention_dim", "dropout_rate", "max_sequence_length",
                    "use_positional_encoding"),
    "moe": ("num_experts", "moe_hidden_dim", "moe_k", "capacity_factor", "dropout_rate"),
}


def register_probe_class(name: str, cls: Type[Probe]) -> None:
    """Register a custom probe class under a name."""
    _PROBE_REGISTRY[name] = cls


def get_probe_class(name: str) -> Type[Probe]:
    """The probe class of a type name."""
    if name in _PROBE_REGISTRY:
        return _PROBE_REGISTRY[name]
    if name in HEAD_CLASSES:
        return Probe
    raise KeyError(f"Unknown probe type {name!r}; known: {sorted(set(HEAD_CLASSES) | set(_PROBE_REGISTRY))}")


def list_probe_classes() -> List[str]:
    """Every known probe type name."""
    return sorted(set(HEAD_CLASSES) | set(_PROBE_REGISTRY))


def load_probe_config(path: Union[str, Path]) -> ProbeConfig:
    """A :class:`ProbeConfig` from a local YAML file (needs PyYAML)."""
    try:
        import yaml
    except ImportError as err:
        raise ImportError("load_probe_config needs PyYAML (the yaml module); pass a dict or a "
                          "ProbeConfig to build_probe_from_config instead") from err
    return ProbeConfig(**(yaml.safe_load(Path(path).read_text()) or {}))


def build_probe_from_config(
    probe_config: Union[ProbeConfig, Dict[str, Any]],
    num_classes: int,
    base_model=None,
    input_dim: Optional[Union[int, Tuple[int, ...], List[Tuple[int, ...]]]] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
) -> Probe:
    """An online or offline probe from a :class:`ProbeConfig` (or its dict).

    Exactly one of ``base_model`` (online: raw audio through the backbone)
    and ``input_dim`` (offline: cached embeddings) must be given. The probe
    lives on the backbone's device online and on ``device`` (``cuda`` unless
    the caller names another) offline.
    """
    if isinstance(probe_config, dict):
        probe_config = ProbeConfig(**probe_config)
    if (base_model is None) == (input_dim is None):
        raise ValueError(
            "Provide exactly one of base_model (online probing) or input_dim "
            "(offline probing on cached embeddings)."
        )
    head_kwargs: Dict[str, Any] = {}
    for name in _HEAD_KWARG_FIELDS[probe_config.probe_type]:
        value = getattr(probe_config, name, None)
        if value is not None:
            head_kwargs[name] = tuple(value) if name == "hidden_dims" else value
    cls = get_probe_class(probe_config.probe_type)
    return cls(
        probe_type=probe_config.probe_type,
        num_classes=num_classes,
        base_model=base_model,
        layers=list(probe_config.target_layers),
        feature_mode=base_model is None,
        input_dim=input_dim,
        aggregation=probe_config.aggregation,
        target_length=probe_config.target_length,
        freeze_backbone=probe_config.freeze_backbone,
        seed=seed,
        device=device,
        **head_kwargs,
    )
