"""Public model loading of the port: ``load_model`` / ``load_label_mapping``.

Counterpart of ``avex_tpu/models/load.py``:

- the first argument may be a registry key, a path to a spec YAML (with
  ``model_spec`` / ``checkpoint_path`` / ``class_mapping_path`` keys; ``yaml``
  is imported only there), or a :class:`ModelSpec`;
- checkpoint priority: explicit argument > registry/YAML default, and
  ``pretrained`` flips off once a checkpoint is supplied;
- ``num_classes`` is read from the checkpoint's classifier weights, falling
  back to the label mapping's size;
- files are local: a remote checkpoint raises; a remote label map is
  skipped (with a warning unless ``random_weights``), as the JAX package
  goes on without a label map it cannot fetch.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Optional, Tuple, Union

from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models.factory import build_model_from_spec
from avex_tpu_torch.models.registry import (
    _MODEL_REGISTRY,
    get_checkpoint_path,
    get_class_mapping_path,
    get_model_spec,
)
from avex_tpu_torch.utils.loaders import (
    extract_num_classes,
    is_remote,
    local_path,
    process_state_dict,
    universal_load,
)

logger = logging.getLogger(__name__)


def _read_text(path: str) -> str:
    with open(local_path(path), encoding="utf-8") as f:
        return f.read()


def _resolve_spec(source: Union[str, ModelSpec]) -> Tuple[ModelSpec, Optional[str], Optional[str]]:
    """Return ``(spec, default_checkpoint, label_map_path)`` for any source."""
    if isinstance(source, ModelSpec):
        return source, None, None
    if source in _MODEL_REGISTRY:
        return get_model_spec(source), get_checkpoint_path(source), get_class_mapping_path(source)
    if str(source).endswith((".yml", ".yaml")):
        import yaml

        doc = yaml.safe_load(_read_text(str(source)))
        spec_dict = doc.get("model_spec", doc)
        return ModelSpec(**spec_dict), doc.get("checkpoint_path"), doc.get("class_mapping_path")
    raise ValueError(
        f"Cannot resolve model source {source!r}: not a registry key, spec YAML "
        f"path, or ModelSpec. Registered: {sorted(_MODEL_REGISTRY)}"
    )


def load_label_mapping(source: str) -> Optional[Dict[str, Any]]:
    """Load a label mapping from a registry key, spec YAML, or local JSON path."""
    path: Optional[str]
    if str(source).endswith(".json"):
        path = str(source)
    else:
        _, _, path = _resolve_spec(source)
    if path is None:
        return None
    return json.loads(_read_text(path))


def load_model(
    source: Union[str, ModelSpec],
    device: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    return_features_only: bool = False,
    num_classes: Optional[int] = None,
    random_weights: bool = False,
    quantization: Optional[str] = None,
    **overrides: Any,
):
    """Load a ready-to-run model with weights and label mapping attached.

    Args:
        source: registry key, spec YAML path, or :class:`ModelSpec`.
        device: ``None`` (the spec's device, ``cuda`` by default) or an
            explicit ``"cuda"`` / ``"cpu"``. Without a card, ``cuda`` raises.
        checkpoint_path: local checkpoint overriding the registry/YAML default.
        return_features_only: build without a classifier head.
        num_classes: explicit head size (otherwise inferred).
        random_weights: skip checkpoint loading entirely (seeded random init).
        quantization: ``"int8"`` converts the loaded weights to the W8A8
            dynamic-int8 serving mode (``avex_tpu_torch.quant``, the K7
            kernel on CUDA) after the checkpoint loads; inference-only.
            Another mode, or a model without int8 support, raises.
    """
    spec, default_ckpt, label_map_path = _resolve_spec(source)
    resolved_ckpt = checkpoint_path or default_ckpt
    if checkpoint_path is not None:
        spec = spec.replace(pretrained=False)

    state = None
    if resolved_ckpt and not random_weights:
        state = process_state_dict(universal_load(resolved_ckpt))

    if label_map_path and is_remote(label_map_path):
        if not random_weights:
            logger.warning("Could not load label mapping %s: the port reads local files only", label_map_path)
        label_map_path = None
    label_mapping = json.loads(_read_text(label_map_path)) if label_map_path else None

    if num_classes is None and not return_features_only:
        if state is not None:
            num_classes = extract_num_classes(state)
        if num_classes is None and label_mapping:
            num_classes = len(label_mapping)

    model = build_model_from_spec(
        spec,
        device=device,
        num_classes=num_classes,
        return_features_only=return_features_only,
        **overrides,
    )
    model.label_mapping = label_mapping
    if state is not None:
        model.load_state_dict(state)
        model.loaded_checkpoint = resolved_ckpt
    if quantization is not None:
        model.quantize(quantization)
    return model
