"""Checkpoint loading: local torch / npz / safetensors files → numpy state dicts.

Counterpart of ``avex_tpu/utils/loaders.py``: any supported checkpoint
resolves to a flat ``{name: np.ndarray}`` state dict with the reference's
prefix normalisation. The port reads local files only; a remote URI raises.
``safetensors`` is imported only when such a file is read.
"""

from __future__ import annotations

import io as _io
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: Guard against truncated/empty published safetensors files.
MIN_PUBLISHED_SAFETENSORS_BYTES = 1024
_REMOTE_SCHEMES = ("hf://", "gs://", "s3://", "http://", "https://")

StateDict = Dict[str, np.ndarray]


def is_remote(path: str) -> bool:
    """True for URIs the port cannot read (``hf://``, ``gs://``, ``http(s)://`` ...)."""
    return str(path).startswith(_REMOTE_SCHEMES)


def local_path(path: str) -> str:
    """``path`` as a local file name; raises for a remote URI."""
    path = str(path)
    if is_remote(path):
        raise ValueError(
            f"{path!r} is a remote URI; the PyTorch port reads local files only. "
            "Download the file and pass its local path."
        )
    if path.startswith("file://"):
        path = path[len("file://"):]
    return path


def _to_numpy(value: Any) -> Any:
    """Convert torch tensors (incl. bf16) to numpy; leave other values alone."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return value


def _flatten_numeric(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    out: StateDict = {}
    for key, value in tree.items():
        full = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten_numeric(value, prefix=full + "."))
        else:
            value = _to_numpy(value)
            if isinstance(value, np.ndarray):
                out[full] = value
    return out


def load_safetensors(path: str) -> StateDict:
    """Load a safetensors file into numpy arrays (imports ``safetensors`` here)."""
    from safetensors.torch import load_file

    size = os.path.getsize(path)
    if size < MIN_PUBLISHED_SAFETENSORS_BYTES:
        raise ValueError(
            f"safetensors file {path} is suspiciously small ({size} bytes); "
            "refusing to load what looks like an empty upload"
        )
    return {k: _to_numpy(v) for k, v in load_file(path).items()}


def load_torch_checkpoint(path: str) -> StateDict:
    """Load a torch ``.pt``/``.ckpt`` pickle into a flat numpy state dict."""
    with open(path, "rb") as f:
        payload = torch.load(_io.BytesIO(f.read()), map_location="cpu", weights_only=False)
    if isinstance(payload, dict):
        # Checkpoints commonly nest the weights under one of these keys.
        for key in ("model_state_dict", "state_dict", "model", "module"):
            if key in payload and isinstance(payload[key], dict):
                payload = payload[key]
                break
        return _flatten_numeric(payload)
    raise TypeError(f"Unsupported torch checkpoint payload type: {type(payload)!r}")


def load_npz(path: str) -> StateDict:
    """Load an ``.npz`` archive of named arrays."""
    with np.load(path, allow_pickle=False) as archive:
        return {k: archive[k] for k in archive.files}


def universal_load(path: str) -> StateDict:
    """Load a local checkpoint into numpy arrays.

    Format is selected by extension (``.safetensors``, ``.npz``, torch
    pickles), falling back to content sniffing.
    """
    local = local_path(path)
    lower = local.lower()
    if lower.endswith(".safetensors"):
        return load_safetensors(local)
    if lower.endswith(".npz"):
        return load_npz(local)
    if lower.endswith((".pt", ".pth", ".ckpt", ".bin")):
        return load_torch_checkpoint(local)
    with open(local, "rb") as f:
        head = f.read(16)
    # safetensors: little-endian u64 header length, then a JSON header; npz: a zip.
    if len(head) >= 9 and head[8:9] in (b"{", b" "):
        return load_safetensors(local)
    if head.startswith(b"PK"):
        return load_npz(local)
    return load_torch_checkpoint(local)


#: Prefixes stripped from checkpoint keys.
_STRIP_PREFIXES = ("module.", "model.", "_orig_mod.")


def process_state_dict(
    state: StateDict,
    drop_classifier: bool = False,
    classifier_keys: tuple = ("classifier.", "predictor.", "head.", "fc."),
    adapt_prefix: Optional[str] = None,
) -> StateDict:
    """Normalize checkpoint key prefixes and optionally drop classifier heads.

    - strips DDP/compile wrappers (``module.``/``model.``/``_orig_mod.``)
    - when ``drop_classifier``, removes final-head parameters
    - when ``adapt_prefix`` is given (e.g. ``"backbone."``), adds it unless
      some keys already carry it.
    """
    out: StateDict = {}
    for key, value in state.items():
        new_key = key
        changed = True
        while changed:
            changed = False
            for prefix in _STRIP_PREFIXES:
                if new_key.startswith(prefix):
                    new_key = new_key[len(prefix):]
                    changed = True
        if drop_classifier and any(part in new_key for part in classifier_keys):
            continue
        out[new_key] = value

    if adapt_prefix:
        has_prefix = sum(1 for k in out if k.startswith(adapt_prefix))
        if 0 < has_prefix < len(out):
            logger.debug("checkpoint has mixed %r prefixing (%d/%d)", adapt_prefix, has_prefix, len(out))
        if has_prefix == 0:
            out = {adapt_prefix + k: v for k, v in out.items()}
    return out


def extract_num_classes(state: StateDict) -> Optional[int]:
    """Infer the classifier output width from checkpoint weights."""
    candidates = [
        "classifier.weight",
        "predictor.weight",
        "head.weight",
        "fc.weight",
        "classifier.kernel",
        "predictor.kernel",
    ]
    normalized = process_state_dict(state)
    for name in candidates:
        for key, value in normalized.items():
            if key == name or key.endswith("." + name):
                if value.ndim == 2:
                    # torch Linear stores (out, in); flax Dense stores (in, out).
                    return int(value.shape[0] if key.endswith("weight") else value.shape[1])
    return None
