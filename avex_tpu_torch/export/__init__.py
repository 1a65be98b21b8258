"""Deployment export: a model → a ``torch.export`` program on raw waveforms.

Counterpart of ``avex_tpu/export/__init__.py``, which converts the JAX
forward with ``jax2tf`` into a TF SavedModel or a TFLite flatbuffer. The
port has no converter to those formats (no TensorFlow on the machine with
the card, no ONNX), so it writes the program format of its own framework:

- :func:`export_program` runs ``torch.export.export`` over the pure forward
  (:func:`_pure_forward`: the pooled capture path for ``embed``, the frontend
  and the classifier for ``logits``), with the whole frontend (fbank,
  spectrogram) in the program, so the artifact takes the raw waveform
  ``float32[batch, clip_seconds * sample_rate]``. The batch axis is a
  ``torch.export.Dim`` unless ``batch_size`` pins it (JAX's polymorphic
  SavedModel). It writes the program with ``torch.export.save`` and the
  sidecar ``avex_tpu_export.json`` with JAX's keys;
- :func:`export_savedmodel` and :func:`export_tflite` keep JAX's names and
  signatures and raise ``NotImplementedError``: no TF converter is
  available to the port;
- a model whose attention runs a hand-written kernel (``use_pallas=True``)
  is refused: the kernels are bound through ``ctypes``, which
  ``torch.export`` cannot trace, and a program must not run another path
  than the model it was asked for. So is an int8 model, as JAX's int8
  export does not legalize (``tests/unittests/test_export.py``).

Load a program with ``torch.export.load(path).module()`` and call it on a
waveform batch on the device it was exported on. A float32 model turns TF32
off around its frontend and convolutions (``ops/_precision.full_fp32``); a
program records the operations, not those flags, so on the card call an
fp32 program inside ``full_fp32()`` to get the eager model's numbers.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Optional, Sequence, Union

import torch
from torch import nn

logger = logging.getLogger(__name__)

__all__ = ["META_FILE", "export_program", "export_savedmodel", "export_tflite"]

#: the sidecar beside an exported program, with JAX's name and keys
META_FILE = "avex_tpu_export.json"

_NO_TF = ("{fmt} export needs TensorFlow's converter, which the PyTorch port does not have (no TensorFlow on "
          "the machine with the card, no torch-to-TF converter); export a torch.export program with "
          "export_program (the CLI's --format pt2)")


class _PureForward(nn.Module):
    """The exported computation: ``waveform → row batch`` (see :func:`_pure_forward`)."""

    def __init__(self, model: Any, mode: str, layers: Sequence[Any], aggregation: str) -> None:
        super().__init__()
        self.model = model
        self.mode = mode
        self.net = model.module  # the program's parameters and buffers
        if mode == "embed":
            self.extract = model.extract_fn(tuple(model.register_hooks_for_layers(list(layers))), aggregation)

    def forward(self, waveform: torch.Tensor) -> torch.Tensor:
        if self.mode == "embed":
            return self.extract(waveform, None)
        return self.model.forward(waveform)


def _pure_forward(model: Any, mode: str, layers: Sequence[Any], aggregation: str) -> nn.Module:
    """The exported computation as a module: ``waveform → row batch``.

    ``embed`` is the pooled capture path over the resolved ``layers`` (the
    captured tensors are the module's return value, no module state);
    ``logits`` is the model's own forward on the waveform, frontend and
    classifier (``model(waveform)``). JAX's runs its module on
    ``process_audio(waveform)``, the same function for every model whose
    forward is that, and a shape error for Perch, whose frontend is its own:
    the port's gives Perch's logits.
    """
    if mode not in ("embed", "logits"):
        raise ValueError(f"mode must be 'embed' or 'logits', got {mode!r}")
    return _PureForward(model, mode, layers, aggregation)


def _check_exportable(model: Any) -> None:
    """Refuse a model whose forward would launch a hand-written kernel or run int8."""
    from avex_tpu_torch.quant import Int8Linear

    if model.module is None:
        raise ValueError("model has no module; load or initialize it first")
    for name, sub in model.module.named_modules():
        if isinstance(sub, Int8Linear):
            raise ValueError(f"int8 models do not export ({name or 'the module'} is an Int8Linear): the int8 "
                             "product is a hand-written kernel, and JAX's int8 export does not legalize either; "
                             "export the float model")
        if getattr(sub, "use_pallas", False):
            raise ValueError(f"{name or 'the module'} runs its attention on a hand-written kernel "
                             "(use_pallas=True), which torch.export cannot trace (the kernels are bound through "
                             "ctypes); rebuild the model with use_pallas=False to export it")


def export_program(
    model: Any,
    out_path: Union[str, Path],
    *,
    mode: str = "embed",
    layers: Sequence[Any] = ("last_layer",),
    aggregation: str = "mean",
    clip_seconds: float = 5.0,
    batch_size: Optional[int] = None,
) -> Path:
    """Export a loaded model as a ``torch.export`` program on raw waveforms.

    ``batch_size=None`` (default) keeps the batch axis dynamic: one program
    serves any batch of at least one clip. The input is ``waveform:
    float32[batch, clip_seconds * sample_rate]`` on the model's device; the
    output is the pooled embeddings (``embed``) or the logits (``logits``).
    Writes ``out_path`` (conventionally ``.pt2``) and ``avex_tpu_export.json``
    beside it; returns ``out_path``.
    """
    _check_exportable(model)
    sample_rate = int(getattr(model.audio_config, "sample_rate", None) or 16000)
    n_samples = int(clip_seconds * sample_rate)
    forward = _pure_forward(model, mode, layers, aggregation).eval()
    example = torch.zeros((batch_size or 2, n_samples), dtype=torch.float32, device=model.device)
    dynamic = None if batch_size is not None else ({0: torch.export.Dim("batch", min=1)},)
    with torch.no_grad():
        program = torch.export.export(forward, (example,), dynamic_shapes=dynamic)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out_path))
    meta = {
        "mode": mode,
        "sample_rate": sample_rate,
        "clip_seconds": clip_seconds,
        "n_samples": n_samples,
        "layers": [str(x) for x in layers],
        "aggregation": aggregation,
    }
    (out_path.parent / META_FILE).write_text(json.dumps(meta, indent=2))
    logger.info("torch.export program written to %s (%s)", out_path, meta)
    return out_path


def export_savedmodel(
    model: Any,
    out_dir: Union[str, Path],
    *,
    mode: str = "embed",
    layers: Sequence[Any] = ("last_layer",),
    aggregation: str = "mean",
    clip_seconds: float = 5.0,
    batch_size: Optional[int] = None,
) -> Path:
    """JAX's TF SavedModel export: not available to the port (raises)."""
    raise NotImplementedError(_NO_TF.format(fmt="TF SavedModel"))


def export_tflite(
    model: Any,
    out_path: Optional[Union[str, Path]] = None,
    *,
    mode: str = "embed",
    layers: Sequence[Any] = ("last_layer",),
    aggregation: str = "mean",
    clip_seconds: float = 5.0,
    batch_size: int = 1,
    quantize_float16: bool = False,
) -> bytes:
    """JAX's TFLite export: not available to the port (raises)."""
    raise NotImplementedError(_NO_TF.format(fmt="TFLite"))
