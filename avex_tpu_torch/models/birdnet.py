"""BirdNet host adapter (TFLite).

Port of ``avex_tpu/models/birdnet.py``: clip-level scores and penultimate
embeddings from a BirdNet TFLite graph, driven through
``tf.lite.Interpreter`` with ``experimental_preserve_all_tensors=True`` so
that intermediate tensors stay readable after ``invoke()``. The graph is
opaque to PyTorch, so its compute stays on the host by design: the model
never touches the card, and ``to``/``cpu``/``cuda`` are no-ops. Backends:

1. a local ``.tflite`` ``model_path`` (or ``extra_config["model_path"]``)
   drives the interpreter directly;
2. otherwise ``birdnetlib``'s bundled analyzer supplies model and labels;
3. otherwise the constructor raises an ``ImportError`` naming both.

TensorFlow and ``birdnetlib`` are imported inside the constructor only; the
species list and the 3 s windowing (``_chunk``) need neither.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from avex_tpu_torch.models.base import ModelBase

__all__ = ["Model", "TFLiteBackend", "load_species_list"]

#: BirdNet's native input: 3 s chunks at 48 kHz.
CHUNK_SECONDS = 3.0
INPUT_SR = 48000


def load_species_list(path: Optional[str] = None) -> List[str]:
    """A BirdNet species list, one ``sci_name_common name`` per line."""
    if path is None:
        return []
    with open(path, encoding="utf-8") as f:
        return [line.strip() for line in f if line.strip()]


class TFLiteBackend:
    """Minimal TFLite runner: clip-level outputs and penultimate embeddings.

    The embedding tensor is, in order: a second model output (the old BirdNet
    format), a ``GLOBAL_AVG_POOL`` tensor, or the last 2-D intermediate
    before the logits.
    """

    def __init__(self, model_path: str) -> None:
        try:
            from tensorflow import lite as tflite  # type: ignore
        except ImportError as err:
            raise ImportError(
                "BirdNet's TFLite backend requires TensorFlow (a host-side optional "
                "dependency; the port's card path never imports it)."
            ) from err
        self._interp = tflite.Interpreter(model_path=model_path, experimental_preserve_all_tensors=True)
        self._interp.allocate_tensors()
        self._input = self._interp.get_input_details()[0]
        # With two outputs (scores and embeddings) the scores are computed from
        # the embedding, so they have the higher tensor index, whatever order
        # get_output_details() lists them in.
        self._outputs = sorted(self._interp.get_output_details(), key=lambda d: -int(d["index"]))

    @property
    def input_samples(self) -> int:
        """Flattened input length the model expects (e.g. 144000 = 3 s at 48 kHz)."""
        return int(np.prod(self._input["shape"][1:]))

    @property
    def num_classes(self) -> int:
        """Width of the score output (the species count)."""
        return int(self._outputs[0]["shape"][-1])

    def _invoke(self, clip: np.ndarray) -> None:
        clip = np.asarray(clip, np.float32).reshape((1,) + tuple(self._input["shape"][1:]))
        self._interp.set_tensor(self._input["index"], clip)
        self._interp.invoke()

    def predict(self, clip: np.ndarray) -> np.ndarray:
        """Clip-level output vector (logits or confidences, as the model defines)."""
        self._invoke(clip)
        return np.asarray(self._interp.get_tensor(self._outputs[0]["index"])[0])

    def embed(self, clip: np.ndarray) -> np.ndarray:
        """Penultimate-layer embedding of one clip."""
        self._invoke(clip)
        if len(self._outputs) > 1:
            return np.asarray(self._interp.get_tensor(self._outputs[1]["index"])[0])
        logits_idx = self._outputs[0]["index"]
        pool_match, last_2d = None, None
        for detail in self._interp.get_tensor_details():
            idx, shape = detail["index"], list(detail.get("shape", []))
            if idx == logits_idx or len(shape) != 2 or shape[0] != 1:
                continue
            if "GLOBAL_AVG_POOL" in detail.get("name", ""):
                pool_match = idx
            last_2d = idx if (last_2d is None or idx > last_2d) else last_2d
        chosen = pool_match if pool_match is not None else last_2d
        if chosen is None:
            raise ValueError("could not locate an embedding tensor in the TFLite graph")
        return np.asarray(self._interp.get_tensor(chosen)[0])


class Model(ModelBase):
    """BirdNet wrapper registered as ``birdnet``: a local TFLite
    ``model_path`` (host TensorFlow) or the ``birdnetlib`` package."""

    #: birdnetlib keeps a trailing partial chunk only when it holds at least
    #: half of the 3 s window (1.5 s).
    MINLEN_FRACTION = 0.5

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = True,
        audio_config: Optional[Dict[str, Any]] = None,
        language: str = "en_us",
        model_path: Optional[str] = None,
        labels_path: Optional[str] = None,
        extra_config: Optional[Dict[str, Any]] = None,
        **_ignored: Any,
    ) -> None:
        super().__init__(device="cpu", audio_config=audio_config)  # the host runs the graph
        self.language = language
        extra_config = extra_config or {}
        model_path = model_path or extra_config.get("model_path")
        labels_path = labels_path or extra_config.get("labels_path")
        self._analyzer = None
        if model_path is not None:
            self._backend = TFLiteBackend(model_path)
            self.species = load_species_list(labels_path)
        else:
            try:
                from birdnetlib.analyzer import Analyzer  # type: ignore
            except ImportError as err:
                raise ImportError(
                    "BirdNet requires either a local TFLite 'model_path' (host TensorFlow "
                    "drives it directly) or the optional 'birdnetlib' dependency. Use the "
                    "'perch' model for bird classification on the card, or supply model_path."
                ) from err
            self._analyzer = Analyzer()
            self._backend = TFLiteBackend(self._analyzer.model_path)
            self.species = [d["scientific_name"] for d in getattr(self._analyzer, "labels", [])] or []
        self.species_to_idx = {name: i for i, name in enumerate(self.species)}
        self.num_classes = len(self.species) or self._backend.num_classes or num_classes

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            self._layer_names = ["embeddings"]

    def _chunk(self, clip: np.ndarray) -> np.ndarray:
        """One waveform as the model's fixed-length windows: a short clip is
        right-padded to one window; a trailing partial window is zero-padded
        when it holds at least half a window, and dropped otherwise."""
        n = self._backend.input_samples
        if len(clip) < n:
            clip = np.pad(clip, (0, n - len(clip)))
        minlen = int(n * self.MINLEN_FRACTION)
        windows = []
        for i in range(0, len(clip), n):
            w = clip[i:i + n]
            if len(w) < n:
                if len(w) < minlen:
                    break
                w = np.pad(w, (0, n - len(w)))
            windows.append(w)
        return np.stack(windows)

    def forward(self, x, padding_mask=None) -> np.ndarray:
        """Clip-level scores; a clip of several windows takes their maximum."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        return np.stack([np.stack([self._backend.predict(w) for w in self._chunk(clip)]).max(axis=0)
                         for clip in x])

    def extract_embeddings(self, x, padding_mask=None, aggregation: str = "mean", **_kw) -> np.ndarray:
        """Penultimate-layer embeddings over the 3 s windows: ``mean`` (and
        ``cls_token``: BirdNet has no class token), ``max`` or ``none``."""
        if isinstance(x, dict):
            x = x["raw_wav"]
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        per_clip = []
        for clip in x:
            embs = np.stack([self._backend.embed(w) for w in self._chunk(clip)])
            if aggregation == "max":
                per_clip.append(embs.max(axis=0))
            elif aggregation == "none":
                per_clip.append(embs)
            else:
                per_clip.append(embs.mean(axis=0))
        return np.stack(per_clip)

    def to(self, device) -> "Model":
        """A no-op: TFLite runs on the host."""
        return self

    def cpu(self) -> "Model":
        """A no-op: TFLite runs on the host."""
        return self

    def cuda(self) -> "Model":
        """A no-op: TFLite runs on the host."""
        return self
