"""Perch / SurfPerch bird-vocalization classifiers in PyTorch.

Port of ``avex_tpu/models/perch.py``: the wrapper interface of the reference
(32 kHz input, a 5 s centre crop or zero pad, 10932-class logits and a
1280-d embedding, one ``embedding`` tap) on this port's EfficientNet-B1 with
the TF-provenance semantics of the published checkpoints: TF "SAME" conv
padding and BatchNorm eps 1e-3. :func:`perch_frontend` is a log-mel
spectrogram on the generic frontend (n_fft 2048, hop 320, window 640, 160
HTK mels over 60 Hz-10 kHz, log clamped at 1e-6).

Weights: a converted TF-Hub checkpoint as a torchvision-style state dict, or
a raw Keras variable dump (:func:`convert_keras_efficientnet_state` maps its
names and layouts); without one the weights are seeded random.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import build_module, torch_dtype
from avex_tpu_torch.models.efficientnet import EfficientNetModel, convert_efficientnet_state_dict, stage_config
from avex_tpu_torch.ops.frontend import mel_product, stft_power

__all__ = ["PERCH_NUM_CLASSES", "Model", "SurfPerchModel", "convert_keras_efficientnet_state", "perch_frontend"]

PERCH_NUM_CLASSES = 10932
PERCH_SAMPLE_RATE = 32000
PERCH_WINDOW_SECONDS = 5.0


def perch_frontend(wav: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """32 kHz waveform ``[B, T]`` → log-mel ``[B, 160, frames]``, fp32.

    ``precision`` is the DFT product's (``ops/frontend.stft_power``): the bf16
    model takes ``"default"``, as JAX's; the mel product is fp32 in both.
    """
    power = stft_power(wav, n_fft=2048, hop_length=320, win_length=640, precision=precision)
    mel = mel_product(power, 160, float(PERCH_SAMPLE_RATE), f_min=60.0, f_max=10000.0)
    return torch.log(torch.clamp_min(mel, 1e-6))


def convert_keras_efficientnet_state(state: Mapping[str, Any], variant: str = "b1") -> Dict[str, np.ndarray]:
    """Keras-applications EfficientNet variable names → torchvision-style keys.

    As the JAX package's: ``:0`` suffixes and path prefixes are dropped;
    ``stem_conv``, ``block{stage}{letter}_{expand_conv, dwconv, se_reduce,
    se_expand, project_conv}`` with their BatchNorms, ``top_conv`` and
    ``predictions`` map onto ``features...`` and ``classifier.1``, with the
    layouts transposed (HWIO conv → OIHW, depthwise HWCM → C1HW, dense
    ``[in, out]`` → ``[out, in]``).
    """
    normalized: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        k = key.split(":")[0]
        k = k.split("/")[-2] + "/" + k.split("/")[-1] if "/" in k else k
        normalized[k] = np.asarray(value)
    out: Dict[str, np.ndarray] = {}

    def conv(src: str, dest: str, depthwise: bool = False) -> None:
        kernel = normalized.get(f"{src}/kernel", normalized.get(f"{src}/depthwise_kernel"))
        if kernel is None:
            return
        out[f"{dest}.weight"] = np.transpose(kernel, (2, 3, 0, 1) if depthwise else (3, 2, 0, 1))
        if f"{src}/bias" in normalized:
            out[f"{dest}.bias"] = normalized[f"{src}/bias"]

    def bn(src: str, dest: str) -> None:
        mapping = {"gamma": "weight", "beta": "bias", "moving_mean": "running_mean",
                   "moving_variance": "running_var"}
        for keras_name, torch_name in mapping.items():
            if f"{src}/{keras_name}" in normalized:
                out[f"{dest}.{torch_name}"] = normalized[f"{src}/{keras_name}"]

    conv("stem_conv", "features.0.0")
    bn("stem_bn", "features.0.1")
    letters = "abcdefghijklmnop"
    for stage_i, (t, _c, n, _s, _k) in enumerate(stage_config(variant), start=1):
        for j in range(n):
            keras, base = f"block{stage_i}{letters[j]}", f"features.{stage_i}.{j}.block"
            if t != 1:
                conv(f"{keras}_expand_conv", f"{base}.0.0")
                bn(f"{keras}_expand_bn", f"{base}.0.1")
                dw, se, proj = 1, 2, 3
            else:
                dw, se, proj = 0, 1, 2
            conv(f"{keras}_dwconv", f"{base}.{dw}.0", depthwise=True)
            bn(f"{keras}_bn", f"{base}.{dw}.1")
            conv(f"{keras}_se_reduce", f"{base}.{se}.fc1")
            conv(f"{keras}_se_expand", f"{base}.{se}.fc2")
            conv(f"{keras}_project_conv", f"{base}.{proj}.0")
            bn(f"{keras}_project_bn", f"{base}.{proj}.1")
    conv("top_conv", "features.8.0")
    bn("top_bn", "features.8.1")
    if "predictions/kernel" in normalized:
        out["classifier.1.weight"] = normalized["predictions/kernel"].T
        out["classifier.1.bias"] = normalized["predictions/bias"]
    return out


class Model(ModelBase):
    """Perch wrapper registered as ``perch``: 10932-class logits and the
    1280-d pooled embedding, the only tap."""

    model_family = "perch"

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = False,
        audio_config: Optional[Dict[str, Any]] = None,
        return_features_only: bool = False,
        compute_dtype: str = "float32",
        seed: int = 0,
        **_ignored: Any,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        self.num_classes = PERCH_NUM_CLASSES
        self.window_samples = int(PERCH_WINDOW_SECONDS * PERCH_SAMPLE_RATE)
        dtype = torch_dtype(compute_dtype)
        self._frontend_precision = "default" if dtype == torch.bfloat16 else "highest"
        self.module = build_module(
            lambda: EfficientNetModel("b1", PERCH_NUM_CLASSES, dtype, bn_eps=1e-3, tf_same_padding=True),
            seed, self.device,
        )

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            self._layer_names = ["embedding"]  # the reference's TF graph exposes nothing else

    def _prepare(self, x) -> torch.Tensor:
        """5 s centre crop or zero pad at 32 kHz, the frontend, the 3-channel repeat."""
        x = self._as_input(x)
        if x.ndim == 1:
            x = x[None]
        length, target = x.shape[-1], self.window_samples
        if length > target:
            start = (length - target) // 2
            x = x[..., start:start + target]
        elif length < target:
            x = torch.nn.functional.pad(x, (0, target - length))
        spec = perch_frontend(x, self._frontend_precision)
        return spec[:, None].expand(-1, 3, -1, -1)

    def forward(self, x, padding_mask=None) -> torch.Tensor:
        """The 10932-class logits; :meth:`infer` gives the embedding too."""
        return self.infer(x)["logits"]

    def infer(self, x) -> Dict[str, torch.Tensor]:
        """``{"logits": [B, 10932], "embedding": [B, 1280]}``."""
        with torch.set_grad_enabled(self._training):
            logits, aux = self.module(self._prepare(x))
        return {"logits": logits, "embedding": aux["pooled"]}

    def extract_fn(self, layers: Tuple[str, ...], aggregation: str):
        """``(wav, mask) → the pooled embedding``: Perch has one tap, so
        ``layers`` and ``aggregation`` are taken for the common interface and
        not used."""

        def extract(x: torch.Tensor, padding_mask: Optional[torch.Tensor]):
            return self.module(self._prepare(x))[1]["pooled"]

        return extract

    def extract_embeddings(self, x, padding_mask=None, aggregation: str = "none", **_kw) -> torch.Tensor:
        """The 1280-d pooled embedding."""
        if isinstance(x, dict):
            x = x["raw_wav"]
        return self.infer(x)["embedding"]

    def load_state_dict(self, state: Mapping[str, Any], strict: bool = False) -> None:
        """Load converted TF-Hub weights; a raw Keras dump is remapped first."""
        if any("/" in k or k.startswith(("stem_", "block", "top_")) for k in state):
            state = convert_keras_efficientnet_state(state, "b1")
        self.load_port_state_dict(convert_efficientnet_state_dict(state, "b1", num_classes=PERCH_NUM_CLASSES),
                                  strict=strict)


class SurfPerchModel(Model):
    """SurfPerch (the marine variant): Perch's interface, other weights."""

    model_family = "surfperch"
