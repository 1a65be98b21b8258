"""ResNet-18/50/152 in PyTorch, under torchvision's module names.

Port of ``avex_tpu/models/resnet.py``: mel spectrogram → 3-channel image
normalised to [0, 1] per image → torchvision-layout ResNet (a 7x7 stride-2
stem, BatchNorm, ReLU, a 3x3 stride-2 max pool, four stages of basic or
bottleneck blocks) → mean pool → classifier. BatchNorm is flax's
(``models/common.batch_norm``). ``aux["intermediates"]`` holds the four
stage outputs as ``backbone.layer{1..4}`` ``[B, C, H, W]``; a 4-D tap takes
no pooled aggregation, as in JAX (use ``aggregation="none"``). As
EfficientNet's: fp32 convolutions take cuDNN's setting (``full_fp32()``
for full fp32), activations are ``channels_last`` on the card.

:func:`convert_resnet_state_dict` takes torchvision keys or the reference
wrapper's ``backbone.`` prefix (``fc`` or ``classifier`` as the head);
:func:`params_from_jax` carries JAX's ``{"params", "batch_stats"}`` across.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import batch_norm, build_module, conv2d, dense, torch_dtype

__all__ = ["RESNET_VARIANTS", "Model", "ResNetModel", "convert_resnet_state_dict", "params_from_jax"]

#: variant → (block type, stage depths)
RESNET_VARIANTS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


class _Block(nn.Module):
    """torchvision ``BasicBlock`` (two 3x3 convs) or ``Bottleneck`` (1x1, 3x3
    with the stride, 1x1 to 4x the width), with ``downsample`` (a strided
    1x1 conv and BatchNorm) where the shape changes."""

    def __init__(self, cin: int, width: int, stride: int, bottleneck: bool) -> None:
        super().__init__()
        cout = width * 4 if bottleneck else width
        shapes = ([(cin, width, 1, 1), (width, width, 3, stride), (width, cout, 1, 1)] if bottleneck
                  else [(cin, width, 3, stride), (width, width, 3, 1)])
        for i, (a, b, k, s) in enumerate(shapes, start=1):
            self.add_module(f"conv{i}", nn.Conv2d(a, b, k, s, bias=False))
            self.add_module(f"bn{i}", nn.BatchNorm2d(b))
        self.n_convs = len(shapes)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        out = x
        for i in range(1, self.n_convs + 1):
            out = batch_norm(getattr(self, f"bn{i}"), conv2d(getattr(self, f"conv{i}"), out, dtype), dtype)
            if i < self.n_convs:
                out = F.relu(out)
        residual = x
        if self.downsample is not None:
            residual = batch_norm(self.downsample[1], conv2d(self.downsample[0], x, dtype), dtype)
        return F.relu(out + residual)


class ResNetModel(nn.Module):
    """torchvision-layout ResNet; ``forward`` returns ``(features or logits,
    aux)`` with the four stage taps. ``channels_last`` keeps activations in
    NHWC memory on the card."""

    def __init__(self, variant: str = "resnet18", num_classes: Optional[int] = None,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        block_type, depths = RESNET_VARIANTS[variant]
        bottleneck = block_type == "bottleneck"
        self.num_classes, self.dtype = num_classes, dtype
        self.channels_last = True
        self.conv1 = nn.Conv2d(3, 64, 7, 2, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        cin, width = 64, 64
        for stage_i, depth in enumerate(depths, start=1):
            blocks = []
            for j in range(depth):
                blocks.append(_Block(cin, width, (1 if stage_i == 1 else 2) if j == 0 else 1, bottleneck))
                cin = width * 4 if bottleneck else width
            self.add_module(f"layer{stage_i}", nn.Sequential(*blocks))
            width *= 2
        if num_classes is not None:
            self.classifier = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``x``: ``[B, 3, F, T]`` or ``[B, F, T]`` (repeated to 3 channels);
        ``padding_mask`` is accepted and not used, as in JAX. In training mode
        BatchNorm takes the batch's statistics and updates its running ones."""
        dt = self.dtype
        if x.ndim == 3:
            x = x[:, None].expand(-1, 3, -1, -1)
        x = x.to(dt)
        if self.channels_last and x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        intermediates: Dict[str, torch.Tensor] = {}
        x = F.relu(batch_norm(self.bn1, conv2d(self.conv1, x, dt), dt))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage_i in range(1, 5):
            for block in getattr(self, f"layer{stage_i}"):
                x = block(x, dt)
            intermediates[f"backbone.layer{stage_i}"] = x
        pooled = x.mean(dim=(2, 3))
        aux: Dict[str, Any] = {"intermediates": intermediates, "features": x, "pooled": pooled}
        if self.num_classes is None:
            return x, aux
        return dense(self.classifier, pooled, dt), aux


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _convbn_keys(conv: str, bn: str) -> List[str]:
    return [f"{conv}.weight"] + [f"{bn}.{name}" for name in _BN_KEYS]


def convert_resnet_state_dict(state: Mapping[str, Any], variant: str = "resnet18",
                              num_classes: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A torchvision or reference-wrapper (``backbone.``) ResNet state dict →
    this port's state dict, as the JAX package's converter takes it: the
    stem, every block's convs and BatchNorms (running statistics included),
    the downsample where present, and the head (``classifier`` or ``fc``)
    only with ``num_classes``."""
    state = {(k[len("backbone."):] if k.startswith("backbone.") else k): v for k, v in state.items()}
    block_type, depths = RESNET_VARIANTS[variant]
    n_convs = 2 if block_type == "basic" else 3
    keys = _convbn_keys("conv1", "bn1")
    for stage_i, depth in enumerate(depths, start=1):
        for j in range(depth):
            base = f"layer{stage_i}.{j}"
            for c in range(1, n_convs + 1):
                keys += _convbn_keys(f"{base}.conv{c}", f"{base}.bn{c}")
            if f"{base}.downsample.0.weight" in state:
                keys += _convbn_keys(f"{base}.downsample.0", f"{base}.downsample.1")
    out = {k: np.asarray(state[k], dtype=np.float32) for k in keys}
    for head in ("classifier", "fc"):
        if num_classes is not None and f"{head}.weight" in state:
            out["classifier.weight"] = np.asarray(state[f"{head}.weight"], dtype=np.float32)
            out["classifier.bias"] = np.asarray(state[f"{head}.bias"], dtype=np.float32)
            break
    return out


def params_from_jax(variables: Mapping[str, Any], variant: str = "resnet18") -> Dict[str, np.ndarray]:
    """JAX ``ResNetModel`` variables (``{"params", "batch_stats"}``, numpy
    leaves) → this port's state dict (HWIO → OIHW, BatchNorm ``scale`` →
    ``weight``, ``mean``/``var`` → running statistics, Dense → Linear)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: Any) -> None:
        out[key] = np.asarray(value, dtype=np.float32)

    def convbn(conv: str, bn: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
        put(f"{conv}.weight", np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1))
        put(f"{bn}.weight", p["bn"]["scale"])
        put(f"{bn}.bias", p["bn"]["bias"])
        if "bn" in s:
            put(f"{bn}.running_mean", s["bn"]["mean"])
            put(f"{bn}.running_var", s["bn"]["var"])

    convbn("conv1", "bn1", {"conv": params["conv1"], "bn": params["bn1"]},
           {"bn": stats["bn1"]} if "bn1" in stats else {})
    block_type, depths = RESNET_VARIANTS[variant]
    n_convs = 2 if block_type == "basic" else 3
    for stage_i, depth in enumerate(depths, start=1):
        for j in range(depth):
            name, base = f"layer{stage_i}_{j}", f"layer{stage_i}.{j}"
            p, s = params[name], stats.get(name, {})
            for c in range(1, n_convs + 1):
                convbn(f"{base}.conv{c}", f"{base}.bn{c}", p[f"cb{c}"], s.get(f"cb{c}", {}))
            if "down" in p:
                convbn(f"{base}.downsample.0", f"{base}.downsample.1", p["down"], s.get("down", {}))
    if "classifier" in params:
        put("classifier.weight", np.asarray(params["classifier"]["kernel"]).T)
        put("classifier.bias", params["classifier"]["bias"])
    return out


# ---------------------------------------------------------------------------
# Registered wrapper (architecture names: "resnet18", "resnet50", "resnet152")
# ---------------------------------------------------------------------------


class Model(ModelBase):
    """ResNet wrapper registered as ``resnet18``/``resnet50``/``resnet152``
    (the factory passes the name as ``variant``). A bf16 trunk takes the
    ``"default"`` DFT precision, as in JAX."""

    def __init__(
        self,
        variant: str = "resnet18",
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = True,
        audio_config: Optional[Dict[str, Any]] = None,
        return_features_only: bool = False,
        compute_dtype: str = "float32",
        seed: int = 0,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        if num_classes is None:
            return_features_only = True
        variant = variant.lower()
        if variant not in RESNET_VARIANTS:
            raise ValueError(f"Unsupported ResNet variant {variant!r}; supported: {list(RESNET_VARIANTS)}")
        self.variant = variant
        self.num_classes = None if return_features_only else num_classes
        dtype = torch_dtype(compute_dtype)
        if dtype == torch.bfloat16 and self.audio_processor is not None:
            self.audio_processor.precision = "default"
        self.module = build_module(lambda: ResNetModel(variant, self.num_classes, dtype), seed, self.device)

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            self._layer_names = [f"backbone.layer{i}" for i in range(1, 5)]

    def process_audio(self, x) -> torch.Tensor:
        """Spectrogram → 3-channel image scaled by its per-image max (+1e-6)."""
        x = super().process_audio(x)
        if x.ndim == 3:
            x = x[:, None].expand(-1, 3, -1, -1)
        return x / (x.amax(dim=(2, 3), keepdim=True) + 1e-6)

    def forward(self, x, padding_mask=None) -> torch.Tensor:
        """Waveform or spectrogram → logits (or features without a classifier)."""
        return super().forward(self.process_audio(x), None)

    def extract_fn(self, layers: Tuple[str, ...], aggregation: str):
        """Extraction with the frontend ahead of the conv net for a waveform ``[B, T]``."""
        inner = super().extract_fn(layers, aggregation)

        def extract(x: torch.Tensor, padding_mask: Optional[torch.Tensor]):
            return inner(self.process_audio(x) if x.ndim == 2 else x, None)

        return extract

    def load_state_dict(self, state: Mapping[str, Any], strict: bool = False) -> None:
        """Load a torchvision ResNet state dict."""
        self.load_port_state_dict(convert_resnet_state_dict(state, self.variant, self.num_classes), strict=strict)
