"""EfficientNet-B0/B1 in PyTorch, under torchvision's module names.

Port of ``avex_tpu/models/efficientnet.py``:

- the stage table and channel rounding (torchvision's ``_make_divisible``);
- ``_ConvBN`` (conv, BatchNorm, SiLU: ``Conv2dNormActivation``'s ``0``/``1``),
  with torchvision's symmetric padding or TF "SAME" padding (asymmetric at
  stride 2 on an even size: the extra row or column at the end);
- ``_MBConv``: expand (not in stage 1), depthwise, squeeze-excitation whose
  width comes from the block's input channels, project, and stochastic depth
  drawn per item on stride-1 same-width blocks;
- BatchNorm as flax's (``models/common.batch_norm``): batch statistics and a
  running update with the biased variance in training;
- ``EfficientNetModel.forward`` returns ``(features or logits, aux)``;
  ``aux["intermediates"]`` holds the raw conv outputs (before BatchNorm)
  under the reference wrapper's names: ``model.features.0.0``, each
  ``model.features.{i}.{j}.block.3.0`` (stage 1 has no expand conv and no
  tap) and ``model.features.8.0``, 17 for B0;
- the wrapper ``Model`` (``efficientnet``): spectrogram frontend and 3-channel
  repeat, the 4-D aggregation, torchvision state dicts.

The module keeps torchvision's key names (``features.{i}.{j}.block.{k}``,
``classifier.1``), so a torchvision or reference state dict loads key for
key; :func:`params_from_jax` carries JAX's ``{"params", "batch_stats"}``
across. A float32 model's convolutions take cuDNN's setting on the card
(TF32 unless turned off; JAX leaves its convs at the default precision
too): run them under ``ops/_precision.full_fp32()``, forward and backward,
for full fp32. On the card activations are ``channels_last`` (NHWC, JAX's
layout): cuDNN's bf16 kernels run that layout faster.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import batch_norm, build_module, conv2d, dense, dropout, torch_dtype

__all__ = ["VARIANTS", "EfficientNetModel", "Model", "convert_efficientnet_state_dict", "params_from_jax",
           "stage_config"]

# (expand_ratio, channels, layers, stride, kernel) per stage — B0 base.
_B0_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

#: variant → (width_mult, depth_mult, dropout)
VARIANTS = {"b0": (1.0, 1.0, 0.2), "b1": (1.0, 1.1, 0.2)}
_STOCHASTIC_DEPTH = 0.2  # the last block's rate; block i of n takes 0.2 · i / n


def _round_channels(channels: float, width_mult: float, divisor: int = 8) -> int:
    """torchvision ``_make_divisible`` channel rounding."""
    channels *= width_mult
    new = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new < 0.9 * channels:
        new += divisor
    return int(new)


def _round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(repeats * depth_mult))


def stage_config(variant: str) -> List[Tuple[int, int, int, int, int]]:
    """Width/depth-scaled stage table for an EfficientNet variant."""
    width, depth, _ = VARIANTS[variant]
    return [(t, _round_channels(c, width), _round_repeats(n, depth), s, k) for (t, c, n, s, k) in _B0_STAGES]


class _ConvBN(nn.Sequential):
    """Conv + BatchNorm (+ SiLU): torchvision ``Conv2dNormActivation``'s
    ``0`` (conv) and ``1`` (BatchNorm). ``forward`` returns ``(out, conv_out)``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1, act: bool = True,
                 bn_eps: float = 1e-5, tf_same: bool = False) -> None:
        super().__init__(nn.Conv2d(cin, cout, kernel, stride, groups=groups, bias=False),
                         nn.BatchNorm2d(cout, eps=bn_eps))
        self.act, self.tf_same = act, tf_same

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        conv_out = conv2d(self[0], x, dtype, self.tf_same)
        y = batch_norm(self[1], conv_out, dtype)
        return (F.silu(y) if self.act else y), conv_out


class _SqueezeExcitation(nn.Module):
    """torchvision ``SqueezeExcitation``: mean over H, W, 1x1 conv ``fc1``,
    SiLU, 1x1 conv ``fc2``, sigmoid, scale."""

    def __init__(self, channels: int, squeeze: int) -> None:
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        scale = x.mean(dim=(2, 3), keepdim=True)
        scale = F.silu(conv2d(self.fc1, scale, dtype))
        return x * torch.sigmoid(conv2d(self.fc2, scale, dtype))


def stochastic_depth_mask(bsz: int, keep: float, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """Stochastic depth's draw: a ``[bsz, 1, 1, 1]`` bool mask, True (keep
    the item's residual branch) with probability ``keep``."""
    return torch.rand((bsz, 1, 1, 1), generator=generator, device=device) < keep


class _MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation (torchvision
    ``MBConv``): ``block`` holds [expand,] depthwise, SE and project.
    ``forward`` returns ``(out, the projection's conv output)``."""

    def __init__(self, cin: int, cout: int, expand_ratio: int, stride: int, kernel: int,
                 stochastic_depth_prob: float = 0.0, bn_eps: float = 1e-5, tf_same: bool = False) -> None:
        super().__init__()
        expanded = cin * expand_ratio
        common = dict(bn_eps=bn_eps, tf_same=tf_same)
        layers: List[nn.Module] = []
        if expand_ratio != 1:
            layers.append(_ConvBN(cin, expanded, 1, **common))
        layers.append(_ConvBN(expanded, expanded, kernel, stride, groups=expanded, **common))
        layers.append(_SqueezeExcitation(expanded, max(1, cin // 4)))  # squeeze width from the block input
        layers.append(_ConvBN(expanded, cout, 1, act=False, **common))
        self.block = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout
        self.stochastic_depth_prob = stochastic_depth_prob

    def forward(self, x: torch.Tensor, dtype: torch.dtype, deterministic: bool,
                generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
        out = x
        for layer in self.block[:-2]:
            out, _ = layer(out, dtype)
        out = self.block[-2](out, dtype)
        out, proj_conv_out = self.block[-1](out, dtype)
        if self.residual:
            if not deterministic and self.stochastic_depth_prob > 0:
                if generator is None:
                    raise ValueError("stochastic depth outside deterministic mode needs a torch.Generator")
                keep = 1.0 - self.stochastic_depth_prob
                out = out * stochastic_depth_mask(out.shape[0], keep, generator, out.device).to(out.dtype) / keep
            out = out + x
        return out, proj_conv_out


class EfficientNetModel(nn.Module):
    """EfficientNet: stem → 7 stages → head conv → pool → classifier.

    ``forward`` returns ``(output, aux)``: the head's features ``[B, C, H,
    W]`` without a classifier, else logits; ``aux["intermediates"]`` holds
    the reference wrapper's taps (raw conv outputs), ``aux["pooled"]`` the
    pooled features. ``channels_last`` keeps activations in NHWC memory on
    the card (the layout JAX's convolutions use; ``PERF.md`` has both
    layouts' times).
    """

    def __init__(self, variant: str = "b0", num_classes: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 bn_eps: float = 1e-5, tf_same_padding: bool = False) -> None:
        super().__init__()
        self.variant, self.num_classes, self.dtype = variant, num_classes, dtype
        self.channels_last = True
        width = VARIANTS[variant][0]
        common = dict(bn_eps=bn_eps, tf_same=tf_same_padding)
        stages = stage_config(variant)
        stem = _round_channels(32, width)
        features: List[nn.Module] = [_ConvBN(3, stem, 3, 2, **common)]
        total = sum(n for (_t, _c, n, _s, _k) in stages)
        self.taps: List[Optional[str]] = []
        idx, cin = 0, stem
        for stage_i, (t, c, n, s, k) in enumerate(stages, start=1):
            blocks = []
            for j in range(n):
                blocks.append(_MBConv(cin, c, t, s if j == 0 else 1, k, _STOCHASTIC_DEPTH * idx / max(total, 1),
                                      **common))
                # torchvision's projection is block.3.0 with an expand stage,
                # block.2.0 without; the reference tracks only block.3.0.
                self.taps.append(f"model.features.{stage_i}.{j}.block.3.0" if t != 1 else None)
                cin, idx = c, idx + 1
            features.append(nn.Sequential(*blocks))
        features.append(_ConvBN(cin, _round_channels(1280, width), 1, **common))
        self.features = nn.Sequential(*features)
        if num_classes is not None:
            self.classifier = nn.Sequential(nn.Dropout(VARIANTS[variant][2]),
                                            nn.Linear(_round_channels(1280, width), num_classes))

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``x``: ``[B, 3, F, T]`` or ``[B, F, T]`` (repeated to 3 channels).
        ``padding_mask`` is accepted for the common contract and not used, as
        in JAX. In training mode BatchNorm takes the batch's statistics and
        updates its running ones; ``deterministic=False`` turns on stochastic
        depth and the classifier's dropout, drawn from ``generator``."""
        dt = self.dtype
        if x.ndim == 3:
            x = x[:, None].expand(-1, 3, -1, -1)
        x = x.to(dt)
        if self.channels_last and x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        intermediates: Dict[str, torch.Tensor] = {}
        x, conv_out = self.features[0](x, dt)
        intermediates["model.features.0.0"] = conv_out
        taps = iter(self.taps)
        for stage in self.features[1:-1]:
            for block in stage:
                x, proj_out = block(x, dt, deterministic, generator)
                name = next(taps)
                if name is not None:
                    intermediates[name] = proj_out
        x, conv_out = self.features[-1](x, dt)
        intermediates["model.features.8.0"] = conv_out
        pooled = x.mean(dim=(2, 3))
        aux: Dict[str, Any] = {"intermediates": intermediates, "features": x, "pooled": pooled}
        if self.num_classes is None:
            return x, aux
        h = dropout(pooled, VARIANTS[self.variant][2], deterministic, generator)
        return dense(self.classifier[1], h, dt), aux


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def _block_layout(expand_ratio: int) -> Tuple[Optional[int], int, int, int]:
    """torchvision indices of (expand, depthwise, SE, project) in ``block``."""
    return (0, 1, 2, 3) if expand_ratio != 1 else (None, 0, 1, 2)


def convert_efficientnet_state_dict(state: Mapping[str, Any], variant: str = "b0",
                                    num_classes: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A torchvision-style EfficientNet state dict (bare ``features...`` keys
    or the reference wrapper's ``model.features...``) → this port's state
    dict, as the JAX package's converter takes it: every conv, BatchNorm
    (with its running statistics) and SE weight of the variant's layout; the
    classifier only with ``num_classes``."""
    state = {(k[len("model."):] if k.startswith("model.") else k): v for k, v in state.items()}
    out: Dict[str, np.ndarray] = {}

    def take(key: str) -> None:
        if key in state:
            out[key] = np.asarray(state[key], dtype=np.float32)

    def convbn(prefix: str) -> None:
        if f"{prefix}.0.weight" not in state:
            return
        take(f"{prefix}.0.weight")
        for name in _BN_KEYS:
            take(f"{prefix}.1.{name}")

    convbn("features.0")
    for stage_i, (t, _c, n, _s, _k) in enumerate(stage_config(variant), start=1):
        for j in range(n):
            base = f"features.{stage_i}.{j}.block"
            expand, dw, se, proj = _block_layout(t)
            if expand is not None:
                convbn(f"{base}.{expand}")
            convbn(f"{base}.{dw}")
            for fc in ("fc1", "fc2"):
                if f"{base}.{se}.{fc}.weight" in state:
                    take(f"{base}.{se}.{fc}.weight")
                    take(f"{base}.{se}.{fc}.bias")
            convbn(f"{base}.{proj}")
    convbn("features.8")
    if num_classes is not None and "classifier.1.weight" in state:
        take("classifier.1.weight")
        take("classifier.1.bias")
    return out


def params_from_jax(variables: Mapping[str, Any], variant: str = "b0") -> Dict[str, np.ndarray]:
    """JAX ``EfficientNetModel`` variables (``{"params", "batch_stats"}``,
    nested dicts of numpy arrays) → this port's state dict: conv kernels HWIO
    → OIHW, BatchNorm ``scale`` → ``weight`` and ``mean``/``var`` →
    ``running_mean``/``running_var``, Dense ``[in, out]`` → Linear ``[out, in]``."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: Any) -> None:
        out[key] = np.asarray(value, dtype=np.float32)

    def conv(prefix: str, node: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in node:
            put(f"{prefix}.bias", node["bias"])

    def convbn(prefix: str, name: Tuple[str, ...]) -> None:
        p, s = params, stats
        for part in name:
            p, s = p[part], s.get(part, {})
        conv(f"{prefix}.0", p["conv"])
        put(f"{prefix}.1.weight", p["bn"]["scale"])
        put(f"{prefix}.1.bias", p["bn"]["bias"])
        if "bn" in s:
            put(f"{prefix}.1.running_mean", s["bn"]["mean"])
            put(f"{prefix}.1.running_var", s["bn"]["var"])

    convbn("features.0", ("features_0",))
    for stage_i, (t, _c, n, _s, _k) in enumerate(stage_config(variant), start=1):
        for j in range(n):
            name, base = f"features_{stage_i}_{j}", f"features.{stage_i}.{j}.block"
            expand, dw, se, proj = _block_layout(t)
            if expand is not None:
                convbn(f"{base}.{expand}", (name, "expand"))
            convbn(f"{base}.{dw}", (name, "dw"))
            conv(f"{base}.{se}.fc1", params[name]["se_fc1"])
            conv(f"{base}.{se}.fc2", params[name]["se_fc2"])
            convbn(f"{base}.{proj}", (name, "project"))
    convbn("features.8", ("features_8",))
    if "classifier" in params:
        put("classifier.1.weight", np.asarray(params["classifier"]["kernel"]).T)
        put("classifier.1.bias", params["classifier"]["bias"])
    return out


# ---------------------------------------------------------------------------
# Registered wrapper (architecture name: "efficientnet")
# ---------------------------------------------------------------------------


class Model(ModelBase):
    """EfficientNet wrapper registered as ``efficientnet``.

    The audio frontend runs ahead of the conv net; a bf16 trunk takes the
    ``"default"`` DFT precision (bf16-rounded operands), an fp32 one
    ``"highest"``, as in JAX. Weights are seeded random (``seed``) until a
    checkpoint is loaded.
    """

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = True,
        audio_config: Optional[Dict[str, Any]] = None,
        efficientnet_variant: str = "b0",
        return_features_only: bool = False,
        compute_dtype: str = "float32",
        seed: int = 0,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        if num_classes is None and not return_features_only:
            return_features_only = True
        self.variant = efficientnet_variant
        self.num_classes = None if return_features_only else num_classes
        dtype = torch_dtype(compute_dtype)
        if dtype == torch.bfloat16 and self.audio_processor is not None:
            self.audio_processor.precision = "default"
        self.module = build_module(
            lambda: EfficientNetModel(efficientnet_variant, self.num_classes, dtype), seed, self.device
        )

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            names = ["model.features.0.0"] + [name for name in self.module.taps if name is not None]
            self._layer_names = names + ["model.features.8.0"]

    def process_audio(self, x) -> torch.Tensor:
        """Spectrogram, then the 3-channel repeat ``[B, 3, F, T]``."""
        x = super().process_audio(x)
        return x[:, None].expand(-1, 3, -1, -1) if x.ndim == 3 else x

    def forward(self, x, padding_mask=None) -> torch.Tensor:
        """Waveform or spectrogram → logits (or features without a classifier)."""
        return super().forward(self.process_audio(x), None)

    def extract_fn(self, layers: Tuple[str, ...], aggregation: str):
        """Extraction with the frontend ahead of the conv net for a waveform ``[B, T]``."""
        inner = super().extract_fn(layers, aggregation)

        def extract(x: torch.Tensor, padding_mask: Optional[torch.Tensor]):
            return inner(self.process_audio(x) if x.ndim == 2 else x, None)

        return extract

    @staticmethod
    def _aggregate(emb: torch.Tensor, aggregation: str) -> torch.Tensor:
        """A 4-D conv map takes the conv-map aggregation; 2-D and 3-D the base's."""
        if emb.ndim == 4:
            return ModelBase._aggregate_conv_map(emb, aggregation)
        return ModelBase._aggregate(emb, aggregation)

    def load_state_dict(self, state: Mapping[str, Any], strict: bool = False) -> None:
        """Load a torchvision-style EfficientNet state dict."""
        self.load_port_state_dict(convert_efficientnet_state_dict(state, self.variant, self.num_classes),
                                  strict=strict)

    def enable_gradient_checkpointing(self) -> None:
        """A no-op, as in JAX: a recomputed train-mode BatchNorm would update
        its running statistics twice."""
