"""AVES / BirdAVES (HuBERT-base wav2vec2) in PyTorch.

Port of ``avex_tpu/models/aves.py``, in the torchaudio wav2vec2 layout of the
published ``*.torchaudio.pt`` checkpoints:

- a 7-layer strided Conv1d feature extractor without biases (group_norm
  mode: a per-channel GroupNorm after conv 0 only), a 320-sample hop, so
  50 frames a second;
- LayerNorm + Linear feature projection (512 → 768);
- a grouped conv positional embedding (K=128, 16 groups, weight norm folded
  at load), then the encoder LayerNorm;
- post-norm transformer layers (768-d, 12 heads, 3072 FFN). With
  ``use_pallas`` and heads the kernel takes, the q, k and v weights are
  concatenated into one ``[E, 3E]`` product and the CUDA kernel K5
  (``fused_qkv_attention``) runs over it with the frame mask; otherwise
  plain ``dot_product_attention`` with the mask as a ``-inf`` bias.

``forward`` returns the last layer's features; the embedding taps are
``model.encoder.transformer.layers.{i}.feed_forward.output_dense``. Module
names follow torchaudio's, so :func:`convert_aves_state_dict` only strips a
wrapper prefix and folds the weight norm. Inference only: dropout and
LayerDrop never run; ``scan_layers`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.beats import downsample_padding_mask
from avex_tpu_torch.models.common import (
    build_module,
    config_from_dict,
    conv_positions,
    dense,
    fold_weight_norm,
    gelu,
    group_norm,
    layer_norm,
    torch_dtype,
)
from avex_tpu_torch.ops._precision import full_fp32
from avex_tpu_torch.ops.attention import dot_product_attention
from avex_tpu_torch.ops.attention_kernels import fused_qkv_attention, fused_qkv_compatible

logger = logging.getLogger(__name__)

__all__ = ["AVESConfig", "AVESModel", "Model", "convert_aves_state_dict", "params_from_jax"]

#: (out_channels, kernel, stride) — HuBERT-base conv feature extractor.
CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 3, 2),
    (512, 2, 2),
    (512, 2, 2),
)


@dataclass
class AVESConfig:
    """HuBERT-base hyper-parameters the inference path reads. Other keys of
    an ``aves_cfg`` (the reference's dropout and LayerDrop rates, which
    inference never applies) are kept in :attr:`extra`, as the JAX class
    keeps any attribute."""

    encoder_embed_dim: int = 768
    encoder_pos_conv_kernel: int = 128
    encoder_pos_conv_groups: int = 16
    encoder_num_layers: int = 12
    encoder_num_heads: int = 12
    encoder_ff_interm_features: int = 3072
    encoder_layer_norm_first: bool = False
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, values: Optional[Mapping[str, Any]] = None) -> "AVESConfig":
        """Build from an ``aves_cfg`` dict; unknown keys go to :attr:`extra`."""
        return config_from_dict(cls, values)


class _ConvBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, norm: bool) -> None:
        super().__init__()
        self.conv = nn.Conv1d(in_ch, out_ch, kernel, stride=stride, bias=False)
        if norm:
            self.layer_norm = nn.GroupNorm(out_ch, out_ch, eps=1e-5)


class _FeatureExtractor(nn.Module):
    """Strided Conv1d stack (group_norm mode: GroupNorm after conv 0 only)."""

    def __init__(self, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        chans = [1] + [c for c, _, _ in CONV_LAYERS]
        self.conv_layers = nn.ModuleList(
            _ConvBlock(chans[i], ch, k, s, norm=i == 0) for i, (ch, k, s) in enumerate(CONV_LAYERS)
        )

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """``[B, samples]`` fp32 → ``[B, frames, 512]`` in the compute dtype."""
        dt = self.dtype
        x = wav[:, None, :]
        with full_fp32():  # fp32 convolutions in full fp32, never TF32
            for block in self.conv_layers:
                x = F.conv1d(x.to(dt), block.conv.weight.to(dt), stride=block.conv.stride)
                if hasattr(block, "layer_norm"):
                    x = group_norm(block.layer_norm, x, dt)
                x = gelu(x)
        return x.transpose(1, 2)


class _SelfAttention(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)


class _FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.intermediate_dense = nn.Linear(dim, hidden)
        self.output_dense = nn.Linear(hidden, dim)


class _EncoderLayer(nn.Module):
    """Post-norm wav2vec2 transformer layer; returns ``(x, output_dense out)``."""

    def __init__(self, cfg: AVESConfig, dtype: torch.dtype, use_pallas: bool) -> None:
        super().__init__()
        dim = cfg.encoder_embed_dim
        self.heads, self.dtype, self.use_pallas = cfg.encoder_num_heads, dtype, use_pallas
        self.attention = _SelfAttention(dim)
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.feed_forward = _FeedForward(dim, cfg.encoder_ff_interm_features)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        bsz, seq, dim = x.shape
        dt, heads, att = self.dtype, self.heads, self.attention
        head_dim = dim // heads
        if self.use_pallas and fused_qkv_compatible(dim, heads):
            # One [E, 3E] product, q|k|v heads-major, then K5 over its columns.
            w = torch.cat([att.q_proj.weight, att.k_proj.weight, att.v_proj.weight]).to(dt)
            b = torch.cat([att.q_proj.bias, att.k_proj.bias, att.v_proj.bias]).to(dt)
            qkv = F.linear(x.to(dt), w, b)
            attn = fused_qkv_attention(qkv, heads, key_padding_mask=padding_mask, scale=head_dim**-0.5)
        else:
            q, k, v = (
                dense(proj, x, dt).view(bsz, seq, heads, head_dim).transpose(1, 2)
                for proj in (att.q_proj, att.k_proj, att.v_proj)
            )
            bias = None
            if padding_mask is not None:
                bias = torch.zeros(padding_mask.shape, dtype=torch.float32, device=x.device)
                bias = bias.masked_fill(padding_mask, float("-inf"))[:, None, None, :]
            # bf16 compute runs the softmax chain in bf16 too, as in JAX.
            attn = dot_product_attention(q, k, v, bias=bias, scale=head_dim**-0.5, logits_dtype=dt)
            attn = attn.transpose(1, 2).reshape(bsz, seq, dim)
        x = layer_norm(self.layer_norm, x + dense(att.out_proj, attn, dt), dt)
        ff = self.feed_forward
        ff_out = dense(ff.output_dense, gelu(dense(ff.intermediate_dense, x, dt)), dt)
        return layer_norm(self.final_layer_norm, x + ff_out, dt), ff_out


class _FeatureProjection(nn.Module):
    def __init__(self, in_dim: int, dim: int) -> None:
        super().__init__()
        self.layer_norm = nn.LayerNorm(in_dim, eps=1e-5)
        self.projection = nn.Linear(in_dim, dim)


class _PosConvEmbed(nn.Module):
    def __init__(self, dim: int, kernel: int, groups: int) -> None:
        super().__init__()
        # Weight norm is folded at load time: a plain grouped conv weight.
        self.conv = nn.Conv1d(dim, dim, kernel, padding=kernel // 2, groups=groups)


class _Transformer(nn.Module):
    def __init__(self, cfg: AVESConfig, dtype: torch.dtype, use_pallas: bool) -> None:
        super().__init__()
        dim = cfg.encoder_embed_dim
        self.pos_conv_embed = _PosConvEmbed(dim, cfg.encoder_pos_conv_kernel, cfg.encoder_pos_conv_groups)
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.layers = nn.ModuleList(_EncoderLayer(cfg, dtype, use_pallas) for _ in range(cfg.encoder_num_layers))


class _Encoder(nn.Module):
    def __init__(self, cfg: AVESConfig, dtype: torch.dtype, use_pallas: bool) -> None:
        super().__init__()
        self.feature_projection = _FeatureProjection(CONV_LAYERS[-1][0], cfg.encoder_embed_dim)
        self.transformer = _Transformer(cfg, dtype, use_pallas)


class AVESModel(nn.Module):
    """Full AVES backbone; ``forward`` returns ``(last_layer_features, aux)``,
    or ``(logits, aux)`` with a classifier over the masked mean of the frames."""

    def __init__(
        self,
        cfg: AVESConfig,
        num_classes: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        scan_layers: bool = False,
    ) -> None:
        super().__init__()
        if scan_layers:
            raise NotImplementedError("AVES scan_layers is not ported to PyTorch yet (ROADMAP queue 1, item 10)")
        self.cfg, self.num_classes, self.dtype = cfg, num_classes, dtype
        self.feature_extractor = _FeatureExtractor(dtype)
        self.encoder = _Encoder(cfg, dtype, use_pallas)
        if num_classes is not None:
            self.classifier = nn.Linear(cfg.encoder_embed_dim, num_classes)

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cfg, dt = self.cfg, self.dtype
        feats = self.feature_extractor(x.float())
        # A frame is padded only when every sample it pools is.
        frame_mask = downsample_padding_mask(padding_mask, feats.shape[1]) if padding_mask is not None else None

        proj = self.encoder.feature_projection
        h = dense(proj.projection, layer_norm(proj.layer_norm, feats, dt), dt)
        if frame_mask is not None:
            h = h.masked_fill(frame_mask[:, :, None], 0.0)
        tr = self.encoder.transformer
        h = h + gelu(conv_positions(tr.pos_conv_embed.conv, h, dt))
        if not cfg.encoder_layer_norm_first:
            # fairseq post-norm: the encoder LayerNorm sits right after the
            # positional conv, before the layer stack.
            h = layer_norm(tr.layer_norm, h, dt)

        intermediates: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(tr.layers):
            h, ff_out = layer(h, frame_mask)
            intermediates[f"model.encoder.transformer.layers.{i}.feed_forward.output_dense"] = ff_out

        aux: Dict[str, Any] = {"intermediates": intermediates, "padding_mask": frame_mask, "features": h}
        if self.num_classes is None:
            return h, aux
        if frame_mask is not None:
            denom = (~frame_mask).sum(dim=1, keepdim=True).clamp_min(1)
            pooled = h.masked_fill(frame_mask[:, :, None], 0.0).sum(dim=1) / denom
        else:
            pooled = h.mean(dim=1)
        aux["pooled"] = pooled
        return dense(self.classifier, pooled, dt), aux


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------


def convert_aves_state_dict(
    state: Mapping[str, np.ndarray], num_classes: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """torchaudio wav2vec2 state dict (optionally behind the wrapper's
    ``model.`` prefix) → this port's :class:`AVESModel` state dict.

    The weight-normed pos_conv is folded from ``parametrizations.weight.
    original0/1`` or ``weight_g/weight_v``; the classifier is kept only with
    ``num_classes``.
    """
    state = {(k[len("model."):] if k.startswith("model.") else k): np.asarray(v) for k, v in state.items()}
    for key in [k for k in state if "pos_conv" in k and k.endswith((".original0", ".weight_g"))]:
        if key.endswith(".original0"):
            prefix = key[: -len(".parametrizations.weight.original0")]
            g, v = state.pop(key), state.pop(f"{prefix}.parametrizations.weight.original1")
        else:
            prefix = key[: -len(".weight_g")]
            g, v = state.pop(key), state.pop(f"{prefix}.weight_v")
        state[f"{prefix}.weight"] = fold_weight_norm(g, v)
    if num_classes is None:
        state = {k: v for k, v in state.items() if not k.startswith("classifier.")}
    return {k: np.asarray(v, dtype=np.float32) for k, v in state.items()}


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``AVESModel`` ``variables["params"]`` (nested dicts of numpy
    arrays) → this port's :class:`AVESModel` state dict.

    Dense ``[in, out]`` → Linear ``[out, in]``; Conv ``[K, in/g, out]`` →
    ``[out, in/g, K]``; LayerNorm / GroupNorm ``scale`` → ``weight``.
    """
    if "layers" in params:
        raise NotImplementedError("scan_layers (stacked) JAX params are not ported (ROADMAP queue 1, item 10)")
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: Any) -> None:
        out[key] = np.asarray(value, dtype=np.float32)

    def dense_(prefix: str, node: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", np.asarray(node["kernel"]).T)
        put(f"{prefix}.bias", node["bias"])

    def norm_(prefix: str, node: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", node["scale"])
        put(f"{prefix}.bias", node["bias"])

    fe = params["feature_extractor"]
    for i in range(len(CONV_LAYERS)):
        put(f"feature_extractor.conv_layers.{i}.conv.weight", np.asarray(fe[f"conv_{i}"]["kernel"]).transpose(2, 1, 0))
    norm_("feature_extractor.conv_layers.0.layer_norm", fe["group_norm"])
    norm_("encoder.feature_projection.layer_norm", params["fp_layer_norm"])
    dense_("encoder.feature_projection.projection", params["fp_projection"])
    put("encoder.transformer.pos_conv_embed.conv.weight", np.asarray(params["pos_conv"]["kernel"]).transpose(2, 1, 0))
    put("encoder.transformer.pos_conv_embed.conv.bias", params["pos_conv"]["bias"])
    norm_("encoder.transformer.layer_norm", params["encoder_layer_norm"])
    for name, node in params.items():
        if not name.startswith("layers_"):
            continue
        base = f"encoder.transformer.layers.{name.split('_', 1)[1]}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            dense_(f"{base}.attention.{proj}", node[proj])
        norm_(f"{base}.layer_norm", node["layer_norm"])
        dense_(f"{base}.feed_forward.intermediate_dense", node["intermediate_dense"])
        dense_(f"{base}.feed_forward.output_dense", node["output_dense"])
        norm_(f"{base}.final_layer_norm", node["final_layer_norm"])
    if "classifier" in params:
        dense_("classifier", params["classifier"])
    return out


# ---------------------------------------------------------------------------
# Registered wrapper (architecture name: "aves_bio")
# ---------------------------------------------------------------------------


class Model(ModelBase):
    """AVES wrapper registered as ``aves_bio``.

    ``use_pallas=True`` runs the CUDA attention kernel K5; None (the default)
    and False the plain path (JAX's auto-enable at T >= 248 was measured on a
    TPU). Weights are seeded random (``seed``) until a checkpoint is loaded;
    the port never fetches weights.
    """

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = False,
        audio_config: Optional[Dict[str, Any]] = None,
        return_features_only: bool = False,
        compute_dtype: str = "float32",
        use_pallas: Optional[bool] = None,
        scan_layers: bool = False,
        aves_cfg: Optional[Dict[str, Any]] = None,
        seed: int = 0,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        self.config = AVESConfig.from_dict(aves_cfg)
        self.num_classes = None if return_features_only else num_classes
        dtype = torch_dtype(compute_dtype)
        self.module = build_module(
            lambda: AVESModel(
                self.config, num_classes=self.num_classes, dtype=dtype,
                use_pallas=bool(use_pallas), scan_layers=scan_layers,
            ),
            seed, self.device,
        )
        if pretrained:
            logger.warning(
                "AVES weights are not fetched by the PyTorch port; keeping the seeded "
                "random init (pass a checkpoint to load_model)"
            )

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            self._layer_names = [
                f"model.encoder.transformer.layers.{i}.feed_forward.output_dense"
                for i in range(self.config.encoder_num_layers)
            ]

    def load_state_dict(self, state: Mapping[str, np.ndarray], strict: bool = False) -> None:
        """Load a torchaudio-style AVES/HuBERT state dict (prefix-tolerant)."""
        self.load_port_state_dict(convert_aves_state_dict(state, self.num_classes), strict=strict)
