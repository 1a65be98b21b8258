"""BEATs (Bidirectional Encoder representation from Audio Transformers) in PyTorch.

Port of ``avex_tpu/models/beats.py``:

- the Kaldi frontend is always fp32 (``avex_tpu_torch.ops.fbank``);
- the patch embedding (stride = kernel = 16) is a reshape into 16x16 patches
  and one matmul, keeping the Conv2d weight layout ``[512, 1, 16, 16]``;
  time patches are the major axis of the flattened tokens;
- the encoder works in ``[B, T, C]``; one shared T5 bucket table
  (``encoder.relative_attention_bias``) gives the ``[1, H, T, T]`` bias once per
  forward, and each layer's GRU gate modulates it;
- with ``use_pallas=True`` the attention runs the CUDA kernel of
  ``avex_tpu_torch.ops.attention_kernels`` (split q/k/v, or the fused
  ``[B, T, 3E]`` projection when ``fused_qkv`` is set and the heads fit);
  otherwise plain ``dot_product_attention`` with the ``fast_attention``
  logits policy, as in the JAX package;
- intermediates are functional outputs: ``forward`` returns ``(output, aux)``
  with ``aux["intermediates"]`` under the reference names
  (``backbone.post_extract_proj``, ``backbone.encoder.layers.{i}.fc2``);
- with ``quantize_encoder`` (or after :meth:`Model.quantize`) the encoder's
  q/k/v/out projections and fc1/fc2 are ``Int8Linear`` layers under the same
  names (W8A8, the K7 kernel on CUDA); the attention is unchanged.

The port is inference-only for now: dropout and LayerDrop belong to
training (ROADMAP queue 1, item 10) and never run, as in the JAX wrapper,
which always applies the model deterministically.

With ``compute_dtype="bfloat16"`` parameters stay fp32 and matmul inputs are
cast to bf16 (flax ``dtype=bf16``); LayerNorm statistics are fp32 with a bf16
output; the gate's sigmoid and the position bias are fp32.

Module and parameter names follow the reference torch checkpoint, so
:func:`convert_beats_state_dict` is key renaming plus the weight-norm fold,
the rel-bias alias and the optional qkv concatenation. :func:`params_from_jax`
carries a JAX ``variables["params"]`` tree (as numpy) across.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import (
    build_module,
    config_from_dict,
    conv_positions,
    dense,
    fold_weight_norm,
    gelu,
    layer_norm,
    torch_dtype,
)
from avex_tpu_torch.ops.attention import dot_product_attention, grad_multiply, relative_position_bucket
from avex_tpu_torch.ops.attention_kernels import (
    fused_qkv_compatible,
    fused_qkv_gated_attention,
    gated_bias_attention,
)
from avex_tpu_torch.ops.fbank import KaldiFbank, beats_fbank
from avex_tpu_torch.quant import Int8Linear, quantize_params

logger = logging.getLogger(__name__)

__all__ = [
    "ENCODER_QUANT_DENSES",
    "BEATsBackbone",
    "BEATsConfig",
    "BEATsModel",
    "Model",
    "convert_beats_state_dict",
    "downsample_padding_mask",
    "params_from_jax",
    "quantize_beats_params",
]

_NOT_PORTED = ("scan_layers", "remat")


@dataclass
class BEATsConfig:
    """BEATs architecture hyper-parameters (defaults: the iter3+AS2M SSL variant).

    The keys the JAX code reads through ``getattr`` are explicit fields;
    unknown keys of an ``init_config`` are kept in :attr:`extra`.
    """

    input_patch_size: int = 16
    embed_dim: int = 512
    conv_bias: bool = False

    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    activation_fn: str = "gelu"

    layer_wise_gradient_decay_ratio: float = 1.0
    layer_norm_first: bool = False
    deep_norm: bool = True

    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    encoder_layerdrop: float = 0.05
    dropout_input: float = 0.0

    conv_pos: int = 128
    conv_pos_groups: int = 16

    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True

    sample_frequency: float = 16000.0
    num_mel_bins: int = 128
    frame_length: float = 25.0
    frame_shift: float = 10.0
    fbank_mean: float = 15.41663
    fbank_std: float = 6.55582

    finetuned_model: bool = False
    predictor_dropout: float = 0.0
    predictor_class: int = 527

    # avex-tpu execution knobs
    use_pallas: Optional[bool] = None
    fast_attention: Optional[bool] = None
    fused_qkv: bool = False
    scan_layers: bool = False
    remat: bool = False
    quantize_encoder: bool = False

    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, values: Optional[Mapping[str, Any]] = None) -> "BEATsConfig":
        """Build from an ``init_config`` dict; unknown keys go to :attr:`extra`."""
        return config_from_dict(cls, values)

    def check_supported(self) -> None:
        """Raise for the JAX package's options this port does not have yet."""
        for name in _NOT_PORTED:
            if getattr(self, name):
                raise NotImplementedError(
                    f"BEATsConfig.{name}=True is not ported to PyTorch yet (ROADMAP queue 1)"
                )
        if self.activation_fn != "gelu":
            raise NotImplementedError(f"activation_fn {self.activation_fn!r} (only 'gelu')")


def downsample_padding_mask(padding_mask: torch.Tensor, target_len: int) -> torch.Tensor:
    """All-pool a bool padding mask down to ``target_len`` positions: trim the
    remainder and mark a position padded only when every pooled element is."""
    bsz, n = padding_mask.shape
    extra = n % target_len
    if extra:
        padding_mask = padding_mask[:, :-extra]
    return padding_mask.reshape(bsz, target_len, -1).all(dim=-1)


def _projection(cfg: BEATsConfig, dtype: torch.dtype, n_in: int, n_out: int) -> nn.Module:
    """An encoder dense layer: ``Int8Linear`` when the encoder is quantized."""
    if cfg.quantize_encoder:
        return Int8Linear(n_in, n_out, dtype=dtype)
    return nn.Linear(n_in, n_out)


class _GatedRelPosAttention(nn.Module):
    """Self-attention with a GRU-gated T5 relative position bias.

    The shared bias ``[1, H, T, T]`` comes from the encoder; the gate, a
    function of this layer's raw q, modulates it per query.
    """

    def __init__(self, cfg: BEATsConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.embed_dim = cfg.encoder_embed_dim
        self.num_heads = cfg.encoder_attention_heads
        self.head_dim = self.embed_dim // self.num_heads
        self.gru_rel_pos = cfg.gru_rel_pos
        self.use_pallas = cfg.use_pallas
        self.fast_attention = cfg.fast_attention
        # A quantized encoder keeps split int8 q/k/v, as JAX's Int8Dense path.
        self.fused_qkv = cfg.fused_qkv and not cfg.quantize_encoder
        self.dtype = dtype
        e = self.embed_dim
        if self.fused_qkv:
            self.qkv_proj = nn.Linear(e, 3 * e)
        else:
            self.q_proj = _projection(cfg, dtype, e, e)
            self.k_proj = _projection(cfg, dtype, e, e)
            self.v_proj = _projection(cfg, dtype, e, e)
        self.out_proj = _projection(cfg, dtype, e, e)
        if self.gru_rel_pos and cfg.relative_position_embedding:
            self.grep_linear = nn.Linear(self.head_dim, 8)
            self.grep_a = nn.Parameter(torch.ones(1, self.num_heads, 1, 1))

    def _gate(self, q_heads: torch.Tensor, layout: str) -> torch.Tensor:
        """GRU gate ``[B, H, T]`` (fp32) from q in ``[B, H, T, dh]`` ("split")
        or ``[B, T, H, dh]`` ("fused") layout."""
        gates = dense(self.grep_linear, q_heads, self.dtype)
        gates = gates.unflatten(-1, (2, 4)).sum(-1).float().sigmoid()
        if layout == "fused":
            gates = gates.transpose(1, 2)  # [B, H, T, 2]
        gate_a, gate_b = gates[..., 0], gates[..., 1]
        return gate_a * (gate_b * self.grep_a[..., 0] - 1.0) + 2.0

    def forward(
        self,
        x: torch.Tensor,
        position_bias: Optional[torch.Tensor],
        key_padding_mask: Optional[torch.Tensor],
    ) -> torch.Tensor:
        bsz, seq, _ = x.shape
        heads, dh, e = self.num_heads, self.head_dim, self.embed_dim
        use_pallas = bool(self.use_pallas)
        has_gate = position_bias is not None and self.gru_rel_pos

        if self.fused_qkv:
            qkv = dense(self.qkv_proj, x, self.dtype)  # [B, T, 3E]
            if use_pallas and position_bias is not None and fused_qkv_compatible(e, heads):
                gate = self._gate(qkv[..., :e].unflatten(-1, (heads, dh)), "fused") if has_gate else None
                out = fused_qkv_gated_attention(
                    qkv, heads, position_bias[0], gate, key_padding_mask, scale=dh**-0.5
                )
                return dense(self.out_proj, out, self.dtype)
            q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, dh).unbind(2))
        else:
            q, k, v = (
                dense(proj, x, self.dtype).view(bsz, seq, heads, dh).permute(0, 2, 1, 3)
                for proj in (self.q_proj, self.k_proj, self.v_proj)
            )

        gate = self._gate(q, "split") if has_gate else None
        if use_pallas and position_bias is not None:
            out = gated_bias_attention(
                q, k, v, position_bias[0], gate, key_padding_mask, scale=dh**-0.5
            )
        else:
            bias = None
            if position_bias is not None:
                bias = gate[..., None] * position_bias if gate is not None else position_bias
            if key_padding_mask is not None:
                pad = torch.zeros(key_padding_mask.shape, dtype=torch.float32, device=x.device)
                pad = pad.masked_fill(key_padding_mask, float("-inf"))[:, None, None, :]
                bias = pad if bias is None else bias + pad
            fast = self.fast_attention
            if fast is None:  # auto: reduced-precision softmax iff bf16 compute
                fast = self.dtype == torch.bfloat16
            logits_dtype = self.dtype if fast else torch.float32
            out = dot_product_attention(q, k, v, bias=bias, scale=dh**-0.5, logits_dtype=logits_dtype)
        out = out.transpose(1, 2).reshape(bsz, seq, e)
        return dense(self.out_proj, out, self.dtype)


class _EncoderLayer(nn.Module):
    """One BEATs block: gated-bias attention + FFN with DeepNorm residuals.

    Returns ``(x, fc2_out)``; ``fc2_out`` is the tensor the reference captures
    with its fc2 forward hook.
    """

    def __init__(self, cfg: BEATsConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.alpha = math.pow(2 * cfg.encoder_layers, 0.25) if cfg.deep_norm else 1.0
        e = cfg.encoder_embed_dim
        self.self_attn = _GatedRelPosAttention(cfg, dtype)
        self.self_attn_layer_norm = nn.LayerNorm(e, eps=1e-5)
        self.fc1 = _projection(cfg, dtype, e, cfg.encoder_ffn_embed_dim)
        self.fc2 = _projection(cfg, dtype, cfg.encoder_ffn_embed_dim, e)
        self.final_layer_norm = nn.LayerNorm(e, eps=1e-5)

    def forward(
        self,
        x: torch.Tensor,
        position_bias: Optional[torch.Tensor],
        key_padding_mask: Optional[torch.Tensor],
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, dt = self.cfg, self.dtype
        if cfg.layer_norm_first:
            residual = x
            h = self.self_attn(layer_norm(self.self_attn_layer_norm, x, dt), position_bias, key_padding_mask)
            x = residual + h
            residual = x
            h = gelu(dense(self.fc1, layer_norm(self.final_layer_norm, x, dt), dt))
            fc2_out = dense(self.fc2, h, dt)
            x = residual + fc2_out
        else:
            h = self.self_attn(x, position_bias, key_padding_mask)
            x = x * self.alpha + h
            x = layer_norm(self.self_attn_layer_norm, x, dt)
            residual = x
            fc2_out = dense(self.fc2, gelu(dense(self.fc1, x, dt)), dt)
            x = residual * self.alpha + fc2_out
            x = layer_norm(self.final_layer_norm, x, dt)
        return x, fc2_out


class _TransformerEncoder(nn.Module):
    """Conv positional embedding + N gated-bias layers, one shared rel-pos table."""

    def __init__(self, cfg: BEATsConfig, dtype: torch.dtype) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        e = cfg.encoder_embed_dim
        # Weight norm is folded at load time: a plain grouped conv weight.
        self.pos_conv = nn.Conv1d(e, e, cfg.conv_pos, padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
        self.layer_norm = nn.LayerNorm(e, eps=1e-5)
        if cfg.relative_position_embedding:
            self.relative_attention_bias = nn.Embedding(cfg.num_buckets, cfg.encoder_attention_heads)
        self.layers = nn.ModuleList(_EncoderLayer(cfg, dtype) for _ in range(cfg.encoder_layers))
        self._buckets: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def position_bias(self, seq: int, device: torch.device) -> torch.Tensor:
        """The shared ``[1, H, T, T]`` fp32 bias, contiguous."""
        cfg = self.cfg
        buckets = self._buckets.get((seq, device))
        if buckets is None:
            matrix = relative_position_bucket(seq, seq, cfg.num_buckets, cfg.max_distance)
            buckets = torch.tensor(matrix, device=device)
            self._buckets[(seq, device)] = buckets
        table = self.relative_attention_bias.weight.float()
        return table[buckets].permute(2, 0, 1).contiguous()[None]

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg, dt = self.cfg, self.dtype
        seq = x.shape[1]
        if padding_mask is not None:
            x = x.masked_fill(padding_mask[:, :, None], 0.0)

        x = x + gelu(conv_positions(self.pos_conv, x, dt))

        if not cfg.layer_norm_first:
            x = layer_norm(self.layer_norm, x, dt)

        position_bias = self.position_bias(seq, x.device) if cfg.relative_position_embedding else None

        intermediates: Dict[str, torch.Tensor] = {}
        for i, layer in enumerate(self.layers):
            if cfg.layer_wise_gradient_decay_ratio != 1.0:
                x = grad_multiply(x, cfg.layer_wise_gradient_decay_ratio)
            x, fc2_out = layer(x, position_bias, padding_mask)
            intermediates[f"encoder.layers.{i}.fc2"] = fc2_out

        if cfg.layer_norm_first:
            x = layer_norm(self.layer_norm, x, dt)
        return x, intermediates


class BEATsBackbone(nn.Module):
    """Fbank frontend → patch embed → encoder (``extract_features``).

    ``apply_predictor=True`` runs the fine-tuned AudioSet head with
    masked-mean logits pooling.
    """

    def __init__(self, cfg: BEATsConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        p = cfg.input_patch_size
        self.fbank = KaldiFbank(
            num_mel_bins=cfg.num_mel_bins,
            sample_frequency=cfg.sample_frequency,
            frame_length_ms=cfg.frame_length,
            frame_shift_ms=cfg.frame_shift,
        )
        self.patch_embedding = nn.Conv2d(1, cfg.embed_dim, p, stride=p, bias=cfg.conv_bias)
        self.layer_norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        if cfg.embed_dim != cfg.encoder_embed_dim:
            self.post_extract_proj = nn.Linear(cfg.embed_dim, cfg.encoder_embed_dim)
        self.encoder = _TransformerEncoder(cfg, dtype)
        if cfg.finetuned_model:
            self.predictor = nn.Linear(cfg.encoder_embed_dim, cfg.predictor_class)

    def _patch_embed(self, feats: torch.Tensor) -> torch.Tensor:
        """``[B, F, M]`` → ``[B, (F/p)·(M/p), embed_dim]``, time patches major.

        Stride equals kernel, so the conv is a reshape into p x p patches and
        one matmul with the ``[out, 1, p, p]`` weight flattened.
        """
        p = self.cfg.input_patch_size
        bsz, frames, mels = feats.shape
        tp, fp = frames // p, mels // p
        patches = (
            feats[:, : tp * p, : fp * p]
            .reshape(bsz, tp, p, fp, p)
            .permute(0, 1, 3, 2, 4)
            .reshape(bsz, tp * fp, p * p)
        )
        conv = self.patch_embedding
        weight = conv.weight.reshape(conv.out_channels, p * p).to(self.dtype)
        bias = conv.bias.to(self.dtype) if conv.bias is not None else None
        return F.linear(patches.to(self.dtype), weight, bias)

    def forward(
        self,
        source: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,
        apply_predictor: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        cfg, dt = self.cfg, self.dtype
        feats = beats_fbank(source, cfg.fbank_mean, cfg.fbank_std, fbank=self.fbank)  # fp32
        if padding_mask is not None:
            padding_mask = downsample_padding_mask(padding_mask, feats.shape[1])

        x = layer_norm(self.layer_norm, self._patch_embed(feats), dt)
        if padding_mask is not None:
            padding_mask = downsample_padding_mask(padding_mask, x.shape[1])
        if cfg.embed_dim != cfg.encoder_embed_dim:
            x = dense(self.post_extract_proj, x, dt)
        intermediates = {"post_extract_proj": x}

        x, enc_inter = self.encoder(x, padding_mask=padding_mask)
        intermediates.update(enc_inter)
        aux: Dict[str, Any] = {"intermediates": intermediates, "padding_mask": padding_mask}

        if apply_predictor and cfg.finetuned_model:
            logits = dense(self.predictor, x, dt)
            if padding_mask is not None:
                logits = logits.masked_fill(padding_mask[:, :, None], 0.0)
                denom = (~padding_mask).sum(dim=1, keepdim=True).clamp_min(1)
                return logits.sum(dim=1) / denom, aux
            return logits.mean(dim=1), aux
        return x, aux


class BEATsModel(nn.Module):
    """Backbone features → masked mean pool → optional classifier.

    ``num_classes=None`` returns frame-level features. ``use_naturelm`` clamps
    the waveform to [-1, 1] first. Intermediates carry the ``backbone.`` prefix.
    """

    def __init__(
        self,
        cfg: BEATsConfig,
        num_classes: Optional[int] = None,
        use_naturelm: bool = False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        cfg.check_supported()
        self.cfg = cfg
        self.num_classes = num_classes
        self.use_naturelm = use_naturelm
        self.dtype = dtype
        self.backbone = BEATsBackbone(cfg, dtype)
        if num_classes is not None:
            self.classifier = nn.Linear(cfg.encoder_embed_dim, num_classes)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        if self.use_naturelm:
            x = x.clamp(-1.0, 1.0)
        features, aux = self.backbone(x, padding_mask=padding_mask)
        aux["intermediates"] = {f"backbone.{k}": v for k, v in aux["intermediates"].items()}
        aux["features"] = features

        frame_mask = aux.get("padding_mask")
        if frame_mask is not None:
            masked = features.masked_fill(frame_mask[:, :, None], 0.0)
            denom = (~frame_mask).sum(dim=1, keepdim=True).clamp_min(1)
            pooled = masked.sum(dim=1) / denom
        else:
            pooled = features.mean(dim=1)
        aux["pooled"] = pooled

        if self.num_classes is None:
            return features, aux
        return dense(self.classifier, pooled, self.dtype), aux


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------


def _concat_qkv(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold ``{q,k,v}_proj`` into one ``qkv_proj`` (rows in q|k|v order)."""
    out = dict(state)
    for key in [k for k in state if k.endswith(".self_attn.q_proj.weight")]:
        base = key[: -len("q_proj.weight")]
        for which in ("weight", "bias"):
            parts = [out.pop(f"{base}{p}_proj.{which}") for p in ("q", "k", "v")]
            out[f"{base}qkv_proj.{which}"] = np.concatenate(parts, axis=0)
    return out


def convert_beats_state_dict(
    state: Mapping[str, np.ndarray],
    cfg: BEATsConfig,
    num_classes: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """Reference BEATs checkpoint → this port's :class:`BEATsModel` state dict.

    Accepts wrapper-level keys (``backbone.``, optional ``classifier.``) or a
    bare backbone. Weight-normed pos_conv parametrizations (``original0/1``
    or legacy ``weight_g/weight_v``) are folded; layer 0's relative-position
    table becomes the shared ``encoder.relative_attention_bias``; with
    ``cfg.fused_qkv`` the three projections are concatenated.
    """
    if not any(k.startswith("backbone.") for k in state):
        state = {f"backbone.{k}": v for k, v in state.items()}
    state = {k: np.asarray(v) for k, v in state.items()}

    pos_prefixes = set()
    for key in list(state):
        if "pos_conv" in key and ("original0" in key or "weight_g" in key):
            pos_prefixes.add(key.rsplit(".", 1)[0].replace(".parametrizations.weight", ""))
    for prefix in pos_prefixes:
        para = f"{prefix}.parametrizations.weight"
        if f"{para}.original0" in state:
            g, v = state.pop(f"{para}.original0"), state.pop(f"{para}.original1")
        else:
            g, v = state.pop(f"{prefix}.weight_g"), state.pop(f"{prefix}.weight_v")
        state[f"{prefix}.weight"] = fold_weight_norm(g, v)

    heads = cfg.encoder_attention_heads
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        parts = key.split(".")
        if parts[0] != "backbone":
            if parts[0] == "classifier" and num_classes is not None:
                out[key] = value
            continue
        name = ".".join(parts[1:])
        if name.startswith("fbank."):
            continue  # frontend constants are rebuilt analytically
        if name.startswith("encoder.pos_conv"):
            out["backbone.encoder.pos_conv." + parts[-1]] = value  # drops the Sequential's ".0"
        elif "relative_attention_bias" in name:
            # The reference aliases every layer to layer 0's table; keep one.
            if name == "encoder.relative_attention_bias.weight" or (
                "layers.0." in name and name.endswith("weight")
            ):
                out["backbone.encoder.relative_attention_bias.weight"] = value
        elif name.endswith("self_attn.grep_a"):
            out[key] = value.reshape(1, heads, 1, 1)
        else:
            out[key] = value

    if cfg.fused_qkv:
        out = _concat_qkv(out)
    return {k: np.asarray(v, dtype=np.float32) for k, v in out.items()}


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX BEATs ``variables["params"]`` (nested dicts of numpy arrays) → this
    port's :class:`BEATsModel` state dict.

    Dense ``[in, out]`` → Linear ``[out, in]``; the patch conv ``[kh, kw, 1,
    out]`` → ``[out, 1, kh, kw]``; the pos_conv ``[K, in/g, out]`` → ``[out,
    in/g, K]``; LayerNorm ``scale`` → ``weight``; ``grep_a`` stays
    ``[1, H, 1, 1]``; ``qkv_proj`` carries over as is. A tree that JAX
    quantized (``Int8Dense``: ``kernel_q`` int8 ``[in, out]``,
    ``kernel_scale``) gives ``weight_q`` int8 ``[out, in]`` and fp32
    ``weight_scale`` and ``bias``, for a model built with
    ``quantize_encoder=True``.
    """
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: Any) -> None:
        out[key] = np.asarray(value, dtype=np.float32)

    def dense(prefix: str, node: Mapping[str, Any]) -> None:
        if "kernel_q" in node:
            out[f"{prefix}.weight_q"] = np.ascontiguousarray(np.asarray(node["kernel_q"], dtype=np.int8).T)
            put(f"{prefix}.weight_scale", node["kernel_scale"])
        else:
            put(f"{prefix}.weight", np.asarray(node["kernel"]).T)
        if "bias" in node:
            put(f"{prefix}.bias", node["bias"])

    def norm(prefix: str, node: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", node["scale"])
        put(f"{prefix}.bias", node["bias"])

    bb = params["backbone"]
    put("backbone.patch_embedding.weight", np.asarray(bb["patch_embedding"]["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in bb["patch_embedding"]:
        put("backbone.patch_embedding.bias", bb["patch_embedding"]["bias"])
    norm("backbone.layer_norm", bb["layer_norm"])
    if "post_extract_proj" in bb:
        dense("backbone.post_extract_proj", bb["post_extract_proj"])
    if "predictor" in bb:
        dense("backbone.predictor", bb["predictor"])

    enc = bb["encoder"]
    if "layers" in enc:
        raise NotImplementedError("scan_layers (stacked) JAX params are not ported (ROADMAP queue 1)")
    put("backbone.encoder.pos_conv.weight", np.asarray(enc["pos_conv"]["kernel"]).transpose(2, 1, 0))
    put("backbone.encoder.pos_conv.bias", enc["pos_conv"]["bias"])
    norm("backbone.encoder.layer_norm", enc["layer_norm"])
    if "rel_attn_bias" in enc:
        put("backbone.encoder.relative_attention_bias.weight", enc["rel_attn_bias"]["embedding"])
    for name, layer in enc.items():
        if not name.startswith("layers_"):
            continue
        prefix = f"backbone.encoder.layers.{name.split('_', 1)[1]}"
        for sub, node in layer["self_attn"].items():
            if sub == "grep_a":
                put(f"{prefix}.self_attn.grep_a", node)
            else:
                dense(f"{prefix}.self_attn.{sub}", node)
        dense(f"{prefix}.fc1", layer["fc1"])
        dense(f"{prefix}.fc2", layer["fc2"])
        norm(f"{prefix}.self_attn_layer_norm", layer["self_attn_layer_norm"])
        norm(f"{prefix}.final_layer_norm", layer["final_layer_norm"])

    if "classifier" in params:
        dense("classifier", params["classifier"])
    return out


#: Encoder dense layers that int8 quantization converts; grep_linear, the
#: patch embedding, pos_conv, the rel-pos table and the classifier stay float.
ENCODER_QUANT_DENSES = frozenset({"q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"})


def quantize_beats_params(module: nn.Module, dtype: torch.dtype = torch.float32) -> nn.Module:
    """Swap the encoder denses of a :class:`BEATsModel` tree for ``Int8Linear``
    layers with output ``dtype``, in place."""
    return quantize_params(
        module,
        include=lambda path: "encoder" in path and path[-1] in ENCODER_QUANT_DENSES,
        dtype=dtype,
    )


# ---------------------------------------------------------------------------
# Registered wrapper (architecture name: "beats")
# ---------------------------------------------------------------------------


class Model(ModelBase):
    """BEATs wrapper registered as ``beats``.

    Weights are seeded random (``seed``) until :meth:`load_state_dict` or
    ``load_model`` installs a checkpoint; the port never fetches weights
    over the network.
    """

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = True,
        audio_config: Optional[Dict[str, Any]] = None,
        init_config: Optional[Dict[str, Any]] = None,
        use_naturelm: Optional[bool] = None,
        fine_tuned: Optional[bool] = None,
        return_features_only: bool = False,
        compute_dtype: str = "float32",
        seed: int = 0,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        cfg = BEATsConfig.from_dict(init_config)
        if use_naturelm:
            cfg = dataclasses.replace(cfg, finetuned_model=True)
        self.cfg = cfg
        self.use_naturelm = bool(use_naturelm)
        self.fine_tuned = bool(fine_tuned)
        self.num_classes = num_classes if not return_features_only else None
        self._return_features_only = return_features_only
        dtype = torch_dtype(compute_dtype)
        self.module = build_module(
            lambda: BEATsModel(cfg, num_classes=self.num_classes, use_naturelm=self.use_naturelm, dtype=dtype),
            seed, self.device,
        )
        if pretrained:
            logger.warning(
                "BEATs base weights are not fetched by the PyTorch port; keeping the "
                "seeded random init (pass a checkpoint to load_model)"
            )

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            self._layer_names = ["backbone.post_extract_proj"] + [
                f"backbone.encoder.layers.{i}.fc2" for i in range(self.cfg.encoder_layers)
            ]

    def load_state_dict(self, state: Mapping[str, np.ndarray], strict: bool = False) -> None:
        """Load a reference BEATs checkpoint (SSL / fine-tuned / NatureLM naming)."""
        converted = convert_beats_state_dict(state, self.cfg, num_classes=self.num_classes)
        self.load_port_state_dict(converted, strict=strict)

    def quantize(self, mode: str = "int8") -> None:
        """Convert to W8A8 dynamic-int8 encoder inference (serving mode).

        Folds every encoder dense projection (q/k/v/out, fc1, fc2) to
        symmetric per-channel int8 in place (``Int8Linear``, same names).
        One-way and inference-only. The frontend, patch embedding, pos_conv,
        rel-pos table, gate and classifier stay float. Idempotent.
        """
        if mode != "int8":
            raise ValueError(f"Unsupported quantization mode: {mode!r} (only 'int8')")
        if self.cfg.quantize_encoder:
            return
        if self.cfg.fused_qkv:
            raise ValueError("quantize() is incompatible with fused_qkv; rebuild without it.")
        quantize_beats_params(self.module, dtype=self.module.dtype)
        self.cfg.quantize_encoder = True  # the module's layers share this config
