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
  ``use_pallas`` the q, k and v weights are concatenated into one
  ``[E, 3E]`` product and the CUDA kernel K5 (``fused_qkv_attention``) runs
  over it with the frame mask (the kernels take every head width);
  otherwise plain ``dot_product_attention`` with the mask as a ``-inf``
  bias.

``forward`` returns the last layer's features; the embedding taps are
``model.encoder.transformer.layers.{i}.feed_forward.output_dense``. Module
names follow torchaudio's, so :func:`convert_aves_state_dict` only strips a
wrapper prefix and folds the weight norm. In training (``deterministic=False``)
dropout runs where the JAX model applies it (after the feature projection,
after the positional conv's residual and the encoder LayerNorm, after the
attention's ``out_proj``, after the FFN's intermediate and output), and
LayerDrop (``disable_layerdrop=False``) keeps each layer with probability
``1 - encoder_layer_drop``; every draw comes from the caller's
``torch.Generator``. ``encoder_attention_dropout`` is configured but, as in
JAX, never applied. ``scan_layers`` is JAX's stacked layout at the edges
(:func:`convert_aves_state_dict`, :func:`params_from_jax`,
``load_port_state_dict``); a ``layer_runner`` may run the layer stack
(``enable_pipeline``, ``enable_sequence_parallel``), and tensor parallelism
(``parallel/tensor.py``) cuts the attention's projections (JAX's names;
the FFN's ``intermediate_dense``/``output_dense`` stay whole).
``enable_ring_attention`` runs each layer's attention as ring attention
over a mesh axis (``ops/ring_attention.py``).
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
    dropout,
    fold_weight_norm,
    gelu,
    group_norm,
    layer_norm,
    split_stacked,
    stack_state,
    torch_dtype,
)
from avex_tpu_torch.ops._precision import full_fp32
from avex_tpu_torch.ops.attention import dot_product_attention
from avex_tpu_torch.ops.attention_kernels import fused_qkv_attention
from avex_tpu_torch.ops.ring_attention import check_ring_axis, ring_self_attention, shared_linear
from avex_tpu_torch.parallel import shared_generator
from avex_tpu_torch.parallel.tensor import linear_bias, whole_names

_SCAN_HINT = "construct the model with scan_layers=True"

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
    """HuBERT-base hyper-parameters, with the JAX class's defaults. Other keys
    of an ``aves_cfg`` are kept in :attr:`extra`, as the JAX class keeps any
    attribute."""

    encoder_embed_dim: int = 768
    encoder_projection_dropout: float = 0.1
    encoder_pos_conv_kernel: int = 128
    encoder_pos_conv_groups: int = 16
    encoder_num_layers: int = 12
    encoder_num_heads: int = 12
    #: configured but never applied, as in the JAX model (no attention-probability dropout)
    encoder_attention_dropout: float = 0.1
    encoder_ff_interm_features: int = 3072
    encoder_ff_interm_dropout: float = 0.0
    encoder_dropout: float = 0.1
    encoder_layer_norm_first: bool = False
    encoder_layer_drop: float = 0.05
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
        self.cfg, self.heads, self.dtype, self.use_pallas = cfg, cfg.encoder_num_heads, dtype, use_pallas
        self.attention = _SelfAttention(dim)
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.feed_forward = _FeedForward(dim, cfg.encoder_ff_interm_features)
        self.final_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        #: the model axis of the attention: its heads cut, or the time axis
        self.model_axis = None
        self.heads_cut: Optional[slice] = None
        #: ring attention over this mesh's model axis (``ops/ring_attention.py``), or None
        self.ring_mesh = None

    def use_model_axis(self, axis, cut) -> list:
        """Run this rank's heads when the projections are cut; returns the
        whole tensors read in part."""
        self.heads_cut = axis.block(self.heads) if "attention.out_proj.weight" in cut else None
        self.model_axis = axis if self.heads_cut is not None or axis.sequence else None
        if axis.sequence:
            return whole_names(self, cut)
        if self.heads_cut is None:
            return []
        return [f"attention.{p}_proj.bias" for p in "qkv"]

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: Optional[torch.Tensor],
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg

        def drop(t: torch.Tensor, rate: float) -> torch.Tensor:
            return dropout(t, rate, deterministic, generator)

        dt, heads, att = self.dtype, self.heads, self.attention
        head_dim = x.shape[-1] // heads
        h = x
        if self.model_axis is not None:
            h = self.model_axis.enter(x, self.heads_cut is not None)
        if self.heads_cut is not None:  # this rank's heads
            heads = self.heads_cut.stop - self.heads_cut.start
        bsz, seq = h.shape[:2]
        dim = heads * head_dim
        if self.ring_mesh is not None:
            # no kernel under a ring, as in JAX; each rank projects its block
            # of positions, T padded to a ring multiple, its padded keys
            # masked with the frames'
            def project(x_l, shared):
                n = x_l.shape[1]
                return (*(shared_linear(proj, x_l, dt, shared).view(bsz, n, heads, head_dim).transpose(1, 2)
                          for proj in (att.q_proj, att.k_proj, att.v_proj)), None)

            attn = ring_self_attention(h, project, mesh=self.ring_mesh, key_padding_mask=padding_mask,
                                       scale=head_dim**-0.5)
            attn = attn.transpose(1, 2).reshape(bsz, seq, dim)
        elif self.use_pallas:
            # One [E, 3E] product, q|k|v heads-major, then K5 over its columns.
            w = torch.cat([att.q_proj.weight, att.k_proj.weight, att.v_proj.weight]).to(dt)
            b = torch.cat([linear_bias(p) for p in (att.q_proj, att.k_proj, att.v_proj)]).to(dt)
            qkv = F.linear(h.to(dt), w, b)
            attn = fused_qkv_attention(qkv, heads, key_padding_mask=padding_mask, scale=head_dim**-0.5)
        else:
            q, k, v = (
                dense(proj, h, dt).view(bsz, seq, heads, head_dim).transpose(1, 2)
                for proj in (att.q_proj, att.k_proj, att.v_proj)
            )
            bias = None
            if padding_mask is not None:
                bias = torch.zeros(padding_mask.shape, dtype=torch.float32, device=h.device)
                bias = bias.masked_fill(padding_mask, float("-inf"))[:, None, None, :]
            # bf16 compute runs the softmax chain in bf16 too, as in JAX.
            attn = dot_product_attention(q, k, v, bias=bias, scale=head_dim**-0.5, logits_dtype=dt)
            attn = attn.transpose(1, 2).reshape(bsz, seq, dim)
        out = dense(att.out_proj, attn, dt)  # row-parallel with the heads cut
        if self.model_axis is not None and self.heads_cut is None:
            out = self.model_axis.leave(out, cut=False)  # this rank's positions
        x = layer_norm(self.layer_norm, x + drop(out, cfg.encoder_dropout), dt)
        ff = self.feed_forward
        hidden = drop(gelu(dense(ff.intermediate_dense, x, dt)), cfg.encoder_ff_interm_dropout)
        ff_out = dense(ff.output_dense, hidden, dt)
        return layer_norm(self.final_layer_norm, x + drop(ff_out, cfg.encoder_dropout), dt), ff_out


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
        #: the layer stack's runner (``parallel/pipeline.py``, ``parallel/sequence.py``), or None
        self.layer_runner = None


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
        self.cfg, self.num_classes, self.dtype = cfg, num_classes, dtype
        self.feature_extractor = _FeatureExtractor(dtype)
        self.encoder = _Encoder(cfg, dtype, use_pallas)
        if num_classes is not None:
            self.classifier = nn.Linear(cfg.encoder_embed_dim, num_classes)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        disable_layerdrop: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Dropout runs unless ``deterministic``, LayerDrop unless
        ``disable_layerdrop`` too; both draw from ``generator``."""
        cfg, dt = self.cfg, self.dtype
        feats = self.feature_extractor(x.float())
        # A frame is padded only when every sample it pools is.
        frame_mask = downsample_padding_mask(padding_mask, feats.shape[1]) if padding_mask is not None else None

        proj = self.encoder.feature_projection
        h = dense(proj.projection, layer_norm(proj.layer_norm, feats, dt), dt)
        h = dropout(h, cfg.encoder_projection_dropout, deterministic, generator)
        if frame_mask is not None:
            h = h.masked_fill(frame_mask[:, :, None], 0.0)
        tr = self.encoder.transformer
        h = h + gelu(conv_positions(tr.pos_conv_embed.conv, h, dt))
        if not cfg.encoder_layer_norm_first:
            # fairseq post-norm: the encoder LayerNorm sits right after the
            # positional conv, before the layer stack.
            h = layer_norm(tr.layer_norm, h, dt)
        h = dropout(h, cfg.encoder_dropout, deterministic, generator)

        use_layerdrop = not disable_layerdrop and cfg.encoder_layer_drop > 0 and not deterministic
        if use_layerdrop and generator is None:
            raise ValueError("LayerDrop outside deterministic mode needs a torch.Generator")
        intermediates: Dict[str, torch.Tensor] = {}
        if tr.layer_runner is not None:
            # Runner-driven stack (pipeline or sequence parallelism): as in
            # JAX, deterministic only, and no per-layer taps.
            if use_layerdrop:
                raise ValueError("runner-driven encoder does not support layerdrop")
            if not deterministic and max(cfg.encoder_dropout, cfg.encoder_attention_dropout,
                                         cfg.encoder_ff_interm_dropout, cfg.encoder_projection_dropout) > 0:
                raise ValueError("runner-driven encoder (pipeline/sequence-parallel) is deterministic-only; "
                                 "set the encoder dropout rates to 0 to train with it")
            batched = (frame_mask,) if frame_mask is not None else ()
            h = tr.layer_runner(lambda layer, x, *mask: layer(x, mask[0] if mask else None, True)[0],
                                tr.layers, h, batched, ())
        for i, layer in enumerate(tr.layers if tr.layer_runner is None else ()):
            new_h, ff_out = layer(h, frame_mask, deterministic, generator)
            if use_layerdrop:
                # Kept with probability 1 - encoder_layer_drop; as in JAX the
                # layer runs either way and the draw selects, one draw for
                # every rank of a multi-rank step (models/beats.py).
                drop_gen = shared_generator(generator)
                keep = torch.rand((), generator=drop_gen, device=h.device) > cfg.encoder_layer_drop
                new_h = torch.where(keep, new_h, h)
                ff_out = torch.where(keep, ff_out, torch.zeros_like(ff_out))
            h = new_h
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


#: the encoder's layer stack in the state dict
STACK = "encoder.transformer.layers"


def convert_aves_state_dict(
    state: Mapping[str, np.ndarray], num_classes: Optional[int] = None, scan_layers: bool = False
) -> Dict[str, np.ndarray]:
    """torchaudio wav2vec2 state dict (optionally behind the wrapper's
    ``model.`` prefix) → this port's :class:`AVESModel` state dict.

    The weight-normed pos_conv is folded from ``parametrizations.weight.
    original0/1`` or ``weight_g/weight_v``; the classifier is kept only with
    ``num_classes``. With ``scan_layers`` the layers' tensors come stacked on
    a leading layer axis under :data:`STACK`, as JAX's converter stacks them.
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
    state = {k: np.asarray(v, dtype=np.float32) for k, v in state.items()}
    return stack_state(state, STACK) if scan_layers else state


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``AVESModel`` ``variables["params"]`` (nested dicts of numpy
    arrays) → this port's :class:`AVESModel` state dict.

    Dense ``[in, out]`` → Linear ``[out, in]``; Conv ``[K, in/g, out]`` →
    ``[out, in/g, K]``; LayerNorm / GroupNorm ``scale`` → ``weight``. A
    ``scan_layers`` tree (``layers`` stacked on a leading layer axis) gives
    the per-layer keys.
    """
    if "layers" in params:
        params = dict(params)
        params.update({f"layers_{i}": layer for i, layer in enumerate(split_stacked(params.pop("layers")))})
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
        self.stacked_layers = STACK if scan_layers else None
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

    def enable_pipeline(self, mesh: Any, num_microbatches: Optional[int] = None) -> None:
        """Run the layer stack pipeline-parallel over ``mesh``'s model axis
        (GPipe, ``parallel/pipeline.py``); the conv feature extractor runs on
        every stage ahead of it. Needs ``scan_layers=True``, as in JAX."""
        self._enable_layer_runner(self.module.encoder.transformer, mesh, "pipeline parallelism", _SCAN_HINT,
                                  num_microbatches)

    def enable_sequence_parallel(self, mesh: Any) -> None:
        """Megatron-SP over ``mesh``'s model axis (``parallel/sequence.py``).
        Needs ``scan_layers=True``, as in JAX."""
        self._enable_layer_runner(self.module.encoder.transformer, mesh, "sequence parallelism", _SCAN_HINT)

    def enable_ring_attention(self, mesh: Any, axis: str = "model") -> None:
        """Run every layer's attention as ring attention over ``mesh``'s model
        axis (``ops/ring_attention.py``): long windows without a ``[B, H, T,
        T]`` score matrix on any rank. ``mesh=None`` turns it off. ``axis``
        is JAX's argument, which AVES's layers do not read either: any other
        axis than ``model`` raises."""
        check_ring_axis(axis)
        for layer in self.module.encoder.transformer.layers:
            layer.ring_mesh = mesh
