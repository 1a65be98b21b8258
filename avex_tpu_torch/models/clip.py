"""CLIP/CLAP audio-text model in PyTorch: EfficientNet audio tower + RoBERTa text tower.

Port of ``avex_tpu/models/clip.py``:

- the audio tower is :class:`~avex_tpu_torch.models.efficientnet.EfficientNetModel`
  without a classifier; its pooled features go through a two-layer
  projection (fc1, ReLU, fc2) into the shared ``projection_dim`` space;
- the text tower, :class:`RobertaEncoder`, is RoBERTa (post-LN: three
  embeddings and an embedding LayerNorm, then q/k/v, ``attn_out``, a
  LayerNorm, an exact-GELU ``ff1``/``ff2`` and a LayerNorm per layer), with
  RoBERTa's position ids (the running count of non-pad tokens, offset by
  the pad id) and a ``-inf`` bias on padded keys; its attention is the plain
  ``dot_product_attention`` with the compute dtype's logits, as in JAX (no
  kernel: JAX runs none here). The ``[CLS]`` row goes through its own
  projection;
- both embeddings are L2-normalised (``max(norm, 1e-12)``); ``logit_scale``
  starts at ``log(1 / temperature)`` and is clipped at ``log 100``;
- taps: ``audio_encoder.<tap>`` (conv maps ``[B, C, H, W]`` flattened to
  ``[B, H·W, C]``), ``audio_pooled`` and ``audio_projection``.

In training mode the audio tower's BatchNorm takes the batch's statistics
and updates its running ones, and ``deterministic=False`` turns on its
stochastic depth (JAX's ``train=not deterministic``). An audio-only call
skips the text tower: JAX runs it on a row of pad ids, every key masked,
and no output reads it.

Text is tokenized on the host: a ``transformers`` tokenizer when one is in
the local cache (``local_files_only=True``, imported only there), else the
offline hashing :class:`SimpleTokenizer` (not RoBERTa's vocabulary; right for
training from scratch), at most ``MAX_TEXT_LEN`` ids.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import build_module, dense, gelu, layer_norm, torch_dtype
from avex_tpu_torch.models.efficientnet import EfficientNetModel, _round_channels
from avex_tpu_torch.models.efficientnet import VARIANTS as EFFICIENTNET_VARIANTS
from avex_tpu_torch.models.efficientnet import convert_efficientnet_state_dict
from avex_tpu_torch.models.efficientnet import params_from_jax as efficientnet_params_from_jax
from avex_tpu_torch.ops.attention import dot_product_attention

__all__ = [
    "CLIPModule",
    "MAX_TEXT_LEN",
    "Model",
    "RobertaEncoder",
    "SimpleTokenizer",
    "convert_roberta_state_dict",
    "params_from_jax",
    "roberta_params_from_jax",
]

MAX_TEXT_LEN = 70
LOGIT_SCALE_MAX = math.log(100.0)


class _RobertaLayer(nn.Module):
    """One post-LN RoBERTa layer's parameters."""

    def __init__(self, dim: int, ffn_dim: int) -> None:
        super().__init__()
        self.q, self.k, self.v = nn.Linear(dim, dim), nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.attn_out = nn.Linear(dim, dim)
        self.attn_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.ff1 = nn.Linear(dim, ffn_dim)
        self.ff2 = nn.Linear(ffn_dim, dim)
        self.ff_layer_norm = nn.LayerNorm(dim, eps=1e-5)


class RobertaEncoder(nn.Module):
    """RoBERTa text encoder (roberta-base by default); ``forward(input_ids,
    attention_mask=None)`` returns the last hidden states ``[B, L, dim]``."""

    def __init__(
        self,
        vocab_size: int = 50265,
        dim: int = 768,
        layers: int = 12,
        heads: int = 12,
        ffn_dim: int = 3072,
        max_positions: int = 514,
        pad_token_id: int = 1,
        type_vocab_size: int = 1,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dim, self.heads, self.pad_token_id, self.dtype = dim, heads, pad_token_id, dtype
        self.word_embeddings = nn.Embedding(vocab_size, dim)
        self.position_embeddings = nn.Embedding(max_positions, dim)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, dim)
        self.emb_layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.layers = nn.ModuleList(_RobertaLayer(dim, ffn_dim) for _ in range(layers))

    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        bsz, seq = input_ids.shape
        if attention_mask is None:
            attention_mask = (input_ids != self.pad_token_id).to(torch.int64)
        position_ids = torch.cumsum(attention_mask, dim=1) * attention_mask + self.pad_token_id
        emb = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
               + self.token_type_embeddings(torch.zeros_like(input_ids)))  # fp32, as flax Embed
        h = layer_norm(self.emb_layer_norm, emb, dt)
        bias = torch.zeros(attention_mask.shape, dtype=torch.float32, device=h.device)
        bias = bias.masked_fill(attention_mask == 0, float("-inf"))[:, None, None, :]
        head_dim = self.dim // self.heads

        def heads_first(t: torch.Tensor) -> torch.Tensor:
            return t.view(bsz, seq, self.heads, head_dim).transpose(1, 2)

        for layer in self.layers:
            q, k, v = (heads_first(dense(proj, h, dt)) for proj in (layer.q, layer.k, layer.v))
            attn = dot_product_attention(q, k, v, bias=bias, scale=head_dim**-0.5, logits_dtype=dt)
            attn = dense(layer.attn_out, attn.transpose(1, 2).reshape(bsz, seq, self.dim), dt)
            h = layer_norm(layer.attn_layer_norm, h + attn, dt)
            ff = dense(layer.ff2, gelu(dense(layer.ff1, h, dt)), dt)
            h = layer_norm(layer.ff_layer_norm, h + ff, dt)
        return h


class _Projection(nn.Module):
    """Two-layer projection head: fc1, ReLU, fc2."""

    def __init__(self, dim_in: int, hidden: int, out: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim_in, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.model_axis = None  # fc1 column-parallel and fc2 row-parallel over it (parallel/tensor.py)

    def use_model_axis(self, axis, cut) -> list:
        """Run this rank's hidden features; returns the whole tensors read in part."""
        self.model_axis = axis if "fc1.weight" in cut else None
        return ["fc1.bias"] if self.model_axis is not None else []

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.model_axis is not None:
            x = self.model_axis.enter(x, cut=True)
        return dense(self.fc2, F.relu(dense(self.fc1, x, dtype)), dtype)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


class CLIPModule(nn.Module):
    """Joint audio-text module: ``forward(audio, text_tokens=None, ...)``
    returns ``({"audio_features", "text_features", "logit_scale"}, aux)``;
    ``audio`` is the spectrogram image ``[B, 3, F, T]``. Without tokens the
    text tower does not run and ``text_features`` is None."""

    def __init__(
        self,
        efficientnet_variant: str = "b0",
        projection_dim: int = 512,
        temperature: float = 0.07,
        text_encoder_kwargs: Optional[Mapping[str, Any]] = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dtype, self.temperature = dtype, temperature
        self.audio_encoder = EfficientNetModel(efficientnet_variant, None, dtype)
        audio_width = _round_channels(1280, EFFICIENTNET_VARIANTS[efficientnet_variant][0])
        self.audio_projection = _Projection(audio_width, projection_dim, projection_dim)
        self.text_encoder = RobertaEncoder(dtype=dtype, **dict(text_encoder_kwargs or {}))
        self.text_projection = _Projection(self.text_encoder.dim, projection_dim, projection_dim)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def forward(
        self,
        audio: torch.Tensor,
        text_tokens: Optional[torch.Tensor] = None,
        padding_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        dt = self.dtype
        _, audio_aux = self.audio_encoder(audio, None, deterministic, generator)
        audio_feat = audio_aux["pooled"]  # [B, 1280]
        audio_emb = _l2_normalize(self.audio_projection(audio_feat, dt))
        text_emb = None
        inter: Dict[str, torch.Tensor] = {"audio_projection": audio_emb, "audio_pooled": audio_feat}
        if text_tokens is not None:
            text_hidden = self.text_encoder(text_tokens)
            text_emb = _l2_normalize(self.text_projection(text_hidden[:, 0], dt))  # [CLS]
            inter["text_projection"] = text_emb
        for name, value in audio_aux["intermediates"].items():
            if value.ndim == 4:  # NCHW → [B, H·W, C]
                value = value.permute(0, 2, 3, 1).reshape(value.shape[0], -1, value.shape[1])
            inter[f"audio_encoder.{name}"] = value
        out = {"audio_features": audio_emb, "text_features": text_emb,
               "logit_scale": torch.clamp(self.logit_scale, max=LOGIT_SCALE_MAX)}
        return out, {"intermediates": inter}


class SimpleTokenizer:
    """Deterministic offline tokenizer (md5 hashing of lower-cased words;
    RoBERTa's special ids: ``<s>`` 0, pad 1, ``</s>`` 2). Not RoBERTa's
    vocabulary: for training from scratch and for tests."""

    bos, eos, pad = 0, 2, 1

    def __init__(self, vocab_size: int = 50265) -> None:
        self.vocab_size = vocab_size

    def __call__(self, texts: List[str], max_length: int = MAX_TEXT_LEN) -> np.ndarray:
        batch = []
        for text in texts:
            ids = [self.bos]
            for word in str(text).lower().split()[: max_length - 2]:
                h = int(hashlib.md5(word.encode()).hexdigest(), 16)
                ids.append(4 + (h % (self.vocab_size - 4)))
            ids.append(self.eos)
            batch.append(ids)
        length = min(max(len(i) for i in batch), max_length)
        out = np.full((len(batch), length), self.pad, dtype=np.int32)
        for row, ids in enumerate(batch):
            out[row, : len(ids)] = ids[:length]
        return out


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------


def convert_roberta_state_dict(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A Hugging Face ``roberta-base`` state dict (keys with a ``roberta.``
    prefix or none) → this port's :class:`RobertaEncoder` state dict."""
    prefix = "roberta." if any(k.startswith("roberta.") for k in state) else ""
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: Any) -> None:
        out[key] = np.asarray(value, dtype=np.float32)

    emb = f"{prefix}embeddings"
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        put(f"{name}.weight", state[f"{emb}.{name}.weight"])
    put("emb_layer_norm.weight", state[f"{emb}.LayerNorm.weight"])
    put("emb_layer_norm.bias", state[f"{emb}.LayerNorm.bias"])
    i = 0
    while f"{prefix}encoder.layer.{i}.attention.self.query.weight" in state:
        base = f"{prefix}encoder.layer.{i}"
        pairs = (
            (f"{base}.attention.self.query", "q"),
            (f"{base}.attention.self.key", "k"),
            (f"{base}.attention.self.value", "v"),
            (f"{base}.attention.output.dense", "attn_out"),
            (f"{base}.attention.output.LayerNorm", "attn_layer_norm"),
            (f"{base}.intermediate.dense", "ff1"),
            (f"{base}.output.dense", "ff2"),
            (f"{base}.output.LayerNorm", "ff_layer_norm"),
        )
        for hf_name, name in pairs:
            put(f"layers.{i}.{name}.weight", state[f"{hf_name}.weight"])
            put(f"layers.{i}.{name}.bias", state[f"{hf_name}.bias"])
        i += 1
    return out


def roberta_params_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``RobertaEncoder`` params (nested dicts of numpy arrays) → this
    port's state dict: Dense ``[in, out]`` → Linear ``[out, in]``, LayerNorm
    ``scale`` → ``weight``, Embed ``embedding`` → ``weight``."""
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: Any) -> None:
        out[key] = np.asarray(value, dtype=np.float32)

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        put(f"{name}.weight", params[name]["embedding"])
    put("emb_layer_norm.weight", params["emb_layer_norm"]["scale"])
    put("emb_layer_norm.bias", params["emb_layer_norm"]["bias"])
    i = 0
    while f"layer_{i}_q" in params:
        for jax_name, name in (("q", "q"), ("k", "k"), ("v", "v"), ("attn_out", "attn_out"), ("ff1", "ff1"),
                               ("ff2", "ff2")):
            node = params[f"layer_{i}_{jax_name}"]
            put(f"layers.{i}.{name}.weight", np.asarray(node["kernel"]).T)
            put(f"layers.{i}.{name}.bias", node["bias"])
        for jax_name, name in (("attn_ln", "attn_layer_norm"), ("ff_ln", "ff_layer_norm")):
            node = params[f"layer_{i}_{jax_name}"]
            put(f"layers.{i}.{name}.weight", node["scale"])
            put(f"layers.{i}.{name}.bias", node["bias"])
        i += 1
    return out


def params_from_jax(variables: Mapping[str, Any], variant: str = "b0") -> Dict[str, np.ndarray]:
    """JAX ``CLIPModule`` variables (``{"params", "batch_stats"}``, nested
    dicts of numpy arrays) → this port's :class:`CLIPModule` state dict,
    the audio tower's running statistics included."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}
    audio = efficientnet_params_from_jax({"params": params["audio_encoder"],
                                          "batch_stats": stats.get("audio_encoder", {})}, variant)
    out.update({f"audio_encoder.{k}": v for k, v in audio.items()})
    out.update({f"text_encoder.{k}": v for k, v in roberta_params_from_jax(params["text_encoder"]).items()})
    for proj in ("audio_projection", "text_projection"):
        for fc in ("fc1", "fc2"):
            out[f"{proj}.{fc}.weight"] = np.asarray(params[proj][fc]["kernel"], np.float32).T
            out[f"{proj}.{fc}.bias"] = np.asarray(params[proj][fc]["bias"], np.float32)
    out["logit_scale"] = np.asarray(params["logit_scale"], np.float32).reshape(())
    return out


# ---------------------------------------------------------------------------
# Registered wrapper (architecture name: "clip")
# ---------------------------------------------------------------------------


class Model(ModelBase):
    """CLIP/CLAP wrapper registered as ``clip``.

    ``extra_config["text_encoder"]`` overrides the text tower's fields (a
    smaller tower for tests). The spectrogram ``audio_config`` runs ahead of
    the audio tower (a raw waveform without one raises, as in JAX). Weights
    are seeded random (``seed``) until a checkpoint is loaded.
    """

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = False,
        audio_config: Optional[Dict[str, Any]] = None,
        text_model_name: str = "roberta-base",
        projection_dim: int = 512,
        temperature: float = 0.07,
        efficientnet_variant: str = "b0",
        extra_config: Optional[Dict[str, Any]] = None,
        compute_dtype: str = "float32",
        seed: int = 0,
        **_ignored: Any,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        self.projection_dim, self.variant = projection_dim, efficientnet_variant
        text_kwargs = dict((extra_config or {}).get("text_encoder") or {})
        dtype = torch_dtype(compute_dtype)
        self.module = build_module(
            lambda: CLIPModule(efficientnet_variant, projection_dim, temperature, text_kwargs, dtype),
            seed, self.device,
        )
        with torch.no_grad():
            self.module.logit_scale.fill_(float(np.log(1.0 / temperature)))
        self.tokenizer = self._load_tokenizer(text_model_name, text_kwargs.get("vocab_size", 50265))

    @staticmethod
    def _load_tokenizer(name: str, vocab_size: int = 50265):
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(name, local_files_only=True)
        except Exception:
            return SimpleTokenizer(vocab_size)

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            taps = ["model.features.0.0"] + [t for t in self.module.audio_encoder.taps if t is not None]
            taps.append("model.features.8.0")
            self._layer_names = [f"audio_encoder.{t}" for t in taps] + ["audio_pooled", "audio_projection"]

    def tokenize(self, texts: List[str]) -> np.ndarray:
        """Texts → a padded ``[B, L]`` int32 batch of token ids."""
        if isinstance(self.tokenizer, SimpleTokenizer):
            return self.tokenizer(texts)
        tokens = self.tokenizer(list(texts), padding=True, truncation=True, max_length=MAX_TEXT_LEN,
                                return_tensors="np")
        return tokens["input_ids"].astype(np.int32)

    def process_audio(self, x) -> torch.Tensor:
        """Waveform → spectrogram (the ``audio_config`` frontend) → 3-channel image."""
        x = super().process_audio(x)
        if x.ndim == 3:
            x = x[:, None].expand(-1, 3, -1, -1)
        if x.ndim == 2:
            raise ValueError(
                "CLIP's audio tower consumes spectrograms: pass a spectrogram audio_config "
                "or feed pre-computed (B, C, F, T) features, not raw waveforms."
            )
        return x

    def _tokens(self, tokens: Any) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).to(torch.int64)

    def forward(self, audio, text: Optional[List[str]] = None, padding_mask=None):
        """``(audio_embeddings, text_embeddings, exp(logit_scale))``; an
        audio-only call returns the projected audio embeddings."""
        tokens = None if text is None else self._tokens(self.tokenize(text))
        with torch.set_grad_enabled(self._training):
            out, _ = self.module(self.process_audio(audio), tokens)
        if text is None:
            return out["audio_features"]
        return out["audio_features"], out["text_features"], torch.exp(out["logit_scale"])

    def __call__(self, audio, text: Optional[List[str]] = None, padding_mask=None):
        return self.forward(audio, text, padding_mask)

    def train_forward(self, x, text_tokens=None, padding_mask=None, **kwargs: Any):
        """Both towers' ``(features, aux)`` with grad tracking as the caller
        has it; ``kwargs`` (``deterministic``, ``generator``) as the base's."""
        tokens = None if text_tokens is None else self._tokens(text_tokens)
        allowed = ("deterministic", "generator")
        kwargs = {k: v for k, v in kwargs.items() if k in allowed}
        return self.module(self.process_audio(x), tokens, self._as_mask(padding_mask), **kwargs)

    def extract_fn(self, layers: Tuple[str, ...], aggregation: str):
        """Audio-only extraction, the frontend ahead of the audio tower for a waveform."""

        def extract(x: torch.Tensor, padding_mask: Optional[torch.Tensor]):
            _, aux = self.module(self.process_audio(x) if x.ndim == 2 else x)
            return self._select_intermediates(aux["intermediates"], layers, aggregation)

        return extract

    def extract_embeddings(self, x, *, padding_mask=None, aggregation: str = "none", freeze_backbone: bool = True):
        """The selected layers' activations; with no layer selected, the
        projected audio features (the reference's default)."""
        if not self._hook_layers:
            if isinstance(x, dict):
                x = x["raw_wav"]
            with torch.set_grad_enabled(not freeze_backbone):
                out, _ = self.module(self.process_audio(x))
            return out["audio_features"]
        return super().extract_embeddings(x, padding_mask=padding_mask, aggregation=aggregation,
                                          freeze_backbone=freeze_backbone)

    def load_state_dict(self, state: Mapping[str, Any], strict: bool = False) -> None:
        """Load a CLIP/CLAP checkpoint: ``audio_encoder.*`` (torchvision
        EfficientNet names, running statistics included), ``text_encoder.*``
        (Hugging Face RoBERTa names), ``{audio,text}_projection.{0,2}`` and
        ``logit_scale``."""
        converted: Dict[str, np.ndarray] = {}
        audio = {k[len("audio_encoder."):]: v for k, v in state.items() if k.startswith("audio_encoder.")}
        if audio:
            converted.update({f"audio_encoder.{k}": v
                              for k, v in convert_efficientnet_state_dict(audio, self.variant).items()})
        text = {k[len("text_encoder."):]: v for k, v in state.items() if k.startswith("text_encoder.")}
        if text:
            converted.update({f"text_encoder.{k}": v for k, v in convert_roberta_state_dict(text).items()})
        for proj in ("audio_projection", "text_projection"):
            for index, fc in (("0", "fc1"), ("2", "fc2")):
                for param in ("weight", "bias"):
                    key = f"{proj}.{index}.{param}"
                    if key in state:
                        converted[f"{proj}.{fc}.{param}"] = np.asarray(state[key], np.float32)
        if "logit_scale" in state:
            converted["logit_scale"] = np.asarray(state["logit_scale"], np.float32).reshape(())
        self.load_port_state_dict(converted, strict=strict)
