"""EAT (Efficient Audio Transformer, data2vec-2.0 image encoder) in PyTorch.

Port of ``avex_tpu/models/eat.py``:

- frontend: the fp32 Hann-window Kaldi fbank normalised with the dataset
  statistics (``avex_tpu_torch.ops.fbank.eat_fbank``), ``[B, 128, 1024]``;
- backbone: a ViT over the spectrogram image — a 16x16 patch embedding
  (stride = kernel, so a reshape into patches and one matmul with the Conv2d
  weight), fixed 2-D sin-cos positions, a pre-norm, a prepended CLS token,
  pre-norm blocks with a fused ``[E, 3E]`` qkv projection and a 4x GELU MLP,
  a final norm, then ``cls`` or ``mean`` pooling; tokens are frequency
  patches major, as the JAX NHWC conv gives them;
- attention, as the JAX ``_Block`` dispatches it: with ``use_pallas`` the
  CUDA kernel over the raw ``[B, T, 3E]`` projection (K5,
  ``fused_qkv_attention``) when the heads fit it, else the split-input
  bias-free kernel (K4, ``gated_bias_attention(pos_bias=None)``); without,
  plain ``dot_product_attention`` (bf16 logits under bf16 compute);
- embedding taps: ``backbone.model.blocks.{i}.attn.proj``.

Module names follow the reference's ``backbone.model`` layout, so
:func:`convert_eat_state_dict` is key renaming; :func:`params_from_jax`
carries a JAX ``variables["params"]`` tree (as numpy) across. Inference only:
the layer-stack layouts of the JAX package (``scan_layers``,
``layer_runner``) and ring attention raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import build_module, dense, gelu, layer_norm, torch_dtype
from avex_tpu_torch.ops.attention import dot_product_attention
from avex_tpu_torch.ops.attention_kernels import (
    fused_qkv_attention,
    fused_qkv_compatible,
    gated_bias_attention,
)
from avex_tpu_torch.ops.fbank import KaldiFbank, eat_fbank

logger = logging.getLogger(__name__)

__all__ = [
    "EATModel",
    "Model",
    "apply_vit_blocks",
    "convert_eat_state_dict",
    "params_from_jax",
    "sincos_2d_positions",
]

#: JAX layer-stack options and the ROADMAP item that brings each to the port.
_NOT_PORTED = {
    "scan_layers": "queue 1, item 10",
    "layer_runner": "queue 1, item 14",
    "ring_mesh": "queue 1, item 14",
}


def sincos_2d_positions(embed_dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    """MAE-style fixed 2-D sin-cos positional table ``[grid_h*grid_w, dim]``."""

    def _1d(dim: int, positions: np.ndarray) -> np.ndarray:
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("p,d->pd", positions.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.meshgrid(np.arange(grid_w, dtype=np.float64), np.arange(grid_h, dtype=np.float64))
    grid = np.stack(grid)  # [2, h, w] (w-coordinate first, MAE convention)
    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


class _Attention(nn.Module):
    """Parameter holder of a block's attention (reference names ``attn.qkv``, ``attn.proj``)."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class _Block(nn.Module):
    """Pre-norm ViT block with a fused qkv projection (data2vec AltBlock).

    Returns ``(x, proj_out)``; ``proj_out`` is the embedding tap.
    """

    def __init__(
        self, dim: int, heads: int, mlp_ratio: float, dtype: torch.dtype, use_pallas: bool
    ) -> None:
        super().__init__()
        self.dim, self.heads, self.dtype, self.use_pallas = dim, heads, dtype, use_pallas
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        bsz, seq, dim = x.shape
        dt, heads = self.dtype, self.heads
        head_dim = dim // heads
        qkv = dense(self.attn.qkv, layer_norm(self.norm1, x, dt), dt)  # [B, T, 3E]
        if self.use_pallas and fused_qkv_compatible(dim, heads):
            attn = fused_qkv_attention(qkv, heads, scale=head_dim**-0.5)  # K5
        else:
            q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, head_dim).unbind(2))
            if self.use_pallas:
                # K4. Reached only when K5 refuses the heads, i.e. dh != 64,
                # which K4 refuses as well: on CUDA this raises; the CPU twin runs.
                attn = gated_bias_attention(q, k, v, None, scale=head_dim**-0.5)
            else:
                # bf16 compute runs the softmax chain in bf16 too, as in JAX.
                attn = dot_product_attention(q, k, v, scale=head_dim**-0.5, logits_dtype=dt)
            attn = attn.transpose(1, 2).reshape(bsz, seq, dim)
        proj_out = dense(self.attn.proj, attn, dt)
        x = x + proj_out
        h = gelu(dense(self.mlp.fc1, layer_norm(self.norm2, x, dt), dt))
        return x + dense(self.mlp.fc2, h, dt), proj_out


def apply_vit_blocks(
    blocks: nn.ModuleList, tokens: torch.Tensor, *, key_prefix: str
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run a pre-norm ViT block stack, one block after another, collecting
    each block's ``attn.proj`` output under ``{key_prefix}{i}.attn.proj``."""
    intermediates: Dict[str, torch.Tensor] = {}
    for i, block in enumerate(blocks):
        tokens, proj_out = block(tokens)
        intermediates[f"{key_prefix}{i}.attn.proj"] = proj_out
    return tokens, intermediates


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int) -> None:
        super().__init__()
        self.proj = nn.Conv2d(1, dim, patch, stride=patch)


class EATModel(nn.Module):
    """EAT backbone + optional classifier; ``forward`` returns ``(output, aux)``.

    Input is a raw waveform ``[B, T]`` (the fp32 fbank runs inside) or a
    spectrogram ``[B, F, T]``. ``use_pallas`` picks the attention kernels
    (see the module docstring).
    """

    def __init__(
        self,
        num_classes: Optional[int] = None,
        target_length: int = 1024,
        norm_mean: float = -4.268,
        norm_std: float = 4.569,
        depth: int = 12,
        dim: int = 768,
        heads: int = 12,
        patch_size: int = 16,
        pooling: str = "cls",
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        scan_layers: bool = False,
        layer_runner: Any = None,
        ring_mesh: Any = None,
    ) -> None:
        super().__init__()
        for name, value in (("scan_layers", scan_layers), ("layer_runner", layer_runner), ("ring_mesh", ring_mesh)):
            if value:
                raise NotImplementedError(
                    f"EAT {name} is not ported to PyTorch yet (ROADMAP {_NOT_PORTED[name]})"
                )
        if pooling not in ("cls", "mean"):
            raise ValueError(f"pooling must be 'cls' or 'mean', got {pooling!r}")
        self.num_classes, self.target_length = num_classes, target_length
        self.norm_mean, self.norm_std = norm_mean, norm_std
        self.dim, self.patch_size, self.pooling, self.dtype = dim, patch_size, pooling, dtype
        self.fbank = KaldiFbank(window_type="hanning")
        self.patch_embed = _PatchEmbed(dim, patch_size)
        self.pre_norm = nn.LayerNorm(dim, eps=1e-6)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.blocks = nn.ModuleList(_Block(dim, heads, 4.0, dtype, use_pallas) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        if num_classes is not None:
            self.classifier = nn.Linear(dim, num_classes)
        self._positions: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def _patch_tokens(self, spec: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """``[B, F, T]`` → ``[B, (F/p)·(T/p), dim]``, frequency patches major."""
        p, dt = self.patch_size, self.dtype
        bsz, freq, frames = spec.shape
        gh, gw = freq // p, frames // p
        patches = (
            spec[:, : gh * p, : gw * p]
            .reshape(bsz, gh, p, gw, p)
            .permute(0, 1, 3, 2, 4)
            .reshape(bsz, gh * gw, p * p)
        )
        conv = self.patch_embed.proj
        weight = conv.weight.reshape(conv.out_channels, p * p).to(dt)
        return F.linear(patches.to(dt), weight, conv.bias.to(dt)), gh, gw

    def _position_table(self, gh: int, gw: int, device: torch.device) -> torch.Tensor:
        key = (gh, gw, device)
        table = self._positions.get(key)
        if table is None:
            table = torch.from_numpy(sincos_2d_positions(self.dim, gh, gw)).to(device)
            self._positions[key] = table
        return table

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``padding_mask`` is accepted for the common model contract and, as
        in the JAX package, not used: the fbank pads to ``target_length``."""
        dt = self.dtype
        if x.ndim == 2:
            spec = eat_fbank(x, self.target_length, self.norm_mean, self.norm_std, fbank=self.fbank)
        else:
            spec = x
        tokens, gh, gw = self._patch_tokens(spec)
        tokens = tokens + self._position_table(gh, gw, tokens.device)[None].to(dt)
        tokens = layer_norm(self.pre_norm, tokens, dt)
        cls = self.cls_token.to(dt).expand(tokens.shape[0], 1, self.dim)
        tokens = torch.cat([cls, tokens], dim=1)

        tokens, intermediates = apply_vit_blocks(self.blocks, tokens, key_prefix="backbone.model.blocks.")
        tokens = layer_norm(self.norm, tokens, dt)
        pooled = tokens[:, 0] if self.pooling == "cls" else tokens.mean(dim=1)
        aux: Dict[str, Any] = {"intermediates": intermediates, "features": tokens, "pooled": pooled}
        if self.num_classes is None:
            return tokens, aux
        return dense(self.classifier, pooled, dt), aux


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------


def _normalize_eat_key(key: str) -> Optional[str]:
    """A reference key (fairseq ``modality_encoders.IMAGE.*`` or bare, or the
    wrapper's ``backbone.model.*``) → ``model.*`` / ``classifier.*``; EMA and
    decoder keys → None."""
    if key.startswith("_ema") or ".decoder." in key or key.startswith("decoder."):
        return None
    k = key[len("backbone."):] if key.startswith("backbone.") else key
    if k.startswith("modality_encoders.IMAGE.context_encoder.norm."):
        return "model.pre_norm." + k.rsplit(".", 1)[1]
    if k.startswith("modality_encoders.IMAGE."):
        return "model." + k[len("modality_encoders.IMAGE."):]
    if not k.startswith(("model.", "classifier.")):
        return "model." + k
    return k


def convert_eat_state_dict(
    state: Mapping[str, np.ndarray], num_classes: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """ESP-wrapper / fairseq EAT state dict → this port's :class:`EATModel` state dict.

    Key normalisation mirrors the JAX package's (``eat.py:307-377``):
    ``modality_encoders.IMAGE.context_encoder.norm`` is the pre-norm, the
    IMAGE prefix and bare keys both root at ``model.``, wrapper exports
    arrive as ``backbone.model.*``; ``local_encoder.proj`` is the patch
    embedding and ``extra_tokens`` the CLS token. EMA and decoder entries are
    skipped, as are unknown keys and, without ``num_classes``, the classifier.
    """
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        k = _normalize_eat_key(key)
        if k is None:
            continue
        value = np.asarray(value, dtype=np.float32)
        if k.startswith("classifier."):
            if num_classes is not None:
                out[k] = value
            continue
        name = k[len("model."):]
        if name.startswith(("local_encoder.proj.", "patch_embed.proj.")):
            out["patch_embed.proj." + name.rsplit(".", 1)[1]] = value
        elif name in ("extra_tokens", "cls_token"):
            out["cls_token"] = value.reshape(1, 1, -1)
        elif name.startswith(("pre_norm.", "norm.")):
            out[name] = value
        elif name.startswith("blocks."):
            sub = name.split(".")[2:]
            if sub[0] in ("norm1", "norm2") or (sub[0] == "attn" and sub[1] in ("qkv", "proj")) or (
                sub[0] == "mlp" and sub[1] in ("fc1", "fc2")
            ):
                out[name] = value
    return out


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``EATModel`` ``variables["params"]`` (nested dicts of numpy arrays)
    → this port's :class:`EATModel` state dict.

    Dense ``[in, out]`` → Linear ``[out, in]``; the patch conv ``[kh, kw, 1,
    out]`` → ``[out, 1, kh, kw]``; LayerNorm ``scale`` → ``weight``.
    """
    if "blocks" in params:
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

    put("patch_embed.proj.weight", np.asarray(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    put("patch_embed.proj.bias", params["patch_embed"]["bias"])
    put("cls_token", params["cls_token"])
    norm_("pre_norm", params["pre_norm"])
    norm_("norm", params["norm"])
    for name, node in params.items():
        if not name.startswith("blocks_"):
            continue
        prefix = f"blocks.{name.split('_', 1)[1]}"
        norm_(f"{prefix}.norm1", node["norm1"])
        norm_(f"{prefix}.norm2", node["norm2"])
        dense_(f"{prefix}.attn.qkv", node["qkv"])
        dense_(f"{prefix}.attn.proj", node["proj"])
        dense_(f"{prefix}.mlp.fc1", node["fc1"])
        dense_(f"{prefix}.mlp.fc2", node["fc2"])
    if "classifier" in params:
        dense_("classifier", params["classifier"])
    return out


# ---------------------------------------------------------------------------
# Registered wrapper (architecture name: "eat_hf")
# ---------------------------------------------------------------------------


class Model(ModelBase):
    """EAT wrapper registered as ``eat_hf``.

    The JAX wrapper's arguments, plus ``use_pallas`` (``EATModel``'s own
    field in JAX): True runs the CUDA attention kernels; None (the default)
    and False the plain path. JAX's auto-enable at T >= 248 was measured on
    a TPU and is not the port's default. Weights are seeded random (``seed``)
    until a checkpoint is loaded; the port never fetches weights.
    """

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = False,
        audio_config: Optional[Dict[str, Any]] = None,
        eat_norm_mean: float = -4.268,
        eat_norm_std: float = 4.569,
        target_length: int = 1024,
        pooling: str = "cls",
        return_features_only: bool = False,
        compute_dtype: str = "float32",
        depth: int = 12,
        dim: int = 768,
        heads: int = 12,
        scan_layers: bool = False,
        use_pallas: Optional[bool] = None,
        seed: int = 0,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        self.num_classes = None if return_features_only else num_classes
        self.depth = depth
        dtype = torch_dtype(compute_dtype)
        self.module = build_module(
            lambda: EATModel(
                num_classes=self.num_classes, target_length=target_length,
                norm_mean=eat_norm_mean, norm_std=eat_norm_std, depth=depth, dim=dim,
                heads=heads, pooling=pooling, dtype=dtype, use_pallas=bool(use_pallas),
                scan_layers=scan_layers,
            ),
            seed, self.device,
        )
        if pretrained:
            logger.warning(
                "EAT weights are not fetched by the PyTorch port; keeping the seeded "
                "random init (pass a checkpoint to load_model)"
            )

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            self._layer_names = [f"backbone.model.blocks.{i}.attn.proj" for i in range(self.depth)]

    def load_state_dict(self, state: Mapping[str, np.ndarray], strict: bool = False) -> None:
        """Load an EAT checkpoint (fairseq or wrapper naming, remapped)."""
        self.load_port_state_dict(convert_eat_state_dict(state, self.num_classes), strict=strict)
