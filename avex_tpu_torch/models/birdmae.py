"""Bird-MAE (masked-autoencoder ViT for bird audio) in PyTorch.

Port of ``avex_tpu/models/birdmae.py``, an AudioMAE-style ViT over a 128-mel
spectrogram of 32 kHz audio:

- frontend: the fp32 Kaldi fbank (Hann window) at 32 kHz, 128 mels, padded
  or cut to 1024 frames, then ``(mel + 7.2) / (2 · 4.43)``;
- backbone: a 16x16 patch embedding over the ``[T, 128]`` image (time is the
  image's height, as the JAX package's NHWC conv has it, so the 64 x 8
  tokens are time-major: 64 rows of 8 frequency patches), fixed 2-D sin-cos
  positions over that grid, a prepended CLS token, the pre-norm blocks of
  the port's EAT (fused ``[E, 3E]`` qkv, 4x GELU MLP), a final norm;
  ``pooled`` is the CLS token;
- variants by ``model_id``: base 768 x 12 (12 heads, dh 64), large 1024 x 24
  and huge 1280 x 32 (16 heads, dh 80);
- attention as EAT's: with ``use_pallas`` the K5 kernel over the raw
  projection (dh 64 and 80 alike; its backward K6), else the plain path;
- embedding taps: ``model.blocks.{i}.attn.proj``.

:func:`convert_birdmae_state_dict` takes timm/MAE naming (EAT's converter,
as in JAX); :func:`params_from_jax` (EAT's: Bird-MAE has the same tree
without the pre-norm) carries a JAX ``variables["params"]`` tree across,
per-layer or stacked. The layer-stack options are EAT's: ``scan_layers`` is
JAX's stacked layout at the edges (the converter, ``params_from_jax``,
``load_port_state_dict``), ``enable_pipeline`` and
``enable_sequence_parallel`` hand the block stack to a ``layer_runner``
(GPipe, ``parallel/pipeline.py``; Megatron-SP with tensor parallelism,
``parallel/sequence.py``: the 1 + 512 tokens cut unevenly over the axis, as
GSPMD cuts them), both needing ``scan_layers`` as in JAX, and
``enable_ring_attention`` runs each block's attention as ring attention.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import build_module, dense, layer_norm, torch_dtype
from avex_tpu_torch.models.eat import (
    _Block,
    _PatchEmbed,
    _PositionTables,
    _SCAN_HINT,
    apply_vit_blocks,
    convert_eat_state_dict,
    params_from_jax,
    patch_tokens,
    set_ring_mesh,
)
from avex_tpu_torch.ops.fbank import KaldiFbank

logger = logging.getLogger(__name__)

__all__ = ["MAE_VARIANTS", "BirdMAEModel", "Model", "convert_birdmae_state_dict", "params_from_jax"]

#: model_id suffix → (dim, depth, heads)
MAE_VARIANTS = {
    "base": (768, 12, 12),
    "large": (1024, 24, 16),
    "huge": (1280, 32, 16),
}
PATCH = 16


class BirdMAEModel(nn.Module):
    """Bird-MAE encoder + optional classifier; ``forward`` returns ``(output, aux)``.

    Input is a raw 32 kHz waveform ``[B, T]`` (the fp32 fbank runs inside) or
    a normalised spectrogram ``[B, frames, 128]``.
    """

    def __init__(
        self,
        dim: int = 1280,
        depth: int = 32,
        heads: int = 16,
        target_length: int = 1024,
        sample_rate: float = 32000.0,
        norm_mean: float = -7.2,
        norm_std: float = 4.43,
        num_classes: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
        scan_layers: bool = False,
        layer_runner: Any = None,
        ring_mesh: Any = None,
    ) -> None:
        super().__init__()
        self.dim, self.num_classes, self.target_length, self.dtype = dim, num_classes, target_length, dtype
        self.norm_mean, self.norm_std = norm_mean, norm_std
        self.fbank = KaldiFbank(num_mel_bins=128, sample_frequency=sample_rate, window_type="hanning")
        self.patch_embed = _PatchEmbed(dim, PATCH)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.blocks = nn.ModuleList(_Block(dim, heads, 4.0, dtype, use_pallas) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        if num_classes is not None:
            self.classifier = nn.Linear(dim, num_classes)
        self._positions = _PositionTables(dim)
        #: the block stack's runner (``parallel/pipeline.py``, ``parallel/sequence.py``), or None
        self.layer_runner = layer_runner
        set_ring_mesh(self.blocks, ring_mesh)

    def spectrogram(self, wav: torch.Tensor) -> torch.Tensor:
        """``[B, T]`` 32 kHz waveform → normalised ``[B, target_length, 128]`` fp32."""
        mel = self.fbank(wav.float())  # [B, frames, 128]
        frames = mel.shape[1]
        if frames < self.target_length:
            mel = F.pad(mel, (0, 0, 0, self.target_length - frames))
        else:
            mel = mel[:, : self.target_length]
        return (mel - self.norm_mean) / (2.0 * self.norm_std)

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``padding_mask`` is accepted for the common model contract and, as
        in the JAX package, not used: the fbank pads to ``target_length``."""
        dt = self.dtype
        spec = self.spectrogram(x) if x.ndim == 2 else x
        tokens, gh, gw = patch_tokens(self.patch_embed.proj, spec, dt)  # time-major: gh time rows of gw
        tokens = tokens + self._positions(gh, gw, tokens.device)[None].to(dt)
        cls = self.cls_token.to(dt).expand(tokens.shape[0], 1, self.dim)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens, intermediates = apply_vit_blocks(self.blocks, tokens, key_prefix="model.blocks.",
                                                 layer_runner=self.layer_runner)
        tokens = layer_norm(self.norm, tokens, dt)
        aux: Dict[str, Any] = {"intermediates": intermediates, "features": tokens, "pooled": tokens[:, 0]}
        if self.num_classes is None:
            return tokens, aux
        return dense(self.classifier, aux["pooled"], dt), aux


def convert_birdmae_state_dict(
    state: Mapping[str, Any], num_classes: Optional[int] = None, scan_layers: bool = False
) -> Dict[str, Any]:
    """timm/MAE-style ViT state dict → this port's :class:`BirdMAEModel` state
    dict: EAT's converter, as in JAX (the same block naming; decoder and EMA
    entries skipped); with ``scan_layers`` the blocks come stacked."""
    return convert_eat_state_dict(state, num_classes=num_classes, scan_layers=scan_layers)


def variant_of(model_id: str) -> str:
    """The Bird-MAE variant a model id names (the last of base, large, huge
    it contains; huge when none), as the JAX wrapper reads it."""
    variant = "huge"
    for key in MAE_VARIANTS:
        if key in model_id.lower():
            variant = key
    return variant


class Model(ModelBase):
    """Bird-MAE wrapper registered as ``birdmae``.

    The JAX wrapper's arguments, plus ``use_pallas`` (``BirdMAEModel``'s own
    field in JAX; through ``init_config`` from a spec): True runs the CUDA
    attention kernels, None and False the plain path. The variant is read
    from ``model_id``; ``dim``, ``depth`` and ``heads`` override it. Weights
    are seeded random (``seed``) until a checkpoint is loaded; the port never
    fetches weights.
    """

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = False,
        audio_config: Optional[Dict[str, Any]] = None,
        model_id: str = "DBD-research-group/Bird-MAE-huge",
        return_features_only: bool = False,
        compute_dtype: str = "float32",
        depth: Optional[int] = None,
        dim: Optional[int] = None,
        heads: Optional[int] = None,
        target_length: int = 1024,
        scan_layers: bool = False,
        use_pallas: Optional[bool] = None,
        seed: int = 0,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        self.model_id = model_id
        self.target_sample_rate = 32000
        v_dim, v_depth, v_heads = MAE_VARIANTS[variant_of(model_id)]
        dim, depth, heads = dim or v_dim, depth or v_depth, heads or v_heads
        self.depth = depth
        self.stacked_layers = "blocks" if scan_layers else None
        self.num_classes = None if return_features_only else num_classes
        dtype = torch_dtype(compute_dtype)
        self.module = build_module(
            lambda: BirdMAEModel(
                dim=dim, depth=depth, heads=heads, target_length=target_length, num_classes=self.num_classes,
                dtype=dtype, use_pallas=bool(use_pallas), scan_layers=scan_layers,
            ),
            seed, self.device,
        )
        if pretrained:
            logger.warning(
                "Bird-MAE weights are not fetched by the PyTorch port; keeping the seeded "
                "random init (pass a checkpoint to load_model)"
            )

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            self._layer_names = [f"model.blocks.{i}.attn.proj" for i in range(self.depth)]

    def enable_pipeline(self, mesh: Any, num_microbatches: Optional[int] = None) -> None:
        """Run the block stack pipeline-parallel over ``mesh``'s model axis
        (GPipe, ``parallel/pipeline.py``). Needs ``scan_layers=True``, as in JAX."""
        self._enable_layer_runner(self.module, mesh, "pipeline parallelism", _SCAN_HINT, num_microbatches)

    def enable_sequence_parallel(self, mesh: Any) -> None:
        """Megatron-SP over ``mesh``'s model axis (``parallel/sequence.py``),
        with tensor parallelism. Needs ``scan_layers=True``, as in JAX."""
        self._enable_layer_runner(self.module, mesh, "sequence parallelism", _SCAN_HINT)

    def enable_ring_attention(self, mesh: Any, axis: str = "model") -> None:
        """Every block's attention as ring attention over ``mesh``'s model
        axis (``ops/ring_attention.py``), as EAT's; ``mesh=None`` turns it off.
        ``axis`` is JAX's argument, which its blocks do not read: any other
        axis than ``model`` raises."""
        set_ring_mesh(self.module.blocks, mesh, axis)

    def load_state_dict(self, state: Mapping[str, Any], strict: bool = False) -> None:
        """Load a timm/MAE-style Bird-MAE state dict."""
        self.load_port_state_dict(convert_birdmae_state_dict(state, self.num_classes), strict=strict)
