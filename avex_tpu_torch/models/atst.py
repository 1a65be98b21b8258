"""ATST-Frame (frame-level Audio Spectrogram Transformer) in PyTorch.

Port of ``avex_tpu/models/atst.py``:

- frontend (:func:`atst_frontend`): mel spectrogram (16 kHz, n_fft and
  window 1024, hop 160, 64 HTK mels over 60-7800 Hz) through the generic
  frontend's ``stft_power``, power to dB with ``top_db`` 80 per clip, then
  min-max to [-1, 1] with the published constants;
- FrameAST-base: a (64 freq x 4 frame) patch embedding (one token per 4
  frames, the kernel in JAX's (freq, time, channel) order), learned
  positions cut to the input length (at most 250 tokens), 12 pre-norm ViT
  blocks without a qkv bias (EAT's block), the shared final norm applied to
  each of the last 12 block outputs;
- outputs: ``timestamp_embedding`` ``[B, N, 12 · 768]`` (the normed block
  outputs side by side), ``scene_embedding`` (their per-block means),
  ``pooled`` (the timestamp embedding's mean over frames);
- attention: EAT's block dispatch. With ``use_pallas`` the K5 kernel over
  the raw projection (its backward K6) at every head width; else the plain
  path;
- embedding taps: ``atst.blocks.{i}``, each block's output before the norm.

:func:`convert_atst_state_dict` takes the reference encoder naming (both
patch-embedding namings, ``pos_embed`` with its class slot, ``norm`` or
``norm_frame``); :func:`params_from_jax` carries a JAX
``variables["params"]`` tree across.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import build_module, dense, layer_norm, torch_dtype
from avex_tpu_torch.models.eat import _Block, _PatchEmbed, patch_tokens
from avex_tpu_torch.ops.frontend import mel_product, stft_power

__all__ = ["FrameASTModel", "Model", "atst_frontend", "convert_atst_state_dict", "params_from_jax"]

N_BLOCKS = 12
_MINMAX = (-79.6482, 50.6842)


def atst_frontend(wav: torch.Tensor, precision: str = "highest") -> torch.Tensor:
    """16 kHz waveform ``[B, T]`` → normalised 64-mel dB spectrogram ``[B, 64, frames]``, fp32.

    ``precision`` is the DFT product's (``ops/frontend.stft_power``): the bf16
    model takes ``"default"``, as JAX's; the mel product is fp32 in both.
    """
    power = stft_power(wav, n_fft=1024, hop_length=160, win_length=1024, precision=precision)
    mel = mel_product(power, 64, 16000.0, f_min=60.0, f_max=7800.0)
    db = 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))  # AmplitudeToDB(stype="power", top_db=80)
    db = torch.maximum(db, db.amax(dim=(1, 2), keepdim=True) - 80.0)
    lo, hi = _MINMAX
    return (db - lo) / (hi - lo) * 2.0 - 1.0


class FrameASTModel(nn.Module):
    """FrameAST: a per-frame ViT over the mel spectrogram; ``forward`` returns
    ``(timestamp_embedding or logits, aux)``."""

    def __init__(
        self,
        embed_dim: int = 768,
        depth: int = 12,
        heads: int = 12,
        patch_h: int = 64,
        patch_w: int = 4,
        max_frames: int = 1001,
        num_classes: Optional[int] = None,
        n_blocks_out: int = N_BLOCKS,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
    ) -> None:
        super().__init__()
        self.embed_dim, self.depth, self.num_classes = embed_dim, depth, num_classes
        self.n_blocks_out, self.dtype = n_blocks_out, dtype
        self.patch_embed = _PatchEmbed(embed_dim, (patch_h, patch_w))
        self.pos_embed = nn.Parameter(torch.empty(1, max_frames // patch_w, embed_dim))
        self.blocks = nn.ModuleList(
            _Block(embed_dim, heads, 4.0, dtype, use_pallas, qkv_bias=False) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)  # the shared final norm (norm_frame)
        if num_classes is not None:
            self.classifier = nn.Linear(embed_dim * min(n_blocks_out, depth), num_classes)

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """``x``: a 16 kHz waveform ``[B, T]`` or a spectrogram ``[B, 64,
        frames]``. ``padding_mask`` is accepted for the common model contract
        and, as in the JAX package, not used."""
        dt = self.dtype
        # The bf16 model takes bf16-rounded DFT operands (fp32 sums), as JAX.
        spec = atst_frontend(x, "highest" if dt == torch.float32 else "default") if x.ndim == 2 else x
        tokens, _, n = patch_tokens(self.patch_embed.proj, spec, dt)  # [B, frames // 4, D]
        tokens = tokens + self.pos_embed[:, :n].to(dt)  # the "cut" positional type

        intermediates: Dict[str, torch.Tensor] = {}
        block_outputs: List[torch.Tensor] = []
        for i, block in enumerate(self.blocks):
            tokens, _ = block(tokens)
            intermediates[f"atst.blocks.{i}"] = tokens
            if self.depth - i <= self.n_blocks_out:
                block_outputs.append(layer_norm(self.norm, tokens, dt))

        timestamp = torch.cat(block_outputs, dim=-1)
        aux: Dict[str, Any] = {
            "intermediates": intermediates,
            "timestamp_embedding": timestamp,
            "scene_embedding": torch.cat([b.mean(dim=1) for b in block_outputs], dim=-1),
            "features": block_outputs[-1],
            "pooled": timestamp.mean(dim=1),
        }
        if self.num_classes is None:
            return timestamp, aux
        return dense(self.classifier, aux["pooled"], dt), aux


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------

_PREFIXES = ("model.teacher.encoder.", "teacher.encoder.", "encoder.", "atst.")
_BLOCK_PARTS = ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")


def convert_atst_state_dict(
    state: Mapping[str, Any], num_classes: Optional[int] = None
) -> Dict[str, np.ndarray]:
    """Reference FrameAST encoder state dict → this port's :class:`FrameASTModel` state dict.

    As the JAX package's converter (``atst.py:213-268``): the teacher/encoder
    prefixes are stripped; ``patch_embed.proj`` (a Conv2d) is taken as it is,
    ``patch_embed.patch_embed`` (PatchEmbed_v2's Linear over features packed
    as (freq, time, channel)) is reshaped into the conv weight; ``pos_embed``
    loses its class-token slot; ``norm`` and ``norm_frame`` are the final
    norm; the classifier is kept only with ``num_classes``.
    """
    out: Dict[str, np.ndarray] = {}
    for key, value in state.items():
        for prefix in _PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        value = np.asarray(value, dtype=np.float32)
        if key == "patch_embed.proj.weight":
            out[key] = value
        elif key == "patch_embed.patch_embed.weight":
            out["patch_embed.proj.weight"] = value.reshape(value.shape[0], 64, 4, 1).transpose(0, 3, 1, 2)
        elif key in ("patch_embed.proj.bias", "patch_embed.patch_embed.bias"):
            out["patch_embed.proj.bias"] = value
        elif key == "pos_embed":
            out["pos_embed"] = value[:, 1:]  # the "cut" path skips the class slot (pos_embed[:, 1:T+1])
        elif key in ("norm.weight", "norm.bias", "norm_frame.weight", "norm_frame.bias"):
            out["norm." + key.rsplit(".", 1)[1]] = value
        elif key.startswith("blocks."):
            if ".".join(key.split(".")[2:-1]) in _BLOCK_PARTS:
                out[key] = value
        elif key.startswith("classifier.") and num_classes is not None:
            out[key] = value
    return out


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``FrameASTModel`` ``variables["params"]`` (nested dicts of numpy
    arrays) → this port's state dict: Dense ``[in, out]`` → Linear ``[out,
    in]``, the patch conv ``[64, 4, 1, out]`` → ``[out, 1, 64, 4]``,
    LayerNorm ``scale`` → ``weight``."""
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: Any) -> None:
        out[key] = np.asarray(value, dtype=np.float32)

    def norm_(prefix: str, node: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", node["scale"])
        put(f"{prefix}.bias", node["bias"])

    def dense_(prefix: str, node: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", np.asarray(node["kernel"]).T)
        if "bias" in node:
            put(f"{prefix}.bias", node["bias"])

    put("patch_embed.proj.weight", np.asarray(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    put("patch_embed.proj.bias", params["patch_embed"]["bias"])
    put("pos_embed", params["pos_embed"])
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
# Registered wrapper (architecture name: "atst")
# ---------------------------------------------------------------------------


class Model(ModelBase):
    """ATST-Frame wrapper registered as ``atst``.

    The JAX wrapper's arguments: ``atst_model_path`` is a local checkpoint
    (the port reads local files only), ``use_pallas`` True runs the CUDA
    attention kernels, None and False the plain path. Weights are seeded
    random (``seed``) until a checkpoint is loaded.
    """

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = False,
        audio_config: Optional[Dict[str, Any]] = None,
        atst_model_path: Optional[str] = None,
        return_features_only: bool = True,
        compute_dtype: str = "float32",
        use_pallas: Optional[bool] = None,
        seed: int = 0,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        self.num_classes = None if return_features_only else num_classes
        self.depth = 12
        dtype = torch_dtype(compute_dtype)
        self.module = build_module(
            lambda: FrameASTModel(num_classes=self.num_classes, dtype=dtype, use_pallas=bool(use_pallas)),
            seed, self.device,
        )
        if atst_model_path:
            from avex_tpu_torch.utils.loaders import process_state_dict, universal_load

            self.load_state_dict(process_state_dict(universal_load(atst_model_path)))

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            self._layer_names = [f"atst.blocks.{i}" for i in range(self.depth)]

    def load_state_dict(self, state: Mapping[str, Any], strict: bool = False) -> None:
        """Load a reference ATST checkpoint (converted to this port's names)."""
        self.load_port_state_dict(convert_atst_state_dict(state, self.num_classes), strict=strict)
