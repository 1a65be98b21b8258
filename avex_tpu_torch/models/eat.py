"""EAT (Efficient Audio Transformer, data2vec-2.0 image encoder) in PyTorch.

Port of ``avex_tpu/models/eat.py``:

- frontend: the fp32 Hann-window Kaldi fbank normalised with the dataset
  statistics (``avex_tpu_torch.ops.fbank.eat_fbank``), ``[B, 128, 1024]``;
- backbone: a ViT over the spectrogram image — a 16x16 patch embedding
  (stride = kernel, so a reshape into patches and one matmul with the Conv2d
  weight), fixed 2-D sin-cos positions, a pre-norm, a prepended CLS token,
  pre-norm blocks with a fused ``[E, 3E]`` qkv projection and a 4x GELU MLP,
  a final norm, then ``cls`` or ``mean`` pooling; tokens are frequency
  patches major, as the JAX NHWC conv gives them (the block, the block
  stack, the patch embedding and the positions serve Bird-MAE and, without
  the qkv bias, ATST too);
- attention: with ``use_pallas`` the CUDA kernel over the raw
  ``[B, T, 3E]`` projection (K5, ``fused_qkv_attention``) at every head
  width, which the kernels take on CUDA too (JAX's ``_Block`` takes the
  split-input K4 where its fused rule refuses the heads); without, plain
  ``dot_product_attention`` (bf16 logits under bf16 compute);
- embedding taps: ``backbone.model.blocks.{i}.attn.proj``.

Module names follow the reference's ``backbone.model`` layout, so
:func:`convert_eat_state_dict` is key renaming; :func:`params_from_jax`
carries a JAX ``variables["params"]`` tree (as numpy) across. The JAX
``_Block`` has no dropout, so training runs the same forward; on CUDA the K5
route's backward is the K6 kernel. ``scan_layers`` is JAX's stacked layout
at the edges (:func:`convert_eat_state_dict`, :func:`params_from_jax`,
``load_port_state_dict``); the block stack may be run by a ``layer_runner``
(``enable_pipeline``, ``enable_sequence_parallel``), and a block's
``mlp.fc1``/``mlp.fc2`` cut by tensor parallelism (``parallel/tensor.py``).
``enable_ring_attention`` runs each block's attention as ring attention
over a mesh axis (``ops/ring_attention.py``): the CLS token makes T = grid
+ 1, which pads to a ring multiple with masked keys.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import (
    build_module,
    dense,
    gelu,
    layer_norm,
    split_stacked,
    stack_state,
    torch_dtype,
)
from avex_tpu_torch.ops.attention import dot_product_attention
from avex_tpu_torch.ops.attention_kernels import fused_qkv_attention
from avex_tpu_torch.ops.fbank import KaldiFbank, eat_fbank
from avex_tpu_torch.ops.ring_attention import check_ring_axis, ring_self_attention, shared_linear
from avex_tpu_torch.parallel.tensor import whole_names

logger = logging.getLogger(__name__)

__all__ = [
    "EATModel",
    "Model",
    "apply_vit_blocks",
    "convert_eat_state_dict",
    "params_from_jax",
    "sincos_2d_positions",
]

_SCAN_HINT = 'construct the model with init_config={"scan_layers": True}'


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

    def __init__(self, dim: int, qkv_bias: bool = True) -> None:
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class _Block(nn.Module):
    """Pre-norm ViT block with a fused qkv projection (data2vec AltBlock;
    Bird-MAE's and, without the qkv bias, ATST's block too).

    Returns ``(x, proj_out)``; ``proj_out`` is the embedding tap.
    """

    def __init__(
        self, dim: int, heads: int, mlp_ratio: float, dtype: torch.dtype, use_pallas: bool,
        qkv_bias: bool = True,
    ) -> None:
        super().__init__()
        self.dim, self.heads, self.dtype, self.use_pallas = dim, heads, dtype, use_pallas
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _Attention(dim, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        # the model axis: of the attention under sequence parallelism (JAX's
        # tensor parallelism cuts no attention tensor of this block), of the
        # MLP when fc1/fc2 are cut
        self.attn_axis = self.mlp_axis = None
        #: ring attention over this mesh's model axis (``ops/ring_attention.py``), or None
        self.ring_mesh = None

    def use_model_axis(self, axis, cut) -> list:
        """Run this rank's part; returns the whole tensors read in part."""
        self.attn_axis = axis if axis.sequence else None
        self.mlp_axis = axis if "mlp.fc1.weight" in cut else None
        if axis.sequence:
            return whole_names(self, cut)
        return ["mlp.fc1.bias"] if self.mlp_axis is not None else []

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dt, heads = self.dtype, self.heads
        h = layer_norm(self.norm1, x, dt)
        if self.attn_axis is not None:
            h = self.attn_axis.enter(h, cut=False)  # every position's keys
        bsz, seq, dim = h.shape
        head_dim = dim // heads
        if self.ring_mesh is not None:
            # no kernel under a ring, as in JAX; each rank projects its block
            # of positions, T = grid + CLS padded to a ring multiple
            def project(x_l, shared):
                qkv = shared_linear(self.attn.qkv, x_l, dt, shared).view(bsz, x_l.shape[1], 3, heads, head_dim)
                return (*(t.permute(0, 2, 1, 3) for t in qkv.unbind(2)), None)

            attn = ring_self_attention(h, project, mesh=self.ring_mesh, scale=head_dim**-0.5)
            attn = attn.transpose(1, 2).reshape(bsz, seq, dim)
        elif self.use_pallas:
            attn = fused_qkv_attention(dense(self.attn.qkv, h, dt), heads, scale=head_dim**-0.5)  # K5
        else:
            qkv = dense(self.attn.qkv, h, dt)  # [B, T, 3E]
            q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, head_dim).unbind(2))
            # bf16 compute runs the softmax chain in bf16 too, as in JAX.
            attn = dot_product_attention(q, k, v, scale=head_dim**-0.5, logits_dtype=dt)
            attn = attn.transpose(1, 2).reshape(bsz, seq, dim)
        proj_out = dense(self.attn.proj, attn, dt)
        if self.attn_axis is not None:
            proj_out = self.attn_axis.leave(proj_out, cut=False)
        x = x + proj_out
        h = layer_norm(self.norm2, x, dt)
        if self.mlp_axis is not None:
            h = self.mlp_axis.enter(h, cut=True)
        h = gelu(dense(self.mlp.fc1, h, dt))
        return x + dense(self.mlp.fc2, h, dt), proj_out


def apply_vit_blocks(
    blocks: nn.ModuleList, tokens: torch.Tensor, *, key_prefix: str, layer_runner: Any = None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run a pre-norm ViT block stack, one block after another, collecting
    each block's ``attn.proj`` output under ``{key_prefix}{i}.attn.proj``;
    or hand the stack to ``layer_runner`` (``runner(layer_fn, blocks, x,
    batched, shared)``: pipeline or sequence parallelism), which gives the
    final activations only, as in JAX."""
    if layer_runner is not None:
        return layer_runner(lambda block, h: block(h)[0], blocks, tokens, (), ()), {}
    intermediates: Dict[str, torch.Tensor] = {}
    for i, block in enumerate(blocks):
        tokens, proj_out = block(tokens)
        intermediates[f"{key_prefix}{i}.attn.proj"] = proj_out
    return tokens, intermediates


class _PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: Union[int, Tuple[int, int]]) -> None:
        super().__init__()
        self.proj = nn.Conv2d(1, dim, patch, stride=patch)


def patch_tokens(conv: nn.Conv2d, image: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, int, int]:
    """A stride-equals-kernel Conv2d over a one-channel image ``[B, H, W]`` as
    one matmul: ``[B, (H/ph)·(W/pw), dim]``, tokens row-major over the
    (H, W) patch grid as the JAX package's NHWC conv gives them; returns the
    tokens and the grid ``(gh, gw)``."""
    ph, pw = conv.kernel_size
    bsz, height, width = image.shape
    gh, gw = height // ph, width // pw
    patches = (
        image[:, : gh * ph, : gw * pw]
        .reshape(bsz, gh, ph, gw, pw)
        .permute(0, 1, 3, 2, 4)
        .reshape(bsz, gh * gw, ph * pw)
    )
    weight = conv.weight.reshape(conv.out_channels, ph * pw).to(dtype)
    return F.linear(patches.to(dtype), weight, conv.bias.to(dtype)), gh, gw


class _PositionTables:
    """The fixed 2-D sin-cos table of a patch grid, built once per (grid, device)."""

    def __init__(self, dim: int) -> None:
        self.dim = dim
        self._tables: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def __call__(self, gh: int, gw: int, device: torch.device) -> torch.Tensor:
        key = (gh, gw, device)
        table = self._tables.get(key)
        if table is None:
            table = self._tables[key] = torch.from_numpy(sincos_2d_positions(self.dim, gh, gw)).to(device)
        return table


def set_ring_mesh(blocks: nn.ModuleList, mesh: Any, axis: str = "model") -> None:
    """Every block's attention as ring attention over ``mesh``'s model axis
    (``None``: the block's own attention); ``axis`` must be ``model``."""
    check_ring_axis(axis)
    for block in blocks:
        block.ring_mesh = mesh


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
        self._positions = _PositionTables(dim)
        #: the block stack's runner (``parallel/pipeline.py``, ``parallel/sequence.py``), or None
        self.layer_runner = layer_runner
        set_ring_mesh(self.blocks, ring_mesh)

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
        tokens, gh, gw = patch_tokens(self.patch_embed.proj, spec, dt)  # frequency patches major
        tokens = tokens + self._positions(gh, gw, tokens.device)[None].to(dt)
        tokens = layer_norm(self.pre_norm, tokens, dt)
        cls = self.cls_token.to(dt).expand(tokens.shape[0], 1, self.dim)
        tokens = torch.cat([cls, tokens], dim=1)

        tokens, intermediates = apply_vit_blocks(self.blocks, tokens, key_prefix="backbone.model.blocks.",
                                                 layer_runner=self.layer_runner)
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
    state: Mapping[str, np.ndarray], num_classes: Optional[int] = None, scan_layers: bool = False
) -> Dict[str, np.ndarray]:
    """ESP-wrapper / fairseq EAT state dict → this port's :class:`EATModel` state dict.

    Key normalisation mirrors the JAX package's (``eat.py:307-377``):
    ``modality_encoders.IMAGE.context_encoder.norm`` is the pre-norm, the
    IMAGE prefix and bare keys both root at ``model.``, wrapper exports
    arrive as ``backbone.model.*``; ``local_encoder.proj`` is the patch
    embedding and ``extra_tokens`` the CLS token. EMA and decoder entries are
    skipped, as are unknown keys and, without ``num_classes``, the classifier.
    With ``scan_layers`` the blocks' tensors come stacked on a leading layer
    axis under ``blocks``, as JAX's converter stacks them.
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
    return stack_state(out, "blocks") if scan_layers else out


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``EATModel`` (or ``BirdMAEModel``, which has no pre-norm)
    ``variables["params"]`` (nested dicts of numpy arrays) → this port's
    state dict.

    Dense ``[in, out]`` → Linear ``[out, in]``; the patch conv ``[kh, kw, 1,
    out]`` → ``[out, 1, kh, kw]``; LayerNorm ``scale`` → ``weight``. A ``scan_layers`` tree
    (``blocks`` stacked on a leading layer axis) gives the per-block keys.
    """
    if "blocks" in params:
        params = dict(params)
        params.update({f"blocks_{i}": block for i, block in enumerate(split_stacked(params.pop("blocks")))})
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
    if "pre_norm" in params:  # EAT's; Bird-MAE has none
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
        self.stacked_layers = "blocks" if scan_layers else None
        dtype = torch_dtype(compute_dtype)
        self.module = build_module(
            lambda: EATModel(
                num_classes=self.num_classes, target_length=target_length,
                norm_mean=eat_norm_mean, norm_std=eat_norm_std, depth=depth, dim=dim,
                heads=heads, pooling=pooling, dtype=dtype, use_pallas=bool(use_pallas),
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

    def enable_pipeline(self, mesh: Any, num_microbatches: Optional[int] = None) -> None:
        """Run the block stack pipeline-parallel over ``mesh``'s model axis
        (GPipe, ``parallel/pipeline.py``). Needs ``scan_layers=True``, as in JAX."""
        self._enable_layer_runner(self.module, mesh, "pipeline parallelism", _SCAN_HINT, num_microbatches)

    def enable_sequence_parallel(self, mesh: Any) -> None:
        """Megatron-SP over ``mesh``'s model axis (``parallel/sequence.py``;
        the 1 + patches tokens cut unevenly when odd). Needs ``scan_layers=True``."""
        self._enable_layer_runner(self.module, mesh, "sequence parallelism", _SCAN_HINT)

    def enable_ring_attention(self, mesh: Any, axis: str = "model") -> None:
        """Run every block's attention as ring attention over ``mesh``'s model
        axis (``ops/ring_attention.py``): long windows without a ``[B, H, T,
        T]`` score matrix on any rank. ``mesh=None`` turns it off. ``axis``
        is JAX's argument, which EAT's blocks do not read either: any other
        axis than ``model`` raises."""
        set_ring_mesh(self.module.blocks, mesh, axis)
