"""EAT self-supervised pretraining (data2vec 2.0 style) in PyTorch.

Port of ``avex_tpu/models/eat_ssl.py``:

- the **student** encodes only the *visible* patches of the fbank image (a
  draw of ``mask_ratio``·n patches is masked) with EAT's pre-norm blocks and a
  final LayerNorm; a light decoder (``decoder_dim`` wide, ``decoder_dim //
  64`` heads) sees the visible tokens plus a learned mask token at every
  masked position and predicts the ``dim``-wide representation there;
- the **teacher** is an EMA copy of the student trunk. It encodes *all*
  patches under ``torch.no_grad()`` (JAX stops its gradient): the target is
  the mean of its last ``target_layers`` block outputs (the residual
  stream), instance-normed over the feature axis and gathered at the masked
  positions;
- the loss is ``((pred - target)²).mean(-1).sum()`` in fp32, reported as
  ``{"losses": {"regression": ...}, "sample_size": B·n_masked}``.

The mask is the argsort of one uniform draw per patch (:func:`mask_noise`,
from the caller's generator), with a fixed mask count. On the deterministic
(inference) path the order is ``arange(n)``, so the student encodes the
*first* ``n - int(mask_ratio·n)`` patches, as the JAX module does.

With ``use_pallas`` every block's attention takes the CUDA kernel over the
raw ``[B, T, 3E]`` projection (K5; its backward K6 under grad; the teacher's
calls keep no residuals), at any token count: JAX's switch-on at T >= 248 is
a TPU measurement. The wrapper :class:`Model` refreshes the teacher after
each optimizer update (:meth:`Model.post_optimizer_step`, which the
``Trainer`` calls). It is not in the registry's architecture table: register
it as the JAX package documents, ``register_model_class("eat_ssl", Model)``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import build_module, dense, layer_norm, torch_dtype
from avex_tpu_torch.models.eat import _Block, _PatchEmbed, _PositionTables, patch_tokens
from avex_tpu_torch.ops.fbank import KaldiFbank, eat_fbank

__all__ = ["EATSSLModule", "Model", "ema_update", "mask_noise", "params_from_jax"]


class _Encoder(nn.Module):
    """A ViT trunk over any token subset (positions already added): EAT's
    blocks and a final LayerNorm. ``forward`` returns the normed tokens and
    every block's output."""

    def __init__(self, dim: int, depth: int, heads: int, dtype: torch.dtype, use_pallas: bool) -> None:
        super().__init__()
        self.dtype = dtype
        self.blocks = nn.ModuleList(_Block(dim, heads, 4.0, dtype, use_pallas) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        layer_outputs = []
        for block in self.blocks:
            tokens, _ = block(tokens)
            layer_outputs.append(tokens)
        return layer_norm(self.norm, tokens, self.dtype), layer_outputs


def mask_noise(bsz: int, n: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """The uniform draw ``[bsz, n]`` whose argsort orders the patches: the
    first ``n_visible`` are seen by the student, the rest masked."""
    return torch.rand((bsz, n), generator=generator, device=device)


def _take(tokens: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``tokens[b, idx[b]]`` for every item: ``[B, N, C]`` at ``[B, K]`` → ``[B, K, C]``."""
    return torch.gather(tokens, 1, idx[:, :, None].expand(-1, -1, tokens.shape[-1]))


class EATSSLModule(nn.Module):
    """Student-teacher masked prediction over fbank patches.

    ``forward(x, padding_mask=None, deterministic=True, generator=None)``:
    with ``deterministic=False`` the masked-prediction step, returning
    ``(result, aux)`` with ``result = {"losses", "sample_size",
    "predictions"}``; the mask draw comes from ``generator``. With
    ``deterministic=True`` the student's features ``(student_out, aux)``.
    ``padding_mask`` is accepted for the common contract and not used: the
    fbank pads to ``target_length``.
    """

    def __init__(
        self,
        dim: int = 768,
        depth: int = 12,
        heads: int = 12,
        decoder_dim: int = 384,
        decoder_depth: int = 4,
        mask_ratio: float = 0.8,
        target_layers: int = 8,
        target_length: int = 1024,
        norm_mean: float = -4.268,
        norm_std: float = 4.569,
        dtype: torch.dtype = torch.float32,
        use_pallas: bool = False,
    ) -> None:
        super().__init__()
        self.dim, self.decoder_dim, self.dtype = dim, decoder_dim, dtype
        self.mask_ratio, self.target_layers = mask_ratio, target_layers
        self.target_length, self.norm_mean, self.norm_std = target_length, norm_mean, norm_std
        self.fbank = KaldiFbank(window_type="hanning")
        self.patch_embed = _PatchEmbed(dim, 16)
        self.student = _Encoder(dim, depth, heads, dtype, use_pallas)
        self.decoder_embed = nn.Linear(dim, decoder_dim)
        self.mask_token = nn.Parameter(torch.empty(1, 1, decoder_dim))
        dec_heads = max(decoder_dim // 64, 1)
        self.decoder_blocks = nn.ModuleList(
            _Block(decoder_dim, dec_heads, 4.0, dtype, use_pallas) for _ in range(decoder_depth)
        )
        self.decoder_pred = nn.Linear(decoder_dim, dim)
        self.teacher = _Encoder(dim, depth, heads, dtype, use_pallas)
        self._positions = _PositionTables(dim)
        self._dec_positions = _PositionTables(decoder_dim)

    def forward(
        self,
        x: torch.Tensor,
        padding_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Any, Dict[str, Any]]:
        dt = self.dtype
        if x.ndim == 2:
            spec = eat_fbank(x, self.target_length, self.norm_mean, self.norm_std, fbank=self.fbank)
        else:
            spec = x
        tokens, gh, gw = patch_tokens(self.patch_embed.proj, spec, dt)  # frequency patches major
        tokens = tokens + self._positions(gh, gw, tokens.device)[None].to(dt)
        bsz, n, _ = tokens.shape

        n_masked = int(self.mask_ratio * n)
        n_visible = n - n_masked
        if deterministic:
            order = torch.arange(n, device=tokens.device).expand(bsz, n)
        else:
            if generator is None:
                raise ValueError("the EAT-SSL mask draw outside deterministic mode needs a torch.Generator")
            order = torch.argsort(mask_noise(bsz, n, generator, tokens.device), dim=1, stable=True)
        visible_idx, masked_idx = order[:, :n_visible], order[:, n_visible:]

        student_out, _ = self.student(_take(tokens, visible_idx))
        if deterministic:
            # As in JAX: the first n_visible patches, not all of them.
            return student_out, {"intermediates": {"student.norm": student_out}, "features": student_out}

        dec_pos = self._dec_positions(gh, gw, tokens.device)[None].to(dt).expand(bsz, n, self.decoder_dim)
        dec_vis = dense(self.decoder_embed, student_out, dt) + _take(dec_pos, visible_idx)
        dec_mask = self.mask_token.to(dt).expand(bsz, n_masked, self.decoder_dim) + _take(dec_pos, masked_idx)
        dec_tokens = torch.cat([dec_vis, dec_mask], dim=1)
        for block in self.decoder_blocks:
            dec_tokens, _ = block(dec_tokens)
        predictions = dense(self.decoder_pred, dec_tokens[:, n_visible:], dt)  # [B, M, dim]

        with torch.no_grad():
            _, t_layers = self.teacher(tokens)
            top = torch.stack(t_layers[-self.target_layers:]).float().mean(dim=0).to(dt)  # [B, N, dim]
            mean = top.float().mean(dim=-1, keepdim=True).to(dt)
            var = top.float().var(dim=-1, unbiased=False, keepdim=True).to(dt)
            target = _take((top - mean) / torch.sqrt(var + 1e-6), masked_idx)

        regression = ((predictions.float() - target.float()) ** 2).mean(dim=-1).sum()
        result = {"losses": {"regression": regression}, "sample_size": bsz * n_masked, "predictions": predictions}
        return result, {"intermediates": {}}


def ema_update(teacher: nn.Module, student: nn.Module, decay: float) -> None:
    """``teacher ← decay·teacher + (1 - decay)·student``, parameter by
    parameter (the two trunks have one layout), in place and untracked."""
    t_params, s_params = list(teacher.parameters()), list(student.parameters())
    with torch.no_grad():
        torch._foreach_mul_(t_params, decay)
        torch._foreach_add_(t_params, s_params, alpha=1.0 - decay)


# ---------------------------------------------------------------------------
# Weight conversion
# ---------------------------------------------------------------------------


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``EATSSLModule`` ``variables["params"]`` (nested dicts of numpy
    arrays: ``patch_embed``, ``student``, ``decoder_embed``, ``mask_token``,
    ``decoder_blocks_{i}``, ``decoder_pred``, ``teacher``) → this port's
    state dict. Dense ``[in, out]`` → Linear ``[out, in]``; the patch conv
    ``[kh, kw, 1, out]`` → ``[out, 1, kh, kw]``; LayerNorm ``scale`` →
    ``weight``."""
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: Any) -> None:
        out[key] = np.asarray(value, dtype=np.float32)

    def dense_(prefix: str, node: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", np.asarray(node["kernel"]).T)
        put(f"{prefix}.bias", node["bias"])

    def norm_(prefix: str, node: Mapping[str, Any]) -> None:
        put(f"{prefix}.weight", node["scale"])
        put(f"{prefix}.bias", node["bias"])

    def block_(prefix: str, node: Mapping[str, Any]) -> None:
        norm_(f"{prefix}.norm1", node["norm1"])
        norm_(f"{prefix}.norm2", node["norm2"])
        dense_(f"{prefix}.attn.qkv", node["qkv"])
        dense_(f"{prefix}.attn.proj", node["proj"])
        dense_(f"{prefix}.mlp.fc1", node["fc1"])
        dense_(f"{prefix}.mlp.fc2", node["fc2"])

    put("patch_embed.proj.weight", np.asarray(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    put("patch_embed.proj.bias", params["patch_embed"]["bias"])
    for trunk in ("student", "teacher"):
        node = params[trunk]
        norm_(f"{trunk}.norm", node["norm"])
        for name, block in node.items():
            if name.startswith("blocks_"):
                block_(f"{trunk}.blocks.{name.split('_', 1)[1]}", block)
    dense_("decoder_embed", params["decoder_embed"])
    put("mask_token", params["mask_token"])
    for name, block in params.items():
        if name.startswith("decoder_blocks_"):
            block_(f"decoder_blocks.{name.rsplit('_', 1)[1]}", block)
    dense_("decoder_pred", params["decoder_pred"])
    return out


# ---------------------------------------------------------------------------
# Wrapper (register as "eat_ssl")
# ---------------------------------------------------------------------------


class Model(ModelBase):
    """EAT-SSL wrapper for ``label_type="self_supervised"`` training.

    ``eat_cfg`` holds :class:`EATSSLModule`'s fields (``use_pallas`` among
    them) and ``ema_decay`` (default 0.999). The teacher starts as a copy of
    the student with storage of its own; it is in the module's state dict (so
    a checkpoint keeps the EMA) and in ``frozen_param_keys`` (no optimizer
    updates it). Inference (``extract_embeddings``) reads ``student.norm``.
    Weights are seeded random (``seed``).
    """

    #: excluded from the optimizer: the EMA refresh owns it
    frozen_param_keys = ("teacher",)

    def __init__(
        self,
        device: Optional[str] = None,
        num_classes: Optional[int] = None,
        pretrained: bool = False,
        audio_config: Optional[Dict[str, Any]] = None,
        eat_cfg: Optional[Dict[str, Any]] = None,
        compute_dtype: str = "float32",
        use_pallas: Optional[bool] = None,
        seed: int = 0,
        **_ignored: Any,
    ) -> None:
        super().__init__(device=device, audio_config=audio_config)
        cfg = dict(eat_cfg or {})
        self.ema_decay = float(cfg.pop("ema_decay", 0.999))
        if use_pallas is not None:
            cfg["use_pallas"] = bool(use_pallas)
        dtype = torch_dtype(compute_dtype)
        self.module = build_module(lambda: EATSSLModule(dtype=dtype, **cfg), seed, self.device)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(seed + 1)
            token = torch.randn(self.module.mask_token.shape, generator=gen) * 0.02  # flax normal(0.02)
            self.module.mask_token.copy_(token)
            self.module.teacher.load_state_dict(self.module.student.state_dict())
        self.module.teacher.requires_grad_(False)

    def _discover_embedding_layers(self) -> None:
        if not self._layer_names:
            self._layer_names = ["student.norm"]

    def post_optimizer_step(self) -> None:
        """The EMA teacher refresh; the ``Trainer`` calls it after each update."""
        ema_update(self.module.teacher, self.module.student, self.ema_decay)
