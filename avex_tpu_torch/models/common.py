"""Building blocks the port's models share (BEATs, EAT, AVES).

- the flax dtype policy: ``dense`` casts input, weight and bias to the
  compute dtype (an ``Int8Linear`` runs as it is: its int8 weight is never
  cast); ``layer_norm`` / ``group_norm`` take fp32 statistics and return
  the compute dtype;
- the exact (erf) GELU;
- ``conv_positions``: the grouped Conv1d positional embedding of BEATs and
  AVES, with the even-kernel trim;
- the weight-norm fold of the reference checkpoints' pos_conv;
- ``config_from_dict``: an ``init_config`` dict → a config dataclass;
- ``build_module``: construct a module without storage, give it CPU memory
  and a seeded init, then move it to its device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Mapping, Optional, Type, TypeVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.ops._precision import full_fp32
from avex_tpu_torch.quant import Int8Linear

__all__ = [
    "build_module",
    "config_from_dict",
    "conv_positions",
    "dense",
    "fold_weight_norm",
    "gelu",
    "group_norm",
    "layer_norm",
    "torch_dtype",
]


C = TypeVar("C")


def config_from_dict(cls: Type[C], values: Optional[Mapping[str, Any]]) -> C:
    """Build the config dataclass ``cls`` from a dict; keys it has no field
    for are kept in its ``extra`` field."""
    names = {f.name for f in dataclasses.fields(cls)} - {"extra"}
    values = dict(values or {})
    return cls(
        **{k: v for k, v in values.items() if k in names},
        extra={k: v for k, v in values.items() if k not in names},
    )


def torch_dtype(compute_dtype: str) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` → the torch dtype; anything else raises."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', got {compute_dtype!r}")
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)  # exact erf form, as torch nn.GELU and the reference


def dense(layer: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: input, kernel and bias cast to ``dtype``.

    An :class:`Int8Linear` (``Int8Dense``) is called as it is: it quantizes
    x itself and adds its bias in fp32 before the cast to its output type.
    """
    if isinstance(layer, Int8Linear):
        return layer(x)
    bias = layer.bias.to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: fp32 statistics, output in ``dtype``."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps).to(dtype)


def group_norm(layer: nn.GroupNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``GroupNorm(dtype=...)`` on ``[B, C, T]``: fp32 statistics, output in ``dtype``."""
    return F.group_norm(x.float(), layer.num_groups, layer.weight, layer.bias, layer.eps).to(dtype)


def conv_positions(conv: nn.Conv1d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The grouped conv positional embedding of ``x`` ``[B, T, C]``, in ``dtype``.

    An even kernel gives T+1 outputs and the reference's SamePad trims the
    last one. fp32 runs without TF32, as the JAX package's fp32 does.
    """
    # oneDNN's bf16 grouped conv1d gives wrong sums at some CPU shapes
    # (torch 2.13: 6 input channels per group, K=128); it is not used on CUDA.
    cpu_bf16 = x.device.type == "cpu" and dtype == torch.bfloat16
    onednn = torch.backends.mkldnn.flags(enabled=False) if cpu_bf16 else contextlib.nullcontext()
    with full_fp32(), onednn:
        pos = F.conv1d(
            x.transpose(1, 2).to(dtype), conv.weight.to(dtype), conv.bias.to(dtype),
            padding=conv.padding, groups=conv.groups,
        ).transpose(1, 2)
    if conv.kernel_size[0] % 2 == 0:
        pos = pos[:, :-1, :]
    return pos


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Fold torch ``weight_norm(dim=2)`` into a plain conv weight:
    ``w[:, :, k] = g[0, 0, k] * v[:, :, k] / ||v[:, :, k]||``."""
    norm = np.sqrt(np.sum(np.square(v), axis=(0, 1), keepdims=True))
    return g * v / norm


def _seeded_init(module: nn.Module, seed: int) -> None:
    """Seeded init in the flax defaults' families: weights N(0, 1/fan_in)
    (fan_in = all axes but the first), biases 0, norms 1/0, ``grep_a`` 1;
    an :class:`Int8Linear` gets ``Int8Dense``'s init (zero weights, unit
    scales)."""
    gen = torch.Generator().manual_seed(seed)
    for sub in module.modules():
        if isinstance(sub, Int8Linear):
            sub.reset_buffers()
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("grep_a") or (p.ndim == 1 and "norm" in name and name.endswith("weight")):
                p.fill_(1.0)
            elif p.ndim == 1:
                p.zero_()
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))


def build_module(make: Callable[[], nn.Module], seed: int, device: torch.device) -> nn.Module:
    """``make()`` built without storage, then given CPU memory and the seeded
    init once, moved to ``device`` and put in eval mode."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device="cpu")
    _seeded_init(module, seed)
    return module.to(device).eval()
