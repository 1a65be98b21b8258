"""Building blocks the port's models share (BEATs, EAT, AVES, the CNNs).

- the flax dtype policy: ``dense`` casts input, weight and bias to the
  compute dtype (an ``Int8Linear`` runs as it is: its int8 weight is never
  cast); ``layer_norm`` / ``group_norm`` take fp32 statistics and return
  the compute dtype;
- the exact (erf) GELU;
- ``conv_positions``: the grouped Conv1d positional embedding of BEATs and
  AVES, with the even-kernel trim;
- ``conv2d``: a conv in the compute dtype with torchvision's symmetric or
  TF "SAME" padding (``same_padding``);
- ``batch_norm``: flax ``BatchNorm(momentum=0.9)`` on an ``nn.BatchNorm2d``
  (torchvision's names and buffers): batch statistics and a running update
  with the biased variance in training, the running statistics in eval;
  in a multi-rank step the statistics are the global batch's;
- ``dropout`` (flax ``nn.Dropout``, drawing from a caller's generator) and
  ``checkpoint_layer`` (per-layer gradient checkpointing that replays the
  layer's draws on recompute, keeping nothing or, with ``"dots"``, the
  dense layers' products);
- the weight-norm fold of the reference checkpoints' pos_conv;
- ``config_from_dict``: an ``init_config`` dict → a config dataclass;
- ``build_module``: construct a module without storage, give it CPU memory
  and a seeded init, then move it to its device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Callable, Mapping, Optional, Type, TypeVar

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from avex_tpu_torch.ops._precision import full_fp32
from avex_tpu_torch.parallel import all_reduce_sum, batch_mesh
from avex_tpu_torch.parallel.tensor import column_rows, linear_bias, row_parallel_dense
from avex_tpu_torch.quant import Int8Linear

__all__ = [
    "batch_norm",
    "build_module",
    "conv2d",
    "checkpoint_layer",
    "config_from_dict",
    "conv_positions",
    "dense",
    "dropout",
    "fold_weight_norm",
    "gelu",
    "group_norm",
    "layer_norm",
    "same_padding",
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
    A layer cut over the model axis (``parallel/tensor.py``) computes its
    part: a column-parallel one its block of output features (and bias), a
    row-parallel one its partial sum, completed over the axis.
    """
    if isinstance(layer, Int8Linear):
        return layer(x)
    if getattr(layer, "tp_axis", None) is not None:
        return row_parallel_dense(layer, x, dtype)
    bias = linear_bias(layer)
    bias = bias.to(dtype) if bias is not None else None
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def dropout(
    x: torch.Tensor, rate: float, deterministic: bool, generator: Optional[torch.Generator],
    columns: Optional[nn.Linear] = None,
) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    and scale it by ``1 / (1 - rate)``, in x's type; the identity when
    ``deterministic`` or ``rate == 0``. The draws come from ``generator``,
    never from the global RNG. ``columns``: the layer whose output ``x`` is;
    cut column-parallel (``parallel/tensor.py``), the draw is the whole
    output's and ``x`` takes its block of it, so every rank of the model
    axis draws what one process draws."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout outside deterministic mode needs a torch.Generator")
    keep_prob = 1.0 - rate
    rows = column_rows(columns) if columns is not None else None
    if rows is not None:
        draw = torch.rand(x.shape[:-1] + (columns.out_features,), generator=generator, device=x.device)
        keep = draw[..., rows] < keep_prob
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


#: the dense layers' products: what ``remat_policy="dots"`` keeps (JAX's
#: ``dots_with_no_batch_dims_saveable``: products without batch dimensions;
#: attention's batched products and kernels are recomputed)
_DENSE_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dense_products(ctx: Any, op: Any, *args: Any, **kwargs: Any) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DENSE_PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_layer(layer: Callable, generator: Optional[torch.Generator], *args: Any,
                     policy: Optional[str] = None) -> Any:
    """``layer(*args, generator)`` under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward pass.

    ``policy`` None or ``"nothing"`` keeps nothing of the layer; ``"dots"``
    keeps the outputs of its dense layers' products (``aten.mm`` /
    ``aten.addmm``, through ``create_selective_checkpoint_contexts``) and
    recomputes everything else, attention kernels included.

    The checkpoint restores the global RNG for the recompute but not a
    caller's generator, so this wrapper does: the recompute starts from the
    generator state the forward started from and draws the same dropout
    masks, and the generator is put back afterwards.
    """
    if policy not in (None, "nothing", "dots"):
        raise ValueError(f"Unknown remat_policy {policy!r} (None, 'nothing', 'dots')")
    start = generator.get_state() if generator is not None else None
    calls = []

    def run(*inputs: Any) -> Any:
        if calls and generator is not None:  # the recompute
            now = generator.get_state()
            generator.set_state(start)
            try:
                return layer(*inputs, generator)
            finally:
                generator.set_state(now)
        calls.append(1)
        return layer(*inputs, generator)

    if policy == "dots":
        return checkpoint(run, *args, use_reentrant=False,
                          context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dense_products))
    return checkpoint(run, *args, use_reentrant=False)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: fp32 statistics, output in ``dtype``."""
    return F.layer_norm(x.float(), layer.normalized_shape, layer.weight, layer.bias, layer.eps).to(dtype)


def batch_norm(layer: nn.BatchNorm2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``BatchNorm(momentum=0.9, dtype=...)`` on ``[B, C, H, W]``.

    In training (``layer.training``) the batch's fp32 mean and biased
    variance normalise it, and the running statistics move as
    ``r ← 0.9·r + 0.1·s``, ``s`` the biased variance (torch's own module
    would take the unbiased one); in eval the running statistics normalise.
    The normalisation runs in fp32 and returns ``dtype``.

    Inside a multi-rank :func:`~avex_tpu_torch.parallel.global_batch` the
    statistics are those of the global batch, as flax's over a data-sharded
    batch: the per-channel count, sum and sum of squares are summed over the
    ranks (with their gradient), and the variance is flax's
    ``E[x²] - E[x]²``; the running update is then the same on every rank.
    """
    x = x.to(dtype)
    if not layer.training:
        return F.batch_norm(x, layer.running_mean, layer.running_var, layer.weight, layer.bias,
                            False, 0.0, layer.eps)
    mesh = batch_mesh()
    if mesh is None:
        out, mean, invstd = torch.native_batch_norm(x, layer.weight, layer.bias, None, None, True, 0.0,
                                                    layer.eps)
        with torch.no_grad():
            var = invstd.reciprocal().square() - layer.eps
    else:
        xf = x.float()
        count = torch.full((1,), float(xf.numel() // xf.shape[1]), device=x.device)
        sums = all_reduce_sum(torch.cat([xf.sum((0, 2, 3)), xf.square().sum((0, 2, 3)), count]), mesh)
        channels = xf.shape[1]
        mean, mean_sq = sums[:channels] / sums[-1], sums[channels:2 * channels] / sums[-1]
        var = torch.clamp_min(mean_sq - mean.square(), 0.0)
        scale = torch.rsqrt(var + layer.eps) * layer.weight
        out = ((xf - mean[:, None, None]) * scale[:, None, None] + layer.bias[:, None, None]).to(dtype)
    with torch.no_grad():
        layer.running_mean.mul_(0.9).add_(0.1 * mean)
        layer.running_var.mul_(0.9).add_(0.1 * var)
    return out


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/Keras "SAME" padding of one axis: the total is ``max(k - (size mod
    s or s), 0)``, the extra one at the end."""
    rem = size % stride
    total = max(kernel - (rem if rem else stride), 0)
    return total // 2, total - total // 2


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype, tf_same: bool = False) -> torch.Tensor:
    """``conv`` on ``x`` in ``dtype`` (input, kernel and bias cast, flax's
    policy), with torchvision's symmetric ``(k - 1) // 2`` padding or TF
    "SAME" padding (``F.pad`` before the conv)."""
    k, s = conv.kernel_size[0], conv.stride[0]
    x = x.to(dtype)
    pad = (k - 1) // 2
    if tf_same:
        top, bottom = same_padding(x.shape[2], k, s)
        left, right = same_padding(x.shape[3], k, s)
        if (top, bottom, left, right) != (0, 0, 0, 0):
            x = F.pad(x, (left, right, top, bottom))
        pad = 0
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    return F.conv2d(x, conv.weight.to(dtype), bias, s, pad, 1, conv.groups)


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


def split_stacked(tree: Mapping[str, Any]) -> list:
    """A JAX ``nn.scan`` parameter tree (every leaf with a leading layer axis)
    → the per-layer trees, in order."""
    def leaves(node):
        return [leaf for v in node.values() for leaf in (leaves(v) if isinstance(v, Mapping) else [v])]

    def take(node, i):
        return {k: take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i] for k, v in node.items()}

    return [take(tree, i) for i in range(np.shape(leaves(tree)[0])[0])]


def unstack_state(state: Mapping[str, Any], stack: str) -> dict:
    """A port state dict in the stacked layout (``{stack}.<name>``, leading
    layer axis) → the per-layer one (``{stack}.{i}.<name>``); other keys as
    they are."""
    out = {}
    for key, value in state.items():
        if key.startswith(stack + ".") and not key[len(stack) + 1:].split(".", 1)[0].isdigit():
            for i, layer in enumerate(np.asarray(value)):
                out[f"{stack}.{i}.{key[len(stack) + 1:]}"] = layer
        else:
            out[key] = value
    return out


def stack_state(state: Mapping[str, Any], stack: str) -> dict:
    """The per-layer port state dict → the stacked one (JAX's ``scan_layers``
    layout at the edges: ``{stack}.<name>`` with a leading layer axis)."""
    out, layers = {}, {}
    for key, value in state.items():
        rest = key[len(stack) + 1:] if key.startswith(stack + ".") else ""
        index, _, name = rest.partition(".")
        if index.isdigit() and name:
            layers.setdefault(name, {})[int(index)] = np.asarray(value)
        else:
            out[key] = value
    for name, per_layer in layers.items():
        out[f"{stack}.{name}"] = np.stack([per_layer[i] for i in range(len(per_layer))])
    return out


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Fold torch ``weight_norm(dim=2)`` into a plain conv weight:
    ``w[:, :, k] = g[0, 0, k] * v[:, :, k] / ||v[:, :, k]||``."""
    norm = np.sqrt(np.sum(np.square(v), axis=(0, 1), keepdims=True))
    return g * v / norm


def _seeded_init(module: nn.Module, seed: int) -> None:
    """Seeded init in the flax defaults' families: weights N(0, 1/fan_in)
    (fan_in = all axes but the first), biases and scalars 0, norms 1/0,
    ``grep_a`` 1;
    an :class:`Int8Linear` gets ``Int8Dense``'s init (zero weights, unit
    scales); a module's constant buffers (the fbank's) are refilled; a
    BatchNorm scale 1, shift 0, running mean 0 and variance 1."""
    gen = torch.Generator().manual_seed(seed)
    for sub in module.modules():
        if callable(getattr(sub, "reset_buffers", None)):  # Int8Linear, KaldiFbank
            sub.reset_buffers()
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("grep_a") or (p.ndim == 1 and "norm" in name and name.endswith("weight")):
                p.fill_(1.0)
            elif p.ndim <= 1:
                p.zero_()
            else:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
    for sub in module.modules():
        if isinstance(sub, nn.modules.batchnorm._BatchNorm):
            sub.reset_parameters()


def build_module(make: Callable[[], nn.Module], seed: int, device: torch.device) -> nn.Module:
    """``make()`` built without storage, then given CPU memory and the seeded
    init once, moved to ``device`` and put in eval mode."""
    with torch.device("meta"):
        module = make()
    module = module.to_empty(device="cpu")
    _seeded_init(module, seed)
    return module.to(device).eval()
