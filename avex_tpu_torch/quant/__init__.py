"""Post-training int8 quantization (W8A8) for inference on the GPU.

Port of ``avex_tpu/quant/__init__.py``. The scheme is the JAX package's:

- **Weights**: symmetric per-output-channel int8,
  ``scale[n] = max(max_k |w[n, k]|, 1e-8) / 127``, folded offline by
  :func:`quantize_params`, which swaps a module tree's Linears for
  :class:`Int8Linear` in place.
- **Activations**: dynamic symmetric per-row int8, computed in fp32.
- **Accumulation**: int32, rescaled once by ``row_scale * col_scale``; the
  bias is added in fp32 before the cast to the compute type.

:class:`Int8Linear` holds the quantized layer. On CUDA it runs the K7 kernel
(``avex_tpu_torch.ops.int8_kernels.int8_dynamic_dense``); on the CPU its
plain twin, :func:`dynamic_int8_matmul`. Quantized models are inference-only.
Weights are in torch's Linear layout ``[N, K]`` (the JAX package's kernels
are ``[K, N]``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from avex_tpu_torch.ops.int8_kernels import int8_dynamic_dense, quantize_rows
from avex_tpu_torch.ops.int8_kernels import int8_dynamic_dense_reference as dynamic_int8_matmul

__all__ = [
    "QUANT_FIELDS",
    "Int8Linear",
    "dense_path_matcher",
    "dynamic_int8_matmul",
    "int8_error_report",
    "quantize_kernel",
    "quantize_params",
]

#: State-dict fields that mark a quantized Linear (an Int8Linear's buffers).
QUANT_FIELDS = ("weight_q", "weight_scale")

Path = Tuple[str, ...]


def _tensor(value: Any) -> torch.Tensor:
    """A tensor as it is; anything else (numpy, read-only JAX buffers) copied."""
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))


def quantize_kernel(weight: Union[torch.Tensor, np.ndarray]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a Linear weight.

    ``weight`` is ``[..., N, K]``; each output channel ``n`` gets
    ``scale = max(max_k |w|, 1e-8) / 127`` (an IEEE division, as in the JAX
    package) and ``q = clip(round_half_even(w / scale), -127, 127)``: the
    arithmetic of the activations' per-row quantization, over each row of
    ``w``. Returns ``(q int8 [..., N, K], scale float32 [..., N])``.
    """
    q, scale = quantize_rows(_tensor(weight))
    return q.to(torch.int8), scale.squeeze(-1)


class Int8Linear(nn.Module):
    """``nn.Linear``'s int8 counterpart (``Int8Dense`` in the JAX package).

    Buffers, no parameters: ``weight_q`` int8 ``[N, K]``, ``weight_scale``
    float32 ``[N]`` and, with ``bias=True``, ``bias`` float32 ``[N]``. The
    output is in ``dtype`` (the model's compute type). Built empty (zero
    weights, unit scales, as ``Int8Dense``'s init); :meth:`from_linear`
    quantizes a float layer.
    """

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features) if bias else None)

    def reset_buffers(self) -> None:
        """Zero weights, unit scales and zero bias (the state after ``__init__``)."""
        with torch.no_grad():
            self.weight_q.zero_()
            self.weight_scale.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    @classmethod
    def from_linear(cls, linear: nn.Linear, dtype: torch.dtype = torch.float32) -> "Int8Linear":
        """Quantize ``linear`` on its own device."""
        layer = cls(linear.in_features, linear.out_features, linear.bias is not None, dtype)
        q, scale = quantize_kernel(linear.weight.detach())
        layer.weight_q, layer.weight_scale = q, scale
        if linear.bias is not None:
            layer.bias = linear.bias.detach().float().clone()
        return layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dynamic_dense(x, self.weight_q, self.weight_scale, self.bias, out_dtype=self.dtype)

    def extra_repr(self) -> str:
        return f"in_features={self.in_features}, out_features={self.out_features}, dtype={self.dtype}"


def quantize_params(
    module: nn.Module,
    *,
    include: Callable[[Path], bool],
    dtype: torch.dtype = torch.float32,
) -> nn.Module:
    """Replace every ``nn.Linear`` whose dotted path (a tuple of names) passes
    ``include`` by an :class:`Int8Linear` of the same name, with output type
    ``dtype``; the module's state dict then holds ``<path>.weight_q``,
    ``<path>.weight_scale`` and a float32 ``<path>.bias`` there. Changes the
    tree in place and returns it (the JAX package's walks a param pytree)."""
    targets = [
        name for name, sub in module.named_modules()
        if isinstance(sub, nn.Linear) and include(tuple(name.split(".")))
    ]
    for name in targets:
        parent_name, _, child = name.rpartition(".")
        parent = module.get_submodule(parent_name)
        setattr(parent, child, Int8Linear.from_linear(getattr(parent, child), dtype))
    return module


def dense_path_matcher(substrings: Sequence[str]) -> Callable[[Path], bool]:
    """Predicate matching paths whose final component is in ``substrings``."""
    targets = frozenset(substrings)
    return lambda path: bool(path) and path[-1] in targets


def int8_error_report(fp_out: Any, q_out: Any) -> Dict[str, float]:
    """Relative L2 and max-abs error between float and quantized outputs."""
    fp, q = (_tensor(a).detach().double().cpu().numpy() for a in (fp_out, q_out))
    denom = float(np.linalg.norm(fp)) or 1.0
    return {"rel_l2": float(np.linalg.norm(q - fp)) / denom, "max_abs": float(np.max(np.abs(q - fp)))}
