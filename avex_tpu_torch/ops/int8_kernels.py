"""Int8 (W8A8) dense: CUDA kernel wrappers and their plain twins.

Port of ``avex_tpu/ops/pallas_int8.py``:

- :func:`int8_dynamic_dense` replaces ``_dyn_kernel`` (K7,
  ``pallas_int8.py:100``, launched at ``:177``): each row of a float ``x`` is
  quantized to int8 with its own scale ``max(|x|, 1e-8) / 127`` (fp32, round
  half to even, clip ±127), contracted against an int8 weight with int32
  sums, and rescaled by ``row_scale * col_scale`` (plus an fp32 bias) into
  the output type. On CUDA that is two kernels: the row quantization, once
  per row, into scratch (``xq``, ``row_scale``), then the scaled product on
  ``wgmma``;
- :func:`int8_matmul` replaces ``_mm_kernel`` (K8, ``pallas_int8.py:46``,
  launched at ``:79``): the exact ``s8[M, K] × s8[K, N] → s32[M, N]``.

Both live in ``csrc/int8_dense.cu``. The weight of
:func:`int8_dynamic_dense` is in torch's Linear layout ``[N, K]`` (the
JAX kernel takes ``[K, N]``), K-major as 8-bit ``wgmma`` takes it;
:func:`int8_matmul` keeps JAX's ``[K, N]`` and ``mma.sync``.

A tensor on the CPU takes the plain PyTorch twin (``*_reference``); a CUDA
tensor launches the kernel or raises. Each launch adds one to
:data:`LAUNCHES`. The twins compute the int32 product as a float64 matmul of
the int8 values (exact while a sum stays below 2**53; CUDA has no int32
matmul), so they run the same code on the CPU and on the card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from avex_tpu_torch.ops._build import load_library

__all__ = [
    "LAUNCHES",
    "int8_dynamic_dense",
    "int8_dynamic_dense_reference",
    "int8_matmul",
    "int8_matmul_reference",
    "quantize_rows",
    "reset_launch_counts",
    "scaled_product_reference",
]

SOURCE = "int8_dense.cu"
EPS = 1e-8
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last :func:`reset_launch_counts`: K7 and K8
LAUNCHES: Dict[str, int] = {"int8_dynamic_dense": 0, "int8_matmul": 0}


_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    """Set every launch count in :data:`LAUNCHES` to 0."""
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _count(name: str) -> None:
    # Served models launch from one batcher thread each: += is not atomic.
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if lib.avex_int8_scaled_product.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.avex_int8_quantize_rows.argtypes = [i, p, p, p, i, i, p]
        lib.avex_int8_scaled_product.argtypes = [i, p, p, p, p, p, p, i, i, i, p]
        lib.avex_int8_matmul.argtypes = [p, p, p, i, i, i, p]
        lib.avex_int8_quantize_rows.restype = i
        lib.avex_int8_scaled_product.restype = i
        lib.avex_int8_matmul.restype = i
    return lib


# ---------------------------------------------------------------------------
# Plain PyTorch twins (the CPU path, and what the kernels are held against)
# ---------------------------------------------------------------------------


def _int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b`` of int8-valued tensors as int32, through float64."""
    return torch.matmul(a.double(), b.double()).to(torch.int32)


def int8_matmul_reference(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Twin of ``int8_matmul``: ``s8[M, K] × s8[K, N] → s32[M, N]``, exact."""
    return _int_product(xq, wq)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's activation quantization of ``x`` ``[..., K]``, in fp32.

    The row scale is ``max(|x|, 1e-8) / 127``, a division by a tensor (CUDA
    turns a division by a Python scalar into a product with its reciprocal,
    which rounds differently); ``x / row_scale`` is rounded half to even and
    clipped to ±127. Returns ``(levels [..., K], row_scale [..., 1])``, the
    levels as integer-valued float32.
    """
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    row_scale = amax.clamp_min(EPS) / torch.full_like(amax, 127.0)
    return torch.round(xf / row_scale).clamp(-127, 127), row_scale


def scaled_product_reference(
    xq: torch.Tensor,
    row_scale: torch.Tensor,
    weight_q: torch.Tensor,
    weight_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Twin of K7's second kernel: ``xq`` int8 ``[M, K]`` and ``row_scale``
    float32 ``[M]`` (the row quantization's output) against ``weight_q``
    int8 ``[N, K]``, exact int32 sums, then ``(float)acc * (row_scale *
    weight_scale)`` (+ bias) in fp32, cast to ``out_dtype``."""
    acc = _int_product(xq, weight_q.t())
    out = acc.float() * (row_scale[:, None] * weight_scale.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def int8_dynamic_dense_reference(
    x: torch.Tensor,
    weight_q: torch.Tensor,
    weight_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Twin of ``dynamic_int8_matmul`` (``avex_tpu/quant/__init__.py:84-113``)
    with the weight in Linear layout.

    ``x``: ``[..., K]`` float; ``weight_q``: int8 ``[N, K]``;
    ``weight_scale``: ``[N]``; ``bias``: ``[N]`` or None. ``x`` is quantized
    by :func:`quantize_rows`. The bias is added in fp32 before the cast to
    ``out_dtype`` (default: x's type). All-zero rows give zero rows.
    """
    out_dtype = out_dtype or x.dtype
    xq, row_scale = quantize_rows(x)
    acc = _int_product(xq, weight_q.t())
    out = acc.float() * (row_scale * weight_scale.float())
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(
            f"{name} must be {dtype} {list(shape)} on {device}, got {t.dtype} {list(t.shape)} on {t.device}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_depth(k: int) -> None:
    if k % 32:
        raise ValueError(f"the int8 kernel needs K (the contraction width) to be a multiple of 32, got K={k}")


def _inference_only(name: str, x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(f"{name} is inference-only on CUDA: the int8 path has no backward")


def _quantize_rows_kernel(x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's first kernel on a CUDA ``[M, K]`` x: ``(xq int8 [M, K], row_scale
    float32 [M])``, the levels and scales of :func:`quantize_rows`."""
    m, k = x2.shape
    xq = torch.empty(m, k, dtype=torch.int8, device=x2.device)
    row_scale = torch.empty(m, dtype=torch.float32, device=x2.device)
    with torch.cuda.device(x2.device):
        stream = torch.cuda.current_stream(x2.device).cuda_stream
        err = _library().avex_int8_quantize_rows(_DTYPE_CODES[x2.dtype], x2.data_ptr(), xq.data_ptr(),
                                                 row_scale.data_ptr(), m, k, stream)
    if err != 0:
        raise RuntimeError(f"int8 row quantization launch failed at M={m}, K={k}: CUDA error {err}")
    return xq, row_scale


def _scaled_product_kernel(xq, row_scale, weight_q, weight_scale, bias, out_dtype) -> torch.Tensor:
    """K7's second kernel: ``(xq · weight_qᵀ) * (row_scale * weight_scale)
    (+ bias)`` on ``wgmma``, ``[M, N]`` in ``out_dtype``."""
    (m, k), n = xq.shape, weight_q.shape[0]
    out = torch.empty(m, n, dtype=out_dtype, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = _library().avex_int8_scaled_product(
            _DTYPE_CODES[out_dtype], xq.data_ptr(), row_scale.data_ptr(), weight_q.data_ptr(),
            weight_scale.data_ptr(), bias.data_ptr() if bias is not None else None, out.data_ptr(), m, n, k, stream,
        )
    if err != 0:
        raise RuntimeError(f"int8 scaled product launch failed at M={m}, N={n}, K={k}: CUDA error {err}")
    return out


def int8_dynamic_dense(
    x: torch.Tensor,
    weight_q: torch.Tensor,
    weight_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """W8A8 dense with dynamic activation quantization (K7).

    Args:
        x: ``[..., K]`` float32 or bfloat16; K a multiple of 32 on CUDA.
        weight_q: int8 ``[N, K]`` (Linear layout).
        weight_scale: float32 ``[N]`` per-output-channel scales.
        bias: float32 ``[N]``, or None.
        out_dtype: float32 or bfloat16; default x's type.

    Returns ``[..., N]`` in ``out_dtype``. On the CPU the plain twin runs; on
    CUDA the two kernels do (the row quantization, then the scaled product),
    inference-only, and the output equals the twin's bit for bit.
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_dynamic_dense_reference(x, weight_q, weight_scale, bias, out_dtype)
    _inference_only("int8_dynamic_dense", x)
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_dynamic_dense takes float32 or bfloat16 x and output, got {x.dtype} -> {out_dtype}")
    lead, k = x.shape[:-1], x.shape[-1]
    n = weight_q.shape[0]
    _check_depth(k)
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    _check_operand("x", x2, x.dtype, (m, k), x.device)
    _check_operand("weight_q", weight_q, torch.int8, (n, k), x.device)
    _check_operand("weight_scale", weight_scale, torch.float32, (n,), x.device)
    if bias is not None:
        _check_operand("bias", bias, torch.float32, (n,), x.device)
    xq, row_scale = _quantize_rows_kernel(x2)
    out = _scaled_product_kernel(xq, row_scale, weight_q, weight_scale, bias, out_dtype)
    _count("int8_dynamic_dense")
    return out.view(*lead, n)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``s8[M, K] × s8[K, N] → s32[M, N]``, exact (K8).

    On CUDA, K must be a multiple of 32 and N of 16, and both operands
    contiguous. On the CPU the plain twin runs.
    """
    if xq.device.type == "cpu":
        return int8_matmul_reference(xq, wq)
    (m, k), n = xq.shape, wq.shape[-1]
    _check_depth(k)
    if n % 16:
        raise ValueError(f"int8_matmul needs N to be a multiple of 16, got N={n}")
    _check_operand("xq", xq, torch.int8, (m, k), xq.device)
    _check_operand("wq", wq, torch.int8, (k, n), xq.device)
    out = torch.empty(m, n, dtype=torch.int32, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = _library().avex_int8_matmul(xq.data_ptr(), wq.data_ptr(), out.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed at M={m}, N={n}, K={k}: CUDA error {err}")
    _count("int8_matmul")
    return out
