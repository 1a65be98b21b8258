"""Attention: CUDA kernel wrappers and their plain twins.

Port of ``avex_tpu/ops/pallas_attention.py``'s four forward kernels, which
compute ``softmax(q·kᵀ·scale + gate ⊙ pos_bias + pad) · v`` (gated) or
``softmax(q·kᵀ·scale + pad) · v`` (bias-free) with fp32 logits and softmax
and P cast to v's type before PV:

- :func:`gated_bias_attention` replaces ``_attention_kernel`` (K1,
  ``pallas_attention.py:126``, launched at ``:272``) and, with
  ``pos_bias=None``, ``_plain_attention_kernel`` (K4, ``:161``, launched at
  ``:261``): split ``[B, H, T, D]`` q/k/v, ``[B, H, T, D]`` out;
- :func:`fused_qkv_gated_attention` replaces ``_fused_qkv_gated_kernel``
  (K2, ``:389``, launched at ``:745``): q/k/v are column views of the raw
  ``[B, T, 3E]`` projection, the output is the merged ``[B, T, E]``;
- :func:`fused_qkv_attention` replaces ``_fused_qkv_kernel`` (K5, ``:344``,
  launched at ``:511``): the bias-free cell in K2's layout.

All four launch the one kernel body in ``csrc/gated_attention.cu``, gated or
bias-free by a template flag; the two layouts differ only in the strides
handed to it. On an H100 at the BEATs and EAT shapes the call is bound by
bytes (see the source's header for the bound and what this first design
does about it).

A tensor on the CPU takes the plain PyTorch twin (``*_reference``); a CUDA
tensor launches the kernel or raises. Each launch adds one to
:data:`LAUNCHES`, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional

import torch

from avex_tpu_torch.ops._build import load_library

__all__ = [
    "LAUNCHES",
    "HEAD_DIM",
    "fused_qkv_attention",
    "fused_qkv_compatible",
    "fused_qkv_gated_attention",
    "fused_qkv_gated_reference",
    "fused_qkv_reference",
    "gated_bias_attention",
    "gated_bias_attention_reference",
    "reset_launch_counts",
]

SOURCE = "gated_attention.cu"
#: The only head width the kernel takes (BEATs, EAT and AVES: 768 / 12).
HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last :func:`reset_launch_counts`, by kernel:
#: K1, K2, K4 (``gated_bias_attention`` with ``pos_bias=None``) and K5
LAUNCHES: Dict[str, int] = {
    "gated_bias_attention": 0,
    "fused_qkv_gated_attention": 0,
    "plain_attention": 0,
    "fused_qkv_attention": 0,
}


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
    if lib.avex_gated_attention_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [i, i, i, i, ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), p]
        lib.avex_gated_attention_forward.argtypes = [i, p, p, p, p, p, p, p, *tail]
        lib.avex_plain_attention_forward.argtypes = [i, p, p, p, p, p, *tail]
        lib.avex_gated_attention_forward.restype = i
        lib.avex_plain_attention_forward.restype = i
    return lib


# ---------------------------------------------------------------------------
# Plain PyTorch twins (the CPU path, and what the kernel is held against)
# ---------------------------------------------------------------------------


def gated_bias_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: Optional[torch.Tensor],
    gate: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Twin of ``_attention_reference`` (``pallas_attention.py:192-204``).

    q and k are upcast to fp32 before QKᵀ (JAX asks for fp32 logits with
    ``preferred_element_type``); the softmax is fp32; P is cast to v's type
    and PV accumulates in fp32 before the result is cast to v's type.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if pos_bias is not None:
        bias = pos_bias[None].float()
        if gate is not None:
            bias = gate[..., None].float() * bias
        logits = logits + bias
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights.float(), v.float()).to(v.dtype)


def _split_heads(qkv: torch.Tensor, heads: int):
    """``[B, T, 3E]`` → q, k, v as ``[B, H, T, D]`` views (``q | k | v``, head-major)."""
    bsz, seq, three_e = qkv.shape
    dim = three_e // 3
    parts = qkv.view(bsz, seq, 3, heads, dim // heads)
    return [parts[:, :, i].permute(0, 2, 1, 3) for i in range(3)]


def fused_qkv_gated_reference(
    qkv: torch.Tensor,
    heads: int,
    pos_bias: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Twin of ``_fused_qkv_gated_reference`` (``pallas_attention.py:679-687``)."""
    bsz, seq, three_e = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    out = gated_bias_attention_reference(q, k, v, pos_bias, gate, key_padding_mask, scale)
    return out.permute(0, 2, 1, 3).reshape(bsz, seq, three_e // 3)


def fused_qkv_reference(
    qkv: torch.Tensor,
    heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Twin of ``_fused_qkv_reference`` (``pallas_attention.py:434-442``)."""
    bsz, seq, three_e = qkv.shape
    q, k, v = _split_heads(qkv, heads)
    out = gated_bias_attention_reference(q, k, v, None, None, key_padding_mask, scale)
    return out.permute(0, 2, 1, 3).reshape(bsz, seq, three_e // 3)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _check_rows(name: str, t: torch.Tensor) -> None:
    """The kernel reads and writes 8-element runs of the head dimension."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: the kernel needs a contiguous head dimension, strides that are "
            f"multiples of 8 elements and a 16-byte aligned start; got strides "
            f"{tuple(t.stride())} at offset {t.data_ptr() % 16} bytes"
        )


def _launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: Optional[torch.Tensor],
    gate: Optional[torch.Tensor],
    key_padding_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    scale: float,
) -> None:
    """Launch the kernel on ``[B, H, T, D]`` views; ``out`` is written in place.

    With ``pos_bias`` the gated variant runs, without it the bias-free one
    (which takes no gate either).
    """
    bsz, heads, seq, dim = q.shape
    if dim != HEAD_DIM:
        raise ValueError(f"the attention kernel takes head_dim {HEAD_DIM}, got {dim}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _check_rows(name, t)
    if pos_bias is None and gate is not None:
        raise ValueError("a gate needs a pos_bias to modulate")
    if pos_bias is not None and (pos_bias.shape != (heads, seq, seq) or pos_bias.dtype != torch.float32):
        raise ValueError(f"pos_bias must be float32 [{heads}, {seq}, {seq}], got "
                         f"{pos_bias.dtype} {tuple(pos_bias.shape)}")
    if gate is not None and (gate.shape != (bsz, heads, seq) or gate.dtype != torch.float32):
        raise ValueError(f"gate must be float32 [{bsz}, {heads}, {seq}], got "
                         f"{gate.dtype} {tuple(gate.shape)}")
    if key_padding_mask is not None and (
        key_padding_mask.shape != (bsz, seq) or key_padding_mask.dtype != torch.bool
    ):
        raise ValueError(f"key_padding_mask must be bool [{bsz}, {seq}]")
    for t in (pos_bias, gate, key_padding_mask):
        if t is not None and t.device != q.device:
            raise ValueError("every operand must lie on q's device")

    pad_strides = key_padding_mask.stride() if key_padding_mask is not None else (0, 0)
    pad_ptr = key_padding_mask.data_ptr() if key_padding_mask is not None else None
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        head = (_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr())
        tail = (bsz, heads, seq, dim, float(scale))
        views = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
        if pos_bias is None:
            strides = (ctypes.c_longlong * 14)(*views, *pad_strides)
            err = lib.avex_plain_attention_forward(
                *head, pad_ptr, out.data_ptr(), *tail, strides, stream
            )
        else:
            gate_strides = gate.stride() if gate is not None else (0, 0, 0)
            strides = (ctypes.c_longlong * 22)(*views, *pos_bias.stride(), *gate_strides, *pad_strides)
            err = lib.avex_gated_attention_forward(
                *head, pos_bias.data_ptr(), gate.data_ptr() if gate is not None else None,
                pad_ptr, out.data_ptr(), *tail, strides, stream,
            )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")


def _kernel_split(q, k, v, pos_bias, gate, key_padding_mask, scale) -> torch.Tensor:
    bsz, heads, seq, dim = q.shape
    # Written as [B, T, H, D] and returned as a [B, H, T, D] view: the caller's
    # head merge back to [B, T, E] is then free.
    out = torch.empty(bsz, seq, heads, dim, dtype=v.dtype, device=v.device).permute(0, 2, 1, 3)
    _launch(q, k, v, pos_bias, gate, key_padding_mask, out, scale)
    _count("gated_bias_attention" if pos_bias is not None else "plain_attention")
    return out


def _kernel_fused(qkv, heads, pos_bias, gate, key_padding_mask, scale) -> torch.Tensor:
    bsz, seq, three_e = qkv.shape
    dim = three_e // 3
    q, k, v = _split_heads(qkv, heads)
    out = torch.empty(bsz, seq, dim, dtype=qkv.dtype, device=qkv.device)
    _launch(q, k, v, pos_bias, gate, key_padding_mask,
            out.view(bsz, seq, heads, dim // heads).permute(0, 2, 1, 3), scale)
    _count("fused_qkv_gated_attention" if pos_bias is not None else "fused_qkv_attention")
    return out


def _forward_only(name: str, backward: str, number: str, tensors) -> None:
    """The fused-layout kernels have no backward yet: refuse a tensor that needs one."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} is forward-only on CUDA: its backward kernel ({backward}) is "
            f"ROADMAP queue 2, {number}"
        )


class _GatedBiasAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain twin (CPU). Backward: the plain
    twin recomputed under autograd, as JAX's ``_bwd`` (``:297-338``) is jnp."""

    @staticmethod
    def forward(ctx, q, k, v, pos_bias, gate, key_padding_mask, scale):
        ctx.save_for_backward(q, k, v, pos_bias, gate, key_padding_mask)
        ctx.scale = scale
        if q.device.type == "cpu":
            return gated_bias_attention_reference(q, k, v, pos_bias, gate, key_padding_mask, scale)
        return _kernel_split(q, k, v, pos_bias, gate, key_padding_mask, scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, pos_bias, gate, key_padding_mask = ctx.saved_tensors
        inputs = (q, k, v, pos_bias, gate)
        wanted = [
            t is not None and need for t, need in zip(inputs, ctx.needs_input_grad[:5])
        ]
        with torch.enable_grad():
            leaves = [
                t.detach().requires_grad_(w) if t is not None else None
                for t, w in zip(inputs, wanted)
            ]
            out = gated_bias_attention_reference(*leaves, key_padding_mask, ctx.scale)
            targets = [t for t, w in zip(leaves, wanted) if w]
            grads = iter(torch.autograd.grad(out, targets, grad_out) if targets else ())
        return (*(next(grads) if w else None for w in wanted), None, None)


def gated_bias_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: Optional[torch.Tensor],
    gate: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``softmax(q·kᵀ·scale + gate ⊙ pos_bias + pad) · v`` (K1), or with
    ``pos_bias=None`` the bias-free ``softmax(q·kᵀ·scale + pad) · v`` (K4).

    Args:
        q, k, v: ``[B, H, T, D]``; any strides with a contiguous head dimension.
        pos_bias: shared ``[H, T, T]`` float32 bias, or None (bias-free).
        gate: per-query ``[B, H, T]`` float32 gate, or None (always None
            without ``pos_bias``).
        key_padding_mask: ``[B, T]`` bool, True = padded key.
        scale: logit scale, default ``1/sqrt(D)``.

    Returns ``[B, H, T, D]`` in v's type. Differentiable; the backward is the
    plain twin's.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _GatedBiasAttention.apply(q, k, v, pos_bias, gate, key_padding_mask, scale)


def fused_qkv_compatible(dim: int, heads: int) -> bool:
    """True when the kernel takes this projection's heads (``dim / heads == 64``).

    The JAX rule (128-lane head groups) is a Mosaic layout rule with no
    Hopper counterpart; here the only constraint is the kernel's head width.
    """
    return heads > 0 and dim % heads == 0 and dim // heads == HEAD_DIM


def fused_qkv_gated_attention(
    qkv: torch.Tensor,
    heads: int,
    pos_bias: torch.Tensor,
    gate: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gated-bias attention over the raw ``[B, T, 3E]`` projection (K2).

    q, k and v are read as column views (``q | k | v``, each head-major) and
    the output is written as merged heads, ``[B, T, E]``. ``pos_bias`` is
    required: bias-free attention in this layout is
    :func:`fused_qkv_attention` (K5). Forward only: on a CUDA tensor that
    requires grad it raises, since the backward kernel
    (``_fused_qkv_gated_bwd_kernel``, ROADMAP queue 2: K3) is not ported yet.
    """
    if pos_bias is None:
        raise ValueError("fused_qkv_gated_attention needs a pos_bias; use fused_qkv_attention without one")
    dim = qkv.shape[-1] // 3
    scale = scale if scale is not None else 1.0 / math.sqrt(dim // heads)
    if qkv.device.type == "cpu":
        return fused_qkv_gated_reference(qkv, heads, pos_bias, gate, key_padding_mask, scale)
    _forward_only("fused_qkv_gated_attention", "_fused_qkv_gated_bwd_kernel", "K3", (qkv, pos_bias, gate))
    return _kernel_fused(qkv, heads, pos_bias, gate, key_padding_mask, scale)


def fused_qkv_attention(
    qkv: torch.Tensor,
    heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Bias-free attention over the raw ``[B, T, 3E]`` projection (K5).

    q, k and v are read as column views (``q | k | v``, each head-major) and
    the output is written as merged heads, ``[B, T, E]``. ``key_padding_mask``
    is ``[B, T]`` bool, True = padded key. On the CPU the plain twin runs and
    is differentiable. On CUDA the kernel is forward only: a tensor that
    requires grad raises, since the backward kernel (``_fused_qkv_bwd_kernel``,
    ROADMAP queue 2: K6) is not ported yet.
    """
    dim = qkv.shape[-1] // 3
    scale = scale if scale is not None else 1.0 / math.sqrt(dim // heads)
    if qkv.device.type == "cpu":
        return fused_qkv_reference(qkv, heads, key_padding_mask, scale)
    _forward_only("fused_qkv_attention", "_fused_qkv_bwd_kernel", "K6", (qkv,))
    return _kernel_fused(qkv, heads, None, None, key_padding_mask, scale)
