"""Attention: CUDA kernel wrappers and their plain twins.

Port of ``avex_tpu/ops/pallas_attention.py``'s four forward kernels, which
compute ``softmax(q·kᵀ·scale + gate ⊙ pos_bias + pad) · v`` (gated) or
``softmax(q·kᵀ·scale + pad) · v`` (bias-free) with fp32 logits and softmax
and P cast to v's type before PV, and of its two backward kernels:

- :func:`gated_bias_attention` replaces ``_attention_kernel`` (K1,
  ``pallas_attention.py:126``, launched at ``:272``) and, with
  ``pos_bias=None``, ``_plain_attention_kernel`` (K4, ``:161``, launched at
  ``:261``): split ``[B, H, T, D]`` q/k/v, ``[B, H, T, D]`` out; its backward
  is the plain twin under autograd, as JAX's ``_bwd`` (``:297-338``) is jnp;
- :func:`fused_qkv_gated_attention` replaces ``_fused_qkv_gated_kernel``
  (K2, ``:389``, launched at ``:745``): q/k/v are column views of the raw
  ``[B, T, 3E]`` projection, the output is the merged ``[B, T, E]``; its
  backward replaces ``_fused_qkv_gated_bwd_kernel`` (K3, ``:765``, launched
  at ``:902``);
- :func:`fused_qkv_attention` replaces ``_fused_qkv_kernel`` (K5, ``:344``,
  launched at ``:511``): the bias-free cell in K2's layout; its backward
  replaces ``_fused_qkv_bwd_kernel`` (K6, ``:524``, launched at ``:631``).

Two CUDA sources carry them, chosen by type by one rule,
:func:`kernel_body` (a plan, not a fallback): every bf16 call,
forward (K1, K2, K4, K5) or backward (K3, K6), launches the tensor-core
kernels of ``csrc/tensor_core_attention.cu``, whose fused forwards also
write the row log-sum-exp and the output's rounding rest when a backward
will follow, so that the backward rebuilds P from the one and takes Δ from
the forward's output and the other. Every fp32 call, forward or backward,
at every head width, runs on the tensor cores in 3xTF32
(``csrc/tf32x3_attention.cu``),
and each fused fp32 forward writes the row log-sum-exp for the backward.
Each source is gated or bias-free by a template flag. Every
kernel, gated or not, takes any head width D >= 1 (:func:`width_plan`).
Each source is built once for each width of :data:`KERNEL_WIDTHS` (its
``-DAVEX_HEAD_DIM``). Up to :data:`CHUNK_COLUMNS` a call runs on the
smallest build that holds D, the extra columns zero-filled on load and
never stored; past it D is cut into column chunks of a multiple of 8 and
the logits are summed over every chunk. A call whose D or strides are not
multiples of 8, or whose operands start off a 16-byte boundary, moves them
element by element (narrow rows, :func:`_narrow`); the wrapper never copies
an operand to pad it. The two layouts differ only in the
strides handed to the kernels. Each source's header states its bounds on an
H100 and what its design does about them.

A tensor on the CPU takes the plain PyTorch twin (``*_reference``, and
autograd through it); a CUDA tensor launches the kernel or raises, forward
and backward (a backward whose forward saved no log-sum-exp raises). Each
launch adds one to :data:`LAUNCHES`, so a run can show that its path went
through the kernel. The backward twins
(``*_backward_reference``) write K3's and K6's steps out one by one; the
tests and ``chip_smoke.py`` hold the kernels against them.
:func:`fused_qkv_backward_from_residuals_reference` is the twin of the
tensor-core K3's and K6's own contract (P from the saved log-sum-exp, Δ from
the saved output). :data:`FORWARD_BODIES` and :data:`BACKWARD_BODIES`
count which body ran each forward and each backward.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, NamedTuple, Optional

import torch

from avex_tpu_torch.ops._build import load_library

__all__ = [
    "BACKWARD_BODIES",
    "CHUNK_COLUMNS",
    "FORWARD_BODIES",
    "LAUNCHES",
    "KERNEL_WIDTHS",
    "WidthPlan",
    "fused_qkv_attention",
    "fused_qkv_backward_from_residuals_reference",
    "fused_qkv_backward_reference",
    "fused_qkv_compatible",
    "fused_qkv_gated_attention",
    "fused_qkv_gated_backward_reference",
    "fused_qkv_gated_reference",
    "fused_qkv_reference",
    "gated_bias_attention",
    "gated_bias_attention_reference",
    "kernel_body",
    "kernel_width",
    "reset_launch_counts",
    "width_plan",
]

#: bf16 attention on the tensor cores (every kernel in bf16)
TENSOR_CORE_SOURCE = "tensor_core_attention.cu"
#: fp32 attention (K1-K6) on the tensor cores in 3xTF32, at every width
TF32X3_SOURCE = "tf32x3_attention.cu"
#: The widths each CUDA source is built for, one library a width; a head
#: width runs on the smallest that holds it or its column chunks
#: (:func:`width_plan`). The zoo's checkpoints use 64 (BEATs, EAT, AVES,
#: ATST, Bird-MAE base: 768 / 12) and 80 (Bird-MAE large and huge: 1024 / 16,
#: 1280 / 16).
KERNEL_WIDTHS = (32, 64, 80, 96, 128)
#: The most columns one block holds: a wider head runs in column chunks (the
#: bf16 dK/dV kernel holds 255 registers at 128 already).
CHUNK_COLUMNS = 128
_DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches since the last :func:`reset_launch_counts`, by kernel:
#: K1, K2, K4 (``gated_bias_attention`` with ``pos_bias=None``), K5, and the
#: backward kernels K3 and K6 (one count per backward call)
LAUNCHES: Dict[str, int] = {
    "gated_bias_attention": 0,
    "fused_qkv_gated_attention": 0,
    "plain_attention": 0,
    "fused_qkv_attention": 0,
    "fused_qkv_gated_attention_backward": 0,
    "fused_qkv_attention_backward": 0,
}
#: forward calls (K1, K2, K4 and K5 together) since the last
#: :func:`reset_launch_counts`, by the body that ran them: ``"bf16"`` (the
#: tensor cores), ``"tf32x3"`` (fp32 on the tensor cores in 3xTF32)
FORWARD_BODIES: Dict[str, int] = {"bf16": 0, "tf32x3": 0}
#: backward calls (K3 and K6 together), by body, as :data:`FORWARD_BODIES`
BACKWARD_BODIES: Dict[str, int] = {"bf16": 0, "tf32x3": 0}
#: dbias blocks of the bf16 K3 resident on an SM at once at width 64 (168
#: registers x 128 threads, 66 KB of shared memory): its batch is split into
#: as many chunks (summed in order after) as fill the card in one wave
_DBIAS_BLOCKS_PER_SM = 3
#: shared memory an SM holds for the blocks of one kernel (227 KB)
_SM_SHARED_BYTES = 232448


class WidthPlan(NamedTuple):
    """How the kernels run a head width: on the build ``build`` of
    :data:`KERNEL_WIDTHS`, in ``chunks`` column chunks of ``chunk_width``
    columns (the last holds what is left of the width)."""

    build: int
    chunks: int
    chunk_width: int


def width_plan(head_dim: int) -> WidthPlan:
    """The plan for a head width D >= 1: one chunk up to
    :data:`CHUNK_COLUMNS` (``chunk_width`` = D); past it ceil(D / 128)
    chunks, each ceil(D / chunks) rounded up to a multiple of 8 (so that every
    chunk starts on a 16-byte boundary), the last narrower. The build is the
    smallest that holds a chunk."""
    if isinstance(head_dim, bool) or not isinstance(head_dim, int) or head_dim < 1:
        raise ValueError(f"the attention kernels take a head_dim of at least 1, got {head_dim!r}")
    chunks = -(-head_dim // CHUNK_COLUMNS)
    per_chunk = -(-head_dim // chunks)
    width = head_dim if chunks == 1 else -(-per_chunk // 8) * 8
    return WidthPlan(min(w for w in KERNEL_WIDTHS if w >= width), chunks, width)


def _dbias_blocks_per_sm(width: int) -> int:
    """dbias blocks of the bf16 K3 that fit an SM at a build's width: its
    eight bf16 tiles of 64 rows (stored ``width`` wide at 64 and 128, one
    16-byte chunk wider otherwise) and 2 KB of row statistics, at most
    :data:`_DBIAS_BLOCKS_PER_SM`."""
    stride = width if width % 64 == 0 else width + 8
    smem = 8 * 64 * stride * 2 + 2048
    return max(1, min(_DBIAS_BLOCKS_PER_SM, _SM_SHARED_BYTES // smem))


def _fp32_dbias_items(bsz: int, blocks: int, slots: int) -> int:
    """Batch items a block of the 3xTF32 dbias kernel walks (one partial a
    chunk of them, summed in a second pass), for ``blocks`` blocks a chunk
    and ``slots`` resident on the card (both from the build,
    ``avex_tf32x3_dbias_plan``): of the chunk counts up to 64, the
    fewest whose waves of blocks times the items a block walks comes within
    5% of the least, so that the last wave is not left mostly idle."""
    costs = []
    for asked in range(1, min(bsz, 64) + 1):
        items = -(-bsz // asked)
        waves = -(-(-(-bsz // items)) * blocks // slots)  # ceil(chunks · blocks / slots)
        costs.append((waves * items, items))
    least = min(cost for cost, _ in costs)
    return next(items for cost, items in costs if cost <= 1.05 * least)


_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    """Set every launch count in :data:`LAUNCHES`, :data:`FORWARD_BODIES` and
    :data:`BACKWARD_BODIES` to 0."""
    with _COUNT_LOCK:
        for counts in (LAUNCHES, FORWARD_BODIES, BACKWARD_BODIES):
            for name in counts:
                counts[name] = 0


def _count(bodies: Dict[str, int], name: str, body: str) -> None:
    """One launch of kernel ``name`` on ``body``, counted in :data:`LAUNCHES`
    and in ``bodies`` (:data:`FORWARD_BODIES` or :data:`BACKWARD_BODIES`)."""
    # Served models launch from one batcher thread each: += is not atomic.
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        bodies[body] += 1


def kernel_width(head_dim: int) -> int:
    """The build (of :data:`KERNEL_WIDTHS`) that runs a head width D >= 1:
    the smallest that holds D, or past :data:`CHUNK_COLUMNS` its column
    chunks (:func:`width_plan`)."""
    return width_plan(head_dim).build


def _tensor_core_library(head_dim: int) -> ctypes.CDLL:
    """The tensor-core build that runs ``head_dim``."""
    lib = load_library(TENSOR_CORE_SOURCE, kernel_width(head_dim))
    if lib.avex_bias_free_attention_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        tail = [i, i, i, i, i, i, ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), p]
        lib.avex_tensor_core_gated_attention_forward.argtypes = [p] * 9 + tail
        lib.avex_bias_free_attention_forward.argtypes = [p] * 7 + tail
        lib.avex_tensor_core_attention_backward.argtypes = [p] * 17 + [i] + tail
        lib.avex_tensor_core_gated_attention_forward.restype = i
        lib.avex_bias_free_attention_forward.restype = i
        lib.avex_tensor_core_attention_backward.restype = i
    return lib


def _tf32x3_library(head_dim: int) -> ctypes.CDLL:
    """The 3xTF32 build that runs ``head_dim``."""
    lib = load_library(TF32X3_SOURCE, kernel_width(head_dim))
    if lib.avex_tf32x3_attention_backward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.avex_tf32x3_attention_forward.argtypes = [p] * 8 + [i] * 6 + [
            ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), p]
        lib.avex_tf32x3_attention_forward.restype = i
        lib.avex_tf32x3_attention_backward.argtypes = [p] * 16 + [i] * 7 + [
            ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), p]
        lib.avex_tf32x3_attention_backward.restype = i
        lib.avex_tf32x3_dbias_plan.argtypes = [i, i, ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.avex_tf32x3_dbias_plan.restype = i
    return lib


def kernel_body(dtype: torch.dtype) -> str:
    """The one rule for which body runs a call, forward (K1, K2, K4, K5) or
    backward (K3, K6), by the name :data:`FORWARD_BODIES` and
    :data:`BACKWARD_BODIES` count it under: ``"bf16"``, every bf16 call, on
    the tensor cores (``csrc/tensor_core_attention.cu``); ``"tf32x3"``,
    every fp32 call, on the tensor cores in 3xTF32
    (``csrc/tf32x3_attention.cu``). Either body takes every head width and
    row alignment (the kernel inside it follows from the ``chunk_width`` and
    ``narrow`` arguments of :func:`_columns`), and every backward runs from
    the residuals the fused forward saves (its output and row log-sum-exp).
    Raises TypeError for any other type."""
    if dtype == torch.bfloat16:
        return "bf16"
    if dtype == torch.float32:
        return "tf32x3"
    raise TypeError(f"the attention kernels take float32 or bfloat16, got {dtype}")


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
    logits = _scaled_logits(q, k, key_padding_mask, scale, pos_bias, gate)
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


def _backward_reference(qkv, heads, pos_bias, gate, key_padding_mask, dout, scale):
    """The backward chain of K3 (and, without ``pos_bias``, K6), step by step.

    As ``_fused_qkv_gated_bwd_kernel`` (``pallas_attention.py:799-835``):
    fp32 logits and softmax; P cast to v's type before ``Pᵀ·dO``; dL·scale
    cast to q's type before ``dS·K`` and ``dSᵀ·Q``; every product in fp32.
    """
    bsz, seq, three_e = qkv.shape
    dim = three_e // 3
    scale = scale if scale is not None else 1.0 / math.sqrt(dim // heads)
    q, k, v = (t.float() for t in _split_heads(qkv, heads))
    do = dout.reshape(bsz, seq, heads, dim // heads).permute(0, 2, 1, 3).float()
    logits = _scaled_logits(q, k, key_padding_mask, scale, pos_bias, gate)
    p32 = torch.softmax(logits, dim=-1)
    p = p32.to(qkv.dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), do)  # dV = Pᵀ·dO
    dp = torch.matmul(do, v.transpose(-1, -2))  # dP = dO·Vᵀ
    delta = (p32 * dp).sum(dim=-1, keepdim=True)  # Δ = rowsum(P ∘ dP)
    dl = p32 * (dp - delta)  # the logits' cotangent
    dgate = dbias = None
    if pos_bias is not None:
        dbias = (gate[..., None].float() * dl if gate is not None else dl).sum(dim=0)
        if gate is not None:
            dgate = (pos_bias[None].float() * dl).sum(dim=-1)
    ds = (dl * scale).to(qkv.dtype).float()
    dq = torch.matmul(ds, k)  # dQ = dS·K
    dk = torch.matmul(ds.transpose(-1, -2), q)  # dK = dSᵀ·Q
    dqkv = torch.stack([t.permute(0, 2, 1, 3) for t in (dq, dk, dv)], dim=2)
    return dqkv.reshape(bsz, seq, three_e).to(qkv.dtype), dbias, dgate


def fused_qkv_gated_backward_reference(
    qkv: torch.Tensor,
    heads: int,
    pos_bias: torch.Tensor,
    gate: Optional[torch.Tensor],
    key_padding_mask: Optional[torch.Tensor],
    dout: torch.Tensor,
    scale: Optional[float] = None,
):
    """Plain twin of K3: ``(dqkv, dbias, dgate)`` of
    :func:`fused_qkv_gated_attention` for the output cotangent ``dout``
    ``[B, T, E]``. ``dbias`` is float32 ``[H, T, T]`` (summed over the batch),
    ``dgate`` float32 ``[B, H, T]``, or None without a gate."""
    return _backward_reference(qkv, heads, pos_bias, gate, key_padding_mask, dout, scale)


def fused_qkv_backward_reference(
    qkv: torch.Tensor,
    heads: int,
    key_padding_mask: Optional[torch.Tensor],
    dout: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain twin of K6: ``dqkv`` of :func:`fused_qkv_attention` for ``dout``."""
    return _backward_reference(qkv, heads, None, None, key_padding_mask, dout, scale)[0]


def _scaled_logits(q, k, key_padding_mask, scale, pos_bias=None, gate=None):
    """fp32 ``q·kᵀ·scale (+ gate ⊙ pos_bias)`` with −inf at padded keys, over
    ``[B, H, T, D]``."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if pos_bias is not None:
        bias = pos_bias[None].float()
        logits = logits + (gate[..., None].float() * bias if gate is not None else bias)
    if key_padding_mask is not None:
        logits = logits.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
    return logits


def _fused_qkv_forward_lse_reference(qkv, heads, key_padding_mask=None, scale=None, pos_bias=None, gate=None):
    """:func:`fused_qkv_reference` (or, with ``pos_bias``,
    :func:`fused_qkv_gated_reference`) with the residuals the bf16 K5 and K2
    write for K6 and K3: ``(out, lse, out_rest)``. ``lse`` is the row
    log-sum-exp of the logits, float32 ``[B, H, T]``; ``out_rest`` is what
    rounding the output to its type dropped, in that type (0 in fp32)."""
    bsz, seq, three_e = qkv.shape
    dim = three_e // 3
    scale = scale if scale is not None else 1.0 / math.sqrt(dim // heads)
    q, k, v = _split_heads(qkv, heads)
    logits = _scaled_logits(q, k, key_padding_mask, scale, pos_bias, gate)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out32 = torch.matmul(weights.float(), v.float()).permute(0, 2, 1, 3).reshape(bsz, seq, dim)
    out = out32.to(v.dtype)
    return out, torch.logsumexp(logits, dim=-1), (out32 - out.float()).to(v.dtype)


def fused_qkv_backward_from_residuals_reference(
    qkv: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],
    dout: torch.Tensor,
    scale: Optional[float] = None,
    out_rest: Optional[torch.Tensor] = None,
    pos_bias: Optional[torch.Tensor] = None,
    gate: Optional[torch.Tensor] = None,
):
    """Plain twin of the bf16 K6 (and, with ``pos_bias``, of the bf16 K3):
    ``(dqkv, dbias, dgate)`` from the forward's residuals. (The fp32 K3 and
    K6 on 3xTF32 also take P over its row sum for dK, dV and dbias; their
    arithmetic is emulated in ``tests/test_torch_tf32x3.py``.)

    As :func:`fused_qkv_gated_backward_reference`, except that P is rebuilt
    from ``lse`` (float32 ``[B, H, T]``, the forward's row log-sum-exp) and Δ
    is ``rowsum(dout ∘ O)`` with O = ``out + out_rest`` in fp32 (the
    forward's output ``[B, T, E]`` and what its rounding dropped; ``out``
    alone without ``out_rest``), as the kernels do: in exact arithmetic the
    same Δ as ``rowsum(P ∘ dP)``. P is ``exp2(L·log2e − lse·log2e)``, the
    kernels' form, and a fully padded row (``lse = −inf``) gives NaN. With
    dL = P ∘ (dP − Δ) in fp32, ``dbias`` = Σ_b gate ⊙ dL (float32
    ``[H, T, T]``, None without ``pos_bias``) and ``dgate`` = Σ_k bias·dL
    (float32 ``[B, H, T]``, None without a gate).
    """
    bsz, seq, three_e = qkv.shape
    dim = three_e // 3
    heads = lse.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dim // heads)
    log2e = 1.0 / math.log(2.0)

    def heads_first(t):
        return t.reshape(bsz, seq, heads, dim // heads).permute(0, 2, 1, 3).float()

    q, k, v = (t.float() for t in _split_heads(qkv, heads))
    o, do = heads_first(out), heads_first(dout)
    if out_rest is not None:
        o = o + heads_first(out_rest)
    logits = _scaled_logits(q, k, key_padding_mask, scale, pos_bias, gate)
    p32 = torch.exp2(logits * log2e - lse[..., None].float() * log2e)
    p = p32.to(qkv.dtype).float()
    dv = torch.matmul(p.transpose(-1, -2), do)  # dV = Pᵀ·dO
    dp = torch.matmul(do, v.transpose(-1, -2))  # dP = dO·Vᵀ
    delta = (do * o).sum(dim=-1, keepdim=True)  # Δ = rowsum(dO ∘ O)
    dl = p32 * (dp - delta)  # the logits' cotangent
    dbias = dgate = None
    if pos_bias is not None:
        dbias = (gate[..., None].float() * dl if gate is not None else dl).sum(dim=0)
        if gate is not None:
            dgate = (pos_bias[None].float() * dl).sum(dim=-1)
    ds = (dl * scale).to(qkv.dtype).float()
    dq = torch.matmul(ds, k)  # dQ = dS·K
    dk = torch.matmul(ds.transpose(-1, -2), q)  # dK = dSᵀ·Q
    dqkv = torch.stack([t.permute(0, 2, 1, 3) for t in (dq, dk, dv)], dim=2)
    return dqkv.reshape(bsz, seq, three_e).to(qkv.dtype), dbias, dgate


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _narrow(name: str, t: torch.Tensor) -> bool:
    """Whether the kernels must read and write ``t``'s rows element by element
    (narrow rows): its head width or a stride is not a multiple of 8
    elements, or it starts off a 16-byte boundary; else they move 16-byte
    runs. Raises unless the head dimension is contiguous."""
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: the kernel needs a contiguous head dimension; got strides {tuple(t.stride())}")
    return bool(t.shape[-1] % 8 or any(s % 8 for s in t.stride()[:-1]) or t.data_ptr() % 16)


def _check_operands(q, k, v, outputs, pos_bias, gate, key_padding_mask) -> bool:
    """Raise on what the kernels do not take. q, k, v and every tensor of
    ``outputs`` (name → tensor) are ``[B, H, T, D]`` views of one type.
    Returns whether the call takes narrow rows (:func:`_narrow` of any of
    them)."""
    bsz, heads, seq, dim = q.shape
    width_plan(dim)  # raises at a head_dim below 1
    if q.dtype not in _DTYPES:
        raise TypeError(f"the attention kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), *outputs.items()):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    narrow = [_narrow(name, t) for name, t in (("q", q), ("k", k), ("v", v), *outputs.items())]
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
    return any(narrow)


def _columns(dim: int, narrow: bool) -> tuple:
    """The entry points' ``(head_dim, chunk_width, narrow)`` arguments."""
    return dim, width_plan(dim).chunk_width, int(narrow)


def _launch(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_bias: Optional[torch.Tensor],
    gate: Optional[torch.Tensor],
    key_padding_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    scale: float,
    residuals: Optional[tuple] = None,
) -> str:
    """Launch the forward kernel on ``[B, H, T, D]`` views; ``out`` is written
    in place. With ``pos_bias`` the gated variant runs, without it the
    bias-free one (which takes no gate either), on the body
    :func:`kernel_body` gives; returns that body's name (``"bf16"`` or
    ``"tf32x3"``). The one place the forwards' C arguments are laid out.
    ``residuals`` = ``(lse, out_rest)`` may
    receive the backward's residuals, on either body: the row log-sum-exp
    (float32 ``[B, H, T]`` contiguous) and, in bf16, what rounding the output
    dropped (bf16 with ``out``'s strides; None in fp32, whose output is not
    rounded)."""
    narrow = _check_operands(q, k, v, {"out": out}, pos_bias, gate, key_padding_mask)
    bsz, heads, seq, dim = q.shape
    gated = pos_bias is not None
    bf16 = q.dtype == torch.bfloat16
    body = kernel_body(q.dtype)
    lse, out_rest = residuals if residuals is not None else (None, None)
    if residuals is not None and not (
        lse.shape == (bsz, heads, seq) and lse.dtype == torch.float32 and lse.is_contiguous()
        and (out_rest.dtype == out.dtype and out_rest.stride() == out.stride() if bf16 else out_rest is None)
    ):
        raise ValueError("the backward's residuals: lse float32 [B, H, T] contiguous, and out_rest in out's "
                         "type and layout in bf16 (None in fp32)")
    pad_strides = key_padding_mask.stride() if key_padding_mask is not None else (0, 0)
    pad_ptr = _ptr(key_padding_mask)
    views = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    bias_strides = pos_bias.stride() if gated else (0, 0, 0)
    gate_strides = gate.stride() if gate is not None else (0, 0, 0)
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    tail = (bsz, heads, seq, *_columns(dim, narrow), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if body == "tf32x3" or gated:
            strides = (ctypes.c_longlong * 20)(*views, *bias_strides, *gate_strides, *pad_strides)
        else:
            strides = (ctypes.c_longlong * 14)(*views, *pad_strides)
        if body == "tf32x3":
            err = _tf32x3_library(dim).avex_tf32x3_attention_forward(
                *operands, _ptr(pos_bias), _ptr(gate), pad_ptr, out.data_ptr(), _ptr(lse), *tail, strides, stream,
            )
        elif gated:
            err = _tensor_core_library(dim).avex_tensor_core_gated_attention_forward(
                *operands, pos_bias.data_ptr(), _ptr(gate), pad_ptr, out.data_ptr(), _ptr(out_rest), _ptr(lse),
                *tail, strides, stream,
            )
        else:
            err = _tensor_core_library(dim).avex_bias_free_attention_forward(
                *operands, pad_ptr, out.data_ptr(), _ptr(out_rest), _ptr(lse), *tail, strides, stream,
            )
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    return body


def _kernel_split(q, k, v, pos_bias, gate, key_padding_mask, scale) -> torch.Tensor:
    bsz, heads, seq, dim = q.shape
    # Written as [B, T, H, D] and returned as a [B, H, T, D] view: the caller's
    # head merge back to [B, T, E] is then free.
    out = torch.empty(bsz, seq, heads, dim, dtype=v.dtype, device=v.device).permute(0, 2, 1, 3)
    body = _launch(q, k, v, pos_bias, gate, key_padding_mask, out, scale)
    _count(FORWARD_BODIES, "gated_bias_attention" if pos_bias is not None else "plain_attention", body)
    return out


def _kernel_fused(qkv, heads, pos_bias, gate, key_padding_mask, scale, with_residuals=False):
    """Launch K2 (with ``pos_bias``) or K5; returns ``(out, residuals)``.
    ``residuals`` is ``(lse, out_rest)`` (see :func:`_launch`; ``out_rest``
    None in fp32) when ``with_residuals`` asks for them, else None."""
    bsz, seq, three_e = qkv.shape
    dim = three_e // 3
    q, k, v = _split_heads(qkv, heads)
    out = torch.empty(bsz, seq, dim, dtype=qkv.dtype, device=qkv.device)

    def heads_first(t):
        return t.view(bsz, seq, heads, dim // heads).permute(0, 2, 1, 3)

    residuals = rest = None
    if with_residuals:
        bf16 = qkv.dtype == torch.bfloat16
        residuals = (torch.empty(bsz, heads, seq, dtype=torch.float32, device=qkv.device),
                     torch.empty_like(out) if bf16 else None)
        rest = heads_first(residuals[1]) if bf16 else None
    body = _launch(q, k, v, pos_bias, gate, key_padding_mask, heads_first(out), scale,
                   None if residuals is None else (residuals[0], rest))
    _count(FORWARD_BODIES, "fused_qkv_gated_attention" if pos_bias is not None else "fused_qkv_attention", body)
    return out, residuals


def _kernel_residual_backward(qkv, heads, pos_bias, gate, key_padding_mask, out, lse, out_rest, dout, scale):
    """Launch K3 (with ``pos_bias``) or K6 on the tensor cores from the
    forward's residuals: its output ``out``, row log-sum-exp ``lse`` and, in
    bf16, ``out_rest`` (what rounding the output dropped; None in fp32).
    bf16 runs ``csrc/tensor_core_attention.cu``, fp32 the 3xTF32 kernels of
    ``csrc/tf32x3_attention.cu`` at every head width (narrow rows and column
    chunks too). Returns ``(dqkv, dbias, dgate)``, dqkv written
    straight into the column views of one ``[B, T, 3E]`` gradient."""
    bsz, seq, three_e = qkv.shape
    dim = three_e // 3
    gated = pos_bias is not None
    bf16 = qkv.dtype == torch.bfloat16
    qkv = qkv.contiguous()
    q, k, v = _split_heads(qkv, heads)
    dqkv = torch.empty_like(qkv)
    dq, dk, dv = _split_heads(dqkv, heads)

    def heads_first(t):
        return t.contiguous().view(bsz, seq, heads, dim // heads).permute(0, 2, 1, 3)

    o, do = heads_first(out), heads_first(dout)
    rest = heads_first(out_rest) if bf16 else None
    views = {"out": o, "dout": do, "dq": dq, "dk": dk, "dv": dv}
    if bf16:
        views["out_rest"] = rest
    elif out_rest is not None:
        raise ValueError("the fp32 backward takes no out_rest: the fp32 output is not rounded")
    narrow = _check_operands(q, k, v, views, pos_bias, gate, key_padding_mask)
    body = kernel_body(qkv.dtype)
    if lse.shape != (bsz, heads, seq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 [{bsz}, {heads}, {seq}]")
    f32 = dict(dtype=torch.float32, device=qkv.device)
    # Δ (bf16); Δ' and the rebased log-sum-exp (fp32, csrc/tf32x3_attention.cu)
    delta = torch.empty(bsz, heads, seq, **f32) if bf16 else torch.empty(2, bsz, heads, seq, **f32)
    dbias = torch.empty(heads, seq, seq, **f32) if gated else None
    dgate = torch.empty(bsz, heads, seq, **f32) if gate is not None else None
    items, part = bsz, None
    if gated:
        # dbias in batch chunks, a partial each: bf16 as many as one wave of
        # blocks holds; fp32 by _fp32_dbias_items on the build's own shape
        if bf16:
            tiles = -(-seq // 64)
            sms = torch.cuda.get_device_properties(qkv.device).multi_processor_count
            per_sm = _dbias_blocks_per_sm(kernel_width(dim // heads))
            chunks = max(1, min(bsz, per_sm * sms // (tiles * tiles * heads)))
            items = -(-bsz // chunks)
        else:
            blocks, resident = ctypes.c_int(), ctypes.c_int()
            with torch.cuda.device(qkv.device):
                err = _tf32x3_library(dim // heads).avex_tf32x3_dbias_plan(heads, seq, ctypes.byref(blocks),
                                                                           ctypes.byref(resident))
            if err != 0:
                raise RuntimeError(f"the 3xTF32 dbias plan failed: CUDA error {err}")
            items = _fp32_dbias_items(bsz, blocks.value, resident.value)
        chunks = -(-bsz // items)
        part = torch.empty(chunks, heads, seq, seq, **f32) if chunks > 1 else None
    pad_strides = key_padding_mask.stride() if key_padding_mask is not None else (0, 0)
    bias_strides = pos_bias.stride() if gated else (0, 0, 0)
    gate_strides = gate.stride() if gate is not None else (0, 0, 0)
    views = (s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3])
    strides = (ctypes.c_longlong * 32)(*views, *pad_strides, *bias_strides, *gate_strides)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        if bf16:
            err = _tensor_core_library(dim // heads).avex_tensor_core_attention_backward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), rest.data_ptr(), do.data_ptr(),
                _ptr(pos_bias), _ptr(gate), _ptr(key_padding_mask), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), delta.data_ptr(), _ptr(dbias), _ptr(dgate), _ptr(part), items,
                bsz, heads, seq, *_columns(dim // heads, narrow), float(scale), strides, stream,
            )
        else:
            err = _tf32x3_library(dim // heads).avex_tf32x3_attention_backward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), _ptr(pos_bias), _ptr(gate),
                _ptr(key_padding_mask), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                delta.data_ptr(), _ptr(dbias), _ptr(dgate), _ptr(part), items, bsz, heads, seq,
                *_columns(dim // heads, narrow), float(scale), strides, stream,
            )
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: CUDA error {err}")
    _count(BACKWARD_BODIES, "fused_qkv_gated_attention_backward" if gated else "fused_qkv_attention_backward",
           body)
    return dqkv, dbias, dgate


class _FusedQKVAttention(torch.autograd.Function):
    """CUDA tensors: K2 (with ``pos_bias``) or K5 forward, K3 or K6 backward.

    The residuals are the forward's inputs, as JAX keeps them
    (``pallas_attention.py:648-650``, ``:940-944``), and, on every body, the
    forward's output and the row log-sum-exp as well (in bf16 also what the
    output's rounding dropped): P is rebuilt from the log-sum-exp and Δ
    taken from the output, with no pass for the row statistics. The output
    is the tensor the caller's output projection keeps for its own weight
    gradient, so saving it costs nothing; the rounding rest costs as much
    again in bf16, and keeps Δ's error near fp32's (PERF.md). The backward
    follows from the saved log-sum-exp alone, and raises without one.
    ``need_grad`` (grad mode on and an input requiring grad, decided by the
    caller: a Function's forward always runs with grad mode off) asks for
    the residuals; without it nothing extra is written.
    """

    @staticmethod
    def forward(ctx, qkv, pos_bias, gate, key_padding_mask, heads, scale, need_grad):
        out, residuals = _kernel_fused(qkv, heads, pos_bias, gate, key_padding_mask, scale,
                                       with_residuals=need_grad)
        lse, out_rest = residuals if residuals is not None else (None, None)
        ctx.save_for_backward(qkv, pos_bias, gate, key_padding_mask, out if lse is not None else None, out_rest, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, pos_bias, gate, key_padding_mask, out, out_rest, lse = ctx.saved_tensors
        if lse is None:
            raise RuntimeError("the attention backward needs the forward's residuals: run the forward with grad "
                               "mode on and an input requiring grad")
        dqkv, dbias, dgate = _kernel_residual_backward(
            qkv, ctx.heads, pos_bias, gate, key_padding_mask, out, lse, out_rest, dout, ctx.scale
        )
        return dqkv, dbias, dgate, None, None, None, None


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
    """True when the fused kernels (K2/K5) take this projection's heads:
    ``dim`` splits into ``heads`` equal heads, whatever their width (every
    head width D >= 1 runs, :func:`width_plan`).

    The JAX rule (head groups that tile 128 lanes, ``pallas_attention.py:445-468``)
    is a Mosaic layout rule with no Hopper counterpart. So the port takes
    the fused kernels wherever the heads split evenly, and JAX takes its
    split-input K1/K4 where its head groups do not tile: at 12 heads of 80
    (K5 here, K4 in JAX), 4 heads of 16 (K2 here, K1 in JAX) or 12 heads of
    20. The function is the same.
    """
    return heads > 0 and dim % heads == 0


def _needs_grad(*inputs: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs)


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
    :func:`fused_qkv_attention` (K5). Differentiable in ``qkv``, ``pos_bias``
    and ``gate``: on CUDA the backward is the K3 kernel, on the CPU autograd
    through the plain twin.
    """
    if pos_bias is None:
        raise ValueError("fused_qkv_gated_attention needs a pos_bias; use fused_qkv_attention without one")
    dim = qkv.shape[-1] // 3
    scale = scale if scale is not None else 1.0 / math.sqrt(dim // heads)
    if qkv.device.type == "cpu":
        return fused_qkv_gated_reference(qkv, heads, pos_bias, gate, key_padding_mask, scale)
    return _FusedQKVAttention.apply(qkv, pos_bias, gate, key_padding_mask, heads, scale,
                                    _needs_grad(qkv, pos_bias, gate))


def fused_qkv_attention(
    qkv: torch.Tensor,
    heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Bias-free attention over the raw ``[B, T, 3E]`` projection (K5).

    q, k and v are read as column views (``q | k | v``, each head-major) and
    the output is written as merged heads, ``[B, T, E]``. ``key_padding_mask``
    is ``[B, T]`` bool, True = padded key. Differentiable in ``qkv``: on
    CUDA the backward is the K6 kernel, on the CPU autograd through the plain
    twin. bf16 CUDA tensors run on the tensor-core kernels
    (``csrc/tensor_core_attention.cu``); fp32 ones on the tensor cores in
    3xTF32 (``csrc/tf32x3_attention.cu``), forward and backward, at every
    width.
    """
    dim = qkv.shape[-1] // 3
    scale = scale if scale is not None else 1.0 / math.sqrt(dim // heads)
    if qkv.device.type == "cpu":
        return fused_qkv_reference(qkv, heads, key_padding_mask, scale)
    return _FusedQKVAttention.apply(qkv, None, None, key_padding_mask, heads, scale, _needs_grad(qkv))
