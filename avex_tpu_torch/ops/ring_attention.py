"""Ring attention: exact SDPA with the time axis cut over a mesh axis.

Port of ``avex_tpu/ops/ring_attention.py``. JAX runs it in a ``shard_map``:
each device keeps its query chunk while the key/value chunks hop around
the device ring (``lax.ppermute``, i → i+1), and an online softmax in fp32
(running max, sum and weighted accumulator, flash-attention style) gives
the exact softmax without the ``[B, H, T, T]`` score matrix on any device.
Here the ring is the mesh axis's process group:

- a layer's attention (:func:`ring_self_attention`, what the models call)
  hands each rank its block of positions of the layer's input, so the rank
  projects q, k, v (and BEATs' gate) for its own positions only; the
  parameters read there pass ``copy_to_model``, whose backward sums their
  gradient over the ring, and the block's backward gathers the input's;
- the key/value chunks hop with :func:`~avex_tpu_torch.parallel.ring_shift`
  (the shift GPipe's stages use: ``batch_isend_irecv`` on NCCL, written
  from ``all_reduce`` on gloo), one step per rank of the ring; at step
  ``s`` a rank holds the chunk that started on rank ``(me − s) % ring``,
  and slices the additive bias's key columns and the padding mask at that
  chunk; the gate multiplies the bias inside the step, so ``gate · bias``
  is never formed at ``[B, H, T, T]``;
- the ranks' output chunks are gathered whole (each rank goes on with the
  same values); the backward keeps a rank's chunk of the output gradient,
  runs the reverse ring (the chunks and their dK/dV accumulators hop i →
  i−1, the transpose of the forward's shift, and end on the rank that
  owns them; P is recomputed from the saved row log-sum-exp), and gives
  each rank its chunks' dQ, dK, dV, dgate and its dbias rows.

:func:`ring_attention` is JAX's function on q, k, v that every rank holds
whole (as a replicated array enters JAX's ``shard_map``): each rank takes
its chunks, and the backward gathers the chunks' gradients.

Products accumulate in fp32 (``q`` and ``k`` cast up, as JAX's
``preferred_element_type``); the output is in ``v``'s dtype. A query row
whose keys are all padded gives 0: the online sum is floored at fp32's
smallest normal number, as JAX's ring does (``:160-163``), where the plain
attention and its twins give NaN. No Pallas kernel is on this path
(JAX's ring branch turns them off and computes with einsums), so plain
torch products are the port; a ring step on the LSE-returning forward
kernels is a speed item (ROADMAP queue 2).

The batch of a rank is its data row's share already, so JAX's
``data_axis`` has no counterpart. A ring of one rank is the port's
``dot_product_attention`` on ``gate · bias`` plus the padding bias.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.ops.attention import dot_product_attention
from avex_tpu_torch.parallel import Mesh, ring_shift
from avex_tpu_torch.parallel.sequence import enter_blocks, leave_blocks
from avex_tpu_torch.parallel.tensor import copy_to_model

__all__ = ["check_ring_axis", "ring_attention", "ring_bytes", "ring_self_attention", "shared_linear"]

_TINY = torch.finfo(torch.float32).tiny


def _block(x: torch.Tensor, src: int, chunk: int) -> torch.Tensor:
    """Key block ``src`` of ``x``'s last axis."""
    return x[..., src * chunk:(src + 1) * chunk]


class _Ring(torch.autograd.Function):
    """The ring over one rank's chunks: ``q``, ``k``, ``v`` ``[B, H, c, D]``,
    the bias's query rows ``[Bb, Hb, c, T]`` (all keys), the gate's ``[B, H,
    c, 1]``, the whole ``[B, T]`` mask; returns the chunk's output."""

    @staticmethod
    def forward(ctx, q, k, v, bias, gate, mask, scale, mesh):
        ring, me = mesh.size, mesh.rank
        chunk = k.shape[2]
        qf = q.float()
        m = torch.full(q.shape[:3], -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)  # noqa: E741
        acc = torch.zeros(q.shape[:3] + (v.shape[-1],), dtype=torch.float32, device=q.device)
        kv = torch.stack([k, v])
        for s in range(ring):
            src = (me - s) % ring
            logits = _logits(qf, kv[0], bias, gate, mask, src, chunk, scale)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)  # noqa: E741
            acc = acc * alpha[..., None] + torch.matmul(p, kv[1].float())
            m = m_new
            if s < ring - 1:
                kv = ring_shift(kv, mesh, 1)
        safe = l.clamp_min(_TINY)
        out = acc / safe[..., None]
        ctx.save_for_backward(qf, kv, bias, gate, mask, out, m + torch.log(safe))
        ctx.scale, ctx.mesh, ctx.dtypes = scale, mesh, (q.dtype, k.dtype, v.dtype)
        ctx.bias_shape = None if bias is None else bias.shape
        return out.to(v.dtype)

    @staticmethod
    def backward(ctx, grad):
        qf, kv, bias, gate, mask, out, lse = ctx.saved_tensors
        scale, mesh = ctx.scale, ctx.mesh
        ring, me = mesh.size, mesh.rank
        chunk = kv.shape[3]
        d_out = grad.float()
        delta = (d_out * out).sum(-1, keepdim=True)
        dq = torch.zeros_like(qf)
        dbias = torch.zeros(ctx.bias_shape, dtype=torch.float32, device=qf.device) if bias is not None else None
        dgate = torch.zeros(gate.shape, dtype=torch.float32, device=qf.device) if gate is not None else None
        # the last step's chunks, with their dK/dV accumulators
        state = torch.cat([kv.float(), torch.zeros_like(kv, dtype=torch.float32)])
        for s in reversed(range(ring)):
            src = (me - s) % ring
            k_c, v_c = state[0], state[1]
            logits = _logits(qf, k_c, bias, gate, mask, src, chunk, scale)
            p = torch.exp(logits - lse[..., None])
            state[3] += torch.matmul(p.transpose(-1, -2), d_out)
            ds = p * (torch.matmul(d_out, v_c.transpose(-1, -2)) - delta)
            dq += torch.matmul(ds, k_c) * scale
            state[2] += torch.matmul(ds.transpose(-1, -2), qf) * scale
            if bias is not None:
                b = _block(bias, src, chunk).float()
                if gate is not None:
                    dgate += (ds * b).sum(-1, keepdim=True).sum_to_size(dgate.shape)
                    ds = ds * gate.float()
                _block(dbias, src, chunk).add_(ds.sum_to_size(dbias.shape[:-1] + (chunk,)))
            if s > 0:
                state = ring_shift(state, mesh, -1)  # the reverse ring: rank r takes rank r+1's
        q_dtype, k_dtype, v_dtype = ctx.dtypes
        return (dq.to(q_dtype), state[2].to(k_dtype), state[3].to(v_dtype),
                None if dbias is None else dbias.to(bias.dtype), None if dgate is None else dgate.to(gate.dtype),
                None, None, None)


def _logits(qf, k_c, bias, gate, mask, src: int, chunk: int, scale: float) -> torch.Tensor:
    """One step's fp32 logits: this rank's queries against key chunk ``src``,
    scaled, plus that chunk's columns of ``gate · bias`` and the padding."""
    logits = torch.matmul(qf, k_c.float().transpose(-1, -2)) * scale
    if bias is not None:
        b = _block(bias, src, chunk).float()
        if gate is not None:
            b = gate.float() * b
        logits = logits + b
    if mask is not None:
        logits = logits.masked_fill(_block(mask, src, chunk)[:, None, None, :], float("-inf"))
    return logits


def _check(q: torch.Tensor, bias, gate, seq: int, ring: int) -> None:
    """JAX's refusals."""
    if q.ndim != 4:
        raise ValueError(f"ring_attention expects [B, H, T, D] inputs, got {tuple(q.shape)}")
    if gate is not None and bias is None:
        raise ValueError("ring_attention: gate without bias has nothing to gate")
    if seq % ring:
        raise ValueError(f"sequence length {seq} not divisible by ring size {ring}")
    if ring > 1 and bias is not None and (bias.shape[-2] != seq or bias.shape[-1] != seq):
        raise ValueError(f"ring_attention bias must have concrete [.., T, T] = {seq} trailing dims, "
                         f"got {tuple(bias.shape)}")


def _one_rank(q, k, v, bias, gate, mask, scale: float) -> torch.Tensor:
    """A ring of one: ``dot_product_attention`` on ``gate · bias`` plus the padding bias."""
    full_bias = gate * bias if gate is not None else bias
    if mask is not None:
        pad = torch.zeros(mask.shape, dtype=torch.float32, device=q.device)
        pad = pad.masked_fill(mask, float("-inf"))[:, None, None, :]
        full_bias = pad if full_bias is None else full_bias + pad
    return dot_product_attention(q, k, v, bias=full_bias, scale=scale)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    *,
    mesh: Mesh,
    axis: str = "model",
    gate: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exact SDPA with the time axis cut over ``mesh``'s ``axis`` (the module
    docstring has the ring).

    Args:
      q, k, v: ``[B, H, T, D]``, whole on every rank of the axis; ``T``
        must divide by the ring size.
      bias: optional additive bias ``[B|1, H|1, T, T]``.
      scale: logit scale; default ``1/sqrt(D)``.
      gate: optional per-query gate ``[B, H, T, 1]`` applied to ``bias``
        (BEATs' GRU gate) inside each step.
      key_padding_mask: optional boolean ``[B, T]`` (True = padded key),
        applied as ``-inf`` in each step.

    Returns ``[B, H, T, D]`` in ``v``'s dtype on every rank, equal to
    ``dot_product_attention(q, k, v, gate · bias + pad)`` to fp32 roundoff,
    with a fully padded query row's output 0 (see the module docstring).
    """
    ring_mesh = mesh.axis(axis)
    ring, seq = ring_mesh.size, int(q.shape[2]) if q.ndim == 4 else 0
    _check(q, bias, gate, seq, ring)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if ring == 1:
        return _one_rank(q, k, v, bias, gate, key_padding_mask, scale)
    q_l, k_l, v_l = (enter_blocks(t, ring_mesh, dim=2) for t in (q, k, v))
    bias_l = enter_blocks(bias, ring_mesh, dim=2) if bias is not None else None
    gate_l = enter_blocks(gate, ring_mesh, dim=2) if gate is not None else None
    out = _Ring.apply(q_l, k_l, v_l, bias_l, gate_l, key_padding_mask, scale, ring_mesh)
    return leave_blocks(out, ring_mesh, seq, dim=2)


#: ``project(x, shared) -> (q, k, v, gate)``: a layer's ``[B, H, n, D]``
#: projections of ``x`` ``[B, n, E]`` (and its ``[B, H, n, 1]`` gate, or
#: None), reading each parameter through ``shared``
Projection = Callable[[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]], Tuple]


def shared_linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
                  shared: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``layer`` on ``x`` in ``dtype`` (flax ``Dense(dtype=...)``), its weight
    and bias read through ``shared``. A layer that is no ``nn.Linear`` (an
    ``Int8Linear``: inference weights, no gradient) is called as it is."""
    if not isinstance(layer, nn.Linear):
        return layer(x)
    bias = shared(layer.bias).to(dtype) if layer.bias is not None else None
    return F.linear(x.to(dtype), shared(layer.weight).to(dtype), bias)


def ring_self_attention(
    x: torch.Tensor,
    project: Projection,
    *,
    mesh: Mesh,
    axis: str = "model",
    bias: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    scale: float,
) -> torch.Tensor:
    """A layer's attention as ring attention at any T, as the JAX models call
    it: ``x`` ``[B, T, E]`` (whole on every rank of the axis) pads with zeros
    to a multiple of the ring size, the bias too and the mask with True (the
    padded keys get ``-inf``: exact); each rank projects its block of
    positions (``project``; the parameters it reads through ``shared`` get
    their gradient summed over the ring) and the k/v chunks hop. Returns
    ``[B, H, T, D]`` whole on every rank, the padded query rows sliced off.
    """
    ring_mesh = mesh.axis(axis)
    ring = ring_mesh.size
    if ring == 1:
        q, k, v, gate = project(x, lambda p: p)
        _check(q, bias, gate, q.shape[2], 1)
        return _one_rank(q, k, v, bias, gate, key_padding_mask, scale)
    bsz, seq = x.shape[:2]
    pad = (-seq) % ring
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        bias = F.pad(bias, (0, pad, 0, pad)) if bias is not None else None
        if key_padding_mask is None:
            key_padding_mask = torch.zeros((bsz, seq), dtype=torch.bool, device=x.device)
        key_padding_mask = torch.cat(
            [key_padding_mask, torch.ones((bsz, pad), dtype=torch.bool, device=x.device)], dim=1)
    q, k, v, gate = project(enter_blocks(x, ring_mesh), lambda p: copy_to_model(p, ring_mesh))
    _check(q, bias, gate, seq + pad, ring)
    bias_l = enter_blocks(bias, ring_mesh, dim=2) if bias is not None else None
    out = _Ring.apply(q, k, v, bias_l, gate, key_padding_mask, scale, ring_mesh)
    return leave_blocks(out, ring_mesh, seq + pad, dim=2)[:, :, :seq]


def check_ring_axis(axis: str) -> None:
    """Raise unless ``axis`` is ``model``: the axis EAT's, AVES's and
    Bird-MAE's blocks ring over (JAX's ``enable_ring_attention`` takes the
    argument and reads only the model axis)."""
    if axis != "model":
        raise ValueError(f"enable_ring_attention: these blocks ring over the model axis, not {axis!r}")


def ring_bytes(q: torch.Tensor, ring: int) -> int:
    """The bytes one rank sends around a ring of ``ring`` ranks in a forward
    for ``[B, H, T, D]`` inputs like ``q``: ``ring − 1`` hops, each carrying
    the rank's key and value chunks."""
    b, h, t, d = q.shape
    return (ring - 1) * 2 * b * h * (t // ring) * d * q.element_size()
