"""Attention and transformer support ops (port of ``avex_tpu/ops/attention.py``).

- ``dot_product_attention``: SDPA with an additive bias and a chosen logits
  dtype (fp32 parity by default);
- ``relative_position_bucket``: the T5 bidirectional bucket matrix, computed
  in numpy and cached. The float32 log lands on bucket edges; a torch
  float32 log can come out one ulp off there, so torch does not compute it;
- ``grad_multiply``: identity forward, gradient scaled in the backward.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

__all__ = ["dot_product_attention", "grad_multiply", "relative_position_bucket"]


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    logits_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Scaled dot-product attention with an additive bias.

    Args:
        q, k, v: ``[B, H, T, D]``.
        bias: additive bias broadcastable to ``[B, H, T, T]``.
        scale: logit scale; default ``1/sqrt(D)``.
        logits_dtype: dtype of the logits/softmax chain. fp32 is the parity
            mode; bfloat16 is the reduced-precision ``fast_attention`` chain.

    Returns ``[B, H, T, D]`` in v's dtype.
    """
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if logits_dtype == torch.float32:
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    else:
        logits = torch.matmul(q.to(logits_dtype), k.to(logits_dtype).transpose(-1, -2))
    logits = logits * scale
    if bias is not None:
        logits = logits + bias.to(logits_dtype)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


@functools.lru_cache(maxsize=32)
def _bucket_matrix(
    query_length: int, key_length: int, num_buckets: int, max_distance: int, bidirectional: bool
) -> np.ndarray:
    context = np.arange(query_length, dtype=np.int64)[:, None]
    memory = np.arange(key_length, dtype=np.int64)[None, :]
    rel = memory - context

    buckets = np.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        buckets += (rel > 0).astype(np.int64) * num_buckets
        rel = np.abs(rel)
    else:
        rel = -np.minimum(rel, 0)

    max_exact = num_buckets // 2
    is_small = rel < max_exact
    # float32 log to match the reference's dtype, truncated toward zero.
    large = max_exact + (
        np.log(np.maximum(rel, 1).astype(np.float32) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, num_buckets - 1)
    buckets += np.where(is_small, rel, large)
    out = buckets.astype(np.int64)
    out.setflags(write=False)
    return out


def relative_position_bucket(
    query_length: int,
    key_length: int,
    num_buckets: int = 320,
    max_distance: int = 800,
    bidirectional: bool = True,
) -> np.ndarray:
    """T5 relative-position bucket matrix ``[query_length, key_length]`` (int64, read-only).

    Half the buckets for each direction, exact buckets for small distances,
    log-spaced buckets saturating at ``max_distance``.
    """
    return _bucket_matrix(query_length, key_length, num_buckets, max_distance, bidirectional)


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.scale, None


def grad_multiply(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Identity in the forward pass; gradients scaled by ``scale`` backward."""
    return _GradMultiply.apply(x, scale)
