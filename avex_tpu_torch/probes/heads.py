"""Probe heads: linear, MLP, MoE, LSTM, attention and transformer.

Port of ``avex_tpu/probes/heads.py`` as ``nn.Module``s. Each head takes its
input width at construction (flax infers it at init) and a
``torch.Generator`` for its initialisation; ``forward`` takes
``deterministic`` and, for dropout, a generator. Initialisation follows
flax: lecun-normal kernels, zero biases, orthogonal LSTM recurrent kernels,
a transformer's ``pos_encoding`` from a normal with std 1. LayerNorm's eps
is flax's 1e-6.

Attention is flax's ``MultiHeadDotProductAttention`` written as plain
products: q scaled by ``head_dim**-0.5``, masked logits filled with the
fp32 minimum (so a fully masked row attends uniformly instead of giving
NaN), the softmax in fp32, and attention dropout with one mask shared
across the batch and the heads (``broadcast_dropout``). The sequence heads
mean-pool every step, padded or not, as the JAX heads do.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.models.common import dropout
from avex_tpu_torch.ops.moe import MoEMLP, lecun_normal_

__all__ = ["AttentionHead", "LSTMHead", "LinearHead", "MLPHead", "MoEHead", "MultiHeadAttention", "TransformerHead"]

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": F.gelu,  # exact, as the JAX head's approximate=False
    "tanh": torch.tanh,
    "swish": F.silu,
}
LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm


def dense(in_dim: int, out_dim: int, generator: Optional[torch.Generator]) -> nn.Linear:
    """flax ``nn.Dense``: a lecun-normal kernel and a zero bias."""
    layer = nn.Linear(in_dim, out_dim)
    lecun_normal_(layer.weight.data.T, generator)
    nn.init.zeros_(layer.bias)
    return layer


def degraded_heads(dim: int, num_heads: int) -> int:
    """Drop ``num_heads`` until it divides the width, as the JAX heads do."""
    while dim % num_heads != 0 and num_heads > 1:
        num_heads -= 1
    return num_heads


def attention_mask(padding_mask: Optional[torch.Tensor], seq: int) -> Optional[torch.Tensor]:
    """``[B, 1, 1, T]`` True where a key is attended, or None when the mask
    does not match the sequence (a raw-audio mask)."""
    if padding_mask is None or padding_mask.shape[1] != seq:
        return None
    return ~padding_mask.bool()[:, None, None, :]


class LinearHead(nn.Module):
    """A single linear classifier."""

    def __init__(self, in_dim: int, num_classes: int, generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.classifier = dense(in_dim, num_classes, generator)

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        return self.classifier(x)


class MLPHead(nn.Module):
    """Dense layers with an activation and dropout, then the classifier."""

    def __init__(
        self,
        in_dim: int,
        num_classes: int,
        hidden_dims: Sequence[int] = (512, 256),
        activation: str = "relu",
        dropout_rate: float = 0.1,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.activation, self.dropout_rate = activation, dropout_rate
        self.num_hidden = len(hidden_dims)
        for i, width in enumerate(hidden_dims):
            self.add_module(f"hidden_{i}", dense(in_dim, width, generator))
            in_dim = width
        self.classifier = dense(in_dim, num_classes, generator)

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        act = _ACTIVATIONS[self.activation]
        for i in range(self.num_hidden):
            x = act(getattr(self, f"hidden_{i}")(x))
            x = dropout(x, self.dropout_rate, deterministic, generator)
        return self.classifier(x)


class MoEHead(nn.Module):
    """Top-k routed mixture-of-experts MLP (``ops/moe.py``), exact GELU,
    dropout, then the classifier."""

    def __init__(
        self,
        in_dim: int,
        num_classes: int,
        num_experts: int = 4,
        moe_hidden_dim: int = 256,
        moe_k: int = 2,
        capacity_factor: float = 2.0,
        dropout_rate: float = 0.1,
        mesh=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.dropout_rate = dropout_rate
        self.moe = MoEMLP(in_dim, num_experts, moe_hidden_dim, moe_hidden_dim, k=moe_k,
                          capacity_factor=capacity_factor, mesh=mesh, generator=generator)
        self.classifier = dense(moe_hidden_dim, num_classes, generator)

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        h = F.gelu(self.moe(x))
        h = dropout(h, self.dropout_rate, deterministic, generator)
        return self.classifier(h)


class LSTMHead(nn.Module):
    """(Bi)LSTM layers over the sequence, mean-pooled, then the classifier.

    The hidden size is ``max(int((max_sequence_length or 4) / 4),
    lstm_hidden_size)``. Layer ``i`` is ``lstm_{i}`` (one direction, or both),
    with the flax cell's gates in torch's i, f, g, o order: the input kernels
    carry no bias (``bias_ih`` stays 0), the hidden kernels do.
    """

    def __init__(
        self,
        in_dim: int,
        num_classes: int,
        lstm_hidden_size: int = 256,
        num_layers: int = 1,
        bidirectional: bool = False,
        dropout_rate: float = 0.1,
        max_sequence_length: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        hidden = max(int((max_sequence_length or 4) / 4), lstm_hidden_size)
        self.num_layers, self.dropout_rate = num_layers, dropout_rate
        directions = 2 if bidirectional else 1
        for i in range(num_layers):
            lstm = nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=bidirectional)
            for name, param in lstm.named_parameters():
                if name.startswith("weight_ih"):  # four [in, hidden] kernels
                    for gate in param.data.view(4, hidden, in_dim):
                        lecun_normal_(gate.T, generator)
                elif name.startswith("weight_hh"):
                    for gate in param.data.view(4, hidden, hidden):
                        nn.init.orthogonal_(gate, generator=generator)
                else:
                    nn.init.zeros_(param)
                    param.requires_grad_(name.startswith("bias_hh"))
            self.add_module(f"lstm_{i}", lstm)
            in_dim = hidden * directions
        self.classifier = dense(in_dim, num_classes, generator)

    def forward(self, x, padding_mask=None, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        for i in range(self.num_layers):
            x, _ = getattr(self, f"lstm_{i}")(x)
            if i < self.num_layers - 1:
                x = dropout(x, self.dropout_rate, deterministic, generator)
        pooled = dropout(x.mean(dim=1), self.dropout_rate, deterministic, generator)
        return self.classifier(pooled)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` (self-attention, with biases):
    ``query``/``key``/``value`` project to ``H·D``, ``out`` back to the width."""

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.dropout_rate = dropout_rate
        for name in ("query", "key", "value", "out"):
            self.add_module(name, dense(dim, dim, generator))
        # flax's DenseGeneral kernels are [E, H, D] and [H, D, E]: fan-in E and H·D
        # are the same as a [E, E] Dense's, so the init above is flax's too.

    def forward(self, x, mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        b, t, _ = x.shape
        heads, depth = self.num_heads, self.head_dim

        def split(t_):
            return t_.view(b, t, heads, depth).transpose(1, 2)  # [B, H, T, D]

        q = split(self.query(x)) * depth**-0.5
        k, v = split(self.key(x)), split(self.value(x))
        logits = torch.matmul(q, k.transpose(-1, -2)).float()
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1)
        if not deterministic and self.dropout_rate > 0.0:
            # one mask for every item and head (flax's broadcast_dropout)
            keep_prob = 1.0 - self.dropout_rate
            if generator is None:
                raise ValueError("attention dropout outside deterministic mode needs a torch.Generator")
            keep = torch.rand((1, 1, t, t), generator=generator, device=x.device) < keep_prob
            weights = torch.where(keep, weights / keep_prob, torch.zeros((), device=x.device))
        out = torch.matmul(weights.to(v.dtype), v).transpose(1, 2).reshape(b, t, heads * depth)
        return self.out(out)


def sinusoidal_encoding(length: int, dim: int) -> np.ndarray:
    """Fixed sinusoidal positional table (the JAX head's ``_sinusoidal_encoding``)."""
    pe = np.zeros((length, dim), dtype=np.float32)
    position = np.arange(length, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * (-np.log(10000.0) / dim))
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)[:, : pe[:, 1::2].shape[1]]
    return pe


class AttentionHead(nn.Module):
    """Residual attention blocks (attention, add, LayerNorm, dropout), mean
    pool, classifier."""

    def __init__(
        self,
        in_dim: int,
        num_classes: int,
        num_heads: int = 8,
        num_layers: int = 2,
        dropout_rate: float = 0.1,
        use_positional_encoding: bool = False,
        max_sequence_length: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        heads = degraded_heads(in_dim, num_heads)
        self.num_layers, self.dropout_rate = num_layers, dropout_rate
        self.use_positional_encoding = use_positional_encoding
        if use_positional_encoding:
            table = sinusoidal_encoding(max_sequence_length or 1000, in_dim)
            self.register_buffer("positions", torch.from_numpy(table), persistent=False)
        for i in range(num_layers):
            self.add_module(f"attention_{i}", MultiHeadAttention(in_dim, heads, dropout_rate, generator))
            self.add_module(f"layer_norm_{i}", nn.LayerNorm(in_dim, eps=LAYER_NORM_EPS))
        self.classifier = dense(in_dim, num_classes, generator)

    def forward(self, x, padding_mask=None, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        if self.use_positional_encoding:
            x = x + self.positions[None, : x.shape[1]]
        mask = attention_mask(padding_mask, x.shape[1])
        for i in range(self.num_layers):
            attn = getattr(self, f"attention_{i}")(x, mask, deterministic, generator)
            x = getattr(self, f"layer_norm_{i}")(x + attn)
            x = dropout(x, self.dropout_rate, deterministic, generator)
        pooled = dropout(x.mean(dim=1), self.dropout_rate, deterministic, generator)
        return self.classifier(pooled)


class TransformerHead(nn.Module):
    """Post-norm transformer encoder blocks (ReLU FFN of width
    ``attention_dim``), mean pool, classifier; an optional learned
    ``pos_encoding``."""

    def __init__(
        self,
        in_dim: int,
        num_classes: int,
        num_heads: int = 8,
        num_layers: int = 2,
        attention_dim: int = 512,
        dropout_rate: float = 0.1,
        use_positional_encoding: bool = False,
        max_sequence_length: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        heads = degraded_heads(in_dim, num_heads)
        self.num_layers, self.dropout_rate = num_layers, dropout_rate
        self.pos_encoding = None
        if use_positional_encoding:
            self.pos_encoding = nn.Parameter(torch.empty(1, max_sequence_length or 1000, in_dim))
            nn.init.normal_(self.pos_encoding, 0.0, 1.0, generator=generator)
        for i in range(num_layers):
            self.add_module(f"block_{i}_attn", MultiHeadAttention(in_dim, heads, dropout_rate, generator))
            self.add_module(f"block_{i}_norm1", nn.LayerNorm(in_dim, eps=LAYER_NORM_EPS))
            self.add_module(f"block_{i}_ff1", dense(in_dim, attention_dim, generator))
            self.add_module(f"block_{i}_ff2", dense(attention_dim, in_dim, generator))
            self.add_module(f"block_{i}_norm2", nn.LayerNorm(in_dim, eps=LAYER_NORM_EPS))
        self.classifier = dense(in_dim, num_classes, generator)

    def forward(self, x, padding_mask=None, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        if self.pos_encoding is not None:
            x = x + self.pos_encoding[:, : x.shape[1]]
        mask = attention_mask(padding_mask, x.shape[1])
        rate = self.dropout_rate
        for i in range(self.num_layers):
            block = lambda name: getattr(self, f"block_{i}_{name}")  # noqa: E731
            attn = block("attn")(x, mask, deterministic, generator)
            x = block("norm1")(x + dropout(attn, rate, deterministic, generator))
            h = dropout(F.relu(block("ff1")(x)), rate, deterministic, generator)
            x = block("norm2")(x + dropout(block("ff2")(h), rate, deterministic, generator))
        pooled = dropout(x.mean(dim=1), rate, deterministic, generator)
        return self.classifier(pooled)

