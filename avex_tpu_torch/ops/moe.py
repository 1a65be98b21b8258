"""Mixture-of-experts MLP with dense dispatch, on one device.

Port of ``avex_tpu/ops/moe.py`` (GShard/Switch routing written as dense
one-hot contractions):

1. an fp32 router picks the top-k experts of each token, renormalises their
   probabilities, and gives each (token, choice) pair a position in its
   expert's capacity buffer by a cumulative sum over the dispatch order:
   choice 0 of every token first, then choice 1, so primary assignments win
   capacity over secondary ones;
2. ``dispatch`` / ``combine`` tensors ``[N, X, C]`` move tokens into
   per-expert batches ``[X, C, E]`` and back by ``einsum``.

The capacity is ``ceil(k·N/X·capacity_factor)``, clipped to [1, N]; pairs
past it are dropped (their combine weight is 0, as in Switch). The dense
``[k·N, X, C]`` dispatch grows as ``O(k²·capacity_factor·N²)`` elements;
:class:`MoEMLP` refuses past ``max_dispatch_elements``. The expert GELU is
the tanh form (``jax.nn.gelu``'s default). Expert parallelism (a mesh and
``shard_moe_params``) is ROADMAP queue 1, item 14, part 3.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MoEMLP", "lecun_normal_", "shard_moe_params", "switch_load_balancing_loss"]

_NOT_PORTED = "expert parallelism over a mesh is not ported (ROADMAP queue 1, item 14, part 3)"


def lecun_normal_(tensor: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal`` on a kernel laid out ``[..., in, out]``: a normal
    truncated at ±2 with variance ``1 / fan_in`` (fan_in = in x the leading
    dimensions), rescaled for the truncation."""
    fan_in = tensor.numel() // tensor.shape[-1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def shard_moe_params(tree: Any, mesh: Any, axis: str = "model") -> Any:
    raise NotImplementedError(f"shard_moe_params: {_NOT_PORTED}")


def switch_load_balancing_loss(router_probs: torch.Tensor, dispatch_mask: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer auxiliary loss ``X · Σ_i f_i · P_i``: ``f`` the
    fraction of tokens dispatched to expert ``i``, ``P`` its mean router
    probability; a uniform router minimises it."""
    num_experts = router_probs.shape[-1]
    tokens_per_expert = dispatch_mask.sum(dim=-1).mean(dim=0)
    prob_per_expert = router_probs.mean(dim=0)
    return num_experts * torch.sum(tokens_per_expert * prob_per_expert)


class MoEMLP(nn.Module):
    """Top-k routed mixture-of-experts MLP over ``[N, E]`` tokens → ``[N, out_dim]``.

    With capacity to spare the output is the dense mixture ``Σ_k w_k ·
    expert_k(x)``; under overflow the dropped pairs add nothing. The
    auxiliary load-balancing loss of the last call is kept in ``aux_loss``
    (the JAX module sows it as ``moe_aux_loss``).
    """

    def __init__(
        self,
        in_dim: int,
        num_experts: int,
        hidden_dim: int,
        out_dim: int,
        k: int = 2,
        capacity_factor: float = 2.0,
        max_dispatch_elements: int = 2**28,
        mesh: Any = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        if mesh is not None:
            raise NotImplementedError(f"MoEMLP(mesh=...): {_NOT_PORTED}")
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.max_dispatch_elements = max_dispatch_elements
        self.router = nn.Linear(in_dim, num_experts)
        self.w1 = nn.Parameter(torch.empty(num_experts, in_dim, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(num_experts, hidden_dim))
        self.w2 = nn.Parameter(torch.empty(num_experts, hidden_dim, out_dim))
        self.b2 = nn.Parameter(torch.zeros(num_experts, out_dim))
        lecun_normal_(self.router.weight.data.T, generator)
        nn.init.zeros_(self.router.bias)
        lecun_normal_(self.w1.data, generator)
        lecun_normal_(self.w2.data, generator)
        self.aux_loss: Optional[torch.Tensor] = None

    def capacity(self, n_tokens: int) -> int:
        """Slots per expert: ``ceil(k·N/X·capacity_factor)`` clipped to [1, N]."""
        return max(1, min(int(math.ceil(self.k * n_tokens / self.num_experts * self.capacity_factor)), n_tokens))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 2:
            raise ValueError(f"MoEMLP expects [N, E] tokens, got {tuple(x.shape)}")
        n_tokens = x.shape[0]
        n_exp, k = self.num_experts, self.k
        if not 1 <= k <= n_exp:
            raise ValueError(f"k={k} must be in [1, num_experts={n_exp}]")
        capacity = self.capacity(n_tokens)
        dispatch_elements = k * n_tokens * n_exp * capacity
        if dispatch_elements > self.max_dispatch_elements:
            raise ValueError(
                f"MoEMLP dense dispatch would materialize {dispatch_elements:,} "
                f"elements ({dispatch_elements * 4 / 2**30:.1f} GB fp32) for "
                f"N={n_tokens} tokens x {n_exp} experts x capacity "
                f"{capacity} — past max_dispatch_elements="
                f"{self.max_dispatch_elements:,}. Dense one-hot dispatch is "
                "O(k^2 * capacity_factor * N^2); chunk the tokens or raise the "
                "cap explicitly if this size is intended."
            )
        x = x.float()
        probs = torch.softmax(F.linear(x, self.router.weight.float(), self.router.bias.float()), dim=-1)
        top_vals, top_idx = torch.topk(probs, k, dim=-1)  # [N, k]
        weights = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)

        # Dispatch order: choice 0 of every token, then choice 1.
        flat = F.one_hot(top_idx.T.reshape(-1), n_exp).float()  # [kN, X]
        position = torch.cumsum(flat, dim=0) - flat
        pos_row = (position * flat).sum(-1)  # [kN]
        keep = (pos_row < capacity).float()
        slot = F.one_hot(pos_row.long().clamp_max(capacity - 1), capacity).float()  # [kN, C]
        disp = ((flat * keep[:, None])[:, :, None] * slot[:, None, :]).reshape(k, n_tokens, n_exp, capacity)
        dispatch = disp.sum(0)  # [N, X, C], 0/1
        combine = (disp * weights.T[:, :, None, None]).sum(0)
        self.aux_loss = switch_load_balancing_loss(probs, dispatch)

        expert_in = torch.einsum("ne,nxc->xce", x, dispatch)
        h = F.gelu(torch.einsum("xce,xeh->xch", expert_in, self.w1) + self.b1[:, None, :], approximate="tanh")
        y = torch.einsum("xch,xho->xco", h, self.w2) + self.b2[:, None, :]
        return torch.einsum("xco,nxc->no", y, combine)
