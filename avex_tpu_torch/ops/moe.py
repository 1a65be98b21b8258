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
the tanh form (``jax.nn.gelu``'s default).

Expert parallelism (:func:`shard_moe_params`, JAX's placement with GSPMD's
collectives written out): every expert-major tensor (``w1``, ``b1``,
``w2``, ``b2`` on a path through a ``moe`` module, its leading axis
divisible by the axis size) keeps one slice of experts per rank of the mesh
axis; the router and everything else stay whole. Each rank routes every
token (the router is whole), runs its own experts on their tokens, and the
combine's partial sums are summed over the axis; the tokens and the combine
weights enter the cut region through ``copy_to_model``, so the router's
gradient is the sum of the ranks' parts, the one-process gradient.
Checkpoints hold whole tensors (:meth:`ExpertParallelLayout.gather_tensors`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.parallel import Mesh, all_gather_into
from avex_tpu_torch.parallel.tensor import copy_to_model, reduce_from_model

__all__ = [
    "EXPERT_PARAM_NAMES",
    "ExpertParallelLayout",
    "MoEMLP",
    "lecun_normal_",
    "moe_sharding",
    "shard_moe_params",
    "switch_load_balancing_loss",
]

#: expert-major parameters of :class:`MoEMLP` (``[num_experts, ...]``)
EXPERT_PARAM_NAMES = frozenset({"w1", "b1", "w2", "b2"})


def lecun_normal_(tensor: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal`` on a kernel laid out ``[..., in, out]``: a normal
    truncated at ±2 with variance ``1 / fan_in`` (fan_in = in x the leading
    dimensions), rescaled for the truncation."""
    fan_in = tensor.numel() // tensor.shape[-1]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def moe_sharding(name: str, shape: Tuple[int, ...], size: int) -> Optional[int]:
    """The dimension of parameter ``name`` cut over an expert axis of
    ``size`` ranks (0, the experts), or None: JAX's rule, an expert-major
    leaf under a ``moe`` module whose expert count the axis divides."""
    parts = name.split(".")
    if "moe" in parts[:-1] and parts[-1] in EXPERT_PARAM_NAMES and len(shape) >= 1 and shape[0] % size == 0:
        return 0
    return None


class ExpertParallelLayout:
    """The expert-parallel placement of ``module``'s MoE tensors over a mesh
    axis: ``cut[name]`` is 0 for each tensor of :func:`moe_sharding`. On
    construction the module holds this rank's experts and each
    :class:`MoEMLP` whose experts are cut runs its own. Every rank builds it
    together; a gradient needs no sum (a rank's experts are its own, the
    whole tensors get the whole gradient through the cut region's
    ``copy_to_model``)."""

    def __init__(self, module: nn.Module, mesh: Mesh, axis: str = "model") -> None:
        self.mesh = mesh.axis(axis)
        self.params: Dict[str, nn.Parameter] = dict(module.named_parameters())
        size = self.mesh.size
        self.cut = {n: 0 for n, p in self.params.items()
                    if size > 1 and moe_sharding(n, tuple(p.shape), size) is not None}
        for prefix, sub in module.named_modules():
            if isinstance(sub, MoEMLP) and f"{prefix}.w1" in self.cut:
                sub.expert_mesh, sub.experts = self.mesh, self.block(sub.num_experts)
        for name in self.cut:
            self.params[name].data = self.local_of(name, self.params[name].data)

    def block(self, n: int) -> slice:
        """This rank's experts of ``n``."""
        k = n // self.mesh.size
        return slice(self.mesh.rank * k, (self.mesh.rank + 1) * k)

    def split(self, name: str) -> bool:
        """Whether ``name``'s tensor is cut over the axis."""
        return name in self.cut

    def local_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's experts of a whole tensor of parameter ``name`` (the
        tensor itself for a whole one)."""
        if name not in self.cut:
            return full
        return full[self.block(full.shape[0])].clone()

    def gather_tensors(self, blocks: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole tensors of ``blocks`` (name → this rank's experts of a
        parameter or of a moment that follows it; whole ones pass through)."""
        out = dict(blocks)
        for name, block in blocks.items():
            if name in self.cut:
                block = block.contiguous()
                whole = block.new_empty((self.mesh.size * block.shape[0],) + tuple(block.shape[1:]))
                out[name] = all_gather_into(whole, block, self.mesh)
        return out

    def whole(self, module: nn.Module) -> None:
        """Put the whole tensors back into ``module`` and let its MoE layers
        run every expert again (what a probe holds after training)."""
        params = dict(module.named_parameters())
        gathered = self.gather_tensors({n: params[n].data for n in self.cut})
        for name, value in gathered.items():
            params[name].data = value
        for sub in module.modules():
            if isinstance(sub, MoEMLP):
                sub.expert_mesh, sub.experts = None, None


def shard_moe_params(module: nn.Module, mesh: Mesh, axis: str = "model") -> ExpertParallelLayout:
    """Expert-parallel placement of ``module``'s MoE tensors over ``mesh``'s
    ``axis`` (JAX's ``shard_moe_params``): every expert-major tensor keeps
    one slice of experts per rank, the router and the rest stay whole.
    Returns the layout; the module holds this rank's experts."""
    return ExpertParallelLayout(module, mesh, axis)


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
        if mesh is not None:  # JAX's field; here the placement is shard_moe_params's
            raise ValueError("MoEMLP(mesh=...): the experts are placed over a mesh by shard_moe_params")
        #: the expert axis (a one-axis mesh) and this rank's experts, when cut
        self.expert_mesh: Optional[Mesh] = None
        self.experts: Optional[slice] = None
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

        if self.expert_mesh is not None:  # this rank's experts; the partial sums summed over the axis
            x, combine = copy_to_model(x, self.expert_mesh), copy_to_model(combine, self.expert_mesh)
            dispatch, combine = dispatch[:, self.experts], combine[:, self.experts]
        expert_in = torch.einsum("ne,nxc->xce", x, dispatch)
        h = F.gelu(torch.einsum("xce,xeh->xch", expert_in, self.w1) + self.b1[:, None, :], approximate="tanh")
        y = torch.einsum("xch,xho->xco", h, self.w2) + self.b2[:, None, :]
        out = torch.einsum("xco,nxc->no", y, combine)
        return reduce_from_model(out, self.expert_mesh) if self.expert_mesh is not None else out
