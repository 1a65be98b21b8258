"""The ZeRO-3 layout: each large parameter cut over the data axis.

Stands for what XLA does with ``avex_tpu.parallel.shard_params_fsdp`` and
``fsdp_tree_shardings`` under a jitted step: a tensor of at least
``fsdp_min_size`` elements is cut along the axis that
:func:`~avex_tpu_torch.parallel.fsdp_sharding` picks (the largest one the
mesh size divides) and every rank keeps its block; the rest is replicated.
Optimizer moments are made from the blocks, so they follow their
parameters. Around a step:

- :meth:`FSDPLayout.gather` puts the whole tensors into the module before
  the forward (all of them at once: gathering layer by layer is later
  work), one all-gather of a flat buffer per dtype;
- :meth:`FSDPLayout.reduce_gradients` turns the full gradients into this
  rank's block of their mean over ranks (a reduce-scatter per dtype) and
  averages the replicated ones;
- :meth:`FSDPLayout.release` puts the blocks back, and the optimizer
  updates them in place.

Between steps the module holds this rank's blocks: the parameter and moment
memory of the cut tensors drops by the mesh size. A post-update that works
element by element on tensors of one layout (EAT-SSL's EMA teacher, which
takes its student's placement) runs on the blocks as it is.

Every rank must call these methods together: each is collective.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn

from avex_tpu_torch.parallel import Mesh, all_gather_into, fsdp_sharding, reduce_scatter_into, sum_over_ranks

__all__ = ["FSDPLayout"]


class FSDPLayout:
    """The ZeRO-3 placement of ``module``'s parameters over ``mesh``.

    ``axis[name]`` is the cut axis of a parameter, or None where it is
    replicated (``axes`` names it for some, :func:`fsdp_sharding` for the
    rest); ``shards[name]`` this rank's block of a cut one.
    """

    def __init__(self, module: nn.Module, mesh: Mesh, min_size: int = 2**16,
                 axes: Optional[Mapping[str, Optional[int]]] = None) -> None:
        self.mesh = mesh
        self.params: Dict[str, nn.Parameter] = dict(module.named_parameters())
        axes = axes or {}
        self.axis = {n: axes[n] if n in axes else fsdp_sharding(tuple(p.shape), mesh, min_size)
                     for n, p in self.params.items()}
        self.full_shape = {n: tuple(p.shape) for n, p in self.params.items()}
        self.shards: Dict[str, torch.Tensor] = {
            n: self.shard_of(n, p.data) for n, p in self.params.items() if self.axis[n] is not None
        }

    @property
    def sharded(self) -> List[str]:
        """The names of the cut parameters."""
        return list(self.shards)

    def shard_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``, a tensor of parameter ``name``'s shape."""
        axis = self.axis[name]
        size = full.shape[axis] // self.mesh.size
        return full.narrow(axis, self.mesh.rank * size, size).clone(memory_format=torch.contiguous_format)

    # -- collectives over flat buffers ----------------------------------------

    def _by_dtype(self, tensors: Mapping[str, torch.Tensor]) -> Dict[torch.dtype, List[str]]:
        groups: Dict[torch.dtype, List[str]] = {}
        for name, t in tensors.items():
            groups.setdefault(t.dtype, []).append(name)
        return groups

    def _rows(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t`` with the cut axis first: a full tensor's rank blocks are then
        its ``size`` equal runs of rows."""
        return t.movedim(self.axis[name], 0)

    def gather_tensors(self, blocks: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole tensors of ``blocks`` (name → this rank's block, of a cut
        parameter or of a moment that follows it)."""
        out: Dict[str, torch.Tensor] = {}
        for names in self._by_dtype(blocks).values():
            local = torch.cat([self._rows(n, blocks[n]).reshape(-1) for n in names])
            gathered = all_gather_into(local.new_empty(self.mesh.size * local.numel()), local, self.mesh)
            gathered = gathered.view(self.mesh.size, -1)
            offset = 0
            for n in names:
                rows = self._rows(n, blocks[n])
                k = rows.numel()
                full_shape = (self.mesh.size * rows.shape[0],) + tuple(rows.shape[1:])
                out[n] = gathered[:, offset:offset + k].reshape(full_shape).movedim(0, self.axis[n]).contiguous()
                offset += k
        return out

    def reduce_gradients(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full gradients (name → gradient of the whole parameter) → the mean
        over ranks: this rank's block for a cut parameter, the whole tensor
        for a replicated one."""
        out: Dict[str, torch.Tensor] = {}
        replicated = [n for n in grads if self.axis[n] is None]
        for n, g in zip(replicated, sum_over_ranks([grads[n] for n in replicated], self.mesh)):
            out[n] = g.div_(self.mesh.size)
        cut = {n: grads[n] for n in grads if self.axis[n] is not None}
        for names in self._by_dtype(cut).values():
            blocks = torch.cat([self._rows(n, cut[n]).reshape(self.mesh.size, -1) for n in names], dim=1)
            mine = reduce_scatter_into(blocks.new_empty(blocks.shape[1]), blocks, self.mesh)
            offset = 0
            for n in names:
                shard = self.shards[n]
                rows_shape = self._rows(n, shard).shape
                k = shard.numel()
                out[n] = mine[offset:offset + k].view(rows_shape).movedim(0, self.axis[n]).contiguous()
                out[n].div_(self.mesh.size)
                offset += k
        return out

    # -- placement --------------------------------------------------------------

    def gather(self) -> None:
        """The module holds whole parameters (before a forward, a save)."""
        for name, full in self.gather_tensors(self.shards).items():
            self.params[name].data = full

    def release(self, update: bool = False) -> None:
        """The module holds this rank's blocks again; with ``update`` the
        blocks are first taken from the whole parameters (after a load)."""
        for name in self.shards:
            if update:
                self.shards[name] = self.shard_of(name, self.params[name].data)
            self.params[name].data = self.shards[name]

    @contextlib.contextmanager
    def unsharded(self, update: bool = False) -> Iterator[None]:
        """Whole parameters inside; blocks again on the way out (taken anew
        from the whole ones with ``update``)."""
        self.gather()
        try:
            yield
        finally:
            self.release(update=update)

    def resident_bytes(self) -> Tuple[int, int]:
        """(bytes of the cut tensors' blocks, bytes of the replicated
        parameters) this rank holds between steps."""
        cut = sum(t.numel() * t.element_size() for t in self.shards.values())
        whole = sum(p.numel() * p.element_size() for n, p in self.params.items() if self.axis[n] is None)
        return cut, whole
