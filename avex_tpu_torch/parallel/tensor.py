"""Megatron tensor parallelism over the mesh's ``model`` axis.

Port of the placement ``__graft_entry__._tp_shard_params`` gives a trainer's
parameters, with the collectives GSPMD inserts for it written out:

- the tensors cut are the ones JAX cuts, chosen by name and divisibility:
  the 2-D weights of ``fc1``, ``q_proj``, ``k_proj`` and ``v_proj``
  (column-parallel: each rank computes its block of output features, for
  attention its heads) and of ``fc2`` and ``out_proj`` (row-parallel: each
  rank takes its block of input features and gives a partial sum); every
  other tensor, biases included, stays whole on every rank;
- a column-parallel product runs on its rank's output features and slices
  its (whole) bias; a row-parallel product's partial sum is completed by an
  ``all_reduce`` over the model axis before its bias is added
  (:meth:`ModelAxis.leave`); the input of a cut region passes
  :meth:`ModelAxis.enter`, whose backward sums the ranks' input gradients;
- a model's layers read the axis through ``use_model_axis`` (BEATs', EAT's
  and AVES's layers, CLIP's projections): the attention runs on the rank's
  heads, BEATs' fused
  ``qkv_proj`` (whole, as in JAX) gives each rank the rows of its heads out
  of each third;
- under sequence parallelism (``parallel/sequence.py``) the same regions
  gather the time axis on the way in and reduce-scatter it on the way out.

A whole tensor that a rank reads only in part (a column-parallel bias, the
fused ``qkv_proj``, BEATs' gate parameters; under sequence parallelism
every whole tensor of the layers, which sees the rank's positions only)
gets a part of its gradient on each rank: :meth:`TensorParallelLayout.reduce_gradients`
sums those over the model axis. A whole tensor computed alike on every
rank (a LayerNorm between the regions, a row-parallel bias, the frontend,
the head) has its whole gradient on each rank already.

Values are those of the one-device step: only where the sums run changes.
Checkpoints hold whole tensors (:meth:`TensorParallelLayout.gather_tensors`).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Mapping, Optional, Set, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from avex_tpu_torch.parallel import Mesh, all_gather_into, reduce_scatter_into, sum_over_ranks

__all__ = [
    "COLUMN_PARALLEL",
    "ROW_PARALLEL",
    "ModelAxis",
    "TensorParallelLayout",
    "copy_to_model",
    "gather_time",
    "reduce_from_model",
    "scatter_time",
    "sequence_length",
    "time_block",
    "time_span",
    "tp_sharding",
]

#: JAX's names (``__graft_entry__._tp_shard_params``): output features cut
COLUMN_PARALLEL = ("fc1", "q_proj", "k_proj", "v_proj")
#: and input features cut
ROW_PARALLEL = ("fc2", "out_proj")


def tp_sharding(name: str, shape: Tuple[int, ...], model: int) -> Optional[int]:
    """The dimension of parameter ``name`` (a ``named_parameters`` path, torch
    ``[out, in]`` weights) cut over a model axis of ``model`` ranks, or None.

    JAX's rule on its ``[in, out]`` kernels: a 2-D tensor on a path through a
    column-parallel name is cut on its output features, through a
    row-parallel one on its input features, where the axis divides them."""
    parts = name.split(".")
    if len(shape) != 2:
        return None
    if any(p in COLUMN_PARALLEL for p in parts):
        return 0 if shape[0] % model == 0 else None
    if any(p in ROW_PARALLEL for p in parts):
        return 1 if shape[1] % model == 0 else None
    return None


# ---------------------------------------------------------------------------
# The collectives of a region, with their gradients
# ---------------------------------------------------------------------------


class _CopyToModel(torch.autograd.Function):
    """Forward the identity; backward the sum over the model axis (each rank
    gives the gradient of the part it read)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return sum_over_ranks([grad.contiguous()], ctx.mesh)[0], None


class _ReduceFromModel(torch.autograd.Function):
    """Forward the sum over the model axis (the partial sums of a
    row-parallel product); backward the identity (every rank's copy of the
    sum feeds the same computation)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        return sum_over_ranks([x.contiguous()], mesh)[0]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


# The time axis of a sequence of T positions cuts into blocks of ceil(T/n)
# positions, the last ones shorter (GSPMD's uneven sharding): rank r holds
# [r·c, min((r+1)·c, T)). The collectives move blocks padded to c at their
# end, so the gathered buffer's first T rows are the sequence in order.
_SEQUENCE: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar("sequence_length", default=None)


@contextlib.contextmanager
def sequence_length(seq: int) -> Iterator[None]:
    """Inside, the time blocks of sequence parallelism belong to a sequence of
    ``seq`` positions (what a rank's own block cannot tell when T does not
    divide over the axis)."""
    token = _SEQUENCE.set(int(seq))
    try:
        yield
    finally:
        _SEQUENCE.reset(token)


def time_span(seq: int, mesh: Mesh, rank: Optional[int] = None) -> Tuple[int, int]:
    """``(start, stop)`` of rank ``rank``'s (default this rank's) block of ``seq`` positions."""
    rank = mesh.rank if rank is None else rank
    c = -(-seq // mesh.size)
    return min(rank * c, seq), min((rank + 1) * c, seq)


def _whole_length() -> int:
    """The sequence length of the enclosing :func:`sequence_length`: what a
    layer's block of positions belongs to (it cannot tell when T does not
    divide over the axis), so a gather outside one raises."""
    seq = _SEQUENCE.get()
    if seq is None:
        raise ValueError("sequence parallelism: a layer gathered its time blocks outside "
                         "parallel.tensor.sequence_length(...) (the sequence parallelism runner sets it)")
    return seq


def _major(x: torch.Tensor, dim: int, length: int) -> torch.Tensor:
    """``x`` with axis ``dim`` first, padded with zeros at its end to ``length``."""
    rows = x.movedim(dim, 0)
    if rows.shape[0] < length:
        rows = torch.cat([rows, rows.new_zeros((length - rows.shape[0],) + tuple(rows.shape[1:]))])
    return rows.contiguous()


def gather_time(x: torch.Tensor, mesh: Mesh, seq: int, dim: int = 1) -> torch.Tensor:
    """This rank's block of a sequence of ``seq`` positions (axis ``dim``) on
    each rank → the whole sequence, the ranks' blocks in order."""
    c = -(-seq // mesh.size)
    rows = _major(x, dim, c)
    out = rows.new_empty((mesh.size * c,) + tuple(rows.shape[1:]))
    return all_gather_into(out, rows, mesh)[:seq].movedim(0, dim)


def scatter_time(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """The whole sequence (axis ``dim``) on each rank → this rank's block of
    the sum over ranks."""
    seq = x.shape[dim]
    c = -(-seq // mesh.size)
    rows = _major(x, dim, mesh.size * c)
    out = rows.new_empty((c,) + tuple(rows.shape[1:]))
    start, stop = time_span(seq, mesh)
    return reduce_scatter_into(out, rows, mesh)[:stop - start].movedim(0, dim)


def time_block(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x``'s time axis (axis ``dim``)."""
    start, stop = time_span(x.shape[dim], mesh)
    return x.narrow(dim, start, stop - start)


class _GatherTime(torch.autograd.Function):
    """Forward the all-gather over T; backward the reduce-scatter (each rank's
    computation on the whole sequence gives a part of every position's gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, seq):
        ctx.mesh = mesh
        return gather_time(x, mesh, seq)

    @staticmethod
    def backward(ctx, grad):
        return scatter_time(grad, ctx.mesh), None, None


class _ScatterTime(torch.autograd.Function):
    """Forward the reduce-scatter over T; backward the all-gather."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.seq = mesh, x.shape[1]
        return scatter_time(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return gather_time(grad, ctx.mesh, ctx.seq), None


class _TimeBlock(torch.autograd.Function):
    """Forward this rank's block of a tensor that every rank computed whole;
    backward the block's gradient in place, zeros elsewhere (the others'
    blocks are theirs to answer for)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.shape = mesh, x.shape
        return time_block(x, mesh).contiguous()

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_zeros(ctx.shape)
        time_block(out, ctx.mesh).copy_(grad)
        return out, None


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the model axis of the ranks' partial sums ``x``; its
    gradient passes to every rank as it is (each rank's copy of the sum feeds
    the same computation)."""
    return _ReduceFromModel.apply(x, mesh) if mesh.size > 1 else x


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the model axis: for an input
    that every rank reads in part (a shared bias's heads, a pipeline stage's
    microbatches)."""
    return _CopyToModel.apply(x, mesh) if mesh.size > 1 else x


class ModelAxis:
    """How a region of a layer (an attention, an MLP) crosses the model axis.

    ``mesh`` is the model axis (``Mesh.model_axis``). Without ``sequence`` a
    cut region's input is copied in (:class:`_CopyToModel`) and its partial
    sums reduced out; with it the activations between regions hold this
    rank's block of positions, ``[B, T/n, E]``: a region gathers the time axis
    on the way in and, cut, reduce-scatters it on the way out, or, whole
    (an attention that needs every key), keeps its block of positions.
    """

    def __init__(self, mesh: Mesh, sequence: bool = False) -> None:
        self.mesh, self.sequence = mesh, sequence
        self.size, self.rank = mesh.size, mesh.rank

    def enter(self, x: torch.Tensor, cut: bool) -> torch.Tensor:
        if self.sequence:
            return _GatherTime.apply(x, self.mesh, _whole_length())
        return _CopyToModel.apply(x, self.mesh) if cut else x

    def leave(self, y: torch.Tensor, cut: bool) -> torch.Tensor:
        if self.sequence:
            return _ScatterTime.apply(y, self.mesh) if cut else _TimeBlock.apply(y, self.mesh)
        return _ReduceFromModel.apply(y, self.mesh) if cut else y

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` items (features, heads)."""
        if n % self.size:
            raise ValueError(f"{n} not divisible over a model axis of {self.size}")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def column_rows(layer: nn.Linear) -> Optional[slice]:
    """The output features a column-parallel ``layer`` computes on this rank
    (None for a whole layer)."""
    return getattr(layer, "tp_rows", None)


def linear_bias(layer: nn.Module) -> Optional[torch.Tensor]:
    """``layer``'s bias, the rank's block of it for a column-parallel layer."""
    bias = layer.bias
    rows = column_rows(layer)
    return bias[rows] if bias is not None and rows is not None else bias


def row_parallel_dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A row-parallel product: the partial sum over this rank's input
    features, completed over the model axis, then the whole bias."""
    axis: ModelAxis = layer.tp_axis
    y = axis.leave(F.linear(x.to(dtype), layer.weight.to(dtype)), cut=True)
    return y + layer.bias.to(dtype) if layer.bias is not None else y


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------


class TensorParallelLayout:
    """The tensor-parallel placement of ``module``'s parameters over the
    model axis of ``mesh``: ``cut[name]`` is the dimension cut, for the
    tensors of :func:`tp_sharding`; ``partial`` the whole tensors whose
    gradient is a sum over the axis's ranks. ``sequence`` adds Megatron-SP
    (``parallel/sequence.py``). ``axis`` names the mesh axis the tensors are
    cut over: ``model``, or ``tp`` inside the pipeline stages of a 3-D mesh
    (``parallel/pipeline.shard_pipeline_params``).

    On construction the module holds this rank's blocks and its layers run
    their part (``use_model_axis``); a cut tensor outside every module with
    that hook raises, since nothing would sum its input's gradient. Every
    rank must build it, and call :meth:`reduce_gradients` and
    :meth:`gather_tensors`, together.
    """

    def __init__(self, module: nn.Module, mesh: Mesh, sequence: bool = False, axis: str = "model") -> None:
        self.mesh = mesh.axis(axis) if axis != "model" else mesh.model_axis
        if self.mesh.size < 2:
            raise ValueError(f"tensor and sequence parallelism need a {axis} axis of two ranks or more")
        self.sequence = sequence
        self.axis = ModelAxis(self.mesh, sequence)
        self.params: Dict[str, nn.Parameter] = dict(module.named_parameters())
        self.full_shape = {n: tuple(p.shape) for n, p in self.params.items()}
        self.cut = {n: d for n, p in self.params.items()
                    if (d := tp_sharding(n, tuple(p.shape), self.mesh.size)) is not None}
        hooked = [(prefix, sub.use_model_axis) for prefix, sub in module.named_modules()
                  if hasattr(sub, "use_model_axis")]
        unclaimed = [n for n in self.cut if not any(not p or n.startswith(p + ".") for p, _ in hooked)]
        if unclaimed:
            raise ValueError(f"tensor parallelism: {type(module).__name__} cuts {unclaimed[:4]} in no "
                             "module with a use_model_axis hook")
        self.partial: Set[str] = set()
        for prefix, hook in hooked:
            own = {n[len(prefix) + 1:] if prefix else n for n in self.cut
                   if (n.startswith(prefix + ".") or not prefix)}
            for local in hook(self.axis, own) or ():
                self.partial.add(f"{prefix}.{local}" if prefix else local)
        self.partial -= set(self.cut)
        for name, dim in self.cut.items():
            self.params[name].data = self.local_of(name, self.params[name].data)
        for prefix, sub in module.named_modules():
            if isinstance(sub, nn.Linear):
                weight = f"{prefix}.weight"
                if self.cut.get(weight) == 0:
                    sub.tp_rows = self.axis.block(sub.out_features)
                elif self.cut.get(weight) == 1:
                    sub.tp_axis = self.axis

    def split(self, name: str) -> bool:
        """Whether ``name``'s tensor is cut over the model axis."""
        return name in self.cut

    def local_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor of parameter ``name`` (the tensor
        itself for a whole one)."""
        dim = self.cut.get(name)
        if dim is None:
            return full
        size = full.shape[dim] // self.mesh.size
        return full.narrow(dim, self.mesh.rank * size, size).clone(memory_format=torch.contiguous_format)

    def local_state(self, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A whole state dict (a checkpoint's) → the module's layout."""
        return {n: self.local_of(n, t) if n in self.cut else t for n, t in state.items()}

    def reduce_gradients(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients with those of :attr:`partial` summed over the model
        axis (one ``all_reduce`` of a flat buffer per dtype)."""
        out = dict(grads)
        names = [n for n in grads if n in self.partial]
        for n, g in zip(names, sum_over_ranks([grads[n] for n in names], self.mesh)):
            out[n] = g
        return out

    def gather_tensors(self, blocks: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole tensors of ``blocks`` (name → this rank's block, of a
        parameter or of a moment that follows it; whole ones pass through)."""
        out = dict(blocks)
        for name, block in blocks.items():
            dim = self.cut.get(name)
            if dim is None:
                continue
            rows = block.movedim(dim, 0).contiguous()
            gathered = all_gather_into(rows.new_empty((self.mesh.size * rows.shape[0],) + tuple(rows.shape[1:])),
                                       rows, self.mesh)
            out[name] = gathered.movedim(0, dim).contiguous()
        return out


def whole_names(module: nn.Module, cut: Set[str]) -> List[str]:
    """``module``'s parameter names, less the cut ones: what a region hands
    back as read in part under sequence parallelism."""
    return [n for n, _ in module.named_parameters() if n not in cut]
