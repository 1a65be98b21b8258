"""GPipe pipeline parallelism over the mesh's ``model`` axis.

Port of ``avex_tpu/parallel/pipeline.py``. JAX runs the schedule as one
``lax.scan`` inside a ``shard_map`` and lets ``ppermute`` and ``psum``
transpose for the backward; here the same schedule runs eagerly and
autograd goes back through each collective's own backward:

- stage ``s`` of ``S`` holds layers ``[s·L/S, (s+1)·L/S)`` of the stack
  (:func:`shard_pipeline_params`: the other stages' layers are released
  from this rank, and gathered whole for a checkpoint);
- the local batch splits into ``M`` microbatches; at tick ``t`` stage ``s``
  runs microbatch ``t - s`` through its layers and hands the result to stage
  ``s + 1`` (:func:`~avex_tpu_torch.parallel.ring_shift`, whose backward is
  the shift the other way); a stage with no microbatch at a tick (the
  bubble, a share ``(S-1)/(M+S-1)`` of the ticks) runs nothing;
- the per-example side inputs (a padding mask) are on every stage already,
  so each stage takes its microbatch's rows of them;
- the last stage's outputs reach every stage rank (JAX's ``psum`` of the
  last stage's buffer), and the head and the loss run on each; the backward
  hands the cotangent to the last stage once, as the ``psum``'s transpose
  does, not once per stage;
- the stack's input enters through ``copy_to_model``: only stage 0 reads it,
  and the sum of the stages' input gradients gives every rank the frontend's
  whole gradient.

Every stage runs the same collectives in the same order, forward and
backward: a stage that reads a value only to discard it (stage 0's
received activations) still takes it into its graph. ``S == 1`` is the
sequential loop.

The 3-D cell (dp x pp x tp, ``shard_pipeline_params(tp_axis="tp")`` on a
``make_mesh(data, model, tp=...)`` mesh): the stages go on ``model`` and
each stage's products are cut over ``tp`` by the Megatron layout of
``parallel/tensor.py`` (column-parallel ``fc1``, ``q/k/v_proj``,
row-parallel ``fc2``, ``out_proj``, a rank running its heads), which
computes the same function. JAX places the cut differently: it cuts the
last dimension of every stacked leaf of two or more dimensions over
``tp`` (the kernels' output features, the stacked biases and LayerNorm
scales too) and lets GSPMD insert the collectives; the values are the
same, the tensors each rank holds and the collectives that run are not.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from avex_tpu_torch.parallel import Mesh, broadcast_from, ring_shift, sum_over_ranks
from avex_tpu_torch.parallel.tensor import TensorParallelLayout, copy_to_model

__all__ = [
    "PipelineLayout",
    "StageTensorLayout",
    "bubble_share",
    "make_pipeline_runner",
    "pipeline_apply",
    "pipeline_microbatch_count",
    "shard_pipeline_params",
]

class _RingShift(torch.autograd.Function):
    """Forward: each stage's tensor to the next stage; backward: each
    gradient back to the stage it came from."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return ring_shift(x, mesh, 1)

    @staticmethod
    def backward(ctx, grad):
        return ring_shift(grad, ctx.mesh, -1), None


class _FromLastStage(torch.autograd.Function):
    """Forward: the last stage's tensor on every stage; backward: the
    cotangent to the last stage, once (every stage runs the same head on the
    same values, so their cotangents are equal)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.last = mesh.rank == mesh.size - 1
        return broadcast_from(x.contiguous().clone(), mesh.size - 1, mesh)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else torch.zeros_like(grad)), None


def _check_kept(kept: bool, mesh: Mesh, h: torch.Tensor, out: Optional[torch.Tensor]) -> None:
    """Raise on every stage when a stage's layers changed the activation's
    shape (JAX checks it with ``eval_shape`` before the schedule runs; here
    the stages agree on it, so none is left waiting in a collective)."""
    flag = torch.tensor([0.0 if kept else 1.0], device=h.device)
    if sum_over_ranks([flag], mesh)[0].item():
        got = f"{tuple(out.shape)} {out.dtype}" if out is not None else "another shape on another stage"
        raise ValueError(f"pipeline_apply: layer_fn must preserve activation shape; got {got} "
                         f"from {tuple(h.shape)} {h.dtype}")


def bubble_share(stages: int, microbatches: int) -> float:
    """The share of a stage's ticks that run nothing: ``(S-1)/(M+S-1)``."""
    return (stages - 1) / (microbatches + stages - 1)


def pipeline_apply(
    layer_fn: Callable,
    layers: Sequence[nn.Module],
    x: torch.Tensor,
    batched: Sequence[Any] = (),
    shared: Sequence[Any] = (),
    *,
    mesh: Mesh,
    num_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """Run ``x`` (this rank's batch) through ``layers``, pipelined over
    ``mesh``'s model axis.

    ``layer_fn(layer, h, *batched, *shared)`` runs one layer and keeps
    ``h``'s shape; ``batched`` are per-example side inputs (``[B, ...]``, a
    key padding mask) and ``shared`` batch-independent ones (a position
    bias). ``num_microbatches`` is M (default S); the batch must divide by
    it. The result is on every stage, the value of the sequential loop.
    """
    batched, shared = tuple(batched), tuple(shared)
    stages_mesh = mesh.model_axis
    stages, n_layers = stages_mesh.size, len(layers)
    if n_layers % stages:
        raise ValueError(f"pipeline_apply: {n_layers} layers not divisible into {stages} stages")
    if stages == 1:
        for layer in layers:
            x = layer_fn(layer, x, *batched, *shared)
        return x
    n_micro = int(num_microbatches or stages)
    batch = int(x.shape[0])
    if batch % n_micro:
        raise ValueError(f"pipeline_apply: per-device batch {batch} not divisible into {n_micro} microbatches")
    stage, per_stage, rows = stages_mesh.rank, n_layers // stages, batch // n_micro
    mine = list(layers)[stage * per_stage:(stage + 1) * per_stage]

    x = copy_to_model(x, stages_mesh)
    x_mb = x.reshape((n_micro, rows) + tuple(x.shape[1:]))
    batched_mb = [b.reshape((n_micro, rows) + tuple(b.shape[1:])) for b in batched]
    first = torch.tensor(stage == 0, device=x.device)
    received = torch.zeros_like(x_mb[0])
    outputs = []
    ticks = n_micro + stages - 1
    for t in range(ticks):
        h = torch.where(first, x_mb[min(t, n_micro - 1)], received)
        micro = t - stage
        kept = True
        if 0 <= micro < n_micro:
            extras = [b[micro] for b in batched_mb]
            out = h
            for layer in mine:
                out = layer_fn(layer, out, *extras, *shared)
            kept = out.shape == h.shape and out.dtype == h.dtype
            if kept:
                h = out
        if t < stages:  # each stage's first microbatch: every stage learns whether its layers kept the shape
            _check_kept(kept, stages_mesh, h, None if kept else out)
        if t >= stages - 1:
            outputs.append(h)  # the last stage finished microbatch t - S + 1
        if t < ticks - 1:
            received = _RingShift.apply(h, stages_mesh)
    return _FromLastStage.apply(torch.cat(outputs), stages_mesh)


def make_pipeline_runner(
    mesh: Mesh,
    num_microbatches: Optional[int] = None,
) -> Callable:
    """A layer-stack runner bound to a mesh, in the shape model modules
    expect (``layer_runner``): ``runner(layer_fn, layers, x, batched, shared)``."""
    return partial(pipeline_apply, mesh=mesh, num_microbatches=num_microbatches)


def pipeline_microbatch_count(mesh: Mesh) -> int:
    """Default microbatch count: one per stage (a bubble of about half the ticks)."""
    return int(mesh.model_size)


def _stage_index(name: str, markers: Tuple[str, ...]) -> Optional[Tuple[str, int]]:
    """``(stack path, layer index)`` of a parameter under a ``markers`` list
    (``...layers.3.fc1.weight`` → ``("...layers", 3)``), or None."""
    parts = name.split(".")
    for i, part in enumerate(parts[:-1]):
        if part in markers and parts[i + 1].isdigit():
            return ".".join(parts[:i + 1]), int(parts[i + 1])
    return None


class PipelineLayout:
    """The stage placement of ``module``'s layer stacks over ``mesh``'s model
    axis: ``owner[name]`` is the stage that holds a layer's parameter (stage
    ``s`` the layers ``[s·L/S, (s+1)·L/S)`` of each stack whose length the
    stage count divides); every other parameter is whole on every rank. The
    module keeps its own stage's layers; the others' parameters hold no
    elements (:meth:`gather_tensors` gives them whole, for a checkpoint)."""

    def __init__(self, module: nn.Module, mesh: Mesh, marker: Any = ("layers", "blocks")) -> None:
        markers = (marker,) if isinstance(marker, str) else tuple(marker)
        self.mesh = mesh.model_axis
        self.params: Dict[str, nn.Parameter] = dict(module.named_parameters())
        self.full_shape = {n: tuple(p.shape) for n, p in self.params.items()}
        found = {n: idx for n in self.params if (idx := _stage_index(n, markers)) is not None}
        lengths: Dict[str, int] = {}
        for stack, layer in found.values():
            lengths[stack] = max(lengths.get(stack, 0), layer + 1)
        self.owner = {n: layer // (lengths[stack] // self.mesh.size) for n, (stack, layer) in found.items()
                      if lengths[stack] % self.mesh.size == 0}
        self.release()

    def split(self, name: str) -> bool:
        """Whether ``name``'s tensor lives on one stage only."""
        return name in self.owner

    def mine(self, name: str) -> bool:
        return self.owner.get(name, self.mesh.rank) == self.mesh.rank

    def local_of(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """What this rank keeps of a whole tensor of parameter ``name``."""
        return full if self.mine(name) else full.new_empty(0)

    def local_state(self, state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A whole state dict (a checkpoint's) → the module's layout."""
        return {n: self.local_of(n, t) if n in self.owner else t for n, t in state.items()}

    def reduce_gradients(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients as they are: a stage's layers are its own, and every
        rank holds the whole gradient of the rest (``copy_to_model`` at the
        stack's entry, the last stage's cotangent once at its exit)."""
        return dict(grads)

    def gather_tensors(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors on every rank from each stage's own (name → this
        rank's tensor of a parameter or of a moment that follows it): one
        broadcast of a flat buffer per stage and dtype."""
        out = dict(tensors)
        for stage in range(self.mesh.size):
            names = [n for n in tensors if self.owner.get(n) == stage]
            by_dtype: Dict[torch.dtype, list] = {}
            for n in names:
                by_dtype.setdefault(tensors[n].dtype, []).append(n)
            for group in by_dtype.values():
                full = [tensors[n] if stage == self.mesh.rank
                        else tensors[n].new_empty(self.full_shape[n]) for n in group]
                flat = broadcast_from(_flatten_dense_tensors(full), stage, self.mesh)
                for n, value in zip(group, _unflatten_dense_tensors(flat, full)):
                    out[n] = value
        return out

    def release(self) -> None:
        """The module keeps its own stage's layers only."""
        for name in self.owner:
            if not self.mine(name):
                self.params[name].data = self.params[name].data.new_empty(0)


class StageTensorLayout:
    """The 3-D placement: the tensor-parallel cut over the ``tp`` axis
    (``tensor``, made first, on whole tensors), then the stages over the
    model axis (``stages``, on the cut ones). A parameter is split when
    either cuts it."""

    def __init__(self, tensor: TensorParallelLayout, stages: PipelineLayout) -> None:
        self.tensor, self.stages = tensor, stages
        self.cut, self.owner = tensor.cut, stages.owner

    def reduce_gradients(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The whole tensors a stage's ranks each read in part summed over
        ``tp`` (a stage's layers are its own)."""
        return self.tensor.reduce_gradients(self.stages.reduce_gradients(grads))

    def gather_tensors(self, tensors: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors on every rank: each stage's (cut) tensors from its
        ranks, then the cut pieces over ``tp``."""
        return self.tensor.gather_tensors(self.stages.gather_tensors(tensors))


def shard_pipeline_params(
    module: nn.Module,
    mesh: Mesh,
    marker: Any = ("layers", "blocks"),
    tp_axis: Optional[str] = None,
):
    """Place ``module``'s layer stacks one stage per rank of ``mesh``'s model
    axis (every parameter under a ``marker`` list: ``layers`` for the BEATs
    and AVES encoders, ``blocks`` for EAT's and Bird-MAE's); everything else
    stays whole. With ``tp_axis`` (a third mesh axis, the 3-D cell) each
    stage's products are also cut over that axis
    (:class:`StageTensorLayout`; the module docstring says how the cut
    differs from JAX's)."""
    if tp_axis is None:
        return PipelineLayout(module, mesh, marker)
    if tp_axis == "model":
        raise ValueError("shard_pipeline_params: tp_axis must be another mesh axis than the stages' 'model'")
    tensor = TensorParallelLayout(module, mesh, axis=tp_axis)
    return StageTensorLayout(tensor, PipelineLayout(module, mesh, marker))
