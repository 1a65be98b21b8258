"""Megatron sequence parallelism (Megatron-SP) for a model's layer stack.

Port of ``avex_tpu/parallel/sequence.py``. JAX pins the activations between
layers to ``[B, T/n, E]`` over the ``model`` axis and lets GSPMD choose the
collectives; here they are written out:

- the runner hands each rank its block of positions, ``[B, T/n, E]``, on
  the way into the stack (the backward gathers every block's gradient, so
  the frontend, computed alike on every rank, gets the whole of it) and
  gathers the blocks on the way out (the backward keeps this rank's block);
- between the layers every position-wise op (LayerNorm, residual adds, an
  MLP that tensor parallelism leaves whole) runs on the rank's positions;
- each layer's attention gathers the time axis before its projections and,
  under tensor parallelism, reduce-scatters it after its row-parallel
  product; a cut MLP does the same (``parallel/tensor.ModelAxis``);
- the layers' whole tensors see the rank's positions only, so their
  gradients are summed over the axis (``TensorParallelLayout`` with
  ``sequence=True``, which a model's ``enable_sequence_parallel`` builds:
  Megatron-SP always comes with the tensor parallelism of
  ``parallel/tensor.py``).

T must divide by the axis size. Values are those of the plain loop.
"""

from __future__ import annotations

from typing import Callable

import torch

from avex_tpu_torch.parallel import Mesh
from avex_tpu_torch.parallel.tensor import gather_time, time_block

__all__ = ["check_sequence_length", "make_sequence_parallel_runner"]


def check_sequence_length(seq: int, size: int) -> None:
    """Raise unless a sequence of ``seq`` positions divides over ``size`` ranks."""
    if seq % size:
        raise ValueError(f"sequence parallelism: T={seq} positions do not divide over a model axis of {size}")


class _EnterBlocks(torch.autograd.Function):
    """Forward this rank's block of positions; backward the all-gather of
    the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return time_block(x, mesh).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return gather_time(grad, ctx.mesh).contiguous(), None


class _LeaveBlocks(torch.autograd.Function):
    """Forward the all-gather of the blocks; backward this rank's block of the
    gradient (every rank computes the same from the whole sequence)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return gather_time(x, mesh).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return time_block(grad, ctx.mesh).contiguous(), None


def make_sequence_parallel_runner(mesh: Mesh) -> Callable:
    """A layer-stack runner (the ``layer_runner`` contract: ``runner(layer_fn,
    layers, x, batched, shared)``, ``layer_fn(layer, h, *batched, *shared)``)
    that runs the layers on this rank's block of positions over ``mesh``'s
    model axis."""
    model = mesh.model_axis

    def runner(layer_fn, layers, x, batched=(), shared=()):
        check_sequence_length(x.shape[1], model.size)
        h = _EnterBlocks.apply(x, model) if model.size > 1 else x
        for layer in layers:
            h = layer_fn(layer, h, *batched, *shared)
        return _LeaveBlocks.apply(h, model) if model.size > 1 else h

    return runner
