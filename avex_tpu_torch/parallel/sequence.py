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

A rank holds ``ceil(T/n)`` positions, the last ranks fewer when T does
not divide over the axis (GSPMD's uneven sharding, which JAX's runner gets
from its sharding constraint: Bird-MAE's and EAT's 1 + patches tokens are
odd); the collectives move blocks padded at their end. Values are those of
the plain loop.
"""

from __future__ import annotations

from typing import Callable

import torch

from avex_tpu_torch.parallel import Mesh
from avex_tpu_torch.parallel.tensor import gather_time, sequence_length, time_block

__all__ = ["enter_blocks", "leave_blocks", "make_sequence_parallel_runner"]


class _EnterBlocks(torch.autograd.Function):
    """Forward this rank's block of positions; backward the all-gather of
    the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, dim=1):
        ctx.mesh, ctx.seq, ctx.dim = mesh, x.shape[dim], dim
        return time_block(x, mesh, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return gather_time(grad, ctx.mesh, ctx.seq, ctx.dim).contiguous(), None, None


class _LeaveBlocks(torch.autograd.Function):
    """Forward the all-gather of the blocks; backward this rank's block of the
    gradient (every rank computes the same from the whole sequence)."""

    @staticmethod
    def forward(ctx, x, mesh, seq, dim=1):
        ctx.mesh, ctx.dim = mesh, dim
        return gather_time(x, mesh, seq, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return time_block(grad, ctx.mesh, ctx.dim).contiguous(), None, None, None


def enter_blocks(x: torch.Tensor, mesh: Mesh, dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x``'s axis ``dim`` (a value every rank holds
    whole); the backward gathers the blocks' gradients, so each rank gets
    the whole gradient."""
    return _EnterBlocks.apply(x, mesh, dim) if mesh.size > 1 else x


def leave_blocks(x: torch.Tensor, mesh: Mesh, seq: int, dim: int = 1) -> torch.Tensor:
    """The ranks' blocks of a sequence of ``seq`` positions gathered whole;
    the backward keeps this rank's block of the gradient."""
    return _LeaveBlocks.apply(x, mesh, seq, dim) if mesh.size > 1 else x


def make_sequence_parallel_runner(mesh: Mesh) -> Callable:
    """A layer-stack runner (the ``layer_runner`` contract: ``runner(layer_fn,
    layers, x, batched, shared)``, ``layer_fn(layer, h, *batched, *shared)``)
    that runs the layers on this rank's block of positions over ``mesh``'s
    model axis."""
    model = mesh.model_axis

    def runner(layer_fn, layers, x, batched=(), shared=()):
        seq = x.shape[1]
        with sequence_length(seq):
            h = enter_blocks(x, model)
            for layer in layers:
                h = layer_fn(layer, h, *batched, *shared)
            return leave_blocks(h, model, seq)

    return runner
