"""Data parallelism over ``torch.distributed``: one process per device.

Port of ``avex_tpu/parallel/__init__.py``. In JAX a data-sharded array is one
logical global batch; here each process holds its rows, and the global
batch is the concatenation of the ranks' local batches in rank order (what
``jax.make_array_from_process_local_data`` builds). What XLA inserts
around a step on a data-sharded mesh is written out:

- :func:`average_gradients`: the gradient psum, as one ``all_reduce`` of a
  flat buffer per dtype;
- :func:`gather_rows` (with its gradient) and :func:`all_reduce_sum` (with
  its gradient): the collectives of the ops that couple a batch's rows
  (CLIP's global-batch similarity, BatchNorm's statistics). Those ops read
  :func:`batch_mesh`, which a step sets with :func:`global_batch`;
- :func:`replicate`: every rank starts from rank 0's weights;
- the ZeRO-3 layout (:func:`fsdp_sharding`, :func:`shard_params_fsdp`,
  ``parallel/fsdp.py``).

A mesh is a :class:`Mesh`: ``data`` x ``model`` processes, rank ``r`` at
``(r // model, r % model)`` (JAX's ``devices.reshape(data, model)``), with
one process group per model column (the data axis's collectives) and one
per data row (the model axis's: tensor parallelism, ``parallel/tensor.py``;
the pipeline, ``parallel/pipeline.py``; sequence parallelism,
``parallel/sequence.py``; ring attention, ``ops/ring_attention.py``; expert
parallelism, ``ops/moe.py``). A third ``tp`` axis (the 3-D dp x pp x tp
cell: ``make_mesh(data, model, tp=...)``) puts rank ``r`` at
``(r // (model·tp), (r // tp) % model, r % tp)`` with a group for each line
of processes along each axis. Without an initialised process group it is a
one-process mesh and no collective runs, so a run without
``torch.distributed`` is what it always was. The backend follows the run's
device (NCCL for ``cuda``, gloo for ``cpu``) unless the caller names one.
:func:`_gloo` is the one place that tells the two apart: on gloo the
gathers, reduce-scatters and the pipeline's ring shift are written out of
``all_reduce``, the collective gloo runs on CUDA tensors as well as on host
ones (PyTorch's backend table gives gloo ``broadcast`` and ``all_reduce`` on
the GPU), so the CPU runs the code that two gloo ranks sharing a card run;
on NCCL they are NCCL's own collectives and ``batch_isend_irecv``.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

logger = logging.getLogger(__name__)

__all__ = [
    "Mesh",
    "all_gather_into",
    "all_reduce_sum",
    "average_gradients",
    "batch_mesh",
    "broadcast_from",
    "check_equal_rows",
    "fsdp_sharding",
    "gather_metrics",
    "gather_rows",
    "global_batch",
    "init_multihost",
    "is_main_process",
    "local_array",
    "local_device_count",
    "make_mesh",
    "rank_device",
    "reduce_scatter_into",
    "replicate",
    "ring_shift",
    "shard_batch",
    "shard_params_fsdp",
    "shared_generator",
    "stitch_local_blocks",
    "sum_over_ranks",
    "world_size",
]

# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------


def world_size() -> int:
    """Processes of the run: ``torch.distributed``'s world size, else 1."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def is_main_process() -> bool:
    """True on the process that writes checkpoints, metadata and logs (rank 0)."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def local_device_count() -> int:
    """CUDA devices attached to this host, or 1 where there is none (the CPU)."""
    return max(torch.cuda.device_count(), 1) if torch.cuda.is_available() else 1


def _local_card(rank: int) -> int:
    """The card of process ``rank`` on its host: ``LOCAL_RANK``, else the
    rank, modulo the host's cards (so ranks may share one)."""
    return int(os.environ.get("LOCAL_RANK", rank)) % local_device_count()


def rank_device(device: Any = "cuda") -> torch.device:
    """This process's device: ``cuda`` without an index becomes the rank's
    card (:func:`_local_card`); anything else as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or world_size() == 1:
        return device
    return torch.device("cuda", _local_card(dist.get_rank()))


def _first_slurm_node(nodelist: str) -> str:
    """First hostname of a SLURM nodelist expression.

    Handles bracketed ranges and hyphenated hostnames:
    ``node[001-004]`` → ``node001``, ``gpu-a[3,17]`` → ``gpu-a3``,
    ``tpu-pod-1`` → ``tpu-pod-1``, ``a1,a2`` → ``a1``.
    """
    depth = 0
    first = nodelist
    for i, ch in enumerate(nodelist):
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:  # comma separating whole hostnames
            first = nodelist[:i]
            break
    first = first.strip()
    if "[" in first:
        prefix, rng = first.split("[", 1)
        token = rng.rstrip("]").split(",")[0].split("-")[0]
        return prefix + token
    return first


def _discover_slurm() -> Optional[Dict[str, Any]]:
    """SLURM environment → coordinator address, process count and id (the
    port is salted with the job id, as the reference does)."""
    if "SLURM_PROCID" not in os.environ:
        return None
    try:
        process_id = int(os.environ["SLURM_PROCID"])
        num_processes = int(os.environ["SLURM_NTASKS"])
        head = _first_slurm_node(os.environ.get("SLURM_NODELIST", "localhost"))
        job_id = int(os.environ.get("SLURM_JOB_ID", "0"))
        port = 10000 + (job_id % 20000)
        return {
            "coordinator_address": f"{head}:{port}",
            "num_processes": num_processes,
            "process_id": process_id,
        }
    except (KeyError, ValueError):
        return None


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: Any = "cuda",
) -> bool:
    """Join this process to the run's process group; returns whether one was started.

    Without arguments the SLURM environment names the coordinator, the
    process count and this process's id; without SLURM, or with one
    process, nothing starts (False). ``host:port`` becomes a ``tcp://``
    rendezvous; a ``tcp://`` or ``file://`` URL is taken as it is. The
    backend is NCCL for a ``cuda`` run and gloo for a ``cpu`` one, unless
    ``backend`` names it. On ``cuda`` the process takes its card
    (:func:`rank_device`) first.
    """
    if coordinator_address is None:
        discovered = _discover_slurm()
        if discovered is None:
            return False
        coordinator_address = discovered["coordinator_address"]
        num_processes = discovered["num_processes"]
        process_id = discovered["process_id"]
    if num_processes in (None, 1):
        return False
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cuda" and torch.device(device).index is None:
        torch.cuda.set_device(_local_card(int(process_id)))
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes), rank=int(process_id))
    logger.info("process group up: rank %d of %d over %s (%s)", process_id, num_processes, url, backend)
    return True


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh of processes, one device each, seen from one of them.

    ``size``, ``rank`` and ``group`` are the data axis: its rank count, this
    process's index on it and the process group of its collectives (this
    process's model column), ``None`` where no collective runs over it (a
    one-process mesh, or a data axis of one beside a model axis).
    ``model_size``, ``model_rank`` and ``model_group`` are the model axis
    (this process's data row), ``model_group`` ``None`` for a model axis of
    one; ``tp_size``, ``tp_rank`` and ``tp_group`` the third axis of a 3-D
    mesh (size 1 otherwise). ``device`` is where this process's batch and
    the collectives' buffers live.
    """

    size: int
    rank: int
    group: Any
    device: torch.device
    axis_names: Tuple[str, ...] = ("data", "model")
    model_size: int = 1
    model_rank: int = 0
    model_group: Any = None
    tp_size: int = 1
    tp_rank: int = 0
    tp_group: Any = None

    @property
    def distributed(self) -> bool:
        """Whether the process runs in a process group (of one rank or more)."""
        return any(g is not None for g in (self.group, self.model_group, self.tp_group))

    @property
    def backend(self) -> Optional[str]:
        group = next((g for g in (self.group, self.model_group, self.tp_group) if g is not None), None)
        return dist.get_backend(group) if group is not None else None

    @property
    def model_axis(self) -> "Mesh":
        """The model axis as a mesh of one axis: its ``size``, ``rank`` and
        ``group`` are this process's data row's, so the collectives below
        run over it as they run over the data axis."""
        return Mesh(self.model_size, self.model_rank, self.model_group, self.device, self.axis_names)

    @property
    def tp_axis(self) -> "Mesh":
        """The third axis as a mesh of one axis (this process's line of ranks
        that share its data and model coordinates)."""
        return Mesh(self.tp_size, self.tp_rank, self.tp_group, self.device, self.axis_names)

    def axis(self, name: str) -> "Mesh":
        """The mesh axis ``name`` (one of :attr:`axis_names`) as a mesh of one axis."""
        if name not in self.axis_names:
            raise ValueError(f"mesh has no {name!r} axis (axes {tuple(self.axis_names)})")
        index = tuple(self.axis_names).index(name)
        return (Mesh(self.size, self.rank, self.group, self.device, self.axis_names), self.model_axis,
                self.tp_axis)[index]


def make_mesh(
    data: int = -1,
    model: int = 1,
    axis_names: Optional[Tuple[str, ...]] = None,
    device: Any = "cuda",
    tp: int = 1,
) -> Mesh:
    """The (data, model) mesh over the run's processes, one device each, or
    with ``tp > 1`` the (data, model, tp) mesh of the 3-D cell.

    ``data=-1`` takes every process the other axes leave. Rank ``r`` sits at
    ``(r // model, r % model)`` (``(r // (model·tp), (r // tp) % model,
    r % tp)``); every rank builds every line's process group along every
    axis, in the same order (``dist.new_group`` is collective). ``device``:
    this process's (:func:`rank_device` of it). ``axis_names`` defaults to
    ``("data", "model")``, with ``"tp"`` after them on a 3-D mesh.
    """
    if model < 1 or tp < 1:
        raise ValueError("model axis size must be >= 1")
    processes = world_size()
    if data == -1:
        if processes % (model * tp):
            raise ValueError(f"{processes} processes not divisible by model={model}" + (f" x tp={tp}" if tp > 1 else ""))
        data = processes // (model * tp)
    if data * model * tp != processes:
        shape = f"{data}x{model}" + (f"x{tp}" if tp > 1 else "")
        raise ValueError(f"mesh {shape} != {processes} processes (one device each)")
    device = rank_device(device)
    names = tuple(axis_names) if axis_names is not None else (("data", "model", "tp") if tp > 1 else ("data", "model"))
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(size=1, rank=0, group=None, device=device, axis_names=names)
    rank = dist.get_rank()
    if tp > 1:
        return _make_3d_mesh(data, model, tp, rank, device, names)
    if model == 1:
        return Mesh(size=data, rank=rank, group=dist.group.WORLD, device=device, axis_names=names)
    columns = [dist.new_group([i * model + j for i in range(data)]) for j in range(model)] if data > 1 else None
    rows = [dist.new_group([i * model + j for j in range(model)]) for i in range(data)]
    row, column = divmod(rank, model)
    return Mesh(size=data, rank=row, group=columns[column] if columns else None, device=device, axis_names=names,
                model_size=model, model_rank=column, model_group=rows[row])


def _make_3d_mesh(data: int, model: int, tp: int, rank: int, device: torch.device, names: Tuple[str, ...]) -> Mesh:
    """The (data, model, tp) mesh: one group per line of ranks along each axis
    (an axis of one has none), built by every rank in the same order."""
    def index(i: int, j: int, t: int) -> int:
        return (i * model + j) * tp + t

    def lines(size, line):  # each line's group, keyed by the two coordinates it does not run along
        if size == 1:
            return {}
        return {key: dist.new_group(members) for key, members in line()}

    columns = lines(data, lambda: [((j, t), [index(i, j, t) for i in range(data)])
                                   for j in range(model) for t in range(tp)])
    rows = lines(model, lambda: [((i, t), [index(i, j, t) for j in range(model)])
                                 for i in range(data) for t in range(tp)])
    tps = lines(tp, lambda: [((i, j), [index(i, j, t) for t in range(tp)]) for i in range(data) for j in range(model)])
    i, j, t = rank // (model * tp), (rank // tp) % model, rank % tp
    return Mesh(size=data, rank=i, group=columns.get((j, t)), device=device, axis_names=names,
                model_size=model, model_rank=j, model_group=rows.get((i, t)),
                tp_size=tp, tp_rank=t, tp_group=tps.get((i, j)))


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _gloo(mesh: Mesh, tensor: Optional[torch.Tensor] = None) -> bool:
    """Whether the collectives over ``mesh`` are written out of ``all_reduce``
    (gloo) or are the backend's own (NCCL). Raises for a backend or a tensor
    that neither form carries, rather than moving the work elsewhere."""
    backend = mesh.backend
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"the collectives are written for gloo and NCCL, not {backend!r}")
    if backend == "nccl" and tensor is not None and tensor.device.type != "cuda":
        raise ValueError(f"NCCL carries CUDA tensors only, not one on {tensor.device}")
    return backend == "gloo"


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``out`` (``size`` times ``inp``'s rows) ← every rank's ``inp`` in rank order."""
    if _gloo(mesh, inp):
        # gloo gathers no CUDA tensor: each rank fills its rows of a zeroed
        # buffer and the sum over ranks is the gather (x + 0 is x).
        out.zero_()
        out.view(mesh.size, -1)[mesh.rank].copy_(inp.reshape(-1))
        dist.all_reduce(out, group=mesh.group)
    else:
        dist.all_gather_into_tensor(out, inp.contiguous(), group=mesh.group)
    return out


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``out`` ← this rank's block of the sum over ranks of ``inp``
    (``size`` blocks of ``out``'s size, in rank order)."""
    if _gloo(mesh, inp):
        # gloo has no reduce-scatter on CUDA tensors: sum everything, keep our block.
        total = inp.contiguous().clone()
        dist.all_reduce(total, group=mesh.group)
        out.copy_(total.view(mesh.size, -1)[mesh.rank].view_as(out))
    else:
        dist.reduce_scatter_tensor(out, inp.contiguous(), group=mesh.group)
    return out


def broadcast_from(x: torch.Tensor, src: int, mesh: Mesh) -> torch.Tensor:
    """Rank ``src``'s ``x`` (of the mesh's axis) on every rank, in place."""
    _gloo(mesh, x)
    dist.broadcast(x, src=dist.get_global_rank(mesh.group, src), group=mesh.group)
    return x


def ring_shift(x: torch.Tensor, mesh: Mesh, step: int = 1) -> torch.Tensor:
    """Every rank's ``x`` passed ``step`` ranks on around the axis's ring
    (JAX's ``ppermute`` with ``(i, (i + step) % size)``): rank ``r`` gets rank
    ``r - step``'s. Each rank sends and receives once (NCCL's
    ``batch_isend_irecv``); gloo, which sends no CUDA tensor, gathers every
    rank's ``x`` with :func:`all_gather_into` and keeps its sender's."""
    x = x.contiguous()
    size, rank = mesh.size, mesh.rank
    sender = (rank - step) % size
    if _gloo(mesh, x):
        gathered = all_gather_into(x.new_empty((size,) + tuple(x.shape)), x, mesh)
        return gathered[sender].clone()
    out = torch.empty_like(x)
    peer = lambda r: dist.get_global_rank(mesh.group, r)  # noqa: E731
    ops = [dist.P2POp(dist.isend, x, peer((rank + step) % size), mesh.group),
           dist.P2POp(dist.irecv, out, peer(sender), mesh.group)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the gradient of every rank's copy is the sum of the
    ranks' gradients (each rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        out = x.contiguous().clone()
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the mesh's ranks, differentiable."""
    return _AllReduceSum.apply(x, mesh)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows in rank order; the backward hands each rank the sum
    over ranks of the gradient of its own rows."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        out = x.new_empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]))
        return all_gather_into(out, x.contiguous(), mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        out = grad.new_empty((grad.shape[0] // mesh.size,) + tuple(grad.shape[1:]))
        return reduce_scatter_into(out, grad, mesh), None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch of ``x``: the ranks' equal local batches, concatenated
    in rank order, with the gradient flowing back to each rank's rows."""
    return _GatherRows.apply(x, mesh)


def sum_over_ranks(tensors: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """Each tensor summed over ranks (new tensors): one ``all_reduce`` of a
    flat buffer per dtype. Over an axis with no group (a one-process
    mesh, or one rank) each is its own sum."""
    if mesh.group is None:
        return [t.clone() for t in tensors]
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = _flatten_dense_tensors([tensors[i] for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        for i, t in zip(idx, _unflatten_dense_tensors(flat, [tensors[i] for i in idx])):
            out[i] = t
    return out


def average_gradients(grads: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The mean over ranks of each gradient (XLA's psum over the data axis,
    divided as JAX's loss over the global batch divides)."""
    names = list(grads)
    summed = sum_over_ranks([grads[n] for n in names], mesh)
    return {n: t.div_(mesh.size) for n, t in zip(names, summed)}


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every process of the mesh takes rank 0's parameters and buffers (one
    broadcast of a flat buffer per dtype over the whole mesh)."""
    if not mesh.distributed:
        return module
    tensors = [t.data for t in list(module.parameters()) + list(module.buffers())]
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = _flatten_dense_tensors(group)
        dist.broadcast(flat, src=0)
        for t, value in zip(group, _unflatten_dense_tensors(flat, group)):
            t.copy_(value)
    return module


def gather_metrics(metrics: Mapping[str, float], mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """The mean over ranks of each scalar metric, in float64; one process
    returns them as they are."""
    if world_size() == 1:
        return dict(metrics)
    if mesh is None:  # NCCL reduces CUDA tensors only
        mesh = make_mesh(device="cuda" if dist.get_backend() == "nccl" else "cpu")
    if mesh.group is None:  # one data rank: the model axis's ranks hold the same numbers
        return dict(metrics)
    keys = list(metrics)
    values = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(values, group=mesh.group)
    return {k: float(v) / mesh.size for k, v in zip(keys, values.tolist())}


# ---------------------------------------------------------------------------
# Batches
# ---------------------------------------------------------------------------


def _numeric(value: Any) -> bool:
    if isinstance(value, torch.Tensor):
        return True
    try:
        kind = np.asarray(value).dtype.kind
    except (TypeError, ValueError):
        return False
    return kind in "biuf"


def check_equal_rows(rows: int, mesh: Mesh) -> None:
    """Raise unless every rank holds ``rows`` rows: JAX's loss is the mean
    over the global batch, which the mean of the ranks' local means equals
    only for equal local batches."""
    if mesh.size == 1:
        return
    stats = torch.tensor([rows, rows * rows], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(stats, group=mesh.group)
    total, squares = stats.tolist()
    if squares * mesh.size != total * total:  # Σn² · W = (Σn)² iff every n is equal
        raise ValueError(
            f"multi-host batch of local size {rows} does not assemble onto the {mesh.size}-way data axis; "
            "use drop_last=True (or pad) so every process contributes equal, divisible batches"
        )


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This process's batch on its device, numeric entries only (text stays
    behind). In a multi-process run the local batches must be equal: their
    concatenation is the global batch."""
    if isinstance(batch, Mapping):
        out = {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
               for k, v in batch.items() if v is not None and _numeric(v)}
        out = {k: v.to(mesh.device, non_blocking=v.is_pinned()) for k, v in out.items()}
        rows = {v.shape[0] for v in out.values() if v.ndim}
    else:
        out = torch.as_tensor(np.asarray(batch)) if not isinstance(batch, torch.Tensor) else batch
        out = out.to(mesh.device)
        rows = {out.shape[0]} if out.ndim else set()
    if rows:
        check_equal_rows(min(rows), mesh)
    return out


def local_array(x: Any) -> Any:
    """This process's rows: a rank holds exactly its own, so ``x`` as it is."""
    return x


def stitch_local_blocks(blocks: dict, shape: tuple, dtype: Any) -> np.ndarray:
    """Assemble shard blocks into one dense array.

    ``blocks`` maps per-axis ``(start, stop)`` global-index tuples to numpy
    data, stitched along every sharded axis: each axis's distinct start
    offsets map to local positions, and the blocks scatter into a dense
    buffer. Ragged blocks, or blocks that do not tile a dense grid, raise.
    """
    if len(blocks) == 1:
        return next(iter(blocks.values()))
    ndim = len(shape)
    axis_offsets = []
    for d in range(ndim):
        extents: Dict[int, int] = {}  # global start -> extent
        for key in blocks:
            start, stop = key[d]
            prev = extents.setdefault(start, stop - start)
            if prev != stop - start:
                raise ValueError(f"local_array: ragged shards along axis {d} of {shape}")
        offsets, pos = {}, 0
        for s in sorted(extents):
            offsets[s] = pos
            pos += extents[s]
        axis_offsets.append((offsets, pos))
    local_shape = tuple(total for _offs, total in axis_offsets)
    expect = int(np.prod([len(offs) for offs, _total in axis_offsets]))
    if len(blocks) != expect:
        raise ValueError("local_array: addressable shards do not tile a dense grid "
                         f"({len(blocks)} blocks vs {expect} grid cells for {shape})")
    out = np.empty(local_shape, dtype=dtype)
    for key, data in blocks.items():
        slices = tuple(slice(axis_offsets[d][0][key[d][0]], axis_offsets[d][0][key[d][0]] + data.shape[d])
                       for d in range(ndim))
        out[slices] = data
    return out


# ---------------------------------------------------------------------------
# The step's global batch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _GlobalBatch:
    mesh: Mesh
    generator: Optional[torch.Generator]


_GLOBAL_BATCH: contextvars.ContextVar[Optional[_GlobalBatch]] = contextvars.ContextVar("global_batch", default=None)


@contextlib.contextmanager
def global_batch(mesh: Mesh, generator: Optional[torch.Generator] = None) -> Iterator[None]:
    """Inside, the ops that couple a batch's rows take the global batch of
    ``mesh``: BatchNorm's statistics, CLIP's similarities, EAT-SSL's sample
    size. ``generator``, the same on every rank, draws what JAX draws once
    for the whole global batch (LayerDrop)."""
    token = _GLOBAL_BATCH.set(_GlobalBatch(mesh, generator))
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def batch_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`global_batch` when it spans more than
    one rank, else None (the local batch is the global one)."""
    active = _GLOBAL_BATCH.get()
    return active.mesh if active is not None and active.mesh.size > 1 else None


def shared_generator(generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """The rank-shared generator of the enclosing multi-rank
    :func:`global_batch`, else ``generator``."""
    active = _GLOBAL_BATCH.get()
    if active is not None and active.mesh.size > 1 and active.generator is not None:
        return active.generator
    return generator


# ---------------------------------------------------------------------------
# ZeRO-3 placement
# ---------------------------------------------------------------------------


def fsdp_sharding(shape: Sequence[int], mesh: Mesh, min_size: int = 2**16) -> Optional[int]:
    """ZeRO-3 placement of one tensor shape: the axis to cut over the data
    axis (the largest one the mesh size divides), or None to replicate a
    tensor of fewer than ``min_size`` elements or with no such axis.
    Shape-deterministic, so optimizer moments follow their parameters."""
    shape = tuple(shape)
    n_elems = int(np.prod(shape)) if shape else 1
    if not shape or n_elems < min_size:
        return None
    dims = [(d, n) for d, n in enumerate(shape) if n % mesh.size == 0]
    if not dims:
        return None
    return max(dims, key=lambda dn: dn[1])[0]


def shard_params_fsdp(module: torch.nn.Module, mesh: Mesh, min_size: int = 2**16,
                      axes: Optional[Mapping[str, Optional[int]]] = None):
    """The ZeRO-3 layout of ``module``'s parameters over ``mesh``
    (:class:`~avex_tpu_torch.parallel.fsdp.FSDPLayout`), at rest: the module
    holds this rank's shards. ``axes`` names the cut dimension (or None) of
    some tensors."""
    from avex_tpu_torch.parallel.fsdp import FSDPLayout

    layout = FSDPLayout(module, mesh, min_size, axes)
    layout.release()
    return layout
