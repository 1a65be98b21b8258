"""DataLoader: seeded shuffling and batching over ``torch.utils.data.DataLoader``.

Counterpart of ``avex_tpu/data/loader.py``, rebuilt on PyTorch's loader:

- the batch sampler runs in the calling process and yields the JAX package's
  chunks: the permutation of ``default_rng(seed * 1_000_003 + epoch)`` (or
  the identity without shuffling), this process's shard
  ``[shard_process::num_shards]``, then batches of ``batch_size`` with the
  remainder dropped under ``drop_last``. Each chunk travels with its epoch
  and batch index;
- a worker loads the chunk's items and collates them with the generator
  ``default_rng(SeedSequence([seed, epoch, batch_idx]))``, so every batch is
  a pure function of (seed, epoch, batch index), the same for any
  ``num_workers``, and equal to the JAX package's batch;
- workers are processes: ``num_workers`` of them, started at the first
  pass over the data and kept across epochs until the loader is dropped.
  They are spawned, as the JAX package's and the reference's are (forking a
  process that runs threads, as CUDA and JAX do, is unsafe), so the
  dataset and the collater are pickled to them. They do numpy and file
  work only and never touch CUDA. Their batches reach this process as CPU
  tensors in shared memory, the role of the JAX loader's hand-built
  shared-memory slot ring;
- batches come out as dicts of CPU tensors (``raw_wav``, ``padding_mask``,
  ``label``; ``text_label`` stays a list of strings), in pinned memory when
  ``pin_memory`` is set, for a consumer on ``cuda`` to copy with
  ``non_blocking=True``.

``set_epoch`` reseeds the shuffle, as ``DistributedSampler.set_epoch`` does.
``wait_seconds`` and ``batches_served`` count the time the consumer waited
for batches and how many it took.
"""

from __future__ import annotations

import time
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.data import Dataset, Sampler

from avex_tpu_torch.data.collate import accepts_rng

__all__ = ["DataLoader"]


class _BatchMaker(Dataset):
    """What a worker runs: ``(epoch, batch_idx, indices)`` → one collated batch."""

    def __init__(self, dataset, collate_fn: Callable, seed: int) -> None:
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.seed = seed
        self.accepts_rng = accepts_rng(collate_fn)

    def __getitem__(self, key: Tuple[int, int, List[int]]) -> Dict[str, Any]:
        epoch, batch_idx, indices = key
        items = [self.dataset[int(i)] for i in indices]
        if not self.accepts_rng:
            return self.collate_fn(items)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch, batch_idx]))
        return self.collate_fn(items, rng=rng)

    def __len__(self) -> int:
        return len(self.dataset)


def _as_tensors(batch: Dict[str, Any]) -> Dict[str, Any]:
    """numpy arrays → CPU tensors sharing their memory; anything else as it is."""
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


class _ChunkSampler(Sampler):
    """The loader's chunks for its current epoch, each with its epoch and index.

    It holds its loader by a weak reference: no reference cycle keeps a
    dropped loader, and so its worker processes, alive until the garbage
    collector or the interpreter's exit finds them.
    """

    def __init__(self, loader: "DataLoader") -> None:
        self._loader = weakref.ref(loader)

    def __iter__(self) -> Iterator[Tuple[int, int, List[int]]]:
        loader = self._loader()
        epoch, first = loader.epoch, loader._first_batch
        for batch_idx, chunk in enumerate(loader._chunks()):
            if batch_idx >= first:
                yield epoch, batch_idx, chunk.tolist()

    def __len__(self) -> int:
        loader = self._loader()
        return max(len(loader) - loader._first_batch, 0)


class DataLoader:
    """Batched iterator over a map-style dataset (see the module docstring)."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 0,
        shard_process: Optional[int] = None,
        num_shards: int = 1,
        pin_memory: bool = False,
        prefetch_factor: Optional[int] = None,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.num_workers = num_workers
        self.shard_process = shard_process
        self.num_shards = num_shards
        self.pin_memory = pin_memory
        self.prefetch_factor = prefetch_factor  # batches a worker prepares ahead (torch's default: 2)
        self.wait_seconds = 0.0
        self.batches_served = 0
        self._first_batch = 0  # the epoch's first batch a pass yields (a resumed pass starts later)
        self._torch_loader: Optional[torch.utils.data.DataLoader] = None

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle (and the collation draws) for ``epoch``."""
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.random.default_rng(self.seed * 1_000_003 + self.epoch).permutation(n) if self.shuffle \
            else np.arange(n)
        if self.num_shards > 1 and self.shard_process is not None:
            idx = idx[self.shard_process::self.num_shards]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _chunks(self) -> List[np.ndarray]:
        idx = self._indices()
        end = len(idx) - len(idx) % self.batch_size if self.drop_last else len(idx)
        return [idx[s:s + self.batch_size] for s in range(0, end, self.batch_size)]

    def _loader(self) -> torch.utils.data.DataLoader:
        """The PyTorch loader, built once: its workers persist across epochs."""
        if self._torch_loader is None:
            workers = self.num_workers > 0
            self._torch_loader = torch.utils.data.DataLoader(
                _BatchMaker(self.dataset, self.collate_fn, self.seed),
                batch_size=None,  # the sampler's chunks are whole batches
                sampler=_ChunkSampler(self),
                collate_fn=_as_tensors,
                num_workers=self.num_workers,
                pin_memory=self.pin_memory,
                persistent_workers=workers,
                multiprocessing_context="spawn" if workers else None,
                prefetch_factor=self.prefetch_factor if workers else None,
            )
        return self._torch_loader

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        it = iter(self._loader())
        while True:
            start = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.wait_seconds += time.perf_counter() - start
            self.batches_served += 1
            yield batch
