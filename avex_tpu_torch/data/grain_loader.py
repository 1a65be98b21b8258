"""The checkpointable data loader, in place of the JAX package's grain pipeline.

Counterpart of ``avex_tpu/data/grain_loader.py``. That module runs the
dataset and the collater through ``grain`` for its checkpointable
iterators: the mid-epoch position serializes and is stored beside the step
checkpoint for an exact resume. :class:`GrainDataLoader` keeps its name and
surface and needs no ``grain``: it is the port's :class:`DataLoader` (worker
processes, pinned batches) with

- grain's order: ``MapDataset.shuffle(seed=seed * 1_000_003 + epoch)``, whose
  index shuffle (a Simon block cipher over a power-of-two domain with cycle
  walking, keyed by ``std::seed_seq``) :func:`index_shuffle` computes in
  numpy bit for bit, then the shard ``slice(shard, None, num_shards)``, then
  batches of ``batch_size`` (the remainder dropped under ``drop_last``);
- grain's collation draws: ``SeedSequence([seed, epoch, batch_idx])`` with
  ``batch_idx`` the batch's position in the shard, whatever the worker
  count or the resume point;
- ``iterator_state()``: a JSON-able dict ``{"epoch", "position", "seed",
  "num_shards"}`` whose ``position`` counts the batches handed to the
  consumer, never those the workers have prefetched;
  ``restore_iterator(state)`` yields the rest of that epoch from there. The
  state names no shard: every rank of a run stands at the same position, so
  the one state that rank 0 saves in the step checkpoint restores each rank
  on its own shard, as JAX's saved grain position does.

Select it with ``RunConfig.data_pipeline = "grain"``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from avex_tpu_torch.data.loader import DataLoader

__all__ = ["GrainDataLoader", "index_shuffle"]

_U32 = 0xFFFFFFFF
_MIN_BLOCK_BITS = 16  # grain's kMinBlockSize


def _seed_seq(seeds: Sequence[int], n: int) -> List[int]:
    """``std::seed_seq(seeds).generate`` of ``n`` 32-bit words (C++11 [rand.util.seedseq])."""
    words = [0x8B8B8B8B] * n
    s = len(seeds)
    t = 11 if n >= 623 else 7 if n >= 68 else 5 if n >= 39 else 3 if n >= 7 else (n - 1) // 2
    p, m = (n - t) // 2, max(s + 1, n)
    q = p + t

    def mix(x: int) -> int:
        return x ^ (x >> 27)

    for k in range(m):
        r1 = (1664525 * mix(words[k % n] ^ words[(k + p) % n] ^ words[(k - 1) % n])) & _U32
        r2 = (r1 + (s if k == 0 else k % n + seeds[k - 1] if k <= s else k % n)) & _U32
        words[(k + p) % n] = (words[(k + p) % n] + r1) & _U32
        words[(k + q) % n] = (words[(k + q) % n] + r2) & _U32
        words[k % n] = r2
    for k in range(m, m + n):
        r3 = (1566083941 * mix((words[k % n] + words[(k + p) % n] + words[(k - 1) % n]) & _U32)) & _U32
        r4 = (r3 - k % n) & _U32
        words[(k + p) % n] ^= r3
        words[(k + q) % n] ^= r4
        words[k % n] = r4
    return words


def index_shuffle(indices: np.ndarray, max_index: int, seed: int, rounds: int = 4) -> np.ndarray:
    """grain's ``index_shuffle``: the positions of ``indices`` (each at most
    ``max_index``) under a seeded permutation of ``[0, max_index]``, for
    every index at once.

    The domain is ``2**bits`` with ``bits`` the even number at least
    ``ceil(log2(max_index))`` (at least 16); a Simon cipher of ``rounds`` round
    keys (two a round pair, from ``std::seed_seq{seed}``) on the two halves
    permutes it, and an index that lands past ``max_index`` is encrypted
    again until it does not. Up to ``2**20`` the whole domain is encrypted
    once and each index's walk is found by pointer doubling (a dataset far
    smaller than the domain walks long cycles); past it, where at least a
    quarter of the domain is in range, each index walks its own cycle.
    """
    indices = np.asarray(indices, np.int64)
    if max_index == 0:
        return np.zeros(indices.shape, np.int64)
    bits = math.ceil(math.log2(max_index))
    bits = max(bits + bits % 2, _MIN_BLOCK_BITS)
    half = bits // 2
    mask = np.uint64((1 << half) - 1)
    keys = [np.uint64(k) & mask for k in _seed_seq([seed & _U32], rounds)]

    def rotl(v, r):
        return ((v >> np.uint64(half - r)) | (v << np.uint64(r))) & mask

    def f(v):
        return (rotl(v, 1) & rotl(v, 8)) ^ rotl(v, 2)

    def encrypt(v: np.ndarray) -> np.ndarray:
        x, y = (v >> np.uint64(half)) & mask, v & mask
        for i in range(0, len(keys) - 1, 2):
            x = x ^ f(y) ^ keys[i]
            y = y ^ f(x) ^ keys[i + 1]
        return ((x << np.uint64(half)) | y).astype(np.int64)

    if bits <= 20 and max_index < 1 << bits:
        # ptr[v]: where v's walk stands, every element passed on the way out of range
        ptr = encrypt(np.arange(1 << bits, dtype=np.uint64))
        for _ in range(bits + 1):  # 2**(bits+1) steps outrun any cycle
            out = ptr > max_index
            if not out[: max_index + 1].any():
                break
            ptr[out] = ptr[ptr[out]]
        return ptr[indices]
    out = encrypt(indices.astype(np.uint64))
    todo = out > max_index
    while todo.any():
        out[todo] = encrypt(out[todo].astype(np.uint64))
        todo = out > max_index
    return out


class GrainDataLoader(DataLoader):
    """The native loader in grain's order, with a checkpointable iterator
    (see the module docstring). Needs no ``grain``."""

    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        num_workers: int = 0,
        prefetch: int = 2,
        shard_process: Optional[int] = None,
        num_shards: int = 1,
        pin_memory: bool = False,
    ) -> None:
        super().__init__(dataset, batch_size, collate_fn, shuffle=shuffle, drop_last=drop_last, seed=seed,
                         num_workers=num_workers, shard_process=shard_process, num_shards=num_shards,
                         pin_memory=pin_memory, prefetch_factor=prefetch)
        self._position: Optional[int] = None  # batches the live pass has handed out

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            seed = self.seed * 1_000_003 + self.epoch
            if not 0 <= seed < 2**32:
                raise ValueError(f"Seed must be an integer between 0 and 2**32-1 (got {seed=}).")
            idx = index_shuffle(idx, n - 1, seed) if n else idx
        if self.num_shards > 1 and self.shard_process is not None:
            idx = idx[self.shard_process::self.num_shards]
        return idx

    def _pass(self, first_batch: int) -> Iterator[Dict[str, Any]]:
        self._first_batch = first_batch
        self._position = first_batch
        for batch in DataLoader.__iter__(self):
            self._position += 1
            yield batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self._pass(0)

    # -- the checkpointable iterator --------------------------------------

    def iterator_state(self) -> Optional[Dict[str, Any]]:
        """The live pass's position as a JSON-able dict, or None before any pass."""
        if self._position is None:
            return None
        return {"epoch": self.epoch, "position": self._position, "seed": self.seed,
                "num_shards": self.num_shards}

    def restore_iterator(self, state: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        """The rest of the epoch from the position ``iterator_state`` captured."""
        theirs = (state.get("seed", self.seed), state.get("num_shards", self.num_shards))
        if theirs != (self.seed, self.num_shards):
            raise ValueError(f"iterator state of another loader (seed, num_shards) {theirs}; "
                             f"this one's {(self.seed, self.num_shards)}")
        self.epoch = int(state["epoch"])
        return self._pass(int(state["position"]))
