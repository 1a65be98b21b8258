"""Micro-batching inference service on the GPU.

Port of ``avex_tpu/serving/service.py``, with the same three rules:

1. **Fixed clip length.** Every request is center-cropped or right-padded to
   the service's ``clip_seconds`` on the host (``pad_or_window_np``), with a
   padding mask for the padded samples, so the time axis never varies.
2. **Power-of-two batch buckets.** Concurrent requests are coalesced up to
   ``max_batch``, and the batch is rounded *up* to the next power of two
   with rows of zero audio. At most ``log2(max_batch) + 1`` batch shapes
   ever reach the device. In JAX each is one compiled program; here the
   model runs eagerly, and a CUDA graph per bucket is the counterpart
   (ROADMAP queue 1, item 12).
3. **One batcher thread owns the device.** Requests enqueue from any number
   of producer threads (e.g. the HTTP server's); a single batcher thread
   runs the forward, so the queue, not device contention, absorbs bursts.

The batcher waits at most ``max_wait_ms`` after the first request of a batch
before it dispatches, so an idle server answers one request at bucket-1
latency while a loaded one fills ``max_batch``. Rows leave the device as
float32 numpy arrays.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter
from concurrent.futures import Future
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from avex_tpu_torch._native import resample
from avex_tpu_torch.ops.audio import pad_or_window_np

__all__ = ["InferenceService", "ServiceConfig"]


@dataclass
class ServiceConfig:
    """Serving knobs. ``clip_seconds`` and ``max_batch`` fix the set of batch
    shapes; the rest is host-side."""

    clip_seconds: float = 5.0
    max_batch: int = 32
    max_wait_ms: float = 10.0
    mode: str = "embed"  # "embed" (pooled features) | "logits"
    layers: Sequence[Any] = field(default_factory=lambda: ["last_layer"])
    aggregation: str = "mean"

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.mode not in ("embed", "logits"):
            raise ValueError(f"mode must be 'embed' or 'logits', got {self.mode!r}")


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


class InferenceService:
    """A loaded model behind a thread-safe ``submit() -> Future`` API.

    ``submit`` takes a mono float waveform at any sample rate (resampled on
    the host to the model's rate) and resolves to the pooled embedding row
    (``mode="embed"``) or the logits row (``mode="logits"``) of that clip.
    """

    def __init__(self, model: Any, config: Optional[ServiceConfig] = None) -> None:
        self.model = model
        # A private copy: callers share one ServiceConfig across a pool, and
        # the service must never change another service's knobs.
        self.config = replace(config) if config is not None else ServiceConfig()
        ac = getattr(model, "audio_config", None)
        self.sample_rate = int(getattr(ac, "sample_rate", None) or 16000)
        self.target_len = int(self.config.clip_seconds * self.sample_rate)
        if self.config.mode == "embed":
            model.register_hooks_for_layers(list(self.config.layers))
        self.stats: Dict[str, Any] = {"requests": 0, "batches": 0, "padded_rows": 0, "bucket_counts": Counter()}
        self._queue: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        # Coalescing window during warmup (ms); None = config.max_wait_ms.
        self._wait_override_ms: Optional[float] = None
        self._thread = threading.Thread(target=self._loop, daemon=True, name="avex-batcher")
        self._thread.start()

    # ------------------------------------------------------------------
    # Producer side
    # ------------------------------------------------------------------

    def submit(self, wav: np.ndarray, sr: Optional[int] = None) -> "Future":
        """Enqueue one clip; returns a Future resolving to its output row.

        The host work happens here, on the caller's thread: mono mixdown,
        resampling to the model's rate, center crop or right pad to the
        clip length.
        """
        wav = np.asarray(wav, dtype=np.float32)
        if wav.ndim == 2:  # (channels, samples) or (samples, channels)
            wav = wav.mean(axis=0 if wav.shape[0] <= 2 else 1)
        if wav.ndim != 1:
            raise ValueError(f"expected mono waveform, got shape {wav.shape}")
        if sr is not None and int(sr) != self.sample_rate:
            wav = resample(wav, int(sr), self.sample_rate)
        clip, mask = pad_or_window_np(wav, self.target_len, window_selection="center")
        future: "Future" = Future()
        # Under the lock that close() takes, so nothing lands behind its sentinel.
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self._queue.put((clip, mask, future))
            self.stats["requests"] += 1
        return future

    def infer(self, wav: np.ndarray, sr: Optional[int] = None, timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(wav, sr).result(timeout=timeout)

    # ------------------------------------------------------------------
    # Batcher thread
    # ------------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._fail_pending()
                return
            batch = [item]
            override = self._wait_override_ms
            wait_ms = override if override is not None else self.config.max_wait_ms
            deadline = time.monotonic() + wait_ms / 1000.0
            while len(batch) < self.config.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._dispatch(batch)
                    self._fail_pending()
                    return
                batch.append(nxt)
            self._dispatch(batch)

    def _fail_pending(self) -> None:
        """Resolve requests queued behind the shutdown sentinel (none can be
        submitted there, but the queue is the batcher's to drain): their
        Futures must not hang."""
        while True:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                return
            if nxt is not None:
                nxt[2].set_exception(RuntimeError("service is closed"))

    def _dispatch(self, batch: List[tuple]) -> None:
        clips = np.stack([b[0] for b in batch])
        masks = np.stack([b[1] for b in batch])
        futures = [b[2] for b in batch]
        n = len(batch)
        bucket = _bucket(n, self.config.max_batch)
        if bucket > n:  # padding rows: zero audio, nothing masked
            clips = np.concatenate([clips, np.zeros((bucket - n, clips.shape[1]), clips.dtype)])
            masks = np.concatenate([masks, np.zeros((bucket - n, masks.shape[1]), masks.dtype)])
        with self._lock:
            self.stats["batches"] += 1
            self.stats["padded_rows"] += bucket - n
            self.stats["bucket_counts"][bucket] += 1
        try:
            out = self._forward(clips, masks).float().cpu().numpy()
        except Exception as err:  # surface to every caller in the batch
            for f in futures:
                f.set_exception(err)
            return
        for i, f in enumerate(futures):
            f.set_result(out[i])

    def _forward(self, clips: np.ndarray, masks: np.ndarray):
        if self.config.mode == "embed":
            return self.model.extract_embeddings(clips, padding_mask=masks, aggregation=self.config.aggregation)
        # logits: as ModelBase.batch_inference (frontend, then the model, no mask)
        return self.model.forward(self.model.process_audio(clips))

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def warmup(self, buckets: Optional[Sequence[int]] = None, timeout: Optional[float] = None) -> None:
        """Run each bucket once ahead of traffic (default: 1 and max_batch,
        the lone request and the throughput shape): the first launch of each
        shape builds kernels and picks cuBLAS algorithms."""
        buckets = list(buckets or {1, self.config.max_batch})
        silence = np.zeros(self.target_len, np.float32)
        # A wide coalescing window, so that each warmup group forms its bucket
        # even on a slow host; it lives on a private override, never on config.
        self._wait_override_ms = max(self.config.max_wait_ms, 500.0)
        try:
            for b in sorted(set(_bucket(x, self.config.max_batch) for x in buckets)):
                futures = [self.submit(silence) for _ in range(b)]
                for f in futures:
                    f.result(timeout=timeout)
        finally:
            self._wait_override_ms = None

    def close(self) -> None:
        """Drain and stop the batcher thread."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._thread.join(timeout=30)

    def __enter__(self) -> "InferenceService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def info(self) -> Dict[str, Any]:
        """Service metadata for the /info endpoint."""
        with self._lock:
            stats = {
                **{k: v for k, v in self.stats.items() if k != "bucket_counts"},
                "bucket_counts": dict(self.stats["bucket_counts"]),
            }
        return {
            "mode": self.config.mode,
            "sample_rate": self.sample_rate,
            "clip_seconds": self.config.clip_seconds,
            "max_batch": self.config.max_batch,
            "max_wait_ms": self.config.max_wait_ms,
            "layers": list(self.config.layers),
            "aggregation": self.config.aggregation,
            "stats": stats,
        }
