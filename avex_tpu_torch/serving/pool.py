"""Multi-model co-hosting: one process, one GPU, N micro-batched services.

Port of ``avex_tpu/serving/pool.py``. A BEATs-class encoder needs a few
hundred MB of weights (half that in int8, see ``avex_tpu_torch.quant``), so
one serving process keeps a model zoo resident on the card and routes per
request (e.g. a float and an int8 BEATs, or an embedding model beside a
classifier over the same stream).

Each pooled model keeps its own :class:`InferenceService` (request queue,
batcher thread, bucket set), so one model's traffic never changes another's
batch shapes. The batcher threads enqueue on the same CUDA stream; PyTorch
serializes the enqueues, so the models' forwards simply interleave.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence

from avex_tpu_torch.serving.service import InferenceService, ServiceConfig

__all__ = ["ServicePool"]


class ServicePool:
    """Named collection of :class:`InferenceService` instances.

    Insertion order is meaningful: the first added service is the pool's
    *default*, served on the bare ``/embed`` | ``/logits`` routes for
    backward compatibility with single-model clients.
    """

    def __init__(self) -> None:
        self._services: Dict[str, InferenceService] = {}

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------

    def add(self, name: str, service: InferenceService) -> "ServicePool":
        """Register ``service`` under ``name`` (chainable)."""
        if name in self._services:
            raise ValueError(f"model {name!r} already pooled")
        self._services[name] = service
        return self

    @classmethod
    def from_models(
        cls,
        models: Dict[str, Any],
        config: Optional[ServiceConfig] = None,
        configs: Optional[Dict[str, ServiceConfig]] = None,
    ) -> "ServicePool":
        """Pool already-loaded models: ``{name: model}`` (+ optional per-name
        ``configs`` overriding the shared ``config``)."""
        pool = cls()
        for name, model in models.items():
            cfg = (configs or {}).get(name, config)
            pool.add(name, InferenceService(model, cfg))
        return pool

    # ------------------------------------------------------------------
    # Lookup
    # ------------------------------------------------------------------

    def get(self, name: str) -> InferenceService:
        """The service for ``name`` (KeyError with the known names if absent)."""
        try:
            return self._services[name]
        except KeyError:
            raise KeyError(
                f"unknown model {name!r}; pooled models: {sorted(self._services)}"
            ) from None

    @property
    def default(self) -> InferenceService:
        """The first-added service (the bare-route model)."""
        if not self._services:
            raise RuntimeError("empty pool")
        return next(iter(self._services.values()))

    def names(self) -> list:
        """Pooled model names, insertion-ordered (default first)."""
        return list(self._services)

    def __contains__(self, name: str) -> bool:
        return name in self._services

    def __len__(self) -> int:
        return len(self._services)

    def __iter__(self) -> Iterator[str]:
        return iter(self._services)

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------

    def warmup(self, buckets: Optional[Sequence[int]] = None, timeout: Optional[float] = None) -> None:
        """Run every pooled model's buckets once, one model at a time.

        ``buckets`` forwards to :meth:`InferenceService.warmup`; pass the
        bucket sizes production traffic will drive, so that no request pays
        for a shape's first launch (kernel builds, cuBLAS algorithm choice).
        """
        for service in self._services.values():
            service.warmup(buckets=buckets, timeout=timeout)

    def info(self) -> Dict[str, Any]:
        """Pool metadata for ``GET /models``."""
        return {
            "models": {name: svc.info() for name, svc in self._services.items()},
            "default": self.names()[0] if self._services else None,
        }

    def close(self) -> None:
        """Drain and stop every pooled service."""
        for service in self._services.values():
            service.close()

    def __enter__(self) -> "ServicePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
