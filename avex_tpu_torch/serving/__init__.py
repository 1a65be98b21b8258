"""Inference serving on the GPU (port of ``avex_tpu/serving``).

``InferenceService`` micro-batches concurrent requests into power-of-two
bucket shapes; ``ServicePool`` co-hosts several models; ``AvexHTTPServer``
puts a dependency-free HTTP API in front of either. See ``service.py`` for
the design.
"""

from avex_tpu_torch.serving.http import AvexHTTPServer
from avex_tpu_torch.serving.pool import ServicePool
from avex_tpu_torch.serving.service import InferenceService, ServiceConfig

__all__ = ["InferenceService", "ServiceConfig", "AvexHTTPServer", "ServicePool"]
