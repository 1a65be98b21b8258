"""Full-fp32 arithmetic on the card for the parity-critical ops.

On CUDA a float32 matmul runs in full fp32 unless
``torch.backends.cuda.matmul.allow_tf32`` was turned on, and a float32
convolution goes through cuDNN in TF32 by default. The JAX package pins
``Precision.HIGHEST`` for its fp32 frontend, so the port turns TF32 off for
both around those ops and restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def full_fp32() -> Iterator[None]:
    """Disable TF32 for matmuls and cuDNN convolutions inside the block."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False,
        ):
            yield
    finally:
        matmul.allow_tf32 = saved
