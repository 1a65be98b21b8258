"""Storage access for local and remote paths.

Counterpart of the path functions of ``avex_tpu/io/__init__.py:76-145``.
Local paths are read and written with the standard library; a remote path
(``gs://``, ``s3://``, ``r2://``, ``hf://``, ``http(s)://``) goes through
fsspec, which is imported only then, and its reads are retried with
exponential backoff. The JAX package's download cache is not part of this
module.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Any, Callable, Tuple, TypeVar

__all__ = ["anypath", "exists", "is_remote", "read_bytes", "read_text", "retry", "write_bytes", "write_text"]

logger = logging.getLogger(__name__)

_T = TypeVar("_T")
_REMOTE_SCHEMES = ("gs://", "s3://", "r2://", "hf://", "http://", "https://")


def retry(fn: Callable[[], _T], attempts: int = 3, base_delay: float = 0.5, max_delay: float = 8.0,
          retry_on: Tuple[type, ...] = (OSError, TimeoutError), description: str = "io operation") -> _T:
    """Run ``fn``, retrying transient IO failures with exponential backoff;
    the last failure is raised. ``AVEX_IO_RETRIES`` overrides ``attempts``."""
    attempts = max(1, int(os.environ.get("AVEX_IO_RETRIES", attempts)))
    delay = base_delay
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as err:
            if attempt == attempts:
                raise
            logger.warning("%s failed (attempt %d/%d): %s; retrying in %.1fs", description, attempt, attempts,
                           err, delay)
            time.sleep(delay)
            delay = min(delay * 2, max_delay)
    raise RuntimeError("unreachable")  # pragma: no cover


def is_remote(path: str) -> bool:
    """True when ``path`` names a remote (non-local) filesystem."""
    return str(path).startswith(_REMOTE_SCHEMES)


def anypath(path: str) -> str:
    """A local path with ``~`` expanded; a remote one unchanged."""
    path = str(path)
    return path if is_remote(path) else str(Path(path).expanduser())


def _remote_fs(path: str) -> Tuple[Any, str]:
    """(fsspec filesystem, path inside it) of a remote path."""
    import fsspec

    if path.startswith("r2://"):  # Cloudflare R2 speaks S3; the endpoint comes from the environment
        return fsspec.filesystem("s3"), path[len("r2://"):]
    fs, _, paths = fsspec.get_fs_token_paths(path)
    return fs, paths[0]


def exists(path: str) -> bool:
    """True when the local or remote path exists."""
    if not is_remote(path):
        return Path(anypath(path)).exists()
    fs, p = _remote_fs(path)
    return fs.exists(p)


def read_bytes(path: str) -> bytes:
    """The whole file as bytes (a remote read is retried)."""
    if not is_remote(path):
        return Path(anypath(path)).read_bytes()
    fs, p = _remote_fs(path)

    def _read() -> bytes:
        with fs.open(p, "rb") as f:
            return f.read()

    return retry(_read, description=f"read {path}")


def read_text(path: str, encoding: str = "utf-8") -> str:
    """The whole file as text."""
    return read_bytes(path).decode(encoding)


def write_bytes(path: str, data: bytes) -> None:
    """Write bytes; a local parent directory is created."""
    if not is_remote(path):
        target = Path(anypath(path))
        target.parent.mkdir(parents=True, exist_ok=True)
        target.write_bytes(data)
        return
    fs, p = _remote_fs(path)
    with fs.open(p, "wb") as f:
        f.write(data)


def write_text(path: str, text: str, encoding: str = "utf-8") -> None:
    """Write text."""
    write_bytes(path, text.encode(encoding))
