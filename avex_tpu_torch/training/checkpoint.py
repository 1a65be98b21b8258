"""Checkpoint save and restore with ``torch.save``.

Port of ``avex_tpu/training/checkpoint.py``: the same names and lifecycle —
``best_model`` / ``checkpoint_epoch_N`` / ``final_model`` / rolling
``step_checkpoint`` — each a directory holding ``checkpoint.pt`` with
``{params, opt_state}`` (``params`` is the module's state dict, buffers
included, so nothing like JAX's ``extra_variables`` is needed), beside a
``<name>.meta.json`` sidecar with ``step``, ``epoch``, ``best_val_acc`` and
any extra metadata.
Tensors are saved on the host, so a checkpoint loads on any device, and the
payload holds only tensors, numbers, strings and containers of them, so it
loads with ``torch.load(weights_only=True)``. Local paths only: a remote URI
raises.

In a multi-process run only rank 0 writes; the ``Trainer`` hands every
rank the whole tensors (gathered from the ZeRO-3 blocks under FSDP), so a
checkpoint is the same whatever layout and rank count wrote it, and a
restore places it for the run that reads it, on any number of ranks.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from avex_tpu_torch.parallel import is_main_process

__all__ = ["CheckpointManager"]

logger = logging.getLogger(__name__)

PAYLOAD = "checkpoint.pt"
_REMOTE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def _local(path: Any) -> Path:
    if _REMOTE.match(str(path)):
        raise ValueError(f"{path}: the port's checkpoints are local paths only")
    return Path(path).expanduser()


def _to_host(tree: Any) -> Any:
    """The same containers with every tensor detached and moved to the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Training checkpoint lifecycle with best / periodic / final variants."""

    def __init__(self, output_dir: str) -> None:
        self.output_dir = _local(output_dir).resolve()
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def _path(self, name: str) -> Path:
        return self.output_dir / name

    def save(
        self,
        name: str,
        params: Any,
        opt_state: Any = None,
        step: int = 0,
        epoch: int = 0,
        best_val_acc: float = 0.0,
        extra_meta: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Save a named checkpoint, replacing one of the same name; returns its
        path (on every rank; rank 0 writes it).

        ``extra_meta`` merges into the meta.json sidecar (step-level
        checkpoints carry ``step_in_epoch``, the loader state and the rng).
        """
        path = self._path(name)
        if not is_main_process():
            return str(path)
        payload: Dict[str, Any] = {"params": params}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(_to_host(payload), path / PAYLOAD)
        meta = {"step": int(step), "epoch": int(epoch), "best_val_acc": float(best_val_acc)}
        meta.update(extra_meta or {})
        (self.output_dir / f"{name}.meta.json").write_text(json.dumps(meta))
        logger.info("Saved checkpoint %s (epoch %d, step %d)", path, epoch, step)
        return str(path)

    def save_rolling(self, name: str, **kwargs) -> str:
        """Crash-safe rolling save: write ``<name>_next``, then swap it in.

        A crash inside the swap still leaves the complete ``<name>_next`` on
        disk; the trainer's resume falls back to it.
        """
        next_name = f"{name}_next"
        self.save(next_name, **kwargs)
        final = self._path(name)
        if not is_main_process():
            return str(final)
        if final.exists():
            shutil.rmtree(final)
        final_meta = self.output_dir / f"{name}.meta.json"
        final_meta.unlink(missing_ok=True)
        self._path(next_name).rename(final)
        (self.output_dir / f"{next_name}.meta.json").rename(final_meta)
        return str(final)

    def save_best(self, **kwargs) -> str:
        """Save/overwrite the best_model checkpoint."""
        return self.save("best_model", **kwargs)

    def save_final(self, **kwargs) -> str:
        """Save the final_model checkpoint."""
        return self.save("final_model", **kwargs)

    def save_epoch(self, epoch: int, **kwargs) -> str:
        """Save a periodic ``checkpoint_epoch_N``; its meta ``epoch`` is the
        next epoch to run (N is complete), as ``save_final`` records it."""
        return self.save(f"checkpoint_epoch_{epoch}", epoch=epoch + 1, **kwargs)

    def load(self, name_or_path: str) -> Dict[str, Any]:
        """Restore a checkpoint's payload merged with its metadata (the
        payload carries its own shapes and types: no template is needed)."""
        path = _local(name_or_path)
        if not path.exists():
            path = self._path(str(name_or_path))
        payload = torch.load(path / PAYLOAD, map_location="cpu", weights_only=True)
        meta_path = Path(str(path) + ".meta.json")
        if meta_path.exists():
            payload.update(json.loads(meta_path.read_text()))
        return payload

    def exists(self, name: str) -> bool:
        """True when the named checkpoint directory exists."""
        return self._path(name).exists()
