"""Probe training for evaluation: offline (cached embeddings) and online.

Port of ``avex_tpu/evaluation/finetune.py``:

- :class:`FineTuneTrainer`: the schedule of ``build_scheduler`` (warmup in
  epochs), cross-entropy or BCE, optax's ``adamw`` with no decay mask (every
  probe parameter is decayed, biases and LayerNorm included; not the
  ``Trainer``'s masked AdamW), global-norm clipping chained in front,
  per-epoch metrics, and the best-validation parameters kept as a host copy
  and restored at the end (into the backbone too when it trained);
- :func:`train_and_eval_offline`: a probe over cached embeddings (batches
  with ``embeddings_{i}`` and ``label``);
- :func:`train_and_eval_online`: a probe on the backbone on raw audio.
  Frozen, the backbone's extraction forward runs under ``torch.no_grad()``;
  unfrozen, the same extraction forward runs with gradients and its
  parameters train with the probe's. As in JAX, that forward is the
  extraction one, not ``train_forward``: the backbone gets no dropout and
  no LayerDrop.

Dropout in the head draws from one ``torch.Generator`` on the probe's
device, seeded from ``seed``.

With a ``mesh`` of several ranks the probe trains data-parallel: every rank
starts from rank 0's trainable parameters, its batches are its shares of
the global batches (equal, checked), the gradients are averaged over the
ranks before the clipped AdamW, the training loss is averaged over the
ranks and the evaluation scores the gathered global set, so every rank
keeps the same best parameters. On a mesh with a model axis the MoE head
goes expert-parallel, as JAX's ``_place_trainable`` places it
(``ops/moe.shard_moe_params``): each model rank holds and runs its slice
of the experts, the router and the rest stay whole, the clipping norm
counts each cut tensor once, and after training the probe holds its whole
parameters again (as JAX's ``device_get`` hands them back). Other heads
are whole on every model rank, which compute the same step.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avex_tpu_torch.configs import ProbeConfig, TrainingParams
from avex_tpu_torch.metrics import get_metric_class
from avex_tpu_torch.ops.moe import ExpertParallelLayout, shard_moe_params
from avex_tpu_torch.parallel import (
    Mesh,
    average_gradients,
    check_equal_rows,
    gather_rows,
    global_batch,
    replicate,
    sum_over_ranks,
)
from avex_tpu_torch.probes import Probe, build_probe_from_config
from avex_tpu_torch.training.losses import bce_loss, cross_entropy_loss
from avex_tpu_torch.training.optimizers import AdamW, build_scheduler

__all__ = ["FineTuneTrainer", "train_and_eval_offline", "train_and_eval_online"]

logger = logging.getLogger(__name__)


def _batch_embeddings(batch: Dict[str, Any]) -> List[Any]:
    """The ordered per-layer embeddings of a cached-embedding batch."""
    embs = []
    while f"embeddings_{len(embs)}" in batch:
        embs.append(batch[f"embeddings_{len(embs)}"])
    if not embs and "raw_wav" in batch:
        embs = [batch["raw_wav"]]
    return embs


class FineTuneTrainer:
    """Train a probe (with its backbone, online and unfrozen) and evaluate it."""

    def __init__(
        self,
        probe: Probe,
        training_params: TrainingParams,
        metrics: Sequence[str] = ("accuracy",),
        multilabel: bool = False,
        mesh: Optional[Mesh] = None,
        mode: str = "offline",
        seed: int = 0,
    ) -> None:
        if mode not in ("offline", "online"):
            raise ValueError(f"mode must be 'offline' or 'online', got {mode!r}")
        self.probe = probe
        self.params_cfg = training_params
        self.metric_names = list(metrics)
        self.multilabel = multilabel
        self.mode = mode
        self.seed = seed
        self.device = probe.device
        self.criterion = bce_loss if multilabel else cross_entropy_loss
        self.best_val_metric = -np.inf
        self._best_params: Optional[Dict[str, torch.Tensor]] = None
        self.train_backbone = mode == "online" and not probe.freeze_backbone
        self.mesh = mesh if mesh is not None and (mesh.size > 1 or mesh.model_size > 1) else None
        self._trainable = self._initial_trainable()
        self._experts: Optional[ExpertParallelLayout] = None
        if self.mesh is not None:
            replicate(probe.module, self.mesh)
            if self.train_backbone:
                replicate(probe.base_model.module, self.mesh)
            if probe.probe_type == "moe" and self.mesh.model_size > 1:
                self._experts = shard_moe_params(probe.module, self.mesh, axis="model")
        self._tx: Optional[AdamW] = None
        self._opt_state: Optional[Dict[str, Any]] = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if mode == "online":
            base = probe.base_model
            self._extract = base.extract_fn(tuple(base._hook_layers), probe.aggregation)

    def _initial_trainable(self) -> Dict[str, torch.Tensor]:
        """Name → parameter of everything the optimizer updates: ``probe.*``,
        and ``backbone.*`` when the backbone trains."""
        trainable = {f"probe.{n}": p for n, p in self.probe.module.named_parameters() if p.requires_grad}
        if self.train_backbone:
            trainable.update({f"backbone.{n}": p for n, p in self.probe.base_model.module.named_parameters()})
        return trainable

    def _to_device(self, value: Any) -> torch.Tensor:
        """``value`` on the probe's device (integers as int64); a pinned
        tensor (the loader's, for a ``cuda`` run) is copied without blocking."""
        t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        non_blocking = t.is_pinned()
        if t.dtype == torch.bool or t.is_floating_point():
            return t.to(self.device, non_blocking=non_blocking)
        return t.to(self.device, torch.int64, non_blocking=non_blocking)

    def _forward(self, batch: Dict[str, Any], train: bool) -> torch.Tensor:
        mask = batch.get("padding_mask")
        mask = None if mask is None else self._to_device(mask)
        if self.mode == "offline":
            embs = [self._to_device(e) for e in _batch_embeddings(batch)]
        else:
            base = self.probe.base_model
            with torch.set_grad_enabled(train and self.train_backbone):
                embs = self._extract(base._as_input(self._to_device(batch["raw_wav"])), base._as_mask(mask))
            embs = list(embs) if isinstance(embs, tuple) else [embs]
        return self.probe.module(embs, mask, deterministic=not train, generator=self.generator if train else None)

    def _init_optimizer(self, steps_per_epoch: int) -> None:
        """A fresh optimizer and state for ``steps_per_epoch`` steps an epoch."""
        cfg = self.params_cfg
        schedule = build_scheduler(
            cfg.scheduler_type, cfg.lr, warmup_steps=cfg.warmup_epochs * steps_per_epoch,
            total_steps=max(steps_per_epoch * cfg.train_epochs, 1),
        )
        # optax.adamw(schedule, weight_decay=wd) with no mask, clipping in front
        self._tx = AdamW(schedule, weight_decay=cfg.weight_decay, clip_norm=cfg.gradient_clip_val)
        self._opt_state = self._tx.init(self._trainable)

    def _set_modes(self, train: bool) -> None:
        self.probe.module.train(train)
        if self.mode == "online":
            self.probe.base_model.module.eval()  # the extraction forward: no dropout, no LayerDrop

    def _train_step(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer update on ``batch``; returns (loss, logits), not synchronised."""
        self._set_modes(train=True)
        if self.mesh is not None:
            check_equal_rows(len(batch["label"]), self.mesh)
        with global_batch(self.mesh) if self.mesh is not None else contextlib.nullcontext():
            logits = self._forward(batch, train=True)
            loss = self.criterion(logits, self._to_device(batch["label"]))
            names = list(self._trainable)
            params = [self._trainable[n] for n in names]
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as in JAX
        grads = {n: g if g is not None else torch.zeros_like(p) for n, p, g in zip(names, params, grads)}
        if self.mesh is not None:
            grads = average_gradients(grads, self.mesh)
        norm = self._global_norm(grads) if self._tx.clip_norm and self._experts is not None else None
        self._tx.step(self._trainable, grads, self._opt_state, global_norm=norm)
        return loss.detach(), logits.detach()

    def _global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The whole gradient's L2 norm from this rank's share: the cut expert
        tensors' squares summed over the model axis, the whole ones once."""
        parts = [torch.zeros((), device=self.device), torch.zeros((), device=self.device)]
        for name, g in grads.items():
            parts[self._experts.split(name.removeprefix("probe."))] += g.float().square().sum()
        cut = sum_over_ranks([parts[1].reshape(1)], self.mesh.model_axis)[0][0]
        return torch.sqrt(parts[0] + cut)

    def _eval_step(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        self._set_modes(train=False)
        with torch.no_grad():
            logits = self._forward(batch, train=False)
            return self.criterion(logits, self._to_device(batch["label"])), logits

    def _run_eval(self, loader: Iterable) -> Dict[str, float]:
        """The metrics of the whole set. Under a mesh each batch's logits and
        labels are gathered from every rank (rank order), so every rank
        scores the global set: mAP, F1 or ROC-AUC of a set is not the mean of
        its shares' scores."""
        calcs = {name: get_metric_class(name, self.probe.num_classes) for name in self.metric_names}
        loss_sum, n = 0.0, 0
        for batch in loader:
            loss, logits = self._eval_step(batch)
            labels = self._to_device(batch["label"])
            if self.mesh is not None and self.mesh.size > 1:
                check_equal_rows(len(labels), self.mesh)
                logits, labels = gather_rows(logits.contiguous(), self.mesh), gather_rows(labels, self.mesh)
                loss = sum_over_ranks([loss.reshape(1)], self.mesh)[0][0] / self.mesh.size  # equal shares
            logits, labels = logits.float().cpu().numpy(), labels.cpu().numpy()
            for calc in calcs.values():
                calc.update(logits, labels)
            loss_sum += float(loss) * logits.shape[0]
            n += logits.shape[0]
        out = {name: calc.get_primary_metric() for name, calc in calcs.items()}
        out["loss"] = loss_sum / max(n, 1)
        return out

    def _host_copy(self) -> Dict[str, torch.Tensor]:
        return {n: p.detach().to("cpu", copy=True) for n, p in self._trainable.items()}

    def train(self, train_loader: Iterable, val_loader: Optional[Iterable] = None) -> Dict[str, Any]:
        """The probe-training loop; restores the best-validation parameters at
        the end. Each history record holds the epoch's mean training loss and
        ``train_seconds``, the host-clock time of its training steps."""
        try:
            steps_per_epoch = len(train_loader)
        except TypeError:
            steps_per_epoch = 100
        self._init_optimizer(steps_per_epoch)
        history = []
        for epoch in range(self.params_cfg.train_epochs):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            start = time.perf_counter()
            loss_sum, n = torch.zeros((), device=self.device), 0
            for batch in train_loader:
                loss, logits = self._train_step(batch)
                loss_sum += loss * logits.shape[0]  # summed on the device: no sync per step
                n += logits.shape[0]
            if self.mesh is not None:  # the global batch's mean: equal shares, so the mean of the ranks'
                loss_sum = sum_over_ranks([loss_sum.reshape(1)], self.mesh)[0][0] / self.mesh.size
            train_loss = float(loss_sum) / max(n, 1)  # waits for the epoch's last step
            record = {"epoch": epoch, "train_loss": train_loss, "train_seconds": time.perf_counter() - start}
            if val_loader is not None and not self.params_cfg.skip_validation:
                val = self._run_eval(val_loader)
                record["val"] = val
                primary = val.get(self.metric_names[0], -val["loss"])
                if primary > self.best_val_metric:
                    self.best_val_metric = primary
                    self._best_params = self._host_copy()
            history.append(record)
            logger.debug("probe epoch %d: %s", epoch, record)
        if self._best_params is not None:
            with torch.no_grad():
                for name, value in self._best_params.items():
                    self._trainable[name].copy_(value)
        if self._experts is not None:
            self._experts.whole(self.probe.module)
            self._experts = None
        self._set_modes(train=False)
        return {"history": history, "best_val_metric": self.best_val_metric}

    def evaluate(self, loader: Iterable) -> Dict[str, float]:
        """Test-set metrics with the (best) trained parameters."""
        return self._run_eval(loader)


def train_and_eval_offline(
    probe_config: ProbeConfig,
    training_params: TrainingParams,
    train_loader: Iterable,
    test_loader: Iterable,
    input_dims: Sequence[Tuple[int, ...]],
    num_classes: int,
    val_loader: Optional[Iterable] = None,
    metrics: Sequence[str] = ("accuracy",),
    multilabel: bool = False,
    seed: int = 0,
    device: Optional[str] = None,
) -> Tuple[Dict[str, float], FineTuneTrainer]:
    """Offline probing over cached embeddings, on ``device`` (``cuda`` unless named)."""
    input_dim = list(input_dims) if len(input_dims) > 1 else tuple(input_dims[0])
    probe = build_probe_from_config(probe_config, num_classes=num_classes, input_dim=input_dim, seed=seed,
                                    device=device)
    trainer = FineTuneTrainer(probe, training_params, metrics=metrics, multilabel=multilabel, mode="offline",
                              seed=seed)
    trainer.train(train_loader, val_loader)
    return trainer.evaluate(test_loader), trainer


def train_and_eval_online(
    probe_config: ProbeConfig,
    training_params: TrainingParams,
    base_model,
    train_loader: Iterable,
    test_loader: Iterable,
    num_classes: int,
    val_loader: Optional[Iterable] = None,
    metrics: Sequence[str] = ("accuracy",),
    multilabel: bool = False,
    seed: int = 0,
) -> Tuple[Dict[str, float], FineTuneTrainer]:
    """Online probing on raw audio through the backbone, on its device."""
    probe = build_probe_from_config(probe_config, num_classes=num_classes, base_model=base_model, seed=seed)
    trainer = FineTuneTrainer(probe, training_params, metrics=metrics, multilabel=multilabel, mode="online",
                              seed=seed)
    trainer.train(train_loader, val_loader)
    return trainer.evaluate(test_loader), trainer
