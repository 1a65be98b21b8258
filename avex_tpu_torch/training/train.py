"""Trainer: the epoch loop of training, on one device or data-parallel.

Port of ``avex_tpu/training/train.py``, in eager PyTorch:

- a step is the strategy's forward and loss, ``torch.autograd.grad`` over
  the trainable parameters and one in-place update of the optimizer chain of
  :mod:`avex_tpu_torch.training.optimizers`; the model's module holds the
  parameters, so the trained weights are the model handle's own;
- dropout and LayerDrop draw from one ``torch.Generator`` on the model's
  device, seeded from ``RunConfig.seed``; its state goes into step
  checkpoints, so a resumed run continues the same stream;
- two-stage fine-tuning: in stage 1 the ``backbone.*`` parameters take no
  update (and so no weight decay), and neither do the model's
  ``frozen_param_keys``; stage 2 rebuilds the optimizer at
  ``second_stage_lr`` (default ``0.1 * lr``) with fresh state, so its
  schedule restarts;
- after every optimizer update the model's ``post_optimizer_step`` runs,
  where it has one (EAT-SSL's EMA teacher refresh, JAX's ``post_update``);
- the three label types: ``supervised``, ``text`` (CLIP: ``text_label`` is
  tokenized on the host by the model's ``tokenize``) and
  ``self_supervised`` (EAT-SSL);
- with ``AVEX_PROFILE_DIR`` set, the first epoch runs under
  ``utils/profiling.trace`` (a ``torch.profiler`` trace written there);
- clustering evaluation (``RunConfig.clustering_eval``) on the validation
  loader every ``frequency`` epochs (never before training, as in the JAX
  ``Trainer``);
- validation with best-model saves, ``checkpoint_every_epochs``, rolling
  step checkpoints (``checkpoint_every_steps``) with the loader
  skip-forward on resume, a SIGTERM save-and-stop, and resume with the
  ``_next`` fallback of an interrupted rolling swap.

Data parallelism (``parallel/``): the mesh comes from ``RunConfig.mesh`` (or
the ``mesh`` argument), one process per device. Over a mesh of several
ranks, or of one rank in a process group:

- the weights start as rank 0's (``parallel.replicate``); under
  ``param_sharding="fsdp"`` the module then holds this rank's ZeRO-3 blocks
  between steps (``parallel/fsdp.py``), gathered whole for each forward and
  save, and the optimizer's moments are made from the blocks;
- a rank's batch is its share of the global batch (equal shares, checked);
  the forward runs inside ``parallel.global_batch``, so BatchNorm, CLIP's
  loss and EAT-SSL's sample size take the global batch;
- between ``autograd.grad`` and the optimizer the gradients are averaged
  over the ranks (one ``all_reduce`` of a flat buffer per dtype), or
  reduce-scattered to the blocks under FSDP: XLA's psum;
- LayerDrop draws from one generator seeded alike on every rank (JAX draws
  once for the global batch); dropout and the other per-row draws from the
  rank's generator, seeded from the run's seed and the rank (rank 0's as a
  single process's): JAX's distribution, not its bits;
- the epoch's metrics are averaged over ranks (``parallel.gather_metrics``);
  only rank 0 writes checkpoints, metadata and the label map;
  ``checkpoint_every_steps`` falls back to epoch checkpoints and the
  SIGTERM save-and-stop is off with more than one process, as in JAX.

The model axis (``MeshConfig.model``; rank ``r`` at ``(r // model, r %
model)``, the ranks of a data row share its batch and its generators):

- ``pipeline_microbatches`` runs the model's layer stack as a GPipe
  pipeline (``model.enable_pipeline``, ``parallel/pipeline.py``; each stage
  keeps its own layers), ``sequence_parallel`` as Megatron-SP
  (``model.enable_sequence_parallel``, ``parallel/sequence.py``); they
  conflict with each other, the pipeline with ZeRO-3, and a model without
  the method raises, as in JAX;
- otherwise, and with sequence parallelism (Megatron-SP with tensor
  parallelism, the dry run's cell 7), a model axis of more than one rank
  cuts the tensors JAX's ``_tp_shard_params`` cuts (``parallel/tensor.py``)
  in the constructor. JAX's ``Trainer`` keeps them whole there; the values
  are the same. Under ZeRO-3 a cut tensor's data-axis block is taken along
  its other dimension, as JAX places it;
- after ``autograd.grad`` the gradients of the whole tensors that each
  model rank reads only in part are summed over the model axis, then the
  data axis averages; the clipping norm is the whole model's (a tensor cut
  over an axis counted over it, a whole one once);
- checkpoints hold whole tensors: every stage's layers, every rank's
  block, gathered before rank 0 writes; a resume places them anew.

Without ``torch.distributed`` the mesh has one process and no collective
runs: a step is what it was before the mesh existed. Buffer donation has no
meaning in eager PyTorch.
"""

from __future__ import annotations

import contextlib
import csv
import json
import logging
import os
import signal
import time
import uuid
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from avex_tpu_torch.configs import RunConfig
from avex_tpu_torch.parallel import (
    all_gather_into,
    average_gradients,
    fsdp_sharding,
    gather_metrics,
    global_batch,
    is_main_process,
    make_mesh,
    replicate,
    shard_batch,
    shard_params_fsdp,
    sum_over_ranks,
    world_size,
)
from avex_tpu_torch.parallel.pipeline import shard_pipeline_params
from avex_tpu_torch.parallel.tensor import TensorParallelLayout
from avex_tpu_torch.training.checkpoint import CheckpointManager
from avex_tpu_torch.training.clustering_evaluator import ClusteringEvaluator
from avex_tpu_torch.training.metrics_tracker import MetricsTracker
from avex_tpu_torch.training.optimizers import make_optimizer
from avex_tpu_torch.training.strategies import make_strategy
from avex_tpu_torch.utils.profiling import trace

__all__ = ["TrainState", "Trainer"]

logger = logging.getLogger(__name__)


def _rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generator: the run's seed on rank 0, a
    draw of ``SeedSequence([seed, rank])`` on the others."""
    return seed if rank == 0 else int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


@dataclass
class TrainState:
    """What a step advances besides the parameters: the update count, the
    optimizer state and the random generator."""

    step: int
    opt_state: Dict[str, Any]
    generator: torch.Generator


def _tree_to(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree


class Trainer:
    """Epoch-loop trainer over any iterable of host batches.

    Batches are dicts with ``raw_wav`` (B, T), an optional ``padding_mask``
    and ``label`` (class indices, or one- or multi-hot); numpy or tensors.
    """

    def __init__(
        self,
        model,
        config: RunConfig,
        train_loader: Iterable,
        val_loader: Optional[Iterable] = None,
        mesh=None,
        exp_logger=None,
        steps_per_epoch: Optional[int] = None,
        checkpoint_every_epochs: int = 0,
    ) -> None:
        self.model = model
        self.config = config
        self.params_cfg = config.training_params
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.exp_logger = exp_logger
        self.device = model.device
        self.strategy = make_strategy(config.label_type, config.loss_function, config.multilabel)
        self.mode = {"supervised": "supervised", "text": "clip", "self_supervised": "ssl"}[config.label_type]
        self.checkpoints = CheckpointManager(config.output_dir)
        self.checkpoint_every_epochs = checkpoint_every_epochs
        self.checkpoint_every_steps = int(config.checkpoint_every_steps or 0)
        if self.checkpoint_every_steps and world_size() > 1:
            logger.warning("checkpoint_every_steps is single-process only; falling back to epoch-level "
                           "checkpoints on this %d-process run", world_size())
            self.checkpoint_every_steps = 0
        self._preempted = False
        self._resume_step_in_epoch = 0
        self._resume_loader_state = None

        # During-training clustering evaluation on the validation loader.
        self.clustering_evaluator = None
        cluster_cfg = config.clustering_eval
        if cluster_cfg is not None and cluster_cfg.enabled and val_loader is not None:
            try:
                self.clustering_evaluator = ClusteringEvaluator(model, cluster_cfg, val_loader,
                                                                num_classes=model.num_classes or 2, seed=config.seed)
            except (ValueError, NotImplementedError, ImportError) as err:
                logger.warning("clustering eval disabled: %s", err)

        if steps_per_epoch is None:
            try:
                steps_per_epoch = len(train_loader)
            except TypeError:
                steps_per_epoch = 100
        self.steps_per_epoch = steps_per_epoch
        self.total_steps = steps_per_epoch * self.params_cfg.train_epochs

        mesh_cfg = config.mesh
        self.mesh = mesh or make_mesh(mesh_cfg.data, mesh_cfg.model, mesh_cfg.axis_names, device=self.device)
        self._pipeline = int(mesh_cfg.pipeline_microbatches or 0)
        self._sequence_parallel = bool(mesh_cfg.sequence_parallel)
        self._layout = None  # ZeRO-3 over the data axis
        self._layerdrop_generator = None
        if self.mesh.distributed:  # whole tensors, before the model axis cuts them
            replicate(model.module, self.mesh)
            self._layerdrop_generator = torch.Generator(device=self.device).manual_seed(config.seed)
        self._claim_model_axis(model, mesh_cfg.param_sharding)
        self._model_layout = getattr(model, "model_axis_layout", None)  # over the model axis (SP sets it)
        if self._pipeline and self.mesh.model_size > 1:
            self._model_layout = shard_pipeline_params(model.module, self.mesh)
        elif self.mesh.model_size > 1 and not self._sequence_parallel:
            self._model_layout = TensorParallelLayout(model.module, self.mesh)
        model.model_axis_layout = self._model_layout
        if self.mesh.distributed and mesh_cfg.param_sharding == "fsdp":
            self._layout = shard_params_fsdp(model.module, self.mesh, mesh_cfg.fsdp_min_size, self._fsdp_axes())

        self._params = dict(model.module.named_parameters())
        self._stage = 1 if self.params_cfg.freeze_backbone_epochs > 0 else 2
        self._build_step(stage=self._stage)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(_rank_seed(config.seed, self.mesh.rank))
        self.state = TrainState(step=0, opt_state=self._tx.init(self._trainable), generator=generator)
        self.best_val_acc = -np.inf
        self.start_epoch = 0
        if config.resume_from_checkpoint:
            self._resume(config.resume_from_checkpoint)

    # ------------------------------------------------------------------

    def _claim_model_axis(self, model, param_sharding: str) -> None:
        """The layer runner the mesh config asks for, with JAX's conflicts."""
        if self._pipeline and self._sequence_parallel:
            raise ValueError("pipeline_microbatches and sequence_parallel both claim the encoder layer runner; "
                             "enable one")
        if self._sequence_parallel:
            if not hasattr(model, "enable_sequence_parallel"):
                raise ValueError(f"model {type(model).__name__} does not support sequence parallelism "
                                 "(no enable_sequence_parallel)")
            model.enable_sequence_parallel(self.mesh)
        if self._pipeline:
            if param_sharding == "fsdp":
                raise ValueError("pipeline_microbatches and param_sharding='fsdp' do not compose "
                                 "(the layer stack shards over the model axis)")
            if not hasattr(model, "enable_pipeline"):
                raise ValueError(f"model {type(model).__name__} does not support pipeline parallelism "
                                 "(no enable_pipeline; needs a scanned layer stack)")
            model.enable_pipeline(self.mesh, self._pipeline)

    def _fsdp_axes(self) -> Optional[Dict[str, Optional[int]]]:
        """ZeRO-3's data-axis dimension of each tensor that tensor parallelism
        cut, as JAX places it: the other dimension, for a tensor ZeRO-3 cuts
        at all (by its whole shape) and whose other dimension divides."""
        layout = self._model_layout
        if not isinstance(layout, TensorParallelLayout):
            return None
        axes: Dict[str, Optional[int]] = {}
        for name, dim in layout.cut.items():
            other, local = 1 - dim, layout.params[name].shape
            cut = fsdp_sharding(layout.full_shape[name], self.mesh, self.config.mesh.fsdp_min_size) is not None
            axes[name] = other if cut and local[other] % self.mesh.size == 0 else None
        return axes

    def _whole_opt_state(self) -> Dict[str, Any]:
        """The optimizer state with whole moments (a collective under ZeRO-3
        or a model axis)."""
        opt_state = dict(self.state.opt_state)
        for moment in ("mu", "nu"):
            tensors = opt_state[moment]
            if self._layout is not None:
                tensors = {**tensors, **self._layout.gather_tensors(
                    {n: t for n, t in tensors.items() if n in self._layout.shards})}
            if self._model_layout is not None:
                tensors = self._model_layout.gather_tensors(tensors)
            opt_state[moment] = tensors
        return opt_state

    def _placed_opt_state(self, opt_state: Dict[str, Any]) -> Dict[str, Any]:
        """Whole moments → this run's layout (the model axis's, then ZeRO-3's blocks)."""
        opt_state = dict(opt_state)
        for moment in ("mu", "nu"):
            tensors = opt_state[moment]
            if self._model_layout is not None:
                tensors = self._model_layout.local_state(tensors)
            if self._layout is not None:
                tensors = {n: self._layout.shard_of(n, t) if n in self._layout.shards else t
                           for n, t in tensors.items()}
            opt_state[moment] = tensors
        return opt_state

    def _global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The L2 norm of the whole model's gradient from this rank's share
        of it: a tensor cut over the data axis (ZeRO-3) or the model axis
        (tensor parallelism, a pipeline stage's) summed over that axis, a
        whole one counted once."""
        data_cut = set(self._layout.shards) if self._layout is not None else set()
        split = self._model_layout.split if self._model_layout is not None else (lambda name: False)
        parts: list = [[], [], [], []]  # by (data-cut, model-split)
        for n, g in grads.items():
            parts[2 * (n in data_cut) + bool(split(n))].append(g.float().square().sum())
        sums = torch.stack([torch.stack(p).sum() if p else torch.zeros((), device=self.mesh.device)
                            for p in parts])
        sums[2:] = sum_over_ranks([sums[2:].contiguous()], self.mesh)[0]
        model_split = sums[1::2].contiguous()
        sums[1::2] = sum_over_ranks([model_split], self.mesh.model_axis)[0]
        return torch.sqrt(sums.sum())

    def _build_step(self, stage: int) -> None:
        """(Re)build the optimizer and the trainable set for the given stage."""
        lr_override = None
        if stage == 2 and self.params_cfg.freeze_backbone_epochs > 0:
            lr_override = self.params_cfg.second_stage_lr or 0.1 * self.params_cfg.lr
        self._tx, self._schedule = make_optimizer(
            self.params_cfg,
            self.config.scheduler,
            total_steps=self.total_steps,
            params=self.model.module,
            lr_override=lr_override,
        )
        frozen = set(getattr(self.model, "frozen_param_keys", ()) or ())
        if stage == 1:
            frozen.add("backbone")
        self._trainable = {n: p for n, p in self._params.items() if n.split(".", 1)[0] not in frozen}

    def _device_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The batch's numeric entries as tensors on the model's device:
        waveforms and float labels in fp32, integer labels and token ids as
        int64; text (``text_label``) stays behind, tokenized on the host
        first into ``text_tokens`` in ``text`` mode. A pinned tensor (the
        loader's, for a ``cuda`` run) is copied without blocking the host."""
        if self.mode == "clip" and batch.get("text_label") is not None:
            batch = dict(batch, text_tokens=self.model.tokenize(list(batch["text_label"])))
        out: Dict[str, torch.Tensor] = {}
        for key, value in shard_batch(batch, self.mesh).items():
            if value.dtype == torch.bool:
                out[key] = value
            elif value.is_floating_point():
                out[key] = value.to(torch.float32)
            elif value.dtype in (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8):
                out[key] = value.to(torch.int64)
        return out

    @contextlib.contextmanager
    def _whole_params(self, update: bool = False):
        """The module holds whole parameters inside (FSDP's blocks are gathered;
        with ``update`` they are taken anew from the whole ones on the way out)."""
        with self._layout.unsharded(update) if self._layout is not None else contextlib.nullcontext():
            yield

    def _train_step(self, batch: Dict[str, Any]):
        """One optimizer update on ``batch``; returns (loss, step metrics)."""
        self.model.module.train()
        batch = self._device_batch(batch)
        if self._layout is not None:
            self._layout.gather()
        names = list(self._trainable)
        params = [self._trainable[n] for n in names]
        with global_batch(self.mesh, self._layerdrop_generator):
            loss, metrics = self.strategy.forward_loss(
                self.model.train_forward, batch, self.state.generator, train=True
            )
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        # A parameter the loss does not reach gets a zero gradient, as in JAX.
        grads = {n: g if g is not None else torch.zeros_like(p) for n, p, g in zip(names, params, grads)}
        if self._model_layout is not None:
            grads = self._model_layout.reduce_gradients(grads)
        if self._layout is not None:
            grads = self._layout.reduce_gradients(grads)
            self._layout.release()
        elif self.mesh.distributed:
            grads = average_gradients(grads, self.mesh)
        norm = None
        if self._tx.clip_norm and (self._layout is not None or self._model_layout is not None):
            norm = self._global_norm(grads)
        self._tx.step(self._trainable, grads, self.state.opt_state, global_norm=norm)
        post_update = getattr(self.model, "post_optimizer_step", None)
        if post_update is not None:
            post_update()  # model-owned state, e.g. the EMA teacher
        self.state.step += 1
        return loss.detach(), metrics

    def _eval_step(self, batch: Dict[str, Any]):
        self.model.module.eval()
        batch = self._device_batch(batch)
        with torch.no_grad(), self._whole_params(), global_batch(self.mesh):
            return self.strategy.forward_loss(self.model.train_forward, batch, None, train=False)

    def _resume(self, path: str) -> None:
        # Interrupted rolling swap: the stable name may be mid-rename while
        # the complete _next checkpoint survives; fall back to it.
        if not Path(str(path)).exists() and Path(str(path) + "_next").exists():
            logger.warning("checkpoint %s missing; resuming from %s_next (interrupted rolling swap)", path, path)
            path = str(path) + "_next"
        payload = self.checkpoints.load(path)
        # Checkpoints hold whole tensors: they are placed for this run's layout
        # whatever the layout and the rank count that wrote them.
        params = payload["params"]
        if self._model_layout is not None:
            params = self._model_layout.local_state(params)
        with self._whole_params(update=True):
            self.model.module.load_state_dict(params)
        opt_state = _tree_to(payload["opt_state"], self.device)
        if set(opt_state["mu"]) != set(self._trainable):
            raise ValueError(f"checkpoint {path}: its optimizer state covers other parameters than "
                             f"this stage trains")
        self.state.opt_state = self._placed_opt_state(opt_state)
        self.state.step = int(payload.get("step", 0))
        self.start_epoch = int(payload.get("epoch", 0))
        self.best_val_acc = float(payload.get("best_val_acc", -np.inf))
        # Mid-epoch (step-level) checkpoints carry the position inside the
        # epoch, a stateful loader's iterator state and the generator's state.
        self._resume_step_in_epoch = int(payload.get("step_in_epoch", 0) or 0)
        self._resume_loader_state = payload.get("loader_state")
        rng = payload.get("rng")
        if rng is not None and payload.get("rng_ranks", 1) != self.mesh.size:
            logger.warning("checkpoint %s holds the generators of %s ranks; this run's %d keep their seeds",
                           path, payload.get("rng_ranks", 1), self.mesh.size)
        elif rng is not None:
            state = rng[self.mesh.rank] if self.mesh.size > 1 else rng
            self.state.generator.set_state(torch.tensor(state, dtype=torch.uint8))
        logger.info("Resumed from %s at epoch %d, step %d in the epoch", path, self.start_epoch,
                    self._resume_step_in_epoch)

    def _save_kwargs(self) -> Dict[str, Any]:
        """What a checkpoint holds: whole tensors under any layout (FSDP's
        blocks, the model axis's blocks and stages are gathered, collectives
        every rank joins)."""
        with self._whole_params():
            params = self.model.module.state_dict()
        if self._model_layout is not None:
            params = self._model_layout.gather_tensors(params)
        opt_state = self._whole_opt_state()
        kwargs = {"params": params, "opt_state": opt_state, "step": self.state.step}
        if self.mesh.size > 1:  # each rank's generator goes with every checkpoint
            kwargs["extra_meta"] = self._generator_states()
        return kwargs

    def _generator_states(self) -> Dict[str, Any]:
        """Every rank's generator state (a list over ranks with more than one,
        a collective), for an exact resume."""
        state = self.state.generator.get_state()
        if self.mesh.size == 1:
            return {"rng": state.tolist()}
        blocks = state.to(self.mesh.device)
        gathered = blocks.new_empty(self.mesh.size * blocks.numel())
        all_gather_into(gathered, blocks, self.mesh)
        return {"rng": gathered.view(self.mesh.size, -1).cpu().tolist(), "rng_ranks": self.mesh.size}

    def _save_metadata(self, checkpoint_name: str, metrics: Dict[str, float],
                       is_best: bool = False, is_final: bool = False) -> None:
        """Append one row (run id, checkpoint, config snapshot, metrics) to
        ``<output_dir>/metadata/experiment_metadata.csv``, rewriting it with
        the union of the rows' columns, as the JAX package does (rank 0 only)."""
        if not is_main_process():
            return
        path = self.checkpoints.output_dir / "metadata" / "experiment_metadata.csv"
        path.parent.mkdir(parents=True, exist_ok=True)
        rows = list(csv.DictReader(path.open(newline=""))) if path.exists() else []
        row = {
            "id": self.config.run_name or uuid.uuid4().hex[:12],
            "end_timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "checkpoint_name": checkpoint_name, "is_best": is_best, "is_final": is_final,
            "config": json.dumps(self.config.to_dict(), sort_keys=True, default=str),
        }
        row.update({k: float(v) for k, v in (metrics or {}).items() if isinstance(v, (int, float))})
        rows.append(row)
        columns = list(dict.fromkeys(k for r in rows for k in r))
        with path.open("w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=columns)
            writer.writeheader()
            writer.writerows(rows)

    # ------------------------------------------------------------------

    def _save_step_checkpoint(self, epoch: int, step_in_epoch: int) -> str:
        """Rolling mid-epoch checkpoint with the loader's and the generator's state."""
        loader_state = None
        if hasattr(self.train_loader, "iterator_state"):
            try:
                loader_state = self.train_loader.iterator_state()
            except Exception as err:  # keep training; the skip-forward resume still works
                logger.warning("could not capture loader state: %s", err)
        kwargs = self._save_kwargs()
        kwargs["extra_meta"] = {"step_in_epoch": int(step_in_epoch), "loader_state": loader_state,
                                **(kwargs.get("extra_meta") or self._generator_states())}
        return self.checkpoints.save_rolling("step_checkpoint", epoch=epoch, best_val_acc=self.best_val_acc,
                                             **kwargs)

    def _run_epoch(self, loader: Iterable, train: bool, epoch: int, start_step: int = 0,
                   iterator=None) -> Dict[str, float]:
        """One pass over ``loader``; ``iterator``/``start_step`` continue an
        epoch resumed mid-way with the step counter at its true position."""
        tracker = MetricsTracker(mode=self.mode, metric_names=self.config.metrics,
                                 num_classes=self.model.num_classes)
        t0 = time.time()
        stream = iterator if iterator is not None else loader
        for step_idx, batch in enumerate(stream, start=start_step):
            labels = batch.get("label")
            if train:
                loss, metrics = self._train_step(batch)
            else:
                loss, metrics = self._eval_step(batch)
            tracker.update(loss, metrics, labels=labels)
            if train and self.checkpoint_every_steps and (step_idx + 1) % self.checkpoint_every_steps == 0:
                self._save_step_checkpoint(epoch, step_idx + 1)
            if train and self._preempted:
                self._save_step_checkpoint(epoch, step_idx + 1)
                logger.warning("Preemption signal: saved step_checkpoint at epoch %d step %d, stopping",
                               epoch, step_idx + 1)
                break
            if train and (step_idx + 1) % self.params_cfg.log_steps == 0:
                logger.info("epoch %d step %d loss %.4f (%.1f samples/s)", epoch, step_idx + 1,
                            tracker.avg_loss, tracker.sample_count / max(time.time() - t0, 1e-6))
        metrics = tracker.epoch_metrics()
        metrics["epoch_seconds"] = time.time() - t0
        metrics["primary"] = tracker.primary_metric()
        if self.mesh.size > 1:
            # every rank logs and compares the same numbers: best-checkpoint
            # decisions must not diverge
            metrics = gather_metrics(metrics, self.mesh)
        return metrics

    def train(self) -> Dict[str, Any]:
        """Run the full training loop; returns the final metric summary."""
        prev_handler = None
        if self.config.save_on_preemption and world_size() == 1:
            # A preemption delivers SIGTERM: save a resumable step checkpoint
            # and leave the loop cleanly instead of dying mid-step.
            try:
                prev_handler = signal.signal(signal.SIGTERM, lambda *_a: setattr(self, "_preempted", True))
            except ValueError:  # not the main thread
                prev_handler = None
        try:
            return self._train_loop()
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            if self._layout is not None:
                self._layout.gather()  # the model handle holds the whole trained weights
            self.model.eval()

    def _clustering(self, epoch: int) -> Optional[Dict[str, float]]:
        """The clustering metrics due after ``epoch``, or None. As in the JAX
        ``Trainer``, nothing is scored before the first epoch."""
        if self.clustering_evaluator is None or not self.clustering_evaluator.should_run(epoch):
            return None
        self.model.eval()  # the module trained in place: extraction sees the current weights
        with self._whole_params():
            return self.clustering_evaluator.evaluate()

    def _train_loop(self) -> Dict[str, Any]:
        cfg = self.params_cfg
        history = []
        for epoch in range(self.start_epoch, cfg.train_epochs):
            if self._stage == 1 and epoch >= cfg.freeze_backbone_epochs:
                logger.info("Stage 2: unfreezing backbone at reduced LR")
                self._stage = 2
                self._build_step(stage=2)
                self.state.opt_state = self._tx.init(self._trainable)

            if hasattr(self.train_loader, "set_epoch"):
                self.train_loader.set_epoch(epoch)

            # Mid-epoch resume: continue the interrupted epoch from its saved
            # position, from the loader's restored iterator state or by
            # skipping the batches already trained.
            start_step, resume_iterator = 0, None
            if epoch == self.start_epoch and self._resume_step_in_epoch:
                start_step = self._resume_step_in_epoch
                if self._resume_loader_state is not None and hasattr(self.train_loader, "restore_iterator"):
                    resume_iterator = self.train_loader.restore_iterator(self._resume_loader_state)
                    logger.info("Restored exact loader state at step %d", start_step)
                else:
                    resume_iterator = iter(self.train_loader)
                    for _ in range(start_step):
                        next(resume_iterator, None)
                    logger.info("Skip-forwarded loader by %d batches", start_step)
                self._resume_step_in_epoch = 0
                self._resume_loader_state = None

            profile_dir = os.environ.get("AVEX_PROFILE_DIR")
            profiled = bool(profile_dir) and epoch == self.start_epoch  # the first epoch, as in JAX
            with trace(profile_dir) if profiled else contextlib.nullcontext():
                train_metrics = self._run_epoch(self.train_loader, train=True, epoch=epoch,
                                                start_step=start_step, iterator=resume_iterator)
            if profiled:
                logger.info("profiled epoch %d -> %s", epoch, profile_dir)
            record = {"epoch": epoch, "train": train_metrics}
            if self._preempted:
                history.append(record)
                logger.warning("Training preempted at epoch %d; resumable from step_checkpoint", epoch)
                return {"history": history, "best_val_acc": self.best_val_acc, "preempted": True,
                        "final_checkpoint": str(self.checkpoints._path("step_checkpoint"))}

            if self.val_loader is not None and not cfg.skip_validation:
                val_metrics = self._run_epoch(self.val_loader, train=False, epoch=epoch)
                record["val"] = val_metrics
                if val_metrics["primary"] > self.best_val_acc:
                    self.best_val_acc = val_metrics["primary"]
                    # meta epoch = the next epoch to run (this one is complete)
                    self.checkpoints.save_best(epoch=epoch + 1, best_val_acc=self.best_val_acc,
                                               **self._save_kwargs())
                    self._save_metadata("best_model", val_metrics, is_best=True)

            if self.checkpoint_every_epochs and (epoch + 1) % self.checkpoint_every_epochs == 0:
                self.checkpoints.save_epoch(epoch, best_val_acc=self.best_val_acc, **self._save_kwargs())

            clustering = self._clustering(epoch)
            if clustering is not None:
                record["clustering"] = clustering

            if self.exp_logger is not None:
                flat = {f"train/{k}": v for k, v in train_metrics.items()}
                flat.update({f"val/{k}": v for k, v in record.get("val", {}).items()})
                flat.update({f"clustering/{k}": v for k, v in record.get("clustering", {}).items()})
                self.exp_logger.log_metrics(flat, step=epoch)
            history.append(record)
            logger.info("epoch %d done: %s", epoch,
                        {k: round(v, 4) if isinstance(v, float) else v for k, v in train_metrics.items()})

        final_path = self.checkpoints.save_final(epoch=cfg.train_epochs, best_val_acc=self.best_val_acc,
                                                 **self._save_kwargs())
        self._save_metadata("final_model", history[-1]["train"] if history else {}, is_final=True)
        if self.model.label_mapping is not None and is_main_process():
            (self.checkpoints.output_dir / "label_map.json").write_text(json.dumps(self.model.label_mapping))
        # The module trained in place: the model handle already holds the trained weights.
        return {"history": history, "best_val_acc": self.best_val_acc, "final_checkpoint": final_path}
