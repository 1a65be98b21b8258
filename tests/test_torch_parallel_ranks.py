"""What each rank runs in the two-process tests of the port's data parallelism.

``tests/test_torch_parallel_training.py`` writes the inputs (JAX's weights
carried across, the global batches, JAX's mask draw) into a work directory,
in two parts (``inputs.pkl``, then ``inputs_late.pkl`` while the ranks run
the first), and starts a :class:`RankGroup`: two spawned processes joined by
``parallel.init_multihost`` over a ``file://`` rendezvous in that directory,
gloo on the CPU, one thread each. Every rank runs every scenario named in
the inputs on its rows of the global batch and pickles what the test holds
against JAX. This module imports torch and the port only, so a rank starts
without JAX.

A rank that raises writes its traceback and exits 1; the group is joined
with a deadline and killed when it passes it (a rank left blocked in a
collective by a failed peer never returns).
"""

from __future__ import annotations

import multiprocessing
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

WORLD = 2


class RankGroup:
    """``world`` spawned ranks running ``main`` (default :func:`_rank_main`)
    on ``work``."""

    def __init__(self, work: Path, world: int = WORLD, timeout: float = 240.0, main=None) -> None:
        self.work, self.world, self.timeout = Path(work), world, timeout
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=main or _rank_main, args=(rank, world, str(self.work)), daemon=True)
                      for rank in range(world)]
        self.started = time.monotonic()
        for proc in self.procs:
            proc.start()
        self._results: List[Dict[str, Any]] = []

    def results(self) -> List[Dict[str, Any]]:
        """Each rank's results, in rank order; raises with the tracebacks of
        the ranks that failed, or when the deadline passes."""
        if self._results:
            return self._results
        for proc in self.procs:
            proc.join(max(self.started + self.timeout - time.monotonic(), 0.0))
        alive = [p for p in self.procs if p.is_alive()]
        for proc in alive:
            proc.kill()
            proc.join()
        errors = [(self.work / f"rank{r}.err") for r in range(self.world)]
        failed = "\n".join(e.read_text() for e in errors if e.exists())
        if alive or failed or any(p.exitcode != 0 for p in self.procs):
            raise RuntimeError(f"ranks failed (alive at the deadline: {len(alive)}; exit codes "
                               f"{[p.exitcode for p in self.procs]}):\n{failed}")
        for rank in range(self.world):
            with open(self.work / f"rank{rank}.pkl", "rb") as f:
                self._results.append(pickle.load(f))
        return self._results


def _rank_main(rank: int, world: int, work: str, scenarios=None) -> None:
    from avex_tpu_torch.parallel import init_multihost

    torch.set_num_threads(1)
    work_dir = Path(work)
    scenarios = scenarios or SCENARIOS
    try:
        init_multihost(f"file://{work_dir / 'rendezvous'}", world, rank, device="cpu")
        out = {}
        for part in ("inputs.pkl", "inputs_late.pkl"):  # the test writes the second while the first runs
            while not (work_dir / part).exists():
                time.sleep(0.1)
            with open(work_dir / part, "rb") as f:
                inputs = pickle.load(f)
            out.update({name: scenarios[name](rank, world, spec, work_dir) for name, spec in inputs.items()})
        with open(work_dir / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        (work_dir / f"rank{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def rows(value: Any, rank: int, world: int) -> Any:
    """Rank ``rank``'s equal share of a global batch entry (a dict's entries)."""
    if isinstance(value, dict):
        return {k: rows(v, rank, world) for k, v in value.items()}
    n = len(value) // world
    return value[rank * n:(rank + 1) * n]


def _np(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().numpy().copy() for k, v in tensors.items()}


# ---------------------------------------------------------------------------
# Scenarios: (rank, world, spec, work) → picklable results
# ---------------------------------------------------------------------------


def _supervised_beats(rank, world, spec, work, sharding):
    from avex_tpu_torch.configs import MeshConfig, ModelSpec, RunConfig, SchedulerConfig, TrainingParams
    from avex_tpu_torch.models.factory import build_model_from_spec
    from avex_tpu_torch.training import Trainer

    config = RunConfig(
        model_spec=ModelSpec(name="beats", pretrained=False, init_config=spec["init_config"], device="cpu",
                             audio_config=spec["audio_config"]),
        training_params=TrainingParams(**spec["training"]), output_dir=str(work / f"{sharding}_rank{rank}"),
        scheduler=SchedulerConfig(name="cosine", warmup_steps=0), seed=0, device="cpu",
        mesh=MeshConfig(param_sharding=sharding, fsdp_min_size=spec["fsdp_min_size"]),
    )
    model = build_model_from_spec(config.model_spec, num_classes=spec["num_classes"])
    model.load_port_state_dict(spec["state"], strict=True)
    trainer = Trainer(model, config, [], steps_per_epoch=spec["steps_per_epoch"])
    loss, metrics = trainer._train_step(rows(spec["batch"], rank, world))
    saved = trainer._save_kwargs()
    out = {"loss": loss.item(), "count": metrics["count"], "params": _np(saved["params"]),
           "mu": _np(saved["opt_state"]["mu"]), "nu": _np(saved["opt_state"]["nu"])}
    if sharding == "fsdp":
        out["cut"] = {n: trainer._layout.axis[n] for n in trainer._layout.shards}
        out["moment_shapes"] = {n: tuple(t.shape) for n, t in trainer.state.opt_state["mu"].items()}
        out["resident_bytes"] = trainer._layout.resident_bytes()
        out["checkpoint"] = trainer.checkpoints.save_final(epoch=1, best_val_acc=0.0, **saved)
        out["written"] = (Path(out["checkpoint"]) / "checkpoint.pt").exists()
    return out


def supervised_beats_dp(rank, world, spec, work):
    return _supervised_beats(rank, world, spec, work, "replicated")


def supervised_beats_fsdp(rank, world, spec, work):
    return _supervised_beats(rank, world, spec, work, "fsdp")


def efficientnet_batchnorm(rank, world, spec, work):
    """One train-mode forward and backward of the module on the rank's
    images: the loss, the averaged gradients and the running statistics."""
    from avex_tpu_torch.models import efficientnet as eff
    from avex_tpu_torch.parallel import average_gradients, global_batch, make_mesh

    model = eff.EfficientNetModel("b0", spec["num_classes"], torch.float32)
    model.load_state_dict({k: torch.tensor(v) for k, v in spec["state"].items()}, strict=False)
    model.train()
    mesh = make_mesh(device="cpu")
    with global_batch(mesh):
        out, _ = model(torch.from_numpy(rows(spec["images"], rank, world)))
        loss = torch.nn.functional.cross_entropy(out, torch.from_numpy(rows(spec["labels"], rank, world)))
        params = dict(model.named_parameters())
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    grads = average_gradients(grads, mesh)
    return {"loss": loss.item(), "grads": _np(grads),
            "buffers": _np({k: v for k, v in model.named_buffers() if "running" in k})}


def clip_global_batch(rank, world, spec, work):
    """CLIP's train-mode loss and averaged gradients on the rank's clips and
    captions (stochastic depth keeps every item, as in the single-process
    test)."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models import efficientnet as eff
    from avex_tpu_torch.parallel import average_gradients, global_batch, make_mesh
    from avex_tpu_torch.training.strategies import CLIPStrategy

    eff.stochastic_depth_mask = lambda bsz, keep, generator, device: torch.ones((bsz, 1, 1, 1), dtype=torch.bool,
                                                                                 device=device)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(**spec["spec"]), device="cpu")
    port.load_port_state_dict(spec["state"], strict=True)
    port.train()
    mesh = make_mesh(device="cpu")
    batch = {"raw_wav": torch.from_numpy(rows(spec["wav"], rank, world)),
             "text_tokens": torch.from_numpy(rows(spec["tokens"], rank, world)).long()}
    with global_batch(mesh):
        loss, metrics = CLIPStrategy().forward_loss(port.train_forward, batch, torch.Generator().manual_seed(0),
                                                    train=True)
    params = dict(port.module.named_parameters())
    grads = average_gradients(dict(zip(params, torch.autograd.grad(loss, list(params.values())))), mesh)
    return {"loss": loss.item(), "count": metrics["count"], "grads": _np(grads),
            "buffers": _np({k: v for k, v in port.module.named_buffers() if "running" in k})}


def clip_model_axis(rank, world, spec, work):
    """One CLIP ``Trainer`` step on a 1 x 2 mesh, the model axis cutting its
    two projections (``parallel/tensor.py``), each rank on the whole global
    batch (one data row), stochastic depth keeping every item: the loss, the
    gradient the step applied (Adam's first moment / (1 - b1)) and every
    parameter after it, whole, and the tensors cut and summed over the axis."""
    from avex_tpu_torch.configs import MeshConfig, ModelSpec, RunConfig, SchedulerConfig, TrainingParams
    from avex_tpu_torch.models import efficientnet as eff
    from avex_tpu_torch.models.factory import build_model_from_spec
    from avex_tpu_torch.training import Trainer

    eff.stochastic_depth_mask = lambda bsz, keep, generator, device: torch.ones((bsz, 1, 1, 1), dtype=torch.bool,
                                                                                 device=device)
    config = RunConfig(
        model_spec=ModelSpec(**spec["spec"], device="cpu"), training_params=TrainingParams(**spec["training"]),
        output_dir=str(work / f"clip_model_axis_rank{rank}"), scheduler=SchedulerConfig(name="cosine", warmup_steps=0),
        seed=0, device="cpu", mesh=MeshConfig(data=1, model=world), label_type="text", loss_function="clip",
    )
    model = build_model_from_spec(config.model_spec)
    model.load_port_state_dict(spec["state"], strict=True)
    trainer = Trainer(model, config, [], steps_per_epoch=spec["steps_per_epoch"])
    loss, _ = trainer._train_step({"raw_wav": spec["wav"], "text_tokens": spec["tokens"]})
    saved = trainer._save_kwargs()
    layout = trainer._model_layout
    return {"loss": loss.item(), "cut": dict(layout.cut), "partial": sorted(layout.partial),
            "params": _np(saved["params"]),
            "grads": {k: v / np.float32(0.1) for k, v in _np(saved["opt_state"]["mu"]).items()}}


def eat_ssl_step(rank, world, spec, work):
    """One ``Trainer`` step of EAT-SSL on the rank's clips, its mask draw the
    rank's rows of JAX's global draw: the loss, the student and the teacher,
    in the DDP layout and (``fsdp``: the state alone) in the ZeRO-3 one,
    where the teacher takes its student's placement."""
    from avex_tpu_torch.configs import MeshConfig, ModelSpec, RunConfig, SchedulerConfig, TrainingParams
    from avex_tpu_torch.models import eat_ssl
    from avex_tpu_torch.training import Trainer

    noise = rows(spec["noise"], rank, world)
    eat_ssl.mask_noise = lambda bsz, n, generator, device: torch.from_numpy(noise.copy()).to(device)
    out = {}
    for sharding in ("replicated", "fsdp"):
        port = eat_ssl.Model(device="cpu", eat_cfg=dict(spec["eat_cfg"]))
        port.load_port_state_dict(spec["state"], strict=True)
        config = RunConfig(
            model_spec=ModelSpec(name="eat_ssl", pretrained=False, eat_cfg=spec["eat_cfg"], device="cpu"),
            training_params=TrainingParams(**spec["training"]), output_dir=str(work / f"eat_ssl_rank{rank}"),
            scheduler=SchedulerConfig(name="cosine", warmup_steps=0), label_type="self_supervised", seed=0,
            device="cpu", mesh=MeshConfig(param_sharding=sharding, fsdp_min_size=spec["fsdp_min_size"]),
        )
        before = _np({k: v for k, v in port.state_dict().items() if k.startswith("teacher.")})
        trainer = Trainer(port, config, [], steps_per_epoch=2)
        loss, metrics = trainer._train_step(rows(spec["batch"], rank, world))
        if sharding == "fsdp":
            assert {n for n in trainer._layout.shards if n.startswith("teacher.")}, "no teacher tensor is cut"
            saved = trainer._save_kwargs()  # whole tensors
            out["fsdp"], out["fsdp_mu"] = _np(saved["params"]), _np(saved["opt_state"]["mu"])
            continue
        out.update({"loss": loss.item(), "count": metrics["count"], "state": _np(port.state_dict()),
                    "regression": metrics["loss_regression"].item(), "teacher_before": before,
                    "mu": _np(trainer.state.opt_state["mu"])})
    return out


def extraction(rank, world, spec, work):
    """Cell 5: extraction into the cache under the mesh, a remainder batch
    among the batches; each rank names a cache path of its own, so the
    test sees who wrote."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.evaluation.embedding_cache import extract_embeddings_to_cache, load_cached_embeddings
    from avex_tpu_torch.parallel import make_mesh

    model = avex_tpu_torch.build_model_from_spec(ModelSpec(**spec["spec"]), device="cpu",
                                                 return_features_only=True)
    model.load_port_state_dict(spec["state"], strict=True)
    model.register_hooks_for_layers(["last_layer"])
    path = extract_embeddings_to_cache(model, spec["batches"], work / f"cache_rank{rank}" / "x.h5",
                                       aggregation="mean", mesh=make_mesh(device="cpu"))
    if rank != 0:
        return {"written": Path(path).exists()}
    embs, labels, _meta = load_cached_embeddings(path)
    return {"written": True, "embeddings": embs[0], "labels": labels}


def metrics_mean(rank, world, spec, work):
    from avex_tpu_torch.parallel import gather_metrics

    return gather_metrics({"value": float(rank + 1), "rank": float(rank)})


def finetune(rank, world, spec, work):
    """An offline linear probe trained data-parallel on the rank's halves of
    each batch of embeddings, scored on the rank's halves of the validation
    batches."""
    from avex_tpu_torch.configs import ProbeConfig, TrainingParams
    from avex_tpu_torch.evaluation.finetune import FineTuneTrainer
    from avex_tpu_torch.parallel import make_mesh
    from avex_tpu_torch.probes import build_probe_from_config

    probe = build_probe_from_config(ProbeConfig(**spec["probe"]), num_classes=spec["num_classes"],
                                    input_dim=spec["input_dim"], seed=0, device="cpu")
    trainer = FineTuneTrainer(probe, TrainingParams(**spec["training"]), metrics=spec["metrics"],
                              mesh=make_mesh(device="cpu"))
    batches = [rows(b, rank, world) for b in spec["batches"]]
    result = trainer.train(batches, [rows(b, rank, world) for b in spec["batches"]])
    return {"params": _np(dict(probe.module.named_parameters())), "history": result["history"]}


def run_train_distributed(rank, world, spec, work):
    """``run_train`` with ``distributed=True`` in the running process group:
    the rank's loader shard, the data-parallel epoch and rank 0's files."""
    from avex_tpu_torch import run_train
    from avex_tpu_torch.configs import RunConfig
    from avex_tpu_torch.data import build_dataloaders

    config = RunConfig.from_dict(dict(spec["config"], output_dir=str(work / f"run_rank{rank}")))
    train_loader = build_dataloaders(config)[0]
    result = run_train.main(config)
    files = sorted(p.name for p in (work / f"run_rank{rank}").iterdir())
    return {"train_indices": [chunk.tolist() for chunk in train_loader._chunks()], "files": files,
            "loss": result["history"][-1]["train"]["loss"], "final": result["final_checkpoint"]}


def run_evaluate_distributed(rank, world, spec, work):
    """``run_evaluate`` in the running process group, every rank on one save
    directory: extraction into the caches under the mesh (rank 0 writes, the
    others read them), an offline probe and retrieval."""
    from avex_tpu_torch import run_evaluate
    from avex_tpu_torch.configs import EvaluateConfig

    config = EvaluateConfig.from_sources(spec["yaml"], [f"save_dir={work / 'evaluate'}", *spec["patches"]])
    return [result["metrics"] for result in run_evaluate.main(config)]


SCENARIOS = {f.__name__: f for f in (supervised_beats_dp, supervised_beats_fsdp, efficientnet_batchnorm,
                                      clip_global_batch, clip_model_axis, eat_ssl_step, extraction, metrics_mean,
                                      finetune, run_train_distributed, run_evaluate_distributed)}
