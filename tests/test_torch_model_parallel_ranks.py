"""What each rank runs in the four-process tests of the port's model axis.

``tests/test_torch_model_parallel.py`` and
``tests/test_torch_pipeline_parallel.py`` write the inputs (JAX's weights
carried across, the global batch) into a work directory, ``inputs.pkl``
and then ``inputs_late.pkl``, and start a
:class:`~tests.test_torch_parallel_ranks.RankGroup` of four spawned gloo
ranks on the CPU running :func:`rank_main`: a 2x2 (data, model) mesh, rank
``r`` at ``(r // 2, r % 2)``. Every rank runs every scenario named in the
inputs and pickles what the test holds against JAX. This module imports
torch and the port only, so a rank starts without JAX.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from tests.test_torch_parallel_ranks import _np, _rank_main, rows, run_train_distributed

WORLD = 4


def rank_main(rank: int, world: int, work: str) -> None:
    _rank_main(rank, world, work, SCENARIOS)


def _config(spec: Dict[str, Any], work: Path, name: str, rank: int):
    from avex_tpu_torch.configs import MeshConfig, ModelSpec, RunConfig, SchedulerConfig, TrainingParams

    return RunConfig(
        model_spec=ModelSpec(**spec["model_spec"], device="cpu"),
        training_params=TrainingParams(**spec["training"]), output_dir=str(work / f"{name}_rank{rank}"),
        scheduler=SchedulerConfig(name="cosine", warmup_steps=0), seed=0, device="cpu",
        mesh=MeshConfig(**spec["mesh"]),
    )


def trainer_step(rank, world, spec, work, name="step"):
    """One ``Trainer`` step on the rank's data row's share of the global
    batch, in the layout ``spec["mesh"]`` asks for: the loss, every parameter
    and the first moment after it, whole; the layout's placement; with
    ``checkpoint``, the checkpoint rank 0 wrote."""
    from avex_tpu_torch.models.factory import build_model_from_spec
    from avex_tpu_torch.parallel.tensor import TensorParallelLayout
    from avex_tpu_torch.training import Trainer

    config = _config(spec, work, name, rank)
    model = build_model_from_spec(config.model_spec, num_classes=spec["num_classes"])
    model.load_port_state_dict(spec["state"], strict=True)
    trainer = Trainer(model, config, [], steps_per_epoch=4)
    mesh = trainer.mesh
    loss, metrics = trainer._train_step(rows(spec["batch"], mesh.rank, mesh.size))
    saved = trainer._save_kwargs()
    layout = trainer._model_layout
    out = {"loss": loss.item(), "count": metrics["count"], "coords": (mesh.rank, mesh.model_rank),
           "params": _np(saved["params"]), "mu": _np(saved["opt_state"]["mu"]),
           "held_bytes": sum(p.numel() for p in model.module.parameters())}
    if isinstance(layout, TensorParallelLayout):
        out["cut"], out["partial"] = dict(layout.cut), sorted(layout.partial)
    elif layout is not None:
        out["owner"] = dict(layout.owner)
    if trainer._layout is not None:
        out["fsdp_axis"] = {n: a for n, a in trainer._layout.axis.items() if a is not None}
    if spec.get("checkpoint"):
        out["checkpoint"] = trainer.checkpoints.save_final(epoch=1, best_val_acc=0.0, **saved)
        out["written"] = (Path(out["checkpoint"]) / "checkpoint.pt").exists()
    return out


def refusals(rank, world, spec, work):
    """JAX's errors, raised alike on every rank: each case's message."""
    from avex_tpu_torch.models.factory import build_model_from_spec
    from avex_tpu_torch.parallel import make_mesh
    from avex_tpu_torch.parallel.pipeline import pipeline_apply, shard_pipeline_params
    from avex_tpu_torch.training import Trainer

    messages = {}

    def expect(label, fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as err:
            messages[label] = f"{type(err).__name__}: {err}"
        else:
            messages[label] = None

    def trainer(case):
        config = _config(case, work, "refusal", rank)
        model = build_model_from_spec(config.model_spec, num_classes=4)
        Trainer(model, config, [], steps_per_epoch=4)

    for label, case in spec["trainer_cases"].items():
        expect(label, lambda case=case: trainer(case))
    mesh = make_mesh(2, 2, device="cpu")
    layers = [torch.nn.Linear(4, 4) for _ in range(3)]
    expect("layers_per_stage", lambda: pipeline_apply(lambda l, h: l(h), layers, torch.zeros(4, 4), mesh=mesh))
    expect("microbatches", lambda: pipeline_apply(lambda l, h: l(h), layers[:2], torch.zeros(3, 4), mesh=mesh))
    expect("shape", lambda: pipeline_apply(lambda l, h: h[:, :2], layers[:2], torch.zeros(4, 4), mesh=mesh))
    expect("tp_axis", lambda: shard_pipeline_params(torch.nn.Sequential(), mesh, tp_axis="model"))
    # runner-driven stacks are deterministic only
    model = build_model_from_spec(_config(spec["dropout_case"], work, "dropout", rank).model_spec, num_classes=4)
    model.enable_sequence_parallel(mesh)
    wav = torch.zeros(2, 16000)
    expect("runner_dropout", lambda: model.module(wav, deterministic=False, generator=torch.Generator()))
    expect("runner_layerdrop", lambda: model.module(wav, deterministic=False, disable_layerdrop=False,
                                                     generator=torch.Generator()))
    # EAT's 1 + 32 tokens do not divide over two ranks: they run cut unevenly
    model = build_model_from_spec(_config(spec["sequence_case"], work, "sequence", rank).model_spec, num_classes=4)
    model.enable_sequence_parallel(mesh)
    expect("sequence_length", lambda: model.module(wav))
    return {"messages": messages, "coords": (mesh.rank, mesh.model_rank), "groups": _groups(mesh)}


def collective_forms(rank, world, spec, work):
    """The ring shift, the gather and the reduce-scatter over the model axis
    in both of ``parallel``'s forms: gloo's (written from ``all_reduce``) and
    the one NCCL runs (``batch_isend_irecv``, ``all_gather_into_tensor``,
    ``reduce_scatter_tensor``), here on gloo's CPU tensors."""
    import avex_tpu_torch.parallel as par

    mesh = par.make_mesh(2, 2, device="cpu").model_axis
    x = torch.arange(6.0).reshape(2, 3) + 10 * rank
    out = {}
    real = par._gloo
    for form, use_gloo in (("gloo", True), ("nccl", False)):
        par._gloo = lambda mesh, tensor=None, use_gloo=use_gloo: use_gloo
        try:
            gathered = par.all_gather_into(x.new_empty((4, 3)), x, mesh)  # the ranks' rows, concatenated
            scattered = par.reduce_scatter_into(x.new_empty((1, 3)), x, mesh)  # this rank's row of the sum
            out[form] = {"next": par.ring_shift(x, mesh, 1).numpy(), "back": par.ring_shift(x, mesh, -1).numpy(),
                         "gather": gathered.numpy().reshape(2, 2, 3).copy(), "scatter": scattered.numpy().copy()}
        finally:
            par._gloo = real
    return out


def _groups(mesh) -> Dict[str, Any]:
    """The global ranks of this rank's data column and model row."""
    import torch.distributed as dist

    def members(group):
        return None if group is None else sorted(dist.get_process_group_ranks(group))

    return {"data": members(mesh.group), "model": members(mesh.model_group)}


def pipeline_step(rank, world, spec, work):
    return trainer_step(rank, world, spec, work, name=f"pipeline_m{spec['mesh']['pipeline_microbatches']}")


SCENARIOS = {
    **{name: trainer_step for name in ("dp_tp", "fsdp_tp", "sp_tp", "tp_eat", "tp_aves")},
    **{f"pipeline_{m}_{k}": pipeline_step for m in ("beats", "eat", "aves") for k in (2, 4)},
    "refusals": refusals,
    "collective_forms": collective_forms,
    "run_train_model_axis": run_train_distributed,
}


def hold_equal_ranks(results, name, keys=("params", "mu")) -> None:
    """Every rank ends the step with the same whole tensors."""
    for r in results[1:]:
        for key in keys:
            for n, v in results[0][name][key].items():
                np.testing.assert_array_equal(r[name][key][n], v, err_msg=f"{name} {key} {n}")
