"""What each rank runs in the four-process tests of the rest of the model axis.

``tests/test_torch_ring_attention.py`` and
``tests/test_torch_expert_parallel.py`` each write their inputs (JAX's
weights carried across, the global arrays) into a work directory and start
one :class:`~tests.test_torch_parallel_ranks.RankGroup` of four spawned gloo
ranks on the CPU running :func:`rank_main`; every rank runs every scenario
named in the inputs, building the meshes the scenario asks for (2x2, 1x4,
the 3-D 1x2x2), and pickles what the test holds against JAX. This module
imports torch and the port only, so a rank starts without JAX.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict

import numpy as np
import torch

from tests.test_torch_model_parallel_ranks import trainer_step
from tests.test_torch_parallel_ranks import _np, _rank_main, rows

WORLD = 4


def rank_main(rank: int, world: int, work: str) -> None:
    _rank_main(rank, world, work, SCENARIOS)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _message(fn) -> str:
    try:
        fn()
    except ValueError as err:
        return str(err)
    return ""


def ring_op(rank, world, spec, work):
    """``ring_attention`` over the model axis of a 2x2 mesh (ring 2, each data
    row on its half of the batch) and of a 1x4 mesh (ring 4): the output and
    the gradients of ``Σ out · cot`` with respect to q, k, v, the bias and
    the gate, on the rank's rows; JAX's errors."""
    from avex_tpu_torch.ops.ring_attention import ring_attention
    from avex_tpu_torch.parallel import make_mesh

    out: Dict[str, Any] = {}
    for data, model in ((2, 2), (1, 4)):
        mesh = make_mesh(data, model, device="cpu")
        mine = {k: rows(v, mesh.rank, mesh.size) if k != "bias" else v for k, v in spec["arrays"].items()}
        inputs = [_t(mine[k]).requires_grad_() for k in ("q", "k", "v", "bias", "gate")]
        got = ring_attention(*inputs[:4], mesh=mesh, gate=inputs[4], key_padding_mask=_t(mine["mask"]))
        grads = torch.autograd.grad((got * _t(mine["cot"])).sum(), inputs)
        plain = ring_attention(*inputs[:3], mesh=mesh)  # no bias, gate or mask
        out[f"ring{model}"] = {"coords": (mesh.rank, mesh.model_rank), "out": got.detach().numpy(),
                               "plain": plain.detach().numpy(),
                               "grads": dict(zip(("q", "k", "v", "bias", "gate"), (g.numpy() for g in grads)))}
        if model == 4:
            q = inputs[0].detach()
            out["errors"] = {
                "divisible": _message(lambda: ring_attention(q[:, :, :30], q[:, :, :30], q[:, :, :30], mesh=mesh)),
                "trailing": _message(lambda: ring_attention(q, q, q, torch.zeros(1, q.shape[1], 1, q.shape[2]),
                                                            mesh=mesh)),
                "gate": _message(lambda: ring_attention(q, q, q, mesh=mesh, gate=torch.ones(q.shape[:3] + (1,)))),
            }
    return out


def ring_models(rank, world, spec, work):
    """Each model's features with ``enable_ring_attention`` over a 1x4 mesh,
    on JAX's weights; the gradients of ``Σ features · cot`` with respect to
    every parameter, with the ring and without it (one process)."""
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models.factory import build_model_from_spec
    from avex_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, 4, device="cpu")
    out = {}
    for name, case in spec.items():
        args = [_t(case["wav"])] + ([_t(case["mask"])] if case.get("mask") is not None else [])
        result = {}
        for label, ring in (("ring", mesh), ("alone", None)):
            model = build_model_from_spec(ModelSpec(**case["model_spec"], device="cpu"),
                                          num_classes=case["num_classes"])
            model.load_port_state_dict(case["state"], strict=True)
            if ring is not None:
                model.enable_ring_attention(ring)
            params = dict(model.module.named_parameters())
            features = model.module(*args)[1]["features"]
            cot = torch.randn(features.shape, generator=torch.Generator().manual_seed(11))
            grads = torch.autograd.grad((features * cot).sum(), list(params.values()), allow_unused=True)
            result[f"{label}_grads"] = {n: g.numpy() for n, g in zip(params, grads) if g is not None}
            if ring is not None:
                result["features"] = features.detach().numpy()
        out[name] = result
    return out


def moe_expert_parallel(rank, world, spec, work):
    """Cell 8: the MoE probe's ``FineTuneTrainer`` run on a 2x2 mesh, its
    experts over the model axis: the epochs' losses, the tensors cut and what
    a rank held of them while training, and the whole parameters after."""
    from avex_tpu_torch.configs import TrainingParams
    from avex_tpu_torch.evaluation.finetune import FineTuneTrainer
    from avex_tpu_torch.parallel import make_mesh
    from avex_tpu_torch.probes import build_probe_from_config

    mesh = make_mesh(2, 2, device="cpu")
    probe = build_probe_from_config(spec["probe"], num_classes=spec["num_classes"], input_dim=spec["input_dim"],
                                    seed=0, device="cpu")
    probe.module.load_state_dict({k: torch.tensor(v) for k, v in spec["state"].items()}, strict=True)
    trainer = FineTuneTrainer(probe, TrainingParams(**spec["training"]), mesh=mesh, seed=0)
    cut = dict(trainer._experts.cut)
    held = {n: tuple(p.shape) for n, p in probe.module.named_parameters()}
    result = trainer.train([rows(b, mesh.rank, mesh.size) for b in spec["batches"]])
    return {"coords": (mesh.rank, mesh.model_rank), "cut": cut, "held": held,
            "losses": [h["train_loss"] for h in result["history"]],
            "params": _np(dict(probe.module.named_parameters()))}


def three_d(rank, world, spec, work):
    """Cell 9: BEATs' stacked encoder pipelined over ``model`` (GPipe, M=2)
    with each stage's products cut over ``tp`` on a 1x2x2 mesh; one SGD step
    of ``mean(features²)``: the loss before and after it."""
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models.factory import build_model_from_spec
    from avex_tpu_torch.parallel import make_mesh
    from avex_tpu_torch.parallel.pipeline import shard_pipeline_params

    mesh = make_mesh(1, 2, tp=2, device="cpu")
    model = build_model_from_spec(ModelSpec(**spec["model_spec"], device="cpu"), return_features_only=True)
    model.load_port_state_dict(spec["state"], strict=True)
    model.enable_pipeline(mesh, spec["microbatches"])
    layout = shard_pipeline_params(model.module, mesh, tp_axis="tp")
    params = dict(model.module.named_parameters())
    wav = _t(spec["wav"])

    def loss_fn():
        return model.module.backbone(wav)[0].float().square().mean()

    loss0 = loss_fn()
    grads = torch.autograd.grad(loss0, list(params.values()), allow_unused=True)
    grads = {n: g if g is not None else torch.zeros_like(p) for (n, p), g in zip(params.items(), grads)}
    grads = layout.reduce_gradients(grads)
    with torch.no_grad():
        for n, p in params.items():
            p -= spec["lr"] * grads[n]
        loss1 = loss_fn()
    held = sum(p.numel() for p in params.values())
    whole = layout.gather_tensors({n: p.data for n, p in params.items()})  # a collective: every rank
    return {"coords": (mesh.rank, mesh.model_rank, mesh.tp_rank), "losses": (loss0.item(), loss1.item()),
            "tp_cut": sorted(layout.cut), "stage_owned": len(layout.owner), "held": held,
            "params": _np(whole) if rank == 0 else None}


SCENARIOS = {
    "ring_op": ring_op,
    "ring_models": ring_models,
    "moe_expert_parallel": moe_expert_parallel,
    "three_d": three_d,
    **{name: partial(trainer_step, name=name) for name in ("birdmae_pipeline", "birdmae_sp")},
}
