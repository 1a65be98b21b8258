"""The port's model axis on four gloo processes on the CPU, against JAX's 2x2 cells.

JAX gets tensor and sequence parallelism from GSPMD: its cells of
``__graft_entry__.dryrun_multichip`` run one ``Trainer`` step on a 2x2
(data, model) mesh of its 8-device CPU platform, here with the tensors
``_tp_shard_params`` places. Sharding changes no value, so each layout's
oracle is JAX's one-device step on the same weights and batch: the port's
loss is held to both, its gradients and parameters to the one-device
step. (JAX's 2x2 steps give BEATs' grouped ``pos_conv`` weight exactly
twice its gradient, on a replicated layout too, and the clipping norm
follows; its 2x1 and 1x2 steps do not. The dry run holds the loss only.
ROADMAP queue 3.) The port writes the collectives out over a 2x2 mesh of
four processes (``tests/test_torch_model_parallel_ranks.py``, one spawned
group for the file, started before JAX's side runs here):

- cell 1, data x tensor parallelism (tiny BEATs, split q/k/v);
- cell 2, ZeRO-3 x tensor parallelism (a tensor cut over both axes);
- cell 7, Megatron-SP with tensor parallelism (BEATs ``scan_layers`` with
  ``fused_qkv`` on the K2/K3 twins: each rank takes its heads' rows of the
  whole ``qkv_proj``), as ``sequence_parallel`` builds it;
- tensor parallelism of EAT's MLP and AVES's attention (CLIP's
  projections: ``tests/test_torch_parallel_training.py``);
- the loss, every gradient tensor and every parameter after one update at
  the full rate, the 2-D group layout, the set of cut tensors against
  ``_tp_shard_params``'s, JAX's errors, and cell 1's checkpoint restored in
  one process.

Each data row's two ranks share its half of the global batch; JAX's loss
is the mean over the global batch. Tolerances are those of the
single-process ``Trainer`` tests (fp32 on both sides).
"""

import pickle

import numpy as np
import pytest
import torch

import jax

import avex_tpu
from __graft_entry__ import _tp_shard_params
from avex_tpu.configs import DatasetCollectionConfig, DatasetConfig
from avex_tpu.configs import MeshConfig as JaxMeshConfig
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import RunConfig as JaxRunConfig
from avex_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from avex_tpu.configs import TrainingParams as JaxTrainingParams
from avex_tpu.models.beats import BEATsConfig as JaxBEATsConfig
from avex_tpu.models.beats import convert_beats_state_dict as jax_convert_beats
from avex_tpu.parallel import make_mesh as jax_make_mesh
from avex_tpu.parallel import shard_batch
from avex_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from avex_tpu.training import Trainer as JaxTrainer

import avex_tpu_torch
from avex_tpu_torch.configs import MeshConfig, ModelSpec, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.models import aves, beats, eat
from avex_tpu_torch.parallel.tensor import tp_sharding
from avex_tpu_torch.training import Trainer
from tests.test_torch_beats import FP32_TOL
from tests.test_torch_eat_ssl import hold_adam_step
from tests.test_torch_efficientnet import _tree
from tests.test_torch_model_parallel_ranks import WORLD, hold_equal_ranks, rank_main
from tests.test_torch_parallel_training import _run_train_config
from tests.test_torch_parallel_ranks import RankGroup
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

LOSS_REL = 1e-5
NUM_CLASSES = 4
BATCH = 8  # the global batch: 4 clips a data row
BEATS = {  # the dry run's widths (__graft_entry__._supervised_config), 4 layers, dropout 0
    "encoder_layers": 4, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 128, "encoder_attention_heads": 4,
    "embed_dim": 32, "dropout": 0.0, "attention_dropout": 0.0, "encoder_layerdrop": 0.0,
}
EAT = {"depth": 2, "dim": 64, "heads": 4, "target_length": 64}
AVES = {"aves_cfg": {"encoder_num_layers": 2, "encoder_embed_dim": 64, "encoder_num_heads": 4,
                     "encoder_ff_interm_features": 128, "encoder_dropout": 0.0, "encoder_attention_dropout": 0.0,
                     "encoder_ff_interm_dropout": 0.0, "encoder_projection_dropout": 0.0,
                     "encoder_layer_drop": 0.0}}
RAW_AUDIO = {"representation": "raw", "normalize": False, "target_length_seconds": 1, "window_selection": "random"}
# the tiny BEATs' global gradient norm is ~13 at this batch: a clip at 1 scales it
TRAINING = dict(train_epochs=1, lr=1e-3, batch_size=BATCH, optimizer="adamw", weight_decay=0.01, log_steps=100,
                gradient_clip_val=1.0)
TP = {"data": 2, "model": 2}


def _batch():
    rng = np.random.default_rng(11)
    return {"raw_wav": (rng.standard_normal((BATCH, 16000)) * 0.1).astype(np.float32),
            "label": np.eye(NUM_CLASSES, dtype=np.float32)[rng.integers(0, NUM_CLASSES, BATCH)]}


def _jax_spec(name, init):
    return JaxModelSpec(name=name, pretrained=False, init_config=init, audio_config=RAW_AUDIO)


def _jax_config(name, init, tmp, **mesh):
    return JaxRunConfig(
        model_spec=_jax_spec(name, init), training_params=JaxTrainingParams(**TRAINING),
        dataset_config=DatasetCollectionConfig(
            train_datasets=[DatasetConfig(name="d", kind="synthetic", num_samples=BATCH, num_classes=NUM_CLASSES)]),
        output_dir=str(tmp), scheduler=JaxSchedulerConfig(name="cosine", warmup_steps=0), seed=0,
        mesh=JaxMeshConfig(**mesh),
    )


def jax_cell(name, init, tmp, convert, tp=False, variables=None, built=None, **mesh):
    """One JAX ``Trainer`` step on a ``data`` x ``model`` mesh of the CPU
    platform (the tensors ``_tp_shard_params`` places with ``tp``; the
    model's weights replaced by ``variables``; ``built``, the model already
    built): the initial weights, the loss, the parameters after it and the
    gradient it applied (Adam's first moment / (1 - b1)), in the port's
    names, and the names of the tensors placed over each mesh axis."""
    config = _jax_config(name, init, tmp, **mesh)
    model = built or avex_tpu.build_model_from_spec(config.model_spec, num_classes=NUM_CLASSES)
    if variables is not None:
        model.variables = variables
    initial = convert(jax.tree_util.tree_map(np.asarray, model.variables["params"]))
    jax_mesh = jax_make_mesh(data=mesh["data"], model=mesh["model"], devices=jax.devices()[:mesh["data"] * mesh["model"]])
    trainer = JaxTrainer(model, config, [], mesh=jax_mesh, steps_per_epoch=4)
    if tp:
        trainer.state = trainer.state.replace(params=_tp_shard_params(trainer.state.params, jax_mesh, 2))
    placed = {axis: _axis_names(trainer.state.params, axis, convert) for axis in ("data", "model")}
    trainer.state, loss, _ = trainer._train_step(trainer.state, shard_batch(_batch(), jax_mesh))
    adam = next(x for x in jax.tree_util.tree_leaves(trainer.state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu"))
    grads = convert(jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, jax.device_get(adam.mu)))
    return {"initial": initial, "loss": float(loss), "params": convert(_tree(trainer.state.params)), "grads": grads,
            "placed": placed}


def _axis_names(params, axis, convert):
    """The port's names of the tensors JAX placed over mesh axis ``axis``."""
    def mark(leaf):
        return np.full(leaf.shape, float(axis in str(getattr(leaf.sharding, "spec", ""))), np.float32)

    marks = jax.tree_util.tree_map(mark, params)
    return {k for k, v in convert(_tree(marks)).items() if v.size and v.min() == 1.0}


def _beats_convert(params):
    return beats.params_from_jax(params)


def _zero_gradient(key, value):
    """Entries whose exact gradient is 0: the key projection's bias (the
    middle third of a fused qkv bias), which a softmax cannot see."""
    noise = np.zeros(value.shape, bool)
    if key.endswith("k_proj.bias"):
        noise[:] = True
    elif key.endswith(("qkv_proj.bias", "attn.qkv.bias")):
        noise[value.shape[0] // 3:2 * value.shape[0] // 3] = True
    return noise


def hold_step(results, name, want_loss, want_params, want_grads, before):
    """The loss (the mean of the data rows'), every gradient tensor and every
    parameter after the step against the reference step's; the ranks equal."""
    rows = [r[name] for r in results]
    assert [r["coords"] for r in rows] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert rows[0]["loss"] == rows[1]["loss"] and rows[2]["loss"] == rows[3]["loss"]
    got_loss = (rows[0]["loss"] + rows[2]["loss"]) / 2
    assert abs(got_loss - want_loss) <= LOSS_REL * abs(want_loss), (got_loss, want_loss)
    hold_equal_ranks(results, name)
    got = rows[0]
    assert set(got["mu"]) == set(want_grads)
    for key, value in want_grads.items():
        grad, noise = got["mu"][key] / np.float32(0.1), _zero_gradient(key, value)
        np.testing.assert_allclose(grad[~noise], value[~noise], err_msg=key, **FP32_TOL)
    # every tensor with an entry whose gradient is not 0 moved (a step at lr 0 would move none)
    still = [k for k, v in want_grads.items() if (~_zero_gradient(k, v)).any()
             and np.array_equal(got["params"][k], before[k])]
    assert not still, still
    for key, value in want_params.items():
        hold_adam_step(got["params"][key], value, key, got["mu"][key] / np.float32(0.1), want_grads[key],
                       TRAINING["lr"])


def _jax_model(name, init, convert):
    """A JAX model (its seeded weights) and a copy of those weights in the port's names."""
    model = avex_tpu.build_model_from_spec(_jax_spec(name, init), num_classes=NUM_CLASSES)
    return model, convert(jax.tree_util.tree_map(np.array, model.variables["params"]))


def _spec(name, init, state, mesh, **extra):
    return dict(model_spec=dict(name=name, pretrained=False, init_config=init, audio_config=RAW_AUDIO),
                training=TRAINING, mesh=mesh, num_classes=NUM_CLASSES, state=state, batch=_batch(), **extra)


def _dump(inputs, path):
    with open(path.with_suffix(".tmp"), "wb") as f:
        pickle.dump(inputs, f)
    path.with_suffix(".tmp").rename(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's cells and the rank group: the ranks start on what needs no
    weights (the refusals, ``run_train``, the collectives) while JAX builds
    its models; their weights follow in ``inputs_late.pkl``, and JAX's steps
    run while the ranks take theirs."""
    work = tmp_path_factory.mktemp("model_axis")
    early = {
        "refusals": {
            "trainer_cases": {
                "pipeline_with_sp": _spec("beats", dict(BEATS, scan_layers=True), None,
                                          dict(TP, pipeline_microbatches=2, sequence_parallel=True)),
                "pipeline_with_fsdp": _spec("beats", dict(BEATS, scan_layers=True), None,
                                            dict(TP, pipeline_microbatches=2, param_sharding="fsdp")),
                "pipeline_unstacked": _spec("beats", BEATS, None, dict(TP, pipeline_microbatches=2)),
                "sequence_unstacked": _spec("beats", BEATS, None, dict(TP, sequence_parallel=True)),
                "no_enable_pipeline": dict(_spec("efficientnet", {}, None, dict(TP, pipeline_microbatches=2)),
                                           model_spec=dict(name="efficientnet", pretrained=False,
                                                           efficientnet_variant="b0")),
            },
            "dropout_case": _spec("beats", dict(BEATS, scan_layers=True, dropout=0.1, encoder_layerdrop=0.1), None,
                                  TP),
            "sequence_case": _spec("eat_hf", dict(EAT, scan_layers=True), None, TP),
        },
        "run_train_model_axis": {"config": dict(_run_train_config(), mesh={"model": 2})},
        "collective_forms": {},
    }
    _dump(early, work / "inputs.pkl")
    group = RankGroup(work, world=WORLD, timeout=240.0, main=rank_main)

    jax_beats, weights = _jax_model("beats", BEATS, _beats_convert)
    jax_eat, eat_state = _jax_model("eat_hf", EAT, eat.params_from_jax)
    jax_aves, aves_state = _jax_model("aves_bio", AVES, aves.params_from_jax)
    fused = dict(BEATS, scan_layers=True, fused_qkv=True)
    late = {
        "dp_tp": _spec("beats", BEATS, weights, TP, checkpoint=True),
        "fsdp_tp": _spec("beats", BEATS, weights, dict(TP, param_sharding="fsdp", fsdp_min_size=1024)),
        "sp_tp": _spec("beats", dict(fused, use_pallas=True), beats._concat_qkv(weights),
                       dict(TP, sequence_parallel=True)),
        "tp_eat": _spec("eat_hf", EAT, eat_state, TP),
        "tp_aves": _spec("aves_bio", AVES, aves_state, TP),
    }
    _dump(late, work / "inputs_late.pkl")  # the ranks' steps run while JAX's below do

    one = {"data": 1, "model": 1}
    oracle = jax_cell("beats", BEATS, work / "jax_one", _beats_convert, built=jax_beats, **one)
    alone = {
        "tp_eat": jax_cell("eat_hf", EAT, work / "jax_eat", eat.params_from_jax, built=jax_eat, **one),
        "tp_aves": jax_cell("aves_bio", AVES, work / "jax_aves", aves.params_from_jax, built=jax_aves, **one),
    }
    stacked = jax_convert_beats(reference_state(weights), JaxBEATsConfig(**fused), num_classes=NUM_CLASSES,
                                scan_layers=True)
    cells = {
        "dp_tp": jax_cell("beats", BEATS, work / "jax1", _beats_convert, tp=True,
                          variables={"params": _jax_tree(weights)}, **TP),
        "fsdp_tp": jax_cell("beats", BEATS, work / "jax2", _beats_convert, tp=True, param_sharding="fsdp",
                            fsdp_min_size=1024, variables={"params": _jax_tree(weights)}, **TP),
        "sp_tp": jax_cell("beats", fused, work / "jax7", _beats_convert, tp=True, sequence_parallel=True,
                          variables=stacked, **TP),
    }
    return {"group": group, "work": work, "cells": cells, "oracle": oracle, "alone": alone, "early": early,
            "late": late}


def reference_state(state):
    """The port's BEATs state dict in the reference checkpoint's names (the
    port's, the shared relative-position table as layer 0's)."""
    table = "backbone.encoder.relative_attention_bias.weight"
    out = {k: v for k, v in state.items() if k != table}
    out["backbone.encoder.layers.0.self_attn.relative_attention_bias.weight"] = state[table]
    return out


def _jax_tree(state):
    """The port's per-layer BEATs state dict → JAX's parameter tree."""
    return jax_convert_beats(reference_state(state), JaxBEATsConfig(**BEATS), num_classes=NUM_CLASSES,
                             scan_layers=False)["params"]


def _results(ranks):
    return ranks["group"].results()


def test_mesh_groups_and_the_cut_set_match_jax(ranks):
    """Rank r at (r // 2, r % 2) with its data column's and model row's
    groups; the tensors cut over the model axis are ``_tp_shard_params``'s."""
    results = _results(ranks)
    assert [r["refusals"]["coords"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["refusals"]["groups"] for r in results] == [
        {"data": [0, 2], "model": [0, 1]}, {"data": [1, 3], "model": [0, 1]},
        {"data": [0, 2], "model": [2, 3]}, {"data": [1, 3], "model": [2, 3]}]
    for name, cell in ranks["cells"].items():
        if name == "sp_tp":  # the stacked layout: JAX's rule also takes the stacked biases (2-D there)
            continue
        want = cell["placed"]["model"]
        assert want and set(results[0][name]["cut"]) == want, name
        if name == "fsdp_tp":  # a tensor cut over both axes: the data axis on its other dimension
            both = cell["placed"]["data"] & want
            got = results[0][name]["fsdp_axis"]
            assert both and {k for k in got if k in want} == both
            assert all(got[k] == 1 - results[0][name]["cut"][k] for k in both)


def test_tp_cut_sets_of_eat_and_aves_match_jax():
    """The port's rule (``tp_sharding``) against ``_tp_shard_params`` on
    EAT's and AVES's per-layer trees: EAT's ``fc1``/``fc2``, AVES's
    ``q/k/v/out_proj``."""
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    for name, init, convert in (("eat_hf", EAT, eat.params_from_jax), ("aves_bio", AVES, aves.params_from_jax)):
        model = avex_tpu.build_model_from_spec(_jax_spec(name, init), num_classes=NUM_CLASSES)
        placed = _tp_shard_params(model.variables["params"], mesh, 2)
        marks = jax.tree_util.tree_map(
            lambda leaf: np.full(leaf.shape, float("model" in str(getattr(leaf.sharding, "spec", ""))), np.float32),
            placed)
        want = {k for k, v in convert(_tree(marks)).items() if v.size and v.min() == 1.0}
        port = avex_tpu_torch.build_model_from_spec(
            ModelSpec(name=name, pretrained=False, init_config=init, audio_config=RAW_AUDIO, device="cpu"),
            num_classes=NUM_CLASSES)
        got = {n for n, p in port.module.named_parameters() if tp_sharding(n, tuple(p.shape), 2) is not None}
        assert want and got == want, (name, got ^ want)


@pytest.mark.parametrize("cell", ["dp_tp", "fsdp_tp", "sp_tp"])
def test_beats_model_axis_step_matches_jax(ranks, cell):
    """Cells 1, 2 and 7: the step on the port's 2x2 mesh against JAX's one-device
    step (its 2x2 cell's loss too; cell 7 on the same weights, ``qkv_proj``
    the concatenation of the three projections)."""
    want = ranks["oracle"]
    params, grads, before = want["params"], want["grads"], want["initial"]
    if cell == "sp_tp":
        params, grads, before = (beats._concat_qkv(t) for t in (params, grads, before))
    assert abs(ranks["cells"][cell]["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    hold_step(_results(ranks), cell, want["loss"], params, grads, before)
    if cell == "fsdp_tp":  # the tensors cut over both axes hold a quarter of their elements on a rank
        assert _results(ranks)[0]["fsdp_tp"]["held_bytes"] < _results(ranks)[0]["dp_tp"]["held_bytes"]


@pytest.mark.parametrize("name", ["tp_eat", "tp_aves"])
def test_eat_and_aves_tensor_parallel_step_matches_one_process(ranks, name):
    """EAT's MLP and AVES's attention cut over the model axis against the
    one-process step: JAX's one-device step on the same weights and global
    batch."""
    want = ranks["alone"][name]
    results = _results(ranks)
    assert results[0][name]["cut"] and results[0][name]["partial"]
    hold_step(results, name, want["loss"], want["params"], want["grads"], want["initial"])


def test_checkpoint_of_a_2x2_step_restores_in_one_process(ranks, tmp_path):
    """Rank 0 wrote whole tensors (the ranks' blocks gathered); one process
    restores them, optimizer moments included, and trains on."""
    results = _results(ranks)
    first = results[0]["dp_tp"]
    assert first["written"] and not any(r["dp_tp"]["written"] for r in results[1:])
    spec = ranks["late"]["dp_tp"]
    config = RunConfig(
        model_spec=ModelSpec(**spec["model_spec"], device="cpu"), training_params=TrainingParams(**TRAINING),
        output_dir=str(tmp_path / "restored"), scheduler=SchedulerConfig(name="cosine", warmup_steps=0), seed=0,
        device="cpu", mesh=MeshConfig(), resume_from_checkpoint=first["checkpoint"])
    model = avex_tpu_torch.build_model_from_spec(config.model_spec, num_classes=NUM_CLASSES, seed=5)
    trainer = Trainer(model, config, [], steps_per_epoch=4)
    assert trainer.mesh.size == 1 and trainer.state.step == 1
    for key, value in model.module.named_parameters():
        np.testing.assert_array_equal(value.detach().numpy(), first["params"][key], err_msg=key)
    for key, value in trainer.state.opt_state["mu"].items():
        np.testing.assert_array_equal(value.numpy(), first["mu"][key], err_msg=key)
    loss, _ = trainer._train_step(_batch())
    assert np.isfinite(loss.item())


def _jax_error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as err:
        return str(err)
    return None


def test_run_train_takes_a_model_axis(ranks):
    """``run_train`` with ``distributed=True`` and ``mesh: {model: 2}``: the two
    ranks of a data row read the same shard (the loader shards over the data
    axis), the epoch runs tensor-parallel, and rank 0 alone writes whole
    tensors."""
    results = [r["run_train_model_axis"] for r in _results(ranks)]
    assert results[0]["train_indices"] == results[1]["train_indices"] != results[2]["train_indices"]
    assert results[2]["train_indices"] == results[3]["train_indices"]
    assert {"final_model", "label_map.json"} <= set(results[0]["files"])
    assert all(r["files"] == [] for r in results[1:])
    assert len({r["loss"] for r in results}) == 1  # the epoch's metrics, averaged over the data axis
    saved = torch.load(results[0]["final"] + "/checkpoint.pt", weights_only=True)["params"]
    assert tuple(saved["backbone.encoder.layers.0.fc1.weight"].shape) == (BEATS["encoder_ffn_embed_dim"],
                                                                         BEATS["encoder_embed_dim"])
    assert all(torch.isfinite(t).all() for t in saved.values())


def test_ring_shift_and_gather_in_both_forms(ranks):
    """Over a model row of two ranks, the ring shift hands each rank its
    neighbour's tensor, the gather stacks the row's and the reduce-scatter
    gives each its block of their sum, in gloo's form and in NCCL's
    (``batch_isend_irecv``, ``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, run on gloo's CPU tensors here: the card's
    NCCL needs a card a rank)."""
    results = [r["collective_forms"] for r in _results(ranks)]
    base = np.arange(6.0).reshape(2, 3)
    for rank, r in enumerate(results):
        row, column = divmod(rank, 2)
        other = row * 2 + 1 - column
        for form in ("gloo", "nccl"):
            np.testing.assert_array_equal(r[form]["next"], base + 10 * other, err_msg=form)
            np.testing.assert_array_equal(r[form]["back"], base + 10 * other, err_msg=form)
            row_x = np.stack([base + 10 * (row * 2), base + 10 * (row * 2 + 1)])
            np.testing.assert_array_equal(r[form]["gather"], row_x, err_msg=form)
            np.testing.assert_array_equal(r[form]["scatter"], row_x.sum(0)[column:column + 1], err_msg=form)


def test_refusals_are_jax_s(ranks, tmp_path):
    """The conflicts and errors JAX raises, raised alike by every rank: the
    pipeline with sequence parallelism or ZeRO-3, a runner without the
    stacked layout or on a model without the method, a stack that does not
    divide into stages or microbatches, a layer that changes the shape,
    dropout or LayerDrop under a runner; ``tp_axis`` naming the stages'
    axis. A sequence that does not divide over the axis runs, cut unevenly
    as GSPMD cuts it (EAT's 1 + 32 tokens here; its values are held in
    ``tests/test_torch_expert_parallel.py`` on Bird-MAE's)."""
    results = _results(ranks)
    messages = results[0]["refusals"]["messages"]
    for r in results:  # every rank raises; the stage whose layer changed the shape names the shapes
        theirs = r["refusals"]["messages"]
        assert {k: v for k, v in theirs.items() if k != "shape"} == {k: v for k, v in messages.items() if k != "shape"}
        assert theirs["shape"].startswith("ValueError: pipeline_apply: layer_fn must preserve activation shape")
    # the Trainer's conflicts: the port's message is JAX's
    cases = ranks["early"]["refusals"]["trainer_cases"]
    jax_mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    # one unstacked model serves every case: each raises before the model's layout matters, or for it
    jax_model = avex_tpu.build_model_from_spec(_jax_spec("beats", BEATS), num_classes=NUM_CLASSES)
    for label in ("pipeline_with_sp", "pipeline_with_fsdp", "pipeline_unstacked", "sequence_unstacked"):
        case = cases[label]
        jax_config = _jax_config("beats", case["model_spec"]["init_config"], tmp_path / label, **case["mesh"])
        want = _jax_error(lambda: JaxTrainer(jax_model, jax_config, [], mesh=jax_mesh, steps_per_epoch=4))
        assert want is not None and messages[label] == f"ValueError: {want}", (label, messages[label], want)
    assert "does not support pipeline parallelism" in messages["no_enable_pipeline"]
    # pipeline_apply's errors
    stack = {"w": np.zeros((3, 4, 4), np.float32)}
    want = _jax_error(lambda: jax_pipeline_apply(lambda p, h: h, stack, np.zeros((4, 4), np.float32), mesh=jax_mesh))
    assert messages["layers_per_stage"] == f"ValueError: {want}"
    stack = {"w": np.zeros((2, 4, 4), np.float32)}
    want = _jax_error(lambda: jax_pipeline_apply(lambda p, h: h, stack, np.zeros((6, 4), np.float32), mesh=jax_mesh))
    assert messages["microbatches"] == f"ValueError: {want}"
    assert "layer_fn must preserve activation shape" in messages["shape"]
    assert messages["tp_axis"].startswith("ValueError") and "another mesh axis" in messages["tp_axis"]
    assert "deterministic-only" in messages["runner_dropout"]
    assert "does not support layerdrop" in messages["runner_layerdrop"]
    assert messages["sequence_length"] is None


def test_sequence_gather_takes_t_from_the_runner():
    """A layer's time gather under sequence parallelism reads T from the
    runner's ``sequence_length`` context: a block of ceil(T/n) positions
    cannot tell an odd T from T + 1, so outside the context it raises
    before any collective runs."""
    from avex_tpu_torch.parallel import Mesh
    from avex_tpu_torch.parallel.tensor import ModelAxis, time_span

    two = Mesh(size=2, rank=0, group=None, device=torch.device("cpu"))
    assert [time_span(seq, two, 0) for seq in (513, 514)] == [(0, 257), (0, 257)]
    with pytest.raises(ValueError, match="sequence_length"):
        ModelAxis(two, sequence=True).enter(torch.zeros(2, 257, 8), cut=False)
