"""GPipe over the port's model axis and the stacked ``scan_layers`` layout, against JAX.

JAX's cells 6, 6b and 6c of ``__graft_entry__.dryrun_multichip`` pipeline
the stacked layer stack of BEATs, EAT and AVES over the ``model`` axis of
a 2x2 mesh (``pipeline_apply``, one stage per model rank, every data row
its own pipeline). The port runs the same schedule over four gloo
processes (``tests/test_torch_model_parallel_ranks.py``, one spawned group
for the file), at M=2 and M=4 microbatches, on JAX's weights carried
across from its stacked trees. Each step's oracle is JAX's one-device step
on the same weights: the port's loss is held to it and to JAX's pipelined
cell (at M=2: JAX's values do not depend on M, and its M=4 cells give the
same loss; one more compile each is time the file does not have), its
gradients and parameters to the one-device step (JAX's 2x2 steps double
the gradient of BEATs' and AVES's grouped ``pos_conv`` weight: ROADMAP
queue 3).

The stacked layout at the edges: JAX's stacked trees load into the port's
per-layer modules (``params_from_jax``) and give JAX's outputs; the port's
converters with ``scan_layers`` stack what JAX's stack.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avex_tpu
from avex_tpu.models.aves import convert_aves_state_dict as jax_convert_aves
from avex_tpu.models.beats import BEATsConfig as JaxBEATsConfig
from avex_tpu.models.beats import convert_beats_state_dict as jax_convert_beats
from avex_tpu.models.eat import convert_eat_state_dict as jax_convert_eat

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models import aves, beats, eat
from avex_tpu_torch.models.common import unstack_state
from tests.test_torch_beats import FP32_TOL
from tests.test_torch_efficientnet import _tree
from tests.test_torch_model_parallel import (
    AVES,
    BEATS,
    EAT,
    LOSS_REL,
    NUM_CLASSES,
    RAW_AUDIO,
    _dump,
    _spec,
    hold_step,
    jax_cell,
    reference_state,
)
from tests.test_torch_model_parallel_ranks import WORLD, rank_main
from tests.test_torch_parallel_ranks import RankGroup
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

MODELS = {  # architecture, stacked init, params_from_jax
    "beats": ("beats", dict(BEATS, scan_layers=True), beats.params_from_jax),
    "eat": ("eat_hf", dict(EAT, scan_layers=True), eat.params_from_jax),
    "aves": ("aves_bio", dict(AVES, scan_layers=True), aves.params_from_jax),
}
STACKS = {"beats": beats.STACK, "eat": "blocks", "aves": aves.STACK}
MICROBATCHES = (2, 4)


def _jax_stacked(name):
    """JAX's stacked model and its variables as numpy."""
    arch, init, _ = MODELS[name]
    model = avex_tpu.build_model_from_spec(
        avex_tpu.configs.ModelSpec(name=arch, pretrained=False, init_config=init, audio_config=RAW_AUDIO),
        num_classes=NUM_CLASSES)
    return model, jax.tree_util.tree_map(np.asarray, dict(model.variables))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks start as soon as the weights exist; JAX's steps run meanwhile."""
    work = tmp_path_factory.mktemp("pipeline")
    weights = {name: _jax_stacked(name)[1] for name in MODELS}
    inputs = {}
    for name, (arch, init, convert) in MODELS.items():
        state = convert(weights[name]["params"])
        for m in MICROBATCHES:
            inputs[f"pipeline_{name}_{m}"] = _spec(arch, init, state, {"data": 2, "model": 2,
                                                                       "pipeline_microbatches": m})
    _dump(inputs, work / "inputs.pkl")
    _dump({}, work / "inputs_late.pkl")
    group = RankGroup(work, world=WORLD, timeout=240.0, main=rank_main)
    oracles, cells = {}, {}
    for name, (arch, init, convert) in MODELS.items():
        oracles[name] = jax_cell(arch, init, work / f"{name}_one", convert, variables=weights[name], data=1, model=1)
        cells[name] = jax_cell(arch, init, work / f"{name}_pipeline", convert, variables=weights[name],
                               data=2, model=2, pipeline_microbatches=MICROBATCHES[0])
    return {"group": group, "oracles": oracles, "cells": cells, "inputs": inputs, "weights": weights}


@pytest.mark.parametrize("m", MICROBATCHES)
@pytest.mark.parametrize("name", list(MODELS))
def test_pipeline_step_matches_jax(ranks, name, m):
    """Cells 6 (BEATs), 6b (EAT) and 6c (AVES): two stages of two layers on
    each data row, M microbatches of the row's four clips."""
    oracle, cell = ranks["oracles"][name], ranks["cells"][name]
    assert abs(cell["loss"] - oracle["loss"]) <= LOSS_REL * abs(oracle["loss"])
    assert cell["placed"]["model"]  # JAX's stages hold the stacked layers
    results = ranks["group"].results()
    scenario = f"pipeline_{name}_{m}"
    hold_step(results, scenario, oracle["loss"], oracle["params"], oracle["grads"], oracle["initial"])
    # each stage holds its own layers: stage s the second half of the stack for s = 1
    owner = results[0][scenario]["owner"]
    stack = STACKS[name] + "."
    index = {n: int(n[len(stack):].split(".")[0]) for n in owner}
    per_stage = (max(index.values()) + 1) // 2
    assert owner and all(o == index[n] // per_stage for n, o in owner.items())
    assert set(owner) == {n for n in oracle["params"] if n.startswith(stack)}
    held = [r[scenario]["held_bytes"] for r in results]
    assert held[0] == held[2] and held[1] == held[3] and max(held) < sum(v.size for v in oracle["params"].values())


@pytest.mark.parametrize("name", list(MODELS))
def test_stacked_jax_trees_load_and_match_the_per_layer_layout(name):
    """A JAX ``scan_layers`` model's stacked tree, carried across by
    ``params_from_jax``, gives JAX's features; the port's model built with
    ``scan_layers`` and with the per-layer layout give the same."""
    arch, init, convert = MODELS[name]
    jax_model, variables = _jax_stacked(name)
    state = convert(variables["params"])
    wav = (np.random.default_rng(3).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jax_model.module.apply)(jax_model.variables, jnp.asarray(wav))[1]["features"])
    outs = []
    for layout in (init, {k: v for k, v in init.items() if k != "scan_layers"}):
        port = avex_tpu_torch.build_model_from_spec(
            ModelSpec(name=arch, pretrained=False, init_config=layout, audio_config=RAW_AUDIO, device="cpu"),
            num_classes=NUM_CLASSES)
        port.load_port_state_dict(state, strict=True)
        with torch.no_grad():
            outs.append(port.module(torch.from_numpy(wav))[1]["features"].numpy())
    np.testing.assert_allclose(outs[0], want, **FP32_TOL)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_stacked_converters_match_jax_s():
    """The converters' ``scan_layers`` output: JAX's stacked tree carried
    across equals the port's per-layer conversion, and the port's stacked
    state dict is its per-layer one stacked (and loads as it)."""
    rng = np.random.default_rng(7)

    def randomized(state):
        return {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in state.items()}

    def port_model(arch, init):
        return avex_tpu_torch.build_model_from_spec(
            ModelSpec(name=arch, pretrained=False, init_config=init, audio_config=RAW_AUDIO, device="cpu"),
            num_classes=NUM_CLASSES)

    beats_port = port_model("beats", BEATS)  # split q/k/v, as a reference checkpoint has them
    state = reference_state(randomized({k: v.numpy() for k, v in beats_port.module.state_dict().items()
                                        if not k.startswith("backbone.fbank")}))
    cfg = beats.BEATsConfig.from_dict(dict(BEATS, fused_qkv=True))
    per_layer = beats.convert_beats_state_dict(state, cfg, num_classes=NUM_CLASSES)
    stacked = beats.convert_beats_state_dict(state, cfg, num_classes=NUM_CLASSES, scan_layers=True)
    assert "backbone.encoder.layers.self_attn.qkv_proj.weight" in stacked
    assert _same(unstack_state(stacked, beats.STACK), per_layer)
    jax_stacked = jax_convert_beats(state, JaxBEATsConfig(**dict(BEATS, fused_qkv=True)), num_classes=NUM_CLASSES,
                                    scan_layers=True)["params"]
    assert _same(beats.params_from_jax(_tree(jax_stacked)), per_layer)
    fused = port_model("beats", dict(BEATS, fused_qkv=True, scan_layers=True))
    fused.load_port_state_dict(stacked, strict=True)  # the stacked layout loads as the per-layer one
    assert _same({k: v.numpy() for k, v in fused.module.state_dict().items() if k in per_layer}, per_layer)

    eat_port = port_model("eat_hf", EAT)
    state = randomized({f"backbone.model.{k}": v.numpy() for k, v in eat_port.module.state_dict().items()
                        if not k.startswith(("fbank", "classifier"))})
    per_layer = eat.convert_eat_state_dict(state)
    stacked = eat.convert_eat_state_dict(state, scan_layers=True)
    assert _same(unstack_state(stacked, "blocks"), per_layer)
    assert _same(eat.params_from_jax(_tree(jax_convert_eat(state, scan_layers=True)["params"])), per_layer)

    aves_port = port_model("aves_bio", AVES)
    state = randomized({k: v.numpy() for k, v in aves_port.module.state_dict().items()
                        if not k.startswith("classifier")})
    per_layer = aves.convert_aves_state_dict(state)
    stacked = aves.convert_aves_state_dict(state, scan_layers=True)
    assert _same(unstack_state(stacked, aves.STACK), per_layer)
    assert _same(aves.params_from_jax(_tree(jax_convert_aves(state, scan_layers=True)["params"])), per_layer)


def _same(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    return True
