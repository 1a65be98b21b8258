"""ATST-Frame in the PyTorch port against the JAX package, with the same weights.

A 2-block FrameAST at dim 128 with 2 heads (dh 64, so JAX's fused route
takes it: K5 in interpret mode with ``use_pallas``, the port's twin on the
CPU) over one second of 16 kHz audio (101 frames, 25 tokens), initialised in
JAX and carried across with ``params_from_jax``: the frontend in both
precisions, the timestamp and scene embeddings, ``pooled``, the intermediates
and a classifier; then both converter namings and the position cut, a local
checkpoint, and three ``Trainer`` steps against JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.models.atst import FrameASTModel as JaxFrameAST
from avex_tpu.models.atst import Model as JaxATSTWrapper
from avex_tpu.models.atst import atst_frontend as jax_frontend
from avex_tpu.models.atst import convert_atst_state_dict as jax_convert
from avex_tpu.utils.tree import count_params

import avex_tpu
from avex_tpu.configs import DatasetCollectionConfig, DatasetConfig
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import RunConfig as JaxRunConfig
from avex_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from avex_tpu.configs import TrainingParams as JaxTrainingParams
from avex_tpu.parallel import shard_batch
from avex_tpu.training import Trainer as JaxTrainer

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.models import atst
from avex_tpu_torch.models.common import build_module
from avex_tpu_torch.ops import attention_kernels as ak
from avex_tpu_torch.training import Trainer
from tests.test_torch_beats import BF16_POOLED_REL, FP32_TOL, _np, _rel
from tests.test_torch_training import LOSS_REL, NUM_CLASSES, PARAM_TOL, STEPS, TRAINING, _batches
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

TINY = dict(embed_dim=128, depth=2, heads=2)
PATHS = pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "k5"])
# The frontend: dB of an fp32 DFT summed in another order, min-max scaled by
# 1/130; near-silent bins are clipped at top_db either way.
FRONTEND_ATOL = 2e-5


def _wav(rng, batch=2, samples=16000):
    return (rng.standard_normal((batch, samples)) * 0.1).astype(np.float32)


def build_pair(compute_dtype="float32", use_pallas=True, num_classes=None, seed=5):
    """(JAX ``FrameASTModel`` and its variables, port ``FrameASTModel``), same weights."""
    dtype = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    jax_module = JaxFrameAST(num_classes=num_classes, use_pallas=use_pallas, dtype=dtype, **TINY)
    variables = jax_module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16000), jnp.float32))
    port = atst.FrameASTModel(num_classes=num_classes, use_pallas=use_pallas,
                              dtype=torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32, **TINY)
    state = atst.params_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"]))
    assert set(state) == set(port.state_dict()), set(state) ^ set(port.state_dict())
    port.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=True)
    return (jax_module, variables), port


def run_pair(pair, wav):
    (jax_module, variables), port = pair
    out_j, aux_j = jax_module.apply(variables, wav)
    with torch.no_grad():
        out_t, aux_t = port(torch.from_numpy(wav))
    return (out_j, aux_j), (out_t, aux_t)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_atst_frontend_matches_jax(rng, precision):
    wav = _wav(rng)
    jax_precision = jax.lax.Precision.HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
    want = np.asarray(jax_frontend(jnp.asarray(wav), precision=jax_precision))
    got = atst.atst_frontend(torch.from_numpy(wav), precision)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 64, 101)
    np.testing.assert_allclose(got.numpy(), want, atol=FRONTEND_ATOL, rtol=0)


@PATHS
def test_atst_fp32_matches_jax(rng, use_pallas):
    ak.reset_launch_counts()
    (out_j, aux_j), (out_t, aux_t) = run_pair(build_pair(use_pallas=use_pallas), _wav(rng))
    assert out_t.shape == (2, 25, 2 * 128)  # timestamp: the 2 blocks' normed outputs side by side
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    for key in ("timestamp_embedding", "scene_embedding", "pooled", "features"):
        np.testing.assert_allclose(_np(aux_t[key]), _np(aux_j[key]), err_msg=key, **FP32_TOL)
    assert aux_t["scene_embedding"].shape == (2, 256) and aux_t["pooled"].shape == (2, 256)
    assert sorted(aux_t["intermediates"]) == sorted(aux_j["intermediates"]) == ["atst.blocks.0", "atst.blocks.1"]
    for name, want in aux_j["intermediates"].items():
        np.testing.assert_allclose(_np(aux_t["intermediates"][name]), _np(want), err_msg=name, **FP32_TOL)
    assert sum(ak.LAUNCHES.values()) == 0


@PATHS
def test_atst_bf16_matches_jax(rng, use_pallas):
    (_, aux_j), (out_t, aux_t) = run_pair(build_pair("bfloat16", use_pallas=use_pallas), _wav(rng))
    assert out_t.dtype == torch.bfloat16
    assert _rel(aux_t["pooled"], aux_j["pooled"]) <= BF16_POOLED_REL
    for name, want in aux_j["intermediates"].items():
        assert _rel(aux_t["intermediates"][name], want) <= 2 * BF16_POOLED_REL, name


def test_atst_classifier_and_spectrogram_input_match_jax(rng):
    pair = build_pair(num_classes=3)
    spec = np.array(jax_frontend(jnp.asarray(_wav(rng, samples=24000))))  # 151 frames → 37 tokens
    (out_j, aux_j), (out_t, aux_t) = run_pair(pair, spec)
    assert out_t.shape == (2, 3) and aux_t["timestamp_embedding"].shape[1] == 37
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)


def test_atst_wrapper_layers_and_factory(rng):
    """``ModelSpec(name="atst")`` builds the full FrameAST-base wrapper; its
    taps are the 12 blocks, un-normed."""
    model = avex_tpu_torch.build_model_from_spec(ModelSpec(name="atst", pretrained=False, device="cpu"))
    assert model.get_model_layers() == [f"atst.blocks.{i}" for i in range(12)]
    assert model.module.pos_embed.shape == (1, 250, 768) and model.module.blocks[0].attn.qkv.bias is None
    model.register_hooks_for_layers([0, "last_layer"])
    emb = model.extract_embeddings(_wav(rng, batch=1, samples=8000), aggregation="mean")
    assert emb.shape == (1, 2 * 768)
    timestamp = model(_wav(rng, batch=1, samples=8000))
    assert timestamp.shape == (1, 12, 12 * 768)  # 51 frames → 12 tokens


def _reference_state(params, linear_patch):
    """A reference-named FrameAST encoder checkpoint holding ``params``: the
    Conv2d or the Linear (PatchEmbed_v2) patch embedding, ``pos_embed`` with
    its class slot, ``norm_frame``, behind the teacher's prefix."""
    kernel = np.asarray(params["patch_embed"]["kernel"])  # [64, 4, 1, D]
    prefix = "model.teacher.encoder."
    state = {
        f"{prefix}pos_embed": np.concatenate([np.full((1, 1, 128), 7.0, np.float32), params["pos_embed"]], axis=1),
        f"{prefix}norm_frame.weight": params["norm"]["scale"],
        f"{prefix}norm_frame.bias": params["norm"]["bias"],
    }
    if linear_patch:
        state[f"{prefix}patch_embed.patch_embed.weight"] = kernel.reshape(64 * 4 * 1, -1).T
        state[f"{prefix}patch_embed.patch_embed.bias"] = params["patch_embed"]["bias"]
    else:
        state[f"{prefix}patch_embed.proj.weight"] = np.transpose(kernel, (3, 2, 0, 1))
        state[f"{prefix}patch_embed.proj.bias"] = params["patch_embed"]["bias"]
    for i in range(2):
        node, base = params[f"blocks_{i}"], f"{prefix}blocks.{i}"
        for norm in ("norm1", "norm2"):
            state[f"{base}.{norm}.weight"] = node[norm]["scale"]
            state[f"{base}.{norm}.bias"] = node[norm]["bias"]
        state[f"{base}.attn.qkv.weight"] = node["qkv"]["kernel"].T
        for sub, name in (("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            state[f"{base}.{sub}.{name}.weight"] = node[name]["kernel"].T
            state[f"{base}.{sub}.{name}.bias"] = node[name]["bias"]
    return state


@pytest.mark.parametrize("linear_patch", [False, True], ids=["conv_patch", "linear_patch"])
def test_convert_atst_state_dict_matches_jax(rng, linear_patch):
    """Both patch-embedding namings and the position cut: the converted
    state gives the JAX converter's outputs on the same dict."""
    (jax_module, variables), port = build_pair()
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    state = _reference_state(params, linear_patch)
    converted = atst.convert_atst_state_dict(state)
    assert converted.keys() == port.state_dict().keys()
    assert converted["pos_embed"].shape == (1, 250, 128) and not (converted["pos_embed"] == 7.0).any()
    jax_params = jax_convert(state)["params"]
    assert sum(v.size for v in converted.values()) == count_params(jax_params)
    port.load_state_dict({k: torch.tensor(v) for k, v in converted.items()}, strict=True)
    wav = _wav(rng)
    want, _ = jax_module.apply({"params": jax_params}, wav)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(wav))
    np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)


def test_atst_wrapper_loads_a_local_checkpoint(tmp_path, rng):
    """``atst_model_path`` is read from a local file, as the JAX wrapper's."""
    jax_model = JaxATSTWrapper()
    params = jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])
    state = {f"blocks.{k.split('.', 1)[1]}" if k.startswith("blocks") else k: v
             for k, v in atst.params_from_jax(params).items()}
    state["pos_embed"] = np.concatenate([np.zeros((1, 1, 768), np.float32), state["pos_embed"]], axis=1)
    state["norm_frame.weight"], state["norm_frame.bias"] = state.pop("norm.weight"), state.pop("norm.bias")
    path = tmp_path / "atst.npz"
    np.savez(path, **state)
    jax_model.load_state_dict(state)
    port = atst.Model(device="cpu", atst_model_path=str(path))
    wav = _wav(rng, batch=1, samples=8000)
    np.testing.assert_allclose(_np(port(wav)), _np(jax_model(wav)), **FP32_TOL)
    with pytest.raises(ValueError, match="local files only"):
        atst.Model(device="cpu", atst_model_path="hf://org/atst.ckpt")


def test_atst_train_steps_match_jax_trainer(tmp_path):
    """Three supervised AdamW steps through both ``Trainer``s with a class
    head (``return_features_only=False``), K5 and K6 (JAX: in interpret
    mode; the port: the twins): per-step loss and the final parameters. Both
    wrappers are the registered ``atst``, their modules swapped for the tiny
    FrameAST with the same weights."""
    spec = dict(name="atst", pretrained=False)
    jax_config = JaxRunConfig(
        model_spec=JaxModelSpec(**spec),
        training_params=JaxTrainingParams(**TRAINING),
        dataset_config=DatasetCollectionConfig(
            train_datasets=[DatasetConfig(name="synth", kind="synthetic", num_samples=8, num_classes=4)]),
        output_dir=str(tmp_path / "jax"),
        scheduler=JaxSchedulerConfig(name="cosine", warmup_steps=1),
        seed=0,
    )
    jax_model = avex_tpu.build_model_from_spec(jax_config.model_spec, num_classes=NUM_CLASSES,
                                               return_features_only=False)
    jax_model.module = JaxFrameAST(num_classes=NUM_CLASSES, use_pallas=True, **TINY)
    jax_model.variables = jax_model._init_variables(jnp.zeros((1, 16000), jnp.float32), seed=2)
    config = RunConfig(model_spec=ModelSpec(**spec, device="cpu"), training_params=TrainingParams(**TRAINING),
                       output_dir=str(tmp_path / "port"), scheduler=SchedulerConfig(name="cosine", warmup_steps=1),
                       seed=0, device="cpu")
    port = avex_tpu_torch.build_model_from_spec(config.model_spec, num_classes=NUM_CLASSES,
                                                return_features_only=False)
    assert port.num_classes == NUM_CLASSES
    port.module = build_module(lambda: atst.FrameASTModel(num_classes=NUM_CLASSES, use_pallas=True, **TINY), 0,
                               port.device)
    port.load_port_state_dict(atst.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                          jax_model.variables["params"])),
                              strict=True)
    batches = _batches(seed=17)
    jax_trainer = JaxTrainer(jax_model, jax_config, batches, steps_per_epoch=4)
    trainer = Trainer(port, config, batches, steps_per_epoch=4)
    for batch in batches:
        jax_trainer.state, want, _ = jax_trainer._train_step(jax_trainer.state, shard_batch(batch, jax_trainer.mesh))
        got, _ = trainer._train_step(batch)
        assert abs(got.item() - float(want)) <= LOSS_REL * abs(float(want))
    want_params = atst.params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_trainer.state.params)))
    state = port.state_dict()
    for key, value in want_params.items():
        np.testing.assert_allclose(state[key].numpy(), value, err_msg=key, **PARAM_TOL)
    assert trainer.state.step == STEPS
