"""Bird-MAE in the PyTorch port against the JAX package, with the same weights.

A 2-block Bird-MAE at dim 640 with 8 heads (dh 80, the width of Bird-MAE
large and huge; JAX's fused route takes it in 8-head groups) over 64 frames
of 32 kHz audio (33 tokens with the CLS token), initialised in JAX and
carried across with ``params_from_jax``. With ``use_pallas`` JAX runs K5 (and
under ``jax.grad`` K6) in interpret mode and the port its plain twins on the
CPU; without, both take the plain path. Then the variants by ``model_id``,
the converter, the layer-stack options and JAX's stacked layout, and three
``Trainer`` steps against JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avex_tpu
from avex_tpu.configs import DatasetCollectionConfig, DatasetConfig
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import RunConfig as JaxRunConfig
from avex_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from avex_tpu.configs import TrainingParams as JaxTrainingParams
from avex_tpu.models.birdmae import BirdMAEModel as JaxBirdMAEModel
from avex_tpu.models.birdmae import Model as JaxBirdMAEWrapper
from avex_tpu.models.birdmae import convert_birdmae_state_dict as jax_convert
from avex_tpu.parallel import shard_batch
from avex_tpu.training import Trainer as JaxTrainer
from avex_tpu.utils.tree import count_params

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.models import birdmae
from avex_tpu_torch.models.birdmae import MAE_VARIANTS, BirdMAEModel, Model, convert_birdmae_state_dict
from avex_tpu_torch.models.common import unstack_state
from avex_tpu_torch.models.eat import patch_tokens
from avex_tpu_torch.ops import attention_kernels as ak
from avex_tpu_torch.training import Trainer
from tests.test_torch_beats import BF16_POOLED_REL, FP32_TOL, _np, _rel
from tests.test_torch_training import BATCH, LOSS_REL, NUM_CLASSES, PARAM_TOL, STEPS, TRAINING, _batches, _zero_gradient
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

TINY = dict(depth=2, dim=640, heads=8, target_length=64)  # dh 80
MODEL_ID = "DBD-research-group/Bird-MAE-huge"
PATHS = pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "k5"])


def build_pair(compute_dtype="float32", use_pallas=True, num_classes=None, seed=3):
    """(JAX ``BirdMAEModel`` and its variables, port model on the CPU), same
    weights. JAX's wrapper does not expose ``use_pallas``, so its module is
    built directly; the port goes through its factory, ``init_config`` and all."""
    jax_module = JaxBirdMAEModel(num_classes=num_classes, use_pallas=use_pallas,
                                 dtype=jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32, **TINY)
    variables = jax_module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32000), jnp.float32))
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="birdmae", pretrained=False, model_id=MODEL_ID, compute_dtype=compute_dtype,
                  init_config=dict(TINY, use_pallas=use_pallas)),
        device="cpu", num_classes=num_classes,
    )
    state = birdmae.params_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"]))
    assert set(state) == set(port.state_dict()), set(state) ^ set(port.state_dict())
    port.load_port_state_dict(state, strict=True)
    return (jax_module, variables), port


def run_pair(pair, wav):
    (jax_module, variables), port = pair
    out_j, aux_j = jax_module.apply(variables, wav)
    with torch.no_grad():
        out_t, aux_t = port.module(torch.from_numpy(wav))
    return (out_j, aux_j), (out_t, aux_t)


def _wav(rng, batch=2, samples=32000):
    return (rng.standard_normal((batch, samples)) * 0.1).astype(np.float32)


@PATHS
@pytest.mark.parametrize("samples", [32000, 12000], ids=["cut", "padded"])
def test_birdmae_fp32_matches_jax(rng, use_pallas, samples):
    ak.reset_launch_counts()
    (out_j, aux_j), (out_t, aux_t) = run_pair(build_pair(use_pallas=use_pallas), _wav(rng, samples=samples))
    assert out_t.shape == (2, 33, 640)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)
    assert sorted(aux_t["intermediates"]) == sorted(aux_j["intermediates"]) == [
        "model.blocks.0.attn.proj", "model.blocks.1.attn.proj"]
    for name, want in aux_j["intermediates"].items():
        np.testing.assert_allclose(_np(aux_t["intermediates"][name]), _np(want), err_msg=name, **FP32_TOL)
    assert sum(ak.LAUNCHES.values()) == 0  # CPU tensors take the twins


@PATHS
def test_birdmae_bf16_matches_jax(rng, use_pallas):
    (_, aux_j), (out_t, aux_t) = run_pair(build_pair("bfloat16", use_pallas=use_pallas), _wav(rng))
    assert out_t.dtype == torch.bfloat16
    assert _rel(aux_t["pooled"], aux_j["pooled"]) <= BF16_POOLED_REL
    for name, want in aux_j["intermediates"].items():
        assert _rel(aux_t["intermediates"][name], want) <= 2 * BF16_POOLED_REL, name


def test_birdmae_classifier_matches_jax(rng):
    (out_j, _), (out_t, _) = run_pair(build_pair(num_classes=5), _wav(rng))
    assert out_t.shape == (2, 5)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)


def test_birdmae_tokens_are_time_major(rng):
    """The spectrogram is the image with time as its height: patch (row r,
    column c) covers frames 16r.. and mel bins 16c.., as JAX's NHWC conv."""
    (_, _), port = build_pair()
    spec = torch.zeros(1, 64, 128)
    spec[0, 16:32, 48:64] = 1.0  # time row 1, frequency column 3
    with torch.no_grad():
        tokens, gh, gw = patch_tokens(port.module.patch_embed.proj, spec, torch.float32)
    assert (gh, gw) == (4, 8)
    bias = port.module.patch_embed.proj.bias
    moved = [i for i in range(gh * gw) if not torch.allclose(tokens[0, i], bias)]
    assert moved == [1 * 8 + 3]


@pytest.mark.parametrize("variant", list(MAE_VARIANTS))
def test_birdmae_variant_from_model_id(variant):
    """``ModelSpec(name="birdmae", model_id=...)`` builds the variant the id
    names (one block here), as the JAX factory does."""
    dim, depth, heads = MAE_VARIANTS[variant]
    spec = ModelSpec(name="birdmae", pretrained=False, device="cpu",
                     model_id=f"DBD-research-group/Bird-MAE-{variant}", init_config={"depth": 1})
    model = avex_tpu_torch.build_model_from_spec(spec, return_features_only=True)
    assert model.model_id == spec.model_id and model.target_sample_rate == 32000
    block = model.module.blocks[0]
    assert (len(model.module.blocks), block.dim, block.heads) == (1, dim, heads)
    assert ak.fused_qkv_compatible(dim, heads)  # dh 64 (base) or 80: K5 takes every variant
    jax_model = avex_tpu.build_model_from_spec(
        JaxModelSpec(name="birdmae", pretrained=False, model_id=spec.model_id, init_config={"depth": 1}),
        return_features_only=True)
    assert (jax_model._module_kwargs["dim"], jax_model._module_kwargs["heads"]) == (dim, heads)
    assert birdmae.variant_of("something-else") == "huge" == birdmae.variant_of(MODEL_ID)
    model.register_hooks_for_layers(["all"])
    assert model.get_model_layers() == ["model.blocks.0.attn.proj"]


def test_birdmae_base_forward_shape(rng):
    """One second at 32 kHz pads to 1024 frames: 64 x 8 patches + CLS, 768-d
    (the JAX package's ``test_birdmae_base_forward``, at one block)."""
    model = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="birdmae", pretrained=False, device="cpu", model_id="DBD-research-group/Bird-MAE-base",
                  init_config={"depth": 1}), return_features_only=True)
    feats = model(_wav(rng, batch=1))
    assert feats.shape == (1, 513, 768)
    model.register_hooks_for_layers(["last_layer"])
    assert model.extract_embeddings(_wav(rng, batch=1), aggregation="mean").shape == (1, 768)


def _timm_state(params):
    """A timm/MAE-named Bird-MAE checkpoint holding ``params``, with a
    decoder entry and the fixed positions to skip."""
    state = {
        "patch_embed.proj.weight": np.transpose(params["patch_embed"]["kernel"], (3, 2, 0, 1)),
        "patch_embed.proj.bias": params["patch_embed"]["bias"],
        "cls_token": params["cls_token"],
        "pos_embed": np.zeros((1, 33, 640), np.float32),
        "norm.weight": params["norm"]["scale"] + 0.5,
        "norm.bias": params["norm"]["bias"],
        "decoder.blocks.0.attn.qkv.weight": np.zeros((4, 4), np.float32),
    }
    for i in range(2):
        node, base = params[f"blocks_{i}"], f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            state[f"{base}.{norm}.weight"] = node[norm]["scale"]
            state[f"{base}.{norm}.bias"] = node[norm]["bias"]
        for sub, name in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            state[f"{base}.{sub}.{name}.weight"] = node[name]["kernel"].T
            state[f"{base}.{sub}.{name}.bias"] = node[name]["bias"]
    return state


def test_convert_birdmae_state_dict_loads_like_jax(rng):
    jax_model = JaxBirdMAEWrapper(return_features_only=True, model_id=MODEL_ID, **TINY)
    params = jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])
    state = _timm_state(params)
    converted = convert_birdmae_state_dict(state)
    assert not any("decoder" in k or "pos_embed" in k for k in converted)
    assert sum(v.size for v in converted.values()) == count_params(jax_convert(state)["params"])
    port = Model(device="cpu", return_features_only=True, model_id=MODEL_ID, **TINY)
    assert converted.keys() == port.state_dict().keys()
    jax_model.load_state_dict(state)
    port.load_state_dict(state, strict=True)
    np.testing.assert_allclose(port.state_dict()["norm.weight"].numpy(), params["norm"]["scale"] + 0.5)
    wav = _wav(rng)
    np.testing.assert_allclose(_np(port(wav)), _np(jax_model(wav)), **FP32_TOL)


def test_birdmae_unported_options_raise():
    """JAX's layer-stack options are ported: the stacked layout, and
    pipeline and sequence parallelism refused without it, with JAX's
    message; a ring mesh of None is the block's own attention."""
    assert Model(device="cpu", scan_layers=True, **TINY).stacked_layers == "blocks"
    assert all(block.ring_mesh is None for block in BirdMAEModel(ring_mesh=None, **TINY).blocks)
    model = Model(device="cpu", **dict(TINY, depth=1))
    jax_model = JaxBirdMAEWrapper(model_id=MODEL_ID, **dict(TINY, depth=1))
    for method in ("enable_pipeline", "enable_sequence_parallel"):
        with pytest.raises(ValueError) as want:
            getattr(jax_model, method)(None)
        with pytest.raises(ValueError, match="scan_layers=True") as got:
            getattr(model, method)(None)
        assert str(got.value) == str(want.value)
    model.enable_ring_attention(None)
    assert model.module.blocks[0].ring_mesh is None


def test_birdmae_stacked_layout_round_trips_jax_scan_layers(rng):
    """JAX's ``scan_layers=True`` Bird-MAE: its stacked tree carried across
    (``params_from_jax``) loads into the port's stacked model and gives
    JAX's features; the converter's stacked output is JAX's stacked
    conversion carried across, and loads as the per-layer one."""
    jax_model = JaxBirdMAEWrapper(return_features_only=True, model_id=MODEL_ID, scan_layers=True, **TINY)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])
    assert variables["blocks"]["qkv"]["kernel"].shape[0] == TINY["depth"]  # stacked
    state = birdmae.params_from_jax(variables)
    port = Model(device="cpu", return_features_only=True, model_id=MODEL_ID, scan_layers=True, **TINY)
    port.load_port_state_dict(state, strict=True)
    wav = _wav(rng)
    np.testing.assert_allclose(_np(port(wav)), _np(jax_model(wav)), **FP32_TOL)
    per_layer = {k: np.asarray(v) for k, v in state.items()}
    timm = _timm_state({**{k: v for k, v in variables.items() if k != "blocks"},
                        **{f"blocks_{i}": jax.tree_util.tree_map(lambda x, i=i: x[i], variables["blocks"])
                           for i in range(TINY["depth"])}})
    stacked = convert_birdmae_state_dict(timm, scan_layers=True)
    assert "blocks.attn.qkv.weight" in stacked and stacked["blocks.attn.qkv.weight"].shape[0] == TINY["depth"]
    carried = birdmae.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_convert(timm, scan_layers=True)["params"]))
    unstacked = unstack_state(stacked, "blocks")
    assert set(carried) == set(unstacked)
    for key, value in carried.items():
        np.testing.assert_array_equal(unstacked[key], value, err_msg=key)
    again = Model(device="cpu", return_features_only=True, model_id=MODEL_ID, scan_layers=True, **TINY)
    again.load_port_state_dict(stacked, strict=True)
    loaded = {k: v.numpy() for k, v in again.module.state_dict().items() if k in per_layer}
    assert set(loaded) == set(unstacked)
    for key, value in unstacked.items():
        np.testing.assert_array_equal(loaded[key], value, err_msg=key)


def _jax_trainer_pair(tmp_path, use_pallas):
    """(JAX model, port model) with the same weights, and both run configs."""
    spec = dict(name="birdmae", pretrained=False, model_id=MODEL_ID, init_config=TINY)
    jax_config = JaxRunConfig(
        model_spec=JaxModelSpec(**spec),
        training_params=JaxTrainingParams(**TRAINING),
        dataset_config=DatasetCollectionConfig(
            train_datasets=[DatasetConfig(name="synth", kind="synthetic", num_samples=8, num_classes=4)]),
        output_dir=str(tmp_path / "jax"),
        scheduler=JaxSchedulerConfig(name="cosine", warmup_steps=1),
        seed=0,
    )
    jax_model = avex_tpu.build_model_from_spec(jax_config.model_spec, num_classes=NUM_CLASSES)
    jax_model.module = JaxBirdMAEModel(**jax_model._module_kwargs, use_pallas=use_pallas)
    config = RunConfig(
        model_spec=ModelSpec(**dict(spec, init_config=dict(TINY, use_pallas=use_pallas)), device="cpu"),
        training_params=TrainingParams(**TRAINING),
        output_dir=str(tmp_path / "port"),
        scheduler=SchedulerConfig(name="cosine", warmup_steps=1),
        seed=0,
        device="cpu",
    )
    port = avex_tpu_torch.build_model_from_spec(config.model_spec, num_classes=NUM_CLASSES)
    port.load_port_state_dict(birdmae.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                             jax_model.variables["params"])),
                              strict=True)
    return jax_model, port, jax_config, config


@PATHS
def test_birdmae_train_steps_match_jax_trainer(tmp_path, use_pallas):
    """Three supervised AdamW steps (JAX: K5/K6 in interpret mode with
    ``use_pallas``): per-step loss and the final parameters."""
    jax_model, port, jax_config, config = _jax_trainer_pair(tmp_path, use_pallas)
    batches = _batches(seed=13)
    jax_trainer = JaxTrainer(jax_model, jax_config, batches, steps_per_epoch=4)
    trainer = Trainer(port, config, batches, steps_per_epoch=4)
    for batch in batches:
        jax_trainer.state, want, _ = jax_trainer._train_step(jax_trainer.state, shard_batch(batch, jax_trainer.mesh))
        got, metrics = trainer._train_step(batch)
        assert abs(got.item() - float(want)) <= LOSS_REL * abs(float(want))
        assert metrics["count"] == BATCH
    want_params = birdmae.params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_trainer.state.params)))
    state = port.state_dict()
    for key, value in want_params.items():
        got, noise = state[key].numpy(), _zero_gradient(key, value.shape)
        np.testing.assert_allclose(got[~noise], value[~noise], err_msg=key, **PARAM_TOL)
        assert np.abs(got[noise] - value[noise]).max(initial=0.0) <= 2 * STEPS * TRAINING["lr"], key
    assert trainer.state.step == STEPS
