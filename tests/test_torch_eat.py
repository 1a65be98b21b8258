"""EAT in the PyTorch port against the JAX package, with the same weights.

A 2-block EAT over a 64-frame spectrogram (33 tokens with the CLS token),
initialised in JAX and carried across with ``params_from_jax``. At dim 128
with 2 heads both packages take the fused route (JAX: K5 in interpret mode,
the port: its plain twin on the CPU); at dim 96 with 12 heads JAX takes the
split-input K4 in interpret mode (lcm(8, 128) / 8 = 16 heads per group does
not divide 12) and the port its split branch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.models.eat import EATModel as JaxEATModel
from avex_tpu.models.eat import Model as JaxEATWrapper
from avex_tpu.models.eat import convert_eat_state_dict as jax_convert
from avex_tpu.models.eat import sincos_2d_positions as jax_sincos
from avex_tpu.ops import fbank as jax_fbank
from avex_tpu.utils.tree import count_params

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models.eat import EATModel, Model, convert_eat_state_dict, params_from_jax, sincos_2d_positions
from avex_tpu_torch.ops import attention_kernels as ak
from avex_tpu_torch.ops import fbank
from tests.test_torch_beats import BF16_POOLED_REL, FP32_TOL, _np, _rel

NORM = dict(eat_norm_mean=-5.553, eat_norm_std=4.606)  # the official EAT entries' statistics
TINY = dict(depth=2, target_length=64)
FUSED = dict(TINY, dim=128, heads=2)  # dh 64: K5 on both sides
SPLIT = dict(TINY, dim=96, heads=12)  # dh 8: JAX's K4, the port's split branch
ROUTES = pytest.mark.parametrize("config", [FUSED, SPLIT], ids=["fused_k5", "split_k4"])


def build_pair(config, compute_dtype="float32", use_pallas=True, num_classes=None, pooling="cls", seed=3):
    """(JAX ``EATModel`` and its variables, port model on the CPU), same weights.

    JAX's wrapper does not expose ``use_pallas``, so its module is built
    directly; the port goes through its factory, ``init_config`` and all.
    """
    jax_module = JaxEATModel(
        num_classes=num_classes, norm_mean=NORM["eat_norm_mean"], norm_std=NORM["eat_norm_std"],
        pooling=pooling, use_pallas=use_pallas,
        dtype=jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32, **config,
    )
    variables = jax_module.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16000), jnp.float32))
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="eat_hf", pretrained=False, compute_dtype=compute_dtype,
                  init_config=dict(config, use_pallas=use_pallas, pooling=pooling), **NORM),
        device="cpu",
        num_classes=num_classes,
    )
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"]))
    assert set(state) == set(port.state_dict()), set(state) ^ set(port.state_dict())
    port.load_port_state_dict(state, strict=True)
    return (jax_module, variables), port


def run_pair(pair, wav):
    (jax_module, variables), port = pair
    out_j, aux_j = jax_module.apply(variables, wav)
    with torch.no_grad():
        out_t, aux_t = port.module(torch.from_numpy(wav))
    return (out_j, aux_j), (out_t, aux_t)


def _wav(rng, batch=2, samples=16000):
    return (rng.standard_normal((batch, samples)) * 0.1).astype(np.float32)


@ROUTES
def test_eat_fp32_matches_jax(rng, config):
    ak.reset_launch_counts()
    (out_j, aux_j), (out_t, aux_t) = run_pair(build_pair(config), _wav(rng))
    assert out_t.shape == (2, 33, config["dim"])
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)
    assert sorted(aux_t["intermediates"]) == sorted(aux_j["intermediates"]) == [
        "backbone.model.blocks.0.attn.proj",
        "backbone.model.blocks.1.attn.proj",
    ]
    for name, want in aux_j["intermediates"].items():
        np.testing.assert_allclose(_np(aux_t["intermediates"][name]), _np(want), err_msg=name, **FP32_TOL)
    assert sum(ak.LAUNCHES.values()) == 0  # CPU tensors take the twins


@ROUTES
def test_eat_bf16_matches_jax(rng, config):
    (_, aux_j), (out_t, aux_t) = run_pair(build_pair(config, compute_dtype="bfloat16"), _wav(rng))
    assert out_t.dtype == torch.bfloat16
    assert _rel(aux_t["pooled"], aux_j["pooled"]) <= BF16_POOLED_REL
    for name, want in aux_j["intermediates"].items():
        assert _rel(aux_t["intermediates"][name], want) <= 2 * BF16_POOLED_REL, name


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_eat_plain_attention_path_matches_jax(rng, compute_dtype):
    """use_pallas=False: plain attention, bf16 logits under bf16 compute on both sides."""
    pair = build_pair(FUSED, compute_dtype=compute_dtype, use_pallas=False)
    (out_j, aux_j), (out_t, aux_t) = run_pair(pair, _wav(rng))
    if compute_dtype == "float32":
        np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    else:
        assert _rel(aux_t["pooled"], aux_j["pooled"]) <= BF16_POOLED_REL


def test_eat_mean_pooling_classifier_matches_jax(rng):
    pair = build_pair(SPLIT, num_classes=5, pooling="mean")
    (out_j, aux_j), (out_t, aux_t) = run_pair(pair, _wav(rng))
    assert out_t.shape == (2, 5)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)


@pytest.mark.parametrize("samples", [16000, 170000], ids=["padded", "truncated"])
def test_eat_fbank_matches_jax(rng, samples):
    wav = _wav(rng, samples=samples) + 0.05  # a DC offset for the frontend to remove
    want = np.asarray(jax_fbank.eat_fbank(jnp.asarray(wav), norm_mean=-5.553, norm_std=4.606))
    got = fbank.eat_fbank(torch.from_numpy(wav), norm_mean=-5.553, norm_std=4.606)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 128, 1024)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    single = fbank.eat_fbank(torch.from_numpy(wav[0]), norm_mean=-5.553, norm_std=4.606)
    np.testing.assert_allclose(single.numpy(), got[0].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("grid", [(8, 4), (8, 64)])
def test_sincos_positions_are_the_jax_table(grid):
    np.testing.assert_array_equal(sincos_2d_positions(96, *grid), jax_sincos(96, *grid))


def _fairseq_state(params):
    """A fairseq-named EAT checkpoint holding ``params`` (``tests/unittests/
    test_eat.py``'s construction), with EMA and decoder entries to skip."""
    state = {
        "modality_encoders.IMAGE.local_encoder.proj.weight": np.transpose(params["patch_embed"]["kernel"], (3, 2, 0, 1)),
        "modality_encoders.IMAGE.local_encoder.proj.bias": params["patch_embed"]["bias"],
        "modality_encoders.IMAGE.context_encoder.norm.weight": params["pre_norm"]["scale"] + 1.0,
        "modality_encoders.IMAGE.context_encoder.norm.bias": params["pre_norm"]["bias"],
        "modality_encoders.IMAGE.extra_tokens": params["cls_token"],
        "norm.weight": params["norm"]["scale"],
        "norm.bias": params["norm"]["bias"],
        "_ema.something": np.zeros(3, np.float32),
        "modality_encoders.IMAGE.decoder.proj.weight": np.zeros((4, 4), np.float32),
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


def test_convert_eat_state_dict_both_namings_load_like_jax(rng):
    """fairseq naming and the wrapper's ``backbone.model.`` naming give one
    state dict, and a checkpoint loads into both packages alike."""
    config = dict(SPLIT, **NORM)
    jax_model = JaxEATWrapper(return_features_only=True, **config)
    params = jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])
    state = _fairseq_state(params)
    wrapped = {f"backbone.model.{k}" if not k.startswith(("modality", "_ema")) else k: v
               for k, v in state.items()}

    converted = convert_eat_state_dict(state)
    assert "cls_token" in converted and not any("decoder" in k or "_ema" in k for k in converted)
    assert converted.keys() == convert_eat_state_dict(wrapped).keys()
    for key, value in convert_eat_state_dict(wrapped).items():
        np.testing.assert_array_equal(value, converted[key], err_msg=key)
    assert sum(v.size for v in converted.values()) == count_params(jax_convert(state)["params"])

    port = Model(device="cpu", return_features_only=True, **config)
    assert converted.keys() == port.state_dict().keys()
    jax_model.load_state_dict(state)
    port.load_state_dict(wrapped, strict=True)
    np.testing.assert_allclose(port.state_dict()["pre_norm.weight"].numpy(), params["pre_norm"]["scale"] + 1.0)
    wav = _wav(rng)
    np.testing.assert_allclose(_np(port(wav)), _np(jax_model(wav)), **FP32_TOL)


def test_eat_unported_options_raise():
    with pytest.raises(NotImplementedError, match="scan_layers"):
        Model(device="cpu", scan_layers=True, **TINY)
    with pytest.raises(NotImplementedError, match="ring_mesh"):
        EATModel(ring_mesh=object(), **TINY)
