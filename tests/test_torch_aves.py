"""AVES in the PyTorch port against the JAX package, with the same weights.

A 2-layer, 128-d, 2-head AVES (FFN 256) over the full HuBERT conv stack,
initialised in JAX and carried across with ``params_from_jax``. With
``use_pallas=True`` both packages take the fused route, which hands the
frame mask to the attention kernel (JAX: K5 in interpret mode; the port: its
plain twin on the CPU).
"""

import numpy as np
import pytest
import torch

import jax

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models.aves import AVESConfig, CONV_LAYERS, convert_aves_state_dict, params_from_jax
from avex_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_beats import BF16_POOLED_REL, FP32_TOL, _np, _rel
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

TINY = {
    "encoder_num_layers": 2,
    "encoder_embed_dim": 128,
    "encoder_num_heads": 2,
    "encoder_ff_interm_features": 256,
}
LAYERS = [f"model.encoder.transformer.layers.{i}.feed_forward.output_dense" for i in range(2)]


def build_pair(compute_dtype="float32", use_pallas=True, num_classes=None, seed=3):
    """(JAX model, port model on the CPU) holding the same weights."""
    kwargs = dict(use_pallas=use_pallas, aves_cfg=TINY, num_classes=num_classes,
                  return_features_only=num_classes is None)
    jax_model = avex_tpu.build_model_from_spec(
        JaxModelSpec(name="aves_bio", pretrained=False, compute_dtype=compute_dtype), seed=seed, **kwargs
    )
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="aves_bio", pretrained=False, compute_dtype=compute_dtype), device="cpu", **kwargs
    )
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.variables["params"]))
    assert set(state) == set(port.state_dict()), set(state) ^ set(port.state_dict())
    port.load_port_state_dict(state, strict=True)
    return jax_model, port


def run_pair(jax_model, port, wav, mask=None):
    out_j, aux_j = jax_model.module.apply(
        jax_model.variables, wav, mask, deterministic=True, disable_layerdrop=True
    )
    with torch.no_grad():
        out_t, aux_t = port.module(torch.from_numpy(wav), None if mask is None else torch.from_numpy(mask))
    return (out_j, aux_j), (out_t, aux_t)


def _inputs(rng, padded):
    """1 s clips; with ``padded`` the second clip is padded from 0.5625 s."""
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    mask = None
    if padded:
        mask = np.zeros((2, 16000), dtype=bool)
        mask[1, 9000:] = True
    return wav, mask


def _valid_mean(features, frame_mask):
    features = _np(features)
    if frame_mask is None:
        return features.mean(axis=1)
    valid = ~_np(frame_mask).astype(bool)
    return (features * valid[..., None]).sum(axis=1) / valid.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_aves_fp32_matches_jax(rng, padded):
    ak.reset_launch_counts()
    wav, mask = _inputs(rng, padded)
    (out_j, aux_j), (out_t, aux_t) = run_pair(*build_pair(), wav, mask)
    assert out_t.shape == (2, 49, 128)
    if padded:
        frame_mask = _np(aux_j["padding_mask"]).astype(bool)
        np.testing.assert_array_equal(aux_t["padding_mask"].numpy(), frame_mask)
        assert frame_mask[1].any() and not frame_mask[0].any()
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    assert sorted(aux_t["intermediates"]) == sorted(aux_j["intermediates"]) == LAYERS
    for name, want in aux_j["intermediates"].items():
        np.testing.assert_allclose(_np(aux_t["intermediates"][name]), _np(want), err_msg=name, **FP32_TOL)
    assert sum(ak.LAUNCHES.values()) == 0  # CPU tensors take the twins


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_aves_bf16_matches_jax(rng, padded):
    wav, mask = _inputs(rng, padded)
    (out_j, aux_j), (out_t, aux_t) = run_pair(*build_pair(compute_dtype="bfloat16"), wav, mask)
    assert out_t.dtype == torch.bfloat16
    pooled_j = _valid_mean(out_j, aux_j["padding_mask"])
    pooled_t = _valid_mean(out_t, aux_t["padding_mask"])
    assert _rel(pooled_t, pooled_j) <= BF16_POOLED_REL
    for name, want in aux_j["intermediates"].items():
        got = _valid_mean(aux_t["intermediates"][name], aux_t["padding_mask"])
        assert _rel(got, _valid_mean(want, aux_j["padding_mask"])) <= 2 * BF16_POOLED_REL, name


def test_aves_plain_attention_path_matches_jax(rng):
    """use_pallas=False: q, k, v as three products, the mask as a -inf bias."""
    wav, mask = _inputs(rng, padded=True)
    (out_j, _), (out_t, _) = run_pair(*build_pair(use_pallas=False), wav, mask)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)


def test_aves_classifier_masked_mean_matches_jax(rng):
    wav, mask = _inputs(rng, padded=True)
    jax_model, port = build_pair(num_classes=6)
    (out_j, aux_j), (out_t, aux_t) = run_pair(jax_model, port, wav, mask)
    assert out_t.shape == (2, 6)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)
    np.testing.assert_allclose(_np(port(wav, mask)), np.asarray(jax_model(wav, mask)), **FP32_TOL)


def _torchaudio_state(params, weight_norm_naming):
    """A torchaudio-named AVES checkpoint holding ``params`` (``tests/unittests/
    test_aves.py``'s construction), behind the wrapper's ``model.`` prefix,
    with the pos_conv weight-normed."""
    state = {}
    fe = params["feature_extractor"]
    for i in range(len(CONV_LAYERS)):
        state[f"feature_extractor.conv_layers.{i}.conv.weight"] = np.transpose(fe[f"conv_{i}"]["kernel"], (2, 1, 0))
    state["feature_extractor.conv_layers.0.layer_norm.weight"] = fe["group_norm"]["scale"]
    state["feature_extractor.conv_layers.0.layer_norm.bias"] = fe["group_norm"]["bias"]
    state["encoder.feature_projection.layer_norm.weight"] = params["fp_layer_norm"]["scale"]
    state["encoder.feature_projection.layer_norm.bias"] = params["fp_layer_norm"]["bias"]
    state["encoder.feature_projection.projection.weight"] = params["fp_projection"]["kernel"].T
    state["encoder.feature_projection.projection.bias"] = params["fp_projection"]["bias"]
    # a g/v pair whose fold is the kernel, with ||v|| != g
    pos = np.transpose(params["pos_conv"]["kernel"], (2, 1, 0))
    g = np.sqrt(np.sum(pos**2, axis=(0, 1), keepdims=True))
    v = pos * 2.0
    conv = "encoder.transformer.pos_conv_embed.conv"
    if weight_norm_naming == "weight_g":
        state[f"{conv}.weight_g"], state[f"{conv}.weight_v"] = g, v
    else:
        state[f"{conv}.parametrizations.weight.original0"] = g
        state[f"{conv}.parametrizations.weight.original1"] = v
    state[f"{conv}.bias"] = params["pos_conv"]["bias"]
    state["encoder.transformer.layer_norm.weight"] = params["encoder_layer_norm"]["scale"]
    state["encoder.transformer.layer_norm.bias"] = params["encoder_layer_norm"]["bias"]
    for i in range(2):
        node, base = params[f"layers_{i}"], f"encoder.transformer.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            state[f"{base}.attention.{name}.weight"] = node[name]["kernel"].T
            state[f"{base}.attention.{name}.bias"] = node[name]["bias"]
        for name in ("intermediate_dense", "output_dense"):
            state[f"{base}.feed_forward.{name}.weight"] = node[name]["kernel"].T
            state[f"{base}.feed_forward.{name}.bias"] = node[name]["bias"]
        for name in ("layer_norm", "final_layer_norm"):
            state[f"{base}.{name}.weight"] = node[name]["scale"]
            state[f"{base}.{name}.bias"] = node[name]["bias"]
    return state


@pytest.mark.parametrize("naming", ["weight_g", "parametrizations"])
def test_convert_aves_state_dict_from_torchaudio_naming(rng, naming):
    jax_model, port = build_pair(use_pallas=False)
    params = jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])
    state = _torchaudio_state(params, naming)
    converted = convert_aves_state_dict({f"model.{k}": v for k, v in state.items()})
    assert converted.keys() == port.state_dict().keys()
    np.testing.assert_allclose(
        converted["encoder.transformer.pos_conv_embed.conv.weight"],
        np.transpose(params["pos_conv"]["kernel"], (2, 1, 0)), atol=1e-6,
    )
    jax_model.load_state_dict(state)  # the JAX package's loader takes the prefix already stripped
    port.load_state_dict({f"model.{k}": v for k, v in state.items()}, strict=True)
    wav, mask = _inputs(rng, padded=True)
    np.testing.assert_allclose(_np(port(wav, mask)), np.asarray(jax_model(wav, mask)), **FP32_TOL)


def test_aves_config_and_unported_options():
    cfg = AVESConfig.from_dict(dict(TINY, extractor_mode="group_norm", encoder_dropout=0.1))
    assert cfg.encoder_embed_dim == 128 and cfg.encoder_dropout == 0.1
    assert cfg.extra == {"extractor_mode": "group_norm"}
    # scan_layers is ported (tests/test_torch_model_parallel.py); so is ring attention
    # (tests/test_torch_ring_attention.py): a mesh of None turns it off
    stacked = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="aves_bio", pretrained=False), device="cpu", aves_cfg=TINY, scan_layers=True
    )
    assert stacked.stacked_layers == "encoder.transformer.layers"
    stacked.enable_ring_attention(mesh=None)
    assert all(layer.ring_mesh is None for layer in stacked.module.encoder.transformer.layers)
