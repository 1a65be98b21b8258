"""BEATs in the PyTorch port against the JAX package, with the same weights.

A 2-layer, 96-d, 12-head BEATs with ``use_pallas=True`` (split q/k/v, and
``fused_qkv``), initialised in JAX, carried across with ``params_from_jax``.
The JAX side runs its Pallas kernels in interpret mode (automatic off-TPU);
the port's attention wrappers take their plain twins on CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.models.beats import BEATsBackbone as JaxBackbone
from avex_tpu.models.beats import BEATsConfig as JaxBEATsConfig

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models.beats import params_from_jax

TINY = {
    "encoder_layers": 2,
    "encoder_embed_dim": 96,
    "encoder_ffn_embed_dim": 128,
    "encoder_attention_heads": 12,
    "embed_dim": 32,
    "dropout": 0.0,
    "attention_dropout": 0.0,
    "encoder_layerdrop": 0.0,
    "use_pallas": True,
}
# fp32: both sides compute the same fp32 ops in another order (fbank matmuls,
# softmax sums); the JAX Pallas test of the same model uses these values.
FP32_TOL = dict(atol=5e-5, rtol=1e-4)
# bf16: the frameworks round at other places (torch adds a Linear's bias before
# rounding its product, XLA after; LayerNorm/GELU round once each), each a
# ~2^-9 relative step, compounded over the layers.
BF16_POOLED_REL = 1e-2


def build_pair(init_config, compute_dtype="float32", seed=3, **kwargs):
    """(JAX model, port model on the CPU) holding the same weights."""
    jax_model = avex_tpu.build_model_from_spec(
        JaxModelSpec(name="beats", pretrained=False, init_config=init_config, compute_dtype=compute_dtype),
        seed=seed,
        **kwargs,
    )
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="beats", pretrained=False, init_config=init_config, compute_dtype=compute_dtype),
        device="cpu",
        **kwargs,
    )
    params = jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])
    state = params_from_jax(params)
    assert set(state) == set(port.state_dict()), set(state) ^ set(port.state_dict())
    port.load_port_state_dict(state, strict=True)
    return jax_model, port


def run_pair(jax_model, port, wav, mask=None):
    out_j, aux_j = jax_model.module.apply(
        jax_model.variables, wav, mask, deterministic=True, disable_layerdrop=True
    )
    with torch.no_grad():
        out_t, aux_t = port.module(
            torch.from_numpy(wav), None if mask is None else torch.from_numpy(mask)
        )
    return (out_j, aux_j), (out_t, aux_t)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# Two 64-wide heads: the fused-QKV kernel's own path (K2) on both sides; at
# TINY's 8-wide heads both packages split the fused projection and run K1.
DH64 = dict(TINY, encoder_embed_dim=128, encoder_attention_heads=2)


@pytest.mark.parametrize(
    "config", [TINY, dict(TINY, fused_qkv=True), dict(DH64, fused_qkv=True)],
    ids=["split", "fused_qkv", "fused_qkv_dh64"],
)
def test_beats_fp32_matches_jax(rng, config):
    jax_model, port = build_pair(config, return_features_only=True)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    (out_j, aux_j), (out_t, aux_t) = run_pair(jax_model, port, wav)

    assert out_t.shape == (2, 48, config["encoder_embed_dim"])
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)
    assert sorted(aux_t["intermediates"]) == sorted(aux_j["intermediates"]) == [
        "backbone.encoder.layers.0.fc2",
        "backbone.encoder.layers.1.fc2",
        "backbone.post_extract_proj",
    ]
    for name, want in aux_j["intermediates"].items():
        np.testing.assert_allclose(_np(aux_t["intermediates"][name]), _np(want), err_msg=name, **FP32_TOL)


@pytest.mark.parametrize(
    "config", [TINY, dict(TINY, fused_qkv=True), dict(DH64, fused_qkv=True)],
    ids=["split", "fused_qkv", "fused_qkv_dh64"],
)
def test_beats_bf16_matches_jax(rng, config):
    jax_model, port = build_pair(config, compute_dtype="bfloat16", return_features_only=True)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    (out_j, aux_j), (out_t, aux_t) = run_pair(jax_model, port, wav)
    assert out_t.dtype == torch.bfloat16
    assert _rel(aux_t["pooled"], aux_j["pooled"]) <= BF16_POOLED_REL
    for name, want in aux_j["intermediates"].items():
        assert _rel(aux_t["intermediates"][name], want) <= 2 * BF16_POOLED_REL, name


def test_beats_padded_batch_matches_jax(rng):
    jax_model, port = build_pair(TINY, return_features_only=True)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    mask = np.zeros((2, 16000), dtype=bool)
    mask[1, 9000:] = True
    (out_j, aux_j), (out_t, aux_t) = run_pair(jax_model, port, wav, mask)

    frame_mask = _np(aux_j["padding_mask"]).astype(bool)
    np.testing.assert_array_equal(aux_t["padding_mask"].numpy(), frame_mask)
    assert frame_mask[1].any() and not frame_mask[0].any()
    valid = ~frame_mask
    np.testing.assert_allclose(_np(out_t)[valid], _np(out_j)[valid], **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)


def test_beats_plain_attention_path_matches_jax(rng):
    """use_pallas=False: the port's dot_product_attention path, fp32 logits."""
    jax_model, port = build_pair(dict(TINY, use_pallas=False), return_features_only=True)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    (out_j, _), (out_t, _) = run_pair(jax_model, port, wav)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)


def test_beats_classifier_head_matches_jax(rng):
    jax_model, port = build_pair(TINY, num_classes=5)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    want = np.asarray(jax_model(wav))
    got = port(wav)
    assert got.shape == (2, 5)
    np.testing.assert_allclose(_np(got), want, **FP32_TOL)


def test_finetuned_predictor_head_matches_jax(rng):
    """The backbone's AudioSet predictor with masked-mean logits pooling."""
    config = dict(TINY, finetuned_model=True, predictor_class=7)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    mask = np.zeros((2, 16000), dtype=bool)
    mask[0, 12000:] = True
    backbone = JaxBackbone(cfg=JaxBEATsConfig(**config))
    # flax creates the predictor's params only on a call that applies it
    variables = backbone.init(jax.random.PRNGKey(5), wav[:1], apply_predictor=True)
    want, _ = backbone.apply(variables, wav, mask, apply_predictor=True)

    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="beats", pretrained=False, init_config=config), device="cpu", return_features_only=True
    )
    params = jax.tree_util.tree_map(np.asarray, {"backbone": variables["params"]})
    port.load_port_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got, _ = port.module.backbone(torch.from_numpy(wav), torch.from_numpy(mask), apply_predictor=True)
    assert got.shape == (2, 7)
    np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)


def test_unported_options_raise():
    for key in ("scan_layers", "remat"):
        with pytest.raises(NotImplementedError, match=key):
            avex_tpu_torch.build_model_from_spec(
                ModelSpec(name="beats", pretrained=False, init_config=dict(TINY, **{key: True})),
                device="cpu",
            )
    # quantize_encoder is ported: the model builds with int8 encoder layers
    # (tests/test_torch_quant.py holds them to JAX).
    model = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="beats", pretrained=False, init_config=dict(TINY, quantize_encoder=True)), device="cpu"
    )
    assert model.module.backbone.encoder.layers[0].fc1.weight_q.dtype == torch.int8
