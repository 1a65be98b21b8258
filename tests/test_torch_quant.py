"""Int8 (W8A8) BEATs in the port against the JAX package, on the CPU.

The tiny BEATs of ``tests/unittests/test_quant.py:109-119`` (2 layers, 64-d,
4 heads), initialised in JAX and carried across with ``params_from_jax``. Two
routes to the quantized port model are held to each other and to JAX's
``Model.quantize``: quantizing the carried float weights in the port, and
carrying the tree that JAX quantized. The port's ``Int8Linear`` takes the
K7 twin on CPU tensors; JAX runs its ``Int8Dense`` (``dynamic_int8_matmul``).
fp32 tolerance: rel L2 ≤ 1e-3, since an activation on a rounding boundary
may round to the neighbouring int8 level on one side only.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models.beats import ENCODER_QUANT_DENSES, params_from_jax, quantize_beats_params
from avex_tpu_torch.quant import Int8Linear
from tests.test_torch_aves import TINY as AVES_TINY
from tests.test_torch_beats import BF16_POOLED_REL, _np, _rel

TINY = dict(
    encoder_layers=2,
    encoder_embed_dim=64,
    encoder_ffn_embed_dim=128,
    encoder_attention_heads=4,
    embed_dim=32,
    dropout=0.0,
    attention_dropout=0.0,
    encoder_layerdrop=0.0,
    dropout_input=0.0,
)
INT8_REL = 1e-3
ATTENTION = pytest.mark.parametrize("use_pallas", [None, True], ids=["plain", "pallas"])


def _carry(jax_model):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.variables["params"]))


def build(init_config, compute_dtype="float32", seed=3):
    """(JAX model, port model on the CPU) with the same float weights."""
    jax_model = avex_tpu.build_model_from_spec(
        JaxModelSpec(name="beats", pretrained=False, init_config=init_config, compute_dtype=compute_dtype),
        seed=seed, return_features_only=True,
    )
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="beats", pretrained=False, init_config=init_config, compute_dtype=compute_dtype),
        device="cpu", return_features_only=True,
    )
    port.load_port_state_dict(_carry(jax_model), strict=True)
    return jax_model, port


def carried_int8(jax_model, init_config, compute_dtype="float32"):
    """A port model built quantized, loaded with the tree JAX quantized."""
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="beats", pretrained=False, compute_dtype=compute_dtype,
                  init_config=dict(init_config, quantize_encoder=True)),
        device="cpu", return_features_only=True,
    )
    state = _carry(jax_model)
    assert set(state) == set(port.state_dict()), set(state) ^ set(port.state_dict())
    port.load_port_state_dict(state, strict=True)
    return port


def forward_pair(jax_model, port, wav):
    out_j, aux_j = jax_model.module.apply(jax_model.variables, wav, None, deterministic=True,
                                          disable_layerdrop=True)
    with torch.no_grad():
        out_t, aux_t = port.module(torch.from_numpy(wav))
    return (out_j, aux_j), (out_t, aux_t)


@pytest.fixture
def wav(rng):
    return (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)


@ATTENTION
def test_quantized_forward_matches_jax(wav, use_pallas):
    """Both port routes against JAX's quantized BEATs: features, pooled and
    every intermediate, fp32."""
    config = dict(TINY, use_pallas=use_pallas)
    jax_model, port = build(config)
    port.quantize("int8")
    jax_model.quantize("int8")
    carried = carried_int8(jax_model, config)
    (out_j, aux_j), (out_t, aux_t) = forward_pair(jax_model, port, wav)
    with torch.no_grad():
        out_c, _ = carried.module(torch.from_numpy(wav))
    assert out_t.shape == (2, 48, 64)
    assert _rel(out_t, out_j) <= INT8_REL
    assert _rel(out_c, out_j) <= INT8_REL
    assert _rel(aux_t["pooled"], aux_j["pooled"]) <= INT8_REL
    for name, want in aux_j["intermediates"].items():
        assert _rel(aux_t["intermediates"][name], want) <= INT8_REL, name


def test_both_routes_give_identical_int8_weights():
    """Quantizing carried float weights in the port, and carrying the tree
    JAX quantized: identical ``weight_q``, equal ``weight_scale``."""
    jax_model, port = build(TINY)
    port.quantize("int8")
    jax_model.quantize("int8")
    carried = carried_int8(jax_model, TINY).state_dict()
    own = port.state_dict()
    assert set(own) == set(carried)
    quantized = [k for k in own if k.endswith((".weight_q", ".weight_scale"))]
    assert len(quantized) == 2 * len(ENCODER_QUANT_DENSES) * TINY["encoder_layers"]
    for key in own:
        assert own[key].dtype == carried[key].dtype, key
        assert torch.equal(own[key], carried[key]), key


def test_quantize_beats_params_selects_the_encoder_denses():
    """Only the encoder's q/k/v/out projections and fc1/fc2 become int8 (as
    ``avex_tpu/models/beats.py:900-918``): post_extract_proj, grep_linear,
    the AudioSet predictor and the classifier stay float."""
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="beats", pretrained=False, init_config=dict(TINY, finetuned_model=True, predictor_class=5)),
        device="cpu", num_classes=3,
    )
    quantize_beats_params(port.module)
    kinds = {name: type(m) for name, m in port.module.named_modules() if isinstance(m, (nn.Linear, Int8Linear))}
    int8 = sorted(name for name, kind in kinds.items() if kind is Int8Linear)
    assert int8 == sorted(
        f"backbone.encoder.layers.{i}.{sub}"
        for i in range(TINY["encoder_layers"])
        for sub in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.out_proj", "fc1", "fc2")
    )
    assert {name.rsplit(".", 1)[-1] for name in int8} == ENCODER_QUANT_DENSES
    for name in ("backbone.post_extract_proj", "backbone.predictor", "classifier",
                 "backbone.encoder.layers.0.self_attn.grep_linear"):
        assert kinds[name] is nn.Linear, name


def test_quantized_extract_embeddings_matches_jax(wav):
    jax_model, port = build(dict(TINY, use_pallas=True))
    for model in (jax_model, port):
        model.quantize("int8")
        model.register_hooks_for_layers(["all"])
    want = np.asarray(jax_model.extract_embeddings(wav, aggregation="mean"))
    got = port.extract_embeddings(wav, aggregation="mean")
    assert got.shape == want.shape == (2, 3 * 64)
    assert _rel(got, want) <= INT8_REL


def test_quantized_bf16_matches_jax(wav):
    jax_model, port = build(dict(TINY, use_pallas=True), compute_dtype="bfloat16")
    port.quantize("int8")
    jax_model.quantize("int8")
    (out_j, aux_j), (out_t, aux_t) = forward_pair(jax_model, port, wav)
    assert out_t.dtype == torch.bfloat16
    assert _rel(aux_t["pooled"], aux_j["pooled"]) <= BF16_POOLED_REL


def test_quantize_quality_idempotence_and_float_parts(wav):
    """int8 vs float with the same weights within JAX's 5e-2; the encoder
    denses become Int8Linear under their names; grep_linear, the patch
    embedding, pos_conv and the rel-pos table stay float; a second call is a
    no-op."""
    _, port = build(TINY)
    port.register_hooks_for_layers(["last_layer"])
    f_feats = _np(port(wav))
    f_emb = _np(port.extract_embeddings(wav, aggregation="mean"))
    port.quantize("int8")
    q_feats = _np(port(wav))
    assert _rel(q_feats, f_feats) < 5e-2
    assert _rel(port.extract_embeddings(wav, aggregation="mean"), f_emb) < 5e-2

    layer0 = port.module.backbone.encoder.layers[0]
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        assert isinstance(getattr(layer0.self_attn, name), Int8Linear)
    assert isinstance(layer0.fc1, Int8Linear) and isinstance(layer0.fc2, Int8Linear)
    assert layer0.fc1.weight_q.dtype == torch.int8
    assert type(layer0.self_attn.grep_linear) is nn.Linear
    backbone = port.module.backbone
    assert backbone.patch_embedding.weight.dtype == torch.float32
    assert backbone.encoder.pos_conv.weight.dtype == torch.float32
    assert backbone.encoder.relative_attention_bias.weight.dtype == torch.float32
    assert port.cfg.quantize_encoder

    port.quantize("int8")
    np.testing.assert_array_equal(_np(port(wav)), q_feats)


def test_quantize_rejects_unknown_mode_and_fused_qkv():
    _, port = build(TINY)
    with pytest.raises(ValueError, match="quantization mode"):
        port.quantize("int4")
    _, fused = build(dict(TINY, fused_qkv=True))
    with pytest.raises(ValueError, match="fused_qkv"):
        fused.quantize("int8")


def test_load_model_int8(wav):
    """``load_model(quantization="int8")`` is the float model, quantized;
    another mode raises as in JAX."""
    spec = ModelSpec(name="beats", pretrained=False, init_config=TINY)
    model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cpu",
                                      quantization="int8")
    manual = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cpu")
    manual.quantize("int8")
    assert model.cfg.quantize_encoder
    np.testing.assert_array_equal(_np(model(wav)), _np(manual(wav)))
    with pytest.raises(ValueError, match="quantization mode"):
        avex_tpu_torch.load_model(spec, random_weights=True, device="cpu", quantization="int4")


@pytest.mark.parametrize(
    "spec, kwargs",
    [
        (ModelSpec(name="eat_hf", pretrained=False, init_config=dict(depth=2, target_length=64),
                   eat_norm_mean=-5.553, eat_norm_std=4.606), {}),
        (ModelSpec(name="aves_bio", pretrained=False), dict(aves_cfg=AVES_TINY)),
    ],
    ids=["eat", "aves"],
)
def test_quantize_unsupported_architectures_raise(spec, kwargs):
    """As ``ModelBase.quantize`` (``avex_tpu/models/base.py:316-323``): only
    BEATs has an int8 mode."""
    model = avex_tpu_torch.build_model_from_spec(spec, device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match="quantization"):
        model.quantize("int8")
    with pytest.raises(NotImplementedError, match="quantization"):
        avex_tpu_torch.load_model(spec, random_weights=True, device="cpu", quantization="int8", **kwargs)
