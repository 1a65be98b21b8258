"""Probes in the PyTorch port against the JAX package, with the same weights.

Each head is built offline in both packages from the same ``ProbeConfig``,
the JAX parameters carried across with ``probes.params_from_jax``, and the
logits compared on the same seeded embeddings (dropout 0). Multi-layer
inputs of different widths and lengths take the projectors, the learned
layer weights and the antialiased sequence alignment (``jax.image.resize``'s
linear method, which ``F.interpolate`` does not match when it shrinks).
Then the plan, the masked attention row, the factory's checks, the weight
table and ``embedding_shapes`` of tiny BEATs, EAT and AVES.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import ProbeConfig as JaxProbeConfig
from avex_tpu.probes import build_probe_from_config as jax_build_probe
from avex_tpu.probes import make_probe_plan as jax_make_probe_plan

import avex_tpu_torch
from avex_tpu_torch.configs import PROBE_CONFIGS, ModelSpec, ProbeConfig
from avex_tpu_torch.probes import build_probe_from_config, make_probe_plan, params_from_jax
from avex_tpu_torch.probes.base import linear_resize_matrix
from avex_tpu_torch.probes.heads import attention_mask
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

FP32_TOL = dict(atol=5e-5, rtol=1e-4)
NUM_CLASSES = 5

BEATS_TINY = {
    "encoder_layers": 2, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 96,
    "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0,
    "attention_dropout": 0.0, "encoder_layerdrop": 0.0,
}
RAW_AUDIO = {"representation": "raw", "normalize": False, "target_length_seconds": 1}
EAT_TINY = dict(depth=2, dim=128, heads=2, target_length=64)
AVES_TINY = {"encoder_num_layers": 2, "encoder_embed_dim": 128, "encoder_num_heads": 2,
             "encoder_ff_interm_features": 256}

# Every head with dropout 0; sequence heads over three layers: two of 13 steps
# and one of 7 (aligned by the antialiased resize), one of them 10 wide
# (projected to the majority width 12).
HEADS = {
    "linear": dict(probe_type="linear"),
    "mlp": dict(probe_type="mlp", hidden_dims=[16, 8], dropout_rate=0.0, activation="gelu"),
    "moe": dict(probe_type="moe", num_experts=4, moe_hidden_dim=8, moe_k=2, capacity_factor=4.0, dropout_rate=0.0),
    "lstm": dict(probe_type="lstm", aggregation="none", lstm_hidden_size=6, num_layers=2, bidirectional=True,
                 dropout_rate=0.0),
    "attention": dict(probe_type="attention", aggregation="none", num_heads=3, num_layers=2, dropout_rate=0.0,
                      use_positional_encoding=True),
    "transformer": dict(probe_type="transformer", aggregation="none", num_heads=4, num_layers=2,
                        attention_dim=24, dropout_rate=0.0, use_positional_encoding=True, max_sequence_length=20),
}
SEQUENCE_DIMS = [(13, 12), (13, 10), (7, 12)]
POOLED_DIMS = [(12,), (12,), (10,)]


def _fields(plan):
    return (plan.expected_dim, plan.input_shapes, plan.target_feat, plan.needs_projector, plan.target_seq)


def _pair(config, input_dim, seed=0):
    """(JAX probe, port probe on the CPU) with the same parameters."""
    jax_probe = jax_build_probe(JaxProbeConfig(**config), num_classes=NUM_CLASSES, input_dim=input_dim, seed=seed)
    port = build_probe_from_config(config, num_classes=NUM_CLASSES, input_dim=input_dim, device="cpu", seed=seed)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_probe.variables["params"]))
    own = port.module.state_dict()
    assert set(state) == set(own), set(state) ^ set(own)
    port.module.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return jax_probe, port


@pytest.mark.parametrize("name", list(HEADS))
def test_head_matches_jax(name):
    config = HEADS[name]
    dims = SEQUENCE_DIMS if config.get("aggregation") == "none" else POOLED_DIMS
    jax_probe, port = _pair(config, dims)
    rng = np.random.default_rng(1)
    embs = [rng.standard_normal((3,) + d).astype(np.float32) for d in dims]
    want = np.asarray(jax_probe(embs))
    got = port([torch.from_numpy(e) for e in embs])
    assert got.shape == (3, NUM_CLASSES)
    np.testing.assert_allclose(got.detach().numpy(), want, **FP32_TOL)


def test_probenet_projectors_layer_weights_and_a_4d_layer():
    """Non-zero learned layer weights mix a (C, H, W) layer (→ W steps of
    H·C) with a longer (T, F) one, shrunk to W steps; a bf16 input is
    cast to fp32 first."""
    dims = [(2, 3, 9), (20, 6), (9, 6)]
    config = dict(HEADS["attention"], use_positional_encoding=False)
    jax_probe, port = _pair(config, dims)
    assert _fields(port.plan) == _fields(jax_probe.plan) and port.plan.needs_projector == (False, True, False)
    weights = np.array([0.3, -1.2, 0.7], np.float32)
    jax_probe.variables = {"params": {**jax_probe.variables["params"], "layer_weights": jnp.asarray(weights)}}
    with torch.no_grad():
        port.module.layer_weights.copy_(torch.from_numpy(weights))
    rng = np.random.default_rng(2)
    embs = [rng.standard_normal((2,) + d).astype(np.float32) for d in dims]
    np.testing.assert_allclose(port([torch.from_numpy(e) for e in embs]).detach().numpy(),
                               np.asarray(jax_probe(embs)), **FP32_TOL)
    bf16 = [torch.from_numpy(e).bfloat16() for e in embs]
    np.testing.assert_allclose(port(bf16).detach().numpy(),
                               np.asarray(jax_probe([jnp.asarray(e.float().numpy()) for e in bf16])), **FP32_TOL)


@pytest.mark.parametrize("sizes", [(13, 7), (248, 100), (31, 30), (7, 13), (5, 5)])
def test_sequence_alignment_is_jax_image_resize(sizes):
    """The resize matrix equals ``jax.image.resize(method="linear")`` (which
    antialiases when shrinking); ``F.interpolate`` differs when it shrinks."""
    t_in, t_out = sizes
    x = np.random.default_rng(3).standard_normal((2, t_in, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, t_out, 3), method="linear"))
    got = np.einsum("ot,btf->bof", linear_resize_matrix(t_in, t_out), x)
    np.testing.assert_allclose(got, want, **FP32_TOL)
    if t_out < t_in // 2:
        interp = F.interpolate(torch.from_numpy(x).transpose(1, 2), size=t_out, mode="linear",
                               align_corners=False).transpose(1, 2).numpy()
        assert np.abs(interp - want).max() > 0.1


@pytest.mark.parametrize("head", ["attention", "transformer"])
def test_fully_masked_item_attends_uniformly(head):
    """flax fills masked logits with the fp32 minimum: an item whose steps are
    all padded attends uniformly (finite logits), as in JAX."""
    config = dict(HEADS[head], use_positional_encoding=False)
    jax_probe, port = _pair(config, (6, 12))
    rng = np.random.default_rng(4)
    embs = rng.standard_normal((3, 6, 12)).astype(np.float32)
    mask = np.zeros((3, 6), bool)
    mask[1, 4:] = True
    mask[2, :] = True  # every step padded
    want = np.asarray(jax_probe.module.apply(jax_probe.variables, [jnp.asarray(embs)], jnp.asarray(mask)))
    got = port(torch.from_numpy(embs), torch.from_numpy(mask)).detach().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **FP32_TOL)
    # uniform weights: each head's output is the mean of its values
    attention = port.module.head.attention_0 if head == "attention" else port.module.head.block_0_attn
    x = torch.from_numpy(embs[2:])
    with torch.no_grad():
        out = attention(x, attention_mask(torch.from_numpy(mask[2:]), 6))
        uniform = attention.out(attention.value(x).mean(dim=1, keepdim=True)).expand_as(out)
    torch.testing.assert_close(out, uniform, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("shapes", [
    (2, [(64,), (64,), (32,)]), (2, [(64,), (32,)]), (2, [(4, 8), (32,)]),
    (3, [(10, 64), (20, 64)]), (3, [(10, 64), (10, 32), (20, 64)]), (3, [(2, 3, 9), (9, 6)]), (3, [(16,), (4, 8)]),
])
def test_probe_plan_matches_jax(shapes):
    expected, dims = shapes
    plan, want = make_probe_plan(expected, dims), jax_make_probe_plan(expected, dims)
    assert _fields(plan) == _fields(want)


def test_plan_majority_max_and_sequence_target():
    plan = make_probe_plan(2, [(64,), (64,), (32,)])
    assert plan.target_feat == 64 and plan.needs_projector == (False, False, True)
    assert make_probe_plan(2, [(64,), (32,)]).target_feat == 64  # no majority: the maximum
    plan = make_probe_plan(3, [(10, 64), (20, 64)])
    assert plan.target_feat == 64 and plan.target_seq == 10


def test_online_xor_offline_and_config_checks():
    with pytest.raises(ValueError, match="exactly one"):
        build_probe_from_config(ProbeConfig(), num_classes=2)
    with pytest.raises(ValueError, match="exactly one"):
        build_probe_from_config(ProbeConfig(), num_classes=2, base_model=object(), input_dim=3)
    with pytest.raises(TypeError):
        ProbeConfig(not_a_field=1)
    for bad in (dict(probe_type="svm"), dict(aggregation="sum"), dict(dropout_rate=1.5),
                dict(target_layers=[True]), dict(activation="elu"), dict(input_processing="x")):
        with pytest.raises(ValueError):
            ProbeConfig(**bad)
    assert build_probe_from_config(PROBE_CONFIGS["mlp"].to_dict(), num_classes=3, input_dim=8,
                                   device="cpu").module.head.num_hidden == 2
    from avex_tpu_torch.probes import list_probe_classes
    assert set(list_probe_classes()) == {"linear", "mlp", "lstm", "attention", "transformer", "moe"}


def test_offline_probe_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_probe_from_config(ProbeConfig(), num_classes=2, input_dim=8)


def test_learned_weights_table_text_matches_jax():
    jax_probe, port = _pair(dict(probe_type="linear"), [(8,), (8,), (8,)])
    raw = np.array([0.25, -0.5, 1.0], np.float32)
    jax_probe.variables = {"params": {**jax_probe.variables["params"], "layer_weights": jnp.asarray(raw)}}
    with torch.no_grad():
        port.module.layer_weights.copy_(torch.from_numpy(raw))
    assert port.get_learned_weights_table() == jax_probe.get_learned_weights_table()
    single_j, single = _pair(dict(probe_type="linear"), 8)
    assert single.get_learned_weights_table() == single_j.get_learned_weights_table()
    assert "does not use weighted sum" in single.get_learned_weights_table()


def _backbones():
    """(JAX model, port model on the CPU) for tiny BEATs, EAT and AVES."""
    yield "beats", avex_tpu.build_model_from_spec(JaxModelSpec(
        name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW_AUDIO)), \
        avex_tpu_torch.build_model_from_spec(ModelSpec(
            name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW_AUDIO, device="cpu"))
    yield "eat", avex_tpu.build_model_from_spec(JaxModelSpec(name="eat_hf", pretrained=False, init_config=EAT_TINY)), \
        avex_tpu_torch.build_model_from_spec(ModelSpec(name="eat_hf", pretrained=False, init_config=EAT_TINY,
                                                       device="cpu"))
    aves = dict(aves_cfg=AVES_TINY, return_features_only=True)
    yield "aves", avex_tpu.build_model_from_spec(JaxModelSpec(name="aves_bio", pretrained=False), **aves), \
        avex_tpu_torch.build_model_from_spec(ModelSpec(name="aves_bio", pretrained=False), device="cpu", **aves)


def test_embedding_shapes_match_jax():
    for name, jax_model, port in _backbones():
        for layers in (["last_layer"], ["all"], [0, -1]):
            for aggregation in ("none", "mean"):
                jax_model.register_hooks_for_layers(layers)
                port.register_hooks_for_layers(layers)
                want = jax_model.embedding_shapes((1, 16000), aggregation=aggregation)
                assert port.embedding_shapes((1, 16000), aggregation=aggregation) == want, (name, layers, aggregation)
        assert port.embedding_shapes((3, 8000), aggregation="none") == jax_model.embedding_shapes(
            (3, 8000), aggregation="none"), name


def test_online_probe_over_tiny_beats_matches_jax():
    """A frozen online attention probe on two BEATs layers: the logits of raw
    audio, and no gradient reaches the backbone."""
    jax_model = avex_tpu.build_model_from_spec(JaxModelSpec(
        name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW_AUDIO))
    port_model = avex_tpu_torch.build_model_from_spec(ModelSpec(
        name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW_AUDIO, device="cpu"))
    from avex_tpu_torch.models.beats import params_from_jax as beats_params
    port_model.load_port_state_dict(beats_params(jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])),
                                    strict=True)
    config = dict(probe_type="attention", aggregation="none", target_layers=[1, "last_layer"], num_heads=4,
                  num_layers=1, dropout_rate=0.0)
    jax_probe = jax_build_probe(JaxProbeConfig(**config), num_classes=3, base_model=jax_model)
    port = build_probe_from_config(config, num_classes=3, base_model=port_model)
    assert port.device == torch.device("cpu") and _fields(port.plan) == _fields(jax_probe.plan)
    port.module.load_state_dict({k: torch.tensor(v) for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_probe.variables["params"])).items()})
    wav = (np.random.default_rng(5).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    logits = port(wav)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jax_probe(wav)), **FP32_TOL)
    logits.sum().backward()
    assert all(p.grad is None for p in port_model.module.parameters())
    assert port.module.layer_weights.grad is not None
