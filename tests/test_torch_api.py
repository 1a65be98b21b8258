"""Public API of the port: registry, factory, load_model, embedding extraction,
held against the JAX package with the same weights."""

import json

import numpy as np
import pytest
import torch

import avex_tpu

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from tests.test_torch_beats import FP32_TOL, TINY, build_pair

SMALL = {k: v for k, v in TINY.items() if k != "use_pallas"}


def _spec(**init):
    return ModelSpec(
        name="beats",
        pretrained=False,
        init_config=dict(TINY, **init),
        audio_config={"representation": "raw", "normalize": False},
    )


def test_public_api_exports():
    for name in avex_tpu.__all__:
        assert hasattr(avex_tpu_torch, name), name


def test_registry_holds_the_official_beats_models():
    info = avex_tpu_torch.list_models(verbose=False)
    assert {"esp_aves2_sl_beats_all", "esp_aves2_sl_beats_bio", "esp_aves2_naturelm_audio_v1_beats"} <= set(info)
    assert all(row["architecture"] in ("beats", "eat_hf") for row in info.values() if row["checkpoint"])
    spec = avex_tpu_torch.get_model_spec("esp_aves2_sl_beats_all")
    spec.pretrained = True
    assert avex_tpu_torch.get_model_spec("esp_aves2_sl_beats_all").pretrained is False
    assert avex_tpu_torch.describe_model("esp_aves2_sl_beats_all")["model_spec"]["init_config"] == (
        avex_tpu.describe_model("esp_aves2_sl_beats_all")["model_spec"]["init_config"]
    )
    with pytest.raises(KeyError, match="not found"):
        avex_tpu_torch.get_model_spec("nonexistent_model")
    with pytest.raises(KeyError, match="No model class"):
        avex_tpu_torch.get_model_class("efficientnet")


def test_build_and_load_random_weights_on_cpu():
    model = avex_tpu_torch.build_model_from_spec(_spec(), device="cpu", num_classes=3)
    wav = np.random.default_rng(0).standard_normal((2, 16000)).astype(np.float32) * 0.1
    assert model(wav).shape == (2, 3)
    assert model.device.type == "cpu"
    chunks = model.batch_inference([wav[:1], wav[1:]])
    np.testing.assert_allclose(chunks.numpy(), model(wav).numpy(), atol=1e-5, rtol=1e-5)

    avex_tpu_torch.register_model("tiny_beats_port_test", _spec(), overwrite=True)
    loaded = avex_tpu_torch.load_model("tiny_beats_port_test", device="cpu", random_weights=True,
                                       return_features_only=True)
    assert loaded.num_classes is None
    assert loaded(wav).shape == (2, 48, 96)
    assert avex_tpu_torch.list_model_layers("tiny_beats_port_test", device="cpu") == [
        "backbone.post_extract_proj",
        "backbone.encoder.layers.0.fc2",
        "backbone.encoder.layers.1.fc2",
    ]


def test_layer_selection():
    model = avex_tpu_torch.build_model_from_spec(_spec(), device="cpu")
    layers = model.get_model_layers()
    assert model.register_hooks_for_layers([0]) == ["backbone.post_extract_proj"]
    assert model.register_hooks_for_layers([-1]) == [layers[-1]]
    assert model.register_hooks_for_layers([1, -1, 1]) == layers[1:]
    assert model.register_hooks_for_layers(["last_layer"]) == ["backbone.encoder.layers.1.fc2"]
    assert model.register_hooks_for_layers(["all"]) == layers
    with pytest.raises(TypeError):
        model.register_hooks_for_layers([True])
    with pytest.raises(ValueError):
        model.register_hooks_for_layers([7])
    with pytest.raises(ValueError):
        model.register_hooks_for_layers(["not_a_layer"])
    model.deregister_all_hooks()
    with pytest.raises(ValueError, match="No hooks registered"):
        model.extract_embeddings(np.zeros((1, 16000), np.float32))


@pytest.mark.parametrize("aggregation", ["none", "mean", "max"])
def test_extract_embeddings_matches_jax(rng, aggregation):
    jax_model, port = build_pair(TINY, return_features_only=True)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    for model in (jax_model, port):
        model.register_hooks_for_layers(["all"])
    want = jax_model.extract_embeddings(wav, aggregation=aggregation)
    got = port.extract_embeddings(wav, aggregation=aggregation)
    if aggregation == "none":
        assert isinstance(got, list) and len(got) == len(want) == 3
    else:
        assert got.shape == (2, 3 * 96)
        got, want = [got], [want]
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FP32_TOL)


def _reference_checkpoint(rng, num_classes):
    """A randomly initialised checkpoint in the reference torch layout:
    weight-normed pos_conv (``pos_conv.0.weight_g/_v``), every layer aliasing
    the rel-pos table, wrapper-level ``backbone.`` keys and a classifier."""
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="beats", pretrained=False, init_config=SMALL), device="cpu"
    )
    state = {}
    for key, value in port.state_dict().items():
        arr = (rng.standard_normal(tuple(value.shape)) * 0.05).astype(np.float32)
        if "norm" in key and key.endswith("weight"):
            arr = 1.0 + arr
        if key.endswith("pos_conv.weight"):
            state["backbone.encoder.pos_conv.0.weight_v"] = arr
            state["backbone.encoder.pos_conv.0.weight_g"] = rng.uniform(0.5, 1.5, (1, 1, arr.shape[2])).astype(np.float32)
        elif key.endswith("pos_conv.bias"):
            state["backbone.encoder.pos_conv.0.bias"] = arr
        elif key.endswith("relative_attention_bias.weight"):
            for i in range(SMALL["encoder_layers"]):
                state[f"backbone.encoder.layers.{i}.self_attn.relative_attention_bias.weight"] = arr
        else:
            state[key] = arr
    state["classifier.weight"] = (rng.standard_normal((num_classes, 96)) * 0.1).astype(np.float32)
    state["classifier.bias"] = np.zeros(num_classes, np.float32)
    return state


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_reference_checkpoint_loads_like_jax(tmp_path, rng, fmt):
    num_classes = 4
    state = _reference_checkpoint(rng, num_classes)
    ckpt = tmp_path / f"model.{fmt}"
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(state, str(ckpt))
    else:
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}}, ckpt)
    label_map = {str(i): f"species_{i}" for i in range(num_classes)}
    (tmp_path / "label_map.json").write_text(json.dumps(label_map))
    spec_yaml = tmp_path / "spec.yml"
    spec_yaml.write_text(
        "\n".join(
            [
                f"checkpoint_path: {ckpt}",
                f"class_mapping_path: {tmp_path / 'label_map.json'}",
                "model_spec:",
                "  name: beats",
                "  pretrained: false",
                "  init_config:",
            ]
            + [f"    {k}: {v}" for k, v in SMALL.items()]
        )
    )

    jax_model = avex_tpu.load_model(str(spec_yaml))
    port = avex_tpu_torch.load_model(str(spec_yaml), device="cpu")
    assert port.num_classes == jax_model.num_classes == num_classes
    assert port.label_mapping == label_map

    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(port(wav).numpy(), np.asarray(jax_model(wav)), **FP32_TOL)
    for model in (jax_model, port):
        model.register_hooks_for_layers(["all"])
    np.testing.assert_allclose(
        port.extract_embeddings(wav, aggregation="mean").numpy(),
        np.asarray(jax_model.extract_embeddings(wav, aggregation="mean")),
        **FP32_TOL,
    )


def test_remote_checkpoint_raises_clearly():
    with pytest.raises(ValueError, match="remote URI"):
        avex_tpu_torch.load_model("esp_aves2_sl_beats_all", device="cpu")
    model = avex_tpu_torch.load_model("esp_aves2_sl_beats_all", device="cpu", random_weights=True,
                                      init_config=dict(SMALL, finetuned_model=True))
    assert model.label_mapping is None and model.num_classes is None


EAT_TINY = {"depth": 2, "dim": 96, "heads": 12, "target_length": 64}
AVES_TINY = {"encoder_num_layers": 2, "encoder_embed_dim": 128, "encoder_num_heads": 2,
             "encoder_ff_interm_features": 256}
EAT_OFFICIAL = ("esp_aves2_eat_all", "esp_aves2_eat_bio", "esp_aves2_sl_eat_all_ssl_all", "esp_aves2_sl_eat_bio_ssl_all")


def test_registry_holds_the_official_eat_models():
    info = avex_tpu_torch.list_models(verbose=False)
    assert set(EAT_OFFICIAL) <= set(info)
    for name in EAT_OFFICIAL:
        assert info[name]["architecture"] == "eat_hf"
        assert info[name]["checkpoint"] == avex_tpu.get_checkpoint_path(name)
        spec = avex_tpu_torch.get_model_spec(name)
        assert (spec.eat_norm_mean, spec.eat_norm_std) == (-5.553, 4.606)
    assert set(avex_tpu_torch.list_model_classes()) >= {"beats", "eat_hf", "aves_bio"}


def test_build_model_expands_init_config_for_eat():
    """EAT's wrapper takes its architecture as direct arguments: the factory
    expands ``init_config`` into them (as the JAX factory does) and forwards
    the spec's fbank statistics."""
    model = avex_tpu_torch.build_model("esp_aves2_eat_all", device="cpu", init_config=EAT_TINY)
    assert model.depth == 2 and len(model.module.blocks) == 2
    assert (model.module.norm_mean, model.module.norm_std) == (-5.553, 4.606)
    assert model.get_model_layers() == [f"backbone.model.blocks.{i}.attn.proj" for i in range(2)]
    wav = np.random.default_rng(0).standard_normal((2, 16000)).astype(np.float32) * 0.1
    assert model(wav).shape == (2, 33, 96)
    # an explicit argument wins over the same key in init_config
    assert avex_tpu_torch.build_model("esp_aves2_eat_all", device="cpu", init_config=EAT_TINY, depth=1).depth == 1


@pytest.mark.parametrize("arch", ["eat", "aves"])
def test_load_model_random_weights_builds_eat_and_aves(rng, arch):
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    if arch == "eat":
        model = avex_tpu_torch.load_model("esp_aves2_sl_eat_all_ssl_all", device="cpu", random_weights=True,
                                          return_features_only=True, init_config=EAT_TINY)
        layers, width = 2, 96
    else:
        spec = ModelSpec(name="aves_bio", pretrained=False, init_config={"aves_cfg": AVES_TINY})
        model = avex_tpu_torch.load_model(spec, device="cpu", random_weights=True, return_features_only=True)
        layers, width = 2, 128
    assert model.label_mapping is None and model.num_classes is None
    model.register_hooks_for_layers(["all"])
    emb = model.extract_embeddings(wav, aggregation="mean")
    assert emb.shape == (2, layers * width) and torch.isfinite(emb).all()
