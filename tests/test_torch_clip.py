"""CLIP/CLAP in the PyTorch port against the JAX package, with the same weights.

The JAX package's own test spec (``tests/unittests/test_clip.py``):
projection 64, a 2-layer text tower of width 64 (4 heads, vocabulary 1024),
the full EfficientNet-B0 audio tower, 64-mel spectrograms of 0.5 s clips.
JAX's variables, their BatchNorm statistics moved off 0/1, are carried
across with ``models.clip.params_from_jax``. RoBERTa alone runs at
roberta-base width (768, 12 heads, 3072) on padded token rows. Both
packages take the offline ``SimpleTokenizer`` here (no cached tokenizer).
In the train-mode step stochastic depth keeps every item on both sides
(``jax.random.bernoulli`` and the port's ``stochastic_depth_mask`` forced
to keep), so the two steps see the same network.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.models.clip import RobertaEncoder as JaxRoberta
from avex_tpu.models.clip import SimpleTokenizer as JaxSimpleTokenizer
from avex_tpu.models.clip import convert_roberta_state_dict as jax_convert_roberta
from avex_tpu.training.losses import clip_loss as jax_clip_loss
from avex_tpu.training.strategies import CLIPStrategy as JaxCLIPStrategy

import avex_tpu_torch
import avex_tpu_torch.run_train as run_train
from avex_tpu_torch.configs import ModelSpec, RunConfig, TrainingParams
from avex_tpu_torch.models import clip
from avex_tpu_torch.models import efficientnet as eff
from avex_tpu_torch.training import Trainer, clip_loss, make_strategy
from avex_tpu_torch.training.strategies import CLIPStrategy
from tests.test_torch_beats import BF16_POOLED_REL, FP32_TOL, _np, _rel
from tests.test_torch_efficientnet import _moved_stats, _tree
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

TEXT_TOWER = {"layers": 2, "dim": 64, "heads": 4, "ffn_dim": 128, "vocab_size": 1024}
AUDIO = {"n_fft": 400, "hop_length": 160, "win_length": 400, "n_mels": 64, "representation": "mel_spectrogram",
         "normalize": True}
TEXTS = ["a dog barking", "bird song at dawn", "an insect chirp", "frog"]
TRAIN_GRAD_REL = 1e-3  # the train-mode step's gradients, global rel L2 (see its test)
ROBERTA_BASE = dict(vocab_size=1000, dim=768, layers=2, heads=12, ffn_dim=3072, max_positions=514)


def _spec(**overrides):
    spec = dict(name="clip", pretrained=False, text_model_name="roberta-base", projection_dim=64,
                temperature=0.07, extra_config={"text_encoder": dict(TEXT_TOWER)}, audio_config=dict(AUDIO))
    return dict(spec, **overrides)


@functools.lru_cache(maxsize=None)
def _jax_clip(compute_dtype="float32"):
    model = avex_tpu.build_model_from_spec(JaxModelSpec(**_spec(compute_dtype=compute_dtype)))
    model.variables = _moved_stats(model.variables)
    return model


def clip_pair(compute_dtype="float32"):
    """(JAX model, port model on the CPU): the same weights and statistics."""
    jax_model = _jax_clip(compute_dtype)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(**_spec(compute_dtype=compute_dtype)), device="cpu")
    state = clip.params_from_jax(jax_model.variables)
    own = {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(state) == own, set(state) ^ own
    port.load_port_state_dict(state, strict=True)
    return jax_model, port


def _wav(seed, batch=4, samples=8000):
    return (np.random.default_rng(seed).standard_normal((batch, samples)) * 0.1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_apply(compute_dtype="float32"):
    module = _jax_clip(compute_dtype).module
    return jax.jit(lambda variables, spec, tokens: module.apply(variables, spec, tokens, deterministic=True))


def test_simple_tokenizer_ids_equal_jax():
    texts = ["A Dog  barking", "", "ÜBER straße naïve", " ".join(f"w{i}" for i in range(100)), "frog"]
    for vocab in (1024, 50265):
        got, want = clip.SimpleTokenizer(vocab)(texts), JaxSimpleTokenizer(vocab)(texts)
        assert got.dtype == want.dtype == np.int32 and got.shape == want.shape == (5, clip.MAX_TEXT_LEN)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(clip.SimpleTokenizer(vocab)(texts[:1], max_length=4),
                                      JaxSimpleTokenizer(vocab)(texts[:1], max_length=4))


def _roberta_pair(compute_dtype="float32"):
    dtype = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    jax_module = JaxRoberta(dtype=dtype, **ROBERTA_BASE)
    variables = jax.jit(jax_module.init)(jax.random.PRNGKey(4), jnp.ones((1, 5), jnp.int32))
    port = clip.RobertaEncoder(dtype=torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32,
                               **ROBERTA_BASE)
    state = clip.roberta_params_from_jax(_tree(variables["params"]))
    assert set(state) == set(port.state_dict())
    port.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
    return jax_module, variables, port


def _padded_ids(seed=6):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 1000, (3, 12)).astype(np.int32)
    ids[:, 0] = 0
    for row, length in enumerate((12, 7, 3)):
        ids[row, length - 1] = 2
        ids[row, length:] = 1  # pad
    return ids


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_roberta_at_roberta_base_width_matches_jax(compute_dtype):
    jax_module, variables, port = _roberta_pair(compute_dtype)
    ids = _padded_ids()
    want = jax.jit(jax_module.apply)(variables, ids)
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long())
    assert got.shape == (3, 12, 768)
    if compute_dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)
    else:
        assert got.dtype == torch.bfloat16 and _rel(got[:, 0], want[:, 0]) <= BF16_POOLED_REL


@pytest.mark.parametrize("prefix", ["", "roberta."])
def test_roberta_hf_converter_matches_jax(prefix):
    """An HF-named state dict built from JAX's parameters goes through both
    converters; the port's result equals JAX's, carried across."""
    _, variables, port = _roberta_pair()
    params = _tree(variables["params"])
    state = {}
    emb = f"{prefix}embeddings"
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        state[f"{emb}.{name}.weight"] = params[name]["embedding"]
    state[f"{emb}.LayerNorm.weight"] = params["emb_layer_norm"]["scale"]
    state[f"{emb}.LayerNorm.bias"] = params["emb_layer_norm"]["bias"]
    hf = {"q": "attention.self.query", "k": "attention.self.key", "v": "attention.self.value",
          "attn_out": "attention.output.dense", "ff1": "intermediate.dense", "ff2": "output.dense"}
    for i in range(ROBERTA_BASE["layers"]):
        base = f"{prefix}encoder.layer.{i}"
        for name, hf_name in hf.items():
            state[f"{base}.{hf_name}.weight"] = params[f"layer_{i}_{name}"]["kernel"].T
            state[f"{base}.{hf_name}.bias"] = params[f"layer_{i}_{name}"]["bias"]
        for name, hf_name in (("attn_ln", "attention.output.LayerNorm"), ("ff_ln", "output.LayerNorm")):
            state[f"{base}.{hf_name}.weight"] = params[f"layer_{i}_{name}"]["scale"]
            state[f"{base}.{hf_name}.bias"] = params[f"layer_{i}_{name}"]["bias"]
    got = clip.convert_roberta_state_dict(state)
    want = clip.roberta_params_from_jax(_tree(jax_convert_roberta(state)["params"]))
    assert set(got) == set(want) == set(port.state_dict())
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_features_logit_scale_and_taps_match_jax():
    jax_model, port = clip_pair()
    wav = _wav(1)
    audio_j, text_j, scale_j = jax_model(wav, TEXTS)
    audio_t, text_t, scale_t = port(wav, TEXTS)
    assert audio_t.shape == text_t.shape == (4, 64)
    np.testing.assert_allclose(_np(audio_t), _np(audio_j), **FP32_TOL)
    np.testing.assert_allclose(_np(text_t), _np(text_j), **FP32_TOL)
    np.testing.assert_allclose(scale_t.item(), float(scale_j), rtol=1e-6)
    np.testing.assert_allclose(torch.linalg.norm(audio_t, dim=1).numpy(), 1.0, atol=1e-5)
    # audio-only calls: the projected audio features (the port skips the text tower)
    np.testing.assert_allclose(_np(port(wav)), _np(jax_model(wav)), **FP32_TOL)
    np.testing.assert_allclose(_np(port.extract_embeddings(wav)), _np(jax_model.extract_embeddings(wav)), **FP32_TOL)
    # every tap, flattened NCHW → [B, HW, C] as JAX's
    assert port.get_model_layers() == jax_model.get_model_layers()
    spec = port.process_audio(wav)
    np.testing.assert_allclose(spec.numpy(), np.asarray(jax_model.process_audio(wav)), **FP32_TOL)
    tokens = jax_model.tokenize(TEXTS)
    _, aux_j = _jax_apply()(jax_model.variables, jnp.asarray(spec.numpy()), tokens)
    with torch.no_grad():
        _, aux_t = port.module(spec, torch.from_numpy(tokens).long())
    assert set(aux_t["intermediates"]) == set(aux_j["intermediates"])
    for name, want in aux_j["intermediates"].items():
        got = aux_t["intermediates"][name]
        assert got.shape == want.shape, name
        np.testing.assert_allclose(_np(got), _np(want), err_msg=name, **FP32_TOL)
    port.register_hooks_for_layers(["all"])
    jax_model.register_hooks_for_layers(["all"])
    got = port.extract_embeddings(wav, aggregation="mean")
    np.testing.assert_allclose(_np(got), _np(jax_model.extract_embeddings(wav, aggregation="mean")), **FP32_TOL)


def test_bf16_audio_features_match_jax():
    jax_model, port = clip_pair("bfloat16")
    wav = _wav(2)
    audio_j, text_j, _ = jax_model(wav, TEXTS)
    audio_t, text_t, _ = port(wav, TEXTS)
    assert audio_t.dtype == torch.bfloat16
    assert _rel(audio_t, audio_j) <= BF16_POOLED_REL and _rel(text_t, text_j) <= BF16_POOLED_REL


def test_load_state_dict_of_a_clip_checkpoint_matches_jax():
    """A synthetic CLIP state dict (torchvision audio tower with running
    statistics, HF RoBERTa text tower, the two projections as
    ``Sequential`` indices 0/2, ``logit_scale``) loaded by both packages."""
    rng = np.random.default_rng(8)
    jax_model, port = clip_pair()
    state = {}
    for key, value in eff.EfficientNetModel("b0", None).state_dict().items():
        if not key.endswith("num_batches_tracked"):
            state[f"audio_encoder.{key}"] = (rng.standard_normal(tuple(value.shape)) * 0.05).astype(np.float32)
    state.update({k: np.abs(v) + 0.5 for k, v in state.items() if k.endswith("running_var")})
    d, f, vocab = TEXT_TOWER["dim"], TEXT_TOWER["ffn_dim"], TEXT_TOWER["vocab_size"]

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    state.update({"text_encoder.embeddings.word_embeddings.weight": w(vocab, d),
                  "text_encoder.embeddings.position_embeddings.weight": w(514, d),
                  "text_encoder.embeddings.token_type_embeddings.weight": w(1, d),
                  "text_encoder.embeddings.LayerNorm.weight": 1 + w(d), "text_encoder.embeddings.LayerNorm.bias": w(d)})
    for i in range(TEXT_TOWER["layers"]):
        base = f"text_encoder.encoder.layer.{i}"
        for name, (n_out, n_in) in (("attention.self.query", (d, d)), ("attention.self.key", (d, d)),
                                    ("attention.self.value", (d, d)), ("attention.output.dense", (d, d)),
                                    ("intermediate.dense", (f, d)), ("output.dense", (d, f))):
            state[f"{base}.{name}.weight"], state[f"{base}.{name}.bias"] = w(n_out, n_in), w(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            state[f"{base}.{name}.weight"], state[f"{base}.{name}.bias"] = 1 + w(d), w(d)
    for proj, width in (("audio_projection", 1280), ("text_projection", d)):
        state[f"{proj}.0.weight"], state[f"{proj}.0.bias"] = w(64, width), w(64)
        state[f"{proj}.2.weight"], state[f"{proj}.2.bias"] = w(64, 64), w(64)
    state["logit_scale"] = np.asarray([2.5], np.float32)
    jax_model = avex_tpu.build_model_from_spec(JaxModelSpec(**_spec()))
    jax_model.load_state_dict(state, strict=True)
    port.load_state_dict(state, strict=True)
    wav = _wav(3)
    audio_j, text_j, scale_j = jax_model(wav, TEXTS)
    audio_t, text_t, scale_t = port(wav, TEXTS)
    np.testing.assert_allclose(_np(audio_t), _np(audio_j), **FP32_TOL)
    np.testing.assert_allclose(_np(text_t), _np(text_j), **FP32_TOL)
    np.testing.assert_allclose(scale_t.item(), float(scale_j), rtol=1e-6)
    assert port.state_dict()["audio_encoder.features.8.1.running_var"].numpy() == pytest.approx(
        state["audio_encoder.features.8.1.running_var"])


def _jax_apply_fn(jax_model):
    module, process_audio = jax_model.module, jax_model.process_audio

    def apply_fn(variables, wav, text_tokens, padding_mask=None, rngs=None, **kwargs):
        return module.apply(variables, process_audio(wav), text_tokens, padding_mask, rngs=rngs, **kwargs)

    return apply_fn


def _port_batch(wav, tokens):
    return {"raw_wav": torch.from_numpy(wav), "text_tokens": torch.from_numpy(tokens).long()}


def test_clip_loss_and_deterministic_step_gradients_match_jax():
    jax_model, port = clip_pair()
    wav, tokens = _wav(4), jax_model.tokenize(TEXTS)
    variables = jax_model.variables
    apply_fn = _jax_apply_fn(jax_model)

    def loss_fn(params):
        return JaxCLIPStrategy().forward_loss(apply_fn, params, {"batch_stats": variables["batch_stats"]},
                                              {"raw_wav": wav, "text_tokens": tokens}, None, train=False)

    (want_loss, want_metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    port.eval()
    loss, metrics = CLIPStrategy().forward_loss(port.train_forward, _port_batch(wav, tokens), None, train=False)
    np.testing.assert_allclose(loss.item(), float(want_loss), **FP32_TOL)
    assert metrics["count"] == 4
    # a2t only: the random audio tower maps these clips to embeddings equal to
    # ~1e-6, so each text's row ties across the audio columns and its argmax
    # is rounding (the counts on distinct features are held below)
    assert int(metrics["a2t_correct"]) == int(want_metrics["a2t_correct"])
    params = dict(port.module.named_parameters())
    got = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = clip.params_from_jax({"params": _tree(grads), "batch_stats": {}})
    assert set(want) == set(got)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, err_msg=key, **FP32_TOL)
    # the loss alone, on features made in the test
    a, t = np.random.default_rng(9).standard_normal((2, 5, 16)).astype(np.float32)
    mine, aux = clip_loss(torch.from_numpy(a), torch.from_numpy(t), torch.tensor(2.0))
    ref, ref_aux = jax_clip_loss(jnp.asarray(a), jnp.asarray(t), jnp.asarray(2.0))
    np.testing.assert_allclose(mine.item(), float(ref), rtol=1e-6)
    assert int(aux["a2t_correct"]) == int(ref_aux["a2t_correct"])
    assert int(aux["t2a_correct"]) == int(ref_aux["t2a_correct"])


def test_train_mode_step_matches_jax(monkeypatch):
    """Train mode (BatchNorm on the batch's statistics, their running update,
    stochastic depth keeping every item): loss, gradients and the updated
    running statistics."""
    jax_model, port = clip_pair()
    wav, tokens = _wav(5), jax_model.tokenize(TEXTS)
    variables = jax_model.variables
    apply_fn = _jax_apply_fn(jax_model)
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.ones(shape, bool))

    def loss_fn(params):
        return JaxCLIPStrategy().forward_loss(apply_fn, params, {"batch_stats": variables["batch_stats"]},
                                              {"raw_wav": wav, "text_tokens": tokens}, jax.random.PRNGKey(0),
                                              train=True)

    (want_loss, want_metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    drawn = []

    def keep_all(bsz, keep, generator, device):
        drawn.append(keep)
        return torch.ones((bsz, 1, 1, 1), dtype=torch.bool, device=device)

    monkeypatch.setattr(eff, "stochastic_depth_mask", keep_all)
    port.train()
    loss, _ = CLIPStrategy().forward_loss(port.train_forward, _port_batch(wav, tokens),
                                          torch.Generator().manual_seed(0), train=True)
    assert len(drawn) == 9  # B0's stride-1 same-width blocks
    np.testing.assert_allclose(loss.item(), float(want_loss), **FP32_TOL)
    params = dict(port.module.named_parameters())
    got = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = clip.params_from_jax({"params": _tree(grads),
                                 "batch_stats": _tree(want_metrics["_updated_variables"]["batch_stats"])})
    buffers = dict(port.module.named_buffers())
    assert any(k.endswith("running_var") for k in want)
    for key in (k for k in want if "running" in k):
        np.testing.assert_allclose(buffers[key].numpy(), want[key], err_msg=key, **FP32_TOL)
    # The gradients by their global relative L2: the random audio tower maps
    # the four clips within ~1e-6 of each other, and train-mode BatchNorm
    # over near-identical items makes the step ill-conditioned (a 1e-6
    # relative change of the input moves the port's own gradients by ~4e-5
    # rel L2; the two frameworks' roundings leave ~2e-4 between them).
    grads_only = {k: v for k, v in want.items() if k in got}
    assert set(grads_only) == set(got)
    num = sum(float(((got[k] - torch.tensor(v)) ** 2).sum()) for k, v in grads_only.items())
    den = sum(float((v.astype(np.float64) ** 2).sum()) for v in grads_only.values())
    assert (num / den) ** 0.5 <= TRAIN_GRAD_REL


def test_strategy_trainer_text_mode_and_errors(tmp_path):
    assert isinstance(make_strategy("text"), CLIPStrategy)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(**_spec()), device="cpu")
    assert isinstance(port, clip.Model) and isinstance(port.tokenizer, clip.SimpleTokenizer)
    config = RunConfig(model_spec=ModelSpec(**_spec(device="cpu")), label_type="text", loss_function="clip",
                       training_params=TrainingParams(train_epochs=1, lr=1e-3, batch_size=4), output_dir=str(tmp_path),
                       device="cpu")
    trainer = Trainer(port, config, [])
    batch = trainer._device_batch({"raw_wav": _wav(6), "label": np.arange(4), "text_label": TEXTS})
    assert batch["text_tokens"].dtype == torch.int64
    np.testing.assert_array_equal(batch["text_tokens"].numpy(), clip.SimpleTokenizer(1024)(TEXTS))
    before = {k: v.clone() for k, v in port.state_dict().items() if "running" in k}
    loss, metrics = trainer._train_step({"raw_wav": _wav(6), "text_label": TEXTS})
    assert np.isfinite(loss.item()) and metrics["count"] == 4
    assert all(not torch.equal(before[k], port.state_dict()[k]) for k in before)
    raw = avex_tpu_torch.build_model_from_spec(ModelSpec(**dict(_spec(), audio_config=None)), device="cpu")
    with pytest.raises(ValueError, match="spectrograms"):
        raw(_wav(6))


def test_run_train_text_epoch_on_the_synthetic_set(tmp_path):
    """``run_train`` with ``label_type: text``: the synthetic set's captions
    are tokenized on the host; an epoch trains and validates, reporting
    a2t/t2a accuracy, and writes the final checkpoint."""
    config = RunConfig.from_dict({
        "model_spec": _spec(audio_config=dict(AUDIO, target_length_seconds=0.5, window_selection="random")),
        "training_params": {"train_epochs": 1, "lr": 1e-3, "batch_size": 4, "optimizer": "adamw",
                            "weight_decay": 0.01},
        "dataset_config": {"train_datasets": [{"name": "t", "kind": "synthetic", "num_samples": 8,
                                               "num_classes": 4, "sample_rate": 16000}],
                           "val_datasets": [{"name": "v", "kind": "synthetic", "num_samples": 4,
                                             "num_classes": 4, "seed": 7, "sample_rate": 16000}]},
        "label_type": "text", "loss_function": "clip", "output_dir": str(tmp_path), "device": "cpu",
        "num_workers": 0, "logging": "none", "seed": 0,
    })
    result = run_train.main(config)
    train = result["history"][0]["train"]
    assert np.isfinite(train["loss"]) and train["samples"] == 8
    assert {"a2t_accuracy", "t2a_accuracy"} <= set(train) and "val" in result["history"][0]
    assert (tmp_path / "final_model").exists()
