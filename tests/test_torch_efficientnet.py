"""EfficientNet-B0/B1 in the PyTorch port against the JAX package, with the same weights.

Full-width B0 and B1 (both are small) on small spectrograms and on 1-2 s of
16 kHz audio through the official entries' frontend (n_fft 800, hop 160, 128
mels). JAX's variables, with their BatchNorm statistics moved off the init's
0/1 so that eval-mode normalisation is exercised, are carried across with
``params_from_jax``. Cases: parameter counts; the 17 (B0) and 23 (B1) taps,
the logits and the pooled features in fp32 and bf16; TF "SAME" padding on
odd and even sizes; the 4-D aggregation; torchvision-keyed state dicts
loaded by both packages; one train-mode BatchNorm step (loss, gradients,
updated running statistics) against JAX's ``mutable=["batch_stats"]``; then,
on the port alone, stochastic depth and the classifier's dropout, a
``Trainer`` checkpoint that keeps the running statistics, and a probe that
leaves them fixed.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.models.efficientnet import EfficientNetModel as JaxEfficientNet
from avex_tpu.models.efficientnet import Model as JaxEfficientNetWrapper
from avex_tpu.models.efficientnet import _ConvBN as JaxConvBN
from avex_tpu.utils.tree import count_params

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec, ProbeConfig, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.evaluation import FineTuneTrainer
from avex_tpu_torch.models import efficientnet as eff
from avex_tpu_torch.models.base import ModelBase
from avex_tpu_torch.models.common import dropout, same_padding
from avex_tpu_torch.probes import build_probe_from_config
from avex_tpu_torch.training import Trainer
from tests.test_torch_beats import BF16_POOLED_REL, FP32_TOL, _np, _rel
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

BF16_TAP_REL = 2e-2  # a tap is one conv output, rounded where each framework rounds, over up to 25 layers
LOSS_REL = 1e-5
EFFNET_AUDIO = {"sample_rate": 16000, "n_fft": 800, "hop_length": 160, "win_length": 800, "window": "hann",
                "n_mels": 128, "representation": "mel_spectrogram", "normalize": True}
TAPS = {"b0": 17, "b1": 23}


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


def _moved_stats(variables, seed=0, low=0.1, high=0.5):
    """JAX variables with each running mean and variance moved off 0 and 1
    by U(low, high)."""
    rng = np.random.default_rng(seed)

    def move(node):
        return {k: move(v) if isinstance(v, dict) else v + rng.uniform(low, high, v.shape).astype(np.float32)
                for k, v in node.items()}

    variables = _tree(variables)
    return {"params": variables["params"], "batch_stats": move(variables["batch_stats"])}


@functools.lru_cache(maxsize=None)
def _jax_variables(variant, num_classes, bn_eps, tf_same, seed):
    """JAX's init (its parameters are fp32 whatever the compute dtype), with
    the statistics moved; one compile per architecture for the whole file."""
    module = JaxEfficientNet(variant=variant, num_classes=num_classes, bn_eps=bn_eps, tf_same_padding=tf_same)
    return _moved_stats(jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 3, 64, 48))), seed)


def module_pair(variant="b0", compute_dtype="float32", num_classes=None, bn_eps=1e-5, tf_same=False, seed=1):
    """(JAX module, its variables, port module), the same weights and statistics."""
    dtype = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    jax_module = JaxEfficientNet(variant=variant, num_classes=num_classes, dtype=dtype, bn_eps=bn_eps,
                                 tf_same_padding=tf_same)
    variables = _jax_variables(variant, num_classes, bn_eps, tf_same, seed)
    port = eff.EfficientNetModel(variant, num_classes, torch.bfloat16 if compute_dtype == "bfloat16"
                                 else torch.float32, bn_eps, tf_same)
    state = eff.params_from_jax(variables, variant)
    own = {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(state) == own, set(state) ^ own
    port.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=False)
    return jax_module, variables, port.eval()


def wrapper_pair(compute_dtype="float32", num_classes=None, variant="b0"):
    """(JAX wrapper, port wrapper on the CPU) of the official entries' config."""
    spec = dict(name="efficientnet", pretrained=False, efficientnet_variant=variant, audio_config=EFFNET_AUDIO,
                compute_dtype=compute_dtype)
    jax_model = avex_tpu.build_model_from_spec(JaxModelSpec(**spec), num_classes=num_classes)
    jax_model.variables = _moved_stats(jax_model.variables)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(**spec), device="cpu", num_classes=num_classes)
    port.load_port_state_dict(eff.params_from_jax(jax_model.variables, variant), strict=True)
    return jax_model, port


def _check_taps(aux_t, aux_j, bf16):
    assert list(aux_t["intermediates"]) == list(aux_j["intermediates"])
    for name, want in aux_j["intermediates"].items():
        got = aux_t["intermediates"][name]
        assert got.shape == want.shape, name
        if bf16:
            assert _rel(got, want) <= BF16_TAP_REL, name
        else:
            np.testing.assert_allclose(_np(got), _np(want), err_msg=name, **FP32_TOL)


@pytest.mark.parametrize("variant", ["b0", "b1"])
def test_full_width_parameter_counts_match_jax(variant):
    """The published torchvision counts with a 1000-class head (B0
    5,288,548; B1 7,794,184) and JAX's, head and headless."""
    published = {"b0": 5_288_548, "b1": 7_794_184}[variant]
    for num_classes in (1000, None):
        jax_module = JaxEfficientNet(variant=variant, num_classes=num_classes)
        shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 48)))
        want = count_params(shapes["params"])
        port = eff.EfficientNetModel(variant, num_classes)
        assert sum(p.numel() for p in port.parameters()) == want
        if num_classes == 1000:
            assert want == published


# B1 in bf16 goes through Perch's tests (tests/test_torch_perch.py).
@pytest.mark.parametrize("variant,compute_dtype", [("b0", "float32"), ("b0", "bfloat16"), ("b1", "float32")])
def test_module_taps_logits_and_pooled_match_jax(rng, variant, compute_dtype):
    jax_module, variables, port = module_pair(variant, compute_dtype, num_classes=7)
    x = rng.standard_normal((2, 3, 64, 50)).astype(np.float32)
    out_j, aux_j = jax.jit(jax_module.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out_t, aux_t = port(torch.from_numpy(x))
    assert len(aux_t["intermediates"]) == TAPS[variant]
    bf16 = compute_dtype == "bfloat16"
    _check_taps(aux_t, aux_j, bf16)
    for got, want in ((out_t, out_j), (aux_t["pooled"], aux_j["pooled"]), (aux_t["features"], aux_j["features"])):
        assert got.shape == want.shape
        if bf16:
            assert _rel(got, want) <= BF16_POOLED_REL
        else:
            np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)


@pytest.mark.parametrize("size", [(63, 47), (64, 48)], ids=["odd", "even"])
def test_tf_same_padding_matches_jax(rng, size):
    """TF "SAME" (Perch's): the pads of every kernel and stride the model
    uses, and a strided 5x5 depthwise ``_ConvBN`` (eps 1e-3), on an odd and
    an even input; the whole B1 on the odd one (Perch's tests run it on an
    even height)."""
    for n in size:
        for kernel in (1, 3, 5):
            for stride in (1, 2):
                conv = JaxConvBN(features=4, kernel=kernel, stride=stride, tf_same_padding=True)
                want = conv._padding(np.zeros((1, n, n, 1)))[0]
                assert same_padding(n, kernel, stride) == tuple(want), (n, kernel, stride)
    x = rng.standard_normal((2, 8) + size).astype(np.float32)
    layer = JaxConvBN(features=8, kernel=5, stride=2, groups=8, bn_eps=1e-3, tf_same_padding=True)
    nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    variables = _moved_stats(layer.init(jax.random.PRNGKey(0), nhwc))
    want, want_conv = layer.apply(variables, nhwc)
    port = eff._ConvBN(8, 8, 5, 2, groups=8, bn_eps=1e-3, tf_same=True).eval()
    state = {"0.weight": np.asarray(variables["params"]["conv"]["kernel"]).transpose(3, 2, 0, 1),
             "1.weight": variables["params"]["bn"]["scale"], "1.bias": variables["params"]["bn"]["bias"],
             "1.running_mean": variables["batch_stats"]["bn"]["mean"],
             "1.running_var": variables["batch_stats"]["bn"]["var"]}
    port.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in state.items()}, strict=False)
    with torch.no_grad():
        got, got_conv = port(torch.from_numpy(x), torch.float32)
    assert got.shape[2:] == (-(-size[0] // 2), -(-size[1] // 2))
    np.testing.assert_allclose(_np(got), np.asarray(want).transpose(0, 3, 1, 2), **FP32_TOL)
    np.testing.assert_allclose(_np(got_conv), np.asarray(want_conv).transpose(0, 3, 1, 2), **FP32_TOL)
    if size[0] % 2:
        jax_module, variables, port = module_pair("b1", bn_eps=1e-3, tf_same=True)
        x = rng.standard_normal((2, 3) + size).astype(np.float32)
        out_j, aux_j = jax.jit(jax_module.apply)(variables, jnp.asarray(x))
        with torch.no_grad():
            out_t, aux_t = port(torch.from_numpy(x))
        _check_taps(aux_t, aux_j, bf16=False)
        np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_wrapper_waveform_taps_match_jax(rng, compute_dtype):
    """The official entries' frontend on 1.5 s of audio (the bf16 trunk's
    bf16-operand DFT), every tap unpooled and mean-pooled through the 4-D
    aggregation (JAX's pooled from its unpooled taps: one compile)."""
    jax_model, port = wrapper_pair(compute_dtype)
    wav = (rng.standard_normal((2, 24000)) * 0.1).astype(np.float32)
    assert port.get_model_layers() == jax_model.get_model_layers() and len(port.get_model_layers()) == 17
    for model in (jax_model, port):
        model.register_hooks_for_layers(["all"])
    got_layers = port.extract_embeddings(wav, aggregation="none")
    want_layers = jax_model.extract_embeddings(wav, aggregation="none")
    assert [g.shape for g in got_layers] == [w.shape for w in want_layers]
    got = port.extract_embeddings(wav, aggregation="mean")
    want = np.concatenate([np.asarray(JaxEfficientNetWrapper._aggregate(w, "mean")) for w in want_layers], axis=1)
    assert got.shape == want.shape
    if compute_dtype == "bfloat16":
        assert _rel(got, want) <= BF16_TAP_REL
        assert max(_rel(g, w) for g, w in zip(got_layers, want_layers)) <= BF16_TAP_REL
    else:
        np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)
        for g, w in zip(got_layers, want_layers):
            np.testing.assert_allclose(_np(g), _np(w), **FP32_TOL)


@pytest.mark.parametrize("aggregation", ["mean", "max", "cls_token"])
def test_conv_map_aggregation_matches_jax(rng, aggregation):
    """4-D maps pool the time axis and flatten; 2-D and 3-D keep the base rule."""
    for shape in ((2, 5, 3, 4), (2, 6, 8), (2, 9)):
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.asarray(JaxEfficientNetWrapper._aggregate(jnp.asarray(x), aggregation))
        got = eff.Model._aggregate(torch.from_numpy(x), aggregation)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Unexpected embedding dimension"):
        ModelBase._aggregate(torch.zeros(2, 3, 4, 5), "mean")


def test_torchvision_state_dict_loads_like_jax(rng):
    """A torchvision-keyed state dict (the reference wrapper's ``model.``
    prefix, ``num_batches_tracked`` included) loaded by both wrappers."""
    jax_model, port = wrapper_pair(num_classes=5)
    module = eff.EfficientNetModel("b0", 5)
    state = {}
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state["model." + key] = np.asarray(3)
        elif key.endswith("running_var"):
            state["model." + key] = rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
        else:
            state["model." + key] = (rng.standard_normal(tuple(value.shape)) * 0.1).astype(np.float32)
    jax_model.load_state_dict(state)
    port.load_state_dict(state)
    for key, value in port.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(value.numpy(), state["model." + key], err_msg=key)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(_np(port(wav)), _np(jax_model(wav)), **FP32_TOL)


def test_batchnorm_train_step_matches_jax(rng):
    """Train mode, deterministic: the loss, every gradient and the updated
    running statistics against ``apply(train=True, deterministic=True,
    mutable=["batch_stats"])``."""
    jax_module, variables, port = module_pair("b0", num_classes=7)
    x = rng.standard_normal((4, 3, 64, 50)).astype(np.float32)
    labels = np.array([1, 2, 3, 0])

    def loss_fn(params):
        (out, _aux), mutated = jax_module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                                jnp.asarray(x), train=True, deterministic=True,
                                                mutable=["batch_stats"])
        return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(4), labels]), mutated

    (want_loss, mutated), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    port.train()
    out, _ = port(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(out, torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_REL * abs(float(want_loss))
    want = eff.params_from_jax({"params": _tree(grads), "batch_stats": _tree(mutated["batch_stats"])})
    params, buffers = dict(port.named_parameters()), dict(port.named_buffers())
    assert any(k.endswith("running_var") for k in want)
    for key, value in want.items():
        got = params[key].grad if key in params else buffers[key]
        np.testing.assert_allclose(got.numpy(), value, err_msg=key, **FP32_TOL)


def test_stochastic_depth_and_dropout_sites_rates_and_scale():
    """On the port alone (JAX's draws are its own): stochastic depth only on
    stride-1 same-width blocks, at 0.2 · i / n, per item, scaled by 1/keep;
    the classifier's dropout 0.2 on the pooled features; nothing drawn when
    deterministic."""
    model = eff.EfficientNetModel("b0", 3)
    blocks = [b for stage in model.features[1:-1] for b in stage]
    assert len(blocks) == 16
    for i, block in enumerate(blocks):
        assert block.stochastic_depth_prob == pytest.approx(0.2 * i / 16)
    assert [b.residual for b in blocks] == [False, False, True, False, True, False, True, True,
                                            False, True, True, False, True, True, True, False]
    block = blocks[-2]  # features.6.3: stride 1, 192 → 192, rate 0.175
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4000, 192, 2, 2)
    with torch.no_grad():
        ref, _ = block(x, torch.float32, True, None)
        out, _ = block(x, torch.float32, False, gen)
    branch = ref - x
    kept = ((out - x) - branch / (1 - 0.175)).abs().amax(dim=(1, 2, 3)) < 1e-4
    dropped = (out - x).abs().amax(dim=(1, 2, 3)) == 0
    assert bool((kept | dropped).all())
    assert abs(float(dropped.float().mean()) - 0.175) < 0.02
    with pytest.raises(ValueError, match="Generator"):
        block(x[:2], torch.float32, False, None)
    pooled_rate = []
    for seed in range(3):
        with torch.no_grad():
            _, aux = model(torch.randn(2, 3, 32, 32), deterministic=True)
        pooled = aux["pooled"][:1].expand(500, -1)
        h = dropout(pooled, 0.2, False, torch.Generator().manual_seed(seed))
        pooled_rate.append(float((h == 0).float().mean()))
        kept = h != 0
        np.testing.assert_allclose(h[kept].numpy(), (pooled[kept] / 0.8).numpy(), rtol=1e-6)
    assert abs(np.mean(pooled_rate) - 0.2) < 0.01


def _cnn_config(tmp_path, epochs=1, **overrides):
    return RunConfig(
        model_spec=ModelSpec(name="efficientnet", pretrained=False, device="cpu", audio_config=EFFNET_AUDIO),
        training_params=TrainingParams(train_epochs=epochs, lr=1e-3, batch_size=4, optimizer="adamw"),
        output_dir=str(tmp_path / "run"), scheduler=SchedulerConfig(name="cosine", warmup_steps=1),
        seed=0, device="cpu", **overrides)


def _cnn_batches(seed, n=2):
    rng = np.random.default_rng(seed)
    return [{"raw_wav": (rng.standard_normal((4, 16000)) * 0.1).astype(np.float32),
             "label": rng.integers(0, 3, 4)} for _ in range(n)]


def test_trainer_checkpoint_persists_batch_stats(tmp_path):
    """After the JAX package's ``test_checkpoint_persists_batch_stats``:
    training moves the running statistics, the final checkpoint holds them,
    and a resumed ``Trainer`` restores them (not the init's 0 and 1); eval
    normalises with them."""
    config = _cnn_config(tmp_path)
    batches = _cnn_batches(3)
    model = avex_tpu_torch.build_model_from_spec(config.model_spec, num_classes=3)
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    result = Trainer(model, config, batches).train()
    trained = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    assert all(not torch.equal(before[k], trained[k]) for k in before)
    resumed_config = config.replace(resume_from_checkpoint=result["final_checkpoint"])
    resumed = avex_tpu_torch.build_model_from_spec(resumed_config.model_spec, num_classes=3)
    Trainer(resumed, resumed_config, batches)
    for key, value in trained.items():
        assert torch.equal(resumed.state_dict()[key], value), key
    wav = batches[0]["raw_wav"]
    out = resumed(wav)  # eval: the running statistics, so the batch's make-up does not matter
    np.testing.assert_allclose(resumed(wav[:1]).numpy(), out[:1].numpy(), rtol=1e-5, atol=1e-5)
    assert not torch.equal(out, model.module.train()(resumed.process_audio(wav))[0].detach())


def test_probe_keeps_batch_stats_fixed():
    """An online probe over an unfrozen BatchNorm backbone trains its weights
    but not its running statistics: the backbone extracts in eval mode."""
    model = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="efficientnet", pretrained=False, audio_config=EFFNET_AUDIO), device="cpu")
    config = ProbeConfig(probe_type="linear", aggregation="mean", target_layers=["last_layer"],
                         freeze_backbone=False)
    probe = build_probe_from_config(config, num_classes=3, base_model=model, input_dim=None)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = FineTuneTrainer(probe, TrainingParams(train_epochs=1, lr=1e-2, batch_size=4), mode="online")
    trainer._init_optimizer(2)
    for batch in _cnn_batches(4):
        trainer._train_step(batch)
    after = model.state_dict()
    assert trainer.train_backbone
    assert all(torch.equal(before[k], after[k]) for k in before if "running" in k or "num_batches" in k)
    assert any(not torch.equal(before[k], after[k]) for k in before if k.endswith(".0.weight"))
