"""ResNet-18/50/152 in the PyTorch port against the JAX package, with the same weights.

ResNet-18 (fp32 and bf16) and ResNet-50 (fp32) at full width on a small
spectrogram image, and ResNet-18 on 1 s of 16 kHz audio through the [0, 1]-normalising frontend, JAX's variables
(BatchNorm statistics moved off the init's 0/1) carried across with
``params_from_jax``: the four ``backbone.layer{i}`` taps, the logits and the
pooled features in fp32 and bf16; a torchvision state dict (``fc`` head)
loaded by both packages; one train-mode BatchNorm step; ResNet-152's
parameter count; the variant check and the registry's three names.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.models.resnet import ResNetModel as JaxResNet
from avex_tpu.utils.tree import count_params

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models import resnet
from tests.test_torch_beats import BF16_POOLED_REL, FP32_TOL, _np, _rel
from tests.test_torch_efficientnet import BF16_TAP_REL, LOSS_REL, _moved_stats, _tree
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

# ReLU stacks: running statistics moved by ±0.05 keep the last stage alive
# (a mean moved by +0.1-0.5 in every layer zeroes it).
MOVE = dict(low=-0.05, high=0.05)
AUDIO = {"sample_rate": 16000, "n_fft": 400, "hop_length": 160, "win_length": 400, "n_mels": 64,
         "representation": "mel_spectrogram", "normalize": True}


@functools.lru_cache(maxsize=None)
def _jax_variables(variant, num_classes, seed):
    """JAX's init (fp32 parameters whatever the compute dtype), statistics moved."""
    init = jax.jit(JaxResNet(variant=variant, num_classes=num_classes).init)(jax.random.PRNGKey(seed),
                                                                            jnp.zeros((1, 3, 64, 64)))
    return _moved_stats(init, seed, **MOVE)


def module_pair(variant, compute_dtype="float32", num_classes=None, seed=2):
    dtype = jnp.bfloat16 if compute_dtype == "bfloat16" else jnp.float32
    jax_module = JaxResNet(variant=variant, num_classes=num_classes, dtype=dtype)
    variables = _jax_variables(variant, num_classes, seed)
    port = resnet.ResNetModel(variant, num_classes, torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32)
    state = resnet.params_from_jax(variables, variant)
    own = {k for k in port.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(state) == own, set(state) ^ own
    port.load_state_dict({k: torch.tensor(v) for k, v in state.items()}, strict=False)
    return jax_module, variables, port.eval()


@pytest.mark.parametrize("variant,compute_dtype",
                         [("resnet18", "float32"), ("resnet18", "bfloat16"), ("resnet50", "float32")])
def test_forward_and_taps_match_jax(rng, variant, compute_dtype):
    jax_module, variables, port = module_pair(variant, compute_dtype, num_classes=6)
    x = rng.uniform(0.0, 1.0, (2, 3, 64, 50)).astype(np.float32)
    out_j, aux_j = jax.jit(jax_module.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        out_t, aux_t = port(torch.from_numpy(x))
    assert list(aux_t["intermediates"]) == [f"backbone.layer{i}" for i in range(1, 5)] == list(aux_j["intermediates"])
    bf16 = compute_dtype == "bfloat16"
    pairs = [(aux_t["intermediates"][k], w) for k, w in aux_j["intermediates"].items()]
    # bf16: the pooled features at the pooled bound; the taps and the logits
    # (one more bf16 product after the pooling) at the taps'.
    bounds = [BF16_TAP_REL] * len(pairs) + [BF16_POOLED_REL, BF16_TAP_REL]
    for bound, (got, want) in zip(bounds, pairs + [(aux_t["pooled"], aux_j["pooled"]), (out_t, out_j)]):
        assert got.shape == want.shape and float(np.abs(_np(want)).max()) > 0
        if bf16:
            assert _rel(got, want) <= bound
        else:
            np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_wrapper_waveform_matches_jax(rng, compute_dtype):
    """The wrapper: frontend, 3 channels scaled to [0, 1] per image, the
    four taps unpooled (a 4-D tap takes no pooled aggregation, as in JAX)."""
    spec = dict(name="resnet18", pretrained=False, audio_config=AUDIO, compute_dtype=compute_dtype)
    jax_model = avex_tpu.build_model_from_spec(JaxModelSpec(**spec), num_classes=4)
    jax_model.variables = _moved_stats(jax_model.variables, **MOVE)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(**spec), device="cpu", num_classes=4)
    assert port.variant == "resnet18"
    port.load_port_state_dict(resnet.params_from_jax(jax_model.variables, "resnet18"), strict=True)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    image = port.process_audio(wav)
    np.testing.assert_allclose(image.numpy(), np.asarray(jax_model.process_audio(wav)), atol=1e-5, rtol=1e-5)
    assert float(image.amax()) <= 1.0
    for model in (jax_model, port):
        model.register_hooks_for_layers(["all"])
    got = port.extract_embeddings(wav, aggregation="none")
    want = jax_model.extract_embeddings(wav, aggregation="none")
    with pytest.raises(ValueError, match="Unexpected embedding dimension"):
        port.extract_embeddings(wav, aggregation="mean")
    if compute_dtype == "bfloat16":
        assert max(_rel(g, w) for g, w in zip(got, want)) <= BF16_TAP_REL
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), **FP32_TOL)
        np.testing.assert_allclose(_np(port(wav)), _np(jax_model(wav)), **FP32_TOL)


def test_torchvision_state_dict_loads_like_jax(rng):
    """torchvision keys with an ``fc`` head, loaded by both wrappers."""
    spec = dict(name="resnet18", pretrained=False, audio_config=AUDIO)
    jax_model = avex_tpu.build_model_from_spec(JaxModelSpec(**spec), num_classes=3)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(**spec), device="cpu", num_classes=3)
    state = {}
    for key, value in resnet.ResNetModel("resnet18", 3).state_dict().items():
        key = key.replace("classifier", "fc")
        if key.endswith("num_batches_tracked"):
            state[key] = np.asarray(7)
        elif key.endswith("running_var"):
            state[key] = rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
        else:
            state[key] = (rng.standard_normal(tuple(value.shape)) * 0.05).astype(np.float32)
    jax_model.load_state_dict(state)
    port.load_state_dict(state)
    np.testing.assert_array_equal(port.state_dict()["classifier.weight"].numpy(), state["fc.weight"])
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    np.testing.assert_allclose(_np(port(wav)), _np(jax_model(wav)), **FP32_TOL)


def test_batchnorm_train_step_matches_jax(rng):
    """ResNet-18 in train mode: loss, gradients and running statistics."""
    jax_module, variables, port = module_pair("resnet18", num_classes=6)
    x = rng.uniform(0.0, 1.0, (4, 3, 48, 40)).astype(np.float32)
    labels = np.array([1, 2, 3, 5])

    def loss_fn(params):
        (out, _aux), mutated = jax_module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                                jnp.asarray(x), train=True, mutable=["batch_stats"])
        return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(4), labels]), mutated

    (want_loss, mutated), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    port.train()
    out, _ = port(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(out, torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) <= LOSS_REL * abs(float(want_loss))
    want = resnet.params_from_jax({"params": _tree(grads), "batch_stats": _tree(mutated["batch_stats"])})
    params, buffers = dict(port.named_parameters()), dict(port.named_buffers())
    for key, value in want.items():
        got = params[key].grad if key in params else buffers[key]
        np.testing.assert_allclose(got.numpy(), value, err_msg=key, **FP32_TOL)


def test_resnet152_parameter_count_and_variants():
    """ResNet-152 (60,192,808 parameters with torchvision's 1000-class head)
    against JAX's count; one class serves the three registry names; another
    variant raises."""
    for num_classes, published in ((1000, 60_192_808), (None, None)):
        shapes = jax.eval_shape(JaxResNet(variant="resnet152", num_classes=num_classes).init,
                                jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64)))
        want = count_params(shapes["params"])
        with torch.device("meta"):
            port = resnet.ResNetModel("resnet152", num_classes)
        assert sum(p.numel() for p in port.parameters()) == want
        assert published is None or want == published
    for name in ("resnet18", "resnet50", "resnet152"):
        assert avex_tpu_torch.get_model_class(name) is resnet.Model
    with pytest.raises(ValueError, match="Unsupported ResNet variant"):
        resnet.Model(variant="resnet34", device="cpu")
