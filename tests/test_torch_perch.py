"""Perch and SurfPerch in the PyTorch port against the JAX package, with the same weights.

The full-width Perch (EfficientNet-B1, TF "SAME" padding, BatchNorm eps 1e-3,
10932 classes) built by both packages, JAX's variables carried across with
``efficientnet.params_from_jax``: ``perch_frontend`` in both precisions, the
5 s centre crop or pad at 32 kHz, the logits and the 1280-d embedding in
fp32 and bf16, a Keras-named variable dump loaded by both, and
``surfperch`` resolving to ``SurfPerchModel``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.models.efficientnet import convert_efficientnet_state_dict as jax_convert
from avex_tpu.models.perch import Model as JaxPerch
from avex_tpu.models.perch import convert_keras_efficientnet_state as jax_convert_keras
from avex_tpu.models.perch import perch_frontend as jax_frontend

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models import efficientnet as eff
from avex_tpu_torch.models import perch
from tests.test_torch_beats import BF16_POOLED_REL, FP32_TOL, _np, _rel
from tests.test_torch_efficientnet import BF16_TAP_REL, _moved_stats
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

# The frontend: log of an fp32 DFT and mel product summed in another order;
# near-silent bins sit at the 1e-6 clamp either way.
FRONTEND_ATOL = 2e-5


def _pair(compute_dtype="float32"):
    jax_model = JaxPerch(compute_dtype=compute_dtype)
    jax_model.variables = _moved_stats(jax_model.variables)
    port = perch.Model(device="cpu", compute_dtype=compute_dtype)
    port.load_port_state_dict(eff.params_from_jax(jax_model.variables, "b1"), strict=True)
    return jax_model, port


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_perch_frontend_matches_jax(rng, precision):
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    jax_precision = jax.lax.Precision.HIGHEST if precision == "highest" else jax.lax.Precision.DEFAULT
    want = np.asarray(jax_frontend(jnp.asarray(wav), precision=jax_precision))
    got = perch.perch_frontend(torch.from_numpy(wav), precision)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 160, 51)
    np.testing.assert_allclose(got.numpy(), want, atol=FRONTEND_ATOL, rtol=0)


def test_centre_crop_and_pad_match_jax(rng):
    """3 s is zero-padded and 7 s centre-cropped to 5 s, then the frontend
    and the 3-channel repeat."""
    jax_model = JaxPerch.__new__(JaxPerch)
    jax_model.window_samples, jax_model._frontend_precision = 160000, jax.lax.Precision.HIGHEST
    port = perch.Model.__new__(perch.Model)
    port.device, port.window_samples, port._frontend_precision = torch.device("cpu"), 160000, "highest"
    for seconds in (3, 7):
        wav = (rng.standard_normal((1, seconds * 32000)) * 0.1).astype(np.float32)
        want = np.asarray(jax_model._prepare(wav))
        got = port._prepare(wav)
        assert got.shape == want.shape == (1, 3, 160, 501)
        np.testing.assert_allclose(got.numpy(), want, atol=FRONTEND_ATOL, rtol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_logits_and_embedding_match_jax(rng, compute_dtype):
    jax_model, port = _pair(compute_dtype)
    wav = (rng.standard_normal((2, 6 * 32000)) * 0.1).astype(np.float32)  # centre-cropped to 5 s
    want, got = jax_model.infer(wav), port.infer(wav)
    assert got["logits"].shape == (2, perch.PERCH_NUM_CLASSES) and got["embedding"].shape == (2, 1280)
    assert port.get_model_layers() == ["embedding"] == jax_model.get_model_layers()
    emb = port.extract_embeddings(wav)
    assert torch.equal(emb, got["embedding"])
    port.register_hooks_for_layers(["embedding"])
    assert torch.equal(port.extract_fn(("embedding",), "mean")(torch.from_numpy(wav), None), emb)
    if compute_dtype == "bfloat16":
        assert _rel(got["embedding"], want["embedding"]) <= BF16_POOLED_REL
        assert _rel(got["logits"], want["logits"]) <= BF16_TAP_REL  # one more bf16 product
    else:
        np.testing.assert_allclose(_np(got["embedding"]), _np(want["embedding"]), **FP32_TOL)
        np.testing.assert_allclose(_np(got["logits"]), _np(want["logits"]), **FP32_TOL)
        np.testing.assert_allclose(_np(port(wav)), _np(jax_model(wav)), **FP32_TOL)


def _keras_dump(state):
    """A Keras-applications EfficientNet-B1 variable dump (TF names with a
    path prefix and ``:0``) holding the values of a torchvision-style B1
    state dict."""
    dump = {}

    def put(name, value):
        dump[f"tfhub_model/{name}:0"] = value

    def conv(src, keras, depthwise=False):
        w = state[f"{src}.weight"]
        put(f"{keras}/{'depthwise_kernel' if depthwise else 'kernel'}",
            w.transpose(2, 3, 0, 1) if depthwise else w.transpose(2, 3, 1, 0))
        if f"{src}.bias" in state:
            put(f"{keras}/bias", state[f"{src}.bias"])

    def bn(src, keras):
        for torch_name, keras_name in (("weight", "gamma"), ("bias", "beta"), ("running_mean", "moving_mean"),
                                       ("running_var", "moving_variance")):
            put(f"{keras}/{keras_name}", state[f"{src}.{torch_name}"])

    conv("features.0.0", "stem_conv")
    bn("features.0.1", "stem_bn")
    for stage_i, (t, _c, n, _s, _k) in enumerate(eff.stage_config("b1"), start=1):
        for j in range(n):
            keras, base = f"block{stage_i}{'abcdefgh'[j]}", f"features.{stage_i}.{j}.block"
            dw, se, proj = (1, 2, 3) if t != 1 else (0, 1, 2)
            if t != 1:
                conv(f"{base}.0.0", f"{keras}_expand_conv")
                bn(f"{base}.0.1", f"{keras}_expand_bn")
            conv(f"{base}.{dw}.0", f"{keras}_dwconv", depthwise=True)
            bn(f"{base}.{dw}.1", f"{keras}_bn")
            conv(f"{base}.{se}.fc1", f"{keras}_se_reduce")
            conv(f"{base}.{se}.fc2", f"{keras}_se_expand")
            conv(f"{base}.{proj}.0", f"{keras}_project_conv")
            bn(f"{base}.{proj}.1", f"{keras}_project_bn")
    conv("features.8.0", "top_conv")
    bn("features.8.1", "top_bn")
    put("predictions/kernel", state["classifier.1.weight"].T)
    put("predictions/bias", state["classifier.1.bias"])
    return dump


def test_keras_dump_loads_like_jax(rng):
    """Both packages remap the same Keras dump into the same weights and
    statistics (JAX's through its converters, carried across with
    ``params_from_jax``; the logits test holds the forward on equal
    weights); the port's state dict then holds the dump's values under
    torchvision's names."""
    state = {}
    for key, value in eff.EfficientNetModel("b1", perch.PERCH_NUM_CLASSES).state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.endswith("running_var"):
            state[key] = rng.uniform(0.5, 2.0, value.shape).astype(np.float32)
        else:
            state[key] = (rng.standard_normal(tuple(value.shape)) * 0.1).astype(np.float32)
    dump = _keras_dump(state)
    converted = perch.convert_keras_efficientnet_state(dump, "b1")
    assert set(converted) == set(state)
    want = eff.params_from_jax(jax_convert(jax_convert_keras(dump, "b1"), "b1", num_classes=perch.PERCH_NUM_CLASSES),
                               "b1")
    port = perch.Model(device="cpu")
    port.load_state_dict(dump)
    own = port.state_dict()
    assert set(want) == set(state)
    for key, value in state.items():
        np.testing.assert_array_equal(own[key].numpy(), value, err_msg=key)
        np.testing.assert_array_equal(want[key], value, err_msg=key)


def test_surfperch_resolves_to_its_class():
    assert avex_tpu_torch.get_model_class("surfperch") is perch.SurfPerchModel
    assert avex_tpu_torch.get_model_class("perch") is perch.Model
    model = avex_tpu_torch.build_model_from_spec(ModelSpec(name="surfperch", pretrained=False), device="cpu")
    assert isinstance(model, perch.SurfPerchModel) and model.model_family == "surfperch"
    assert model.num_classes == perch.PERCH_NUM_CLASSES
    conv = model.module.features[0][0]
    assert model.module.features[0][1].eps == 1e-3 and model.module.features[0].tf_same and conv.stride == (2, 2)
