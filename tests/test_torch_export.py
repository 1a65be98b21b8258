"""The port's export (``avex_tpu_torch/export``) against the JAX package's.

The JAX package's export matrix (``tests/unittests/test_export.py``: the
tiny BEATs of its fixture, EfficientNet-B0, Perch B1, AVES; here AVES at 2
layers, 64 wide; EfficientNet-B0 in ``tests/test_torch_export_cnn.py``,
Perch B1 in ``tests/test_torch_export_perch.py``)
goes through ``export_program`` in ``embed`` and
``logits`` mode with a dynamic batch, is loaded with ``torch.export.load``
and run at B=1 and B=3. Held: the program against the eager port at atol
1e-6, and against JAX on the same weights (carried with each model's
``params_from_jax``, BatchNorm statistics moved off 0/1) at the matrix's
tolerance: JAX's ``export._pure_forward`` for ``embed``, and for
``logits`` the JAX model's forward, which JAX's ``_pure_forward`` equals
where it runs (not for Perch, where JAX's raises a shape error: its module
gets the raw waveform). Then the sidecar against JAX's meta, a pinned
batch, and the refusals: a model on the hand-written kernels
(``use_pallas=True``), an int8 model, and the TF formats.
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.export import _pure_forward as jax_pure_forward

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.export import META_FILE, export_program, export_savedmodel, export_tflite
from avex_tpu_torch.models import aves, beats
from tests.test_torch_beats import FP32_TOL
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

PROGRAM_ATOL = 1e-6  # the program against the eager port: the same ops
MATRIX_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/unittests/test_export.py's matrix
BEATS_TINY = {"encoder_layers": 1, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 128,
              "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0, "attention_dropout": 0.0,
              "encoder_layerdrop": 0.0}
RAW = {"representation": "raw", "normalize": False}
AVES_TINY = {"encoder_num_layers": 2, "encoder_embed_dim": 64, "encoder_num_heads": 4,
             "encoder_ff_interm_features": 128}


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


def _beats_pair():
    spec = dict(name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW)
    jax_model = avex_tpu.build_model_from_spec(JaxModelSpec(**spec), num_classes=5)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(**spec), device="cpu", num_classes=5)
    port.load_port_state_dict(beats.params_from_jax(_tree(jax_model.variables["params"])), strict=True)
    return jax_model, port


def _aves_pair():
    kw = dict(aves_cfg=AVES_TINY, num_classes=None, return_features_only=True)
    jax_model = avex_tpu.build_model_from_spec(JaxModelSpec(name="aves_bio", pretrained=False, audio_config=None),
                                               **kw)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(name="aves_bio", pretrained=False, audio_config=None),
                                                device="cpu", **kw)
    port.load_port_state_dict(aves.params_from_jax(_tree(jax_model.variables["params"])), strict=True)
    return jax_model, port


# (name, pair, clip seconds, samples, tolerance against JAX); the CNN rows
# are in tests/test_torch_export_cnn.py and tests/test_torch_export_perch.py
MATRIX = {
    "beats": (_beats_pair, 1.0, 16000, FP32_TOL),
    "aves": (_aves_pair, 1.0, 16000, MATRIX_TOL),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    jax_model, port = MATRIX[name][0]()
    return jax_model, port.eval()


@pytest.mark.parametrize("mode", ["embed", "logits"])
@pytest.mark.parametrize("name", list(MATRIX))
def test_program_matches_the_eager_port_and_jax(name, mode, tmp_path):
    check_program(MATRIX[name], _pair(name), name, mode, tmp_path)


def check_program(row, pair, name, mode, tmp_path):
    """Export ``pair``'s port model in ``mode``, load it, and hold it at B=1
    and B=3 to the eager port and to JAX."""
    _, clip_seconds, n_samples, tol = row
    jax_model, port = pair
    path = export_program(port, tmp_path / f"{name}.pt2", mode=mode, layers=["last_layer"], aggregation="mean",
                          clip_seconds=clip_seconds)
    program = torch.export.load(str(path)).module()
    wav = (np.random.default_rng(5).standard_normal((3, n_samples)) * 0.1).astype(np.float32)
    if mode == "embed":
        port.register_hooks_for_layers(["last_layer"])
        want_jax = np.asarray(jax.jit(jax_pure_forward(jax_model, "embed", ["last_layer"], "mean"))(
            jax_model.variables, wav))
    else:
        want_jax = np.asarray(jax_model(wav))
        if name == "perch_b1":
            with pytest.raises(ValueError, match="out of bounds"):
                jax_pure_forward(jax_model, "logits", ["last_layer"], "mean")(jax_model.variables, wav)
        else:
            jax_program = jax.jit(jax_pure_forward(jax_model, "logits", ["last_layer"], "mean"))
            np.testing.assert_allclose(np.asarray(jax_program(jax_model.variables, wav)), want_jax, **tol)
    for batch in (1, 3):
        x = torch.from_numpy(wav[:batch])
        with torch.no_grad():
            got = program(x)
            eager = port.extract_embeddings(x, aggregation="mean") if mode == "embed" else port(x)
        assert got.shape == eager.shape and got.shape[0] == batch
        np.testing.assert_allclose(got.numpy(), eager.numpy(), rtol=0, atol=PROGRAM_ATOL)
        np.testing.assert_allclose(got.numpy(), want_jax[:batch], **tol)


def test_sidecar_equals_jax_meta_and_a_pinned_batch_stays_pinned(tmp_path):
    pytest.importorskip("tensorflow")
    from avex_tpu.export import _build_tf_module

    jax_model, port = _pair("beats")
    kw = dict(mode="embed", layers=["last_layer"], aggregation="mean", clip_seconds=1.0)
    path = export_program(port, tmp_path / "pinned.pt2", batch_size=2, **kw)
    _module, want = _build_tf_module(jax_model, kw["mode"], kw["layers"], kw["aggregation"], kw["clip_seconds"], 2)
    assert json.loads((tmp_path / META_FILE).read_text()) == want
    program = torch.export.load(str(path))
    wav = torch.zeros((2, 16000))
    assert program.module()(wav).shape == (2, 64)
    with pytest.raises(Exception):  # the batch axis is pinned at 2
        program.module()(torch.zeros((3, 16000)))


def test_kernel_and_int8_models_and_tf_formats_are_refused(tmp_path):
    spec = ModelSpec(name="beats", pretrained=False, init_config=dict(BEATS_TINY, use_pallas=True), audio_config=RAW)
    kernels = avex_tpu_torch.build_model_from_spec(spec, device="cpu", return_features_only=True)
    with pytest.raises(ValueError, match="use_pallas=True"):
        export_program(kernels, tmp_path / "k.pt2", clip_seconds=1.0)
    int8 = avex_tpu_torch.build_model_from_spec(spec.replace(init_config=BEATS_TINY), device="cpu",
                                                return_features_only=True)
    int8.quantize("int8")
    with pytest.raises(ValueError, match="int8"):
        export_program(int8, tmp_path / "q.pt2", clip_seconds=1.0)
    assert not (tmp_path / "k.pt2").exists() and not (tmp_path / "q.pt2").exists()
    _, port = _pair("beats")
    with pytest.raises(NotImplementedError, match="TF SavedModel export needs TensorFlow"):
        export_savedmodel(port, tmp_path / "sm")
    with pytest.raises(NotImplementedError, match="TFLite export needs TensorFlow"):
        export_tflite(port, tmp_path / "m.tflite")
