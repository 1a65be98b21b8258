"""Windowed inference of the port (``avex_tpu_torch/ops/windowing.py``)
against the JAX package's ``avex_tpu/ops/windowing.py``.

``window_waveform`` on JAX's cases (``tests/unittests/test_windowing.py``:
a short clip, the hop-aligned zero-padded tail, ``pad_final=False``, the
gapped case where the hop exceeds the window) and on random lengths, bit
for bit; ``windowed_apply``'s fixed-shape chunks; then ``windowed_apply``
over a tiny BEATs of each package holding the same weights, at the fp32
tolerance of the BEATs tests.
"""

import numpy as np
import pytest

from avex_tpu.ops.windowing import window_waveform as jax_window
from avex_tpu.ops.windowing import windowed_apply as jax_windowed_apply

from avex_tpu_torch.ops.windowing import window_waveform, windowed_apply
from tests.test_torch_beats import FP32_TOL, build_pair
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

CASES = [  # (length, window, hop, pad_final)
    (100, 160, None, True),  # shorter than one window: one zero-padded window
    (1000, 400, 300, True),  # the last window ends at the end: no tail
    (1100, 400, 300, True),  # a hop-aligned, zero-padded tail window at 900
    (1100, 400, 300, False),  # the partial tail dropped
    (90000, 16000, 32000, True),  # gapped: hop > window, no tail past the end
    (16000 * 7, 16000, None, True),
    (400, 400, 100, True),  # exactly one window
]


@pytest.mark.parametrize("length,window,hop,pad_final", CASES)
def test_window_waveform_equals_jax(length, window, hop, pad_final):
    wav = np.arange(length, dtype=np.float32)
    got_w, got_o = window_waveform(wav, window, hop, pad_final=pad_final)
    want_w, want_o = jax_window(wav, window, hop, pad_final=pad_final)
    assert got_w.dtype == want_w.dtype == np.float32 and got_o.dtype == want_o.dtype == np.int64
    np.testing.assert_array_equal(got_o, want_o)
    np.testing.assert_array_equal(got_w, want_w)


def test_window_waveform_equals_jax_on_random_lengths(rng):
    for _ in range(50):
        length, window = int(rng.integers(1, 5000)), int(rng.integers(1, 800))
        hop = int(rng.integers(1, 1200)) if rng.random() < 0.8 else None
        wav = rng.standard_normal(length).astype(np.float32)
        got, want = window_waveform(wav, window, hop), jax_window(wav, window, hop)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


def test_windowed_apply_keeps_one_batch_shape():
    seen = []

    def fn(chunk):
        seen.append(chunk.shape)
        return chunk.mean(axis=1, keepdims=True)

    wav = np.random.default_rng(0).standard_normal(16000 * 7).astype(np.float32)
    out, offsets = windowed_apply(fn, wav, window_samples=16000, batch_size=4)
    want, want_offsets = jax_windowed_apply(fn, wav, window_samples=16000, batch_size=4)
    assert out.shape[0] == len(offsets) == 7
    assert set(seen) == {(4, 16000)}  # the last chunk padded to the batch
    np.testing.assert_array_equal(offsets, want_offsets)
    np.testing.assert_array_equal(out, want)


def test_windowed_apply_over_beats_matches_jax(rng):
    """Each package's tiny BEATs over the 1 s windows of a 3.75 s recording
    (hop 0.5 s, a padded tail), in chunks of 4 windows."""
    jax_model, port = build_pair({"encoder_layers": 1, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 128,
                                  "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0,
                                  "attention_dropout": 0.0, "encoder_layerdrop": 0.0},
                                 return_features_only=True)
    for model in (jax_model, port):
        model.register_hooks_for_layers(["last_layer"])
    wav = (rng.standard_normal(60000) * 0.1).astype(np.float32)
    got, offsets = windowed_apply(lambda c: port.extract_embeddings(c, aggregation="mean"), wav,
                                  window_samples=16000, hop_samples=8000, batch_size=4)
    want, want_offsets = jax_windowed_apply(lambda c: jax_model.extract_embeddings(c, aggregation="mean"), wav,
                                            window_samples=16000, hop_samples=8000, batch_size=4)
    np.testing.assert_array_equal(offsets, want_offsets)
    assert got.shape == want.shape == (7, 64)
    np.testing.assert_allclose(got, np.asarray(want), **FP32_TOL)
