"""The port's fp32 Kaldi fbank against ``avex_tpu.ops.fbank``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avex_tpu.ops import fbank as jax_fbank

from avex_tpu_torch.ops import fbank

# The tolerance the JAX fbank is held to against the reference torch pipeline.
ATOL = 1e-4


@pytest.mark.parametrize("length", [16000, 12345])
def test_beats_fbank_matches_jax(rng, length):
    wav = (rng.standard_normal((2, length)) * 0.1).astype(np.float32)
    want = np.asarray(jax_fbank.beats_fbank(jnp.asarray(wav)))
    got = fbank.beats_fbank(torch.from_numpy(wav))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, fbank.KaldiFbank().output_frames(length), 128)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_fbank_constants_are_the_jax_constants():
    fb = fbank.KaldiFbank()
    kernel, mel = fb.constants()
    jk, jm = jax_fbank.KaldiFbank().constants()
    np.testing.assert_array_equal(kernel, jk)
    np.testing.assert_array_equal(mel, jm)
    np.testing.assert_array_equal(
        fbank.kaldi_mel_banks(512, 128, 16000.0), jax_fbank.kaldi_mel_banks(512, 128, 16000.0)
    )


def test_fbank_single_waveform_and_short_input():
    fb = fbank.KaldiFbank()
    one = fb(torch.zeros(16000))
    assert one.shape == (98, 128)
    assert fb(torch.zeros(2, 100)).shape == (2, 0, 128)
