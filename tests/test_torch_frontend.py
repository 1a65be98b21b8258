"""The generic spectrogram frontend of the port against the JAX package.

``avex_tpu_torch.ops.frontend`` (HTK mel bank, ``stft_power`` in both
precisions, ``AudioProcessor`` in every representation) against
``avex_tpu.ops.frontend`` on the same seeded numpy waveforms, and the
repaired ``AudioConfig`` fields against the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.configs import AudioConfig as JaxAudioConfig
from avex_tpu.ops import frontend as jax_frontend

from avex_tpu_torch.configs import AudioConfig, ModelSpec
from avex_tpu_torch.ops import frontend
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

# fp32: the DFT as one product summed in another order than XLA's.
STFT_ATOL = 1e-5  # of the spectrogram's largest value
# bf16-rounded operands, fp32 sums on both sides: only the order differs.
FAST_REL = 1e-4
# Normalised outputs: log(x + 1e-6) lifts near-zero bins, so an fp32 rounding
# there shows at 1e-5 of the [0, 1] range.
NORMALIZED_ATOL = 5e-5


def _wav(rng, batch=2, samples=4000):
    return (rng.standard_normal((batch, samples)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("args", [(513, 64, 16000.0, 60.0, 7800.0), (1025, 128, 16000.0, 0.0, None),
                                  (257, 40, 22050.0, 20.0, 8000.0)], ids=["atst", "default", "22k"])
def test_htk_mel_banks_equal_jax(args):
    got, want = frontend.htk_mel_banks(*args), jax_frontend.htk_mel_banks(*args)
    assert got.dtype == np.float64 and got.shape == (args[0], args[1])
    np.testing.assert_array_equal(got, want)


# (n_fft, hop, win, window, center): gcd(n_fft, hop) 128, 80, 32, 4; a window
# shorter than n_fft (centred in the frame); hann and hamming; both paddings.
STFT_CASES = [
    (512, 128, 512, "hann", True),
    (400, 160, 300, "hamming", False),
    (1024, 160, 1024, "hann", True),
    (256, 100, 200, "hann", True),
    (256, 100, 256, "hamming", True),
    (512, 256, 400, "hann", False),
]


@pytest.mark.parametrize("n_fft,hop,win,window,center", STFT_CASES)
def test_stft_power_fp32_matches_jax(rng, n_fft, hop, win, window, center):
    wav = _wav(rng)
    want = np.asarray(jax_frontend.stft_power(jnp.asarray(wav), n_fft, hop, win, window, center))
    got = frontend.stft_power(torch.from_numpy(wav), n_fft, hop, win, window, center)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=STFT_ATOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("n_fft,hop,win,window,center", STFT_CASES[:4])
def test_stft_power_bf16_operands_match_jax(rng, n_fft, hop, win, window, center):
    """``precision="default"``: JAX's fast branch (bf16 operands, fp32 sums)."""
    wav = _wav(rng)
    want = np.asarray(jax_frontend.stft_power(jnp.asarray(wav), n_fft, hop, win, window, center,
                                              precision=jax.lax.Precision.DEFAULT))
    got = frontend.stft_power(torch.from_numpy(wav), n_fft, hop, win, window, center, precision="default")
    assert got.dtype == torch.float32
    assert np.linalg.norm(got.numpy() - want) <= FAST_REL * np.linalg.norm(want)
    exact = frontend.stft_power(torch.from_numpy(wav), n_fft, hop, win, window, center).numpy()
    assert np.linalg.norm(got.numpy() - exact) > FAST_REL * np.linalg.norm(exact)  # the operands were rounded


def test_stft_power_takes_one_waveform_and_checks_precision(rng):
    wav = _wav(rng, batch=1)
    one = frontend.stft_power(torch.from_numpy(wav[0]), 512, 128, 512)
    np.testing.assert_array_equal(one.numpy(), frontend.stft_power(torch.from_numpy(wav), 512, 128, 512).numpy())
    assert one.shape == (1, 257, 1 + 4000 // 128)
    with pytest.raises(ValueError, match="precision"):
        frontend.stft_power(torch.from_numpy(wav), 512, 128, 512, precision="high")


@pytest.mark.parametrize("representation", ["raw", "spectrogram", "mel_spectrogram"])
@pytest.mark.parametrize("normalize", [False, True])
def test_audio_processor_matches_jax(rng, representation, normalize):
    fields = dict(representation=representation, normalize=normalize, n_fft=512, hop_length=160, n_mels=64,
                  window="hamming")
    wav = _wav(rng)
    want = np.asarray(jax_frontend.AudioProcessor(JaxAudioConfig(**fields))(jnp.asarray(wav)))
    got = frontend.AudioProcessor(AudioConfig(**fields))(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape
    if representation == "raw":
        np.testing.assert_array_equal(got, want)
    elif normalize:
        np.testing.assert_allclose(got, want, atol=NORMALIZED_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, atol=STFT_ATOL * np.abs(want).max(), rtol=0)


def test_audio_processor_defaults_follow_jax(rng):
    """hop n_fft // 4 and win n_fft when unset; one waveform gets a batch axis."""
    cfg = AudioConfig(n_fft=256)
    proc = frontend.AudioProcessor(cfg)
    want_proc = jax_frontend.AudioProcessor(JaxAudioConfig(n_fft=256))
    assert (proc.hop_length, proc.win_length) == (want_proc.hop_length, want_proc.win_length) == (64, 256)
    wav = _wav(rng, batch=1)[0]
    got = proc(torch.from_numpy(wav))
    assert got.shape == (1, 128, 1 + 4000 // 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_proc(jnp.asarray(wav))), atol=NORMALIZED_ATOL, rtol=0)


def test_audio_config_has_the_jax_fields_and_checks():
    """The seven fields the port once dropped, with JAX's defaults and checks."""
    jax_fields = JaxAudioConfig.model_fields
    port = AudioConfig()
    for name, info in jax_fields.items():
        assert getattr(port, name) == info.default, name
    assert set(AudioConfig.__dataclass_fields__) == set(jax_fields)
    cfg = AudioConfig(n_fft="1024", hop_length="160", win_length=400, window="hamming", n_mels=64, center=False,
                      extra_config={"a": 1})
    assert (cfg.n_fft, cfg.hop_length) == (1024, 160)  # numbers given as strings, as pydantic's lax mode
    assert cfg.to_dict()["extra_config"] == {"a": 1}
    with pytest.raises(ValueError, match="window"):
        AudioConfig(window="blackman")
    with pytest.raises(ValueError, match="representation"):
        AudioConfig(representation="mfcc")
    spec = ModelSpec(name="birdmae", model_id="DBD-research-group/Bird-MAE-base", device="cpu",
                     audio_config={"n_fft": 512, "representation": "spectrogram"})
    assert spec.model_id == "DBD-research-group/Bird-MAE-base" and spec.audio_config.n_fft == 512
