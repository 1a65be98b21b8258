"""The port's small modules against the JAX package's: activity detection,
output fingerprints, the deprecated ``get_model`` and the profiling helpers
(``AVEX_PROFILE_DIR`` on the ``Trainer``)."""

import json
import warnings

import numpy as np
import pytest
import torch

from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.models.get_model import get_model as jax_get_model
from avex_tpu.preprocessing import ActivityDetector as JaxActivityDetector
from avex_tpu.preprocessing import frame_energy as jax_frame_energy
from avex_tpu.preprocessing import select_active_window as jax_select_active_window
from avex_tpu.utils.fingerprints import fingerprint as jax_fingerprint
from avex_tpu.utils.profiling import StepTimer as JaxStepTimer

from avex_tpu_torch.configs import ModelSpec, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.models.get_model import get_model
from avex_tpu_torch.preprocessing import ActivityDetector, frame_energy, select_active_window
from avex_tpu_torch.training import Trainer
from avex_tpu_torch.utils import fingerprints, profiling
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

TINY_BEATS = {"encoder_layers": 1, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 96,
              "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0, "encoder_layerdrop": 0.0}
RAW_AUDIO = {"representation": "raw", "normalize": False, "target_length_seconds": 1}


def _bursty(seed, n=48000):
    """Noise with a loud tone burst somewhere in the middle."""
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal(n) * 0.01).astype(np.float32)
    start = int(rng.integers(n // 4, n // 2))
    t = np.arange(8000) / 16000
    wav[start: start + 8000] += 0.5 * np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    return wav


@pytest.mark.parametrize("kwargs", [{}, {"frame": 256, "hop": 128, "threshold_db": 3.0, "floor_percentile": 20.0}])
def test_activity_detector_matches_jax(kwargs):
    wav = _bursty(1)
    mine, ref = ActivityDetector(**kwargs), JaxActivityDetector(**kwargs)
    np.testing.assert_array_equal(mine(wav), ref(wav))
    assert mine.activity_ratio(wav) == ref.activity_ratio(wav)
    assert 0.0 < mine.activity_ratio(wav) < 1.0
    frame, hop = kwargs.get("frame", 400), kwargs.get("hop", 160)
    np.testing.assert_array_equal(frame_energy(wav, frame, hop), jax_frame_energy(wav, frame, hop))
    np.testing.assert_array_equal(frame_energy(wav[:100]), jax_frame_energy(wav[:100]))  # shorter than a frame


@pytest.mark.parametrize("target_len", [4000, 16000, 48000, 60000])
def test_select_active_window_matches_jax(target_len):
    wav = _bursty(2)
    window, start = select_active_window(wav, target_len)
    want_window, want_start = jax_select_active_window(wav, target_len)
    assert start == want_start and window.dtype == np.float32
    np.testing.assert_array_equal(window, want_window)
    assert window.shape == (target_len,)
    custom = ActivityDetector(frame=256, hop=64)
    got = select_active_window(wav, target_len, custom)
    want = jax_select_active_window(wav, target_len, JaxActivityDetector(frame=256, hop=64))
    assert got[1] == want[1]


def test_fingerprint_and_numerics_profile():
    out = np.random.default_rng(3).standard_normal((4, 7)).astype(np.float32)
    assert fingerprints.fingerprint(out) == jax_fingerprint(out)
    assert fingerprints.fingerprint(torch.from_numpy(out)) == jax_fingerprint(out)
    assert fingerprints.fingerprint(out, decimals=2) == jax_fingerprint(out, decimals=2)
    assert fingerprints.fingerprint(out) != fingerprints.fingerprint(out + 1e-3)
    major, minor = torch.__version__.split("+")[0].split(".")[:2]
    assert fingerprints.numerics_profile() == f"torch_{major}_{minor}"


def test_get_model_is_a_deprecated_alias():
    spec = dict(name="beats", pretrained=False, init_config=TINY_BEATS)
    with pytest.warns(DeprecationWarning, match="build_model_from_spec"):
        model = get_model(ModelSpec(**spec), num_classes=3, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jax_model = jax_get_model(JaxModelSpec(**spec), num_classes=3)
    assert [w.category for w in caught] == [DeprecationWarning]
    assert model.num_classes == jax_model.num_classes == 3 and model.device.type == "cpu"


def test_step_timer_and_annotate():
    for timer in (profiling.StepTimer(), JaxStepTimer()):
        assert timer.summary() == {"steps": 0}
        for _ in range(3):
            with timer.step():
                pass
        summary = timer.summary()
        assert summary["steps"] == 3 and summary["min_s"] <= summary["mean_s"] <= summary["max_s"]
        assert summary["total_s"] >= summary["max_s"]
    with profiling.annotate("region"):
        torch.ones(2).sum()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("matmul_region"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "matmul_region" for e in events)


def test_trainer_traces_its_first_epoch_under_avex_profile_dir(tmp_path, monkeypatch):
    profile_dir = tmp_path / "profile"
    monkeypatch.setenv("AVEX_PROFILE_DIR", str(profile_dir))
    config = RunConfig(
        model_spec=ModelSpec(name="beats", pretrained=False, init_config=TINY_BEATS, audio_config=RAW_AUDIO,
                             device="cpu"),
        training_params=TrainingParams(train_epochs=2, lr=1e-3, batch_size=2, log_steps=100),
        scheduler=SchedulerConfig(name="none"), output_dir=str(tmp_path / "run"), seed=0, device="cpu",
    )
    from avex_tpu_torch.models.factory import build_model_from_spec

    model = build_model_from_spec(config.model_spec, num_classes=2)
    rng = np.random.default_rng(4)
    batches = [{"raw_wav": (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32), "label": np.array([0, 1])}]
    result = Trainer(model, config, batches).train()
    assert len(result["history"]) == 2
    traces = list(profile_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1  # the first epoch only
    assert json.loads(traces[0].read_text())["traceEvents"]
