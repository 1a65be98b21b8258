"""Serving in the port (``avex_tpu_torch.serving``) against the JAX package's.

The contract of ``tests/unittests/test_serving.py``: request timing never
changes a result (a clip embedded alone, in a coalesced batch, or through
HTTP gives the same row) and batch shapes stay inside the power-of-two
buckets. It runs on the port's tiny BEATs on the CPU, float and int8, with
the weights carried from the JAX package's model (the int8 tree as JAX
quantized it). Each served row is held to the port's own direct extraction
(rtol 1e-4 / atol 1e-5, as the JAX test) and to the JAX package fed the same
clip and weights: fp32 atol 5e-5 / rtol 1e-4 for the float model; rel L2
≤ 5e-3 for int8. There an activation within ~1e-5 of a rounding boundary can
take the neighbouring int8 level on one side only (the float inputs differ by
rounding upstream), and in this 1-layer random model one such flip in the
q/k/v input reaches every query through the attention: 2.7e-3 on one clip of
twelve, 1e-7 on the others. The int8 and float models differ by ~8e-3, so
the bound still tells them apart; ``tests/test_torch_int8.py`` holds each
int8 layer to JAX's on the same input exactly.

Every future waits with a timeout, and every server binds port 0 and stops on
leaving its ``with`` block.
"""

import http.client
import io
import json
import os
import sys
import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

import avex_tpu
from avex_tpu import _native as jax_native
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.ops import audio as jax_audio
from avex_tpu.serving import InferenceService as JaxInferenceService
from avex_tpu.serving import ServiceConfig as JaxServiceConfig
from avex_tpu.serving.http import _decode_payload as jax_decode_payload
from avex_tpu.serving.service import _bucket as jax_bucket

import avex_tpu_torch
from avex_tpu_torch import _native
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models.beats import params_from_jax
from avex_tpu_torch.ops.audio import pad_or_window_np, window_start
from avex_tpu_torch.serving import AvexHTTPServer, InferenceService, ServiceConfig, ServicePool
from avex_tpu_torch.serving.http import _decode_payload
from avex_tpu_torch.serving.service import _bucket
from tests.test_torch_beats import _rel

TIMEOUT = 120
CLIP = 8000  # 0.5 s at 16 kHz
KINDS = pytest.mark.parametrize("kind", ["float", "int8"])
INT8_JAX_REL = 5e-3


def _init_config(width=64):
    return {
        "encoder_layers": 1,
        "encoder_embed_dim": width,
        "encoder_ffn_embed_dim": 2 * width,
        "encoder_attention_heads": 4,
        "embed_dim": 32,
        "dropout": 0.0,
        "attention_dropout": 0.0,
        "encoder_layerdrop": 0.0,
    }


def _spec(cls, width=64, **init):
    return cls(name="beats", pretrained=False, init_config=dict(_init_config(width), **init),
               audio_config={"representation": "raw", "normalize": False})


def _pair(quantize=False, width=64, num_classes=None):
    """(JAX model, port model on the CPU) with the same weights; with
    ``quantize`` the JAX model is quantized and the port carries its tree."""
    jax_model = avex_tpu.build_model_from_spec(_spec(JaxModelSpec, width), num_classes=num_classes)
    if quantize:
        jax_model.quantize("int8")
    port = avex_tpu_torch.build_model_from_spec(_spec(ModelSpec, width, quantize_encoder=quantize),
                                                device="cpu", num_classes=num_classes)
    port.load_port_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])),
                              strict=True)
    return jax_model, port


@pytest.fixture(scope="module")
def models():
    return {"float": _pair(), "int8": _pair(quantize=True)}


@pytest.fixture()
def clips():
    rng = np.random.default_rng(3)
    return [rng.standard_normal(CLIP).astype(np.float32) * 0.1 for _ in range(8)]


def _direct(model, wav):
    """The row of ``wav`` extracted alone, as the service prepares it."""
    clip, mask = pad_or_window_np(wav, CLIP, window_selection="center")
    model.register_hooks_for_layers(["last_layer"])
    out = model.extract_embeddings(clip[None], padding_mask=mask[None], aggregation="mean")
    return out[0].float().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)[0]


def _check_row(kind, models, wav, row):
    """A served row against the port's direct extraction and the JAX package's."""
    jax_model, port = models[kind]
    np.testing.assert_allclose(row, _direct(port, wav), rtol=1e-4, atol=1e-5)
    want = _direct(jax_model, wav)
    if kind == "float":
        np.testing.assert_allclose(row, want, rtol=1e-4, atol=5e-5)
    else:
        assert _rel(row, want) <= INT8_JAX_REL


def _config(**kw):
    return ServiceConfig(clip_seconds=0.5, **kw)


@KINDS
def test_single_request_matches_direct(models, clips, kind):
    with InferenceService(models[kind][1], _config(max_wait_ms=1)) as svc:
        row = svc.infer(clips[0], timeout=TIMEOUT)
    assert row.ndim == 1 and row.shape[0] == 64 and row.dtype == np.float32
    _check_row(kind, models, clips[0], row)


@KINDS
def test_concurrent_requests_coalesce_into_one_batch(models, clips, kind):
    """8 submits inside the wait window → one bucket-8 dispatch, and every
    caller gets the row of its own clip."""
    with InferenceService(models[kind][1], _config(max_batch=8, max_wait_ms=500)) as svc:
        rows = [f.result(timeout=TIMEOUT) for f in [svc.submit(c) for c in clips]]
        stats = svc.info()["stats"]
    assert stats["requests"] == 8 and stats["batches"] == 1
    assert stats["bucket_counts"] == {8: 1}
    for clip, row in zip(clips, rows):
        _check_row(kind, models, clip, row)


@KINDS
def test_partial_batch_pads_to_bucket(models, clips, kind):
    """3 requests round up to bucket 4; the padding row never leaks."""
    with InferenceService(models[kind][1], _config(max_batch=8, max_wait_ms=500)) as svc:
        rows = [f.result(timeout=TIMEOUT) for f in [svc.submit(c) for c in clips[:3]]]
        stats = svc.info()["stats"]
    assert stats["bucket_counts"] == {4: 1} and stats["padded_rows"] == 1
    for clip, row in zip(clips[:3], rows):
        _check_row(kind, models, clip, row)


@KINDS
def test_short_and_long_clips_are_padded_or_cropped(models, clips, kind):
    """A half-length clip is right-padded with its samples masked; a longer
    one is center-cropped."""
    short, long = clips[0][:4000], np.concatenate([clips[1], clips[2][:3000]])
    with InferenceService(models[kind][1], _config(max_batch=2, max_wait_ms=200)) as svc:
        rows = [f.result(timeout=TIMEOUT) for f in [svc.submit(short), svc.submit(long)]]
    for wav, row in zip((short, long), rows):
        _check_row(kind, models, wav, row)


def test_submit_resamples_foreign_rates(models):
    """A clip at 8 kHz equals submitting the explicitly resampled waveform."""
    rng = np.random.default_rng(11)
    t = np.arange(4000) / 8000.0
    tone = (0.3 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(4000)).astype(np.float32)
    with InferenceService(models["float"][1], _config(max_wait_ms=1)) as svc:
        a = svc.infer(tone, sr=8000, timeout=TIMEOUT)
        b = svc.infer(_native.resample(tone, 8000, 16000), timeout=TIMEOUT)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@KINDS
def test_service_rows_match_the_jax_service(models, clips, kind):
    """The JAX package's service and the port's, fed the same clips."""
    jax_model, port = models[kind]
    batch = [clips[0], clips[1][:5000], clips[2]]
    with JaxInferenceService(jax_model, JaxServiceConfig(clip_seconds=0.5, max_batch=4, max_wait_ms=500)) as jsvc:
        want = [f.result(timeout=TIMEOUT) for f in [jsvc.submit(c) for c in batch]]
    with InferenceService(port, _config(max_batch=4, max_wait_ms=500)) as svc:
        got = [f.result(timeout=TIMEOUT) for f in [svc.submit(c) for c in batch]]
    for g, w in zip(got, want):
        if kind == "float":
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=5e-5)
        else:
            assert _rel(g, np.asarray(w)) <= INT8_JAX_REL


def test_logits_mode_matches_jax(clips):
    jax_model, port = _pair(num_classes=3)
    with InferenceService(port, _config(mode="logits", max_wait_ms=1)) as svc:
        row = svc.infer(clips[0], timeout=TIMEOUT)
    with JaxInferenceService(jax_model, JaxServiceConfig(clip_seconds=0.5, mode="logits", max_wait_ms=1)) as jsvc:
        want = jsvc.submit(clips[0]).result(timeout=TIMEOUT)
    assert row.shape == (3,)
    np.testing.assert_allclose(row, np.asarray(want), rtol=1e-4, atol=5e-5)


@KINDS
def test_warmup_runs_expected_buckets(models, kind):
    with InferenceService(models[kind][1], _config(max_batch=4, max_wait_ms=5)) as svc:
        svc.warmup(timeout=TIMEOUT)
        buckets = set(svc.info()["stats"]["bucket_counts"])
    assert buckets == {1, 4}


def test_closed_service_rejects_submissions(models):
    svc = InferenceService(models["float"][1], _config())
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros(CLIP, np.float32))


def test_config_validation():
    with pytest.raises(ValueError, match="max_batch"):
        ServiceConfig(max_batch=0)
    with pytest.raises(ValueError, match="mode"):
        ServiceConfig(mode="classify")


def test_bucket_rounding_matches_jax():
    assert [_bucket(n, 32) for n in (1, 2, 3, 5, 17, 32)] == [1, 2, 4, 8, 32, 32]
    assert _bucket(9, 12) == 12  # capped at a non-power-of-two max_batch
    for cap in (1, 12, 32):
        assert [_bucket(n, cap) for n in range(1, 70)] == [jax_bucket(n, cap) for n in range(1, 70)]


def test_close_resolves_raced_submissions(models):
    """A request found behind the shutdown sentinel resolves with an error.
    (submit() and close() share a lock, so the test queues one there itself,
    both items at once, before the batcher can wake.)"""
    service = InferenceService(models["float"][1], _config(max_batch=2))
    try:
        raced: Future = Future()
        q = service._queue
        with q.mutex:
            q.queue.extend([None, (np.zeros(CLIP, np.float32), np.ones(CLIP, bool), raced)])
            q.unfinished_tasks += 2
            q.not_empty.notify()
        with pytest.raises(RuntimeError, match="closed"):
            raced.result(timeout=30)
        service._thread.join(timeout=30)
        assert service._queue.qsize() == 0
    finally:
        service.close()


def _npy(wav):
    buf = io.BytesIO()
    np.save(buf, wav)
    return buf.getvalue()


def _wav_bytes(wav, sr=16000):
    buf = io.BytesIO()
    wavfile.write(buf, sr, (wav * 32767).astype(np.int16))
    return buf.getvalue()


@KINDS
def test_http_roundtrip(models, clips, kind):
    """npy and WAV POSTs, JSON with sr, healthz/info, 404 and mode mismatch."""
    port = models[kind][1]
    with InferenceService(port, _config(max_batch=4, max_wait_ms=5)) as svc, \
            AvexHTTPServer(svc, port=0, request_timeout=TIMEOUT) as server:
        conn = http.client.HTTPConnection(server.host, server.port, timeout=TIMEOUT)
        try:
            conn.request("POST", "/embed", body=_npy(clips[0]))
            resp = json.loads(conn.getresponse().read())
            assert resp["shape"] == [64]
            _check_row(kind, models, clips[0], np.asarray(resp["output"], np.float32))

            conn.request("POST", "/embed", body=_wav_bytes(clips[1]))
            wav_row = np.asarray(json.loads(conn.getresponse().read())["output"], np.float32)
            decoded, _ = _native.decode_audio_bytes(_wav_bytes(clips[1]))
            np.testing.assert_allclose(wav_row, _direct(port, decoded), rtol=1e-4, atol=1e-5)

            conn.request("POST", "/embed", body=json.dumps({"wav": clips[1][::2].tolist(), "sr": 8000}))
            assert json.loads(conn.getresponse().read())["shape"] == [64]

            conn.request("GET", "/healthz")
            assert json.loads(conn.getresponse().read())["status"] == "ok"
            conn.request("GET", "/info")
            info = json.loads(conn.getresponse().read())
            assert info["mode"] == "embed" and info["sample_rate"] == 16000
            assert info["stats"]["requests"] >= 3
            conn.request("GET", "/nope")
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 404
            conn.request("POST", "/logits", body=_npy(clips[0]))
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 409
        finally:
            conn.close()


def test_http_concurrent_posts_batch_together(models, clips):
    """Concurrent HTTP clients ride one device batch."""
    port = models["int8"][1]
    with InferenceService(port, _config(max_batch=4, max_wait_ms=500)) as svc, \
            AvexHTTPServer(svc, port=0, request_timeout=TIMEOUT) as server:
        results = {}

        def post(i):
            conn = http.client.HTTPConnection(server.host, server.port, timeout=TIMEOUT)
            try:
                conn.request("POST", "/embed", body=_npy(clips[i]))
                results[i] = np.asarray(json.loads(conn.getresponse().read())["output"], np.float32)
            finally:
                conn.close()

        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        stats = svc.info()["stats"]
    assert len(results) == 4
    for i in range(4):
        _check_row("int8", models, clips[i], results[i])
    assert stats["batches"] < 4


def test_payload_sniffing_matches_jax(tmp_path):
    """WAV, npy and JSON bodies decode as the JAX front end decodes them."""
    tone = (0.25 * np.sin(2 * np.pi * 330 * np.arange(8000) / 16000)).astype(np.float32)
    stereo = np.stack([tone, 0.5 * tone], axis=1)
    bodies = {
        "wav": _wav_bytes(tone),
        "wav_stereo": _wav_bytes(stereo),
        "npy": _npy(tone),
        "json": json.dumps({"wav": tone[:16].tolist(), "sr": 8000}).encode(),
    }
    for name, body in bodies.items():
        wav, sr = _decode_payload(body, 16000 if name == "npy" else None)
        want_wav, want_sr = jax_decode_payload(body, 16000 if name == "npy" else None)
        assert sr == want_sr, name
        np.testing.assert_array_equal(wav, want_wav, err_msg=name)
    wav, sr = _decode_payload(bodies["wav"], None)
    assert sr == 16000
    np.testing.assert_allclose(wav, tone, atol=2e-4)


def test_native_audio_matches_jax():
    """The port's copy of the native library decodes and resamples exactly
    as the JAX package's (the same C++ source), and is built."""
    rng = np.random.default_rng(5)
    wav = (0.2 * rng.standard_normal(12345)).astype(np.float32)
    assert _native.native_available()
    for sr_in, sr_out in ((8000, 16000), (44100, 16000), (16000, 16000)):
        np.testing.assert_array_equal(_native.resample(wav, sr_in, sr_out), jax_native.resample(wav, sr_in, sr_out))
    body = _wav_bytes(np.stack([wav, -wav], axis=1), sr=22050)
    for mono in (True, False):
        got, want = _native.decode_audio_bytes(body, mono=mono), jax_native.decode_audio_bytes(body, mono=mono)
        assert got[1] == want[1] == 22050
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("dtype", [np.int16, np.float32, np.int32])
@pytest.mark.parametrize("native", [True, False], ids=["native", "scipy"])
def test_decode_wav_files_match_jax(tmp_path, monkeypatch, dtype, native):
    """WAV files in three sample formats, stereo mixed down, through the
    native parser and through the scipy fallback: as the JAX package decodes
    them."""
    rng = np.random.default_rng(6)
    wav = (rng.standard_normal((4000, 2)) * 0.1).astype(np.float32)
    scale = {np.int16: 32767, np.float32: 1, np.int32: 2**31 - 1}[dtype]
    path = tmp_path / "x.wav"
    wavfile.write(path, 22050, (wav * scale).astype(dtype))
    if not native:
        monkeypatch.setattr(_native, "_get_lib", lambda: None)
        monkeypatch.setattr(jax_native, "_get_lib", lambda: None)
    for mono in (True, False):
        got, want = _native.decode_wav(str(path), mono=mono), jax_native.decode_wav(str(path), mono=mono)
        assert got[1] == want[1] == 22050
        np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(_native.decode_wav(str(path))[0], wav.mean(axis=1), atol=2e-4)


def test_decode_flac_rejects_a_corrupt_stream(tmp_path):
    path = tmp_path / "bad.flac"
    path.write_bytes(b"fLaC" + bytes(64))
    with pytest.raises(ValueError, match="FLAC"):
        _native.decode_flac(str(path))
    with pytest.raises(ValueError, match="FLAC"):
        _native.decode_audio_bytes(path.read_bytes())


def test_many_producers_keep_every_row_and_count(models):
    """Twice as many producer threads as cores and a short switch interval:
    every future resolves to its own clip's row, and the request count loses
    no update."""
    port = models["int8"][1]
    rng = np.random.default_rng(13)
    clips = [rng.standard_normal(CLIP).astype(np.float32) * 0.1 for _ in range(6)]
    want = [_direct(port, c) for c in clips]
    n_threads, per_thread = 2 * (os.cpu_count() or 4), 3
    results, lock = [], threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with InferenceService(port, _config(max_batch=8, max_wait_ms=5)) as svc:
            def producer(t):
                for j in range(per_thread):
                    i = (t + j) % len(clips)
                    row = svc.submit(clips[i]).result(timeout=TIMEOUT)
                    with lock:
                        results.append((i, row))

            threads = [threading.Thread(target=producer, args=(t,)) for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            stats = svc.info()["stats"]
    finally:
        sys.setswitchinterval(interval)
    assert stats["requests"] == len(results) == n_threads * per_thread
    assert sum(stats["bucket_counts"].values()) == stats["batches"]
    for i, row in results:
        np.testing.assert_allclose(row, want[i], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("length", [5000, 8000, 11001], ids=["pad", "exact", "crop"])
@pytest.mark.parametrize("selection", ["center", "start", "random"])
def test_pad_or_window_matches_jax(length, selection):
    wav = np.arange(length, dtype=np.float32)
    got = pad_or_window_np(wav, CLIP, selection, rng=np.random.default_rng(0))
    want = jax_audio.pad_or_window_np(wav, CLIP, selection, rng=np.random.default_rng(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert window_start(20000, CLIP, "center") == jax_audio.window_start(20000, CLIP, "center")
    with pytest.raises(ValueError, match="window selection"):
        window_start(20000, CLIP, "middle")


# ----------------------------------------------------------------------
# Multi-model co-hosting (ServicePool)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pool_models(models):
    """A float and an int8 64-d BEATs and a 48-d one, so routing is observable."""
    small = _pair(width=48)[1]
    pool = ServicePool.from_models(
        {"float": models["float"][1], "int8": models["int8"][1], "small": small},
        config=_config(max_batch=4, max_wait_ms=5),
    )
    yield pool, small
    pool.close()


def test_pool_routes_to_the_named_model(models, pool_models):
    pool, small = pool_models
    clip = np.random.default_rng(7).standard_normal(CLIP).astype(np.float32) * 0.1
    before = {name: pool.get(name).info()["stats"]["requests"] for name in pool}
    rows = {name: pool.get(name).infer(clip, timeout=TIMEOUT) for name in pool}
    assert rows["float"].shape == rows["int8"].shape == (64,) and rows["small"].shape == (48,)
    _check_row("float", models, clip, rows["float"])
    _check_row("int8", models, clip, rows["int8"])
    np.testing.assert_allclose(rows["small"], _direct(small, clip), rtol=1e-4, atol=1e-5)
    assert not np.array_equal(rows["float"], rows["int8"])
    for name in pool:
        assert pool.get(name).info()["stats"]["requests"] == before[name] + 1


def test_pool_warmup_forwards_buckets(models):
    pool = ServicePool.from_models({"a": models["int8"][1]}, config=_config(max_batch=8, max_wait_ms=5))
    try:
        pool.warmup(buckets=[1, 2, 8], timeout=TIMEOUT)
        assert {1, 2, 8} <= set(pool.get("a").info()["stats"]["bucket_counts"])
    finally:
        pool.close()


def test_pool_contract():
    pool = ServicePool()
    with pytest.raises(RuntimeError, match="empty"):
        _ = pool.default
    with pytest.raises(KeyError, match="unknown model"):
        pool.get("nope")
    with pytest.raises(ValueError, match="already pooled"):
        pool.add("a", object()).add("a", object())


def test_pool_http_routing(models, pool_models):
    """/models roster, per-model routes, bare routes = default model, 404
    with the roster for unknown names."""
    pool, _ = pool_models
    clip = np.random.default_rng(9).standard_normal(CLIP).astype(np.float32) * 0.1
    body = _npy(clip)
    with AvexHTTPServer(pool, port=0, request_timeout=TIMEOUT) as server:
        conn = http.client.HTTPConnection(server.host, server.port, timeout=TIMEOUT)
        try:
            conn.request("GET", "/models")
            roster = json.loads(conn.getresponse().read())
            assert roster["default"] == "float"
            assert sorted(roster["models"]) == ["float", "int8", "small"]

            conn.request("POST", "/models/small/embed", body=body)
            assert json.loads(conn.getresponse().read())["shape"] == [48]
            conn.request("POST", "/models/int8/embed", body=body)
            _check_row("int8", models, clip, np.asarray(json.loads(conn.getresponse().read())["output"], np.float32))
            conn.request("POST", "/models/float/embed", body=body)
            named = json.loads(conn.getresponse().read())
            conn.request("POST", "/embed", body=body)
            bare = json.loads(conn.getresponse().read())
            assert bare["output"] == named["output"]
            _check_row("float", models, clip, np.asarray(bare["output"], np.float32))

            conn.request("GET", "/models/small/info")
            assert json.loads(conn.getresponse().read())["mode"] == "embed"
            conn.request("POST", "/models/ghost/embed", body=body)
            resp = conn.getresponse()
            assert resp.status == 404
            assert json.loads(resp.read())["models"] == ["float", "int8", "small"]
        finally:
            conn.close()
