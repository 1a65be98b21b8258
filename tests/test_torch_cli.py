"""The port's command line (``avex_tpu_torch/cli.py``) against the JAX package's
(``avex_tpu/cli.py``), both through click's ``CliRunner``.

One local checkpoint in the reference layout (``tests/test_torch_api.py``'s
tiny BEATs: 2 layers, 96 wide) named by a spec YAML with ``device: cpu`` is
read by both CLIs. Held: ``list-models`` prints the same table; ``embed``
over ``.wav`` files at 16 and 8 kHz, a ``.flac`` file (written here with
verbatim subframes and its MD5) and an 8 kHz ``.npy`` file with
``--npy-sr`` gives HDF5 rows within the fp32 tolerance of the BEATs tests
and the same ``.files.json``; ``embed --windowed --hop-seconds`` the same
offsets and rows; ``train -c ... -p k=v`` on JAX's tiny run config parses
the patches as JAX does, rejects an unknown key as JAX does and finishes;
``evaluate`` on the synthetic example config finishes; a duplicate ``serve
-m`` is JAX's usage error; ``serve`` in a child process on port 0 answers a
POST with the row of the port's in-process service (atol 1e-6) and exits 0
on SIGINT, its port free after; ``export`` writes a program for a ``.pt2``
name and refuses the TF formats with their error; ``scripts/torch_run_sweep.py``
expands a grid into the port's ``train`` commands.
"""

import hashlib
import io
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner
from scipy.io import wavfile

from avex_tpu.cli import cli as jax_cli
from avex_tpu.configs import RunConfig as JaxRunConfig

import avex_tpu_torch
from avex_tpu_torch.cli import cli
from avex_tpu_torch.configs import RunConfig
from avex_tpu_torch.evaluation import load_cached_embeddings
from avex_tpu_torch.serving import InferenceService, ServiceConfig
from tests.test_torch_api import SMALL, _reference_checkpoint
from tests.test_torch_beats import FP32_TOL
from tests.test_torch_data import EVAL_YAML
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

ROOT = Path(__file__).resolve().parents[1]
SERVE_ATOL = 1e-6
SERVE_TIMEOUT = 120  # seconds for the child to print its URL (imports, model build, warm-up)


def _crc8(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for byte in data:
        crc ^= byte << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
    return crc


def write_flac(path: Path, samples: np.ndarray, sample_rate: int, block: int = 4096) -> None:
    """A mono 16-bit FLAC stream of verbatim subframes, with its MD5."""
    samples = np.asarray(samples, np.int16)
    info = struct.pack(">HH", block, block) + b"\0" * 6  # block sizes; frame sizes unknown
    info += struct.pack(">Q", (sample_rate << 44) | (0 << 41) | (15 << 36) | len(samples))
    info += hashlib.md5(samples.astype("<i2").tobytes()).digest()
    out = b"fLaC" + bytes([0x80]) + len(info).to_bytes(3, "big") + info
    for number, start in enumerate(range(0, len(samples), block)):
        chunk = samples[start:start + block]
        assert number < 128  # a one-byte frame number
        header = bytes([0xFF, 0xF8, 0x70, 0x08, number]) + struct.pack(">H", len(chunk) - 1)
        frame = header + bytes([_crc8(header), 0x02]) + chunk.astype(">i2").tobytes()
        out += frame + struct.pack(">H", _crc16(frame))
    path.write_bytes(out)


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """The spec YAML naming one local reference-layout checkpoint, on the CPU."""
    root = tmp_path_factory.mktemp("checkpoint")
    state = _reference_checkpoint(np.random.default_rng(3), num_classes=4)
    ckpt = root / "model.pt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}}, ckpt)
    path = root / "spec.yml"
    path.write_text(yaml.safe_dump({
        "checkpoint_path": str(ckpt),
        "model_spec": {"name": "beats", "pretrained": False, "device": "cpu", "init_config": SMALL,
                       "audio_config": {"representation": "raw", "normalize": False}},
    }))
    return str(path)


@pytest.fixture(scope="module")
def audio(tmp_path_factory):
    root = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)

    def pcm(n):
        return (rng.standard_normal(n) * 0.1 * 32767).astype(np.int16)

    (root / "clips" / "deeper").mkdir(parents=True)
    wavfile.write(root / "clips" / "a.wav", 16000, pcm(24000))  # 1.5 s: centre-cropped
    wavfile.write(root / "clips" / "deeper" / "b.wav", 8000, pcm(6000))  # resampled, then padded
    write_flac(root / "clips" / "c.flac", pcm(20000), 16000)
    t = np.arange(8000) / 8000.0  # 8 kHz: JAX's --npy-sr test clip, a tone over noise
    np.save(root / "clips" / "d.npy",
            (0.3 * np.sin(2 * np.pi * 440 * t) + 0.01 * rng.standard_normal(8000)).astype(np.float32))
    (root / "long").mkdir()
    wavfile.write(root / "long" / "long.wav", 16000, pcm(60000))  # 3.75 s: windows and a padded tail
    return root


def _invoke(group, args):
    result = CliRunner().invoke(group, args, catch_exceptions=False)
    assert result.exit_code == 0, result.output
    return result.output


def _embed_both(spec, src, tmp_path, *extra):
    outs = {}
    for name, group in (("jax", jax_cli), ("port", cli)):
        out = tmp_path / f"{name}.h5"
        _invoke(group, ["embed", "-m", spec, "-i", str(src), "-o", str(out), "--clip-seconds", "1",
                        "--batch-size", "2", *extra])
        embs, _labels, meta = load_cached_embeddings(out)
        outs[name] = (embs, meta, json.loads(out.with_suffix(".files.json").read_text()))
    return outs["port"], outs["jax"]


def test_list_models_prints_the_same_table(capsys, monkeypatch):
    import avex_tpu.models.registry as jax_registry
    from avex_tpu.api.list_models import main as jax_main
    from avex_tpu.api.official_models import OFFICIAL_MODELS as JAX_OFFICIAL_MODELS

    import avex_tpu_torch.models.registry as registry
    from avex_tpu_torch.api.list_models import main
    from avex_tpu_torch.api.official_models import OFFICIAL_MODELS

    # Each registry as a fresh process holds it, the official entries: other
    # test files that share this worker register their own models in one
    # package's registry or the other's.
    for module, official in ((registry, OFFICIAL_MODELS), (jax_registry, JAX_OFFICIAL_MODELS)):
        monkeypatch.setattr(module, "_MODEL_REGISTRY",
                            {name: spec for name, spec in module._MODEL_REGISTRY.items() if name in official})
    table = _invoke(cli, ["list-models"])
    assert table == _invoke(jax_cli, ["list-models"])
    assert main() is None  # the console entry's exit code is 0
    mine = capsys.readouterr().out
    jax_main()
    assert mine == capsys.readouterr().out and mine.strip() == table.strip()


def test_embed_matches_jax(spec, audio, tmp_path):
    (got, meta, manifest), (want, want_meta, want_manifest) = _embed_both(
        spec, audio / "clips", tmp_path, "--npy-sr", "8000", "--layers", "last_layer,backbone.post_extract_proj")
    assert manifest == want_manifest
    assert [Path(row["path"]).name for row in manifest] == ["a.wav", "c.flac", "d.npy", "b.wav"]
    assert all(row["offset_samples"] == 0 for row in manifest)
    assert meta["aggregation"] == want_meta["aggregation"] == "mean"
    assert list(meta["layer_names"]) == list(want_meta["layer_names"])
    assert len(got) == len(want) == 1 and got[0].shape == want[0].shape == (4, 2 * 96)
    np.testing.assert_allclose(got[0], want[0], **FP32_TOL)


def test_embed_windowed_matches_jax(spec, audio, tmp_path):
    (got, _meta, manifest), (want, _want_meta, want_manifest) = _embed_both(
        spec, audio / "long", tmp_path, "--windowed", "--hop-seconds", "0.5")
    assert manifest == want_manifest
    assert [row["offset_samples"] for row in manifest] == [0, 8000, 16000, 24000, 32000, 40000, 48000]
    np.testing.assert_allclose(got[0], want[0], **FP32_TOL)


def _tiny_run_config(out):
    """JAX's tiny run config (``tests/unittests/test_cli.py``), on the CPU."""
    return {
        "model_spec": {"name": "beats", "pretrained": False,
                       "init_config": {"encoder_layers": 1, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 128,
                                       "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0,
                                       "encoder_layerdrop": 0.0},
                       "audio_config": {"representation": "raw", "normalize": False, "target_length_seconds": 1,
                                        "window_selection": "random"}},
        "training_params": {"train_epochs": 1, "lr": 1e-3, "batch_size": 2},
        "dataset_config": {"train_datasets": [{"name": "cli_smoke", "kind": "synthetic", "num_samples": 4,
                                               "num_classes": 3, "clip_seconds": 1.0}]},
        "output_dir": str(out), "seed": 0, "num_workers": 0, "device": "cpu",
    }


def test_train_patches_parse_as_jax_and_the_run_finishes(tmp_path):
    path = tmp_path / "run.yml"
    path.write_text(yaml.safe_dump(_tiny_run_config(tmp_path / "out")))
    patched = tmp_path / "patched_out"
    patches = [f"output_dir={patched}", "training_params.lr=0.002"]
    got, want = RunConfig.from_sources(str(path), patches), JaxRunConfig.from_sources(str(path), patches)
    assert got.output_dir == want.output_dir == str(patched)
    assert got.training_params.lr == want.training_params.lr == 0.002
    assert got.training_params.batch_size == want.training_params.batch_size == 2
    args = ["train", "-c", str(path)] + [a for p in patches for a in ("-p", p)]
    assert "Training finished: best_val_acc=" in _invoke(cli, args)
    assert (patched / "final_model").exists()  # the patch won over the YAML

    bad = dict(_tiny_run_config(tmp_path / "out"), not_a_real_field=1)
    bad_path = tmp_path / "bad.yml"
    bad_path.write_text(yaml.safe_dump(bad))
    for group in (cli, jax_cli):
        assert CliRunner().invoke(group, ["train", "-c", str(bad_path)]).exit_code != 0


def test_evaluate_finishes(tmp_path):
    out = _invoke(cli, ["evaluate", "-c", str(EVAL_YAML), "-p", "device=cpu", "-p", f"save_dir={tmp_path}",
                        "-p", "eval_modes=[probe]", "-p", "training_params.train_epochs=1"])
    assert "Evaluation finished: 1 experiment x set results" in out
    assert (tmp_path / "evaluation_metadata.jsonl").exists()


def test_serve_refuses_a_model_given_twice_as_jax():
    results = [CliRunner().invoke(group, ["serve", "-m", "esp_aves2_sl_beats_all", "-m", "esp_aves2_sl_beats_all"])
               for group in (cli, jax_cli)]
    for result in results:
        assert result.exit_code == 2
        assert "model(s) given more than once: esp_aves2_sl_beats_all" in result.output
    assert results[0].output == results[1].output


def _port_is_free(port: int) -> bool:
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)  # as the server binds: TIME_WAIT is no listener
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return False
    return True


def test_serve_in_the_foreground_answers_and_exits_on_sigint(spec, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), LOG_LEVEL="WARNING")
    child = subprocess.Popen(
        [sys.executable, "-m", "avex_tpu_torch.cli", "serve", "-m", spec, "--port", "0", "--clip-seconds", "1",
         "--max-batch", "4"], cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline, url, lines = time.monotonic() + SERVE_TIMEOUT, None, []
        while url is None and time.monotonic() < deadline:
            line = child.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("Serving "):
                url = line.rsplit(" on ", 1)[1].strip()
        assert url is not None, "".join(lines)
        assert line.startswith(f"Serving {spec} (embed) on http://127.0.0.1:")
        wav = (np.random.default_rng(4).standard_normal(16000) * 0.1).astype(np.float32)
        body = io.BytesIO()
        np.save(body, wav)
        request = urllib.request.Request(url + "/embed", data=body.getvalue(), method="POST")
        with urllib.request.urlopen(request, timeout=60) as response:
            got = np.asarray(json.loads(response.read())["output"], np.float32)
        child.send_signal(signal.SIGINT)
        assert child.wait(timeout=30) == 0, child.stdout.read()
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert _port_is_free(int(url.rsplit(":", 1)[1]))
    service = InferenceService(avex_tpu_torch.load_model(spec, return_features_only=True),
                               ServiceConfig(clip_seconds=1.0, max_batch=4))
    try:
        want = np.asarray(service.submit(wav).result(timeout=60))
    finally:
        service.close()
    assert got.shape == want.shape == (96,)
    np.testing.assert_allclose(got, want, rtol=0, atol=SERVE_ATOL)


def test_export_writes_a_program_and_refuses_the_tf_formats(spec, tmp_path):
    out = tmp_path / "model.pt2"
    assert "torch.export program written to" in _invoke(cli, ["export", "-m", spec, "-o", str(out),
                                                                "--clip-seconds", "1"])
    program = torch.export.load(str(out)).module()
    assert program(torch.zeros((3, 16000))).shape == (3, 96)
    assert json.loads((tmp_path / "avex_tpu_export.json").read_text())["n_samples"] == 16000
    for args, message in ((["--format", "savedmodel"], "TF SavedModel export needs TensorFlow"),
                          ([], "TF SavedModel export needs TensorFlow"),  # no suffix: savedmodel, as in JAX
                          (["--format", "tflite"], "TFLite export needs TensorFlow"),
                          (["--format", "pt2", "--quantize-float16"], "applies to tflite exports only")):
        result = CliRunner().invoke(cli, ["export", "-m", spec, "-o", str(tmp_path / "artifact"), *args])
        assert result.exit_code == 1 and message in result.output, result.output


def test_sweep_runner_expands_the_grid_into_port_train_commands(tmp_path):
    """``scripts/torch_run_sweep.py`` (``scripts/run_sweep.py``'s copy) runs the port's ``train``."""
    sweep = tmp_path / "sweep.yml"
    sweep.write_text("base_config: cfg.yml\ngrid:\n  training_params.lr: [0.001, 0.0003]\n"
                     "  training_params.batch_size: [8, 16]\n")
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_run_sweep.py"), str(sweep), "--dry-run"],
                         capture_output=True, text=True, check=True).stdout
    lines = [line for line in out.splitlines() if line.startswith("::")]
    assert len(lines) == 4  # 2 x 2 grid
    assert all(" -m avex_tpu_torch.cli train -c cfg.yml " in line for line in lines)
    assert "training_params.lr=0.001" in lines[0] and "run_name=sweep_3" in lines[3]
