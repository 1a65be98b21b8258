"""The command line's bodies, without click.

Each command of ``avex_tpu/cli.py`` is a plain function here, so a program
(``chip_smoke.py``, a notebook) runs it with no ``click`` installed;
``avex_tpu_torch/cli.py`` is the click group over them. ``source`` names a
model as ``load_model`` takes it: a registry key, a spec YAML path or a
:class:`~avex_tpu_torch.configs.ModelSpec`. The device is the spec's
(``cuda`` unless it says ``cpu``); without a card ``cuda`` raises and nothing
moves to the CPU.

- :func:`train` / :func:`evaluate`: a config YAML with ``key=value``
  patches, then ``run_train.main`` / ``run_evaluate.main``;
- :func:`list_models`: the registry table;
- :func:`embed`: audio files (``*.wav``, ``*.flac``, ``*.npy``, sorted,
  recursive) → one row per file (centre crop) or per window
  (``windowed``) → the HDF5 cache and the ``.files.json`` manifest. Its
  first half, :func:`embed_batches`, yields the batches and fills the
  manifest rows; :func:`embed_mesh` decides the ring. The HDF5 write needs
  ``h5py``; a machine without it drives the batches into
  ``evaluation.extract_embeddings`` (the loop the cache writer feeds from);
- :func:`export`: a ``torch.export`` program (``pt2``); the TF formats raise;
- :func:`serve`: a :class:`ServicePool` behind :class:`AvexHTTPServer`, served
  on the calling thread until ``KeyboardInterrupt``.

A command's usage fault raises :class:`UsageError`, any other refusal
:class:`CommandError`; the CLI prints them as click's errors.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from avex_tpu_torch.configs import ModelSpec

logger = logging.getLogger(__name__)

__all__ = [
    "CommandError",
    "UsageError",
    "embed",
    "embed_batches",
    "embed_mesh",
    "estimated_tokens",
    "evaluate",
    "export",
    "find_audio_files",
    "list_models",
    "model_sample_rate",
    "serve",
    "split_layers",
    "train",
]

Source = Union[str, ModelSpec]
Echo = Callable[[str], None]


class CommandError(Exception):
    """A command refused its inputs (the CLI prints it as ``Error: ...``)."""


class UsageError(CommandError):
    """A command was called wrongly (the CLI prints its usage, exit code 2)."""


def _echo(message: str) -> None:
    print(message, flush=True)


def split_layers(layers: str) -> List[str]:
    """A comma list of layer selectors → its entries."""
    return [s.strip() for s in layers.split(",") if s.strip()]


def _load(source: Source, **kwargs: Any):
    from avex_tpu_torch.models.load import load_model

    return load_model(source, **kwargs)


def _source_name(source: Source) -> str:
    return source.name if isinstance(source, ModelSpec) else str(source)


# ---------------------------------------------------------------------------
# train / evaluate / list-models
# ---------------------------------------------------------------------------


def train(config_path: str, patches: Sequence[str] = ()) -> Dict[str, Any]:
    """Run a training job from a ``RunConfig`` YAML plus ``key=value`` patches."""
    from avex_tpu_torch.configs import RunConfig
    from avex_tpu_torch.run_train import main

    return main(RunConfig.from_sources(config_path, list(patches)))


def evaluate(config_path: str, patches: Sequence[str] = ()) -> List[Dict[str, Any]]:
    """Run a benchmark evaluation from an ``EvaluateConfig`` YAML plus patches."""
    from avex_tpu_torch.configs import EvaluateConfig
    from avex_tpu_torch.run_evaluate import main

    return main(EvaluateConfig.from_sources(config_path, list(patches)))


def list_models() -> Dict[str, Dict[str, Any]]:
    """Print the model registry table; returns it."""
    from avex_tpu_torch.models.registry import list_models as table

    return table(verbose=True)


# ---------------------------------------------------------------------------
# embed
# ---------------------------------------------------------------------------


def find_audio_files(input_path: Union[str, Path]) -> List[Path]:
    """``input_path`` itself, or the ``.wav``/``.flac``/``.npy`` files under it, sorted."""
    src = Path(input_path)
    files = sorted(p for ext in ("*.wav", "*.flac", "*.npy") for p in src.rglob(ext)) if src.is_dir() else [src]
    if not files:
        raise CommandError(f"no .wav/.flac/.npy files under {src}")
    return files


def model_sample_rate(model) -> int:
    """The rate a model takes its audio at (16 kHz where its config names none)."""
    ac = getattr(model, "audio_config", None)
    return int(ac.sample_rate) if ac is not None and getattr(ac, "sample_rate", None) else 16000


def embed_batches(
    model,
    files: Sequence[Path],
    *,
    clip_seconds: float = 5.0,
    batch_size: int = 32,
    npy_sr: Optional[int] = None,
    windowed: bool = False,
    hop_seconds: Optional[float] = None,
) -> Tuple[Iterator[Dict[str, np.ndarray]], List[Dict[str, Any]]]:
    """``(batches, manifest)``: ``{"raw_wav": [n, clip]}`` batches of at most
    ``batch_size`` rows and the manifest rows (``path``, ``offset_samples``),
    one a batch row, appended as the batches are drawn.

    Files are decoded and resampled to the model's rate on the host
    (``.npy`` files are taken at the model's rate unless ``npy_sr`` names
    theirs); each yields its centre crop (``ops.audio.pad_or_window_np``) at
    offset 0, or with ``windowed`` every window of ``window_waveform`` (hop
    ``hop_seconds``, by default the window) at its offset.
    """
    from avex_tpu_torch._native import decode_audio, resample
    from avex_tpu_torch.ops.audio import pad_or_window_np
    from avex_tpu_torch.ops.windowing import window_waveform

    sr = model_sample_rate(model)
    target = int(clip_seconds * sr)
    hop = int((hop_seconds or clip_seconds) * sr)
    manifest: List[Dict[str, Any]] = []

    def load(path: Path) -> np.ndarray:
        if path.suffix == ".npy":
            wav = np.load(path).astype(np.float32).reshape(-1)
            return resample(wav, npy_sr, sr) if npy_sr and npy_sr != sr else wav
        wav, file_sr = decode_audio(str(path), mono=True)
        return resample(wav, file_sr, sr) if file_sr != sr else wav

    def rows() -> Iterator[Tuple[np.ndarray, Dict[str, Any]]]:
        for path in files:
            wav = load(path)
            if windowed:
                windows, offsets = window_waveform(wav, target, hop_samples=hop)
                for clip, offset in zip(windows, offsets):
                    yield clip, {"path": str(path), "offset_samples": int(offset)}
            else:
                clip, _mask = pad_or_window_np(wav, target, window_selection="center")
                yield clip, {"path": str(path), "offset_samples": 0}

    def batches() -> Iterator[Dict[str, np.ndarray]]:
        clips = []
        for clip, row in rows():
            clips.append(clip)
            manifest.append(row)
            if len(clips) == batch_size:
                yield {"raw_wav": np.stack(clips)}
                clips = []
        if clips:
            yield {"raw_wav": np.stack(clips)}

    return batches(), manifest


def estimated_tokens(model, target: int) -> int:
    """Encoder sequence length one ``target``-sample window gives (0: unknown)."""
    cfg = getattr(model, "cfg", None)
    if cfg is not None and hasattr(cfg, "input_patch_size"):  # BEATs-like
        sf = float(getattr(cfg, "sample_frequency", 16000.0))
        frames = 1 + int(
            (target - getattr(cfg, "frame_length", 25.0) / 1000.0 * sf)
            // (getattr(cfg, "frame_shift", 10.0) / 1000.0 * sf)
        )
        p = int(cfg.input_patch_size)
        return (frames // p) * (int(cfg.num_mel_bins) // p)
    tl = getattr(getattr(model, "module", None), "target_length", None)
    if tl:  # EAT / Bird-MAE: a fixed spectrogram grid plus CLS
        return (int(tl) // 16) * (128 // 16) + 1
    return 0


def embed_mesh(model, ring_attention: str = "auto", windowed: bool = False, clip_seconds: float = 5.0,
               echo: Echo = _echo):
    """The mesh ``embed`` extracts over, turning the ring on where asked.

    The device count is the process group's world size (1 without a group).
    With more than one rank the ring runs for ``ring_attention="on"``, or for
    ``"auto"`` on windowed runs whose windows reach about 1024 tokens, on a
    model that has it: each window's attention sequence is cut over a mesh
    of ``data=1, model=ranks``, so no rank holds its ``[T, T]`` scores.
    Otherwise several ranks extract data-parallel over the default mesh;
    one rank has no mesh.
    """
    from avex_tpu_torch.parallel import make_mesh, world_size

    ranks = world_size()
    target = int(clip_seconds * model_sample_rate(model))
    use_ring = (
        ring_attention != "off"
        and ranks > 1
        and hasattr(model, "enable_ring_attention")
        and (ring_attention == "on" or (windowed and estimated_tokens(model, target) >= 1024))
    )
    if use_ring:
        mesh = make_mesh(data=1, model=ranks, device=model.device)
        model.enable_ring_attention(mesh)
        echo(f"ring attention: sequence sharded over {ranks} ranks")
        return mesh
    return make_mesh(device=model.device) if ranks > 1 else None


def embed(
    source: Source,
    input_path: Union[str, Path],
    output_path: Union[str, Path],
    *,
    layers: str = "last_layer",
    aggregation: str = "mean",
    batch_size: int = 32,
    clip_seconds: float = 5.0,
    random_weights: bool = False,
    npy_sr: Optional[int] = None,
    windowed: bool = False,
    hop_seconds: Optional[float] = None,
    ring_attention: str = "auto",
    echo: Echo = _echo,
) -> Dict[str, Any]:
    """Embed audio files into an HDF5 cache (needs ``h5py``) and write the
    ``.files.json`` manifest beside it; returns the counts and paths."""
    from avex_tpu_torch.evaluation import extract_embeddings_to_cache
    from avex_tpu_torch.parallel import is_main_process, rank_device, world_size

    files = find_audio_files(input_path)
    model = _load(source, return_features_only=True, random_weights=random_weights)
    if world_size() > 1:
        model.to(rank_device(model.device))  # each rank on its own card
    mesh = embed_mesh(model, ring_attention, windowed, clip_seconds, echo)
    model.register_hooks_for_layers(split_layers(layers))
    batches, manifest = embed_batches(model, files, clip_seconds=clip_seconds, batch_size=batch_size,
                                      npy_sr=npy_sr, windowed=windowed, hop_seconds=hop_seconds)
    extract_embeddings_to_cache(model, batches, output_path, aggregation=aggregation, mesh=mesh)
    manifest_path = Path(output_path).with_suffix(".files.json")
    if is_main_process():
        manifest_path.write_text(json.dumps(manifest, indent=0))
    echo(f"Embedded {len(files)} files ({len(manifest)} rows) -> {output_path} (manifest: {manifest_path})")
    return {"files": len(files), "rows": len(manifest), "output": str(output_path), "manifest": str(manifest_path)}


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def export(
    source: Source,
    output_path: Union[str, Path],
    *,
    fmt: Optional[str] = None,
    mode: str = "embed",
    layers: str = "last_layer",
    aggregation: str = "mean",
    clip_seconds: float = 5.0,
    batch_size: Optional[int] = None,
    quantize_float16: bool = False,
    random_weights: bool = False,
    echo: Echo = _echo,
) -> Path:
    """Export a model; ``fmt`` ``pt2`` (a ``torch.export`` program, batch
    dynamic unless ``batch_size`` pins it), ``savedmodel`` or ``tflite``
    (both raise: no TF converter). Without ``fmt`` the file name decides:
    ``.tflite`` is tflite, ``.pt2`` pt2, anything else savedmodel."""
    from avex_tpu_torch.export import export_program, export_savedmodel, export_tflite

    output_path = str(output_path)
    if fmt is None:
        fmt = "tflite" if output_path.endswith(".tflite") else "pt2" if output_path.endswith(".pt2") else "savedmodel"
    if quantize_float16 and fmt != "tflite":
        raise CommandError("--quantize-float16 applies to tflite exports only")
    if fmt == "tflite":  # both TF formats raise before a model is read: no TF converter
        export_tflite(None, output_path, quantize_float16=quantize_float16)
    if fmt == "savedmodel":
        export_savedmodel(None, output_path)
    model = _load(source, return_features_only=(mode == "embed"), random_weights=random_weights)
    path = export_program(model, output_path, mode=mode, layers=split_layers(layers), aggregation=aggregation,
                          clip_seconds=clip_seconds, batch_size=batch_size)
    echo(f"torch.export program written to {path}")
    return path


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def serve(
    sources: Sequence[Source],
    *,
    host: str = "127.0.0.1",
    port: int = 8000,
    mode: str = "embed",
    layers: str = "last_layer",
    aggregation: str = "mean",
    clip_seconds: float = 5.0,
    max_batch: int = 32,
    max_wait_ms: float = 10.0,
    random_weights: bool = False,
    no_warmup: bool = False,
    quantization: Optional[str] = None,
    echo: Echo = _echo,
) -> None:
    """Serve model(s) over HTTP with micro-batching on the card, in the
    foreground: prints ``Serving <names> (<mode>) on http://host:port`` and
    serves on the calling thread; ``KeyboardInterrupt`` (SIGINT) stops the
    server, closes the pool and returns. ``quantization="int8"`` applies to
    every model. JAX's command first enables XLA's compilation cache; eager
    PyTorch compiles nothing ahead, so the port has none (the CUDA kernels
    build once into ``build/``)."""
    from avex_tpu_torch.serving import AvexHTTPServer, InferenceService, ServiceConfig, ServicePool

    names = [_source_name(s) for s in sources]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise UsageError(f"model(s) given more than once: {', '.join(dupes)}")
    config = ServiceConfig(clip_seconds=clip_seconds, max_batch=max_batch, max_wait_ms=max_wait_ms, mode=mode,
                           layers=split_layers(layers), aggregation=aggregation)
    pool = ServicePool()
    try:
        for name, source in zip(names, sources):
            model = _load(source, return_features_only=(mode == "embed"), random_weights=random_weights,
                          quantization=quantization)
            pool.add(name, InferenceService(model, config))
        target = pool if len(pool) > 1 else pool.default
        if not no_warmup:
            echo("Warming up (bucket-1 and max-batch batches)...")
            pool.warmup()
        server = AvexHTTPServer(target, host=host, port=port)
    except BaseException:
        pool.close()
        raise
    echo(f"Serving {', '.join(names)} ({mode}) on http://{server.host}:{server.port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        pool.close()
