"""Command-line interface of the port: ``avex-tpu-torch train|evaluate|list-models|embed|export|serve``.

Port of ``avex_tpu/cli.py``: the click group with JAX's commands, options,
defaults and help; each command calls its body in
``avex_tpu_torch.commands``. ``click`` is imported here and nowhere else in
the port. The log level comes from the ``LOG_LEVEL`` environment variable
(set when a command runs, not when the module is imported).
Run it as ``python -m avex_tpu_torch.cli`` or through the console entry.
"""

from __future__ import annotations

import logging
import os

try:
    import click
except ImportError as err:  # the machine with the card may lack it
    raise ImportError("the avex-tpu-torch command line needs click; without it call the command bodies in "
                      "avex_tpu_torch.commands") from err

from avex_tpu_torch import commands


def _run(body, *args, **kwargs):
    """Call a command body; its refusals become click's errors."""
    try:
        return body(*args, **kwargs)
    except commands.UsageError as err:
        raise click.UsageError(str(err)) from err
    except (commands.CommandError, NotImplementedError) as err:
        raise click.ClickException(str(err)) from err


@click.group()
def cli() -> None:
    """avex-tpu-torch: bioacoustics representation learning in PyTorch on CUDA."""
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO").upper(),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )


@cli.command()
@click.option("-c", "--config", "config_path", required=True, type=str)
@click.option("-p", "--patch", "patches", multiple=True, help="key=value config overrides")
def train(config_path: str, patches) -> None:
    """Run a training job from a RunConfig YAML."""
    result = _run(commands.train, config_path, list(patches))
    click.echo(f"Training finished: best_val_acc={result['best_val_acc']:.4f}")


@cli.command()
@click.option("-c", "--config", "config_path", required=True, type=str)
@click.option("-p", "--patch", "patches", multiple=True, help="key=value config overrides")
def evaluate(config_path: str, patches) -> None:
    """Run a benchmark evaluation from an EvaluateConfig YAML."""
    results = _run(commands.evaluate, config_path, list(patches))
    click.echo(f"Evaluation finished: {len(results)} experiment x set results")


@cli.command("list-models")
def list_models_cmd() -> None:
    """Print the model registry table."""
    commands.list_models()


@cli.command()
@click.option("-m", "--model", "model_name", required=True, help="registry key or spec YAML")
@click.option("-i", "--input", "input_path", required=True, type=str,
              help="audio file or directory (wav/flac/npy)")
@click.option("-o", "--output", "output_path", required=True, type=str, help="output .h5")
@click.option("--layers", default="last_layer", help="comma list of layer selectors")
@click.option("--aggregation", default="mean",
              type=click.Choice(["mean", "max", "cls_token", "none"]))
@click.option("--batch-size", default=32, type=int)
@click.option("--clip-seconds", default=5.0, type=float,
              help="fixed window length (center crop/pad)")
@click.option("--random-weights", is_flag=True, help="skip checkpoint loading (seeded random weights)")
@click.option("--npy-sr", type=int, default=None,
              help=".npy inputs are assumed to already be at the model's sample "
                   "rate; pass their actual rate here to resample them")
@click.option("--windowed", is_flag=True,
              help="long recordings: one embedding PER clip-seconds window "
                   "(hop --hop-seconds) instead of a single center crop; the "
                   ".files.json manifest records each row's file + offset")
@click.option("--hop-seconds", type=float, default=None,
              help="window hop for --windowed (default: the window length)")
@click.option("--ring-attention", type=click.Choice(["auto", "on", "off"]),
              default="auto",
              help="long-window mode: shard each window's attention sequence "
                   "over all ranks of the process group (ops/ring_attention.py) "
                   "so the [T, T] score matrix never materializes on one card. "
                   "auto = on for --windowed runs whose windows exceed ~1024 "
                   "tokens with more than one rank")
def embed(model_name, input_path, output_path, layers, aggregation,
          batch_size, clip_seconds, random_weights, npy_sr,
          windowed, hop_seconds, ring_attention) -> None:
    """Embed audio files into an HDF5 cache (point a model at a directory,
    get layer-wise embeddings out)."""
    _run(commands.embed, model_name, input_path, output_path, layers=layers, aggregation=aggregation,
         batch_size=batch_size, clip_seconds=clip_seconds, random_weights=random_weights, npy_sr=npy_sr,
         windowed=windowed, hop_seconds=hop_seconds, ring_attention=ring_attention, echo=click.echo)


@cli.command()
@click.option("-m", "--model", "model_name", required=True, help="registry key or spec YAML")
@click.option("-o", "--output", "output_path", required=True, type=str,
              help=".pt2 program file (SavedModel directory or .tflite file: not available)")
@click.option("--format", "fmt", default=None,
              type=click.Choice(["pt2", "savedmodel", "tflite"]),
              help="default: tflite when output ends in .tflite, pt2 when it ends in .pt2, "
                   "else savedmodel (the TF formats raise: no TF converter)")
@click.option("--mode", default="embed", type=click.Choice(["embed", "logits"]),
              show_default=True)
@click.option("--layers", default="last_layer", help="comma list of layer selectors")
@click.option("--aggregation", default="mean",
              type=click.Choice(["mean", "max", "cls_token"]), show_default=True)
@click.option("--clip-seconds", default=5.0, type=float, show_default=True)
@click.option("--batch-size", default=None, type=int,
              help="pin the batch axis (default: dynamic for pt2)")
@click.option("--quantize-float16", is_flag=True,
              help="tflite only: float16 weight quantization")
@click.option("--random-weights", is_flag=True, help="skip checkpoint loading (seeded random weights)")
def export(model_name, output_path, fmt, mode, layers, aggregation, clip_seconds,
           batch_size, quantize_float16, random_weights) -> None:
    """Export a model as a torch.export program on raw waveforms (see
    avex_tpu_torch.export)."""
    _run(commands.export, model_name, output_path, fmt=fmt, mode=mode, layers=layers, aggregation=aggregation,
         clip_seconds=clip_seconds, batch_size=batch_size, quantize_float16=quantize_float16,
         random_weights=random_weights, echo=click.echo)


@cli.command()
@click.option("-m", "--model", "model_names", required=True, multiple=True,
              help="registry key or spec YAML; repeat to co-host several "
                   "models in one process (routed under /models/<name>/)")
@click.option("--host", default="127.0.0.1", show_default=True)
@click.option("--port", default=8000, type=int, show_default=True,
              help="0 binds an ephemeral port")
@click.option("--mode", default="embed", type=click.Choice(["embed", "logits"]),
              show_default=True)
@click.option("--layers", default="last_layer", help="comma list of layer selectors")
@click.option("--aggregation", default="mean",
              type=click.Choice(["mean", "max", "cls_token"]), show_default=True)
@click.option("--clip-seconds", default=5.0, type=float, show_default=True)
@click.option("--max-batch", default=32, type=int, show_default=True,
              help="micro-batch ceiling (power-of-two buckets up to this)")
@click.option("--max-wait-ms", default=10.0, type=float, show_default=True,
              help="how long the batcher waits to coalesce concurrent requests")
@click.option("--random-weights", is_flag=True, help="skip checkpoint loading (seeded random weights)")
@click.option("--no-warmup", is_flag=True, help="skip the warm-up batches before traffic")
@click.option("--quantization", default=None, type=click.Choice(["int8"]),
              help="W8A8 dynamic-int8 serving mode (int8 encoder weights on the "
                   "K7 kernel; see avex_tpu_torch.quant)")
def serve(model_names, host, port, mode, layers, aggregation, clip_seconds,
          max_batch, max_wait_ms, random_weights, no_warmup, quantization) -> None:
    """Serve model(s) over HTTP with micro-batching on the card (see avex_tpu_torch.serving)."""
    _run(commands.serve, list(model_names), host=host, port=port, mode=mode, layers=layers,
         aggregation=aggregation, clip_seconds=clip_seconds, max_batch=max_batch, max_wait_ms=max_wait_ms,
         random_weights=random_weights, no_warmup=no_warmup, quantization=quantization, echo=click.echo)


if __name__ == "__main__":
    cli()
