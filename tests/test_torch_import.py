"""The port stands alone: it imports torch, numpy and the standard library only."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

ROOT = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "avex_tpu_torch",
    "avex_tpu_torch.configs",
    "avex_tpu_torch.api.official_models",
    "avex_tpu_torch.models.registry",
    "avex_tpu_torch.models.factory",
    "avex_tpu_torch.models.load",
    "avex_tpu_torch.models.base",
    "avex_tpu_torch.models.common",
    "avex_tpu_torch.models.beats",
    "avex_tpu_torch.models.eat",
    "avex_tpu_torch.models.aves",
    "avex_tpu_torch.models.birdmae",
    "avex_tpu_torch.models.atst",
    "avex_tpu_torch.models.efficientnet",
    "avex_tpu_torch.models.resnet",
    "avex_tpu_torch.models.perch",
    "avex_tpu_torch.models.birdnet",
    "avex_tpu_torch.utils.loaders",
    "avex_tpu_torch.ops.fbank",
    "avex_tpu_torch.ops.attention",
    "avex_tpu_torch.ops.attention_kernels",
    "avex_tpu_torch.ops.frontend",
    "avex_tpu_torch.ops._build",
    "avex_tpu_torch.ops._precision",
    "avex_tpu_torch.ops.audio",
    "avex_tpu_torch.ops.int8_kernels",
    "avex_tpu_torch.quant",
    "avex_tpu_torch._native",
    "avex_tpu_torch.serving",
    "avex_tpu_torch.serving.service",
    "avex_tpu_torch.serving.pool",
    "avex_tpu_torch.serving.http",
    "avex_tpu_torch.metrics",
    "avex_tpu_torch.training",
    "avex_tpu_torch.training.checkpoint",
    "avex_tpu_torch.training.losses",
    "avex_tpu_torch.training.metrics_tracker",
    "avex_tpu_torch.training.optimizers",
    "avex_tpu_torch.training.strategies",
    "avex_tpu_torch.training.train",
    "avex_tpu_torch.training.trainer_factory",
    "avex_tpu_torch.training.clustering_evaluator",
    "avex_tpu_torch.ops.moe",
    "avex_tpu_torch.probes",
    "avex_tpu_torch.probes.heads",
    "avex_tpu_torch.probes.base",
    "avex_tpu_torch.probes.factory",
    "avex_tpu_torch.evaluation",
    "avex_tpu_torch.evaluation.finetune",
    "avex_tpu_torch.evaluation.embedding_cache",
    "avex_tpu_torch.evaluation.embedding_manager",
    "avex_tpu_torch.evaluation.retrieval",
    "avex_tpu_torch.evaluation.clustering",
    "avex_tpu_torch.io",
    "avex_tpu_torch.data",
    "avex_tpu_torch.data.dataset",
    "avex_tpu_torch.data.collate",
    "avex_tpu_torch.data.loader",
    "avex_tpu_torch.data.transforms",
    "avex_tpu_torch.data.data_utils",
    "avex_tpu_torch.data.beans",
    "avex_tpu_torch.data.birdset",
    "avex_tpu_torch.data.ebird_taxonomy",
    "avex_tpu_torch.utils.tracking",
    "avex_tpu_torch.utils.experiment_logger",
    "avex_tpu_torch.run_train",
    "avex_tpu_torch.run_evaluate",
    "avex_tpu_torch.parallel",
    "avex_tpu_torch.parallel.fsdp",
    "avex_tpu_torch.parallel.tensor",
    "avex_tpu_torch.parallel.pipeline",
    "avex_tpu_torch.parallel.sequence",
    "avex_tpu_torch.ops.windowing",
    "avex_tpu_torch.api.list_models",
    "avex_tpu_torch.commands",
    "avex_tpu_torch.export",
    "avex_tpu_torch.data.grain_loader",
]
#: top-level packages the port must not import: JAX, its libraries, and the
#: JAX package with its configuration library
_NOT_IMPORTED = ("jax", "flax", "optax", "orbax", "pydantic", "avex_tpu")
#: packages the machine with the card may lack: imported only where a
#: function needs them (the HDF5 cache, clustering, YAML configs, HF
#: datasets, remote paths, the logging backends, BirdNet's TFLite host
#: backends, the command line's click; grain, which the port's loader does
#: without)
_LAZY = ("h5py", "sklearn", "yaml", "datasets", "fsspec", "mlflow", "wandb", "tensorflow", "birdnetlib", "click",
         "grain")
_NAMES = "|".join(_NOT_IMPORTED)
_FORBIDDEN = re.compile(
    rf"^\s*(import\s+({_NAMES})\b(?!_torch)|from\s+({_NAMES})\b(?!_torch))",
    re.MULTILINE,
)


def _run(code: str) -> subprocess.CompletedProcess:
    # A fresh interpreter: the test session itself has imported jax (conftest).
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )


def test_slice_imports_without_jax_flax_or_avex_tpu():
    code = (
        "import importlib, sys\n"
        f"for name in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {_NOT_IMPORTED + _LAZY!r})\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in (ROOT / "avex_tpu_torch").rglob("*.py"))
    + ["chip_smoke.py", "scripts/torch_beats_profile.py", "scripts/torch_attention_shapes.py"],
)
def test_source_has_no_jax_imports(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.findall(text), path
    # no module path of the JAX package handed to importlib either
    assert not re.search(r"[\"']avex_tpu\.", text), path


def test_load_model_without_device_raises_without_cuda():
    code = (
        "import torch, avex_tpu_torch\n"
        "from avex_tpu_torch.configs import ModelSpec\n"
        "assert not torch.cuda.is_available()\n"
        "spec = ModelSpec(name='beats', pretrained=False, init_config={'encoder_layers': 1})\n"
        "try:\n"
        "    avex_tpu_torch.load_model(spec, random_weights=True)\n"
        "except RuntimeError as err:\n"
        "    assert 'CUDA' in str(err), err\n"
        "else:\n"
        "    raise SystemExit('load_model ran on the CPU without being asked to')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_click_is_imported_by_the_command_line_module_only():
    """``avex_tpu_torch/cli.py`` is the one module that imports click; the
    command bodies (``commands.py``) run without it."""
    importers = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "avex_tpu_torch").rglob("*.py")
                       if re.search(r"^\s*(import click|from click)", p.read_text(), re.MULTILINE))
    assert importers == ["avex_tpu_torch/cli.py"]
    code = (
        "import sys, avex_tpu_torch, avex_tpu_torch.commands\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('click', 'h5py', 'yaml', 'grain', 'tensorflow'))\n"
        "assert not bad, bad\n"
        "import avex_tpu_torch.cli\n"
        "assert 'click' in sys.modules\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
