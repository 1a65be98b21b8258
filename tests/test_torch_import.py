"""The port stands alone: it imports torch, numpy and the standard library only."""

import re
import subprocess
import sys
from pathlib import Path

import pytest

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
]
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|flax|avex_tpu)\b(?!_torch)|from\s+(jax|flax|avex_tpu)\b(?!_torch))",
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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'avex_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in (ROOT / "avex_tpu_torch").rglob("*.py"))
    + ["chip_smoke.py"],
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
