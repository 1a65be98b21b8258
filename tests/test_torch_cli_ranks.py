"""``embed --windowed --ring-attention on`` on two gloo ranks against one process.

The ranks (spawned, one gloo process group for the file, rendezvous through
a file) each run the port's CLI through click's ``CliRunner``, as the JAX
package's ``tests/unittests/test_cli.py`` runs its CLI over 8 virtual
devices: ``embed_mesh`` builds the ``data=1, model=2`` mesh, every window's
attention is a ring over the two ranks, and rank 0 writes the HDF5 file.
The test process meanwhile runs the same command with ``--ring-attention
off`` and no process group. Held: the two files' rows at rtol 1e-4 / atol
1e-5 (the JAX test's), the same manifest, and each rank's message naming
the ring of 2 ranks.
"""

import json
import pickle
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from click.testing import CliRunner
from scipy.io import wavfile

from avex_tpu_torch.evaluation import load_cached_embeddings
from tests.test_torch_parallel_ranks import RankGroup
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

WORLD = 2
RING_TOL = dict(rtol=1e-4, atol=1e-5)
SPEC = {"name": "beats", "pretrained": False, "device": "cpu",
        "init_config": {"encoder_layers": 2, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 128,
                        "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0, "attention_dropout": 0.0,
                        "encoder_layerdrop": 0.0},
        "audio_config": {"representation": "raw", "normalize": False}}


def _embed_args(work: Path, out: Path, ring: str) -> list:
    return ["embed", "-m", str(work / "spec.yml"), "-i", str(work / "long"), "-o", str(out), "--random-weights",
            "--clip-seconds", "1", "--windowed", "--batch-size", "4", "--ring-attention", ring]


def rank_main(rank: int, world: int, work: str) -> None:
    from avex_tpu_torch.cli import cli
    from avex_tpu_torch.parallel import init_multihost

    torch.set_num_threads(1)
    work_dir = Path(work)
    try:
        init_multihost(f"file://{work_dir / 'rendezvous'}", world, rank, device="cpu")
        result = CliRunner().invoke(cli, _embed_args(work_dir, work_dir / "ring.h5", "on"), catch_exceptions=False)
        with open(work_dir / f"rank{rank}.pkl", "wb") as f:
            pickle.dump({"exit_code": result.exit_code, "output": result.output}, f)
    except BaseException:
        (work_dir / f"rank{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_ring_embed_on_two_ranks_equals_one_process(tmp_path):
    import yaml

    from avex_tpu_torch.cli import cli

    (tmp_path / "spec.yml").write_text(yaml.safe_dump({"model_spec": SPEC}))
    (tmp_path / "long").mkdir()
    rng = np.random.default_rng(0)
    wavfile.write(tmp_path / "long" / "long.wav", 16000, (rng.standard_normal(40000) * 0.1 * 32767).astype(np.int16))
    group = RankGroup(tmp_path, world=WORLD, timeout=240.0, main=rank_main)
    plain = CliRunner().invoke(cli, _embed_args(tmp_path, tmp_path / "plain.h5", "off"), catch_exceptions=False)
    assert plain.exit_code == 0, plain.output
    assert "ring attention" not in plain.output
    for result in group.results():
        assert result["exit_code"] == 0, result["output"]
        assert "ring attention: sequence sharded over 2 ranks" in result["output"]
    ring, _labels, _meta = load_cached_embeddings(tmp_path / "ring.h5")
    want, _labels, _meta = load_cached_embeddings(tmp_path / "plain.h5")
    assert ring[0].shape == want[0].shape == (3, 64)  # 2.5 s: windows at 0 and 1 s, a padded tail at 2 s
    np.testing.assert_allclose(ring[0], want[0], **RING_TOL)
    assert json.loads((tmp_path / "ring.files.json").read_text()) == \
        json.loads((tmp_path / "plain.files.json").read_text())
