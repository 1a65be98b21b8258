"""A two-rank ``Trainer`` on the checkpointable loader, stopped mid-epoch and resumed.

Two spawned gloo ranks (rendezvous through a file, one thread each) train
a tiny BEATs data-parallel with ``data_pipeline="grain"``: each rank reads
its own shard of the shuffled epoch. Three runs, one after the other in the
same process group: an uninterrupted one; one stopped after step 7 (mid
epoch 1) by the preemption flag on every rank, as a SIGTERM on every rank
would set it, which has rank 0 write ``step_checkpoint`` with rank 0's
loader state; and one resumed from that checkpoint on both ranks. Held, on
each rank: the batches of the stopped and the resumed run together are the
uninterrupted run's, bit for bit (sha256 of ``raw_wav`` and the labels), the
two ranks read different batches, and the resumed run ends at the
uninterrupted run's parameters (fp32, atol 1e-6). This module imports no
JAX, so a rank starts without it.
"""

import hashlib
import json
import pickle
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tests.test_torch_parallel_ranks import RankGroup
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

WORLD = 2
CLASSES, STOP_AFTER = 4, 7
PARAM_ATOL = 1e-6


def _run_config(out, **extra):
    from avex_tpu_torch.configs import RunConfig

    model_spec = {"name": "beats", "pretrained": False,
                  "init_config": {"encoder_layers": 1, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 128,
                                  "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0,
                                  "attention_dropout": 0.0, "encoder_layerdrop": 0.0},
                  "audio_config": {"representation": "raw", "normalize": False, "target_length_seconds": 0.5,
                                   "window_selection": "random"}}
    # 40 items: 20 a rank, 5 batches of 4 an epoch on each
    return RunConfig.from_dict(dict(
        model_spec=model_spec, device="cpu", data_pipeline="grain", distributed=True, seed=3, num_workers=0,
        output_dir=str(out), logging="none", scheduler={"name": "none"},
        training_params={"train_epochs": 2, "lr": 1e-3, "batch_size": 4, "optimizer": "adamw"},
        dataset_config={"train_datasets": [{"name": "t", "kind": "synthetic", "num_samples": 40,
                                            "num_classes": CLASSES, "clip_seconds": 0.5}]},
        **extra))


def _train(config, stop_after=None):
    """Train ``config`` on this rank; returns the trainer and the digests of
    the batches it trained on."""
    import avex_tpu_torch
    from avex_tpu_torch.data import GrainDataLoader, build_dataloaders
    from avex_tpu_torch.training import Trainer

    train, _val, _test, _labels, classes = build_dataloaders(config)
    assert isinstance(train, GrainDataLoader) and train.num_shards == WORLD
    model = avex_tpu_torch.build_model_from_spec(config.model_spec, device="cpu", num_classes=classes)
    trainer = Trainer(model, config, train)
    digests, step = [], trainer._train_step

    def recorded(batch):
        digests.append(hashlib.sha256(np.asarray(batch["raw_wav"]).tobytes()
                                      + np.asarray(batch["label"]).tobytes()).hexdigest())
        out = step(batch)
        if len(digests) == stop_after:
            trainer._preempted = True  # what SIGTERM's handler sets
        return out

    trainer._train_step = recorded
    result = trainer.train()
    dist.barrier()  # rank 0's files are on disk before any rank reads them
    return trainer, digests, result


def rank_main(rank: int, world: int, work: str) -> None:
    from avex_tpu_torch.parallel import init_multihost

    torch.set_num_threads(1)
    work_dir = Path(work)
    try:
        init_multihost(f"file://{work_dir / 'rendezvous'}", world, rank, device="cpu")
        whole, whole_digests, _ = _train(_run_config(work_dir / "whole"))
        _, stopped_digests, stopped = _train(_run_config(work_dir / "stopped"), stop_after=STOP_AFTER)
        resumed, resumed_digests, _ = _train(_run_config(
            work_dir / "resumed", resume_from_checkpoint=str(work_dir / "stopped" / "step_checkpoint")))
        want = whole.model.state_dict()
        err = max(float((value - want[key]).abs().max()) for key, value in resumed.model.state_dict().items())
        with open(work_dir / f"rank{rank}.pkl", "wb") as f:
            pickle.dump({"whole": whole_digests, "stopped": stopped_digests, "resumed": resumed_digests,
                         "preempted": bool(stopped["preempted"]), "param_err": err}, f)
    except BaseException:
        (work_dir / f"rank{rank}.err").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_ranks_resume_a_grain_epoch_from_rank_0s_step_checkpoint(tmp_path):
    results = RankGroup(tmp_path, world=WORLD, timeout=240.0, main=rank_main).results()
    meta = json.loads((tmp_path / "stopped" / "step_checkpoint.meta.json").read_text())
    assert meta["step_in_epoch"] == 2 and meta["loader_state"]["epoch"] == 1
    assert meta["loader_state"]["position"] == 2 and meta["loader_state"]["num_shards"] == WORLD
    for r in results:
        assert r["preempted"] and len(r["whole"]) == 10 and len(r["stopped"]) == STOP_AFTER
        assert r["stopped"] + r["resumed"] == r["whole"]  # every batch after the resume, bit for bit
        assert r["param_err"] <= PARAM_ATOL
    assert not set(results[0]["whole"]) & set(results[1]["whole"])  # each rank reads its own shard
