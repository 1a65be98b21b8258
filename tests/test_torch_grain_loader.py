"""The port's checkpointable loader (``avex_tpu_torch/data/grain_loader.py``)
against the JAX package's grain pipeline (``avex_tpu/data/grain_loader.py``).

grain is installed here, so JAX's ``GrainDataLoader`` runs as its own
tests run it. Held: grain's index shuffle against ``index_shuffle`` in numpy
(lengths across block sizes, on both of its paths, and seeds, exact); whole epochs, unshuffled and
shuffled, unsharded and sharded, bit for bit (order and the collater's
per-batch draws); a mid-epoch ``iterator_state`` taken after some batches,
sent through JSON and restored, yields the rest of the epoch bit for bit
with 0 and 2 worker processes; ``build_dataloaders`` builds the loader for
``data_pipeline="grain"``; and a ``Trainer`` run stopped mid-epoch (the
preemption flag's save-and-stop) and resumed from its step checkpoint
trains on the uninterrupted run's batches and ends at its parameters
(fp32, atol 1e-6).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from avex_tpu.configs import DatasetConfig as JaxDatasetConfig
from avex_tpu.data import Collater as JaxCollater
from avex_tpu.data import SyntheticAudioDataset as JaxSynthetic
from avex_tpu.data.grain_loader import GrainDataLoader as JaxGrainDataLoader

import avex_tpu_torch
from avex_tpu_torch.configs import DatasetConfig, RunConfig
from avex_tpu_torch.data import GrainDataLoader, build_dataloaders
from avex_tpu_torch.data.collate import Collater
from avex_tpu_torch.data.dataset import SyntheticAudioDataset
from avex_tpu_torch.data.grain_loader import index_shuffle
from avex_tpu_torch.training import Trainer
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

grain_shuffle = pytest.importorskip("grain._src.python.experimental.index_shuffle.python.index_shuffle_module")

N_ITEMS, CLASSES, SEED = 37, 4, 13
PARAM_ATOL = 1e-6


def _datasets():
    kw = dict(name="s", kind="synthetic", num_samples=N_ITEMS, num_classes=CLASSES, clip_seconds=0.5, seed=5)
    return JaxSynthetic(JaxDatasetConfig(**kw)), SyntheticAudioDataset(DatasetConfig(**kw))


def _collaters():
    # train=True: a random crop and the per-batch draw from SeedSequence([seed, epoch, batch])
    kw = dict(target_len=6000, num_classes=CLASSES, train=True, seed=SEED)
    return JaxCollater(**kw), Collater(**kw)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for mine, ref in zip(got, want):
        assert set(mine) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(np.asarray(mine[key]), np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("length", [1, 2, 24, 1000, 65536, 65537, 300_001, 2_000_003])
def test_index_shuffle_equals_grain(length):
    for seed in (0, 13 * 1_000_003 + 2, 2**32 - 1):
        idx = np.unique(np.r_[np.arange(min(length, 2000)), length - 1])
        want = [grain_shuffle.index_shuffle(int(i), max_index=length - 1, seed=seed, rounds=4) for i in idx]
        np.testing.assert_array_equal(index_shuffle(idx, length - 1, seed), want)


@pytest.mark.parametrize("shuffle", [False, True], ids=["in_order", "shuffled"])
@pytest.mark.parametrize("shard", [None, 0, 1], ids=["whole", "shard0", "shard1"])
def test_epoch_equals_jax_grain(shuffle, shard):
    jax_ds, ds = _datasets()
    jax_collate, collate = _collaters()
    kw = dict(batch_size=4, shuffle=shuffle, seed=SEED, shard_process=shard, num_shards=1 if shard is None else 2)
    jax_loader, loader = JaxGrainDataLoader(jax_ds, collate_fn=jax_collate, **kw), GrainDataLoader(
        ds, collate_fn=collate, **kw)
    for epoch in (0, 3):
        jax_loader.set_epoch(epoch)
        loader.set_epoch(epoch)
        want = list(jax_loader)
        _assert_batches_equal(list(loader), want)
        assert len(loader) == len(jax_loader) == len(want)


def test_seed_past_grain_range_raises_as_grain():
    _, ds = _datasets()
    loader = GrainDataLoader(ds, batch_size=4, collate_fn=_collaters()[1], seed=5000)
    with pytest.raises(ValueError, match="Seed must be an integer between 0 and 2"):
        list(loader)


@pytest.mark.parametrize("workers", [0, 2])
def test_restored_iterator_yields_the_rest_of_the_epoch(workers):
    _, ds = _datasets()
    collate = _collaters()[1]
    loader = GrainDataLoader(ds, batch_size=4, collate_fn=collate, seed=SEED, num_workers=workers)
    loader.set_epoch(2)
    assert loader.iterator_state() is None
    full = list(loader)
    it = iter(loader)
    for _ in range(3):
        next(it)
    state = json.loads(json.dumps(loader.iterator_state()))  # what the step checkpoint's meta.json holds
    assert state == {"epoch": 2, "position": 3, "seed": SEED, "num_shards": 1}
    fresh = GrainDataLoader(ds, batch_size=4, collate_fn=collate, seed=SEED, num_workers=workers)
    rest = list(fresh.restore_iterator(state))
    assert fresh.epoch == 2 and fresh.iterator_state()["position"] == len(full)
    _assert_batches_equal(rest, full[3:])
    other = GrainDataLoader(ds, batch_size=4, collate_fn=collate, seed=SEED + 1)
    with pytest.raises(ValueError, match="another loader"):
        other.restore_iterator(state)


def _run_config(out, **extra):
    model_spec = {"name": "beats", "pretrained": False,
                  "init_config": {"encoder_layers": 1, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 128,
                                  "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0,
                                  "attention_dropout": 0.0, "encoder_layerdrop": 0.0},
                  "audio_config": {"representation": "raw", "normalize": False, "target_length_seconds": 0.5,
                                   "window_selection": "random"}}
    return RunConfig.from_dict(dict(
        model_spec=model_spec, device="cpu", data_pipeline="grain", seed=3, num_workers=0, output_dir=str(out),
        training_params={"train_epochs": 2, "lr": 1e-3, "batch_size": 4, "optimizer": "adamw"},
        scheduler={"name": "none"}, logging="none",
        dataset_config={"train_datasets": [{"name": "t", "kind": "synthetic", "num_samples": 20,
                                            "num_classes": CLASSES, "clip_seconds": 0.5}]},
        **extra))


def _trainer(config):
    train, _val, _test, _labels, classes = build_dataloaders(config)
    assert isinstance(train, GrainDataLoader)
    model = avex_tpu_torch.build_model_from_spec(config.model_spec, device="cpu", num_classes=classes)
    trainer = Trainer(model, config, train)
    digests, step = [], trainer._train_step

    def recorded(batch):
        digests.append(hashlib.sha256(np.asarray(batch["raw_wav"]).tobytes()
                                      + np.asarray(batch["label"]).tobytes()).hexdigest())
        return step(batch)

    trainer._train_step = recorded
    return trainer, digests


def test_trainer_resumed_from_a_step_checkpoint_ends_where_an_uninterrupted_run_ends(tmp_path):
    """Two epochs of 5 batches; the interrupted run stops after step 7 (mid
    epoch 1), saving ``step_checkpoint`` with the loader's state."""
    whole, whole_digests = _trainer(_run_config(tmp_path / "whole"))
    whole.train()
    assert len(whole_digests) == 10

    stopped, stopped_digests = _trainer(_run_config(tmp_path / "stopped"))
    step = stopped._train_step

    def step_then_preempt(batch):
        out = step(batch)
        if len(stopped_digests) == 7:
            stopped._preempted = True  # what SIGTERM's handler sets
        return out

    stopped._train_step = step_then_preempt
    assert stopped.train()["preempted"]
    meta = json.loads((tmp_path / "stopped" / "step_checkpoint.meta.json").read_text())
    assert meta["step_in_epoch"] == 2 and meta["loader_state"]["position"] == 2 and meta["loader_state"]["epoch"] == 1

    resumed, resumed_digests = _trainer(_run_config(
        tmp_path / "resumed", resume_from_checkpoint=str(tmp_path / "stopped" / "step_checkpoint")))
    resumed.train()
    assert stopped_digests + resumed_digests == whole_digests  # every batch after the resume, bit for bit
    want = whole.model.state_dict()
    for key, value in resumed.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), rtol=0, atol=PARAM_ATOL, err_msg=key)
