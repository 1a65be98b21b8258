"""Data pipeline: datasets, collation, augmentation, loaders.

Port of ``avex_tpu/data``. :func:`build_dataloaders` is the entry point: a
:class:`~avex_tpu_torch.configs.RunConfig` → per-split loaders, the label map
and the class count of the (possibly concatenated) train split. The loader
works in numpy on the host and hands out CPU tensors, pinned when the run's
device is ``cuda``. In a multi-process run each process loads its shard of
every epoch: the rank's strided slice ``[rank::world]`` of the epoch's
permutation, taken before batching, with remainders dropped on every split,
as the JAX package builds it. The collation draws stay a function of
``(seed, epoch, batch index)``, the same on every rank.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from avex_tpu_torch.configs import RunConfig
from avex_tpu_torch.data.collate import Collater, MixupAugmenter, NoiseAugmenter
from avex_tpu_torch.data.dataset import (
    AudioDataset,
    ConcatenatedDataset,
    HFAudioDataset,
    LocalAudioDataset,
    ManifestAudioDataset,
    SubsetDataset,
    SyntheticAudioDataset,
    dataset_from_config,
)
from avex_tpu_torch.data.grain_loader import GrainDataLoader
from avex_tpu_torch.data.loader import DataLoader
from avex_tpu_torch.parallel import world_size

logger = logging.getLogger(__name__)

__all__ = [
    "AudioDataset",
    "Collater",
    "ConcatenatedDataset",
    "DataLoader",
    "GrainDataLoader",
    "HFAudioDataset",
    "LocalAudioDataset",
    "ManifestAudioDataset",
    "MixupAugmenter",
    "NoiseAugmenter",
    "SubsetDataset",
    "SyntheticAudioDataset",
    "build_dataloaders",
    "dataset_from_config",
    "world_size",
]


def _build_split(configs, policy: str) -> Optional[AudioDataset]:
    if not configs:
        return None
    datasets = [dataset_from_config(c) for c in configs]
    return datasets[0] if len(datasets) == 1 else ConcatenatedDataset(datasets, policy=policy)


def build_dataloaders(
    config: RunConfig,
    num_classes_override: Optional[int] = None,
) -> Tuple[Optional[DataLoader], Optional[DataLoader], Optional[DataLoader], Dict[str, int], int]:
    """RunConfig → (train, val, test) loaders, the label map and the class count.

    Each split's datasets are concatenated under the configured policy; the
    collaters take the model's target clip length and window selection; the
    training split shuffles, drops its remainder and augments, the others
    center-crop and keep every item. With more than one process
    (``torch.distributed``'s world size) each loader is this rank's data row's
    shard (``config.mesh.model`` ranks, rank ``r`` in row ``r // model``, read
    the same batches) and every split drops its remainder, so each row
    contributes equal batches. ``data_pipeline="grain"`` builds the
    checkpointable :class:`GrainDataLoader` (grain's order, no ``grain``
    needed) in place of :class:`DataLoader`. An empty configuration raises.
    """
    loader_cls = GrainDataLoader if config.data_pipeline == "grain" else DataLoader
    ds_cfg = config.dataset_config
    if ds_cfg is None:
        raise ValueError("No datasets configured")
    train_ds = _build_split(ds_cfg.train_datasets, ds_cfg.concat_policy)
    val_ds = _build_split(ds_cfg.val_datasets, ds_cfg.concat_policy)
    test_ds = _build_split(ds_cfg.test_datasets, ds_cfg.concat_policy)

    ref = train_ds or val_ds or test_ds
    if ref is None:
        raise ValueError("No datasets configured")
    label_map = ref.label_map()
    num_classes = num_classes_override or ref.num_classes

    audio_cfg = config.model_spec.audio_config
    sr = audio_cfg.sample_rate if audio_cfg else config.sr
    target_len = audio_cfg.target_length_samples if audio_cfg and audio_cfg.target_length_samples else sr
    window_selection = audio_cfg.window_selection if audio_cfg else "random"
    pin = torch.device(config.device).type == "cuda"
    model = config.mesh.model if config.mesh is not None else 1
    num_shards = world_size() // model
    shard = dist.get_rank() // model if num_shards > 1 else None

    def make_loader(ds, train: bool) -> Optional[DataLoader]:
        if ds is None:
            return None
        collater = Collater(
            target_len=target_len, num_classes=num_classes, window_selection=window_selection,
            multilabel=config.multilabel, one_hot=True,  # the reference's collater always one-hots
            augmentations=config.augmentations if train else None, sample_rate=sr, seed=config.seed,
            train=train,
        )
        return loader_cls(ds, batch_size=config.training_params.batch_size, collate_fn=collater, shuffle=train,
                          drop_last=train or num_shards > 1, seed=config.seed, num_workers=config.num_workers,
                          shard_process=shard, num_shards=num_shards, pin_memory=pin)

    return make_loader(train_ds, True), make_loader(val_ds, False), make_loader(test_ds, False), label_map, \
        num_classes
