"""BirdSet benchmark dataset presets (≈ ``avex_tpu/data/birdset.py``).

The BirdSet tasks as HF ``DBD-research-group/BirdSet`` configurations, and
the reference's legacy ``birdset_train`` named splits as manifest configs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from avex_tpu_torch.configs import DatasetConfig, EvaluationSet

__all__ = ["BIRDSET_TASKS", "LEGACY_SPLIT_PATHS", "birdset_config", "birdset_evaluation_sets",
           "birdset_train_config"]

#: BirdSet task codes (the BirdSet paper's subset benchmarks)
BIRDSET_TASKS: List[str] = ["HSN", "NBP", "NES", "PER", "POW", "SNE", "SSW", "UHH"]

_HF_REPO = "DBD-research-group/BirdSet"


def birdset_config(task: str, split: str = "train") -> DatasetConfig:
    """DatasetConfig of one BirdSet task and split (HF-hosted)."""
    task = task.upper()
    if task not in BIRDSET_TASKS:
        raise ValueError(f"Unknown BirdSet task {task!r}; known: {BIRDSET_TASKS}")
    return DatasetConfig(name=f"birdset_{task.lower()}_{split}", kind="hf", path=_HF_REPO, subset=task, split=split,
                         label_column="ebird_code", audio_column="audio", sample_rate=32000)


#: the legacy split registry: validation splits point at the train
#: manifests (the reference derives val by a transform), XCM is train-only
_LEGACY_GCS_ROOT = "gs://foundation-model-data"
LEGACY_SPLIT_PATHS: Dict[str, str] = {}
for _task in BIRDSET_TASKS:
    LEGACY_SPLIT_PATHS[f"{_task}-train"] = f"{_LEGACY_GCS_ROOT}/data/birdset-train/{_task}/{_task}_taxonomic.jsonl"
    LEGACY_SPLIT_PATHS[f"{_task}-validation"] = LEGACY_SPLIT_PATHS[f"{_task}-train"]
    LEGACY_SPLIT_PATHS[f"{_task}-test"] = f"{_LEGACY_GCS_ROOT}/data/birdset-test/{_task}/{_task}_taxonomic.jsonl"
LEGACY_SPLIT_PATHS["XCM"] = f"{_LEGACY_GCS_ROOT}/data/birdset-train/XCM/XCM_taxonomic.jsonl"


def birdset_train_config(split: str, data_root: Optional[str] = None,
                         manifest_path: Optional[str] = None) -> DatasetConfig:
    """DatasetConfig of a legacy ``birdset_train`` split (``POW-train``...).

    ``manifest_path`` overrides the registry (a local mirror of the JSONL);
    ``data_root`` is put before each row's relative audio path (default the
    bucket root). An unknown split raises ``LookupError``.
    """
    path = manifest_path or LEGACY_SPLIT_PATHS.get(split)
    if path is None:
        raise LookupError(f"Invalid birdset_train split: {split!r}. Expected one of {sorted(LEGACY_SPLIT_PATHS)}")
    return DatasetConfig(name=f"birdset_train_{split.lower().replace('-', '_')}", kind="manifest", path=path,
                         data_root=data_root or f"{_LEGACY_GCS_ROOT}/", label_column="ebird_code",
                         sample_rate=32000)


def birdset_evaluation_sets(tasks: Optional[List[str]] = None) -> List[EvaluationSet]:
    """One EvaluationSet per BirdSet task (train/test, mAP, multilabel)."""
    return [EvaluationSet(name=f"birdset_{task.lower()}", train=birdset_config(task, "train"),
                          test=birdset_config(task, "test_5s"), metrics=["mAP", "roc_auc"], multilabel=True)
            for task in tasks or BIRDSET_TASKS]
