"""BEANS benchmark dataset presets (≈ ``avex_tpu/data/beans.py``).

The public BEANS tasks as HF :class:`DatasetConfig` templates.
Classification tasks use accuracy; detection tasks use mAP, as in the BEANS
paper.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from avex_tpu_torch.configs import DatasetConfig, EvaluationSet

__all__ = ["BEANS_TASKS", "beans_config", "beans_evaluation_sets"]

#: task → (hf path, label column, metric, multilabel)
BEANS_TASKS: Dict[str, tuple] = {
    "watkins": ("davidrrobinson/watkins", "label", "accuracy", False),
    "bats": ("davidrrobinson/bats", "label", "accuracy", False),
    "cbi": ("davidrrobinson/cbi", "label", "accuracy", False),
    "dogs": ("davidrrobinson/dogs", "label", "accuracy", False),
    "humbugdb": ("davidrrobinson/humbugdb", "label", "accuracy", False),
    "esc50": ("ashraq/esc50", "category", "accuracy", False),
}


def beans_config(task: str, split: str = "train", path_override: Optional[str] = None) -> DatasetConfig:
    """DatasetConfig of one BEANS task and split."""
    if task not in BEANS_TASKS:
        raise ValueError(f"Unknown BEANS task {task!r}; known: {sorted(BEANS_TASKS)}")
    hf_path, label_col, _metric, _multi = BEANS_TASKS[task]
    return DatasetConfig(name=f"beans_{task}_{split}", kind="hf", path=path_override or hf_path, split=split,
                         label_column=label_col, audio_column="audio", sample_rate=16000)


def beans_evaluation_sets(tasks: Optional[List[str]] = None) -> List[EvaluationSet]:
    """One EvaluationSet per BEANS task, with the paper's metrics."""
    sets = []
    for task in tasks or list(BEANS_TASKS):
        _path, _col, metric, multilabel = BEANS_TASKS[task]
        sets.append(EvaluationSet(
            name=f"beans_{task}", train=beans_config(task, "train"), val=beans_config(task, "validation"),
            test=beans_config(task, "test"), metrics=[metric, "balanced_accuracy"], multilabel=multilabel))
    return sets
