"""Item-level dataset transforms (≈ ``avex_tpu/data/transforms.py``).

The split and subsample transforms are in
:func:`avex_tpu_torch.data.dataset.apply_transform`; these wrap a dataset
with a derived label or text label.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

from avex_tpu_torch.data.dataset import AudioDataset

__all__ = ["FillLabelsFromAnswer", "TextLabelFromFeatures"]


class FillLabelsFromAnswer(AudioDataset):
    """The label from a free-text ``answer`` field: each distinct answer
    (sorted) is a class."""

    def __init__(self, base: AudioDataset, answer_key: str = "answer") -> None:
        self.base = base
        self.answer_key = answer_key
        names = sorted({str(base[i].get(answer_key, base[i].get("label"))) for i in range(len(base))})
        super().__init__(label_names=names)
        self._map = {n: i for i, n in enumerate(names)}

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = dict(self.base[idx])
        item["label"] = self._map[str(item.get(self.answer_key, item.get("label")))]
        return item


class TextLabelFromFeatures(AudioDataset):
    """``text_label`` joined from several item fields (the class name when
    none is set)."""

    def __init__(self, base: AudioDataset, columns: Sequence[str], separator: str = ", ") -> None:
        super().__init__(label_names=base.label_names)
        self.base = base
        self.columns = list(columns)
        self.separator = separator

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = dict(self.base[idx])
        parts = [str(item[c]) for c in self.columns if item.get(c)]
        if not parts and "label" in item:
            parts = [self.label_names[item["label"]]] if self.label_names else []
        item["text_label"] = self.separator.join(parts)
        return item
