"""Dataset helpers (≈ ``avex_tpu/data/data_utils.py``)."""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["balance_by_attribute", "combine_text_labels"]


def balance_by_attribute(items: Sequence[Dict[str, Any]], attribute: str = "label",
                         max_per_value: Optional[int] = None, seed: int = 0) -> List[int]:
    """Sorted indices keeping at most ``max_per_value`` items per value of
    ``attribute`` (default: the rarest value's count), the larger groups
    down-sampled by a generator seeded with ``seed``."""
    groups: Dict[Any, List[int]] = defaultdict(list)
    for i, item in enumerate(items):
        groups[item.get(attribute)].append(i)
    if max_per_value is None:
        max_per_value = min(len(v) for v in groups.values())
    rng = np.random.default_rng(seed)
    keep: List[int] = []
    for value in sorted(groups, key=str):
        idx = groups[value]
        if len(idx) > max_per_value:
            idx = list(rng.permutation(idx)[:max_per_value])
        keep.extend(idx)
    return sorted(keep)


def combine_text_labels(items: Sequence[Dict[str, Any]], columns: Sequence[str], separator: str = ", ",
                        target: str = "text_label") -> None:
    """Join several text fields of each item into ``target``, in place."""
    for item in items:
        item[target] = separator.join(str(item[c]) for c in columns if item.get(c))
