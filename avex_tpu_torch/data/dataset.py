"""Dataset backends: synthetic, local files, manifests, HuggingFace datasets.

Port of ``avex_tpu/data/dataset.py``. Each backend is a map-style
``torch.utils.data.Dataset`` of host items
``{"raw_wav": float32 numpy array, "label": int (or a list of ints),
"text_label": str (optional)}``, built from a
:class:`avex_tpu_torch.configs.DatasetConfig`. Items stay numpy: the
collater crops, pads and stacks them on the host, and the loader turns the
batch into tensors. Audio is decoded and resampled by the port's own
``_native`` library; ``datasets`` (HF) and ``fsspec`` (remote manifests) are
imported only by the backends that need them.
"""

from __future__ import annotations

import csv
import hashlib
import io
import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from torch.utils.data import Dataset

from avex_tpu_torch.configs import DatasetConfig

__all__ = [
    "AudioDataset",
    "ConcatenatedDataset",
    "HFAudioDataset",
    "LocalAudioDataset",
    "ManifestAudioDataset",
    "RelabeledDataset",
    "SubsetDataset",
    "SyntheticAudioDataset",
    "align_label_spaces",
    "apply_transform",
    "dataset_from_config",
]

logger = logging.getLogger(__name__)


class AudioDataset(Dataset):
    """Map-style dataset with a label space: ``len``, integer ``__getitem__``
    and ``label_names``."""

    def __init__(self, label_names: Optional[List[str]] = None) -> None:
        self.label_names = label_names or []

    @property
    def num_classes(self) -> int:
        """Number of distinct labels this dataset yields."""
        return len(self.label_names)

    def label_map(self) -> Dict[str, int]:
        """Label name → index."""
        return {name: i for i, name in enumerate(self.label_names)}

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Dict[str, Any]:  # pragma: no cover - abstract
        raise NotImplementedError


class SyntheticAudioDataset(AudioDataset):
    """Deterministic synthetic clips: class c is a chirp from 400·(c+1) Hz
    plus seeded noise, so a probe has something separable to learn."""

    def __init__(self, cfg: DatasetConfig) -> None:
        self.cfg = cfg
        super().__init__(label_names=[f"class_{i}" for i in range(cfg.num_classes)])
        self.sample_rate = cfg.sample_rate
        self.length = int(cfg.clip_seconds * cfg.sample_rate)

    def __len__(self) -> int:
        return self.cfg.num_samples

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        label = idx % self.cfg.num_classes
        rng = np.random.default_rng(self.cfg.seed * 100003 + idx)
        t = np.arange(self.length, dtype=np.float32) / self.sample_rate
        sweep = 400.0 * (label + 1) * (1.0 + 0.3 * t)
        wav = 0.3 * np.sin(2 * np.pi * sweep * t).astype(np.float32)
        wav += 0.05 * rng.standard_normal(self.length).astype(np.float32)
        return {"raw_wav": wav, "label": label, "text_label": f"a recording of {self.label_names[label]}"}


def _decode_resampled(path: Path, sample_rate: int) -> np.ndarray:
    """A ``.npy`` array, or a WAV/FLAC file decoded and resampled to ``sample_rate``."""
    if path.suffix == ".npy":
        return np.load(path).astype(np.float32)
    if path.suffix in (".wav", ".flac"):
        from avex_tpu_torch._native import decode_audio, resample

        wav, sr = decode_audio(str(path), mono=True)
        return resample(wav, sr, sample_rate) if sr != sample_rate else wav
    raise ValueError(f"Unsupported audio format: {path}")


class LocalAudioDataset(AudioDataset):
    """A directory of ``.wav``/``.flac``/``.npy`` clips and a metadata file
    (``metadata.csv``, ``metadata.jsonl`` or ``meta.csv``) with a ``path``
    column (relative to the directory), the ``label_column`` and optionally
    the ``text_column``."""

    def __init__(self, cfg: DatasetConfig) -> None:
        self.cfg = cfg
        self.root = Path(cfg.path or ".")
        meta_file = next((self.root / c for c in ("metadata.csv", "metadata.jsonl", "meta.csv")
                          if (self.root / c).exists()), None)
        if meta_file is None:
            raise FileNotFoundError(f"No metadata.csv/jsonl under {self.root}")
        with open(meta_file) as f:
            if meta_file.suffix == ".csv":
                self.rows: List[Dict[str, Any]] = list(csv.DictReader(f))
            else:
                self.rows = [json.loads(line) for line in f if line.strip()]
        labels = sorted({str(r[cfg.label_column]) for r in self.rows})
        super().__init__(label_names=labels)
        self._label_to_idx = {name: i for i, name in enumerate(labels)}

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        row = self.rows[idx]
        wav = _decode_resampled(self.root / row["path"], self.cfg.sample_rate)
        if self.cfg.audio_max_length_seconds:
            wav = wav[: int(self.cfg.audio_max_length_seconds * self.cfg.sample_rate)]
        item = {"raw_wav": wav, "label": self._label_to_idx[str(row[self.cfg.label_column])]}
        if self.cfg.text_column and self.cfg.text_column in row:
            item["text_label"] = row[self.cfg.text_column]
        return item


class ManifestAudioDataset(AudioDataset):
    """A JSONL/CSV manifest (local or remote) whose rows carry a ``path``
    (relative to ``data_root``, or absolute, or remote) and a single label or
    a list of labels (then the dataset is multilabel). Manifest and audio go
    through :mod:`avex_tpu_torch.io`."""

    def __init__(self, cfg: DatasetConfig) -> None:
        from avex_tpu_torch import io as aio

        self.cfg = cfg
        if not cfg.path:
            raise ValueError("manifest dataset requires `path` (the manifest file)")
        text = aio.read_text(cfg.path)
        if cfg.path.endswith(".csv"):
            self.rows = list(csv.DictReader(io.StringIO(text)))
        else:
            self.rows = [json.loads(line) for line in text.splitlines() if line.strip()]
        self.data_root = cfg.data_root or ""
        labels: set = set()
        self.multilabel = False
        for row in self.rows:
            lab = row[cfg.label_column]
            if isinstance(lab, (list, tuple)):
                self.multilabel = True
                labels.update(str(x) for x in lab)
            else:
                labels.add(str(lab))
        super().__init__(label_names=sorted(labels))
        self._label_to_idx = {name: i for i, name in enumerate(self.label_names)}

    def __len__(self) -> int:
        return len(self.rows)

    def _resolve(self, rel: str) -> str:
        if not self.data_root or "://" in rel or rel.startswith("/"):
            return rel
        return self.data_root.rstrip("/") + "/" + rel

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        from avex_tpu_torch import io as aio
        from avex_tpu_torch._native import decode_audio_bytes, resample

        row = self.rows[idx]
        wav, sr = decode_audio_bytes(aio.read_bytes(self._resolve(str(row["path"]))))
        if sr and sr != self.cfg.sample_rate:
            wav = resample(wav, int(sr), self.cfg.sample_rate)
        if self.cfg.audio_max_length_seconds:
            wav = wav[: int(self.cfg.audio_max_length_seconds * self.cfg.sample_rate)]
        lab = row[self.cfg.label_column]
        if isinstance(lab, (list, tuple)):
            label: Any = [self._label_to_idx[str(x)] for x in lab]
        else:
            label = self._label_to_idx[str(lab)]
        item = {"raw_wav": wav, "label": label}
        if self.cfg.text_column and self.cfg.text_column in row:
            item["text_label"] = row[self.cfg.text_column]
        return item


class HFAudioDataset(AudioDataset):
    """A HuggingFace ``datasets`` dataset (audio and label columns).

    Without ``soundfile``, the audio column is read undecoded and the native
    WAV/FLAC decoders decode it; decoded cells (``array`` and
    ``sampling_rate``) pass through. Audio is resampled to the configured rate.
    """

    def __init__(self, cfg: DatasetConfig) -> None:
        import datasets as hfds

        self.cfg = cfg
        if cfg.subset:
            self.ds = hfds.load_dataset(cfg.path, cfg.subset, split=cfg.split or "train")
        else:
            self.ds = hfds.load_dataset(cfg.path, split=cfg.split or "train")
        try:
            import soundfile  # noqa: F401
        except ImportError:
            feature = self.ds.features.get(cfg.audio_column)
            if feature is not None and hasattr(feature, "decode"):
                self.ds = self.ds.cast_column(cfg.audio_column, type(feature)(decode=False))
        feature = self.ds.features.get(cfg.label_column)
        labels = list(feature.names) if hasattr(feature, "names") else sorted(
            {str(x) for x in self.ds[cfg.label_column]})
        super().__init__(label_names=labels)
        self._label_to_idx = {name: i for i, name in enumerate(labels)}

    def __len__(self) -> int:
        return len(self.ds)

    @staticmethod
    def _decode_cell(audio: Any) -> tuple:
        """(float32 waveform, sample rate or None) of any HF audio cell."""
        from avex_tpu_torch._native import decode_audio, decode_audio_bytes

        if isinstance(audio, dict):
            if audio.get("array") is not None:
                return np.asarray(audio["array"], dtype=np.float32), audio.get("sampling_rate")
            if audio.get("bytes"):
                return decode_audio_bytes(audio["bytes"])
            if audio.get("path"):
                return decode_audio(str(audio["path"]))
            raise ValueError(f"Undecodable HF audio cell: keys={sorted(audio)}")
        if isinstance(audio, bytes):
            return decode_audio_bytes(audio)
        if isinstance(audio, str):
            return decode_audio(audio)
        return np.asarray(audio, dtype=np.float32), None

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        row = self.ds[int(idx)]
        wav, sr = self._decode_cell(row[self.cfg.audio_column])
        if wav.ndim == 2:
            wav = wav.mean(axis=-1 if wav.shape[-1] <= 2 else 0)
        if sr and sr != self.cfg.sample_rate:
            from avex_tpu_torch._native import resample

            wav = resample(wav, int(sr), self.cfg.sample_rate)
        label = row[self.cfg.label_column]
        if not isinstance(label, int):
            label = self._label_to_idx[str(label)]
        return {"raw_wav": wav, "label": label}


class ConcatenatedDataset(AudioDataset):
    """Datasets merged under a concat policy: ``hard`` (label spaces must be
    identical), ``overlap`` (their intersection, sorted; items outside it are
    dropped) or ``soft`` (their union, in order of appearance)."""

    def __init__(self, datasets: Sequence[AudioDataset], policy: str = "hard") -> None:
        names_list = [ds.label_names for ds in datasets]
        if policy == "hard":
            if any(names != names_list[0] for names in names_list[1:]):
                raise ValueError("hard concat requires identical label spaces")
            merged = list(names_list[0])
        elif policy == "overlap":
            merged = sorted(set(names_list[0]).intersection(*map(set, names_list[1:])))
        elif policy == "soft":
            merged = list(dict.fromkeys(n for names in names_list for n in names))
        else:
            raise ValueError(f"Unknown concat policy: {policy}")
        super().__init__(label_names=merged)
        self._map = {n: i for i, n in enumerate(merged)}
        self.datasets = list(datasets)
        self._index: List[tuple] = []
        for d_idx, ds in enumerate(self.datasets):
            for i in range(len(ds)):
                # as the JAX package: the overlap and soft policies read each item's label
                local_label = ds.label_names[ds[i]["label"]] if policy != "hard" else None
                if policy == "overlap" and local_label not in self._map:
                    continue
                self._index.append((d_idx, i))

    def __len__(self) -> int:
        return len(self._index)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        d_idx, i = self._index[idx]
        item = dict(self.datasets[d_idx][i])
        item["label"] = self._map[self.datasets[d_idx].label_names[item["label"]]]
        return item


class RelabeledDataset(AudioDataset):
    """A dataset's items with their labels remapped into a shared label space."""

    def __init__(self, base: AudioDataset, label_names: Sequence[str]) -> None:
        super().__init__(label_names=list(label_names))
        self.base = base
        shared = self.label_map()
        self._remap = {i: shared[name] for i, name in enumerate(base.label_names)}

    def __len__(self) -> int:
        return len(self.base)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        item = dict(self.base[idx])
        lab = item["label"]
        item["label"] = [self._remap[int(x)] for x in lab] if isinstance(lab, (list, tuple)) else self._remap[int(lab)]
        return item


def align_label_spaces(datasets: Sequence[Optional[AudioDataset]]) -> List[Optional[AudioDataset]]:
    """Put related splits onto one shared (sorted-union) label space.

    Splits loaded from separate sources each derive their own label map from
    their own rows; pairing them unaligned would permute class indices
    between train and test. Identical label spaces pass through unwrapped.
    """
    present = [ds for ds in datasets if ds is not None]
    if not present or all(ds.label_names == present[0].label_names for ds in present):
        return list(datasets)
    union = sorted({name for ds in present for name in ds.label_names})
    return [None if ds is None else RelabeledDataset(ds, union) for ds in datasets]


class SubsetDataset(AudioDataset):
    """The items of another dataset at ``indices``."""

    def __init__(self, base: AudioDataset, indices: List[int]) -> None:
        super().__init__(label_names=base.label_names)
        self.base = base
        self.indices = indices

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.base[self.indices[idx]]


_BACKENDS = {
    "synthetic": SyntheticAudioDataset,
    "local": LocalAudioDataset,
    "manifest": ManifestAudioDataset,
    "hf": HFAudioDataset,
}


def dataset_from_config(cfg: DatasetConfig) -> AudioDataset:
    """The configured backend, with the config's transformations applied in order."""
    if cfg.kind not in _BACKENDS:
        raise ValueError(f"Unknown dataset kind: {cfg.kind}")
    ds = _BACKENDS[cfg.kind](cfg)
    for transform in cfg.transformations:
        ds = apply_transform(ds, transform)
    return ds


def apply_transform(ds: AudioDataset, transform: Dict[str, Any]) -> AudioDataset:
    """A named dataset transform: ``rl_subsample`` (a seeded subsample by
    ``ratio`` and ``max_samples``) or ``train_val_split`` (a split by the
    MD5 of the item index)."""
    kind = transform.get("kind") or transform.get("name")
    if kind == "rl_subsample":
        n = len(ds)
        keep = int(n * transform.get("ratio", 1.0))
        if transform.get("max_samples") is not None:
            keep = min(keep, int(transform["max_samples"]))
        rng = np.random.default_rng(transform.get("seed", 0))
        return SubsetDataset(ds, sorted(rng.permutation(n)[:keep].tolist()))
    if kind == "train_val_split":
        want_val = transform.get("split", "train") == "val"
        threshold = transform.get("val_fraction", 0.1) * 1000
        indices = [i for i in range(len(ds))
                   if (int(hashlib.md5(f"{i}".encode()).hexdigest(), 16) % 1000 < threshold) == want_val]
        return SubsetDataset(ds, indices)
    raise ValueError(f"Unknown dataset transform: {kind}")
