"""Collater and augmentations: dataset items → one fixed-shape numpy batch.

Port of ``avex_tpu/data/collate.py``. Collation stays in numpy on the host,
in the loader's worker processes, and draws its randomness in the JAX
package's order, so that the same generator gives the same batch bit for
bit: per item the dataset-length crop, then each noise augmentation, then
the window start; then mixup over the whole batch. The loader turns the
batch into tensors.
"""

from __future__ import annotations

import glob
import inspect
import logging
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from avex_tpu_torch.configs import MixupAugment, NoiseAugment
from avex_tpu_torch.ops.audio import pad_or_window_np, window_start

__all__ = ["Collater", "MixupAugmenter", "NoiseAugmenter", "accepts_rng"]

logger = logging.getLogger(__name__)


def accepts_rng(collate_fn) -> bool:
    """True when ``collate_fn`` takes an ``rng`` keyword: then the loader
    hands it one generator per batch."""
    try:
        return "rng" in inspect.signature(collate_fn).parameters
    except (TypeError, ValueError):
        return False


class NoiseAugmenter:
    """Additive noise from a pool of ``.npy``/``.wav`` files at an SNR drawn
    from ``snr_db_range``; with ``mask_signal_prob`` the noise alone."""

    def __init__(self, cfg: NoiseAugment, sample_rate: int = 16000, seed: int = 0) -> None:
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.rng = np.random.default_rng(seed)
        self.noise_files: List[str] = []
        for noise_dir in cfg.noise_dirs:
            self.noise_files.extend(sorted(glob.glob(os.path.join(noise_dir, "*.npy"))))
            self.noise_files.extend(sorted(glob.glob(os.path.join(noise_dir, "*.wav"))))
        if not self.noise_files:
            logger.warning("Noise augment configured but no noise files found in %s", cfg.noise_dirs)

    @staticmethod
    def _load_noise(path: str) -> np.ndarray:
        if path.endswith(".npy"):
            return np.load(path).astype(np.float32)
        from scipy.io import wavfile

        from avex_tpu_torch._native import pcm_to_float

        _sr, wav = wavfile.read(path)
        wav = pcm_to_float(wav)
        return wav if wav.ndim == 1 else wav.mean(axis=1)

    def __call__(self, wav: np.ndarray, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or self.rng
        if not self.noise_files or rng.random() > self.cfg.augmentation_prob:
            return wav
        noise = self._load_noise(self.noise_files[rng.integers(len(self.noise_files))])
        noise, _ = pad_or_window_np(noise, wav.shape[-1], "random", rng=rng)
        snr_db = rng.uniform(*self.cfg.snr_db_range)
        sig_power = np.mean(wav**2) + 1e-10
        noise_power = np.mean(noise**2) + 1e-10
        scale = np.sqrt(sig_power / (noise_power * 10 ** (snr_db / 10.0)))
        if rng.random() < self.cfg.mask_signal_prob:
            return (noise * scale).astype(np.float32)
        return (wav + noise * scale).astype(np.float32)


class MixupAugmenter:
    """Batch-level mixup: ``n_mixup`` Beta(alpha, alpha)-weighted convex
    combinations of the batch with a permutation of itself, audio and labels."""

    def __init__(self, cfg: MixupAugment, seed: int = 0) -> None:
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def __call__(self, batch: Dict[str, np.ndarray], rng: Optional[np.random.Generator] = None
                 ) -> Dict[str, np.ndarray]:
        rng = rng or self.rng
        if rng.random() > self.cfg.augmentation_prob:
            return batch
        wav, labels = batch["raw_wav"], batch["label"]
        n = wav.shape[0]
        for _ in range(self.cfg.n_mixup):
            lam = float(rng.beta(self.cfg.alpha, self.cfg.alpha))
            perm = rng.permutation(n)
            wav = lam * wav + (1.0 - lam) * wav[perm]
            labels = lam * labels + (1.0 - lam) * labels[perm]
        batch = dict(batch)
        batch["raw_wav"] = wav.astype(np.float32)
        batch["label"] = labels.astype(np.float32)
        return batch


class Collater:
    """Items → ``{raw_wav, padding_mask, label[, text_label]}`` numpy batch.

    Non-finite clips are zeroed, stereo is averaged to mono, clips are
    cropped to ``dataset_max_len`` and then windowed (``random`` in training,
    ``center`` otherwise) or right-padded to ``target_len`` (``padding_mask``
    True on the padding), integer labels become one-hot (multi-hot for
    multilabel), and mixup runs on the assembled batch. Augmentations apply
    to training batches only.
    """

    def __init__(
        self,
        target_len: int,
        num_classes: int,
        window_selection: str = "random",
        dataset_max_len: Optional[int] = None,
        multilabel: bool = False,
        one_hot: bool = True,
        augmentations: Optional[Sequence[Any]] = None,
        sample_rate: int = 16000,
        seed: int = 0,
        train: bool = True,
    ) -> None:
        self.target_len = target_len
        self.num_classes = num_classes
        self.window_selection = window_selection if train else "center"
        self.dataset_max_len = dataset_max_len
        self.multilabel = multilabel
        self.one_hot = one_hot
        self.rng = np.random.default_rng(seed)
        self.item_augments: List[NoiseAugmenter] = []
        self.batch_augments: List[MixupAugmenter] = []
        for aug in (augmentations or []) if train else []:
            if isinstance(aug, NoiseAugment):
                self.item_augments.append(NoiseAugmenter(aug, sample_rate, seed))
            elif isinstance(aug, MixupAugment):
                self.batch_augments.append(MixupAugmenter(aug, seed))

    def __call__(self, items: Sequence[Dict[str, Any]], rng: Optional[np.random.Generator] = None
                 ) -> Dict[str, Any]:
        """One batch; ``rng`` (the loader's per-batch generator) makes the
        call a pure function of its inputs."""
        rng = rng or self.rng
        n = len(items)
        out = np.zeros((n, self.target_len), dtype=np.float32)
        pad_mask = np.zeros((n, self.target_len), dtype=bool)
        labels, texts = [], []
        for i, item in enumerate(items):
            wav = np.asarray(item["raw_wav"], dtype=np.float32)
            if wav.ndim == 2:  # stereo → mono
                wav = wav.mean(axis=0 if wav.shape[0] <= 2 else 1)
            if not np.isfinite(wav).all():  # a corrupted clip
                wav = np.zeros_like(wav)
            if self.dataset_max_len and wav.shape[-1] > self.dataset_max_len:
                wav, _ = pad_or_window_np(wav, self.dataset_max_len, "random", rng=rng)
            for aug in self.item_augments:
                wav = aug(wav, rng=rng)
            length = wav.shape[-1]
            if length > self.target_len:
                start = window_start(length, self.target_len, self.window_selection, rng=rng)
                out[i] = wav[start:start + self.target_len]
            else:
                out[i, :length] = wav
                pad_mask[i, length:] = True
            labels.append(item.get("label", 0))
            texts.append(item.get("text_label", ""))
        batch: Dict[str, Any] = {"raw_wav": out, "padding_mask": pad_mask, "label": self._encode_labels(labels)}
        if any(texts):
            batch["text_label"] = texts
        for aug in self.batch_augments:
            batch = aug(batch, rng=rng)
        return batch

    def _encode_labels(self, labels: List[Any]) -> np.ndarray:
        if self.multilabel:
            out = np.zeros((len(labels), self.num_classes), dtype=np.float32)
            for i, lab in enumerate(labels):
                for idx in np.atleast_1d(lab):
                    out[i, int(idx)] = 1.0
            return out
        idx = np.asarray([int(np.atleast_1d(lab)[0]) for lab in labels], dtype=np.int64)
        if self.one_hot and self.num_classes:
            return np.eye(self.num_classes, dtype=np.float32)[idx]
        return idx
