"""Probe base: shape planning, layer projectors, learned layer weights.

Port of ``avex_tpu/probes/base.py``. The JAX package takes the embedding
shapes from ``jax.eval_shape``; the port runs one forward on zeros at B=1
(``ModelBase.embedding_shapes``), as the torch reference does. Multi-layer
handling is the JAX package's:

- per-layer linear projectors to a common width (the majority, else the
  maximum), none where the width already agrees;
- a learned softmax combination ``layer_weights`` (initialised to zero) over
  more than one layer;
- 2D heads flatten every embedding to ``(B, F)``; 3D heads take ``(B, T, F)``,
  with ``(B, C, H, W) → (B, W, H·C)``, and sequences of different lengths
  resampled to the shortest by ``jax.image.resize``'s linear method, which
  antialiases when it shrinks (:func:`linear_resize_matrix`).

The head computes in fp32: embeddings of a bf16 backbone are cast first, as
flax promotes bf16 inputs against fp32 parameters. A frozen backbone runs
under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import Counter
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from avex_tpu_torch.models.base import resolve_device
from avex_tpu_torch.probes.heads import (
    AttentionHead,
    LinearHead,
    LSTMHead,
    MLPHead,
    MoEHead,
    TransformerHead,
    dense,
)

__all__ = [
    "HEAD_CLASSES",
    "HEAD_DIMENSIONALITY",
    "Probe",
    "ProbeNet",
    "ProbePlan",
    "linear_resize_matrix",
    "make_probe_plan",
    "params_from_jax",
]

HEAD_CLASSES = {
    "linear": LinearHead,
    "mlp": MLPHead,
    "lstm": LSTMHead,
    "attention": AttentionHead,
    "transformer": TransformerHead,
    "moe": MoEHead,
}

#: heads on pooled (B, F) inputs (2) and on sequences (B, T, F) (3)
HEAD_DIMENSIONALITY = {"linear": 2, "mlp": 2, "lstm": 3, "attention": 3, "transformer": 3, "moe": 2}


def _majority_or_max(values: Sequence[int]) -> int:
    most, count = Counter(values).most_common(1)[0]
    return most if count > len(values) / 2 else max(values)


@dataclasses.dataclass(frozen=True)
class ProbePlan:
    """How the embeddings feed the head."""

    expected_dim: int  # 2 or 3
    input_shapes: Tuple[Tuple[int, ...], ...]  # per layer, no batch dimension
    target_feat: int
    needs_projector: Tuple[bool, ...]
    target_seq: Optional[int] = None  # 3D only: the shortest sequence

    @property
    def num_layers(self) -> int:
        """Number of embedding layers feeding the probe."""
        return len(self.input_shapes)

    def input_feat(self, i: int) -> int:
        """The width layer ``i`` has before its projector."""
        shape = self.input_shapes[i]
        if self.expected_dim == 2:
            return int(np.prod(shape))
        if len(shape) == 2:  # (T, F)
            return shape[1]
        return shape[0] * shape[1] if len(shape) == 3 else 1  # (C, H, W) or (F,)


def make_probe_plan(expected_dim: int, shapes: Sequence[Tuple[int, ...]]) -> ProbePlan:
    """The projector and combination plan of per-layer embedding shapes."""
    shapes = tuple(tuple(int(d) for d in s) for s in shapes)
    if expected_dim == 2:
        flat = [int(np.prod(s)) for s in shapes]
        target = _majority_or_max(flat)
        return ProbePlan(2, shapes, target, tuple(d != target for d in flat))

    info: List[Tuple[int, int]] = []  # (seq, feat) after normalisation
    for s in shapes:
        if len(s) == 2:  # (T, F)
            info.append((s[0], s[1]))
        elif len(s) == 3:  # (C, H, W) -> seq W, feat H*C
            info.append((s[2], s[0] * s[1]))
        elif len(s) == 1:  # (F,) -> seq F, feat 1
            info.append((s[0], 1))
        else:
            raise ValueError(f"Unsupported embedding shape {s} for 3D probe")
    target_feat = _majority_or_max([f for _, f in info])
    target_seq_vote = _majority_or_max([t for t, _ in info])
    needs = tuple(f != target_feat or t != target_seq_vote for t, f in info)
    return ProbePlan(3, shapes, target_feat, needs, target_seq=min(t for t, _ in info))


def _format_to_seq_feat(emb: torch.Tensor) -> torch.Tensor:
    """Any embedding → (B, T, F)."""
    if emb.ndim == 3:
        return emb
    if emb.ndim == 4:
        b, c, h, w = emb.shape
        return emb.permute(0, 3, 2, 1).reshape(b, w, h * c)
    if emb.ndim == 2:
        return emb[:, :, None]
    raise ValueError(f"Unsupported embedding rank {emb.ndim} for 3D probe")


def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``[out, in]`` weights of ``jax.image.resize(..., method="linear")``
    along one axis (``jax.image.scale_and_translate`` with scale out/in and
    no translation, ``antialias=True``): half-pixel sample points and the
    triangle kernel, widened by in/out when shrinking, each row normalised.
    It is not ``F.interpolate(mode="linear")``, which never widens."""
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - dist)  # [in, out]
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], weights, 0.0).T.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """:func:`linear_resize_matrix` on ``device``, built once per shape."""
    return torch.from_numpy(linear_resize_matrix(in_size, out_size)).to(device)


class ProbeNet(nn.Module):
    """Projectors, sequence alignment, layer mixing and the head as one module.

    ``forward`` takes the ordered list of per-layer embeddings (batch first).
    Parameters: ``projector_{i}``, ``layer_weights`` and ``head``, the JAX
    module's names.
    """

    def __init__(
        self,
        plan: ProbePlan,
        probe_type: str,
        num_classes: int,
        head_kwargs: Optional[Mapping[str, Any]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.plan, self.probe_type, self.num_classes = plan, probe_type, num_classes
        for i, needed in enumerate(plan.needs_projector):
            if needed:
                self.add_module(f"projector_{i}", dense(plan.input_feat(i), plan.target_feat, generator))
        self.layer_weights = nn.Parameter(torch.zeros(plan.num_layers)) if plan.num_layers > 1 else None
        self.head = HEAD_CLASSES[probe_type](plan.target_feat, num_classes, **dict(head_kwargs or {}),
                                             generator=generator)

    @staticmethod
    def _resize_to(seq: torch.Tensor, target: int) -> torch.Tensor:
        return torch.einsum("ot,btf->bof", _resize_weights(seq.shape[1], target, seq.device), seq)

    def forward(
        self,
        embeddings: Union[torch.Tensor, Sequence[torch.Tensor]],
        padding_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        plan = self.plan
        if isinstance(embeddings, torch.Tensor):
            embeddings = [embeddings]
        embeddings = list(embeddings)
        if len(embeddings) != plan.num_layers:
            raise ValueError(f"Probe built for {plan.num_layers} layers, got {len(embeddings)}")

        processed: List[torch.Tensor] = []
        for i, emb in enumerate(embeddings):
            emb = emb.float()
            x = emb.reshape(emb.shape[0], -1) if plan.expected_dim == 2 else _format_to_seq_feat(emb)
            if plan.needs_projector[i]:
                x = getattr(self, f"projector_{i}")(x)
            processed.append(x)

        if plan.expected_dim == 3 and len({p.shape[1] for p in processed}) > 1:
            target = min(p.shape[1] for p in processed)
            processed = [p if p.shape[1] == target else self._resize_to(p, target) for p in processed]

        if self.layer_weights is not None:
            weights = torch.softmax(self.layer_weights, dim=0)
            combined = sum(w * p for w, p in zip(weights, processed))
        else:
            combined = processed[0]

        if plan.expected_dim == 3:
            return self.head(combined, padding_mask=padding_mask, deterministic=deterministic, generator=generator)
        return self.head(combined, deterministic=deterministic, generator=generator)


class Probe:
    """Probe handle: online (on a backbone, raw audio in) or offline
    (embeddings in), with the reference probes' ``probe(x, padding_mask) →
    logits`` contract.

    The head lives on the backbone's device online and on ``device``
    (``cuda`` unless the caller names ``cpu``) offline. ``seed`` seeds the
    generator of its initialisation.
    """

    def __init__(
        self,
        probe_type: str,
        num_classes: int,
        base_model=None,
        layers: Optional[List[Union[str, int]]] = None,
        feature_mode: bool = False,
        input_dim: Optional[Union[int, Tuple[int, ...], List[Tuple[int, ...]]]] = None,
        aggregation: str = "mean",
        target_length: Optional[int] = None,
        freeze_backbone: bool = True,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        **head_kwargs: Any,
    ) -> None:
        if probe_type not in HEAD_CLASSES:
            raise ValueError(f"Unknown probe type {probe_type!r}; known: {sorted(HEAD_CLASSES)}")
        self.probe_type = probe_type
        self.num_classes = num_classes
        self.base_model = base_model
        self.feature_mode = feature_mode
        self.aggregation = aggregation
        self.freeze_backbone = freeze_backbone
        self.target_length = target_length
        self.layers = layers or ["last_layer"]
        self.device = base_model.device if base_model is not None and device is None else resolve_device(device)

        shapes = self._infer_embedding_shapes(HEAD_DIMENSIONALITY[probe_type], input_dim)
        self.plan = make_probe_plan(HEAD_DIMENSIONALITY[probe_type], shapes)
        generator = torch.Generator().manual_seed(seed)
        self.module = ProbeNet(self.plan, probe_type, num_classes, head_kwargs, generator).to(self.device)
        self.module.eval()

    def _infer_target_length(self) -> int:
        if self.target_length is not None:
            return int(self.target_length)
        ac = getattr(self.base_model, "audio_config", None)
        if ac is not None and ac.target_length_seconds is not None:
            return int(ac.target_length_seconds * ac.sample_rate)
        return 16000  # 1 s at 16 kHz, the reference's dummy clip

    def _infer_embedding_shapes(self, expected: int, input_dim) -> List[Tuple[int, ...]]:
        if self.feature_mode and input_dim is not None:
            if isinstance(input_dim, int):
                # an int: (F,) for 2D heads, (1, F) for 3D heads
                return [(input_dim,)] if expected == 2 else [(1, input_dim)]
            if isinstance(input_dim, tuple):
                return [tuple(input_dim)]
            return [tuple(s) for s in input_dim]
        if self.base_model is None:
            raise ValueError("input_dim must be provided when feature_mode=True and base_model is None")
        self.base_model.register_hooks_for_layers(self.layers)
        shapes = self.base_model.embedding_shapes((1, self._infer_target_length()), aggregation=self.aggregation)
        return [tuple(s[1:]) for s in shapes]

    def _as_tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x, device=self.device)

    def _get_embeddings(self, x, padding_mask=None):
        """The embeddings the head takes: offline, ``x`` itself (or the
        entries of a cached-embedding batch); online, the backbone's, under
        ``torch.no_grad()`` when the backbone is frozen."""
        if self.feature_mode:
            if isinstance(x, dict):
                if "raw_wav" in x:
                    return x["raw_wav"]
                keys = [k for k in x if k not in ("label", "padding_mask", "text_label")]
                return x[keys[0]] if len(keys) == 1 else [x[k] for k in keys]
            return x
        if isinstance(x, dict):
            padding_mask = x.get("padding_mask", padding_mask)
            x = x["raw_wav"]
        return self.base_model.extract_embeddings(
            x, padding_mask=padding_mask, aggregation=self.aggregation, freeze_backbone=self.freeze_backbone
        )

    def __call__(self, x, padding_mask=None) -> torch.Tensor:
        return self.forward(x, padding_mask)

    def forward(self, x, padding_mask=None) -> torch.Tensor:
        """Probe logits for raw audio (online) or embeddings (offline), dropout off."""
        embs = self._get_embeddings(x, padding_mask)
        embs = [self._as_tensor(e) for e in (embs if isinstance(embs, (list, tuple)) else [embs])]
        mask = None if padding_mask is None else self._as_tensor(padding_mask)
        return self.module(embs, mask)

    def get_learned_weights_table(self) -> str:
        """Human-readable table of the learned layer weights."""
        if self.module.layer_weights is None:
            return "No learned weights found. This probe does not use weighted sum of embeddings."
        raw = self.module.layer_weights.detach().float().cpu().numpy()
        norm = torch.softmax(torch.from_numpy(raw), dim=0).numpy()
        lines = ["Learned Layer Weights:", "=" * 50]
        lines.append(f"{'Layer':<15} {'Raw Weight':<12} {'Normalized':<12} {'Percentage':<12}")
        lines.append("-" * 50)
        for i, (r, n) in enumerate(zip(raw, norm)):
            lines.append(f"Layer_{i:<9} {r:<12.4f} {n:<12.4f} {n * 100:<12.2f}%")
        lines.append("-" * 50)
        lines.append("Sum of normalized weights: %.6f" % norm.sum())
        lines.append("Number of layers: %d" % len(raw))
        return "\n".join(lines)


def params_from_jax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX ``Probe.variables["params"]`` tree (numpy arrays) → the state
    dict of this port's :class:`ProbeNet`.

    Dense ``[in, out]`` → Linear ``[out, in]``; LayerNorm ``scale`` →
    ``weight``; attention ``query``/``key``/``value`` ``[E, H, D]`` → ``[H·D,
    E]`` with bias ``[H, D]`` → ``[H·D]``, ``out`` ``[H, D, E]`` → ``[E, H·D]``;
    the LSTM cells ``OptimizedLSTMCell_{j}`` (creation order: per layer the
    forward cell, then the backward one) → ``lstm_{i}``'s ``weight_ih``
    (``ii, if, ig, io`` stacked), ``weight_hh`` (``hi, hf, hg, ho``), the
    hidden biases as ``bias_hh`` and a zero ``bias_ih``; the MoE
    ``router`` dense and the expert-major ``w1/b1/w2/b2`` as they are.
    """
    out: Dict[str, np.ndarray] = {}

    def put(key: str, value: Any) -> None:
        out[key] = np.asarray(value, dtype=np.float32)

    def convert(prefix: str, node: Mapping[str, Any]) -> None:
        if "kernel" in node:  # Dense / DenseGeneral
            kernel = np.asarray(node["kernel"])
            if kernel.ndim == 3 and prefix.endswith(".out"):  # [H, D, E]
                put(f"{prefix}.weight", kernel.reshape(-1, kernel.shape[-1]).T)
            elif kernel.ndim == 3:  # [E, H, D]
                put(f"{prefix}.weight", kernel.reshape(kernel.shape[0], -1).T)
            else:
                put(f"{prefix}.weight", kernel.T)
            put(f"{prefix}.bias", np.asarray(node["bias"]).reshape(-1))
        elif "scale" in node:  # LayerNorm
            put(f"{prefix}.weight", node["scale"])
            put(f"{prefix}.bias", node["bias"])
        else:
            for name, child in node.items():
                key = f"{prefix}.{name}" if prefix else name
                if isinstance(child, Mapping):
                    convert(key, child)
                else:  # layer_weights, pos_encoding, the experts' w1/b1/w2/b2
                    put(key, child)

    head = dict(params.get("head", {}))
    cells = sorted((k for k in head if k.startswith("OptimizedLSTMCell_")), key=lambda k: int(k.rsplit("_", 1)[1]))
    if cells:
        bidirectional = _lstm_bidirectional(head, cells)
        per_layer = 2 if bidirectional else 1
        for j, name in enumerate(cells):
            cell = head.pop(name)
            suffix = "_reverse" if bidirectional and j % 2 else ""
            prefix = f"head.lstm_{j // per_layer}"
            put(f"{prefix}.weight_ih_l0{suffix}",
                np.concatenate([np.asarray(cell[g]["kernel"]).T for g in ("ii", "if", "ig", "io")]))
            put(f"{prefix}.weight_hh_l0{suffix}",
                np.concatenate([np.asarray(cell[g]["kernel"]).T for g in ("hi", "hf", "hg", "ho")]))
            put(f"{prefix}.bias_hh_l0{suffix}", np.concatenate([cell[g]["bias"] for g in ("hi", "hf", "hg", "ho")]))
            put(f"{prefix}.bias_ih_l0{suffix}", np.zeros(4 * np.asarray(cell["hi"]["bias"]).shape[0]))
    rest = {k: v for k, v in params.items() if k != "head"}
    convert("", rest)
    convert("head", head)
    return out


def _lstm_bidirectional(head: Mapping[str, Any], cells: List[str]) -> bool:
    """Whether the cells pair up as forward/backward: the classifier then
    takes twice the hidden width."""
    hidden = np.asarray(head[cells[0]]["hi"]["bias"]).shape[0]
    return np.asarray(head["classifier"]["kernel"]).shape[0] == 2 * hidden
