"""Base handle for the port's models (port of ``avex_tpu/models/base.py``).

``ModelBase`` pairs an ``nn.Module`` whose ``forward`` returns
``(output, aux)`` — ``aux["intermediates"]`` maps reference layer names to
activations, with no forward hooks — with the reference model API: layer
discovery and selection (int, negative int, ``all``, ``last_layer``),
``forward`` / ``__call__``, ``batch_inference``, and ``extract_embeddings``
with ``none`` / ``mean`` / ``max`` / ``cls_token`` aggregation (a conv
map's, for the models that take it, pools the time axis) and multi-layer
concatenation, and ``embedding_shapes`` (one forward at B=1 on
zeros) for sizing a probe. For training, :meth:`ModelBase.train_forward`
runs the module with the strategy's keywords (``deterministic``,
``disable_layerdrop``, ``generator``) filtered by the module's signature, and
``frozen_param_keys`` names top-level parameter groups no optimizer updates.

Placement is explicit: a model lives on ``cuda`` unless it was built with
``device="cpu"``, and it never moves to the CPU by itself.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avex_tpu_torch.configs import AudioConfig
from avex_tpu_torch.models.common import unstack_state
from avex_tpu_torch.ops.frontend import AudioProcessor

logger = logging.getLogger(__name__)

ArrayLike = Union[torch.Tensor, np.ndarray]


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device a model runs on: ``cuda`` unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and there is no
    card: the port does not carry on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "avex_tpu_torch runs on CUDA by default and no CUDA device is available; "
            'pass device="cpu" to run on the CPU'
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (use 'cuda' or 'cpu')")
    return dev


class ModelBase:
    """Pairs a torch module with the reference model API.

    Subclasses set ``self.module`` (an ``nn.Module`` whose ``forward(x,
    padding_mask)`` returns ``(output, aux)``) and implement
    ``_discover_embedding_layers``.
    """

    #: top-level parameter names (the first component of a name in the
    #: module's ``named_parameters``) that the trainer never updates, e.g. an
    #: EMA teacher (the JAX package's meaning)
    frozen_param_keys: Tuple[str, ...] = ()

    def __init__(
        self,
        device: Optional[Union[str, torch.device]] = None,
        audio_config: Optional[Union[AudioConfig, Dict[str, Any]]] = None,
    ) -> None:
        if isinstance(audio_config, dict):
            audio_config = AudioConfig(**audio_config)
        self.device = resolve_device(device)
        self.audio_config = audio_config
        self.audio_processor = AudioProcessor(audio_config) if audio_config is not None else None
        self.module: Optional[torch.nn.Module] = None
        self.label_mapping: Optional[Dict[str, Any]] = None
        self.num_classes: Optional[int] = None
        self._layer_names: List[str] = []
        self._hook_layers: List[str] = []
        self._training = False

    # ------------------------------------------------------------------
    # Layer discovery / selection
    # ------------------------------------------------------------------

    def _discover_embedding_layers(self) -> None:
        raise NotImplementedError

    def get_model_layers(self) -> List[str]:
        """All discoverable embedding layer names, in forward order."""
        self._discover_embedding_layers()
        return list(self._layer_names)

    def get_model_layer_map(self) -> Dict[int, str]:
        """Index → layer-name mapping for int-based selection."""
        return dict(enumerate(self.get_model_layers()))

    def _get_last_non_classification_layer(self) -> Optional[str]:
        if not self._layer_names:
            return None
        for name in reversed(self._layer_names):
            if any(tag in name.lower() for tag in ("classifier", "head")):
                continue
            return name
        return self._layer_names[-1]

    def register_hooks_for_layers(self, target_layers: List[Union[str, int]]) -> List[str]:
        """Resolve layer selectors and record them as the active capture set.

        0-based (negative OK) indices into :meth:`get_model_layers`, the
        literals ``all`` and ``last_layer`` (last non-classification layer),
        order-preserving dedup. No runtime hooks exist: this selects which
        intermediates later calls read.
        """
        self._discover_embedding_layers()
        resolved: List[str] = []
        for layer in target_layers:
            if isinstance(layer, bool):
                raise TypeError("target_layers entries must be str or int (bool is not allowed).")
            if isinstance(layer, int):
                try:
                    resolved.append(self._layer_names[layer])
                except IndexError as err:
                    n = len(self._layer_names)
                    raise ValueError(f"Layer index {layer} is out of range for {n} layers") from err
            else:
                resolved.append(layer)

        if "all" in resolved:
            resolved = [name for name in resolved if name != "all"] + list(self._layer_names)
        if "last_layer" in resolved:
            last = self._get_last_non_classification_layer()
            if not last:
                raise ValueError("No layers available for 'last_layer'")
            resolved = [last if name == "last_layer" else name for name in resolved]

        seen: set = set()
        unique = [n for n in resolved if not (n in seen or seen.add(n))]
        for name in unique:
            if name not in self._layer_names:
                raise ValueError(f"Layer '{name}' not found in model. Available: {self._layer_names}")
        self._hook_layers = unique
        return unique

    def ensure_hooks_registered(self) -> None:
        """API-parity no-op: functional capture cannot be lost."""

    def deregister_all_hooks(self) -> None:
        """Clear the active capture-layer selection."""
        self._hook_layers = []

    # ------------------------------------------------------------------
    # Forward / audio processing
    # ------------------------------------------------------------------

    def _as_input(self, x: ArrayLike) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _as_mask(self, padding_mask: Optional[ArrayLike]) -> Optional[torch.Tensor]:
        if padding_mask is None:
            return None
        return torch.as_tensor(padding_mask, dtype=torch.bool, device=self.device)

    def process_audio(self, x: ArrayLike) -> torch.Tensor:
        """Apply the configured audio frontend."""
        x = self._as_input(x)
        if self.audio_processor is None:
            return x
        return self.audio_processor(x)

    def forward(self, x: ArrayLike, padding_mask: Optional[ArrayLike] = None) -> torch.Tensor:
        """Primary model output (logits or features); tracks gradients only in train mode."""
        with torch.set_grad_enabled(self._training):
            out, _ = self.module(self._as_input(x), self._as_mask(padding_mask))
        return out

    def __call__(self, x: ArrayLike, padding_mask: Optional[ArrayLike] = None) -> torch.Tensor:
        return self.forward(x, padding_mask)

    def train_forward(self, x: ArrayLike, padding_mask: Optional[ArrayLike] = None, **kwargs: Any):
        """The module's ``(output, aux)`` on the processed audio, with grad
        tracking as the caller has it. ``kwargs`` is the strategies' superset
        of per-model knobs (``deterministic``, ``disable_layerdrop``,
        ``generator``), filtered against the module's ``forward`` signature so
        that every architecture trains through one step, as the JAX trainer's
        ``_make_apply_fn`` does."""
        accepted = inspect.signature(type(self.module).forward).parameters
        kwargs = {k: v for k, v in kwargs.items() if k in accepted}
        return self.module(self.process_audio(x), self._as_mask(padding_mask), **kwargs)

    def batch_inference(self, batched_samples: Sequence[ArrayLike]) -> torch.Tensor:
        """Run :meth:`forward` over pre-batched chunks and concatenate."""
        outs = []
        for batch in batched_samples:
            out = self.forward(self.process_audio(batch))
            if out.ndim == 1:
                out = out[None]
            outs.append(out)
        return torch.cat(outs, dim=0)

    # ------------------------------------------------------------------
    # Embedding extraction
    # ------------------------------------------------------------------

    @staticmethod
    def _aggregate(emb: torch.Tensor, aggregation: str) -> torch.Tensor:
        if emb.ndim == 2:
            return emb
        if emb.ndim == 3:
            if aggregation == "mean":
                return emb.mean(dim=1)
            if aggregation == "max":
                return emb.amax(dim=1)
            if aggregation == "cls_token":
                return emb[:, 0, :]
            raise ValueError(f"Unsupported aggregation method: {aggregation}")
        raise ValueError(f"Unexpected embedding dimension: {emb.ndim}. Expected 2 or 3.")

    @staticmethod
    def _aggregate_conv_map(emb: torch.Tensor, aggregation: str) -> torch.Tensor:
        """A conv map ``[B, C, H, W]`` (EfficientNet's override of
        :meth:`_aggregate`, as the reference wrapper's): ``mean`` / ``max``
        over the trailing time axis, then flattened to ``[B, C·H]``;
        ``cls_token`` takes channel 0 and flattens it to ``[B, H·W]``."""
        if aggregation == "mean":
            pooled = emb.mean(dim=-1)
        elif aggregation == "max":
            pooled = emb.amax(dim=-1)
        elif aggregation == "cls_token":
            pooled = emb[:, 0, :]
        else:
            raise ValueError(f"Unsupported aggregation method: {aggregation}")
        return pooled.reshape(pooled.shape[0], -1)

    def extract_fn(self, layers: Tuple[str, ...], aggregation: str):
        """``(x, padding_mask) → embeddings`` for these layers and this aggregation."""

        def extract(x: torch.Tensor, padding_mask: Optional[torch.Tensor]):
            _, aux = self.module(x, padding_mask)
            return self._select_intermediates(aux["intermediates"], layers, aggregation)

        return extract

    @classmethod
    def _select_intermediates(
        cls, inter: Dict[str, torch.Tensor], layers: Tuple[str, ...], aggregation: str
    ):
        """Pick requested layers from an intermediates dict and pool/concat them."""
        missing = [name for name in layers if name not in inter]
        if missing:
            raise ValueError(
                f"Some requested layers did not produce outputs: {missing}. "
                f"Available: {list(inter.keys())}"
            )
        embs = [inter[name] for name in layers]
        if aggregation == "none":
            return embs[0] if len(embs) == 1 else tuple(embs)
        embs = [cls._aggregate(e, aggregation) for e in embs]
        return embs[0] if len(embs) == 1 else torch.cat(embs, dim=1)

    def extract_embeddings(
        self,
        x: Union[ArrayLike, Dict[str, ArrayLike]],
        *,
        padding_mask: Optional[ArrayLike] = None,
        aggregation: str = "none",
        freeze_backbone: bool = True,
    ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """Capture the selected layers' activations in one forward.

        Returns one tensor when one layer is selected or aggregation is
        active (layers pooled, then concatenated on the feature axis), and a
        list of per-layer tensors for multi-layer ``aggregation="none"``.
        With ``freeze_backbone`` no gradients are tracked.
        """
        if not self._hook_layers:
            raise ValueError("No hooks registered. Call register_hooks_for_layers() first.")
        if isinstance(x, dict):
            padding_mask = x.get("padding_mask", padding_mask)
            x = x["raw_wav"]
        extract = self.extract_fn(tuple(self._hook_layers), aggregation)
        with torch.set_grad_enabled(not freeze_backbone):
            out = extract(self._as_input(x), self._as_mask(padding_mask))
        return list(out) if isinstance(out, tuple) else out

    def embedding_shapes(self, input_shape: Tuple[int, ...], aggregation: str = "none") -> List[Tuple[int, ...]]:
        """Per-selected-layer embedding shapes for an input of ``input_shape``.

        One forward on zeros at batch 1 under ``torch.no_grad()`` on the
        model's device (the JAX package's ``jax.eval_shape`` does no work; a
        kernel here reads real memory, so the port cannot trace on ``meta``).
        The model's kernels launch once; the batch dimension of the result
        is ``input_shape``'s.
        """
        if not self._hook_layers:
            raise ValueError("No hooks registered. Call register_hooks_for_layers() first.")
        extract = self.extract_fn(tuple(self._hook_layers), aggregation)
        with torch.no_grad():
            out = extract(torch.zeros((1,) + tuple(input_shape[1:]), device=self.device), None)
        out = out if isinstance(out, tuple) else (out,)
        return [(int(input_shape[0]),) + tuple(o.shape[1:]) for o in out]

    # ------------------------------------------------------------------
    # torch-module delegation
    # ------------------------------------------------------------------

    def to(self, device: Union[str, torch.device]) -> "ModelBase":
        """Move the module to ``device`` (``cuda`` needs a card)."""
        self.device = resolve_device(device)
        self.module.to(self.device)
        return self

    def eval(self) -> "ModelBase":
        """Switch to inference mode."""
        self._training = False
        self.module.eval()
        return self

    def train(self, mode: bool = True) -> "ModelBase":
        """Toggle training mode."""
        self._training = mode
        self.module.train(mode)
        return self

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's state dict, in the port's own key layout."""
        return self.module.state_dict()

    def _enable_layer_runner(self, stack: Any, mesh: Any, what: str, hint: str,
                             num_microbatches: Optional[int] = None) -> None:
        """Run ``stack``'s layers through a mesh's model axis (JAX's
        ``enable_pipeline`` / ``enable_sequence_parallel``): ``what`` is
        ``"pipeline parallelism"`` or ``"sequence parallelism"``; both need
        the stacked layout, as in JAX (``hint`` says how to ask for it)."""
        from avex_tpu_torch.parallel.pipeline import make_pipeline_runner
        from avex_tpu_torch.parallel.sequence import make_sequence_parallel_runner
        from avex_tpu_torch.parallel.tensor import TensorParallelLayout

        if self.stacked_layers is None:
            raise ValueError(f"{what} needs the stacked (scan_layers=True) parameter layout; {hint}")
        if what == "pipeline parallelism":
            stack.layer_runner = make_pipeline_runner(mesh, num_microbatches=num_microbatches)
            if hasattr(stack, "share_over"):  # a bias every stage reads (BEATs')
                stack.share_over(mesh.model_axis)
        else:  # Megatron-SP comes with tensor parallelism: the tensors JAX's _tp_shard_params cuts are cut
            stack.layer_runner = make_sequence_parallel_runner(mesh)
            if mesh.model_size > 1:
                self.model_axis_layout = TensorParallelLayout(self.module, mesh, sequence=True)

    def enable_gradient_checkpointing(self) -> None:
        """Recompute each layer's activations in the backward pass; see subclasses."""
        raise NotImplementedError(f"{type(self).__name__} does not support gradient checkpointing.")

    def load_state_dict(self, state: Dict[str, np.ndarray], strict: bool = False) -> None:
        """Install converted reference-checkpoint weights; see subclasses."""
        raise NotImplementedError

    def quantize(self, mode: str = "int8") -> None:
        """Convert to a quantized inference mode (see ``avex_tpu_torch.quant``).

        Supported by the architectures that say so (BEATs); one-way and
        inference-only.
        """
        raise NotImplementedError(f"{type(self).__name__} does not support quantization.")

    #: the module's layer stack in JAX's ``scan_layers`` layout at the edges
    #: (``load_port_state_dict`` takes it stacked): its state-dict path, or None
    stacked_layers: Optional[str] = None
    #: what a model-axis layout made of the module (sequence parallelism sets it)
    model_axis_layout: Any = None

    def load_port_state_dict(self, state: Dict[str, np.ndarray], strict: bool = False) -> None:
        """Load a state dict already in the port's key layout (e.g. from a
        model module's ``params_from_jax``). Entries of unknown name or shape
        are skipped with a warning, or raise when ``strict``. With
        :attr:`stacked_layers` set, the stack may come stacked (JAX's
        ``scan_layers`` layout: one entry per tensor with a leading layer axis)."""
        if self.stacked_layers is not None:
            state = unstack_state(state, self.stacked_layers)
        own = self.module.state_dict()
        skipped = [
            k for k, v in state.items() if k not in own or tuple(own[k].shape) != tuple(np.shape(v))
        ]
        if skipped:
            message = f"Skipped {len(skipped)} checkpoint entries: {skipped[:8]}..."
            if strict:
                raise ValueError(message)
            logger.warning(message)
        tensors = {
            k: torch.tensor(np.asarray(v), dtype=own[k].dtype)
            for k, v in state.items()
            if k not in skipped
        }
        self.module.load_state_dict(tensors, strict=False)
