"""Model, audio and training configuration of the port, as dataclasses.

Counterparts of ``avex_tpu.configs.ModelSpec`` and ``AudioConfig`` with the
fields that the BEATs, EAT and AVES paths read, of ``TrainingParams``,
``SchedulerConfig`` and the part of ``RunConfig`` that the trainer reads, and
of ``ProbeConfig`` (with the ``PROBE_CONFIGS`` presets) and
``ClusteringEvalConfig``.
Unknown fields raise ``TypeError`` as the dataclass constructor does; the
value checks of the JAX package's pydantic models raise ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

__all__ = [
    "PROBE_CONFIGS",
    "AudioConfig",
    "ClusteringEvalConfig",
    "ModelSpec",
    "ProbeConfig",
    "RunConfig",
    "SchedulerConfig",
    "TrainingParams",
]

_REPRESENTATIONS = ("spectrogram", "mel_spectrogram", "raw")
_COMPUTE_DTYPES = ("float32", "bfloat16")


@dataclass
class AudioConfig:
    """How raw audio becomes the model input (≈ ``avex_tpu.configs.AudioConfig``)."""

    sample_rate: int = 16000
    representation: str = "mel_spectrogram"
    normalize: bool = True
    target_length_seconds: Optional[float] = None
    window_selection: str = "random"

    def __post_init__(self) -> None:
        if self.representation not in _REPRESENTATIONS:
            raise ValueError(
                f"representation must be one of {_REPRESENTATIONS}, got {self.representation!r}"
            )
        if self.window_selection not in ("random", "center"):
            raise ValueError(f"window_selection must be 'random' or 'center', got "
                             f"{self.window_selection!r}")

    @property
    def target_length_samples(self) -> Optional[int]:
        """Target clip length in samples (sample_rate x target_length_seconds)."""
        if self.target_length_seconds is None:
            return None
        return int(round(self.target_length_seconds * self.sample_rate))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class ModelSpec:
    """Architecture + weights selector consumed by the model factory.

    ``device`` defaults to ``cuda``: the port runs on the card unless the
    caller asks for the CPU.
    """

    name: str
    pretrained: bool = True
    device: str = "cuda"
    audio_config: Optional[Union[AudioConfig, Dict[str, Any]]] = None
    # EAT
    eat_norm_mean: Optional[float] = None
    eat_norm_std: Optional[float] = None
    # BEATs
    use_naturelm: Optional[bool] = None
    fine_tuned: Optional[bool] = None
    init_config: Optional[Dict[str, Any]] = None
    # numeric policy of the backbone compute
    compute_dtype: str = "float32"

    def __post_init__(self) -> None:
        if isinstance(self.audio_config, dict):
            self.audio_config = AudioConfig(**self.audio_config)
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {_COMPUTE_DTYPES}, got {self.compute_dtype!r}"
            )

    def replace(self, **changes: Any) -> "ModelSpec":
        """A copy with ``changes`` applied (≈ pydantic ``model_copy(update=...)``)."""
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _one_of(name: str, value: Any, allowed: Tuple[Any, ...]) -> None:
    if value not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {value!r}")


def _at_least(name: str, value: Any, low: float, strict: bool = False) -> None:
    if value < low or (strict and value == low):
        raise ValueError(f"{name} must be {'>' if strict else '>='} {low}, got {value!r}")


@dataclass
class TrainingParams:
    """Optimization hyper-parameters of a training run (≈ ``avex_tpu.configs.TrainingParams``)."""

    train_epochs: int
    lr: float
    batch_size: int
    optimizer: str = "adamw"
    weight_decay: float = 0.0
    adam_betas: Optional[Tuple[float, float]] = None
    amp: bool = False
    amp_dtype: str = "bf16"
    log_steps: int = 100
    #: checkpoint each encoder layer (recompute its activations in the backward)
    gradient_checkpointing: bool = False
    #: global-norm gradient clip
    gradient_clip_val: Optional[float] = None
    #: two-stage fine-tuning: freeze the backbone for the first N epochs, then
    #: unfreeze at ``second_stage_lr`` (default 0.1 * lr)
    freeze_backbone_epochs: int = 0
    second_stage_lr: Optional[float] = None
    second_stage_warmup_steps: Optional[int] = None
    skip_validation: bool = False
    warmup_epochs: int = 0
    scheduler_type: str = "none"

    def __post_init__(self) -> None:
        _at_least("train_epochs", self.train_epochs, 1)
        _at_least("lr", self.lr, 0.0, strict=True)
        _at_least("batch_size", self.batch_size, 1)
        _one_of("optimizer", self.optimizer, ("adamw", "adam", "adamw8bit"))
        _at_least("weight_decay", self.weight_decay, 0.0)
        _one_of("amp_dtype", self.amp_dtype, ("bf16", "fp16"))
        _at_least("log_steps", self.log_steps, 1)
        _at_least("freeze_backbone_epochs", self.freeze_backbone_epochs, 0)
        _at_least("warmup_epochs", self.warmup_epochs, 0)
        _one_of("scheduler_type", self.scheduler_type, ("none", "cosine", "linear", "step"))
        if self.adam_betas is not None:
            self.adam_betas = tuple(self.adam_betas)


@dataclass
class SchedulerConfig:
    """Learning-rate schedule selector (≈ ``avex_tpu.configs.SchedulerConfig``)."""

    name: str = "none"
    warmup_steps: int = 0
    min_lr: float = 0.0

    def __post_init__(self) -> None:
        _one_of("name", self.name, ("cosine", "linear", "none"))
        _at_least("warmup_steps", self.warmup_steps, 0)
        _at_least("min_lr", self.min_lr, 0.0)


#: the single-device mesh layout; any other value names a parallel layout
#: that the port does not have (ROADMAP queue 1, item 14)
_SINGLE_DEVICE_MESH = {
    "data": (-1, 1), "model": (1,), "param_sharding": ("replicated",),
    "pipeline_microbatches": (0,), "sequence_parallel": (False,),
}


@dataclass
class RunConfig:
    """The fields of a training run that the port's trainer reads
    (≈ ``avex_tpu.configs.RunConfig``).

    ``loss_function`` takes the reference's aliases (``binary_cross_entropy``
    → ``bce``, ``contrastive`` → ``clip``). ``dataset_config`` is accepted and
    ignored: the trainer takes loaders, and the data pipeline is not ported
    (ROADMAP queue 1, item 12). ``mesh`` and ``augmentations`` are accepted
    and raise ``NotImplementedError`` when they ask for more than one device
    or an augmentation. ``clustering_eval`` takes a
    :class:`ClusteringEvalConfig` or its dict. ``device`` defaults to ``cuda``.
    """

    model_spec: Union[ModelSpec, Dict[str, Any]]
    training_params: Union[TrainingParams, Dict[str, Any]]
    output_dir: str
    dataset_config: Any = None
    label_type: str = "supervised"
    resume_from_checkpoint: Optional[str] = None
    #: epoch checkpoint cadence of the reference's run script (0 disables)
    checkpoint_freq: int = 1
    #: rolling mid-epoch ``step_checkpoint`` every N train steps (0 disables)
    checkpoint_every_steps: int = 0
    #: save a ``step_checkpoint`` and stop the epoch loop on SIGTERM
    save_on_preemption: bool = True
    mesh: Optional[Union[Mapping[str, Any], Any]] = None
    augmentations: List[Any] = field(default_factory=list)
    loss_function: str = "cross_entropy"
    multilabel: bool = False
    metrics: List[str] = field(default_factory=lambda: ["accuracy"])
    device: str = "cuda"
    seed: int = 42
    scheduler: Union[SchedulerConfig, Dict[str, Any]] = field(default_factory=SchedulerConfig)
    clustering_eval: Optional[Union["ClusteringEvalConfig", Dict[str, Any]]] = None
    run_name: Optional[str] = None

    def __post_init__(self) -> None:
        if isinstance(self.model_spec, dict):
            self.model_spec = ModelSpec(**self.model_spec)
        if isinstance(self.training_params, dict):
            self.training_params = TrainingParams(**self.training_params)
        if isinstance(self.scheduler, dict):
            self.scheduler = SchedulerConfig(**self.scheduler)
        _one_of("label_type", self.label_type, ("supervised", "text", "self_supervised"))
        self.loss_function = {"binary_cross_entropy": "bce", "contrastive": "clip"}.get(
            self.loss_function, self.loss_function
        )
        _one_of("loss_function", self.loss_function, ("cross_entropy", "bce", "focal", "clip"))
        # multilabel ⇒ bce/focal; clip loss ⇒ text labels (the JAX package's checks)
        if self.multilabel and self.loss_function not in ("bce", "focal"):
            raise ValueError("multilabel=True requires loss_function in {'bce','focal'}")
        if self.loss_function == "clip" and self.label_type != "text":
            raise ValueError("loss_function='clip' requires label_type='text'")
        if self.mesh is not None:
            for name, allowed in _SINGLE_DEVICE_MESH.items():
                value = self.mesh.get(name, allowed[0]) if isinstance(self.mesh, Mapping) else getattr(
                    self.mesh, name, allowed[0])
                if value not in allowed:
                    raise NotImplementedError(
                        f"mesh.{name}={value!r}: the port trains on one device; meshes, FSDP, "
                        f"pipeline and sequence parallelism are ROADMAP queue 1, item 14"
                    )
        if self.augmentations:
            raise NotImplementedError("augmentations belong to the data pipeline, which is not "
                                      "ported (ROADMAP queue 1, item 12)")
        if isinstance(self.clustering_eval, Mapping):
            self.clustering_eval = ClusteringEvalConfig(**self.clustering_eval)

    def replace(self, **changes: Any) -> "RunConfig":
        """A copy with ``changes`` applied (≈ pydantic ``model_copy(update=...)``)."""
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Probes and clustering evaluation
# ---------------------------------------------------------------------------


@dataclass
class ProbeConfig:
    """Configuration of a transfer-learning probe head (≈ ``avex_tpu.configs.ProbeConfig``)."""

    probe_type: str = "linear"
    aggregation: str = "mean"
    input_processing: str = "flatten"
    target_layers: List[Union[str, int]] = field(default_factory=lambda: ["last_layer"])
    freeze_backbone: bool = True
    # MLP
    hidden_dims: Optional[List[int]] = None
    dropout_rate: float = 0.1
    activation: str = "relu"
    # attention / transformer
    num_heads: Optional[int] = None
    attention_dim: Optional[int] = None
    num_layers: Optional[int] = None
    # LSTM
    lstm_hidden_size: Optional[int] = None
    bidirectional: bool = False
    # MoE (routed MLP head over ``ops/moe.py``)
    num_experts: Optional[int] = None
    moe_hidden_dim: Optional[int] = None
    moe_k: Optional[int] = None
    capacity_factor: Optional[float] = None
    # sequence handling
    max_sequence_length: Optional[int] = None
    use_positional_encoding: bool = False
    target_length: Optional[int] = None
    online_training: Optional[bool] = None
    extra_config: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        _one_of("probe_type", self.probe_type, ("linear", "mlp", "lstm", "attention", "transformer", "moe"))
        _one_of("aggregation", self.aggregation, ("mean", "max", "cls_token", "none"))
        _one_of("input_processing", self.input_processing, ("flatten", "sequence", "pooled", "none"))
        _one_of("activation", self.activation, ("relu", "gelu", "tanh", "swish"))
        if not 0.0 <= self.dropout_rate <= 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1], got {self.dropout_rate!r}")
        self.target_layers = list(self.target_layers)
        if any(isinstance(layer, bool) for layer in self.target_layers):
            raise ValueError("target_layers entries must be str or int, not bool")

    def replace(self, **changes: Any) -> "ProbeConfig":
        """A copy with ``changes`` applied (≈ pydantic ``model_copy(update=...)``)."""
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


#: named probe presets (≈ ``avex_tpu.configs.PROBE_CONFIGS``); copy before editing
PROBE_CONFIGS: Dict[str, ProbeConfig] = {
    "linear": ProbeConfig(probe_type="linear", aggregation="mean", input_processing="flatten"),
    "mlp": ProbeConfig(probe_type="mlp", aggregation="mean", input_processing="flatten", hidden_dims=[512, 256]),
    "lstm": ProbeConfig(probe_type="lstm", aggregation="none", input_processing="sequence",
                        lstm_hidden_size=256, num_layers=1),
    "attention": ProbeConfig(probe_type="attention", aggregation="none", input_processing="sequence",
                             num_heads=8, num_layers=2),
    "transformer": ProbeConfig(probe_type="transformer", aggregation="none", input_processing="sequence",
                               num_heads=8, num_layers=2, use_positional_encoding=True),
}


@dataclass
class ClusteringEvalConfig:
    """During-training clustering evaluation (≈ ``avex_tpu.configs.ClusteringEvalConfig``)."""

    enabled: bool = False
    frequency: int = 5
    layers: str = "last_layer"
    use_validation_set: bool = True
    max_samples: Optional[int] = None
    run_before_training: bool = False

    def __post_init__(self) -> None:
        _at_least("frequency", self.frequency, 1)
        if self.max_samples is not None:
            _at_least("max_samples", self.max_samples, 100)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)
