"""Configuration of the port, as dataclasses.

Counterparts of ``avex_tpu.configs``: ``AudioConfig`` with the JAX package's
fields, ``ModelSpec`` with the JAX package's fields, ``TrainingParams``,
``SchedulerConfig``, the augmentations (``NoiseAugment``, ``MixupAugment``),
the dataset configs (``DatasetConfig``, ``DatasetCollectionConfig``,
``EvaluationSet``, ``BenchmarkEvaluationConfig``), ``MeshConfig``, ``RunConfig``,
``ProbeConfig`` (with the ``PROBE_CONFIGS`` presets),
``ClusteringEvalConfig``, and the evaluation configs (``ExperimentConfig``,
``OfflineEmbeddingsConfig``, ``EvaluateConfig``).

Unknown fields raise ``TypeError`` as the dataclass constructor does; the
value checks of the JAX package's pydantic models raise ``ValueError``. What
pydantic did by itself is done here by hand:

- nested configs are given as instances or dicts (``from_dict`` applies the
  reference spellings that the JAX package's ``mode="before"`` validators
  accept, then the constructor);
- ``DatasetConfig`` keeps unknown keys (pydantic's ``extra="allow"``) in
  ``extra``, readable as attributes;
- an augmentation dict is told apart by its ``kind`` (the discriminated
  union), or by its single key (``- noise: {...}``);
- ``to_dict()`` gives JSON types (``model_dump(mode="json")``).

``RunConfig.from_sources`` and ``EvaluateConfig.from_sources`` read a YAML
file and ``key=value`` patches; PyYAML is imported inside the functions that
read YAML, never at import.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

__all__ = [
    "PROBE_CONFIGS",
    "AudioConfig",
    "BenchmarkEvaluationConfig",
    "ClusteringEvalConfig",
    "DatasetCollectionConfig",
    "DatasetConfig",
    "EvaluateConfig",
    "EvaluationSet",
    "ExperimentConfig",
    "MeshConfig",
    "MixupAugment",
    "ModelSpec",
    "NoiseAugment",
    "OfflineEmbeddingsConfig",
    "ProbeConfig",
    "RunConfig",
    "SchedulerConfig",
    "TrainingParams",
    "deep_update",
]

_REPRESENTATIONS = ("spectrogram", "mel_spectrogram", "raw")
_COMPUTE_DTYPES = ("float32", "bfloat16")


def _to_json(value: Any) -> Any:
    """A config value in JSON types (≈ pydantic ``model_dump(mode="json")``)."""
    if isinstance(value, _Config):
        return value.to_dict()
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _to_json(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, Mapping):
        return {str(k): _to_json(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_to_json(v) for v in value]
    return value


def _load_yaml(path: Union[str, Path]) -> Dict[str, Any]:
    """A YAML file (local or remote) as a dict; PyYAML is imported here."""
    import yaml

    from avex_tpu_torch.io import read_text

    return yaml.safe_load(read_text(str(path))) or {}


class _Config:
    """What the configs read from files share: ``from_dict`` (the reference
    spellings of ``_compat``, then the constructor), ``coerce`` and ``to_dict``."""

    @classmethod
    def _compat(cls, data: Dict[str, Any]) -> Dict[str, Any]:
        return data

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]):
        return cls(**cls._compat(dict(data)))

    @classmethod
    def coerce(cls, value: Any):
        """``value`` if it is an instance already, else ``from_dict(value)``."""
        return value if isinstance(value, cls) else cls.from_dict(value)

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: _to_json(getattr(self, f.name)) for f in dataclasses.fields(self)}


# ---------------------------------------------------------------------------
# YAML + CLI source merging (≈ avex_tpu/configs.py:462-540)
# ---------------------------------------------------------------------------


def _resolve_nested_config_paths(data: Dict[str, Any], base_dir: Path) -> None:
    """Resolve nested-config path strings against the referencing file's
    directory when they do not exist from the working directory, so that a
    config tree is relocatable."""
    keys = ("dataset_config", "run_config", "probe_config")

    def fix(d: Dict[str, Any]) -> None:
        for key in keys:
            value = d.get(key)
            if isinstance(value, str) and not Path(value).exists():
                candidate = base_dir / value
                if candidate.exists():
                    d[key] = str(candidate)
        for exp in d.get("experiments") or []:
            if isinstance(exp, dict):
                fix(exp)

    if isinstance(data, dict):
        fix(data)


def deep_update(base: Dict[str, Any], patch: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``patch`` into ``base`` (patch wins); returns a new dict."""
    out = copy.deepcopy(base)
    for key, value in patch.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = deep_update(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _parse_cli_value(raw: str) -> Any:
    """Parse a ``key=value`` CLI value with YAML semantics (numbers, bools, lists)."""
    import yaml

    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def _patch_to_nested(key: str, value: Any) -> Dict[str, Any]:
    """Expand a dotted key like ``training_params.lr`` into a nested dict."""
    parts = key.split(".")
    node: Dict[str, Any] = {parts[-1]: value}
    for part in reversed(parts[:-1]):
        node = {part: node}
    return node


class _CLIConfig(_Config):
    """A config loadable from a YAML file plus ``key=value`` CLI patches
    (≈ ``BaseCLIConfig.from_sources``): the file first, then each patch
    deep-merged on top (the patch wins); dotted keys address nested fields.
    Without PyYAML, build the config from a dict with ``from_dict``."""

    @classmethod
    def from_sources(cls, yaml_path: Optional[Union[str, Path]] = None,
                     cli_patches: Optional[List[str]] = None):
        data: Dict[str, Any] = {}
        if yaml_path is not None:
            data = _load_yaml(yaml_path)
            _resolve_nested_config_paths(data, Path(str(yaml_path)).parent)
        for patch in cli_patches or []:
            if "=" not in patch:
                raise ValueError(f"CLI patch must be key=value, got: {patch!r}")
            key, _, raw = patch.partition("=")
            data = deep_update(data, _patch_to_nested(key.strip(), _parse_cli_value(raw)))
        return cls.from_dict(data)


@dataclass
class AudioConfig:
    """How raw audio becomes the model input (≈ ``avex_tpu.configs.AudioConfig``)."""

    sample_rate: int = 16000
    n_fft: int = 2048
    hop_length: Optional[int] = None
    win_length: Optional[int] = None
    window: str = "hann"
    n_mels: int = 128
    representation: str = "mel_spectrogram"
    normalize: bool = True
    target_length_seconds: Optional[float] = None
    window_selection: str = "random"
    center: bool = True
    extra_config: Optional[Dict[str, Any]] = None

    def __post_init__(self) -> None:
        _lax_numbers(self)
        if self.representation not in _REPRESENTATIONS:
            raise ValueError(
                f"representation must be one of {_REPRESENTATIONS}, got {self.representation!r}"
            )
        if self.window_selection not in ("random", "center"):
            raise ValueError(f"window_selection must be 'random' or 'center', got "
                             f"{self.window_selection!r}")
        if self.window not in ("hann", "hamming"):
            raise ValueError(f"window must be 'hann' or 'hamming', got {self.window!r}")

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
    caller asks for the CPU. A reference config's ``device: tpu`` names the
    accelerator, which is ``cuda`` here.
    """

    name: str
    pretrained: bool = True
    device: str = "cuda"
    audio_config: Optional[Union[AudioConfig, Dict[str, Any]]] = None
    # CLIP/CLAP
    text_model_name: Optional[str] = None
    projection_dim: Optional[int] = None
    temperature: Optional[float] = None
    # EAT
    eat_cfg: Optional[Dict[str, Any]] = None
    pretraining_mode: Optional[bool] = None
    handle_padding: Optional[bool] = None
    fairseq_weights_path: Optional[str] = None
    eat_norm_mean: Optional[float] = None
    eat_norm_std: Optional[float] = None
    # EfficientNet
    efficientnet_variant: str = "b0"
    # BEATs
    use_naturelm: Optional[bool] = None
    fine_tuned: Optional[bool] = None
    init_config: Optional[Dict[str, Any]] = None
    # BirdNet
    language: Optional[str] = None
    # Bird-MAE / HF-hosted models: the variant is read from the id
    model_id: Optional[str] = None
    # free-form escape hatch (BirdNet's model and labels paths, for one)
    extra_config: Optional[Dict[str, Any]] = None
    # numeric policy of the backbone compute
    compute_dtype: str = "float32"

    def __post_init__(self) -> None:
        _lax_numbers(self)
        self.device = _accelerator(self.device)
        if isinstance(self.audio_config, dict):
            self.audio_config = AudioConfig(**self.audio_config)
        if self.compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(
                f"compute_dtype must be one of {_COMPUTE_DTYPES}, got {self.compute_dtype!r}"
            )
        _one_of("efficientnet_variant", self.efficientnet_variant, ("b0", "b1"))

    def replace(self, **changes: Any) -> "ModelSpec":
        """A copy with ``changes`` applied (≈ pydantic ``model_copy(update=...)``)."""
        return dataclasses.replace(self, **changes)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_NUMBER_TYPES = {"int": int, "float": float, "Optional[int]": int, "Optional[float]": float}


def _lax_numbers(config: Any) -> None:
    """Numbers given as strings become numbers, as pydantic's lax mode does
    (YAML reads ``3e-4``, without a dot, as a string)."""
    for f in dataclasses.fields(config):
        kind = _NUMBER_TYPES.get(str(f.type))
        value = getattr(config, f.name, None)
        if kind is not None and isinstance(value, str):
            setattr(config, f.name, kind(float(value)) if kind is int else float(value))


def _accelerator(device: str) -> str:
    """A reference config's ``tpu`` is the accelerator: ``cuda`` here."""
    return "cuda" if device == "tpu" else device


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
        _lax_numbers(self)
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
        _lax_numbers(self)
        _one_of("name", self.name, ("cosine", "linear", "none"))
        _at_least("warmup_steps", self.warmup_steps, 0)
        _at_least("min_lr", self.min_lr, 0.0)


@dataclass
class MeshConfig:
    """The device-mesh layout (≈ ``avex_tpu.configs.MeshConfig``): ``data``
    processes (``-1``: all of them, one device each) by ``model``.

    ``param_sharding`` is ``"replicated"`` (the DDP layout) or ``"fsdp"``
    (ZeRO-3: tensors of at least ``fsdp_min_size`` elements and their
    optimizer moments cut over the data axis, ``parallel/fsdp.py``). A
    ``model`` axis of more than one process runs tensor parallelism
    (``parallel/tensor.py``), or the model's layer stack as a GPipe pipeline
    of ``pipeline_microbatches`` microbatches (``parallel/pipeline.py``) or
    sequence-parallel (``sequence_parallel``, ``parallel/sequence.py``); the
    ``Trainer`` raises for the combinations JAX refuses.
    """

    data: int = -1
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")
    param_sharding: str = "replicated"
    fsdp_min_size: int = 2**16
    pipeline_microbatches: int = 0
    sequence_parallel: bool = False

    def __post_init__(self) -> None:
        _lax_numbers(self)
        self.axis_names = tuple(self.axis_names)
        _one_of("param_sharding", self.param_sharding, ("replicated", "fsdp"))
        _at_least("model", self.model, 1)
        _at_least("pipeline_microbatches", self.pipeline_microbatches, 0)


@dataclass
class RunConfig(_CLIConfig):
    """A training run (≈ ``avex_tpu.configs.RunConfig``).

    ``loss_function`` takes the reference's aliases (``binary_cross_entropy``
    → ``bce``, ``contrastive`` → ``clip``). ``dataset_config`` takes a
    :class:`DatasetCollectionConfig`, its dict or the path of its YAML file;
    ``augmentations`` takes :class:`NoiseAugment` / :class:`MixupAugment`
    instances or dicts (by ``kind`` or in the single-key form). ``mesh``
    takes a :class:`MeshConfig` or its dict. ``clustering_eval`` takes a
    :class:`ClusteringEvalConfig` or its dict. ``device`` places the run's
    model and batches: ``cuda`` by default, and a reference ``tpu`` means
    ``cuda``. ``data_pipeline="grain"`` builds the checkpointable
    ``GrainDataLoader`` (``data/grain_loader.py``). ``distributed`` has ``run_train`` join the run's
    process group (``parallel.init_multihost``, from SLURM's environment).
    """

    model_spec: Union[ModelSpec, Dict[str, Any]]
    training_params: Union[TrainingParams, Dict[str, Any]]
    output_dir: str
    dataset_config: Optional[Union["DatasetCollectionConfig", Dict[str, Any], str]] = None
    preprocessing: Optional[str] = None
    sr: int = 16000
    logging: str = "none"
    logging_uri: str = "http://127.0.0.1:5000/"
    label_type: str = "supervised"
    resume_from_checkpoint: Optional[str] = None
    #: epoch checkpoint cadence of the reference's run script (0 disables)
    checkpoint_freq: int = 1
    #: rolling mid-epoch ``step_checkpoint`` every N train steps (0 disables)
    checkpoint_every_steps: int = 0
    #: save a ``step_checkpoint`` and stop the epoch loop on SIGTERM
    save_on_preemption: bool = True
    distributed: bool = False
    mesh: Union[MeshConfig, Dict[str, Any]] = field(default_factory=MeshConfig)
    augmentations: List[Any] = field(default_factory=list)
    loss_function: str = "cross_entropy"
    multilabel: bool = False
    metrics: List[str] = field(default_factory=lambda: ["accuracy"])
    device: str = "cuda"
    seed: int = 42
    #: loader worker processes (0: the calling process loads)
    num_workers: int = 4
    data_pipeline: str = "native"
    run_name: Optional[str] = None
    wandb_project: str = "audio-experiments"
    scheduler: Union[SchedulerConfig, Dict[str, Any]] = field(default_factory=SchedulerConfig)
    clustering_eval: Optional[Union["ClusteringEvalConfig", Dict[str, Any]]] = None
    debug_mode: bool = False

    def __post_init__(self) -> None:
        _lax_numbers(self)
        if isinstance(self.model_spec, dict):
            self.model_spec = ModelSpec(**self.model_spec)
        if isinstance(self.training_params, dict):
            self.training_params = TrainingParams(**self.training_params)
        if isinstance(self.scheduler, dict):
            self.scheduler = SchedulerConfig(**self.scheduler)
        if isinstance(self.dataset_config, str):
            self.dataset_config = _load_yaml(self.dataset_config)
        if isinstance(self.dataset_config, Mapping):
            self.dataset_config = DatasetCollectionConfig.from_dict(self.dataset_config)
        self.device = _accelerator(self.device)
        _one_of("logging", self.logging, ("mlflow", "wandb", "none"))
        _one_of("data_pipeline", self.data_pipeline, ("native", "grain"))
        _at_least("num_workers", self.num_workers, 0)
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
        if isinstance(self.mesh, Mapping):
            self.mesh = MeshConfig(**self.mesh)
        self.augmentations = [_augment(a) for a in _flatten_augments(self.augmentations or [])]
        if isinstance(self.clustering_eval, Mapping):
            self.clustering_eval = ClusteringEvalConfig(**self.clustering_eval)

    def replace(self, **changes: Any) -> "RunConfig":
        """A copy with ``changes`` applied (≈ pydantic ``model_copy(update=...)``)."""
        return dataclasses.replace(self, **changes)


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
        _lax_numbers(self)
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
        _lax_numbers(self)
        _at_least("frequency", self.frequency, 1)
        if self.max_samples is not None:
            _at_least("max_samples", self.max_samples, 100)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Augmentations (≈ avex_tpu/configs.py:70-100)
# ---------------------------------------------------------------------------


def _probability(name: str, value: float) -> None:
    if not 0.0 <= value <= 1.0:
        raise ValueError(f"{name} must be in [0, 1], got {value!r}")


@dataclass
class NoiseAugment(_Config):
    """Additive noise from the ``.npy``/``.wav`` files of ``noise_dirs`` at an SNR drawn from ``snr_db_range``."""

    noise_dirs: List[str]
    snr_db_range: Tuple[float, float]
    augmentation_prob: float
    mask_signal_prob: float = 0.0
    kind: str = "noise"

    def __post_init__(self) -> None:
        _lax_numbers(self)
        _one_of("kind", self.kind, ("noise",))
        self.noise_dirs = list(self.noise_dirs)
        self.snr_db_range = tuple(float(x) for x in self.snr_db_range)
        if len(self.snr_db_range) != 2:
            raise ValueError(f"snr_db_range must be (low, high), got {self.snr_db_range!r}")
        _probability("augmentation_prob", self.augmentation_prob)
        _probability("mask_signal_prob", self.mask_signal_prob)


@dataclass
class MixupAugment(_Config):
    """Batch-level mixup: ``n_mixup`` Beta(alpha, alpha)-weighted combinations."""

    alpha: float
    augmentation_prob: float
    n_mixup: int = 1
    kind: str = "mixup"

    def __post_init__(self) -> None:
        _lax_numbers(self)
        _one_of("kind", self.kind, ("mixup",))
        _at_least("alpha", self.alpha, 0.0, strict=True)
        _at_least("n_mixup", self.n_mixup, 1)
        _probability("augmentation_prob", self.augmentation_prob)


_AUGMENTS = {"noise": NoiseAugment, "mixup": MixupAugment}


def _flatten_augments(raw: List[Any]) -> List[Any]:
    """The reference's single-key YAML form (``- noise: {...}``) as ``kind`` dicts."""
    out = []
    for item in raw:
        if isinstance(item, Mapping) and len(item) == 1 and "kind" not in item:
            kind, params = next(iter(item.items()))
            out.append(dict(params or {}, kind=kind))
        else:
            out.append(item)
    return out


def _augment(value: Any) -> Union[NoiseAugment, MixupAugment]:
    """One augmentation from an instance or a dict told apart by ``kind``."""
    if isinstance(value, (NoiseAugment, MixupAugment)):
        return value
    kind = value.get("kind")
    if kind not in _AUGMENTS:
        raise ValueError(f"augmentation kind must be one of {tuple(_AUGMENTS)}, got {kind!r}")
    return _AUGMENTS[kind](**value)


# ---------------------------------------------------------------------------
# Datasets (≈ avex_tpu/configs.py:288-455)
# ---------------------------------------------------------------------------


@dataclass(init=False)
class DatasetConfig(_Config):
    """One dataset source (``avex_tpu_torch.data``'s backends):

    - ``kind="hf"``: a HuggingFace ``datasets`` dataset (audio column);
    - ``kind="local"``: a directory of audio files and a metadata csv/jsonl;
    - ``kind="manifest"``: a JSONL/CSV manifest whose rows reference audio
      under ``data_root``;
    - ``kind="synthetic"``: deterministic synthetic audio.

    Unknown keys are kept in ``extra`` and read as attributes (pydantic's
    ``extra="allow"``). The reference's esp_data stanzas (``dataset_name`` and
    a ``split`` such as ``dogs_train``) are accepted: BEANS tasks map onto the
    HF presets, BirdSet splits onto theirs.
    """

    name: str
    kind: str = "local"
    path: Optional[str] = None
    data_root: Optional[str] = None
    subset: Optional[str] = None
    split: Optional[str] = None
    label_column: str = "label"
    audio_column: str = "audio"
    text_column: Optional[str] = None
    sample_rate: int = 16000
    audio_max_length_seconds: Optional[float] = None
    # synthetic backend knobs
    num_samples: int = 64
    num_classes: int = 4
    clip_seconds: float = 1.0
    seed: int = 0
    transformations: List[Dict[str, Any]] = field(default_factory=list)
    extra: Dict[str, Any] = field(default_factory=dict)

    def __init__(self, **data: Any) -> None:
        data = self._esp_data_style_compat(data)
        extra = dict(data.pop("extra", None) or {})
        known = {f.name: f for f in dataclasses.fields(self) if f.name != "extra"}
        if "name" not in data:
            raise TypeError("DatasetConfig needs a name")
        for name, f in known.items():
            if name in data:
                value = data.pop(name)
            elif f.default is not dataclasses.MISSING:
                value = f.default
            else:
                value = f.default_factory()
            setattr(self, name, value)
        extra.update(data)
        self.extra = extra
        _lax_numbers(self)
        _one_of("kind", self.kind, ("hf", "local", "manifest", "synthetic"))
        self.transformations = list(self.transformations)

    def __getattr__(self, name: str) -> Any:
        extra = self.__dict__.get("extra") or {}
        if name in extra:
            return extra[name]
        raise AttributeError(f"{type(self).__name__!r} has no attribute {name!r}")

    @staticmethod
    def _esp_data_style_compat(data: Dict[str, Any]) -> Dict[str, Any]:
        """The reference's esp_data stanzas: ``dataset_name`` + ``split``."""
        if "name" in data or "dataset_name" not in data:
            return data
        data = dict(data)
        dsname = str(data.pop("dataset_name"))
        split = str(data.get("split") or "")
        data["name"] = f"{dsname}_{split}" if split else dsname
        if dsname == "beans" and "_" in split:
            from avex_tpu_torch.data.beans import BEANS_TASKS

            task, _, part = split.rpartition("_")
            if task in BEANS_TASKS:
                data.setdefault("kind", "hf")
                data.setdefault("path", BEANS_TASKS[task][0])
                data["split"] = part
                data.setdefault("label_column", BEANS_TASKS[task][1])
        elif dsname == "birdset_train" and split:
            # the reference's legacy named splits resolve to manifests; an
            # unknown split raises LookupError
            from avex_tpu_torch.data.birdset import birdset_train_config

            preset = birdset_train_config(split, data_root=data.get("data_root"))
            for key, value in preset.to_dict().items():
                if key != "name" and value is not None:
                    data.setdefault(key, value)
            data["kind"] = preset.kind
            data["path"] = data.get("path") or preset.path
        elif dsname == "birdset" and "-" in split:
            # esp_data's 'POW-train' → the HF preset (task subset + split)
            from avex_tpu_torch.data.birdset import BIRDSET_TASKS, birdset_config

            task, _, part = split.partition("-")
            if task.upper() in BIRDSET_TASKS:
                preset = birdset_config(task, part)
                for key, value in preset.to_dict().items():
                    if key != "name" and value is not None:
                        data.setdefault(key, value)
                data["kind"] = preset.kind
                data["split"] = preset.split
                data["label_column"] = preset.label_column
        return data

    def to_dict(self) -> Dict[str, Any]:
        out = {f.name: _to_json(getattr(self, f.name)) for f in dataclasses.fields(self) if f.name != "extra"}
        out.update(_to_json(self.extra))
        return out


@dataclass
class DatasetCollectionConfig(_Config):
    """Train/val/test dataset lists and the concat policy."""

    train_datasets: List[Union[DatasetConfig, Dict[str, Any]]] = field(default_factory=list)
    val_datasets: List[Union[DatasetConfig, Dict[str, Any]]] = field(default_factory=list)
    test_datasets: List[Union[DatasetConfig, Dict[str, Any]]] = field(default_factory=list)
    concat_policy: str = "hard"
    transformations: List[Dict[str, Any]] = field(default_factory=list)

    def __post_init__(self) -> None:
        _lax_numbers(self)
        for key in ("train_datasets", "val_datasets", "test_datasets"):
            setattr(self, key, [DatasetConfig.coerce(d) for d in getattr(self, key) or []])
        _one_of("concat_policy", self.concat_policy, ("hard", "overlap", "soft"))

    @classmethod
    def _compat(cls, data: Dict[str, Any]) -> Dict[str, Any]:
        """``concatenate_method`` → ``concat_policy``; the per-split
        ``concatenate_*`` flags are dropped (splits always concatenate)."""
        if "concatenate_method" in data and "concat_policy" not in data:
            data["concat_policy"] = data.pop("concatenate_method")
        for key in ("concatenate_train", "concatenate_val", "concatenate_test", "concatenate"):
            data.pop(key, None)
        return data


@dataclass
class EvaluationSet(_Config):
    """A named train/val/test triplet of the evaluation harness."""

    name: str
    train: Optional[Union[DatasetConfig, Dict[str, Any]]] = None
    val: Optional[Union[DatasetConfig, Dict[str, Any]]] = None
    test: Optional[Union[DatasetConfig, Dict[str, Any]]] = None
    metrics: List[str] = field(default_factory=lambda: ["accuracy"])
    retrieval_mode: str = "test_vs_test"
    multilabel: bool = False

    def __post_init__(self) -> None:
        _lax_numbers(self)
        for key in ("train", "val", "test"):
            value = getattr(self, key)
            if value is not None:
                setattr(self, key, DatasetConfig.coerce(value))
        _one_of("retrieval_mode", self.retrieval_mode, ("test_vs_test", "train_vs_test"))

    @classmethod
    def _compat(cls, data: Dict[str, Any]) -> Dict[str, Any]:
        """``validation`` → ``val``; a stanza's ``multi_label`` sets ``multilabel``."""
        if "validation" in data and "val" not in data:
            data["val"] = data.pop("validation")
        if "multilabel" not in data:
            for key in ("train", "val", "test"):
                stanza = data.get(key)
                if isinstance(stanza, Mapping) and stanza.get("multi_label"):
                    data["multilabel"] = True
                    break
        return data


@dataclass
class BenchmarkEvaluationConfig(_Config):
    """A benchmark: a list of evaluation sets (``benchmark_name`` → ``name``)."""

    name: str = "benchmark"
    evaluation_sets: List[Union[EvaluationSet, Dict[str, Any]]] = field(default_factory=list)

    def __post_init__(self) -> None:
        _lax_numbers(self)
        self.evaluation_sets = [EvaluationSet.coerce(e) for e in self.evaluation_sets]

    @classmethod
    def _compat(cls, data: Dict[str, Any]) -> Dict[str, Any]:
        if "benchmark_name" in data and "name" not in data:
            data["name"] = data.pop("benchmark_name")
        return data


# ---------------------------------------------------------------------------
# Evaluation (≈ avex_tpu/configs.py:695-800)
# ---------------------------------------------------------------------------


@dataclass
class ExperimentConfig(_Config):
    """One experiment of an :class:`EvaluateConfig`. ``run_config`` takes a
    :class:`RunConfig`, its dict or its YAML path. The legacy ``layers`` and
    ``frozen`` move into ``probe_config`` (``target_layers``,
    ``freeze_backbone``)."""

    run_name: str
    run_config: Union[RunConfig, Dict[str, Any], str]
    pretrained: bool = True
    layers: Optional[str] = None
    probe_config: Optional[Union[ProbeConfig, Dict[str, Any]]] = None
    checkpoint_path: Optional[str] = None
    frozen: Optional[bool] = None

    def __post_init__(self) -> None:
        _lax_numbers(self)
        if isinstance(self.run_config, str):
            self.run_config = _load_yaml(self.run_config)
        self.run_config = RunConfig.coerce(self.run_config)
        if isinstance(self.probe_config, Mapping):
            self.probe_config = ProbeConfig(**self.probe_config)
        if self.probe_config is None:
            self.probe_config = ProbeConfig()
        if self.layers is not None:
            self.probe_config.target_layers = [self.layers]
        if self.frozen is not None:
            self.probe_config.freeze_backbone = self.frozen


#: the reference's manual HDF5 streaming and chunking knobs: accepted and dropped
_DROPPED_EMBEDDING_KEYS = (
    "use_streaming_embeddings", "streaming_chunk_size", "hdf5_compression",
    "hdf5_compression_level", "auto_chunk_size", "max_chunk_size",
    "min_chunk_size", "batch_chunk_size", "cache_size_limit_gb",
    "probe_storage_aggregation",
)


@dataclass
class OfflineEmbeddingsConfig(_Config):
    """The embedding cache of offline probing (``overwrite_embeddings`` → ``overwrite``)."""

    enabled: bool = True
    save_dir: Optional[str] = None
    overwrite: bool = False
    memory_limit_gb: float = 8.0
    chunk_size: Optional[int] = None

    @classmethod
    def _compat(cls, data: Dict[str, Any]) -> Dict[str, Any]:
        if "overwrite_embeddings" in data and "overwrite" not in data:
            data["overwrite"] = data.pop("overwrite_embeddings")
        for key in _DROPPED_EMBEDDING_KEYS:
            data.pop(key, None)
        return data


def _default_eval_training() -> TrainingParams:
    return TrainingParams(train_epochs=10, lr=1e-3, batch_size=32)


@dataclass
class EvaluateConfig(_CLIConfig):
    """A benchmark evaluation: experiments × evaluation sets.

    ``dataset_config`` takes a :class:`BenchmarkEvaluationConfig`, its dict
    or its YAML path. ``device`` places the backbones and probes: ``cuda`` by
    default, and a reference ``tpu`` means ``cuda``.
    """

    experiments: List[Union[ExperimentConfig, Dict[str, Any]]]
    dataset_config: Union[BenchmarkEvaluationConfig, Dict[str, Any], str]
    save_dir: str
    training_params: Union[TrainingParams, Dict[str, Any]] = field(default_factory=_default_eval_training)
    device: str = "cuda"
    seed: int = 42
    num_workers: int = 0
    probe_num_workers: int = 0
    eval_modes: List[str] = field(default_factory=lambda: ["probe"])
    offline_embeddings: Union[OfflineEmbeddingsConfig, Dict[str, Any]] = field(
        default_factory=OfflineEmbeddingsConfig)
    results_csv_path: Optional[str] = None
    disable_tqdm: bool = False

    def __post_init__(self) -> None:
        _lax_numbers(self)
        self.experiments = [ExperimentConfig.coerce(e) for e in self.experiments]
        if isinstance(self.dataset_config, str):
            self.dataset_config = _load_yaml(self.dataset_config)
        self.dataset_config = BenchmarkEvaluationConfig.coerce(self.dataset_config)
        if isinstance(self.training_params, Mapping):
            self.training_params = TrainingParams(**self.training_params)
        self.offline_embeddings = OfflineEmbeddingsConfig.coerce(self.offline_embeddings)
        self.device = _accelerator(self.device)
        self.eval_modes = list(self.eval_modes)
        for mode in self.eval_modes:
            _one_of("eval_modes entry", mode, ("probe", "retrieval", "clustering"))
        _at_least("num_workers", self.num_workers, 0)
