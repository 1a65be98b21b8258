"""avex_tpu_torch: the PyTorch/CUDA port of avex-tpu, for one NVIDIA H100.

A second package beside ``avex_tpu`` (the JAX reference, which it never
imports). It covers BEATs, EAT and AVES embedding extraction: the registry,
``load_model``, layer-wise ``extract_embeddings``, and the attention kernels
in CUDA C++ (``avex_tpu_torch.ops.attention_kernels``: gated-bias for
BEATs, bias-free for EAT and AVES). ``avex_tpu_torch.training`` fine-tunes
them, ``avex_tpu_torch.probes`` and ``avex_tpu_torch.evaluation`` train probes
on them and evaluate their embeddings, ``avex_tpu_torch.serving`` serves
them. Models run on ``cuda`` unless built with ``device="cpu"``.
"""

from avex_tpu_torch.configs import AudioConfig, ModelSpec
from avex_tpu_torch.models.factory import build_model, build_model_from_spec
from avex_tpu_torch.models.load import load_label_mapping, load_model
from avex_tpu_torch.models.registry import (
    describe_model,
    get_checkpoint_path,
    get_model_class,
    get_model_spec,
    list_model_classes,
    list_model_layers,
    list_models,
    register_model,
    register_model_class,
)

__version__ = "0.1.0"

__all__ = [
    "AudioConfig",
    "ModelSpec",
    # Model loading
    "load_model",
    # Registry management
    "register_model",
    "get_model_spec",
    "list_models",
    "describe_model",
    "list_model_layers",
    # Model class management
    "register_model_class",
    "get_model_class",
    "list_model_classes",
    # Model factory
    "build_model",
    "build_model_from_spec",
    # Checkpoint management
    "get_checkpoint_path",
    # Label mapping management
    "load_label_mapping",
]
