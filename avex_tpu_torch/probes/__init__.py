"""Probe system: transfer-learning heads over frozen or fine-tuned backbones."""

from avex_tpu_torch.probes.base import Probe, ProbeNet, ProbePlan, make_probe_plan, params_from_jax
from avex_tpu_torch.probes.factory import (
    build_probe_from_config,
    get_probe_class,
    list_probe_classes,
    load_probe_config,
    register_probe_class,
)

__all__ = [
    "Probe",
    "ProbeNet",
    "ProbePlan",
    "build_probe_from_config",
    "get_probe_class",
    "list_probe_classes",
    "load_probe_config",
    "make_probe_plan",
    "params_from_jax",
    "register_probe_class",
]
