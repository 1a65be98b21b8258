"""The port's export of the JAX export matrix's EfficientNet-B0 against JAX
(the rest of ``tests/test_torch_export.py``'s matrix, held the same way:
the program at B=1 and B=3 against the eager port at atol 1e-6 and against
JAX at the matrix's rtol/atol 1e-4). Perch B1's row is in
``tests/test_torch_export_perch.py``, a file of its own so that each file
stays short on a test worker.

JAX's variables are drawn in numpy on its own tree (``jax.eval_shape`` of
its init, whose compile would take most of the file's time), with the
BatchNorm statistics moved off 0/1, and carried to the port with
``efficientnet.params_from_jax``.
"""

import functools
from unittest import mock

import numpy as np
import pytest

import jax

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.models.base import ModelBase as JaxModelBase

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models import efficientnet as eff
from tests.test_torch_efficientnet import EFFNET_AUDIO, _moved_stats
from tests.test_torch_export import MATRIX_TOL, check_program
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)


def _drawn_variables(self, *dummy_args, seed=0):
    """JAX's variable tree drawn in numpy in place of its jitted init (whose
    compile takes most of a CNN's build): kernels N(0, 1/fan_in), biases 0,
    scales 1; ``_moved_stats`` moves the BatchNorm statistics after."""
    shapes = jax.eval_shape(self.module.init, jax.random.PRNGKey(seed), *dummy_args)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name or name.endswith("['var']"):
            return np.ones(leaf.shape, np.float32)
        if len(leaf.shape) < 2:
            return np.zeros(leaf.shape, np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _build_jax_cnn(spec, **kwargs):
    with mock.patch.object(JaxModelBase, "_init_variables", _drawn_variables):
        model = avex_tpu.build_model_from_spec(spec, **kwargs)
    model.variables = _moved_stats(model.variables)
    return model


def _effnet_pair():
    spec = dict(name="efficientnet", pretrained=False, efficientnet_variant="b0", audio_config=EFFNET_AUDIO)
    jax_model = _build_jax_cnn(JaxModelSpec(**spec), num_classes=7)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(**spec), device="cpu", num_classes=7)
    port.load_port_state_dict(eff.params_from_jax(jax_model.variables, "b0"), strict=True)
    return jax_model, port


# (name, pair, clip seconds, samples, tolerance against JAX)
MATRIX = {
    "efficientnet_b0": (_effnet_pair, 1.0, 16000, MATRIX_TOL),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    jax_model, port = MATRIX[name][0]()
    return jax_model, port.eval()


@pytest.mark.parametrize("mode", ["embed", "logits"])
@pytest.mark.parametrize("name", list(MATRIX))
def test_program_matches_the_eager_port_and_jax(name, mode, tmp_path):
    check_program(MATRIX[name], _pair(name), name, mode, tmp_path)
