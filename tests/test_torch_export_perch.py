"""The port's export of the JAX export matrix's Perch B1 against JAX, held as
``tests/test_torch_export_cnn.py`` holds EfficientNet-B0: the program at
B=1 and B=3 against the eager port at atol 1e-6 and against JAX at the
matrix's rtol/atol 1e-4, on JAX's variables drawn in numpy and carried to
the port with ``efficientnet.params_from_jax``.
"""

import functools

import pytest

from avex_tpu.configs import ModelSpec as JaxModelSpec

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models import efficientnet as eff
from tests.test_torch_export import MATRIX_TOL, RAW, check_program
from tests.test_torch_export_cnn import _build_jax_cnn
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)


def _perch_pair():
    spec = dict(name="perch", pretrained=False, audio_config={"sample_rate": 32000, **RAW})
    jax_model = _build_jax_cnn(JaxModelSpec(**spec))
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(**spec), device="cpu")
    port.load_port_state_dict(eff.params_from_jax(jax_model.variables, "b1"), strict=True)
    return jax_model, port


# (name, pair, clip seconds, samples, tolerance against JAX)
MATRIX = {
    "perch_b1": (_perch_pair, 5.0, 160000, MATRIX_TOL),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    jax_model, port = MATRIX[name][0]()
    return jax_model, port.eval()


@pytest.mark.parametrize("mode", ["embed", "logits"])
@pytest.mark.parametrize("name", list(MATRIX))
def test_program_matches_the_eager_port_and_jax(name, mode, tmp_path):
    check_program(MATRIX[name], _pair(name), name, mode, tmp_path)
