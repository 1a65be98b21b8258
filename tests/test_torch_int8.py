"""The port's int8 twins and quant module against the JAX package, on the CPU.

The same numpy-seeded inputs go through ``avex_tpu.ops.pallas_int8`` (its
Pallas kernels in interpret mode) and ``avex_tpu.quant`` on one side, and
through ``avex_tpu_torch.ops.int8_kernels`` (CPU tensors take the plain twins)
and ``avex_tpu_torch.quant`` on the other. The JAX package's kernels take the
weight as ``[K, N]``; the port's dense takes torch's Linear layout ``[N, K]``.
"""

import sys
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from avex_tpu.ops.pallas_int8 import int8_dynamic_dense as jax_dynamic_dense
from avex_tpu.ops.pallas_int8 import int8_matmul as jax_int8_matmul
from avex_tpu.quant import Int8Dense
from avex_tpu.quant import dynamic_int8_matmul as jax_dynamic_int8_matmul
from avex_tpu.quant import int8_error_report as jax_error_report
from avex_tpu.quant import quantize_kernel as jax_quantize_kernel
from avex_tpu.quant import quantize_params as jax_quantize_params

from avex_tpu_torch.ops import int8_kernels as ik
from avex_tpu_torch.quant import (
    QUANT_FIELDS,
    Int8Linear,
    dense_path_matcher,
    dynamic_int8_matmul,
    int8_error_report,
    quantize_kernel,
    quantize_params,
)
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def np_rng():
    return np.random.default_rng(0)


def _quant_level_tolerance(x, w_scale):
    """Output-space bound for a one-level flip of an activation's rounding
    (``tests/unittests/test_pallas_int8.py:49-56``): the output element moves
    by at most ``row_scale * 127 * col_scale``."""
    xf = np.abs(np.asarray(x, np.float32))
    row_scale = xf.max(axis=-1, keepdims=True) / 127.0
    return row_scale * 127.0 * np.asarray(w_scale, np.float32)[None, :]


def _port_weight(wq_kn, scale):
    """JAX's ``[K, N]`` int8 kernel and scales → the port's ``[N, K]`` tensors."""
    return torch.from_numpy(np.array(np.asarray(wq_kn).T)), torch.from_numpy(np.array(scale))


@pytest.mark.parametrize("m, k, n, block_m", [(96, 256, 256, 32), (50, 128, 128, 32), (7, 64, 384, 8)],
                         ids=["aligned", "ragged_m", "small_m"])
def test_int8_matmul_reference_matches_jax(np_rng, m, k, n, block_m):
    """The K8 twin is exact, as JAX's kernel is; ragged M included."""
    xq = np_rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = np_rng.integers(-127, 128, (k, n)).astype(np.int8)
    want = np.asarray(jax_int8_matmul(jnp.asarray(xq), jnp.asarray(wq), block_m=block_m, block_n=128,
                                      interpret=True))
    got = ik.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))  # a CPU tensor: the twin
    assert got.dtype == torch.int32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), xq.astype(np.int32) @ wq.astype(np.int32))


def _dynamic_case(np_rng, shape, dtype, use_bias):
    """(x as JAX and torch see it, JAX kernel and scales, port weight, bias pair)."""
    x = np_rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[5] = 0.0  # an all-zero row
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TORCH_DTYPES[dtype])
    w = np_rng.standard_normal((shape[-1], 96)).astype(np.float32)
    wq, ws = jax_quantize_kernel(jnp.asarray(w))
    b = np_rng.standard_normal(96).astype(np.float32) if use_bias else None
    jb = jnp.asarray(b) if use_bias else None
    tb = torch.from_numpy(b) if use_bias else None
    return jx, tx, (wq, ws), _port_weight(wq, ws), (jb, tb)


def _assert_within_one_level(got, want, x, w_scale):
    got = np.asarray(got, np.float32).reshape(-1, want.shape[-1])
    want = np.asarray(want, np.float32).reshape(-1, want.shape[-1])
    tol = _quant_level_tolerance(np.asarray(x, np.float32).reshape(got.shape[0], -1), w_scale)
    assert np.all(np.abs(got - want) <= tol + 1e-5)
    assert np.linalg.norm(got - want) / (np.linalg.norm(want) or 1.0) < 2e-3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("shape", [(64, 128), (3, 24, 128)], ids=["2d", "3d"])
def test_dynamic_dense_reference_matches_jax(np_rng, dtype, use_bias, shape):
    """The K7 twin (and ``quant.dynamic_int8_matmul``, the same function)
    against JAX's ``dynamic_int8_matmul`` and its Pallas kernel: within one
    activation quantization level plus 1e-5, rel L2 < 2e-3; zero rows give
    the bias."""
    jx, tx, (wq, ws), (twq, tws), (jb, tb) = _dynamic_case(np_rng, shape, dtype, use_bias)
    got = ik.int8_dynamic_dense(tx, twq, tws, tb, out_dtype=torch.float32)
    assert got.shape == (*shape[:-1], 96) and got.dtype == torch.float32
    assert torch.equal(dynamic_int8_matmul(tx, twq, tws, tb, out_dtype=torch.float32), got)
    want_quant = np.asarray(jax_dynamic_int8_matmul(jx, wq, ws, jb, out_dtype=jnp.float32))
    want_kernel = np.asarray(jax_dynamic_dense(jx, wq, ws, jb, block_m=32, block_n=96, out_dtype=jnp.float32,
                                               interpret=True))
    x = np.asarray(jx.astype(jnp.float32))
    for want in (want_quant, want_kernel):
        _assert_within_one_level(got.numpy(), want, x, ws)
    zero_row = got.reshape(-1, 96)[5].numpy()
    np.testing.assert_array_equal(zero_row, tb.numpy() if use_bias else np.zeros(96, np.float32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("m", [1, 130, 248])
def test_two_step_order_equals_dynamic_dense_twin(np_rng, dtype, use_bias, m):
    """K7 on CUDA is two kernels: the row quantization (``quantize_rows``,
    stored as int8 levels and one fp32 scale a row), then the int32 product
    and the epilogue (``scaled_product_reference``). Composed, they equal the
    one-step twin bit for bit, in bf16 and fp32, with and without the bias,
    at ragged M and with an all-zero row; the twin is held to JAX above."""
    k, n = 96, 136
    x = torch.from_numpy(np_rng.standard_normal((m, k)).astype(np.float32)).to(TORCH_DTYPES[dtype])
    x[m // 2] = 0.0
    wq = torch.from_numpy(np_rng.integers(-127, 128, (n, k), dtype=np.int8))
    ws = torch.from_numpy((np_rng.random(n) * 0.01 + 1e-3).astype(np.float32))
    bias = torch.from_numpy(np_rng.standard_normal(n).astype(np.float32)) if use_bias else None
    levels, row_scale = ik.quantize_rows(x)
    xq = levels.to(torch.int8)
    assert torch.equal(xq.float(), levels) and row_scale.shape == (m, 1)
    assert not xq[m // 2].any() and float(row_scale[m // 2]) == np.float32(1e-8) / np.float32(127.0)
    got = ik.scaled_product_reference(xq, row_scale[:, 0], wq, ws, bias, TORCH_DTYPES[dtype])
    want = ik.int8_dynamic_dense_reference(x, wq, ws, bias)
    assert got.dtype == want.dtype == TORCH_DTYPES[dtype]
    assert torch.equal(got, want)
    if not use_bias:
        assert not got[m // 2].any()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dynamic_dense_default_output_type_follows_x(np_rng, dtype):
    jx, tx, (wq, ws), (twq, tws), _ = _dynamic_case(np_rng, (16, 64), dtype, False)
    got = ik.int8_dynamic_dense(tx, twq, tws)
    want = jax_dynamic_int8_matmul(jx, wq, ws)
    assert got.dtype == TORCH_DTYPES[dtype] and want.dtype == getattr(jnp, dtype)
    tol = _quant_level_tolerance(np.asarray(jx.astype(jnp.float32)), ws)
    rounding = 2.0**-8 * np.abs(np.asarray(want, np.float32)) if dtype == "bfloat16" else 0.0
    assert np.all(np.abs(got.float().numpy() - np.asarray(want, np.float32)) <= tol + rounding + 1e-5)


def test_dynamic_dense_accuracy_vs_float(np_rng):
    x = np_rng.standard_normal((64, 256)).astype(np.float32)
    w = (np_rng.standard_normal((128, 256)) / 16.0).astype(np.float32)  # [N, K]
    q, scale = quantize_kernel(w)
    out = dynamic_int8_matmul(torch.from_numpy(x), q, scale).numpy()
    report = int8_error_report(x @ w.T, out)
    assert report["rel_l2"] < 0.02, report  # W8A8 on well-conditioned gaussians: < 2% L2


@pytest.mark.parametrize("shape", [(96, 48), (3, 16, 8)], ids=["2d", "stacked"])
def test_quantize_kernel_equals_jax(np_rng, shape):
    """Identical int8 and scales: fp32 absmax, IEEE divide, round half to even."""
    w = np_rng.standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0  # a zero output channel: the 1e-8 guard
    w[..., 5] *= 100.0
    jq, js = jax_quantize_kernel(jnp.asarray(w))
    q, scale = quantize_kernel(np.swapaxes(w, -1, -2))  # [..., N, K]
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(q.numpy(), -1, -2), np.asarray(jq))
    assert np.max(np.abs(scale.numpy() - np.asarray(js))) == 0.0


def test_int8_linear_consumes_jax_quantized_dense(np_rng):
    """``Int8Linear`` loads a JAX ``quantize_params`` tree (``Int8Dense``'s
    contract) and computes what ``Int8Dense`` computes."""
    dense = fnn.Dense(12)
    x = np_rng.standard_normal((5, 24)).astype(np.float32)
    variables = dense.init(jax.random.PRNGKey(0), jnp.asarray(x))
    f_out = np.asarray(dense.apply(variables, jnp.asarray(x)))
    qparams = jax_quantize_params(variables["params"], include=lambda path: True)
    q_out = np.asarray(Int8Dense(12).apply({"params": qparams}, jnp.asarray(x)))

    layer = Int8Linear(24, 12)
    weight_q, weight_scale = _port_weight(qparams["kernel_q"], qparams["kernel_scale"])
    layer.load_state_dict({"weight_q": weight_q, "weight_scale": weight_scale,
                           "bias": torch.from_numpy(np.array(qparams["bias"]))})
    got = layer(torch.from_numpy(x)).numpy()
    _assert_within_one_level(got, q_out, x, qparams["kernel_scale"])
    assert int8_error_report(f_out, got)["rel_l2"] < 0.02
    assert not list(layer.parameters())  # buffers only: no gradient path


def test_quantize_params_equals_jax(np_rng):
    """The module walk quantizes what JAX's pytree walk quantizes: identical
    int8 and scales, a float32 bias, the Linears the predicate refuses left
    float, and ``Int8Linear`` layers under the same names."""
    tree = {
        "enc": {"fc1": {"kernel": np_rng.standard_normal((8, 4)).astype(np.float32),
                        "bias": np_rng.standard_normal(4).astype(np.float32)}},
        "head": {"kernel": np_rng.standard_normal((8, 2)).astype(np.float32), "bias": np.zeros(2, np.float32)},
    }
    want = jax_quantize_params(tree, include=dense_path_matcher(["fc1"]))
    model = nn.ModuleDict({"enc": nn.ModuleDict({"fc1": nn.Linear(8, 4)}), "head": nn.Linear(8, 2)})
    with torch.no_grad():
        for layer, node in ((model["enc"]["fc1"], tree["enc"]["fc1"]), (model["head"], tree["head"])):
            layer.weight.copy_(torch.from_numpy(node["kernel"].T))
            layer.bias.copy_(torch.from_numpy(node["bias"]))
    assert quantize_params(model, include=dense_path_matcher(["fc1"]), dtype=torch.bfloat16) is model
    assert isinstance(model["enc"]["fc1"], Int8Linear) and type(model["head"]) is nn.Linear
    assert "kernel" in want["head"]
    state = model.state_dict()
    assert set(state) == {"enc.fc1.weight_q", "enc.fc1.weight_scale", "enc.fc1.bias", "head.weight", "head.bias"}
    assert QUANT_FIELDS == ("weight_q", "weight_scale")
    np.testing.assert_array_equal(state["enc.fc1.weight_q"].numpy().T, np.asarray(want["enc"]["fc1"]["kernel_q"]))
    np.testing.assert_array_equal(state["enc.fc1.weight_scale"].numpy(), np.asarray(want["enc"]["fc1"]["kernel_scale"]))
    np.testing.assert_array_equal(state["enc.fc1.bias"].numpy(), np.asarray(want["enc"]["fc1"]["bias"]))
    assert model["enc"]["fc1"](torch.randn(3, 8)).dtype == torch.bfloat16


def test_int8_error_report_matches_jax(np_rng):
    fp = np_rng.standard_normal((4, 8))
    q = fp + 1e-2 * np_rng.standard_normal((4, 8))
    want = jax_error_report(fp, q)
    got = int8_error_report(fp, torch.from_numpy(q))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12)


def test_launch_counts_lose_no_update():
    """Served models launch from one batcher thread each: the counters take a
    lock (a short switch interval would expose a lost update)."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ik.reset_launch_counts()
        threads = [threading.Thread(target=lambda: [ik._count("int8_matmul") for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert ik.LAUNCHES == {"int8_dynamic_dense": 0, "int8_matmul": 16 * 2000}
    finally:
        sys.setswitchinterval(interval)
        ik.reset_launch_counts()
