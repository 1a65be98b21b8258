"""The residuals of the bf16 K6 held to the JAX package, on the CPU.

On the card the bf16 backward of ``fused_qkv_attention`` rebuilds P from the
row log-sum-exp its forward saved and takes Δ = rowsum(dO ∘ O) from the
forward's output (plus what its bf16 rounding dropped), where JAX's K6
(``_fused_qkv_bwd_kernel``) recomputes the softmax and takes
Δ = rowsum(P ∘ dP). The plain twins of that contract are
held here to JAX: the forward twin's log-sum-exp to ``jax.nn.logsumexp`` of
JAX's logits, and the residual backward twin to ``jax.grad`` through
``fused_qkv_attention`` (K6 in interpret mode) and to the port's own backward
twin. The kernels themselves are held to these twins by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.ops.pallas_attention import fused_qkv_attention as jax_fused

from avex_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

B, H, D = 2, 2, 64
E = H * D
# The tolerance tests/unittests/test_pallas_attention.py holds the JAX kernel to.
TOL = dict(atol=2e-5, rtol=1e-4)
# bf16: P, dS and the gradient rounded to bf16, Δ from the bf16 output.
BF16_REL_L2 = 5e-3
CASES = [(seq, padded) for seq in (31, 65, 130) for padded in (False, True)]


def _inputs(rng, seq, padded):
    qkv = rng.standard_normal((B, seq, 3 * E)).astype(np.float32)
    cot = rng.standard_normal((B, seq, E)).astype(np.float32)
    mask = None
    if padded:
        mask = np.zeros((B, seq), bool)
        mask[1, seq // 2:] = True
    return qkv, cot, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.fixture(autouse=True)
def fp32_products():
    """The precision the fp32 twins and JAX's HIGHEST products assume, pinned
    for each test and asserted: torch's fp32 matmuls in full fp32 (no TF32
    or bf16 passes through oneDNN on the CPU, whatever an earlier caller or
    the environment set) and JAX's default matmul precision the highest."""
    saved = torch.get_float32_matmul_precision(), torch.backends.mkldnn.matmul.fp32_precision
    torch.set_float32_matmul_precision("highest")
    torch.backends.mkldnn.matmul.fp32_precision = "ieee"
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.mkldnn.matmul.fp32_precision == "ieee"
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.mkldnn.matmul.fp32_precision = saved[1]


def _lse64(qkv, mask):
    """The row log-sum-exp of the fp32 logits, in float64."""
    seq = qkv.shape[1]
    q, k = (qkv[..., i * E:(i + 1) * E].astype(np.float64).reshape(B, seq, H, D).transpose(0, 2, 1, 3)
            for i in (0, 1))
    logits = np.einsum("bhqd,bhkd->bhqk", q, k) * D**-0.5
    if mask is not None:
        logits = np.where(mask[:, None, None, :], -np.inf, logits)
    top = logits.max(-1, keepdims=True)
    return top[..., 0] + np.log(np.exp(logits - top).sum(-1))


def _jax_logits(qkv, mask):
    """JAX's K6 logits: fp32 ``q·kᵀ·scale`` plus the −inf padding bias."""
    seq = qkv.shape[1]
    q, k = (jnp.asarray(qkv[..., i * E:(i + 1) * E]).reshape(B, seq, H, D).transpose(0, 2, 1, 3) for i in (0, 1))
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision=jax.lax.Precision.HIGHEST) * D**-0.5
    if mask is not None:
        logits = logits + jnp.where(jnp.asarray(mask), -jnp.inf, 0.0)[:, None, None, :]
    return logits


def _jax_grad(qkv, cot, mask):
    """``jax.grad`` through JAX's ``fused_qkv_attention`` (K6 in interpret
    mode) for the output cotangent ``cot``, in qkv's type."""
    def loss(x):
        return jnp.sum(jax_fused(x, H, _j(mask), interpret=True).astype(jnp.float32) * cot.astype(jnp.float32))

    return jax.grad(loss)(qkv)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("seq,padded", CASES)
def test_forward_lse_twin_matches_jax_logsumexp(rng, seq, padded):
    qkv, _, mask = _inputs(rng, seq, padded)
    out, lse, rest = ak._fused_qkv_forward_lse_reference(_t(qkv), H, _t(mask))
    want = jax.nn.logsumexp(_jax_logits(qkv, mask), axis=-1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, seq)
    # each side against float64 first, so that a drift names the side it is on
    exact = _lse64(qkv, mask)
    np.testing.assert_allclose(lse.numpy(), exact, atol=1e-5, rtol=0, err_msg="port vs float64")
    np.testing.assert_allclose(np.asarray(want), exact, atol=1e-5, rtol=0, err_msg="JAX vs float64")
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out.numpy(), ak.fused_qkv_reference(_t(qkv), H, _t(mask)).numpy())
    assert not rest.any()  # fp32: the output is not rounded
    out16, _, rest16 = ak._fused_qkv_forward_lse_reference(_t(qkv).bfloat16(), H, _t(mask))
    assert rest16.dtype == torch.bfloat16 and rest16.any()
    assert bool((rest16.float().abs() <= out16.float().abs() * 2.0**-8).all())


@pytest.mark.parametrize("seq,padded", CASES)
def test_residual_backward_twin_matches_jax_grad_fp32(rng, seq, padded):
    qkv, cot, mask = _inputs(rng, seq, padded)
    want = _jax_grad(jnp.asarray(qkv), jnp.asarray(cot), mask)
    out, lse, rest = ak._fused_qkv_forward_lse_reference(_t(qkv), H, _t(mask))
    got, _, _ = ak.fused_qkv_backward_from_residuals_reference(_t(qkv), out, lse, _t(mask), _t(cot), out_rest=rest)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rounded_out", [False, True], ids=["out+rest", "out"])
@pytest.mark.parametrize("seq,padded", CASES)
def test_residual_backward_twin_matches_jax_grad_bf16(rng, seq, padded, rounded_out):
    """bf16 qkv and cotangent; the residuals from the bf16 forward twin. Δ
    from the output and its rounding rest, as the kernel takes it, and from
    the bf16 output alone."""
    qkv, cot, mask = _inputs(rng, seq, padded)
    qkv16, cot16 = jnp.asarray(qkv).astype(jnp.bfloat16), jnp.asarray(cot).astype(jnp.bfloat16)
    want = _jax_grad(qkv16, cot16, mask)
    tq, tc = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in (qkv16, cot16))
    out, lse, rest = ak._fused_qkv_forward_lse_reference(tq, H, _t(mask))
    got, _, _ = ak.fused_qkv_backward_from_residuals_reference(tq, out, lse, _t(mask), tc,
                                                               out_rest=None if rounded_out else rest)
    assert out.dtype == rest.dtype == got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(got.float().numpy(), want) <= BF16_REL_L2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("seq,padded", CASES)
def test_residual_backward_twin_matches_backward_twin(rng, seq, padded, dtype):
    qkv, cot, mask = (None if x is None else _t(x) for x in _inputs(rng, seq, padded))
    qkv, cot = qkv.to(dtype), cot.to(dtype)
    out, lse, rest = ak._fused_qkv_forward_lse_reference(qkv, H, mask)
    got, _, _ = ak.fused_qkv_backward_from_residuals_reference(qkv, out, lse, mask, cot, out_rest=rest)
    want = ak.fused_qkv_backward_reference(qkv, H, mask, cot)
    assert got.dtype == want.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _rel(got.float().numpy(), want.float().numpy()) <= BF16_REL_L2


# Head width 80 (Bird-MAE large and huge): 8 heads of 80, the residual twin
# against jax.grad through JAX's fused route (one 640-lane group).
H80, E80 = 8, 640
DH80_CASES = [(seq, padded) for seq in (37, 129) for padded in (False, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("seq,padded", DH80_CASES)
def test_dh80_residual_backward_twin_matches_jax_grad(rng, seq, padded, dtype):
    qkv = rng.standard_normal((B, seq, 3 * E80)).astype(np.float32)
    cot = rng.standard_normal((B, seq, E80)).astype(np.float32)
    mask = None
    if padded:
        mask = np.zeros((B, seq), bool)
        mask[1, seq // 3:] = True
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, jc = jnp.asarray(qkv).astype(jdt), jnp.asarray(cot).astype(jdt)

    def loss(x):
        return jnp.sum(jax_fused(x, H80, _j(mask), interpret=True).astype(jnp.float32) * jc.astype(jnp.float32))

    want = jax.grad(loss)(jq)
    tq, tc = (torch.from_numpy(np.asarray(x, np.float32)).to(dtype) for x in (jq, jc))
    out, lse, rest = ak._fused_qkv_forward_lse_reference(tq, H80, _t(mask))
    assert lse.shape == (B, H80, seq)
    got, _, _ = ak.fused_qkv_backward_from_residuals_reference(tq, out, lse, _t(mask), tc, out_rest=rest)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    else:
        assert _rel(got.float().numpy(), want) <= BF16_REL_L2


def test_residual_twins_give_nan_where_the_softmax_does(rng):
    """An item whose keys are all padded: the log-sum-exp is −inf, and the
    residual backward is NaN exactly where the backward twin is."""
    qkv, cot, _ = _inputs(rng, 31, False)
    mask = np.zeros((B, 31), bool)
    mask[0] = True
    mask[1, 20:] = True
    out, lse, rest = ak._fused_qkv_forward_lse_reference(_t(qkv), H, _t(mask))
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1]).all()
    got, _, _ = ak.fused_qkv_backward_from_residuals_reference(_t(qkv), out, lse, _t(mask), _t(cot), out_rest=rest)
    want = ak.fused_qkv_backward_reference(_t(qkv), H, _t(mask), _t(cot))
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(want[0]).all()
    torch.testing.assert_close(got[1], want[1], **TOL)
