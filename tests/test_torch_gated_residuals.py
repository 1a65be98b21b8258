"""The residuals of the bf16 K3 held to the JAX package, on the CPU.

On the card the bf16 backward of ``fused_qkv_gated_attention`` rebuilds P
from the row log-sum-exp its forward (K2) saved and takes Δ = rowsum(dO ∘ O)
from the forward's output plus what its bf16 rounding dropped, where JAX's K3
(``_fused_qkv_gated_bwd_kernel``) recomputes the softmax and takes
Δ = rowsum(P ∘ dP); it also gives dbias = Σ_b gate ⊙ dL and
dgate = Σ_k bias·dL. The plain twins of that contract are held here to JAX:
the forward twin's log-sum-exp to ``jax.nn.logsumexp`` of JAX's gated
logits, and the residual backward twin to ``jax.grad`` through the JAX
package's ``_fused_qkv_gated_reference`` (in qkv, the bias and the gate) and
to the port's own backward twin. The kernels themselves are held to these
twins by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.ops.pallas_attention import _fused_qkv_gated_reference as jax_gated_reference

from avex_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_attention_residuals import fp32_products  # noqa: F401  (autouse: the pinned fp32 products)
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

B, H, D = 2, 2, 64
E = H * D
SCALE = D**-0.5
# The tolerance tests/unittests/test_pallas_attention.py holds the JAX kernel to.
TOL = dict(atol=2e-5, rtol=1e-4)
# bf16: P, dS and the gradient rounded to bf16, Δ from the bf16 output.
BF16_REL_L2 = 5e-3
# bf16 dgate = Σ_k bias·P∘(dP − Δ): Δ from the twin's output carries the
# bf16 rounding of the normalised P into the output, and enters dgate as
# δΔ·Σ_k bias·P, which does not cancel as it does in dqkv (above 5e-3 at T = 63
# to 250). The kernel rounds the unnormalised P, whose row maximum is exact,
# and its own residuals land nearer (tests/test_torch_cuda.py holds its dgate
# to the recomputing twin within BF16_REL_L2).
BF16_DGATE_REL_L2 = 1e-2
# T = 1, one ragged tile, BEATs' 248 (float2 bias rows) and 250 (even, not a
# multiple of 4); the gate or a bias alone; no mask or one on item 1.
CASES = [(seq, gated, padded) for seq in (1, 63, 248, 250) for gated in (True, False) for padded in (False, True)]


def _ids(case):
    seq, gated, padded = case
    return f"T{seq}-{'gate' if gated else 'bias_only'}-{'mask' if padded else 'nomask'}"


def _inputs(rng, seq, gated, padded):
    qkv = rng.standard_normal((B, seq, 3 * E)).astype(np.float32)
    cot = rng.standard_normal((B, seq, E)).astype(np.float32)
    bias = rng.standard_normal((H, seq, seq)).astype(np.float32)
    gate = (rng.random((B, H, seq)) * 2 + 1).astype(np.float32) if gated else None
    mask = None
    if padded:
        mask = np.zeros((B, seq), bool)
        mask[1, (seq + 1) // 2:] = True
    return qkv, cot, bias, gate, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _jax_logits(qkv, bias, gate, mask):
    """JAX's gated logits: fp32 ``q·kᵀ·scale + gate ⊙ bias`` with −inf at
    padded keys (``_attention_reference``)."""
    seq = qkv.shape[1]
    q, k = (jnp.asarray(qkv[..., i * E:(i + 1) * E]).reshape(B, seq, H, D).transpose(0, 2, 1, 3) for i in (0, 1))
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision=jax.lax.Precision.HIGHEST) * SCALE
    logits = logits + (jnp.asarray(bias)[None] if gate is None else jnp.asarray(gate)[..., None] * bias[None])
    if mask is not None:
        logits = jnp.where(jnp.asarray(mask)[:, None, None, :], -jnp.inf, logits)
    return logits


def _jax_grads(qkv, cot, bias, gate, mask):
    """``jax.grad`` of ``<_fused_qkv_gated_reference(...), cot>`` in qkv, the
    bias and (when there is one) the gate: ``(dqkv, dbias, dgate)``."""
    def loss(x, pb, g):
        out = jax_gated_reference(x, H, pb, g, _j(mask), SCALE)
        return jnp.sum(out.astype(jnp.float32) * cot.astype(jnp.float32))

    if gate is None:
        dqkv, dbias = jax.grad(lambda x, pb: loss(x, pb, None), argnums=(0, 1))(qkv, jnp.asarray(bias))
        return dqkv, dbias, None
    return jax.grad(loss, argnums=(0, 1, 2))(qkv, jnp.asarray(bias), jnp.asarray(gate))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gated_forward_lse_twin_matches_jax_logsumexp(rng, case):
    qkv, _, bias, gate, mask = _inputs(rng, *case)
    seq = case[0]
    out, lse, rest = ak._fused_qkv_forward_lse_reference(_t(qkv), H, _t(mask), SCALE, _t(bias), _t(gate))
    want = jax.nn.logsumexp(_jax_logits(qkv, bias, gate, mask), axis=-1)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, seq)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=1e-5, rtol=1e-6)
    twin = ak.fused_qkv_gated_reference(_t(qkv), H, _t(bias), _t(gate), _t(mask), SCALE)
    np.testing.assert_array_equal(out.numpy(), twin.numpy())
    assert not rest.any()  # fp32: the output is not rounded


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gated_residual_backward_twin_matches_jax_grad_fp32(rng, case):
    qkv, cot, bias, gate, mask = _inputs(rng, *case)
    want = _jax_grads(jnp.asarray(qkv), jnp.asarray(cot), bias, gate, mask)
    out, lse, rest = ak._fused_qkv_forward_lse_reference(_t(qkv), H, _t(mask), SCALE, _t(bias), _t(gate))
    got = ak.fused_qkv_backward_from_residuals_reference(
        _t(qkv), out, lse, _t(mask), _t(cot), SCALE, out_rest=rest, pos_bias=_t(bias), gate=_t(gate))
    assert (got[2] is None) == (gate is None)
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_gated_residual_backward_twin_matches_backward_twin_bf16(rng, case):
    """bf16 qkv and cotangent, residuals from the bf16 forward twin (Δ from
    the output and its rounding rest, as the kernel takes it), against the
    backward twin that recomputes the softmax: dqkv, dbias and dgate."""
    qkv, cot, bias, gate, mask = (_t(x) for x in _inputs(rng, *case))
    qkv, cot = qkv.bfloat16(), cot.bfloat16()
    out, lse, rest = ak._fused_qkv_forward_lse_reference(qkv, H, mask, SCALE, bias, gate)
    got = ak.fused_qkv_backward_from_residuals_reference(qkv, out, lse, mask, cot, SCALE, out_rest=rest,
                                                         pos_bias=bias, gate=gate)
    want = ak.fused_qkv_gated_backward_reference(qkv, H, bias, gate, mask, cot, SCALE)
    assert out.dtype == rest.dtype == got[0].dtype == want[0].dtype == torch.bfloat16
    for name, g, w in zip(("dqkv", "dbias", "dgate"), got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype
        g, w = g.float().numpy(), w.float().numpy()
        if not w.any():
            # T = 1: one key's softmax has no gradient; dP − Δ cancels to fp32 rounding.
            assert np.abs(g).max() <= 1e-4
        else:
            assert _rel(g, w) <= (BF16_DGATE_REL_L2 if name == "dgate" else BF16_REL_L2), name


@pytest.mark.parametrize("seq", [63, 248])
def test_gated_residual_twins_give_nan_where_the_softmax_does(rng, seq):
    """Item 0's keys all padded: its log-sum-exp is −inf, and the residual
    backward is NaN exactly where the backward twin is: item 0's dqkv and
    dgate rows, and dbias, which sums over every item. Item 1 (keys padded
    from 40) agrees with the backward twin and with ``jax.grad``."""
    qkv, cot, bias, gate, _ = _inputs(rng, seq, True, False)
    mask = np.zeros((B, seq), bool)
    mask[0] = True
    mask[1, 40:] = True
    out, lse, rest = ak._fused_qkv_forward_lse_reference(_t(qkv), H, _t(mask), SCALE, _t(bias), _t(gate))
    assert torch.isneginf(lse[0]).all() and torch.isfinite(lse[1]).all()
    got = ak.fused_qkv_backward_from_residuals_reference(
        _t(qkv), out, lse, _t(mask), _t(cot), SCALE, out_rest=rest, pos_bias=_t(bias), gate=_t(gate))
    want = ak.fused_qkv_gated_backward_reference(_t(qkv), H, _t(bias), _t(gate), _t(mask), _t(cot), SCALE)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    dqkv, dbias, dgate = got
    assert torch.isnan(dqkv[0]).all() and torch.isnan(dgate[0]).all() and torch.isnan(dbias).all()
    torch.testing.assert_close(dqkv[1], want[0][1], **TOL)
    torch.testing.assert_close(dgate[1], want[2][1], **TOL)
    # Item 1 alone through JAX: the same gradients, as the items do not mix in dqkv and dgate.
    jax_dqkv, _, jax_dgate = _jax_grads(jnp.asarray(qkv[1:]), jnp.asarray(cot[1:]), bias, gate[1:], mask[1:])
    np.testing.assert_allclose(dqkv[1].numpy(), np.asarray(jax_dqkv[0]), **TOL)
    np.testing.assert_allclose(dgate[1].numpy(), np.asarray(jax_dgate[0]), **TOL)
