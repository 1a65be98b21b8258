"""The fp32 backward of the general route (narrow rows and column chunks past
128) on 3xTF32, held to the JAX package on the CPU.

On the card every fp32 backward of ``fused_qkv_attention`` (K6) and
``fused_qkv_gated_attention`` (K3) runs ``csrc/tf32x3_attention.cu``. At a
head width that is not a multiple of 8 (narrow rows) the kernels load each
row 4 bytes at a time into tiles of the build's width, the columns past D
zero-filled, so they add 0 to every product. Past 128 the width is cut into
column chunks (``attention_kernels.width_plan``): S = Q·Kᵀ and dP = dO·Vᵀ
are summed over the chunks, each chunk zero-filled to the build's width, in
chunk order, once per pair of tiles, and dQ, dK and dV cover the whole
width. Here the backward reads the row log-sum-exp of the plain fp32 twin
(``_fused_qkv_forward_lse_reference``, as ``backward_from_lse`` reads it by
default), an arithmetic other than its own; it rebuilds P from it in
3xTF32 and rebases it (P / Σ P, Δ' = Σ P·dP / Σ P), so that the key
gradients still sum to 0 over the keys, whatever arithmetic the LSE came
from. (The route's own forward, on 3xTF32, and the backward from its LSE:
``tests/test_torch_tf32x3_forward_general.py``.)

Here that arithmetic is emulated in plain torch (``backward_from_lse`` of
``tests/test_torch_tf32x3.py`` with the chunked, zero-padded products) and
held to ``jax.grad`` through what JAX runs for those heads (its fused
kernels in interpret mode where its head groups tile 128 lanes, else its
split kernel), at dh 12 and 20 (narrow) and 136 and 192 (chunked), with a
gate, with a bias only, and K6 with a mask; one TF32 pass misses. The
kernels themselves are held to the plain twins on the card by
``chip_smoke.py`` and ``tests/test_torch_wide_heads.py``'s ``cuda`` tests.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.ops.pallas_attention import _heads_per_block
from avex_tpu.ops.pallas_attention import fused_qkv_attention as jax_fused_plain
from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused
from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split

from avex_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_attention_residuals import fp32_products  # noqa: F401  (autouse: the pinned fp32 products)
from tests.test_torch_tf32x3 import CARD_REL_L2, TOL, backward_from_lse, mm_1xtf32, mm_3xtf32
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

B, H, T = 2, 2, 37
# (head width, a gate ("gate", "bias only", or None: K6), a key-padding mask)
CASES = [
    (12, "gate", False), (12, "bias only", True), (12, None, True),
    (20, "gate", True), (20, None, True),
    (136, "gate", False), (136, "bias only", True), (136, None, True),
    (192, "gate", True), (192, None, True),
]


def _ids(case):
    dim, gating, masked = case
    return f"dh{dim}-{gating or 'K6'}-{'mask' if masked else 'nomask'}".replace(" ", "_")


def general(matmul, head_dim):
    """``a·b`` over the head width as the general route forms it: the width
    in the column chunks of ``width_plan``, each zero-filled to the build's
    width (narrow rows: the columns past D), the chunks' products summed in
    chunk order."""
    plan = ak.width_plan(head_dim)

    def contract(a, b):  # a [..., T, D], b [..., D, T]
        total = None
        for c0 in range(0, head_dim, plan.chunk_width):
            cols = min(plan.chunk_width, head_dim - c0)
            a_c = torch.nn.functional.pad(a[..., c0:c0 + cols], (0, plan.build - cols))
            b_c = torch.nn.functional.pad(b[..., c0:c0 + cols, :], (0, 0, 0, plan.build - cols))
            part = matmul(a_c, b_c)
            total = part if total is None else total + part
        return total

    return contract


def _inputs(rng, dim, gating, masked):
    qkv = rng.standard_normal((B, T, 3 * H * dim)).astype(np.float32)
    cot = rng.standard_normal((B, T, H * dim)).astype(np.float32)
    bias = rng.standard_normal((H, T, T)).astype(np.float32) if gating else None
    gate = rng.uniform(1.0, 3.0, (B, H, T)).astype(np.float32) if gating == "gate" else None
    mask = None
    if masked:
        mask = np.zeros((B, T), bool)
        mask[1, T // 3:] = True
    return qkv, cot, bias, gate, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _jax_grads(dim, qkv, cot, bias, gate, mask):
    """``jax.grad`` through what JAX runs for H heads of ``dim``: its fused
    kernels (K3 / K6 in interpret mode) where its head groups tile 128
    lanes, else its split kernel on the same q, k, v (K1 / K4 and their
    custom VJP). Returns ``(dqkv, dbias, dgate)``, None where there is
    none."""
    if _heads_per_block(H, dim):
        def attention(x, b, g):
            if b is None:
                return jax_fused_plain(x, H, _j(mask), interpret=True)
            return jax_fused(x, H, b, g, _j(mask), interpret=True)
    else:
        def attention(x, b, g):
            parts = x.reshape(B, T, 3, H, dim)
            q, k, v = (jnp.transpose(parts[:, :, i], (0, 2, 1, 3)) for i in range(3))
            out = jax_split(q, k, v, b, g, _j(mask), interpret=True)
            return jnp.transpose(out, (0, 2, 1, 3)).reshape(B, T, H * dim)

    if bias is None:
        return jax.grad(lambda x: jnp.sum(attention(x, None, None) * cot))(_j(qkv)), None, None
    if gate is None:
        dqkv, dbias = jax.grad(lambda x, b: jnp.sum(attention(x, b, None) * cot), argnums=(0, 1))(_j(qkv), _j(bias))
        return dqkv, dbias, None
    return jax.grad(lambda x, b, g: jnp.sum(attention(x, b, g) * cot), argnums=(0, 1, 2))(_j(qkv), _j(bias), _j(gate))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_general_route_backward_matches_jax_and_one_pass_misses(rng, case):
    """The emulated 3xTF32 K3 / K6 of the general route (zero-padded narrow
    columns, S and dP summed over column chunks in order, P from a
    plain-fp32 log-sum-exp and rebased) against JAX at the twins'
    tolerance and the card's relative L2; one TF32 pass misses both."""
    dim, gating, masked = case
    qkv, cot, bias, gate, mask = _inputs(rng, *case)
    want = _jax_grads(dim, qkv, cot, bias, gate, mask)
    args = (_t(qkv), H, _t(cot), _t(mask))
    got = backward_from_lse(*args, mm_3xtf32, _t(bias), _t(gate), contract=general(mm_3xtf32, dim))
    one_pass = backward_from_lse(*args, mm_1xtf32, _t(bias), _t(gate), contract=general(mm_1xtf32, dim))
    for name, g, w in zip(("dqkv", "dbias", "dgate"), got, want):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
        assert _rel(g, w) <= CARD_REL_L2, name
    assert not np.allclose(one_pass[0].numpy(), np.asarray(want[0]), **TOL)
    assert _rel(one_pass[0], want[0]) > 10 * CARD_REL_L2


@pytest.mark.parametrize("dim", [20, 136])
def test_rebasing_keeps_the_key_gradients_summing_to_zero_from_a_plain_lse(dim):
    """A property of the backward: from a row log-sum-exp taken in plain
    fp32, not in its own 3xTF32 arithmetic. With
    logits of a hundred or more P rebuilt from it sums over its row to
    1 + ε; the kernels' rebased P and Δ' keep Σ_k dK at fp32 autograd's
    level on narrow rows (dh 20) and on column chunks (dh 136), and dQ
    within 2.5x of fp32 autograd's distance from float64; without the
    rebasing Σ_k dK is five times that or more."""
    gen = torch.Generator().manual_seed(dim)
    seq = 40
    shared = torch.randn(1, 1, dim, generator=gen) * 6  # a large component every token shares
    qkv = torch.cat([torch.randn(B, seq, H * dim, generator=gen) * 3 + shared.repeat(1, 1, H),
                     torch.randn(B, seq, H * dim, generator=gen) * 3 + shared.repeat(1, 1, H),
                     torch.randn(B, seq, H * dim, generator=gen)], dim=-1)
    cot = torch.randn(B, seq, H * dim, generator=gen)

    def key_sum(dqkv):
        dk = dqkv[..., H * dim:2 * H * dim].double().reshape(B, seq, H, dim)
        return float(dk.sum(dim=1).norm() / dk.norm())

    def dq_error(dqkv):
        return float((dqkv[..., :H * dim].double() - exact[..., :H * dim]).norm() / exact[..., :H * dim].norm())

    leaf = qkv.double().requires_grad_()
    q, k, v = ak._split_heads(leaf, H)
    out = torch.softmax(q @ k.transpose(-1, -2) * dim**-0.5, dim=-1) @ v
    (exact,) = torch.autograd.grad(out.permute(0, 2, 1, 3).reshape(B, seq, H * dim), (leaf,), cot.double())
    leaf = qkv.clone().requires_grad_()
    (plain,) = torch.autograd.grad(ak.fused_qkv_reference(leaf, H), (leaf,), cot)
    contract = general(mm_3xtf32, dim)
    rebased = backward_from_lse(qkv, H, cot, None, mm_3xtf32, contract=contract)[0]
    as_is = backward_from_lse(qkv, H, cot, None, mm_3xtf32, rebase=False, contract=contract)[0]
    assert key_sum(rebased) < 2e-6 and key_sum(plain) < 2e-6
    assert key_sum(as_is) > 5 * max(key_sum(plain), key_sum(rebased))
    assert dq_error(rebased) < 2.5 * dq_error(plain)
