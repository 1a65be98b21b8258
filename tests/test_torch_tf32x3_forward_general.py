"""The fp32 forward of the general route (narrow rows and column chunks past
128) on 3xTF32, held to the JAX package on the CPU.

On the card every fp32 forward of ``gated_bias_attention`` (K1 with a bias,
K4 without), ``fused_qkv_gated_attention`` (K2) and ``fused_qkv_attention``
(K5) runs ``csrc/tf32x3_attention.cu``. On narrow rows (a head width that
is not a multiple of 8) the forward kernel loads each row 4 bytes at a time
into tiles of the build's width, the columns past D zero-filled, and walks
the keys in tiles of 32 as on 16-byte rows. Past 128 the width is cut into
column chunks (``attention_kernels.width_plan``) and the wide forward walks
the keys in tiles of 64: S = Q·Kᵀ is summed over the chunks, each chunk
zero-filled to the build's width, in chunk order, then the online softmax
in log2 units and O += P·V over the whole width; O over the row sum at the
end, and the row log-sum-exp for the backward.

Here that arithmetic is emulated in plain torch (``forward_tf32x3`` of
``tests/test_torch_tf32x3.py`` with the kernel's key tile and the chunked,
zero-padded S of ``general``) and held to what JAX runs for those heads
(its fused kernels in interpret mode where its head groups tile 128 lanes,
else its split kernel) at dh 12 and 20 (narrow) and 136 and 192 (chunked),
in the split (K1/K4) and fused (K2/K5) layouts, with a gate, with a bias
only, and bias-free with a mask; the row log-sum-exp against the plain fp32
twin's; one TF32 pass misses. Then the emulated 3xTF32 backward runs from
this forward's output and log-sum-exp, and its rebasing keeps the key
gradients summing to 0. The kernels themselves are held to the plain twins
on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``'s
``cuda`` tests.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avex_tpu.ops.pallas_attention import _heads_per_block
from avex_tpu.ops.pallas_attention import fused_qkv_attention as jax_fused_plain
from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused
from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split

from avex_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_attention_residuals import fp32_products  # noqa: F401  (autouse: the pinned fp32 products)
from tests.test_torch_tf32x3 import CARD_REL_L2, TOL, backward_from_lse, forward_tf32x3, mm_1xtf32, mm_3xtf32
from tests.test_torch_tf32x3_general import general
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

B, H, T = 2, 2, 37
# (head width, a gate ("gate", "bias only", or None: bias-free), a key-padding mask)
CASES = [
    (12, "gate", False), (12, "bias only", True), (12, None, True),
    (20, "gate", True), (20, None, True),
    (136, "gate", False), (136, "bias only", True), (136, None, True),
    (192, "gate", True), (192, None, True),
]
# The row log-sum-exp against the plain fp32 twin's, as chip_smoke.py holds the kernels'
LSE_ATOL = 1e-5


def _ids(case):
    dim, gating, masked = case
    return f"dh{dim}-{gating or 'bias_free'}-{'mask' if masked else 'nomask'}".replace(" ", "_")


def key_tile(head_dim: int) -> int:
    """The keys a tile of the kernel that runs this width: 32 on one column
    chunk (the forward kernel), 64 past 128 (the wide forward)."""
    return 32 if ak.width_plan(head_dim).chunks == 1 else 64


def _inputs(rng, dim, gating, masked):
    qkv = rng.standard_normal((B, T, 3 * H * dim)).astype(np.float32)
    bias = rng.standard_normal((H, T, T)).astype(np.float32) if gating else None
    gate = rng.uniform(1.0, 3.0, (B, H, T)).astype(np.float32) if gating == "gate" else None
    mask = None
    if masked:
        mask = np.zeros((B, T), bool)
        mask[1, T // 3:] = True
    return qkv, bias, gate, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _jax_forward(layout, dim, qkv, bias, gate, mask):
    """What JAX runs for H heads of ``dim`` as ``[B, T, E]``: in the fused
    layout its fused kernel (K2 / K5, interpret mode) where its head groups
    tile 128 lanes, else (and in the split layout) its split kernel (K1 / K4)
    on the same q, k, v."""
    if layout == "fused" and _heads_per_block(H, dim):
        if bias is None:
            return np.asarray(jax_fused_plain(_j(qkv), H, _j(mask), interpret=True))
        return np.asarray(jax_fused(_j(qkv), H, _j(bias), _j(gate), _j(mask), interpret=True))
    q, k, v = (np.ascontiguousarray(t.transpose(0, 2, 1, 3))
               for t in qkv.reshape(B, T, 3, H, dim).transpose(2, 0, 1, 3, 4))
    out = np.asarray(jax_split(_j(q), _j(k), _j(v), _j(bias), _j(gate), _j(mask), interpret=True))
    return out.transpose(0, 2, 1, 3).reshape(B, T, H * dim)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def general_forward(qkv, dim, bias, gate, mask, matmul):
    """The emulated general forward on ``[B, T, 3E]``: ``(out [B, T, E], lse
    [B, H, T])``."""
    q, k, v = ak._split_heads(qkv, H)
    out, lse = forward_tf32x3(q, k, v, bias, gate, mask, matmul, tile=key_tile(dim),
                              contract=general(matmul, dim))
    return out.permute(0, 2, 1, 3).reshape(B, T, H * dim), lse


@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_general_route_forward_matches_jax_and_one_pass_misses(rng, case, layout):
    """K1/K2 (with a bias) or K4/K5: the emulated 3xTF32 forward of the
    general route against JAX at the twins' tolerance and the card's
    relative L2, its row log-sum-exp against the twin's at 1e-5; one TF32
    pass misses both."""
    dim = case[0]
    qkv, bias, gate, mask = _inputs(rng, *case)
    want = _jax_forward(layout, dim, qkv, bias, gate, mask)
    args = (_t(qkv), dim, _t(bias), _t(gate), _t(mask))
    got, lse = general_forward(*args, mm_3xtf32)
    _, want_lse, _ = ak._fused_qkv_forward_lse_reference(_t(qkv), H, _t(mask), dim**-0.5, _t(bias), _t(gate))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert _rel(got, want) <= CARD_REL_L2
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=LSE_ATOL, rtol=0)
    one_pass, _ = general_forward(*args, mm_1xtf32)
    assert not np.allclose(one_pass.numpy(), want, **TOL)
    assert _rel(one_pass, want) > 10 * CARD_REL_L2


@pytest.mark.parametrize("dim", [20, 136])
def test_backward_from_this_forwards_lse_keeps_the_key_gradients_summing_to_zero(dim):
    """The general route's backward runs from the row log-sum-exp and the
    output of this forward (key tiles of 32 or 64, S summed over the column
    chunks). With logits of a hundred or more, P rebuilt from it sums over
    its row to 1 + ε; the rebased P and Δ' keep Σ_k dK at fp32 autograd's
    level on narrow rows (dh 20) and on column chunks (dh 136), and dQ
    within 2.5x of fp32 autograd's distance from float64; without the
    rebasing Σ_k dK is five times that or more."""
    gen = torch.Generator().manual_seed(dim + 1)
    seq = T
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
    residuals = general_forward(qkv, dim, None, None, None, mm_3xtf32)
    contract = general(mm_3xtf32, dim)
    rebased = backward_from_lse(qkv, H, cot, None, mm_3xtf32, contract=contract, residuals=residuals)[0]
    as_is = backward_from_lse(qkv, H, cot, None, mm_3xtf32, rebase=False, contract=contract,
                              residuals=residuals)[0]
    assert key_sum(rebased) < 2e-6 and key_sum(plain) < 2e-6
    assert key_sum(as_is) > 5 * max(key_sum(plain), key_sum(rebased))
    assert dq_error(rebased) < 2.5 * dq_error(plain)
