"""The numeric design of the fp32 attention kernels on the tensor cores
(3xTF32), forward (K1, K2, K4, K5) and backward (K3, K6), held to the JAX
package on the CPU.

On the card the fp32 forward at a head width that is a multiple of 8 up to
128 on 16-byte rows runs ``csrc/tf32x3_attention.cu``'s forward kernel: per
key tile of 32, S = Q·Kᵀ with Q and K split into TF32 halves, the logits in
log2 units, an online softmax, and O += P·V with P and V split the same
way; O over the row sum at the end, and the row log-sum-exp for the
backward. Its emulation here is held to JAX's K1, K2, K4 and K5 (interpret
mode) at the twins' tolerance at dh 16, 64 and 80, with and without a mask
and a gate, and one TF32 pass misses it. The fp32 backward of ``fused_qkv_attention`` (K6) and
``fused_qkv_gated_attention`` (K3) at a head width that is a multiple of 8 up
to 128 on 16-byte rows runs ``csrc/tf32x3_attention.cu``: P is rebuilt from
the row log-sum-exp the fp32 forward saved and Δ = rowsum(dO ∘ O) is taken
from its output for dQ; dK, dV and dbias take P over its row sum and
Δ' = Σ P·dP / Σ P; every product splits each fp32 operand x into TF32
halves, hi = tf32(x) and lo = tf32(x − hi), and sums lo·hi + hi·lo + hi·hi in
fp32. Here that arithmetic is emulated in plain torch (TF32 rounding is round to
nearest, ties away from zero, on the 13 low mantissa bits of the int32 view,
as ``cvt.rna.tf32.f32`` rounds) and the emulated backward is held to JAX's
K3 and K6 (Pallas in interpret mode, through ``jax.grad``) at the attention
twins' tolerance, at dh 16, 64 and 80, with a mask and with a gate. One TF32
pass (hi·hi alone) misses it, and without the rebased P the key gradients
no longer sum to 0 over the keys. The emulation is a test helper: nothing
of the port calls it. The kernels themselves are held to the plain twins on the
card by ``chip_smoke.py`` and ``scripts/torch_tf32x3_backward.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.ops.pallas_attention import fused_qkv_attention as jax_fused_plain
from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused
from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split

from avex_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_attention_residuals import fp32_products  # noqa: F401  (autouse: the pinned fp32 products)
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

B, H = 2, 2
# The tolerance tests/unittests/test_pallas_attention.py holds the JAX kernel to.
TOL = dict(atol=2e-5, rtol=1e-4)
# chip_smoke.py holds the kernels to the plain fp32 twin at this relative L2.
CARD_REL_L2 = 1e-5
LOG2E = 1.0 / math.log(2.0)
# (head width, a gate ("gate", "bias only", or None: K6), a key-padding mask, T)
CASES = [
    (16, None, True, 37), (64, None, False, 70), (64, None, True, 37), (80, None, True, 37),
    (16, "gate", True, 37), (64, "gate", False, 70), (64, "gate", True, 37), (64, "bias only", True, 37),
    (80, "gate", True, 37),
]


def _ids(case):
    dim, gating, masked, seq = case
    return f"dh{dim}-{gating or 'K6'}-{'mask' if masked else 'nomask'}-T{seq}".replace(" ", "_")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32: to nearest, ties away from zero, on the 13 low
    mantissa bits of the int32 view (``cvt.rna.tf32.f32``)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    """x = hi + lo, each in TF32: lo is what rounding x to TF32 dropped."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b as the kernels take it: lo·hi + hi·lo first, then hi·hi, fp32 sums."""
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b in one TF32 pass: hi·hi alone."""
    return tf32(a) @ tf32(b)


def backward_from_lse(qkv, heads, dout, mask, matmul, pos_bias=None, gate=None, rebase=True, contract=None,
                      residuals=None):
    """The 3xTF32 K3 (with ``pos_bias``) or K6 step by step, every product
    through ``matmul`` (S = Q·Kᵀ and dP = dO·Vᵀ, the products over the head
    width, through ``contract`` when given): P from the forward's row
    log-sum-exp, Δ from its output (``residuals``, ``(out [B, T, E], lse
    [B, H, T])``; the plain fp32 twin's by default); dK, dV and dbias from P / Σ P and
    Δ' = Σ P·dP / Σ P, and dQ and dgate corrected to them (dQ with the keys'
    mean taken out of Σ_k dS·K) as the kernels take them (``rebase``; else
    every output from P and Δ as they are). Returns ``(dqkv, dbias, dgate)``
    (None where there is none)."""
    contract = contract or matmul
    bsz, seq, three_e = qkv.shape
    dim = three_e // 3
    d = dim // heads
    scale = d**-0.5
    out, lse = residuals or ak._fused_qkv_forward_lse_reference(qkv, heads, mask, scale, pos_bias, gate)[:2]

    def heads_first(t):
        return t.reshape(bsz, seq, heads, d).permute(0, 2, 1, 3)

    q, k, v = ak._split_heads(qkv, heads)
    o, do = heads_first(out), heads_first(dout)
    logits = contract(q, k.transpose(-1, -2)) * scale
    if pos_bias is not None:
        logits = logits + (gate[..., None] * pos_bias[None] if gate is not None else pos_bias[None])
    if mask is not None:
        logits = logits.masked_fill(mask[:, None, None, :], float("-inf"))
    p = torch.exp2(logits * LOG2E - lse[..., None] * LOG2E)
    dp = contract(do, v.transpose(-1, -2))  # dP = dO·Vᵀ
    delta = (do * o).sum(dim=-1, keepdim=True)  # Δ = rowsum(dO ∘ O)
    dl = p * (dp - delta)  # dL = P∘(dP − Δ): the dQ kernel's
    total = p.sum(dim=-1, keepdim=True) if rebase else torch.ones_like(delta)
    rebased = (p * dp).sum(dim=-1, keepdim=True) / total if rebase else delta  # Δ'
    dl_kv = (p / total) * (dp - rebased)  # the dK/dV and dbias kernels' dL
    dv = matmul((p / total).transpose(-1, -2), do)  # dV = P'ᵀ·dO
    dbias = dgate = None
    if pos_bias is not None:
        dbias = (gate[..., None] * dl_kv if gate is not None else dl_kv).sum(dim=0)
        if gate is not None:
            bias_p = (pos_bias[None] * p).sum(dim=-1, keepdim=True)
            dgate = (((pos_bias[None] * dl).sum(dim=-1, keepdim=True) + (delta - rebased) * bias_p) / total)[..., 0]
    dq = matmul(dl * scale, k)  # dQ = dS·K
    if rebase:  # less (Σ_k dS)·K̄, over Σ P
        dq = (dq - (dl * scale).sum(dim=-1, keepdim=True) * k.sum(dim=-2, keepdim=True) / seq) / total
    dk = matmul((dl_kv * scale).transpose(-1, -2), q)  # dK = dS'ᵀ·Q
    dqkv = torch.stack([t.permute(0, 2, 1, 3) for t in (dq, dk, dv)], dim=2).reshape(bsz, seq, three_e)
    return dqkv, dbias, dgate


def _inputs(rng, dim, gating, masked, seq):
    qkv = rng.standard_normal((B, seq, 3 * H * dim)).astype(np.float32)
    cot = rng.standard_normal((B, seq, H * dim)).astype(np.float32)
    bias = rng.standard_normal((H, seq, seq)).astype(np.float32) if gating else None
    gate = rng.uniform(1.0, 3.0, (B, H, seq)).astype(np.float32) if gating == "gate" else None
    mask = None
    if masked:
        mask = np.zeros((B, seq), bool)
        mask[1, seq // 2:] = True
    return qkv, cot, bias, gate, mask


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _jax_grads(qkv, cot, bias, gate, mask):
    """``jax.grad`` through JAX's fused kernels in interpret mode (K3 with a
    bias, K6 without): ``(dqkv, dbias, dgate)``, None where there is none."""
    if bias is None:
        return jax.grad(lambda x: jnp.sum(jax_fused_plain(x, H, _j(mask), interpret=True) * cot))(_j(qkv)), None, None

    def loss(x, b, g):
        return jnp.sum(jax_fused(x, H, b, g, _j(mask), interpret=True) * cot)

    if gate is None:
        dqkv, dbias = jax.grad(lambda x, b: loss(x, b, None), argnums=(0, 1))(_j(qkv), _j(bias))
        return dqkv, dbias, None
    return jax.grad(loss, argnums=(0, 1, 2))(_j(qkv), _j(bias), _j(gate))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_3xtf32_backward_matches_jax_and_one_pass_misses(rng, case):
    qkv, cot, bias, gate, mask = _inputs(rng, *case)
    want = _jax_grads(qkv, cot, bias, gate, mask)
    args = (_t(qkv), H, _t(cot), _t(mask))
    got = backward_from_lse(*args, mm_3xtf32, _t(bias), _t(gate))
    one_pass = backward_from_lse(*args, mm_1xtf32, _t(bias), _t(gate))
    for name, g, w in zip(("dqkv", "dbias", "dgate"), got, want):
        assert (g is None) == (w is None), name
        if w is None:
            continue
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=name)
        assert _rel(g, w) <= CARD_REL_L2, name
    # One TF32 pass keeps 10 mantissa bits of each operand: dqkv misses the
    # tolerance, and lands far past the card's relative L2.
    assert not np.allclose(one_pass[0].numpy(), np.asarray(want[0]), **TOL)
    assert _rel(one_pass[0], want[0]) > 10 * CARD_REL_L2


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """tf32() keeps 10 mantissa bits: a value exactly halfway rounds away
    from zero on either sign, below half rounds down, and x − hi is what
    the rounding dropped, itself a TF32 value here."""
    ulp = 2.0**-10  # TF32's spacing in [1, 2)
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0**-23, 1.0 + 3 * ulp / 2, 3.0])
    np.testing.assert_array_equal(tf32(x).numpy(), np.array([1 + ulp, -(1 + ulp), 1.0, 1 + 2 * ulp, 3.0], np.float32))
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0**-21


def test_rebased_p_keeps_the_key_gradients_summing_to_zero():
    """Σ_k dK_k is 0 in exact arithmetic (Σ_k dS = 0). With logits of a
    hundred or more, P rebuilt from the log-sum-exp sums over its row to
    1 + ε for a row-wide ε near 1e-5; with Δ from the output Σ_k dS = Δ·ε,
    which dK carries into every key. The kernels' rebased P and Δ' keep
    Σ_k dK at fp32 autograd's level, and dQ, which multiplies Σ_k dS by the
    keys' shared part, within 2.5x of fp32 autograd's distance from float64
    (without them, past twice that)."""
    gen = torch.Generator().manual_seed(0)
    dim, seq = 64, 249
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

    leaf = qkv.double().requires_grad_()  # float64 throughout (the twins take fp32 logits)
    q, k, v = ak._split_heads(leaf, H)
    out = torch.softmax(q @ k.transpose(-1, -2) * dim**-0.5, dim=-1) @ v
    (exact,) = torch.autograd.grad(out.permute(0, 2, 1, 3).reshape(B, seq, H * dim), (leaf,), cot.double())
    leaf = qkv.clone().requires_grad_()
    (plain,) = torch.autograd.grad(ak.fused_qkv_reference(leaf, H), (leaf,), cot)
    rebased = backward_from_lse(qkv, H, cot, None, mm_3xtf32)[0]
    as_is = backward_from_lse(qkv, H, cot, None, mm_3xtf32, rebase=False)[0]
    assert key_sum(plain) < 2e-6 and key_sum(rebased) < 2e-6
    assert key_sum(as_is) > 5 * max(key_sum(plain), key_sum(rebased))
    assert dq_error(rebased) < 2.5 * dq_error(plain) and dq_error(as_is) > 2 * dq_error(rebased)


@pytest.mark.parametrize("head_dim,narrow,takes", [
    (8, False, "16-byte"), (16, False, "16-byte"), (64, False, "16-byte"), (80, False, "16-byte"),
    (120, False, "16-byte"), (128, False, "16-byte"), (64, True, "narrow"), (12, False, "narrow"),
    (136, False, "wide"), (256, False, "wide"),
])
def test_tf32x3_rows_is_the_plan_of_the_fp32_backward(head_dim, narrow, takes):
    """Every fp32 call, forward or backward, runs on the 3xTF32 kernels, and
    the wrapper's plan says which: the column chunks past 128
    (``width_plan``) take the wide kernels; one chunk on narrow rows (a
    width or stride that is not a multiple of 8, ``_check_operands``) the
    narrow rows' instance; else the 16-byte kernels. The plan reaches the
    C entry points as :func:`_columns`' ``(head_dim, chunk_width, narrow)``.
    One rule, ``kernel_body``, gives the body by type alone."""
    stride = head_dim + 1 if narrow else head_dim
    q = torch.zeros(1, 1, 4, stride)[..., :head_dim]
    rows_narrow = ak._check_operands(q, q, q, {}, None, None, None)
    plan = ak.width_plan(head_dim)
    dim, chunk_width, narrow_arg = ak._columns(head_dim, rows_narrow)
    assert (dim, chunk_width, narrow_arg) == (head_dim, plan.chunk_width, int(rows_narrow))
    assert rows_narrow == (narrow or head_dim % 8 != 0)
    got = "wide" if plan.chunks > 1 else "narrow" if rows_narrow else "16-byte"
    assert got == takes
    assert ak.kernel_body(torch.float32) == "tf32x3"
    assert ak.kernel_body(torch.bfloat16) == "bf16"


def forward_tf32x3(q, k, v, pos_bias, gate, mask, matmul, tile=32, contract=None):
    """The 3xTF32 forward step by step on ``[B, H, T, D]`` q, k and v, every
    product through ``matmul`` (S = Q·Kᵀ, the product over the head width,
    through ``contract`` when given): per key tile of ``tile`` keys S = Q·Kᵀ, the
    logits in log2 units (S·scale·log2e + gate·log2e·bias, −inf at padded
    keys), the running row max (a shift of 0 while it is −inf), the row sum
    and O rescaled by exp2 of the max's move, O += P·V with P unnormalised;
    O over the row sum at the end. Returns ``(out, lse)``, the row
    log-sum-exp in natural units."""
    contract = contract or matmul
    bsz, heads, seq, d = q.shape
    c = d**-0.5 * LOG2E
    mx = torch.full((bsz, heads, seq, 1), float("-inf"))
    lsum = torch.zeros(bsz, heads, seq, 1)
    acc = torch.zeros(bsz, heads, seq, d)
    for k0 in range(0, seq, tile):
        keys = slice(k0, min(seq, k0 + tile))
        x = contract(q, k[:, :, keys].transpose(-1, -2)) * c
        if pos_bias is not None:
            x = x + pos_bias[None, :, :, keys] * (gate[..., None] * LOG2E if gate is not None else LOG2E)
        if mask is not None:
            x = x.masked_fill(mask[:, None, None, keys], float("-inf"))
        m_new = torch.maximum(mx, x.amax(dim=-1, keepdim=True))
        shift = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        corr = torch.exp2(mx - shift)
        p = torch.exp2(x - shift)
        lsum = lsum * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + matmul(p, v[:, :, keys])
        mx = m_new
    return acc / lsum, ((mx + torch.log2(lsum)) / LOG2E)[..., 0]


def _jax_forward(kernel, qkv, bias, gate, mask):
    """JAX's K1 / K4 (``gated_bias_attention`` on split q, k, v) or K2 / K5
    (the fused kernels on ``[B, T, 3E]``) in interpret mode, as ``[B, T, E]``."""
    if kernel in ("K2", "K5"):
        if bias is None:
            return np.asarray(jax_fused_plain(_j(qkv), H, _j(mask), interpret=True))
        return np.asarray(jax_fused(_j(qkv), H, _j(bias), _j(gate), _j(mask), interpret=True))
    bsz, seq, three_e = qkv.shape
    q, k, v = (np.ascontiguousarray(t.transpose(0, 2, 1, 3))
               for t in qkv.reshape(bsz, seq, 3, H, three_e // 3 // H).transpose(2, 0, 1, 3, 4))
    out = np.asarray(jax_split(_j(q), _j(k), _j(v), _j(bias), _j(gate), _j(mask), interpret=True))
    return out.transpose(0, 2, 1, 3).reshape(bsz, seq, three_e // 3)


@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_3xtf32_forward_matches_jax_and_one_pass_misses(rng, case, layout):
    """K1/K2 (gated) or K4/K5 (bias-free): the emulated 3xTF32 forward
    against JAX's kernel at the twins' tolerance and the card's relative L2,
    its row log-sum-exp against the twin's at the card's 1e-5; one TF32
    pass misses both."""
    dim, gating, masked, seq = case
    qkv, _, bias, gate, mask = _inputs(rng, *case)
    kernel = {("split", True): "K1", ("fused", True): "K2", ("split", False): "K4", ("fused", False): "K5"}[
        layout, gating is not None]
    want = _jax_forward(kernel, qkv, bias, gate, mask)
    q, k, v = ak._split_heads(_t(qkv), H)
    _, lse, _ = ak._fused_qkv_forward_lse_reference(_t(qkv), H, _t(mask), dim**-0.5, _t(bias), _t(gate))

    def merged(out):
        return out.permute(0, 2, 1, 3).reshape(want.shape).numpy()

    got, got_lse = forward_tf32x3(q, k, v, _t(bias), _t(gate), _t(mask), mm_3xtf32)
    np.testing.assert_allclose(merged(got), want, **TOL)
    assert _rel(merged(got), want) <= CARD_REL_L2
    np.testing.assert_allclose(got_lse.numpy(), lse.numpy(), atol=1e-5, rtol=0)
    one_pass, _ = forward_tf32x3(q, k, v, _t(bias), _t(gate), _t(mask), mm_1xtf32)
    assert not np.allclose(merged(one_pass), want, **TOL)
    assert _rel(merged(one_pass), want) > 10 * CARD_REL_L2
