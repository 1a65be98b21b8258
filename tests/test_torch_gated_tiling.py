"""The bf16 gated tensor-core forward's arithmetic, emulated in torch, against JAX.

``tensor_core_attention.cu``'s gated forward (K1 on split views, K2 on the
raw ``[B, T, 3E]`` projection, in bf16) computes the softmax in another
order than JAX's TPU cells: 64-key tiles with an online softmax in the exp2
domain, ``(gate·log2e)·bias`` folded into the logits' FMA, the unnormalised P
rounded to bf16 before P·V, and one division by the row sum at the end.
:func:`kernel_emulation` does those steps in that order on the CPU; here it
is held to JAX's ``gated_bias_attention`` and ``fused_qkv_gated_attention``
(Pallas in interpret mode) on the same bf16 inputs. On the card,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` hold the kernel to the
port's plain twin.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused
from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

B, H, D = 2, 4, 64
KEYS = 64  # keys a streamed tile, as the kernel launches it
# One bf16 rounding of P and of the output, sums in another order: the
# kernel's bound against its twin on the card.
BF16_REL_L2 = 5e-3
LOG2E = 1.0 / math.log(2.0)


def kernel_emulation(q, k, v, bias, gate, mask, scale):
    """The gated forward as the kernel orders it, on ``[B, H, T, D]`` bf16
    views; bias fp32 ``[H, T, T]``, gate fp32 ``[B, H, T]`` or None, mask
    bool ``[B, T]`` (True = padded) or None. Returns bf16 ``[B, H, T, D]``."""
    bsz, heads, seq, dim = q.shape
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    gl = (gate.float() if gate is not None else torch.ones(bsz, heads, seq)) * LOG2E  # gate·log2e per row
    m = torch.full((bsz, heads, seq), -math.inf)
    l = torch.zeros(bsz, heads, seq)
    o = torch.zeros(bsz, heads, seq, dim)
    for k0 in range(0, seq, KEYS):
        keys = slice(k0, min(k0 + KEYS, seq))
        s = torch.matmul(q.float(), k[:, :, keys].float().transpose(-1, -2))  # fp32 accumulation
        x = s * c + gl[..., None] * bias[None, :, :, keys]
        if mask is not None:
            x = x.masked_fill(mask[:, None, None, keys], -math.inf)
        m_new = torch.maximum(m, x.amax(dim=-1))
        shift = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)  # an all-padded row so far
        corr = torch.exp2(m - shift)
        p = torch.exp2(x - shift[..., None])
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.matmul(p.to(torch.bfloat16).float(), v[:, :, keys].float())
        m = m_new
    return (o * (1.0 / l)[..., None]).to(torch.bfloat16)


def _inputs(rng, seq, gated, padded):
    qkv = rng.standard_normal((B, seq, 3 * H * D)).astype(np.float32)
    bias = rng.standard_normal((H, seq, seq)).astype(np.float32)
    gate = rng.uniform(1.0, 3.0, (B, H, seq)).astype(np.float32) if gated else None
    mask = None
    if padded:
        mask = np.zeros((B, seq), bool)
        mask[1, (seq + 1) // 2:] = True
    return qkv, bias, gate, mask


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# Each T once at least (one tile and a ragged rest, two tiles and one key,
# BEATs' three tiles and 56 keys), the gate and the mask each on and off, and
# both layouts at BEATs' shape.
CASES = [(31, True, False, "split"), (65, False, True, "fused"), (248, True, True, "split"), (248, True, True, "fused")]


@pytest.mark.parametrize("seq,gated,padded,layout", CASES)
def test_kernel_emulation_matches_jax(rng, seq, gated, padded, layout):
    qkv, bias, gate, mask = _inputs(rng, seq, gated, padded)
    qkv16 = torch.from_numpy(qkv).bfloat16()
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv16.view(B, seq, 3, H, D).unbind(2))
    tbias, tgate = torch.from_numpy(bias), None if gate is None else torch.from_numpy(gate)
    tmask = None if mask is None else torch.from_numpy(mask)
    got = kernel_emulation(q, k, v, tbias, tgate, tmask, D**-0.5)
    jgate, jmask = (None if x is None else jnp.asarray(x) for x in (gate, mask))
    if layout == "split":
        jq, jk, jv = (jnp.asarray(t.float().contiguous().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
        want = jax_split(jq, jk, jv, jnp.asarray(bias), jgate, jmask, interpret=True)
    else:
        jqkv = jnp.asarray(qkv16.float().numpy()).astype(jnp.bfloat16)
        want = jax_fused(jqkv, H, jnp.asarray(bias), jgate, jmask, interpret=True)
        got = got.permute(0, 2, 1, 3).reshape(B, seq, H * D)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel_l2(got.float().numpy(), want) < BF16_REL_L2


def test_kernel_emulation_nan_on_an_all_padded_item():
    """An item whose keys are all padded gives NaN, as the twin's softmax."""
    rng = np.random.default_rng(0)
    qkv, bias, gate, _ = _inputs(rng, 31, True, False)
    mask = torch.zeros(B, 31, dtype=torch.bool)
    mask[0] = True
    qkv16 = torch.from_numpy(qkv).bfloat16()
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv16.view(B, 31, 3, H, D).unbind(2))
    got = kernel_emulation(q, k, v, torch.from_numpy(bias), torch.from_numpy(gate), mask, D**-0.5)
    assert torch.isnan(got[0]).all() and torch.isfinite(got[1]).all()
