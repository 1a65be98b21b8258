"""Attention of the port (K1, K2, K4, K5 and their plain twins) against JAX.

On the CPU the port's wrappers take the plain twins; the JAX side runs its
Pallas kernels in interpret mode. The CUDA kernel itself is held against the
twins on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.ops.attention import relative_position_bucket_jnp
from avex_tpu.ops.pallas_attention import fused_qkv_attention as jax_fused_plain
from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused
from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split

from avex_tpu_torch.ops import attention_kernels as ak
from avex_tpu_torch.ops.attention import grad_multiply, relative_position_bucket

# The tolerance tests/unittests/test_pallas_attention.py holds the JAX kernel to.
TOL = dict(atol=2e-5, rtol=1e-4)
B, H, D = 2, 12, 64


def _inputs(rng, seq, gated, padded):
    qkv = rng.standard_normal((B, seq, 3 * H * D)).astype(np.float32)
    bias = rng.standard_normal((H, seq, seq)).astype(np.float32)
    gate = rng.uniform(1.0, 3.0, (B, H, seq)).astype(np.float32) if gated else None
    mask = None
    if padded:
        mask = np.zeros((B, seq), bool)
        mask[1, seq // 2:] = True
    return qkv, bias, gate, mask


def _split_np(qkv):
    parts = qkv.reshape(B, qkv.shape[1], 3, H, D)
    return [np.ascontiguousarray(parts[:, :, i].transpose(0, 2, 1, 3)) for i in range(3)]


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


CASES = [(seq, gated, padded) for seq in (24, 31) for gated in (True, False) for padded in (False, True)]


@pytest.mark.parametrize("seq,gated,padded", CASES)
def test_split_kernel_twin_matches_jax(rng, seq, gated, padded):
    ak.reset_launch_counts()
    qkv, bias, gate, mask = _inputs(rng, seq, gated, padded)
    q, k, v = _split_np(qkv)
    want = jax_split(_j(q), _j(k), _j(v), _j(bias), _j(gate), _j(mask), interpret=True)
    got = ak.gated_bias_attention(_t(q), _t(k), _t(v), _t(bias), _t(gate), _t(mask))
    ref = ak.gated_bias_attention_reference(_t(q), _t(k), _t(v), _t(bias), _t(gate), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert ak.LAUNCHES["gated_bias_attention"] == 0  # the CPU path launches nothing


@pytest.mark.parametrize("seq,gated,padded", CASES)
def test_fused_kernel_twin_matches_jax(rng, seq, gated, padded):
    ak.reset_launch_counts()
    qkv, bias, gate, mask = _inputs(rng, seq, gated, padded)
    want = jax_fused(_j(qkv), H, _j(bias), _j(gate), _j(mask), interpret=True)
    got = ak.fused_qkv_gated_attention(_t(qkv), H, _t(bias), _t(gate), _t(mask))
    assert got.shape == (B, seq, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ak.LAUNCHES["fused_qkv_gated_attention"] == 0


def test_fused_gated_wrapper_requires_a_bias(rng):
    """K5 has one entry point: the gated fused wrapper refuses ``pos_bias=None``."""
    qkv, _, _, _ = _inputs(rng, 24, False, False)
    with pytest.raises(ValueError, match="fused_qkv_attention"):
        ak.fused_qkv_gated_attention(_t(qkv), H, None)


def test_bf16_twin_matches_jax_reference(rng):
    """bf16 q/k/v: logits from fp32 upcasts, P cast to bf16 before PV."""
    qkv, bias, gate, _ = _inputs(rng, 31, True, False)
    q, k, v = (x.astype(jnp.bfloat16) for x in map(jnp.asarray, _split_np(qkv)))
    want = jax_split(q, k, v, _j(bias), _j(gate), None, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16() for x in (q, k, v))
    got = ak.gated_bias_attention(tq, tk, tv, _t(bias), _t(gate))
    assert got.dtype == torch.bfloat16
    want32 = np.asarray(want, np.float32)
    rel = np.linalg.norm(got.float().numpy() - want32) / np.linalg.norm(want32)
    # One bf16 rounding of the output (2^-9 relative) where the fp32 sums differ.
    assert rel < 5e-3


@pytest.mark.parametrize("gated", [True, False])
def test_split_kernel_gradients_match_jax(rng, gated):
    seq = 24
    qkv, bias, gate, mask = _inputs(rng, seq, gated, True)
    q, k, v = _split_np(qkv)
    cot = rng.standard_normal((B, H, seq, D)).astype(np.float32)

    def loss(q, k, v, bias, gate):
        out = jax_split(q, k, v, bias, gate, jnp.asarray(mask), interpret=True)
        return jnp.sum(out * cot)

    argnums = (0, 1, 2, 3, 4) if gated else (0, 1, 2, 3)
    want = jax.grad(loss, argnums=argnums)(_j(q), _j(k), _j(v), _j(bias), _j(gate))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, bias)]
    tgate = torch.from_numpy(gate).requires_grad_() if gated else None
    out = ak.gated_bias_attention(*leaves, tgate, torch.from_numpy(mask))
    (out * torch.from_numpy(cot)).sum().backward()
    got = [t.grad for t in leaves] + ([tgate.grad] if gated else [])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


PLAIN_CASES = [(seq, padded) for seq in (24, 33) for padded in (False, True)]


@pytest.mark.parametrize("seq,padded", PLAIN_CASES)
def test_plain_split_twin_matches_jax_k4(rng, seq, padded):
    """``pos_bias=None``: K4's twin against JAX's ``_plain_attention_kernel``."""
    ak.reset_launch_counts()
    qkv, _, _, mask = _inputs(rng, seq, False, padded)
    q, k, v = _split_np(qkv)
    want = jax_split(_j(q), _j(k), _j(v), None, None, _j(mask), interpret=True)
    got = ak.gated_bias_attention(_t(q), _t(k), _t(v), None, None, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sum(ak.LAUNCHES.values()) == 0


@pytest.mark.parametrize("seq,padded", PLAIN_CASES)
def test_fused_plain_twin_matches_jax_k5(rng, seq, padded):
    """``fused_qkv_attention``: K5's twin against JAX's ``_fused_qkv_kernel``."""
    ak.reset_launch_counts()
    qkv, _, _, mask = _inputs(rng, seq, False, padded)
    want = jax_fused_plain(_j(qkv), H, _j(mask), interpret=True)
    got = ak.fused_qkv_attention(_t(qkv), H, _t(mask))
    ref = ak.fused_qkv_reference(_t(qkv), H, _t(mask))
    assert got.shape == (B, seq, H * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert sum(ak.LAUNCHES.values()) == 0


@pytest.mark.parametrize("padded", [False, True])
def test_fused_plain_twin_gradient_matches_jax_k6(rng, padded):
    """The K5 twin's autograd gradient against ``jax.grad`` through
    ``fused_qkv_attention``, whose backward is K6 in interpret mode."""
    seq = 24
    qkv, _, _, mask = _inputs(rng, seq, False, padded)
    cot = rng.standard_normal((B, seq, H * D)).astype(np.float32)

    def loss(x):
        return jnp.sum(jax_fused_plain(x, H, _j(mask), interpret=True) * cot)

    want = jax.grad(loss)(_j(qkv))
    leaf = torch.from_numpy(qkv).requires_grad_()
    (ak.fused_qkv_attention(leaf, H, _t(mask)) * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_plain_split_twin_gradient_matches_jax(rng):
    """K4's backward is the twin recomputed under autograd, as JAX's ``_bwd``."""
    seq = 24
    qkv, _, _, mask = _inputs(rng, seq, False, True)
    q, k, v = _split_np(qkv)
    cot = rng.standard_normal((B, H, seq, D)).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jax_split(q, k, v, None, None, jnp.asarray(mask), interpret=True) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (ak.gated_bias_attention(*leaves, None, None, torch.from_numpy(mask)) * torch.from_numpy(cot)).sum().backward()
    for g, w in zip((t.grad for t in leaves), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("seq", [8, 31, 248, 496])
def test_relative_position_bucket_matches_jax_exactly(seq):
    want = np.asarray(relative_position_bucket_jnp(seq, seq, 320, 800))
    got = relative_position_bucket(seq, seq, 320, 800)
    np.testing.assert_array_equal(got, want)


def test_grad_multiply_scales_only_the_gradient():
    x = torch.randn(3, 4, requires_grad=True)
    y = grad_multiply(x, 0.25)
    torch.testing.assert_close(y, x)
    y.sum().backward()
    torch.testing.assert_close(x.grad, torch.full_like(x, 0.25))


def test_fused_qkv_compatible_is_the_kernel_head_width():
    assert ak.fused_qkv_compatible(768, 12)
    assert not ak.fused_qkv_compatible(96, 12)
    assert not ak.fused_qkv_compatible(1280, 16)  # dh=80: K1/K2 take dh=64 only
