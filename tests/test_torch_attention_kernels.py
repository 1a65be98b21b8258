"""Attention of the port (K1, K2, K4, K5 and their plain twins) against JAX,
at head width 64 and, for the bias-free K4/K5/K6, 80 (the other widths the
kernels take: ``tests/test_torch_head_widths.py``).

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
from avex_tpu.ops.pallas_attention import fused_qkv_compatible as jax_compatible
from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused
from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split

from avex_tpu_torch.ops import attention_kernels as ak
from avex_tpu_torch.ops.attention import grad_multiply, relative_position_bucket
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

# The tolerance tests/unittests/test_pallas_attention.py holds the JAX kernel to.
TOL = dict(atol=2e-5, rtol=1e-4)
B, H, D = 2, 12, 64


def _inputs(rng, seq, gated, padded, heads=H):
    qkv = rng.standard_normal((B, seq, 3 * heads * D)).astype(np.float32)
    bias = rng.standard_normal((heads, seq, seq)).astype(np.float32)
    gate = rng.uniform(1.0, 3.0, (B, heads, seq)).astype(np.float32) if gated else None
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
    assert ak.fused_qkv_compatible(96, 12)  # dh=8
    assert ak.fused_qkv_compatible(240, 12)  # dh=20: every head width runs
    assert ak.fused_qkv_compatible(1280, 16)  # dh=80: Bird-MAE huge takes K5
    assert not ak.fused_qkv_compatible(770, 12)  # the heads do not split evenly


# (dim, heads) → JAX's rule (head groups tiling 128 lanes) and the port's
# (the heads split evenly, any width): they differ at 12 heads of 80, 1 of
# 64, 12 of 8 and 11 of 70, where JAX's head groups do not tile 128 lanes.
# The last id is the one that case had when the port took only multiples of
# 8 up to 128.
COMPATIBLE_GRID = [
    (768, 12, True, True), (1024, 16, True, True), (1280, 16, True, True), (640, 8, True, True),
    (128, 2, True, True), (960, 12, False, True), (64, 1, False, True), (96, 12, False, True),
    (1536, 16, True, True), (512, 16, True, True), (1280, 10, True, True),
    pytest.param(770, 11, False, True, id="770-11-False-False"),
]


@pytest.mark.parametrize("dim,heads,jax_rule,port_rule", COMPATIBLE_GRID)
def test_fused_qkv_compatible_grid(dim, heads, jax_rule, port_rule):
    assert jax_compatible(dim, heads) == jax_rule
    assert ak.fused_qkv_compatible(dim, heads) == port_rule == (dim % heads == 0)


# Head width 80 (Bird-MAE large and huge): 8 heads, JAX's fused route in one
# 640-lane group; a ragged tile and two tiles and a row, with and without a mask.
H80, D80 = 8, 80
DH80_CASES = [(seq, padded) for seq in (37, 129) for padded in (False, True)]


def _inputs80(rng, seq, padded):
    qkv = rng.standard_normal((B, seq, 3 * H80 * D80)).astype(np.float32)
    cot = rng.standard_normal((B, seq, H80 * D80)).astype(np.float32)
    mask = None
    if padded:
        mask = np.zeros((B, seq), bool)
        mask[1, seq // 3:] = True
    return qkv, cot, mask


@pytest.mark.parametrize("seq,padded", DH80_CASES)
def test_dh80_plain_split_twin_matches_jax_k4(rng, seq, padded):
    qkv, _, mask = _inputs80(rng, seq, padded)
    q, k, v = (np.ascontiguousarray(t.transpose(0, 2, 1, 3))
               for t in np.moveaxis(qkv.reshape(B, seq, 3, H80, D80), 2, 0))
    want = jax_split(_j(q), _j(k), _j(v), None, None, _j(mask), interpret=True)
    got = ak.gated_bias_attention(_t(q), _t(k), _t(v), None, None, _t(mask))
    assert got.shape == (B, H80, seq, D80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("seq,padded", DH80_CASES)
def test_dh80_fused_plain_twin_matches_jax_k5(rng, seq, padded):
    ak.reset_launch_counts()
    qkv, _, mask = _inputs80(rng, seq, padded)
    want = jax_fused_plain(_j(qkv), H80, _j(mask), interpret=True)
    got = ak.fused_qkv_attention(_t(qkv), H80, _t(mask))
    assert got.shape == (B, seq, H80 * D80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sum(ak.LAUNCHES.values()) == 0


@pytest.mark.parametrize("seq,padded", DH80_CASES)
def test_dh80_backward_twin_matches_jax_k6(rng, seq, padded):
    """K6's twin and autograd through K5's twin against ``jax.grad`` through
    ``fused_qkv_attention`` (K6 in interpret mode)."""
    qkv, cot, mask = _inputs80(rng, seq, padded)
    want = jax.grad(lambda x: jnp.sum(jax_fused_plain(x, H80, _j(mask), interpret=True) * cot))(_j(qkv))
    got = ak.fused_qkv_backward_reference(_t(qkv), H80, _t(mask), _t(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    leaf = _t(qkv).requires_grad_()
    (ak.fused_qkv_attention(leaf, H80, _t(mask)) * _t(cot)).sum().backward()
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(want), **TOL)


# T=520 (one head): past the 512 up to which the fp32 K3 keeps its dbias rows
# in shared memory; the twin, as JAX's K3, takes any T.
BACKWARD_CASES = [(seq, gated, padded) for seq in (24, 31) for gated in (True, False) for padded in (False, True)]
BACKWARD_CASES.append((520, True, True))


@pytest.mark.parametrize("seq,gated,padded", BACKWARD_CASES)
def test_gated_backward_twin_matches_jax_k3(rng, seq, gated, padded):
    """K3's twin (dqkv, dbias summed over the batch, dgate) against
    ``jax.grad`` through ``fused_qkv_gated_attention``, whose backward is K3
    in interpret mode. Without a gate there is no dgate."""
    heads = H if seq <= 512 else 1
    qkv, bias, gate, mask = _inputs(rng, seq, gated, padded, heads)
    cot = rng.standard_normal((B, seq, heads * D)).astype(np.float32)

    def loss(x, b, g):
        return jnp.sum(jax_fused(x, heads, b, g, _j(mask), interpret=True) * cot)

    argnums = (0, 1, 2) if gated else (0, 1)
    want = jax.grad(loss, argnums=argnums)(_j(qkv), _j(bias), _j(gate))
    got = ak.fused_qkv_gated_backward_reference(_t(qkv), heads, _t(bias), _t(gate), _t(mask), _t(cot))
    assert (got[2] is None) == (not gated)
    assert got[1].shape == (heads, seq, seq) and got[1].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("seq,padded", PLAIN_CASES)
def test_backward_twin_matches_jax_k6(rng, seq, padded):
    """K6's twin against ``jax.grad`` through ``fused_qkv_attention`` (K6 in
    interpret mode)."""
    qkv, _, _, mask = _inputs(rng, seq, False, padded)
    cot = rng.standard_normal((B, seq, H * D)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jax_fused_plain(x, H, _j(mask), interpret=True) * cot))(_j(qkv))
    got = ak.fused_qkv_backward_reference(_t(qkv), H, _t(mask), _t(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("gated,padded", [(g, p) for g in (True, False) for p in (False, True)])
def test_backward_twins_match_autograd_of_forward_twins(rng, gated, padded):
    """Each backward twin, step by step, against torch.autograd through its
    forward twin (fp32; the bf16 twin as well, to the bf16 rounding)."""
    seq = 31
    qkv, bias, gate, mask = _inputs(rng, seq, gated, padded)
    cot = _t(rng.standard_normal((B, seq, H * D)).astype(np.float32))
    leaves = [_t(x).requires_grad_() for x in (qkv, bias)] + ([_t(gate).requires_grad_()] if gated else [])
    out = ak.fused_qkv_gated_reference(leaves[0], H, leaves[1], leaves[2] if gated else None, _t(mask))
    want = torch.autograd.grad(out, leaves, cot)
    got = ak.fused_qkv_gated_backward_reference(_t(qkv), H, _t(bias), _t(gate), _t(mask), cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    plain = _t(qkv).requires_grad_()
    (want_plain,) = torch.autograd.grad(ak.fused_qkv_reference(plain, H, _t(mask)), plain, cot)
    torch.testing.assert_close(ak.fused_qkv_backward_reference(_t(qkv), H, _t(mask), cot), want_plain, **TOL)
    # bf16: P and dS rounded to bf16 as K3 rounds them; within bf16 of fp32
    got16 = ak.fused_qkv_gated_backward_reference(_t(qkv).bfloat16(), H, _t(bias), _t(gate), _t(mask),
                                                  cot.bfloat16())
    assert got16[0].dtype == torch.bfloat16 and got16[1].dtype == torch.float32
    rel = float((got16[0].float() - want[0]).norm() / want[0].norm())
    assert rel < 2e-2


def test_fused_wrappers_differentiate_through_the_twins_on_cpu(rng):
    """On CPU tensors the wrappers launch nothing, forward or backward."""
    qkv, bias, gate, mask = _inputs(rng, 24, True, True)
    ak.reset_launch_counts()
    leaf = _t(qkv).requires_grad_()
    ak.fused_qkv_gated_attention(leaf, H, _t(bias), _t(gate), _t(mask)).sum().backward()
    ak.fused_qkv_attention(leaf, H, _t(mask)).sum().backward()
    assert leaf.grad is not None and sum(ak.LAUNCHES.values()) == 0
    assert set(ak.LAUNCHES) >= {"fused_qkv_gated_attention_backward", "fused_qkv_attention_backward"}


def test_tensor_core_dispatch_by_type():
    """Every bf16 call, forward (K1, K2, K4, K5) or backward (K3, K6), runs on
    the tensor cores; every fp32 call, forward or backward, on them in
    3xTF32 at every width and row alignment; no other type has a body."""
    assert ak.kernel_body(torch.bfloat16) == "bf16"
    assert ak.kernel_body(torch.float32) == "tf32x3"
    for dtype in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError):
            ak.kernel_body(dtype)
