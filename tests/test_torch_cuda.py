"""The port's CUDA kernels on the card, against their plain twins.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. This file imports no JAX, so it also runs on a
machine without it:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from avex_tpu_torch.ops import attention_kernels as ak
from avex_tpu_torch.ops import int8_kernels as ik

pytestmark = pytest.mark.cuda

B, H, T, D = 2, 12, 31, 64
# fp32: the kernel's online softmax sums in another order than the twin.
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(B, T, 3 * H * D, generator=gen)
    bias = torch.randn(H, T, T, generator=gen)
    gate = torch.rand(B, H, T, generator=gen) * 2 + 1
    mask = torch.zeros(B, T, dtype=torch.bool)
    mask[1, 20:] = True
    return [t.cuda() for t in (qkv, bias, gate, mask)]


def _split(qkv):
    return [t.permute(0, 2, 1, 3) for t in qkv.view(B, T, 3, H, D).unbind(2)]


def test_kernels_match_twins(inputs):
    qkv, bias, gate, mask = inputs
    q, k, v = _split(qkv)
    ak.reset_launch_counts()
    with torch.no_grad():
        got = ak.gated_bias_attention(q, k, v, bias, gate, mask)
        fused = ak.fused_qkv_gated_attention(qkv, H, bias, gate, mask)
        ref = ak.gated_bias_attention_reference(q, k, v, bias, gate, mask)
    torch.cuda.synchronize()
    assert ak.LAUNCHES == {"gated_bias_attention": 1, "fused_qkv_gated_attention": 1,
                           "plain_attention": 0, "fused_qkv_attention": 0}
    torch.testing.assert_close(got, ref, **TOL)
    torch.testing.assert_close(fused, ref.transpose(1, 2).reshape(B, T, H * D), **TOL)


@pytest.mark.parametrize("padded", [False, True])
def test_bias_free_kernels_match_twins(inputs, padded):
    """K4 (split views) and K5 (the raw [B, T, 3E] projection) at T=31: one
    ragged query tile and one ragged key tile."""
    qkv, _, _, mask = inputs
    mask = mask if padded else None
    q, k, v = _split(qkv)
    ak.reset_launch_counts()
    with torch.no_grad():
        split = ak.gated_bias_attention(q, k, v, None, None, mask)
        fused = ak.fused_qkv_attention(qkv, H, mask)
        ref = ak.gated_bias_attention_reference(q, k, v, None, None, mask)
    torch.cuda.synchronize()
    assert ak.LAUNCHES == {"gated_bias_attention": 0, "fused_qkv_gated_attention": 0,
                           "plain_attention": 1, "fused_qkv_attention": 1}
    torch.testing.assert_close(split, ref, **TOL)
    torch.testing.assert_close(fused, ak.fused_qkv_reference(qkv, H, mask), **TOL)
    torch.testing.assert_close(fused, ref.transpose(1, 2).reshape(B, T, H * D), **TOL)


def test_bias_free_split_kernel_backward_is_the_twins(inputs):
    qkv, _, _, mask = inputs
    leaves = [t.detach().clone().requires_grad_() for t in _split(qkv)]
    twins = [t.detach().clone().requires_grad_() for t in leaves]
    cot = torch.randn(B, H, T, D, device="cuda")
    (ak.gated_bias_attention(*leaves, None, None, mask) * cot).sum().backward()
    (ak.gated_bias_attention_reference(*twins, None, None, mask) * cot).sum().backward()
    for a, b in zip(leaves, twins):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


def test_split_kernel_backward_is_the_twins(inputs):
    qkv, bias, gate, mask = inputs
    leaves = [t.detach().clone().requires_grad_() for t in (*_split(qkv), bias, gate)]
    twins = [t.detach().clone().requires_grad_() for t in leaves]
    cot = torch.randn(B, H, T, D, device="cuda")
    (ak.gated_bias_attention(*leaves, mask) * cot).sum().backward()
    (ak.gated_bias_attention_reference(*twins, mask) * cot).sum().backward()
    for a, b in zip(leaves, twins):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-4, rtol=1e-4)


def test_unsupported_inputs_raise(inputs):
    qkv, bias, gate, mask = inputs
    q, k, v = _split(qkv)
    with pytest.raises(NotImplementedError, match="K3"):
        ak.fused_qkv_gated_attention(qkv.detach().requires_grad_(), H, bias, gate)
    with pytest.raises(NotImplementedError, match="K6"):
        ak.fused_qkv_attention(qkv.detach().requires_grad_(), H)
    with pytest.raises(ValueError, match="head_dim"):
        ak.gated_bias_attention(q[..., :32], k[..., :32], v[..., :32], bias)
    with pytest.raises(ValueError, match="head_dim"):
        ak.fused_qkv_attention(qkv[..., : 3 * H * 32], H)  # dh=32
    with pytest.raises(ValueError, match="gate"):
        ak.gated_bias_attention(q, k, v, None, gate)
    with pytest.raises(ValueError, match="strides"):
        odd_rows = torch.randn(B, H, T, D + 1, device="cuda")[..., :D]  # token stride 65
        ak.gated_bias_attention(odd_rows, k, v, bias)
    with pytest.raises(TypeError):
        ak.gated_bias_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(TypeError):
        ak.fused_qkv_attention(qkv.half(), H)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _int8_weight(n, k, gen):
    wq = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(n, generator=gen, device="cuda") * 0.01 + 1e-3
    return wq, scale


# (M, K, N): a ragged M tile, a half K tile (K = 96), a ragged and an odd N.
INT8_SHAPES = [(200, 96, 136), (130, 256, 131), (1, 768, 768)]


@pytest.mark.parametrize("shape", INT8_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
def test_int8_dynamic_dense_matches_twin(card, shape, dtype, use_bias):
    """K7: the int8 activations and sums equal the twin's, and so does the
    output (same rounding at each step), in fp32 and bf16; zero rows stay 0."""
    m, k, n = shape
    x = torch.randn(m, k, generator=card, device="cuda").to(dtype)
    x[m // 2] = 0.0
    wq, scale = _int8_weight(n, k, card)
    bias = torch.randn(n, generator=card, device="cuda") if use_bias else None
    ik.reset_launch_counts()
    got = ik.int8_dynamic_dense(x, wq, scale, bias)
    want = ik.int8_dynamic_dense_reference(x, wq, scale, bias)
    torch.cuda.synchronize()
    assert ik.LAUNCHES == {"int8_dynamic_dense": 1, "int8_matmul": 0}
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, want), float((got.float() - want.float()).abs().max())
    if not use_bias:
        assert not got[m // 2].any()


def test_int8_dynamic_dense_leading_dims_and_out_dtype(card):
    x = torch.randn(3, 24, 128, generator=card, device="cuda", dtype=torch.bfloat16)
    wq, scale = _int8_weight(64, 128, card)
    got = ik.int8_dynamic_dense(x, wq, scale, out_dtype=torch.float32)
    want = ik.int8_dynamic_dense_reference(x, wq, scale, out_dtype=torch.float32)
    assert got.shape == (3, 24, 64) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(50, 96, 48), (300, 256, 272), (248, 768, 3072)],
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_matmul_exact(card, shape):
    """K8: exact int32 sums, with ragged M and a half K tile; B as [K, N]."""
    m, k, n = shape
    xq = torch.randint(-127, 128, (m, k), generator=card, device="cuda", dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=card, device="cuda", dtype=torch.int8)
    ik.reset_launch_counts()
    got = ik.int8_matmul(xq, wq)
    torch.cuda.synchronize()
    assert ik.LAUNCHES == {"int8_dynamic_dense": 0, "int8_matmul": 1}
    assert got.dtype == torch.int32
    assert torch.equal(got, ik.int8_matmul_reference(xq, wq))


def test_int8_unsupported_inputs_raise(card):
    wq, scale = _int8_weight(64, 80, card)
    with pytest.raises(ValueError, match="multiple of 32"):
        ik.int8_dynamic_dense(torch.randn(4, 80, device="cuda"), wq, scale)
    wq, scale = _int8_weight(64, 96, card)
    with pytest.raises(TypeError):
        ik.int8_dynamic_dense(torch.randn(4, 96, device="cuda").half(), wq, scale)
    with pytest.raises(NotImplementedError, match="inference-only"):
        ik.int8_dynamic_dense(torch.randn(4, 96, device="cuda", requires_grad=True), wq, scale)
    with pytest.raises(ValueError, match="weight_scale"):
        ik.int8_dynamic_dense(torch.randn(4, 96, device="cuda"), wq, scale.double())
    xq = torch.zeros(4, 64, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        ik.int8_matmul(xq, torch.zeros(64, 40, dtype=torch.int8, device="cuda"))
