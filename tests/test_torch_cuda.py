"""The port's CUDA kernels on the card, against their plain twins.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. This file imports no JAX, so it also runs on a
machine without it:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from avex_tpu_torch.ops import attention_kernels as ak

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
