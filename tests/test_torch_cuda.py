"""The port's CUDA kernels on the card, against their plain twins.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. This file imports no JAX, so it also runs on a
machine without it:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from avex_tpu_torch.ops import attention_kernels as ak
from avex_tpu_torch.ops import int8_kernels as ik
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


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
                           "plain_attention": 0, "fused_qkv_attention": 0,
                           "fused_qkv_gated_attention_backward": 0, "fused_qkv_attention_backward": 0}
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
                           "plain_attention": 1, "fused_qkv_attention": 1,
                           "fused_qkv_gated_attention_backward": 0, "fused_qkv_attention_backward": 0}
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


# (B, T): one ragged tile; BEATs' T=248 with several items per dbias chunk;
# T=520 and 800, past the 512 up to which the fp32 K3 keeps its dbias rows in
# shared memory (beyond, they are added in device memory).
BACKWARD_SHAPES = [(2, 31), (16, 248), (2, 520), (2, 800)]


@pytest.mark.parametrize("shape", BACKWARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", ["gated", "bias_only", "bias_free"])
@pytest.mark.parametrize("padded", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_backward_kernels_match_twins(card, shape, variant, padded, dtype):
    """K3 (gated, and with a bias but no gate) and K6 (bias-free) against
    their backward twins: dqkv, dbias and dgate, one launch per backward."""
    bsz, seq = shape
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda").to(dtype).requires_grad_()
    bias = torch.randn(H, seq, seq, generator=card, device="cuda").requires_grad_()
    gate = (torch.rand(bsz, H, seq, generator=card, device="cuda") * 2 + 1).requires_grad_()
    mask = None
    if padded:
        mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
        mask[1::2, seq // 2:] = True
    dout = torch.randn(bsz, seq, H * D, generator=card, device="cuda").to(dtype)
    ak.reset_launch_counts()
    if variant == "bias_free":
        out = ak.fused_qkv_attention(qkv, H, mask)
        (got,) = torch.autograd.grad(out, (qkv,), dout)
        want = ak.fused_qkv_backward_reference(qkv.detach(), H, mask, dout)
        pairs, key = [(got, want)], "fused_qkv_attention_backward"
    else:
        g = gate if variant == "gated" else None
        out = ak.fused_qkv_gated_attention(qkv, H, bias, g, mask)
        inputs = (qkv, bias, g) if g is not None else (qkv, bias)
        got = torch.autograd.grad(out, inputs, dout)
        want = ak.fused_qkv_gated_backward_reference(
            qkv.detach(), H, bias.detach(), None if g is None else g.detach(), mask, dout)
        pairs, key = list(zip(got, want)), "fused_qkv_gated_attention_backward"
    torch.cuda.synchronize()
    assert ak.LAUNCHES[key] == 1 and sum(ak.LAUNCHES.values()) == 2
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:  # bf16 inputs: one rounding of each bf16 output, sums in another order
            assert float((a.float() - b.float()).norm() / b.float().norm()) < 5e-3


@pytest.mark.parametrize("seq", [520, 800])
@pytest.mark.parametrize("variant", ["gated", "bias_free"])
@pytest.mark.parametrize("padded", [False, True], ids=["nomask", "mask"])
def test_fp32_fma_backward_on_narrow_rows_past_512(card, seq, variant, padded):
    """fp32 K3 and K6 on narrow rows (a row stride of 3E + 1 floats) past
    T=512: the 3xTF32 forward on narrow rows saves its row log-sum-exp and
    the 3xTF32 backward runs from it (the FMA body ran both here before the
    3xTF32 kernels took every width); against the twins."""
    bsz = 2
    store = torch.zeros(bsz, seq, 3 * H * D + 1, device="cuda", requires_grad=True)
    values = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda")
    with torch.no_grad():
        store[..., 1:].copy_(values)
    qkv = store[..., 1:]
    bias = torch.randn(H, seq, seq, generator=card, device="cuda").requires_grad_()
    gate = (torch.rand(bsz, H, seq, generator=card, device="cuda") * 2 + 1).requires_grad_()
    mask = None
    if padded:
        mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
        mask[1::2, seq // 2:] = True
    dout = torch.randn(bsz, seq, H * D, generator=card, device="cuda")
    ak.reset_launch_counts()
    if variant == "bias_free":
        out = ak.fused_qkv_attention(qkv, H, mask)
        got = torch.autograd.grad(out, (qkv,), dout)
        want = (ak.fused_qkv_backward_reference(values, H, mask, dout),)
        key = "fused_qkv_attention_backward"
    else:
        out = ak.fused_qkv_gated_attention(qkv, H, bias, gate, mask)
        got = torch.autograd.grad(out, (qkv, bias, gate), dout)
        want = ak.fused_qkv_gated_backward_reference(values, H, bias.detach(), gate.detach(), mask, dout)
        key = "fused_qkv_gated_attention_backward"
    torch.cuda.synchronize()
    assert ak.LAUNCHES[key] == 1 and ak.BACKWARD_BODIES == {"bf16": 0, "tf32x3": 1}
    assert ak.FORWARD_BODIES == {"bf16": 0, "tf32x3": 1}
    for a, b in zip(got, want):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_unsupported_inputs_raise(inputs):
    """What the kernels refuse: a head width below 1, a gate without a bias,
    a head dimension that is not contiguous, half precision. (A head width
    such as 20 and rows of stride 65 run: ``tests/test_torch_wide_heads.py``.)"""
    qkv, bias, gate, mask = inputs
    q, k, v = _split(qkv)
    with pytest.raises(ValueError, match="head_dim"):
        ak.gated_bias_attention(q[..., :0], k[..., :0], v[..., :0], bias, scale=1.0)
    with pytest.raises(ValueError, match="head_dim"):
        ak.fused_qkv_attention(qkv[..., :0], H, scale=1.0)  # dh=0
    with pytest.raises(ValueError, match="gate"):
        ak.gated_bias_attention(q, k, v, None, gate)
    with pytest.raises(ValueError, match="contiguous head dimension"):
        cols = torch.randn(B, H, D, T, device="cuda").transpose(-1, -2)  # head dimension of stride T
        ak.gated_bias_attention(cols, cols, cols, bias)
    with pytest.raises(TypeError):
        ak.gated_bias_attention(q.half(), k.half(), v.half(), bias)
    with pytest.raises(TypeError):
        ak.fused_qkv_attention(qkv.half(), H)




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


# The bf16 bias-free kernels on the tensor cores (K5, K6 and K4 in bf16):
# T = 1, one ragged tile, one full tile and a row, AVES's and EAT's; B = 2
# and 16; no mask, a mask on every other item, and that mask with item 0's
# keys all padded (NaN there, as the twin's softmax gives).
TC_SEQS = [1, 31, 65, 249, 513]
TC_MASKS = ["nomask", "mask", "padded_row"]


def _tc_mask(kind, bsz, seq):
    if kind == "nomask":
        return None
    mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
    mask[1::2, (seq + 1) // 2:] = True
    if kind == "padded_row":
        mask[0] = True
    return mask


def _close_bf16(got, want):
    """NaN exactly where the twin has NaN; elsewhere relative L2 < 5e-3 (one
    bf16 rounding of P, dS and the output, sums in another order)."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    g, w = got.float()[~nan], want.float()[~nan]
    assert float((g - w).norm() / w.norm()) < 5e-3


@pytest.mark.parametrize("seq", TC_SEQS)
@pytest.mark.parametrize("bsz", [2, 16])
@pytest.mark.parametrize("masking", TC_MASKS)
def test_tensor_core_forward_matches_twin(card, seq, bsz, masking):
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda").bfloat16()
    mask = _tc_mask(masking, bsz, seq)
    ak.reset_launch_counts()
    with torch.no_grad():
        got = ak.fused_qkv_attention(qkv, H, mask)
    want = ak.fused_qkv_reference(qkv, H, mask)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_qkv_attention"] == 1 and sum(ak.LAUNCHES.values()) == 1
    _close_bf16(got, want)


@pytest.mark.parametrize("seq", TC_SEQS)
@pytest.mark.parametrize("bsz", [2, 16])
@pytest.mark.parametrize("masking", TC_MASKS)
def test_tensor_core_backward_matches_twins(card, seq, bsz, masking):
    """K6 from the forward's residuals against the backward twin and against
    the twin of its own contract (P from the LSE, Δ from the output)."""
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda").bfloat16().requires_grad_()
    dout = torch.randn(bsz, seq, H * D, generator=card, device="cuda").bfloat16()
    mask = _tc_mask(masking, bsz, seq)
    ak.reset_launch_counts()
    out = ak.fused_qkv_attention(qkv, H, mask)
    (got,) = torch.autograd.grad(out, (qkv,), dout)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_qkv_attention"] == 1 and ak.LAUNCHES["fused_qkv_attention_backward"] == 1
    _close_bf16(got, ak.fused_qkv_backward_reference(qkv.detach(), H, mask, dout))
    _, lse, rest = ak._fused_qkv_forward_lse_reference(qkv.detach(), H, mask)
    _close_bf16(got, ak.fused_qkv_backward_from_residuals_reference(qkv.detach(), out.detach(), lse, mask, dout,
                                                                    out_rest=rest)[0])


def test_tensor_core_forward_writes_residuals_only_under_grad(card, monkeypatch):
    """Under grad the bf16 forward writes the LSE (held to the twin's) and
    the output's rounding rest (below half a bf16 ulp of the output); the
    fp32 forward the LSE alone, for the 3xTF32 backward (its output is not
    rounded)."""
    bsz, seq = 2, 65
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda").bfloat16().requires_grad_()
    mask = _tc_mask("mask", bsz, seq)
    written = []
    launch = ak._launch
    monkeypatch.setattr(ak, "_launch", lambda *args: written.append(args[8]) or launch(*args))
    out = ak.fused_qkv_attention(qkv, H, mask)
    *_, rest, lse = out.grad_fn.saved_tensors
    _, want, _ = ak._fused_qkv_forward_lse_reference(qkv.detach(), H, mask)
    assert written[-1] is not None and lse.dtype == torch.float32 and lse.shape == (bsz, H, seq)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    assert rest.shape == out.shape and rest.dtype == torch.bfloat16 and rest.any()
    assert bool((rest.float().abs() <= out.detach().float().abs() * 2.0**-8).all())
    with torch.no_grad():
        assert ak.fused_qkv_attention(qkv, H, mask).grad_fn is None
    ak.fused_qkv_attention(qkv.detach(), H, mask)  # grad mode on, nothing requires grad
    fp32 = ak.fused_qkv_attention(qkv.detach().float().requires_grad_(), H, mask)  # fp32: the LSE alone
    assert len(written) == 4 and written[1:3] == [None, None]
    assert written[3][0] is not None and written[3][1] is None
    torch.testing.assert_close(fp32.grad_fn.saved_tensors[-1], want, atol=1e-4, rtol=1e-5)


def test_k4_split_views_in_bf16_take_the_tensor_core_kernel(card, monkeypatch):
    bsz, seq = 2, 65
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda")
    mask = _tc_mask("mask", bsz, seq)
    sources = []
    for name in ("_tensor_core_library", "_tf32x3_library"):
        real = getattr(ak, name)
        monkeypatch.setattr(ak, name, lambda *args, real=real, name=name: sources.append(name) or real(*args))
    ak.reset_launch_counts()
    with torch.no_grad():
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.bfloat16().view(bsz, seq, 3, H, D).unbind(2))
        _close_bf16(ak.gated_bias_attention(q, k, v, None, None, mask),
                    ak.gated_bias_attention_reference(q, k, v, None, None, mask))
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, H, D).unbind(2))
        ak.gated_bias_attention(q, k, v, None, None, mask)
    torch.cuda.synchronize()
    assert sources == ["_tensor_core_library", "_tf32x3_library"] and ak.LAUNCHES["plain_attention"] == 2


def test_tensor_core_head_width_other_than_64_raises(card):
    """A bf16 call at dh=20, which this test once saw refused, runs on the
    tensor-core kernels through narrow rows: K5 and its backward K6, and K4,
    against their twins."""
    ak.reset_launch_counts()
    qkv = torch.randn(2, 31, 3 * H * 20, generator=card, device="cuda").to(torch.bfloat16).requires_grad_()
    dout = torch.randn(2, 31, H * 20, generator=card, device="cuda").to(torch.bfloat16)
    out = ak.fused_qkv_attention(qkv, H)
    _close_bf16(out.detach(), ak.fused_qkv_reference(qkv.detach(), H))
    (got,) = torch.autograd.grad(out, (qkv,), dout)
    _close_bf16(got, ak.fused_qkv_backward_reference(qkv.detach(), H, None, dout))
    q = torch.randn(2, H, 31, 20, generator=card, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        _close_bf16(ak.gated_bias_attention(q, q, q, None), ak.gated_bias_attention_reference(q, q, q, None))
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_qkv_attention"] == ak.LAUNCHES["fused_qkv_attention_backward"] == 1
    assert ak.LAUNCHES["plain_attention"] == 1


# The bf16 gated forward on the tensor cores (K1 and K2 in bf16): the
# bias-free kernels' sequences plus BEATs' T=248 and T=250 (even, not a
# multiple of 4: no 16-byte bias rows); with the gate and with a bias alone.
TC_GATED_SEQS = [1, 31, 65, 248, 250, 513]


@pytest.mark.parametrize("seq", TC_GATED_SEQS)
@pytest.mark.parametrize("bsz", [2, 16])
@pytest.mark.parametrize("masking", TC_MASKS)
@pytest.mark.parametrize("gated", [True, False], ids=["gate", "bias_only"])
def test_tensor_core_gated_forward_matches_twins(card, seq, bsz, masking, gated):
    """K1 on split views and K2 on the raw [B, T, 3E] projection, whose gate
    is a transposed view as BEATs hands it over; one launch each."""
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda").bfloat16()
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, H, D).unbind(2))
    bias = torch.randn(H, seq, seq, generator=card, device="cuda")
    gate = (torch.rand(bsz, seq, H, generator=card, device="cuda") * 2 + 1).permute(0, 2, 1) if gated else None
    mask = _tc_mask(masking, bsz, seq)
    ak.reset_launch_counts()
    with torch.no_grad():
        split = ak.gated_bias_attention(q, k, v, bias, gate, mask)
        torch.cuda.synchronize()
        assert ak.LAUNCHES["gated_bias_attention"] == 1 and sum(ak.LAUNCHES.values()) == 1
        fused = ak.fused_qkv_gated_attention(qkv, H, bias, gate, mask)
        torch.cuda.synchronize()
        assert ak.LAUNCHES["fused_qkv_gated_attention"] == 1 and sum(ak.LAUNCHES.values()) == 2
    _close_bf16(split, ak.gated_bias_attention_reference(q, k, v, bias, gate, mask))
    _close_bf16(fused, ak.fused_qkv_gated_reference(qkv, H, bias, gate, mask))
    assert split.transpose(1, 2).is_contiguous()  # written as [B, T, H, D], returned as a [B, H, T, D] view


def test_gated_forward_dispatch_by_type(card, monkeypatch):
    """bf16 gated calls load the tensor-core source, fp32 ones at dh 64 the
    3xTF32 source (within 1e-4 of the twin); the bf16 gated backward (K3)
    runs on the tensor cores too."""
    bsz, seq = 2, 65
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda")
    bias = torch.randn(H, seq, seq, generator=card, device="cuda")
    gate = torch.rand(bsz, H, seq, generator=card, device="cuda") + 1
    mask = _tc_mask("mask", bsz, seq)
    sources = []
    for name in ("_tensor_core_library", "_tf32x3_library"):
        real = getattr(ak, name)
        monkeypatch.setattr(ak, name, lambda *args, real=real, name=name: sources.append(name) or real(*args))
    with torch.no_grad():
        ak.fused_qkv_gated_attention(qkv.bfloat16(), H, bias, gate, mask)
        got = ak.fused_qkv_gated_attention(qkv, H, bias, gate, mask)
    torch.cuda.synchronize()
    assert sources == ["_tensor_core_library", "_tf32x3_library"]
    torch.testing.assert_close(got, ak.fused_qkv_gated_reference(qkv, H, bias, gate, mask), atol=1e-4, rtol=1e-4)
    leaf = qkv.bfloat16().requires_grad_()
    sources.clear()
    ak.fused_qkv_gated_attention(leaf, H, bias, gate, mask).sum().backward()
    torch.cuda.synchronize()
    assert sources == ["_tensor_core_library", "_tensor_core_library"] and leaf.grad is not None


# The bf16 gated backward on the tensor cores (K3 in bf16): the forward's
# sequences, and past the fp32 body's T <= 512 (800, 1024); with the gate and
# with a bias alone. dqkv, dbias and dgate against the twin of the kernel's
# contract on the forward's own residuals (P from the saved LSE, Δ from the
# output and its rounding rest) and against the twin that recomputes the
# softmax; NaN exactly where the twins have NaN (item 0 all padded: its rows,
# and dbias).
TC_GATED_BACKWARD_SEQS = [1, 31, 65, 248, 250, 513, 800, 1024]


def _close_grads(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    if nan.all():
        return
    g, w = got.float()[~nan], want.float()[~nan]
    if float(w.abs().max()) <= 1e-4:  # T = 1: one key's softmax has no gradient, both are rounding
        assert float(g.abs().max()) <= 1e-4
    else:
        assert float((g - w).norm() / w.norm()) < 5e-3


@pytest.mark.parametrize("seq", TC_GATED_BACKWARD_SEQS)
@pytest.mark.parametrize("bsz", [2, 16])
@pytest.mark.parametrize("masking", TC_MASKS)
@pytest.mark.parametrize("gated", [True, False], ids=["gate", "bias_only"])
def test_tensor_core_gated_backward_matches_twins(card, seq, bsz, masking, gated):
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda").bfloat16().requires_grad_()
    bias = torch.randn(H, seq, seq, generator=card, device="cuda").requires_grad_()
    gate = ((torch.rand(bsz, seq, H, generator=card, device="cuda") * 2 + 1).permute(0, 2, 1).requires_grad_()
            if gated else None)
    dout = torch.randn(bsz, seq, H * D, generator=card, device="cuda").bfloat16()
    mask = _tc_mask(masking, bsz, seq)
    ak.reset_launch_counts()
    out = ak.fused_qkv_gated_attention(qkv, H, bias, gate, mask)
    *_, saved_out, rest, lse = out.grad_fn.saved_tensors  # K2's residuals
    got = torch.autograd.grad(out, (qkv, bias, gate) if gated else (qkv, bias), dout)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_qkv_gated_attention"] == 1 and ak.LAUNCHES["fused_qkv_gated_attention_backward"] == 1
    assert sum(ak.LAUNCHES.values()) == 2
    q32, b32 = qkv.detach(), bias.detach()
    g32 = gate.detach() if gated else None
    own = ak.fused_qkv_backward_from_residuals_reference(q32, saved_out, lse, mask, dout, out_rest=rest,
                                                         pos_bias=b32, gate=g32)
    plain = ak.fused_qkv_gated_backward_reference(q32, H, b32, g32, mask, dout)
    for a, b, c in zip(got, own, plain):
        _close_grads(a, b)
        _close_grads(a, c)


def test_tensor_core_gated_forward_writes_residuals_only_under_grad(card, monkeypatch):
    """Under grad the bf16 gated forward (K2) writes the LSE (held to the
    twin's) and the output's rounding rest; with no grad, nothing."""
    bsz, seq = 2, 65
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda").bfloat16().requires_grad_()
    bias = torch.randn(H, seq, seq, generator=card, device="cuda")
    gate = torch.rand(bsz, H, seq, generator=card, device="cuda") + 1
    mask = _tc_mask("mask", bsz, seq)
    written = []
    launch = ak._launch
    monkeypatch.setattr(ak, "_launch", lambda *args: written.append(args[8]) or launch(*args))
    out = ak.fused_qkv_gated_attention(qkv, H, bias, gate, mask)
    *_, rest, lse = out.grad_fn.saved_tensors
    _, want, _ = ak._fused_qkv_forward_lse_reference(qkv.detach(), H, mask, None, bias, gate)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=1e-5)
    assert rest.shape == out.shape and rest.dtype == torch.bfloat16 and rest.any()
    with torch.no_grad():
        ak.fused_qkv_gated_attention(qkv, H, bias, gate, mask)
    assert written[0] is not None and written[1:] == [None]


# K7 at the main path's shapes: M = 1, one clip (248) and a B=128 batch
# (31,744) at BEATs' (K, N) = (768, 3072) and (3072, 768), and a K = 96 tail.
K7_SHAPES = [(m, k, n) for m in (1, 248, 31_744) for k, n in ((768, 3072), (3072, 768))] + [(248, 96, 768)]


@pytest.mark.parametrize("shape", K7_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("use_bias", [False, True], ids=["nobias", "bias"])
def test_int8_dynamic_dense_steps_match_twins(card, shape, dtype, use_bias):
    """K7's two kernels: the row quantization equals ``quantize_rows``, the
    scaled wgmma product equals ``scaled_product_reference`` on those levels,
    and the whole equals the one-step twin, bit for bit."""
    m, k, n = shape
    x = torch.randn(m, k, generator=card, device="cuda").to(dtype)
    x[m // 2] = 0.0
    wq, scale = _int8_weight(n, k, card)
    bias = torch.randn(n, generator=card, device="cuda") if use_bias else None
    xq, row_scale = ik._quantize_rows_kernel(x)
    levels, want_scale = ik.quantize_rows(x)
    assert torch.equal(xq, levels.to(torch.int8)) and torch.equal(row_scale, want_scale[:, 0])
    product = ik._scaled_product_kernel(xq, row_scale, wq, scale, bias, dtype)
    assert torch.equal(product, ik.scaled_product_reference(xq, row_scale, wq, scale, bias, dtype))
    ik.reset_launch_counts()
    got = ik.int8_dynamic_dense(x, wq, scale, bias)
    torch.cuda.synchronize()
    assert ik.LAUNCHES == {"int8_dynamic_dense": 1, "int8_matmul": 0}
    assert torch.equal(got, ik.int8_dynamic_dense_reference(x, wq, scale, bias))


# Probes over a small BEATs on the card: 2 layers, 128-d, 2 heads (dh 64).
PROBE_BEATS = {"encoder_layers": 2, "encoder_embed_dim": 128, "encoder_ffn_embed_dim": 256,
               "encoder_attention_heads": 2, "embed_dim": 32, "dropout": 0.0, "attention_dropout": 0.0,
               "encoder_layerdrop": 0.0, "use_pallas": True}


def _probe_step(card, dtype, freeze, **init):
    """One FineTuneTrainer step of an attention probe over two layers of a
    small BEATs; returns (launch counts of the step, trainer, batch)."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec, TrainingParams
    from avex_tpu_torch.evaluation import FineTuneTrainer
    from avex_tpu_torch.probes import build_probe_from_config

    spec = ModelSpec(name="beats", pretrained=False, compute_dtype=dtype, init_config=dict(PROBE_BEATS, **init),
                     audio_config={"representation": "raw", "normalize": False, "target_length_seconds": 1})
    model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda")
    probe = build_probe_from_config(dict(probe_type="attention", aggregation="none", target_layers=[1, "last_layer"],
                                         num_heads=4, num_layers=1, dropout_rate=0.0, freeze_backbone=freeze),
                                    num_classes=3, base_model=model)
    trainer = FineTuneTrainer(probe, TrainingParams(train_epochs=1, lr=1e-3, batch_size=4), mode="online")
    trainer._init_optimizer(1)
    batch = {"raw_wav": torch.randn(4, 16000, generator=card, device="cuda") * 0.1,
             "label": torch.tensor([0, 1, 2, 0], device="cuda")}
    ak.reset_launch_counts()
    loss, _ = trainer._train_step(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    return dict(ak.LAUNCHES), trainer, batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frozen_probe_launches_k1_and_no_backward(card, dtype):
    counts, trainer, _ = _probe_step(card, dtype, freeze=True)
    assert {k: v for k, v in counts.items() if v} == {"gated_bias_attention": 2}
    assert not any(k.startswith("backbone.") for k in trainer._trainable)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unfrozen_fused_probe_launches_k2_and_k3(card, dtype):
    counts, trainer, _ = _probe_step(card, dtype, freeze=False, fused_qkv=True)
    assert {k: v for k, v in counts.items() if v} == {"fused_qkv_gated_attention": 2,
                                                        "fused_qkv_gated_attention_backward": 2}
    assert any(k.startswith("backbone.") for k in trainer._trainable)


def test_retrieval_similarity_on_the_card_matches_the_cpu(card, monkeypatch):
    """Retrieval over the extraction loop's numpy output computes its
    similarities on the card by default, and agrees with the CPU's."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.evaluation import compute_embeddings, eval_retrieval, eval_retrieval_cross_set
    from avex_tpu_torch.evaluation import retrieval

    spec = ModelSpec(name="beats", pretrained=False, compute_dtype="float32", init_config=PROBE_BEATS,
                     audio_config={"representation": "raw", "normalize": False, "target_length_seconds": 1})
    model = avex_tpu_torch.load_model(spec, random_weights=True, return_features_only=True, device="cuda")
    batches = [{"raw_wav": torch.randn(8, 16000, generator=card, device="cuda") * 0.1,
                "label": torch.randint(0, 3, (8,), generator=card, device="cuda")} for _ in range(3)]
    (embs,), labels = compute_embeddings(model, batches, aggregation="mean", layers=["last_layer"])
    assert isinstance(embs, np.ndarray) and embs.shape == (24, 128) and isinstance(labels, np.ndarray)

    products = []
    similarity = retrieval.cosine_similarity
    monkeypatch.setattr(retrieval, "cosine_similarity",
                        lambda *a, **k: products.append(similarity(*a, **k)) or products[-1])
    same = eval_retrieval(embs, labels)
    cross = eval_retrieval_cross_set(embs[:16], labels[:16], embs[16:], labels[16:])
    assert [p.device.type for p in products] == ["cuda", "cuda"]
    torch.testing.assert_close(products[0].cpu(), similarity(embs, embs, device="cpu"), atol=1e-6, rtol=1e-5)
    assert same == pytest.approx(eval_retrieval(embs, labels, device="cpu"), abs=1e-6)
    assert cross == pytest.approx(eval_retrieval_cross_set(embs[:16], labels[:16], embs[16:], labels[16:],
                                                           device="cpu"), abs=1e-6)


# Head width 80 (Bird-MAE large and huge, 16 heads) in the bias-free kernels:
# K5 and K4 forward, K6 backward, bf16 on the tensor cores (80-wide rows at a
# padded shared-memory stride) and fp32 on them in 3xTF32; T from one ragged
# tile to Bird-MAE's 513.
H80, D80 = 16, 80
DH80_SEQS = [1, 31, 129, 513]


def _dh80(card, bsz, seq, dtype, grad=False):
    qkv = torch.randn(bsz, seq, 3 * H80 * D80, generator=card, device="cuda").to(dtype)
    return qkv.requires_grad_() if grad else qkv


def _close(got, want, dtype):
    if dtype == torch.bfloat16:
        _close_bf16(got, want)
    else:
        torch.testing.assert_close(got, want, equal_nan=True, **TOL)  # a fully padded item: NaN on both


@pytest.mark.parametrize("seq", DH80_SEQS)
@pytest.mark.parametrize("masking", TC_MASKS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_head_width_80_forward_kernels_match_twins(card, seq, masking, dtype):
    """K5 on the raw [B, T, 3E] projection and K4 on its split views."""
    bsz = 4
    qkv = _dh80(card, bsz, seq, dtype)
    mask = _tc_mask(masking, bsz, seq)
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, H80, D80).unbind(2))
    ak.reset_launch_counts()
    with torch.no_grad():
        fused = ak.fused_qkv_attention(qkv, H80, mask)
        split = ak.gated_bias_attention(q, k, v, None, None, mask)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_qkv_attention"] == 1 and ak.LAUNCHES["plain_attention"] == 1
    assert sum(ak.LAUNCHES.values()) == 2
    _close(fused, ak.fused_qkv_reference(qkv, H80, mask), dtype)
    _close(split, ak.gated_bias_attention_reference(q, k, v, None, None, mask), dtype)


@pytest.mark.parametrize("seq", DH80_SEQS)
@pytest.mark.parametrize("masking", ["nomask", "mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_head_width_80_backward_kernel_matches_twins(card, seq, masking, dtype):
    """K6 against the backward twin; in bf16 also against the twin of its own
    contract (P from the saved LSE, Δ from the saved output and its rest)."""
    bsz = 4
    qkv = _dh80(card, bsz, seq, dtype, grad=True)
    dout = torch.randn(bsz, seq, H80 * D80, generator=card, device="cuda").to(dtype)
    mask = _tc_mask(masking, bsz, seq)
    ak.reset_launch_counts()
    out = ak.fused_qkv_attention(qkv, H80, mask)
    (got,) = torch.autograd.grad(out, (qkv,), dout)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_qkv_attention"] == 1 and ak.LAUNCHES["fused_qkv_attention_backward"] == 1
    want = ak.fused_qkv_backward_reference(qkv.detach(), H80, mask, dout)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        return
    _close_bf16(got, want)
    _, lse, rest = ak._fused_qkv_forward_lse_reference(qkv.detach(), H80, mask)
    _close_bf16(got, ak.fused_qkv_backward_from_residuals_reference(qkv.detach(), out.detach(), lse, mask, dout,
                                                                    out_rest=rest)[0])


def test_head_width_80_gated_and_other_widths_raise(card):
    """The gated kernels take dh 80 as the bias-free ones do (K2 and K1
    against their twins), and the widths this test once saw refused run too:
    K2 and K1 at dh 84 (narrow rows), K5 at dh 136 (two column chunks)."""
    for dtype in (torch.float32, torch.bfloat16):
        qkv = _dh80(card, 2, 31, dtype)
        bias = torch.randn(H80, 31, 31, generator=card, device="cuda")
        gate = torch.rand(2, H80, 31, generator=card, device="cuda") + 1
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(2, 31, 3, H80, D80).unbind(2))
        with torch.no_grad():
            _close(ak.fused_qkv_gated_attention(qkv, H80, bias, gate),
                   ak.fused_qkv_gated_reference(qkv, H80, bias, gate), dtype)
            _close(ak.gated_bias_attention(q, k, v, bias, gate),
                   ak.gated_bias_attention_reference(q, k, v, bias, gate), dtype)
    torch.cuda.synchronize()
    ak.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(2, 31, 3 * 8 * 84, generator=card, device="cuda").to(dtype)
        bias = torch.randn(8, 31, 31, generator=card, device="cuda")
        q = torch.randn(2, 8, 31, 84, generator=card, device="cuda").to(dtype)
        wide = torch.randn(2, 31, 3 * 8 * 136, generator=card, device="cuda").to(dtype)
        with torch.no_grad():
            _close(ak.fused_qkv_gated_attention(qkv, 8, bias), ak.fused_qkv_gated_reference(qkv, 8, bias), dtype)
            _close(ak.gated_bias_attention(q, q, q, bias), ak.gated_bias_attention_reference(q, q, q, bias), dtype)
            _close(ak.fused_qkv_attention(wide, 8), ak.fused_qkv_reference(wide, 8), dtype)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["fused_qkv_gated_attention"] == ak.LAUNCHES["gated_bias_attention"] == 2
    assert ak.LAUNCHES["fused_qkv_attention"] == 2


# The fp32 forwards on the tensor cores in 3xTF32 (K1, K2, K4, K5 at a head
# width that is a multiple of 8 up to 128 on 16-byte rows), held as
# chip_smoke.py holds them: max|d| 1e-4 and relative L2 1e-5 against the
# plain fp32 twin (TF32 off), NaN exactly where the twin has NaN (the mask
# pads item 0 whole), the row log-sum-exp within 1e-5 of the twin's.
FP32_FORWARD_SEQS = [37, 248, 513]


def _close_fp32(got, want):
    nan = torch.isnan(want)
    assert got.dtype == want.dtype == torch.float32 and torch.equal(torch.isnan(got), nan)
    g, w = got[~nan], want[~nan]
    assert float((g - w).abs().max()) <= 1e-4 and float((g - w).norm() / w.norm()) <= 1e-5


def _fp32_mask(masked, bsz, seq):
    if not masked:
        return None
    mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
    mask[1::3, seq * 2 // 3:] = True
    mask[0] = True
    return mask


@pytest.mark.parametrize("seq", FP32_FORWARD_SEQS)
@pytest.mark.parametrize("bsz", [2, 16])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("layout", ["split", "fused"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "bias_free"])
def test_fp32_forward_on_3xtf32_matches_twin(card, seq, bsz, masked, layout, gated):
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda")
    bias = torch.randn(H, seq, seq, generator=card, device="cuda") if gated else None
    gate = torch.rand(bsz, H, seq, generator=card, device="cuda") + 1 if gated else None
    mask = _fp32_mask(masked, bsz, seq)
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, H, D).unbind(2))
    ak.reset_launch_counts()
    with torch.no_grad():
        if layout == "split":
            got = ak.gated_bias_attention(q, k, v, bias, gate, mask)
            want = ak.gated_bias_attention_reference(q, k, v, bias, gate, mask)
        elif gated:
            got, want = (ak.fused_qkv_gated_attention(qkv, H, bias, gate, mask),
                         ak.fused_qkv_gated_reference(qkv, H, bias, gate, mask))
        else:
            got, want = ak.fused_qkv_attention(qkv, H, mask), ak.fused_qkv_reference(qkv, H, mask)
    torch.cuda.synchronize()
    assert ak.FORWARD_BODIES == {"bf16": 0, "tf32x3": 1} and sum(ak.LAUNCHES.values()) == 1
    _close_fp32(got, want)


@pytest.mark.parametrize("seq", FP32_FORWARD_SEQS)
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "bias_free"])
def test_fp32_forward_on_3xtf32_writes_the_twins_lse(card, seq, masked, gated):
    """Under grad K2 and K5 save the row log-sum-exp for the 3xTF32 backward:
    within 1e-5 of ``_fused_qkv_forward_lse_reference``'s, −inf exactly where
    a row's keys are all padded; and the output with it."""
    bsz = 4
    qkv = torch.randn(bsz, seq, 3 * H * D, generator=card, device="cuda").requires_grad_()
    bias = torch.randn(H, seq, seq, generator=card, device="cuda") if gated else None
    gate = torch.rand(bsz, H, seq, generator=card, device="cuda") + 1 if gated else None
    mask = _fp32_mask(masked, bsz, seq)
    out = ak.fused_qkv_gated_attention(qkv, H, bias, gate, mask) if gated else ak.fused_qkv_attention(qkv, H, mask)
    *_, rest, lse = out.grad_fn.saved_tensors
    want_out, want, _ = ak._fused_qkv_forward_lse_reference(qkv.detach(), H, mask, None, bias, gate)
    torch.cuda.synchronize()
    assert rest is None and lse.dtype == torch.float32 and lse.shape == (bsz, H, seq)
    finite = torch.isfinite(want)
    assert torch.equal(torch.isfinite(lse), finite) and bool((lse[~finite] == float("-inf")).all())
    assert float((lse[finite] - want[finite]).abs().max()) <= 1e-5
    _close_fp32(out.detach(), want_out)


@pytest.mark.parametrize("dh,body", [(64, "tf32x3"), (16, "tf32x3"), (128, "tf32x3"), (12, "tf32x3"), (136, "tf32x3")])
def test_fp32_forward_body_by_width(card, dh, body):
    """Every fp32 forward runs in 3xTF32: 16-byte rows of a multiple of 8 up
    to 128, narrow rows (dh 12) and column chunks (dh 136); every backward
    too; each against its twin."""
    bsz, seq, heads = 2, 37, 3
    qkv = torch.randn(bsz, seq, 3 * heads * dh, generator=card, device="cuda")
    bias = torch.randn(heads, seq, seq, generator=card, device="cuda")
    gate = torch.rand(bsz, heads, seq, generator=card, device="cuda") + 1
    dout = torch.randn(bsz, seq, heads * dh, generator=card, device="cuda")
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, dh).unbind(2))
    ak.reset_launch_counts()
    with torch.no_grad():
        torch.testing.assert_close(ak.gated_bias_attention(q, k, v, bias, gate),
                                   ak.gated_bias_attention_reference(q, k, v, bias, gate), atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(ak.gated_bias_attention(q, k, v, None),
                                   ak.gated_bias_attention_reference(q, k, v, None), atol=1e-4, rtol=1e-4)
    leaf = qkv.clone().requires_grad_()
    out = ak.fused_qkv_attention(leaf, heads)
    torch.testing.assert_close(out.detach(), ak.fused_qkv_reference(qkv, heads), atol=1e-4, rtol=1e-4)
    (got,) = torch.autograd.grad(out, (leaf,), dout)
    torch.testing.assert_close(got, ak.fused_qkv_backward_reference(qkv, heads, None, dout), atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()
    assert ak.FORWARD_BODIES == {"bf16": 0, "tf32x3": 0, body: 3}
    assert ak.BACKWARD_BODIES == {"bf16": 0, "tf32x3": 1}


# The general route's fp32 forwards (narrow rows: a width or a stride that is
# not a multiple of 8, or a base off 16 bytes; column chunks past 128, up to
# three groups of four chunks at dh 1500), held as the 16-byte rows' above.
GENERAL_FP32_WIDTHS = [1, 12, 20, 33, 100, 136, 150, 192, 320, 520, 1500]


@pytest.mark.parametrize("dh", GENERAL_FP32_WIDTHS)
@pytest.mark.parametrize("layout", ["split", "fused", "fused, a row stride of 3E + 1"])
@pytest.mark.parametrize("gated", [True, False], ids=["gated", "bias_free"])
def test_fp32_general_forward_and_lse_match_twin(card, dh, layout, gated):
    """K1/K4 on split views and K2/K5 on ``[B, T, 3E]`` (16-byte or narrow
    rows) at each width: the output against the twin (NaN exactly on the
    all-padded item), and under grad the saved row log-sum-exp within 1e-5
    of the twin's, −inf exactly on its padded rows; every call on the
    3xTF32 forward."""
    bsz, seq, heads = 3, 70 if dh < 1000 else 33, 2
    store = torch.randn(bsz, seq, 3 * heads * dh + 1, generator=card, device="cuda")
    qkv = store[..., 1:] if layout.endswith("3E + 1") else store[..., :-1].contiguous()
    bias = torch.randn(heads, seq, seq, generator=card, device="cuda") if gated else None
    gate = torch.rand(bsz, heads, seq, generator=card, device="cuda") + 1 if gated else None
    mask = _fp32_mask(True, bsz, seq)
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, dh).unbind(2))
    ak.reset_launch_counts()
    with torch.no_grad():
        if layout == "split":
            got, want = (ak.gated_bias_attention(q, k, v, bias, gate, mask),
                         ak.gated_bias_attention_reference(q, k, v, bias, gate, mask))
        elif gated:
            got, want = (ak.fused_qkv_gated_attention(qkv, heads, bias, gate, mask),
                         ak.fused_qkv_gated_reference(qkv, heads, bias, gate, mask))
        else:
            got, want = ak.fused_qkv_attention(qkv, heads, mask), ak.fused_qkv_reference(qkv, heads, mask)
    _close_fp32(got, want)
    leaf = qkv.detach().requires_grad_()
    out = (ak.fused_qkv_gated_attention(leaf, heads, bias, gate, mask) if gated
           else ak.fused_qkv_attention(leaf, heads, mask))
    lse = out.grad_fn.saved_tensors[-1]
    want_out, want_lse, _ = ak._fused_qkv_forward_lse_reference(qkv, heads, mask, None, bias, gate)
    torch.cuda.synchronize()
    assert ak.FORWARD_BODIES == {"bf16": 0, "tf32x3": 2}
    _close_fp32(out.detach(), want_out)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite) and bool((lse[~finite] == float("-inf")).all())
    assert float((lse[finite] - want_lse[finite]).abs().max()) <= 1e-5
