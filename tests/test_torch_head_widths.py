"""The attention kernels at the head widths other than 64 and 80, against JAX.

Every kernel of the port (K1-K6, gated or not) takes any head width D >= 1
(``attention_kernels.width_plan``); each CUDA source is built for 32, 64,
80, 96 and 128, a width up to 128 runs on the smallest build that holds it
and a wider one in column chunks (``tests/test_torch_wide_heads.py`` holds
the widths that are not a multiple of 8 or are above 128). On the CPU the wrappers take their plain twins, held
here against JAX's Pallas kernels in interpret mode (which take any head
count) at dh 8, 16, 32, 96 and 128: the split (K1, K4) and fused (K2, K5)
forwards, the backward twins of K3 and K6 and the twin of the bf16 K3's and
K6's own contract (P from the saved log-sum-exp, Δ from the saved output)
against ``jax.grad``; then 2-layer BEATs at dh 16 and 128 and a 2-block EAT
at dh 32 with ``use_pallas=True``, port against JAX with the same weights;
then the width rule. The tolerances are those of the dh-80 tests
(``tests/test_torch_attention_kernels.py``).

JAX is imported inside the CPU tests only, so the ``cuda`` tests at the end
(the kernels at each width against their twins) also run on a machine
without it:

    python3 -m pytest --noconftest -m cuda tests/test_torch_head_widths.py
"""

import numpy as np
import pytest
import torch

from avex_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

# The dh-80 tests' tolerance (that of tests/unittests/test_pallas_attention.py).
TOL = dict(atol=2e-5, rtol=1e-4)
B = 2
WIDTHS = (8, 16, 32, 96, 128)
# At dh 128 two heads, else four: JAX's fused kernels in interpret mode take
# any head count, so none of these needs its head groups to tile 128 lanes.
# Each width at a ragged tile (T=37) and at two tiles and a row (T=129), one
# without a key mask and one with; the backward once a width, T and the mask
# alternating.
CASES = [(dh, seq, seq == 129) for dh in WIDTHS for seq in (37, 129)]
GRAD_CASES = [(dh, 129 if i % 2 else 37, i % 3 != 0) for i, dh in enumerate(WIDTHS)]


def _ids(case):
    dh, seq, padded = case
    return f"dh{dh}-T{seq}-{'mask' if padded else 'nomask'}"


def _heads(dh):
    return 2 if dh == 128 else 4


def _inputs(dh, seq, padded, seed=0):
    rng = np.random.default_rng(seed + 1000 * dh + seq)
    heads = _heads(dh)
    qkv = rng.standard_normal((B, seq, 3 * heads * dh)).astype(np.float32)
    bias = rng.standard_normal((heads, seq, seq)).astype(np.float32)
    gate = rng.uniform(1.0, 3.0, (B, heads, seq)).astype(np.float32)
    cot = rng.standard_normal((B, seq, heads * dh)).astype(np.float32)
    mask = None
    if padded:
        mask = np.zeros((B, seq), bool)
        mask[1, seq // 3:] = True
    return heads, qkv, bias, gate, cot, mask


def _split_np(qkv, heads, dh):
    parts = qkv.reshape(B, qkv.shape[1], 3, heads, dh)
    return [np.ascontiguousarray(parts[:, :, i].transpose(0, 2, 1, 3)) for i in range(3)]


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_twins_match_jax_k1_k4(case):
    """K1 (gated, with the gate) and K4 (``pos_bias=None``) on split
    ``[B, H, T, D]`` q/k/v against JAX's ``_attention_kernel`` and
    ``_plain_attention_kernel``; the CPU launches nothing."""
    from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split

    dh, seq, padded = case
    heads, qkv, bias, gate, _, mask = _inputs(dh, seq, padded)
    q, k, v = _split_np(qkv, heads, dh)
    ak.reset_launch_counts()
    want = jax_split(_j(q), _j(k), _j(v), _j(bias), _j(gate), _j(mask), interpret=True)
    got = ak.gated_bias_attention(_t(q), _t(k), _t(v), _t(bias), _t(gate), _t(mask))
    assert got.shape == (B, heads, seq, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jax_split(_j(q), _j(k), _j(v), None, None, _j(mask), interpret=True)
    got = ak.gated_bias_attention(_t(q), _t(k), _t(v), None, None, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sum(ak.LAUNCHES.values()) == 0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_fused_twins_match_jax_k2_k5(case):
    """K2 (gated, with the gate) and K5 over the raw ``[B, T, 3E]``
    projection against JAX's ``_fused_qkv_gated_kernel`` and
    ``_fused_qkv_kernel``."""
    from avex_tpu.ops.pallas_attention import fused_qkv_attention as jax_fused_plain
    from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused

    dh, seq, padded = case
    heads, qkv, bias, gate, _, mask = _inputs(dh, seq, padded)
    ak.reset_launch_counts()
    want = jax_fused(_j(qkv), heads, _j(bias), _j(gate), _j(mask), interpret=True)
    got = ak.fused_qkv_gated_attention(_t(qkv), heads, _t(bias), _t(gate), _t(mask))
    assert got.shape == (B, seq, heads * dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jax_fused_plain(_j(qkv), heads, _j(mask), interpret=True)
    got = ak.fused_qkv_attention(_t(qkv), heads, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sum(ak.LAUNCHES.values()) == 0


@pytest.mark.parametrize("case", GRAD_CASES, ids=_ids)
def test_backward_twins_match_jax_k3_k6(case):
    """K3's twin (dqkv, dbias summed over the batch, dgate), autograd through
    K2's twin, and the twin of the bf16 K3's contract (from the forward's
    log-sum-exp and output) against ``jax.grad`` through JAX's gated fused
    kernel (K3 in interpret mode); the same three for K6 against ``jax.grad``
    through JAX's K5 (K6 in interpret mode)."""
    import jax
    import jax.numpy as jnp

    from avex_tpu.ops.pallas_attention import fused_qkv_attention as jax_fused_plain
    from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused

    dh, seq, padded = case
    heads, qkv, bias, gate, cot, mask = _inputs(dh, seq, padded)
    scale = dh**-0.5

    def loss(x, b, g):
        return jnp.sum(jax_fused(x, heads, b, g, _j(mask), interpret=True) * cot)

    want = jax.grad(loss, argnums=(0, 1, 2))(_j(qkv), _j(bias), _j(gate))
    twin = ak.fused_qkv_gated_backward_reference(_t(qkv), heads, _t(bias), _t(gate), _t(mask), _t(cot))
    leaves = [_t(x).requires_grad_() for x in (qkv, bias, gate)]
    out = ak.fused_qkv_gated_attention(leaves[0], heads, leaves[1], leaves[2], _t(mask))
    autograd = torch.autograd.grad(out, leaves, _t(cot))
    out, lse, rest = ak._fused_qkv_forward_lse_reference(_t(qkv), heads, _t(mask), scale, _t(bias), _t(gate))
    own = ak.fused_qkv_backward_from_residuals_reference(_t(qkv), out, lse, _t(mask), _t(cot), scale,
                                                         out_rest=rest, pos_bias=_t(bias), gate=_t(gate))
    for got in (twin, autograd, own):
        for name, g, w in zip(("dqkv", "dbias", "dgate"), got, want):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), err_msg=name, **TOL)

    want = jax.grad(lambda x: jnp.sum(jax_fused_plain(x, heads, _j(mask), interpret=True) * cot))(_j(qkv))
    leaf = _t(qkv).requires_grad_()
    (ak.fused_qkv_attention(leaf, heads, _t(mask)) * _t(cot)).sum().backward()
    out, lse, rest = ak._fused_qkv_forward_lse_reference(_t(qkv), heads, _t(mask), scale)
    for got in (ak.fused_qkv_backward_reference(_t(qkv), heads, _t(mask), _t(cot)), leaf.grad,
                ak.fused_qkv_backward_from_residuals_reference(_t(qkv), out, lse, _t(mask), _t(cot), scale,
                                                               out_rest=rest)[0]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _recording(monkeypatch, module, names):
    """Count the calls a model module makes to each of its attention entry points."""
    calls = {name: 0 for name in names}
    for name in names:
        real = getattr(module, name)

        def wrapper(*args, _real=real, _name=name, **kwargs):
            calls[_name] += 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)
    return calls


# BEATs at full layer shape but 2 layers: dh 16 is the repo's example configs'
# (64 wide, 4 heads), dh 128 two heads of 128. JAX's fused route needs head
# groups that tile 128 lanes (8 heads of 16, 1 of 128): at dh 16 with 4 heads
# JAX splits the fused projection and runs K1, the port runs K2.
BEATS_WIDTHS = {
    "dh16": dict(encoder_embed_dim=64, encoder_attention_heads=4),
    "dh128": dict(encoder_embed_dim=256, encoder_attention_heads=2),
}


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused_qkv"])
@pytest.mark.parametrize("width", sorted(BEATS_WIDTHS))
def test_beats_matches_jax_at_head_width(monkeypatch, width, fused):
    from avex_tpu_torch.models import beats
    from tests.test_torch_beats import FP32_TOL, TINY, _np, build_pair, run_pair

    config = dict(TINY, **BEATS_WIDTHS[width], fused_qkv=fused)
    jax_model, port = build_pair(config, return_features_only=True)
    calls = _recording(monkeypatch, beats, ["gated_bias_attention", "fused_qkv_gated_attention"])
    wav = (np.random.default_rng(7).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    mask = np.zeros((2, 16000), dtype=bool)
    mask[1, 9000:] = True
    (out_j, aux_j), (out_t, aux_t) = run_pair(jax_model, port, wav, mask)
    # 2 layers on K2's twin with fused_qkv (every multiple of 8 up to 128), else K1's
    assert calls == ({"gated_bias_attention": 0, "fused_qkv_gated_attention": 2} if fused
                     else {"gated_bias_attention": 2, "fused_qkv_gated_attention": 0})
    valid = ~_np(aux_j["padding_mask"]).astype(bool)
    np.testing.assert_allclose(_np(out_t)[valid], _np(out_j)[valid], **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)


def test_eat_matches_jax_at_dh32(monkeypatch):
    """A 2-block EAT at dh 32 (4 heads of 32): both packages take the fused
    route (JAX's 4-head groups tile 128 lanes), K5's twin here."""
    from avex_tpu_torch.models import eat
    from tests.test_torch_beats import FP32_TOL, _np
    from tests.test_torch_eat import TINY, build_pair, run_pair

    calls = _recording(monkeypatch, eat, ["fused_qkv_attention"])
    wav = (np.random.default_rng(8).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    (out_j, aux_j), (out_t, aux_t) = run_pair(build_pair(dict(TINY, dim=128, heads=4)), wav)
    assert calls == {"fused_qkv_attention": 2}
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)


# (dim, heads) → the head width (None: the heads do not split evenly) and the
# build it runs on: the smallest that holds it, or past 128 its column chunks
# (136 in two chunks of 72). The ids are the ones these cases had when the
# kernels took only multiples of 8 up to 128 (None then marked a refusal).
RULE_GRID = [
    pytest.param(dim, heads, dh, build, id=case_id) for dim, heads, dh, build, case_id in (
        (96, 12, 8, 32, "96-12-8-32"), (64, 4, 16, 32, "64-4-16-32"), (128, 4, 32, 32, "128-4-32-32"),
        (240, 12, 20, 32, "240-12-20-None"), (1536, 16, 96, 96, "1536-16-96-96"),
        (256, 2, 128, 128, "256-2-128-128"), (1280, 10, 128, 128, "1280-10-128-128"),
        (1088, 8, 136, 80, "1088-8-136-None"), (768, 12, 64, 64, "768-12-64-64"), (1280, 16, 80, 80, "1280-16-80-80"),
        (840, 12, 70, 80, "840-12-70-None"), (1152, 16, 72, 80, "1152-16-72-80"), (1320, 15, 88, 96, "1320-15-88-96"),
        (960, 8, 120, 128, "960-8-120-128"), (100, 3, None, None, "100-3-None-None"),
    )
]


@pytest.mark.parametrize("dim,heads,dh,build", RULE_GRID)
def test_head_width_rule(dim, heads, dh, build):
    """``fused_qkv_compatible`` is ``dim % heads == 0``, whatever the head
    width, gated or not; ``kernel_width`` names the build every width runs
    on."""
    assert ak.fused_qkv_compatible(dim, heads) == (dh is not None)
    if dh is not None:
        assert dim // heads == dh and ak.kernel_width(dh) == build


def test_head_dims_and_builds():
    assert ak.KERNEL_WIDTHS == (32, 64, 80, 96, 128) and ak.CHUNK_COLUMNS == 128
    # every multiple of 8 up to 128 runs on the smallest build that holds it, in one chunk
    widths = range(8, 129, 8)
    assert [ak.kernel_width(d) for d in widths] == [32] * 4 + [64] * 4 + [80] * 2 + [96] * 2 + [128] * 4
    assert all(ak.width_plan(d).chunks == 1 for d in widths)


@pytest.mark.parametrize("name", ["eat", "aves"])
def test_use_pallas_takes_k5_at_every_head_width(monkeypatch, name):
    """EAT and AVES with ``use_pallas`` call K5 whatever the head width: at
    dh 20 (narrow rows on CUDA) the CPU twin runs and agrees with the plain
    path on the same weights."""
    import avex_tpu_torch
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models import aves, eat
    from tests.test_torch_beats import FP32_TOL, _np

    if name == "eat":
        from tests.test_torch_eat import NORM, TINY

        def build(use_pallas):
            return avex_tpu_torch.build_model_from_spec(
                ModelSpec(name="eat_hf", pretrained=False, compute_dtype="float32",
                          init_config=dict(TINY, dim=80, heads=4, use_pallas=use_pallas), **NORM), device="cpu")
        module = eat
    else:
        from tests.test_torch_aves import TINY

        def build(use_pallas):
            return avex_tpu_torch.build_model_from_spec(
                ModelSpec(name="aves_bio", pretrained=False, compute_dtype="float32"), device="cpu",
                use_pallas=use_pallas, aves_cfg=dict(TINY, encoder_embed_dim=80, encoder_num_heads=4),
                return_features_only=True)
        module = aves
    assert ak.fused_qkv_compatible(80, 4) and ak.width_plan(20).chunks == 1
    kernel, plain = build(True), build(False)
    plain.module.load_state_dict(kernel.module.state_dict())
    calls = _recording(monkeypatch, module, ["fused_qkv_attention"])
    wav = torch.from_numpy((np.random.default_rng(9).standard_normal((2, 16000)) * 0.1).astype(np.float32))
    with torch.no_grad():
        out_k, aux_k = kernel.module(wav)
        assert calls == {"fused_qkv_attention": 2}  # one a layer
        out_p, aux_p = plain.module(wav)
    assert calls == {"fused_qkv_attention": 2}
    np.testing.assert_allclose(_np(out_k), _np(out_p), **FP32_TOL)


# ---------------------------------------------------------------------------
# On the card (marked ``cuda``; they skip without one)
# ---------------------------------------------------------------------------

CARD_WIDTHS = [8, 16, 24, 32, 40, 72, 88, 96, 104, 120, 128]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    got, want = got[~nan].float(), want[~nan].float()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:  # bf16: the kernel rounds the unnormalised P, the twin the normalised one
        assert float((got - want).norm() / want.norm()) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("dh", CARD_WIDTHS)
def test_kernels_at_head_width_match_twins(card, dh, dtype):
    """K1, K2, K4, K5 forward and K3, K6 backward at one head width, a ragged
    T and a padded item, each launched once against its twin."""
    bsz, heads, seq = 3, 3, 37
    qkv = torch.randn(bsz, seq, 3 * heads * dh, generator=card, device="cuda").to(dtype)
    bias = torch.randn(heads, seq, seq, generator=card, device="cuda")
    gate = torch.rand(bsz, heads, seq, generator=card, device="cuda") + 1
    dout = torch.randn(bsz, seq, heads * dh, generator=card, device="cuda").to(dtype)
    mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
    mask[1, 20:] = True
    q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, dh).unbind(2))
    ak.reset_launch_counts()
    with torch.no_grad():
        _close(ak.gated_bias_attention(q, k, v, bias, gate, mask),
               ak.gated_bias_attention_reference(q, k, v, bias, gate, mask), dtype)
        _close(ak.gated_bias_attention(q, k, v, None, None, mask),
               ak.gated_bias_attention_reference(q, k, v, None, None, mask), dtype)
        _close(ak.fused_qkv_gated_attention(qkv, heads, bias, gate, mask),
               ak.fused_qkv_gated_reference(qkv, heads, bias, gate, mask), dtype)
        _close(ak.fused_qkv_attention(qkv, heads, mask), ak.fused_qkv_reference(qkv, heads, mask), dtype)
    leaves = [qkv.clone().requires_grad_(), bias.clone().requires_grad_(), gate.clone().requires_grad_()]
    got = torch.autograd.grad(ak.fused_qkv_gated_attention(leaves[0], heads, leaves[1], leaves[2], mask),
                              leaves, dout)
    want = ak.fused_qkv_gated_backward_reference(qkv, heads, bias, gate, mask, dout)
    _close(got[0], want[0], dtype)
    for g, w in zip(got[1:], want[1:]):  # dbias and dgate sum in another order: relative L2
        assert float((g - w).norm() / w.norm()) < (1e-5 if dtype == torch.float32 else 5e-3)
    leaf = qkv.clone().requires_grad_()
    (got,) = torch.autograd.grad(ak.fused_qkv_attention(leaf, heads, mask), (leaf,), dout)
    _close(got, ak.fused_qkv_backward_reference(qkv, heads, mask, dout), dtype)
    torch.cuda.synchronize()
    # K2 and K5 twice: once alone, once under grad ahead of their backward
    assert ak.LAUNCHES == {"gated_bias_attention": 1, "plain_attention": 1, "fused_qkv_gated_attention": 2,
                           "fused_qkv_attention": 2, "fused_qkv_gated_attention_backward": 1,
                           "fused_qkv_attention_backward": 1}, ak.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [20, 100, 136])
def test_cuda_call_at_another_width_raises(card, dh):
    """The widths this test once saw refused (not a multiple of 8, or above
    128) now launch the kernels, gated or not, bf16 and fp32, each against
    its twin: 20 and 100 through narrow rows, 136 in two column chunks."""
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.randn(2, 31, 3 * 2 * dh, generator=card, device="cuda").to(dtype)
        bias = torch.randn(2, 31, 31, generator=card, device="cuda")
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(2, 31, 3, 2, dh).unbind(2))
        ak.reset_launch_counts()
        with torch.no_grad():
            _close(ak.fused_qkv_attention(qkv, 2), ak.fused_qkv_reference(qkv, 2), dtype)
            _close(ak.fused_qkv_gated_attention(qkv, 2, bias), ak.fused_qkv_gated_reference(qkv, 2, bias), dtype)
            _close(ak.gated_bias_attention(q, k, v, None), ak.gated_bias_attention_reference(q, k, v, None), dtype)
            _close(ak.gated_bias_attention(q, k, v, bias), ak.gated_bias_attention_reference(q, k, v, bias), dtype)
        torch.cuda.synchronize()
        assert ak.LAUNCHES == {"gated_bias_attention": 1, "plain_attention": 1, "fused_qkv_gated_attention": 1,
                               "fused_qkv_attention": 1, "fused_qkv_gated_attention_backward": 0,
                               "fused_qkv_attention_backward": 0}, ak.LAUNCHES
