"""The attention kernels at head widths that are not a multiple of 8 or are
above 128, against JAX.

Every kernel of the port (K1-K6, gated or not) takes any head width D >= 1
(``attention_kernels.width_plan``): up to 128 on the smallest build that
holds it, past 128 in column chunks of a multiple of 8 (a bf16 block owns
one chunk of the output and sums the logits over every chunk; an fp32 block,
on 3xTF32, sums them once for the output of up to four chunks), and a D or a
stride that is not a multiple of 8 through narrow rows read and written
element by element. On the CPU the wrappers take their plain twins, held
here against JAX's Pallas kernels in interpret mode at D = 4, 12, 20, 33,
136, 192 and 256: the split K1/K4; the fused K2/K5 against JAX's fused
kernels where ``_heads_per_block`` takes the head count, else against JAX's
split kernel on the same q/k/v; the backward twins of K3 and K6 and the twin
of the bf16 K3's and K6's own contract against ``jax.grad`` at one narrow and
one wide width; then a 2-layer BEATs at 4 heads of 192, a 2-block EAT at 32
heads of 12 and a 2-block Bird-MAE at 2 heads of 256 with
``use_pallas=True``, port against JAX with the same weights; then the width
plan. The tolerances are those of the dh-80 tests.

JAX is imported inside the CPU tests only, so the ``cuda`` tests at the end
(each kernel at each width against its twin, every call on its type's body,
and no width on a twin) also run on a machine without it:

    python3 -m pytest --noconftest -m cuda tests/test_torch_wide_heads.py
"""

import numpy as np
import pytest
import torch

from avex_tpu_torch.ops import attention_kernels as ak
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

# The dh-80 tests' tolerance (that of tests/unittests/test_pallas_attention.py).
TOL = dict(atol=2e-5, rtol=1e-4)
B, T = 2, 37
WIDTHS = (4, 12, 20, 33, 136, 192, 256)
# (heads, dh) of the fused forwards: JAX's fused kernels where its head
# groups tile 128 lanes (32 x 12, 2 x 192, 1 x 256), else its split kernel
# on the same q/k/v (2 x 4, 2 x 20, 2 x 33, 2 x 136).
FUSED = [(32, 12), (2, 192), (1, 256), (2, 4), (2, 20), (2, 33), (2, 136)]


def _inputs(heads, dh, padded, seq=T, seed=0):
    rng = np.random.default_rng(seed + 1000 * dh + heads)
    qkv = rng.standard_normal((B, seq, 3 * heads * dh)).astype(np.float32)
    bias = rng.standard_normal((heads, seq, seq)).astype(np.float32)
    gate = rng.uniform(1.0, 3.0, (B, heads, seq)).astype(np.float32)
    cot = rng.standard_normal((B, seq, heads * dh)).astype(np.float32)
    mask = None
    if padded:
        mask = np.zeros((B, seq), bool)
        mask[1, seq // 3:] = True
    return qkv, bias, gate, cot, mask


def _split_np(qkv, heads, dh):
    parts = qkv.reshape(B, qkv.shape[1], 3, heads, dh)
    return [np.ascontiguousarray(parts[:, :, i].transpose(0, 2, 1, 3)) for i in range(3)]


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("padded", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("dh", WIDTHS)
def test_split_twins_match_jax_k1_k4(dh, padded):
    """K1 (gated, with the gate) and K4 (``pos_bias=None``) on split
    ``[B, H, T, D]`` q/k/v against JAX's ``_attention_kernel`` and
    ``_plain_attention_kernel``; the CPU launches nothing."""
    from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split

    heads = 2
    qkv, bias, gate, _, mask = _inputs(heads, dh, padded)
    q, k, v = _split_np(qkv, heads, dh)
    ak.reset_launch_counts()
    want = jax_split(_j(q), _j(k), _j(v), _j(bias), _j(gate), _j(mask), interpret=True)
    got = ak.gated_bias_attention(_t(q), _t(k), _t(v), _t(bias), _t(gate), _t(mask))
    assert got.shape == (B, heads, T, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jax_split(_j(q), _j(k), _j(v), None, None, _j(mask), interpret=True)
    got = ak.gated_bias_attention(_t(q), _t(k), _t(v), None, None, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sum(ak.LAUNCHES.values()) == 0


@pytest.mark.parametrize("heads,dh", FUSED, ids=[f"{h}x{d}" for h, d in FUSED])
def test_fused_twins_match_jax_k2_k5(heads, dh):
    """K2 (gated, with the gate and a key mask) and K5 over the raw
    ``[B, T, 3E]`` projection: against JAX's ``_fused_qkv_gated_kernel`` and
    ``_fused_qkv_kernel`` where ``_heads_per_block`` takes the head count,
    else against JAX's split kernels on the same q/k/v (JAX's models take
    those there)."""
    import jax.numpy as jnp

    from avex_tpu.ops.pallas_attention import _heads_per_block
    from avex_tpu.ops.pallas_attention import fused_qkv_attention as jax_fused_plain
    from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused
    from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split

    qkv, bias, gate, _, mask = _inputs(heads, dh, padded=True)
    assert ak.fused_qkv_compatible(heads * dh, heads)
    ak.reset_launch_counts()
    if _heads_per_block(heads, dh):
        want_gated = jax_fused(_j(qkv), heads, _j(bias), _j(gate), _j(mask), interpret=True)
        want_plain = jax_fused_plain(_j(qkv), heads, _j(mask), interpret=True)
    else:
        q, k, v = (_j(x) for x in _split_np(qkv, heads, dh))

        def merged(out):
            return jnp.transpose(out, (0, 2, 1, 3)).reshape(B, T, heads * dh)

        want_gated = merged(jax_split(q, k, v, _j(bias), _j(gate), _j(mask), interpret=True))
        want_plain = merged(jax_split(q, k, v, None, None, _j(mask), interpret=True))
    got = ak.fused_qkv_gated_attention(_t(qkv), heads, _t(bias), _t(gate), _t(mask))
    assert got.shape == (B, T, heads * dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_gated), **TOL)
    got = ak.fused_qkv_attention(_t(qkv), heads, _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_plain), **TOL)
    assert sum(ak.LAUNCHES.values()) == 0


@pytest.mark.parametrize("heads,dh", [(2, 12), (2, 192)], ids=["2x12", "2x192"])
def test_backward_twins_match_jax_k3_k6(heads, dh):
    """K3's twin (dqkv, dbias summed over the batch, dgate), autograd through
    K2's twin, and the twin of the bf16 K3's contract (from the forward's
    log-sum-exp and output) against ``jax.grad`` of what JAX runs for these
    heads: at 2 heads of 192 (one 384-lane group) its gated fused kernel (K3
    in interpret mode), at 2 heads of 12 (no group tiles) its split kernel
    on the same q/k/v (the custom VJP of K1); the same three for K6 against
    ``jax.grad`` through JAX's K5 (K6 in interpret mode) or its split K4."""
    import jax
    import jax.numpy as jnp

    from avex_tpu.ops.pallas_attention import _heads_per_block
    from avex_tpu.ops.pallas_attention import fused_qkv_attention as jax_fused_plain
    from avex_tpu.ops.pallas_attention import fused_qkv_gated_attention as jax_fused
    from avex_tpu.ops.pallas_attention import gated_bias_attention as jax_split

    qkv, bias, gate, cot, mask = _inputs(heads, dh, padded=True)
    scale = dh**-0.5
    if _heads_per_block(heads, dh):
        def attention(x, b, g):
            return jax_fused(x, heads, b, g, _j(mask), interpret=True)

        def plain(x):
            return jax_fused_plain(x, heads, _j(mask), interpret=True)
    else:
        def split(x, b, g):
            parts = x.reshape(B, T, 3, heads, dh)
            q, k, v = (jnp.transpose(parts[:, :, i], (0, 2, 1, 3)) for i in range(3))
            out = jax_split(q, k, v, b, g, _j(mask), interpret=True)
            return jnp.transpose(out, (0, 2, 1, 3)).reshape(B, T, heads * dh)

        attention = split

        def plain(x):
            return split(x, None, None)

    def loss(x, b, g):
        return jnp.sum(attention(x, b, g) * cot)

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

    want = jax.grad(lambda x: jnp.sum(plain(x) * cot))(_j(qkv))
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


@pytest.mark.parametrize("fused", [False, True], ids=["split", "fused_qkv"])
def test_beats_matches_jax_at_4_heads_of_192(monkeypatch, fused):
    """A 2-layer BEATs 768 wide with 4 heads of 192: K2's twin with
    ``fused_qkv`` (JAX's 2-head groups tile 384 lanes, so JAX takes its fused
    K2 too), K1's twin without, against JAX with ``use_pallas=True``."""
    from avex_tpu_torch.models import beats
    from tests.test_torch_beats import FP32_TOL, TINY, _np, build_pair, run_pair

    config = dict(TINY, encoder_embed_dim=768, encoder_attention_heads=4, fused_qkv=fused)
    jax_model, port = build_pair(config, return_features_only=True)
    calls = _recording(monkeypatch, beats, ["gated_bias_attention", "fused_qkv_gated_attention"])
    wav = (np.random.default_rng(7).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    mask = np.zeros((2, 16000), dtype=bool)
    mask[1, 9000:] = True
    (out_j, aux_j), (out_t, aux_t) = run_pair(jax_model, port, wav, mask)
    assert calls == ({"gated_bias_attention": 0, "fused_qkv_gated_attention": 2} if fused
                     else {"gated_bias_attention": 2, "fused_qkv_gated_attention": 0})
    valid = ~_np(aux_j["padding_mask"]).astype(bool)
    np.testing.assert_allclose(_np(out_t)[valid], _np(out_j)[valid], **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)


def test_eat_matches_jax_at_32_heads_of_12(monkeypatch):
    """A 2-block EAT 384 wide with 32 heads of 12: K5's twin here, JAX's
    fused K5 (its 32-head groups tile 384 lanes)."""
    from avex_tpu_torch.models import eat
    from tests.test_torch_beats import FP32_TOL, _np
    from tests.test_torch_eat import TINY, build_pair, run_pair

    calls = _recording(monkeypatch, eat, ["fused_qkv_attention"])
    wav = (np.random.default_rng(8).standard_normal((1, 16000)) * 0.1).astype(np.float32)
    (out_j, aux_j), (out_t, aux_t) = run_pair(build_pair(dict(TINY, dim=384, heads=32)), wav)
    assert calls == {"fused_qkv_attention": 2}
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)


def test_birdmae_matches_jax_at_2_heads_of_256(monkeypatch):
    """A 2-block Bird-MAE 512 wide with 2 heads of 256 (``chip_smoke.py``
    runs Bird-MAE huge with 5 heads of 256): K5's twin here, JAX's
    fused K5 (one-head groups of 256 lanes), the same weights carried
    across."""
    import jax
    import jax.numpy as jnp

    import avex_tpu_torch
    from avex_tpu.models.birdmae import BirdMAEModel as JaxBirdMAEModel
    from avex_tpu_torch.configs import ModelSpec
    from avex_tpu_torch.models import birdmae, eat
    from tests.test_torch_beats import FP32_TOL, _np

    config = dict(depth=2, dim=512, heads=2, target_length=64)
    jax_module = JaxBirdMAEModel(use_pallas=True, dtype=jnp.float32, **config)
    variables = jax_module.init(jax.random.PRNGKey(3), jnp.zeros((1, 32000), jnp.float32))
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="birdmae", pretrained=False, model_id="DBD-research-group/Bird-MAE-huge",
                  compute_dtype="float32", init_config=dict(config, use_pallas=True)), device="cpu")
    port.load_port_state_dict(birdmae.params_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"])),
                              strict=True)
    calls = _recording(monkeypatch, eat, ["fused_qkv_attention"])  # Bird-MAE's blocks are EAT's
    wav = (np.random.default_rng(9).standard_normal((2, 32000)) * 0.1).astype(np.float32)
    out_j, aux_j = jax_module.apply(variables, wav)
    with torch.no_grad():
        out_t, aux_t = port.module(torch.from_numpy(wav))
    assert calls == {"fused_qkv_attention": 2}, calls
    np.testing.assert_allclose(_np(out_t), _np(out_j), **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["pooled"]), _np(aux_j["pooled"]), **FP32_TOL)


# head width → (build, chunks, chunk width): one chunk up to 128 on the
# smallest build that holds it; past it ceil(D / 128) chunks of a multiple of 8.
PLANS = [
    (1, 32, 1, 1), (4, 32, 1, 4), (12, 32, 1, 12), (20, 32, 1, 20), (32, 32, 1, 32), (33, 64, 1, 33),
    (64, 64, 1, 64), (70, 80, 1, 70), (80, 80, 1, 80), (100, 128, 1, 100), (128, 128, 1, 128),
    (136, 80, 2, 72), (150, 80, 2, 80), (192, 96, 2, 96), (200, 128, 2, 104), (256, 128, 2, 128),
    (320, 128, 3, 112), (512, 128, 4, 128), (1000, 128, 8, 128),
]


@pytest.mark.parametrize("dh,build,chunks,width", PLANS)
def test_width_plan(dh, build, chunks, width):
    plan = ak.width_plan(dh)
    assert plan == (build, chunks, width) and ak.kernel_width(dh) == build
    # the chunks cover the width, each starts 16-byte aligned, none is empty
    assert (chunks - 1) * width < dh <= chunks * width <= chunks * ak.CHUNK_COLUMNS
    assert chunks == 1 or width % 8 == 0


@pytest.mark.parametrize("dh", [0, -8, 2.5, True])
def test_width_plan_refuses_what_is_not_a_width(dh):
    with pytest.raises(ValueError, match="head_dim of at least 1"):
        ak.width_plan(dh)


def test_narrow_rows_from_strides_and_alignment():
    """Narrow rows (element by element) exactly where a head width, a stride
    or the start is off the 16-byte runs; a non-contiguous head dimension
    is refused."""
    qkv = torch.zeros(2, 5, 3 * 4 * 12, dtype=torch.bfloat16)
    q, _, _ = ak._split_heads(qkv, 4)  # dh 12: head stride 12
    assert ak._narrow("q", q)
    q, _, _ = ak._split_heads(torch.zeros(2, 5, 3 * 2 * 192, dtype=torch.bfloat16), 2)
    assert not ak._narrow("q", q)
    odd = torch.zeros(2, 2, 5, 65)[..., :64]  # token stride 65
    assert ak._narrow("q", odd)
    assert ak._narrow("q", torch.zeros(2, 2, 5, 65)[..., 1:])  # starts 4 bytes in
    assert not ak._narrow("q", torch.zeros(2, 2, 5, 64))
    with pytest.raises(ValueError, match="contiguous head dimension"):
        ak._narrow("q", torch.zeros(2, 2, 64, 5).transpose(-1, -2))


# ---------------------------------------------------------------------------
# On the card (marked ``cuda``; they skip without one)
# ---------------------------------------------------------------------------

CARD_WIDTHS = [1, 4, 12, 20, 33, 70, 100, 136, 150, 192, 256, 320, 512]


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


def _every_kernel(card, dh, dtype, heads=3, bsz=3, seq=37):
    """K1, K2, K4, K5 forward and K3, K6 backward at one head width, a ragged
    T, a padded item and a key mask, each against its twin and each on its
    type's body (fp32: 3xTF32, forward and backward); returns the
    launches."""
    qkv = torch.randn(bsz, seq, 3 * heads * dh, generator=card, device="cuda").to(dtype)
    bias = torch.randn(heads, seq, seq, generator=card, device="cuda")
    gate = torch.rand(bsz, heads, seq, generator=card, device="cuda") + 1
    dout = torch.randn(bsz, seq, heads * dh, generator=card, device="cuda").to(dtype)
    mask = torch.zeros(bsz, seq, dtype=torch.bool, device="cuda")
    mask[1, 20:] = True
    mask[2] = True  # every key of item 2 padded: NaN there, as the twin gives
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
    live = mask.clone()
    live[2] = False  # the backward without the all-padded item (its gradients are NaN)
    leaves = [qkv.clone().requires_grad_(), bias.clone().requires_grad_(), gate.clone().requires_grad_()]
    got = torch.autograd.grad(ak.fused_qkv_gated_attention(leaves[0], heads, leaves[1], leaves[2], live),
                              leaves, dout)
    want = ak.fused_qkv_gated_backward_reference(qkv, heads, bias, gate, live, dout)
    _close(got[0], want[0], dtype)
    for g, w in zip(got[1:], want[1:]):  # dbias and dgate sum in another order: relative L2
        assert float((g - w).norm() / w.norm()) < (1e-5 if dtype == torch.float32 else 5e-3)
    leaf = qkv.clone().requires_grad_()
    (got,) = torch.autograd.grad(ak.fused_qkv_attention(leaf, heads, live), (leaf,), dout)
    _close(got, ak.fused_qkv_backward_reference(qkv, heads, live, dout), dtype)
    torch.cuda.synchronize()
    body = "bf16" if dtype == torch.bfloat16 else "tf32x3"
    assert ak.FORWARD_BODIES == {"bf16": 0, "tf32x3": 0, body: 6}
    assert ak.BACKWARD_BODIES == {"bf16": 0, "tf32x3": 0, body: 2}
    return dict(ak.LAUNCHES)


# K2 and K5 twice: once alone, once under grad ahead of their backward
EVERY_KERNEL = {"gated_bias_attention": 1, "plain_attention": 1, "fused_qkv_gated_attention": 2,
                "fused_qkv_attention": 2, "fused_qkv_gated_attention_backward": 1, "fused_qkv_attention_backward": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("dh", CARD_WIDTHS)
def test_kernels_at_any_width_match_twins(card, dh, dtype):
    assert _every_kernel(card, dh, dtype) == EVERY_KERNEL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_no_width_takes_a_twin_on_cuda(card, monkeypatch, dtype):
    """With every plain twin patched to fail, each kernel still runs at
    narrow, unaligned and chunked widths on CUDA tensors: none falls back.
    (K1's and K4's backward is the plain twin by design, as JAX's ``_bwd``
    is jnp, so only their forwards run here.)"""
    def refuse(*args, **kwargs):
        pytest.fail("a CUDA tensor took a plain twin")

    for name in ("gated_bias_attention_reference", "fused_qkv_gated_reference", "fused_qkv_reference",
                 "_backward_reference", "fused_qkv_gated_backward_reference", "fused_qkv_backward_reference",
                 "_fused_qkv_forward_lse_reference", "fused_qkv_backward_from_residuals_reference"):
        monkeypatch.setattr(ak, name, refuse)
    for dh in (3, 12, 100, 136, 256):
        heads, bsz, seq = 2, 2, 29
        qkv = torch.randn(bsz, seq, 3 * heads * dh, generator=card, device="cuda").to(dtype)
        bias = torch.randn(heads, seq, seq, generator=card, device="cuda")
        q, k, v = (t.permute(0, 2, 1, 3) for t in qkv.view(bsz, seq, 3, heads, dh).unbind(2))
        ak.reset_launch_counts()
        with torch.no_grad():
            ak.gated_bias_attention(q, k, v, bias)
            ak.gated_bias_attention(q, k, v, None)
        leaf = qkv.clone().requires_grad_()
        ak.fused_qkv_gated_attention(leaf, heads, bias).sum().backward()
        ak.fused_qkv_attention(leaf, heads).sum().backward()
        torch.cuda.synchronize()
        assert ak.LAUNCHES == {"gated_bias_attention": 1, "plain_attention": 1, "fused_qkv_gated_attention": 1,
                               "fused_qkv_attention": 1, "fused_qkv_gated_attention_backward": 1,
                               "fused_qkv_attention_backward": 1}, (dh, ak.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_unaligned_rows_match_twins(card, dtype):
    """Rows of a width that is a multiple of 8 but whose token stride is not
    (a view of [B, H, T, 65]) and rows that start off a 16-byte boundary go
    through the narrow rows, against the twin."""
    base = torch.randn(2, 3, 41, 65, generator=card, device="cuda").to(dtype)
    bias = torch.randn(3, 41, 41, generator=card, device="cuda")
    for q in (base[..., :64], base[..., 1:]):
        with torch.no_grad():
            _close(ak.gated_bias_attention(q, q, q, bias), ak.gated_bias_attention_reference(q, q, q, bias), dtype)
            _close(ak.gated_bias_attention(q, q, q, None), ak.gated_bias_attention_reference(q, q, q, None), dtype)
