"""Ring attention over the port's model axis on gloo processes, against JAX's.

JAX's ``ops/ring_attention.ring_attention`` runs in a ``shard_map`` on its
8-device CPU platform; the port's runs over the model axis of four spawned
gloo ranks (``tests/test_torch_model_axis_ranks.py``, one group for the
file, started before JAX's side runs here): a 2x2 mesh (ring 2, each data
row on its half of the batch) and a 1x4 mesh (ring 4). The same arrays go
through both: a shared relative-position bias, BEATs' per-query gate, a
padding mask with some padded keys and one fully padded row (whose output
is 0 in both rings), and a cotangent for the gradients of q, k, v, the bias
and the gate. The outputs are held at rtol 1e-5 / atol 1e-6, the gradients
at 1e-4 / 1e-5 (``tests/unittests/test_ring_attention.py:46,71``); JAX's
errors; a ring of one against JAX's. Then ``enable_ring_attention`` on
BEATs (masked), EAT (T = 33: the pad path), AVES (T = 49, masked) and
Bird-MAE (T = 33) over the 1x4 mesh, on JAX's weights, against JAX's ring
features at 1e-4 / 1e-5, and each rank's parameter gradients against the
same model's without the ring (rel L2 1e-5 a tensor).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import avex_tpu
from avex_tpu.ops.ring_attention import ring_attention as jax_ring
from avex_tpu.parallel import make_mesh as jax_make_mesh

from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models import aves, beats, birdmae, eat
from avex_tpu_torch.models.factory import build_model_from_spec
from avex_tpu_torch.ops.ring_attention import ring_attention, ring_bytes, ring_self_attention
from avex_tpu_torch.parallel import Mesh
from tests.test_torch_model_axis_ranks import WORLD, rank_main
from tests.test_torch_model_parallel import AVES, BEATS, EAT, NUM_CLASSES, RAW_AUDIO, _dump
from tests.test_torch_parallel_ranks import RankGroup
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)
MODEL_GRAD_REL = 1e-5  # a model's parameter gradients, each tensor's rel L2
ZERO_GRAD = 1e-5  # |g| of a tensor whose exact gradient is 0, of the largest |g|
B, H, T, D = 8, 4, 32, 8
BIRDMAE = {"depth": 2, "dim": 64, "heads": 4, "target_length": 64}
GRADS = ("q", "k", "v", "bias", "gate")


def _arrays():
    rng = np.random.default_rng(5)
    q, k, v, cot = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(4))
    mask = np.zeros((B, T), bool)
    mask[1, -5:] = True
    mask[6] = True  # a fully padded row: its output is 0
    return {"q": q, "k": k, "v": v, "cot": cot, "mask": mask,
            "bias": rng.standard_normal((1, H, T, T)).astype(np.float32),
            "gate": (rng.random((B, H, T, 1)) + 0.5).astype(np.float32)}


def _jax_ring(arrays, data, model):
    """JAX's output and the gradients of ``Σ out · cot`` on a data x model mesh."""
    mesh = jax_make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    mask, cot = jnp.asarray(arrays["mask"]), jnp.asarray(arrays["cot"])

    def run(q, k, v, bias, gate):
        return jax_ring(q, k, v, bias, mesh=mesh, gate=gate, key_padding_mask=mask)

    inputs = [jnp.asarray(arrays[k]) for k in GRADS]
    out = jax.jit(run)(*inputs)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(run(*a) * cot), argnums=tuple(range(5))))(*inputs)
    plain = jax.jit(lambda q, k, v: jax_ring(q, k, v, mesh=mesh))(*inputs[:3])
    return {"out": np.asarray(out), "plain": np.asarray(plain), "grads": dict(zip(GRADS, map(np.asarray, grads)))}


MODELS = {  # architecture, init config, params_from_jax, masked
    "beats": ("beats", dict(BEATS, encoder_layers=2), beats.params_from_jax, True),
    "eat": ("eat_hf", EAT, eat.params_from_jax, False),
    "aves": ("aves_bio", AVES, aves.params_from_jax, True),
    "birdmae": ("birdmae", BIRDMAE, birdmae.params_from_jax, False),
}


def _jax_ring_model(name, wav, mask):
    """A JAX model's weights (in the port's names) and its features with
    ring attention over a 1x4 mesh."""
    arch, init, convert, masked = MODELS[name]
    extra = {"model_id": "DBD-research-group/Bird-MAE-base"} if arch == "birdmae" else {}
    spec = avex_tpu.configs.ModelSpec(name=arch, pretrained=False, init_config=init, audio_config=RAW_AUDIO, **extra)
    model = avex_tpu.build_model_from_spec(spec, num_classes=NUM_CLASSES)
    state = convert(jax.tree_util.tree_map(np.array, model.variables["params"]))
    model.enable_ring_attention(jax_make_mesh(data=1, model=4, devices=jax.devices()[:4]))
    args = [jnp.asarray(wav)] + ([jnp.asarray(mask)] if masked else [])
    features = jax.jit(model.module.apply)(model.variables, *args)[1]["features"]
    port_spec = dict(name=arch, pretrained=False, init_config=init, audio_config=RAW_AUDIO, **extra)
    return {"model_spec": port_spec, "num_classes": NUM_CLASSES, "state": state, "wav": wav,
            "mask": mask if masked else None}, np.asarray(features)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks start on the ring op while JAX builds its models; the
    models' weights follow, and JAX's rings run while the ranks take theirs."""
    work = tmp_path_factory.mktemp("ring")
    arrays = _arrays()
    _dump({"ring_op": {"arrays": arrays}}, work / "inputs.pkl")
    group = RankGroup(work, world=WORLD, timeout=240.0, main=rank_main)
    rng = np.random.default_rng(9)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    mask = np.zeros((2, 16000), bool)
    mask[1, 12000:] = True
    cases, want = {}, {}
    for name in MODELS:
        cases[name], want[name] = _jax_ring_model(name, wav, mask)
    _dump({"ring_models": cases}, work / "inputs_late.pkl")
    jax_rings = {2: _jax_ring(arrays, 2, 2), 4: _jax_ring(arrays, 1, 4)}
    return {"group": group, "arrays": arrays, "jax": jax_rings, "models": want}


def _gathered(results, ring):
    """The port's global output and gradients from its ranks (each data row
    holds its rows; the shared bias's gradient is the sum of the rows')."""
    per = [r["ring_op"][f"ring{ring}"] for r in results]
    for got in per:  # the ranks of a data row end equal
        same = per[(got["coords"][0]) * ring]
        np.testing.assert_array_equal(got["out"], same["out"])
        for key in GRADS:
            np.testing.assert_array_equal(got["grads"][key], same["grads"][key])
    heads = per[::ring]
    out = {"out": np.concatenate([p["out"] for p in heads]), "plain": np.concatenate([p["plain"] for p in heads]),
           "grads": {k: np.concatenate([p["grads"][k] for p in heads]) for k in GRADS if k != "bias"}}
    out["grads"]["bias"] = np.sum([p["grads"]["bias"] for p in heads], axis=0)
    return out


@pytest.mark.parametrize("ring", [2, 4])
def test_ring_matches_jax(ranks, ring):
    """Bias, gate and mask applied in each step, a fully padded row's 0, and
    the gradients through the reverse ring; the mesh's 2x2 data rows each on
    their half of the batch."""
    got, want = _gathered(ranks["group"].results(), ring), ranks["jax"][ring]
    assert not want["out"][6].any() and not got["out"][6].any()
    np.testing.assert_allclose(got["out"], want["out"], **OUT_TOL)
    np.testing.assert_allclose(got["plain"], want["plain"], **OUT_TOL)
    for key in GRADS:
        assert np.isfinite(got["grads"][key]).all(), key
        np.testing.assert_allclose(got["grads"][key], want["grads"][key], err_msg=key, **GRAD_TOL)


def test_ring_errors_are_jax_s(ranks):
    """A T the ring does not divide, a bias without concrete trailing dims and
    a gate without a bias raise JAX's messages."""
    arrays = ranks["arrays"]
    mesh = jax_make_mesh(data=1, model=4, devices=jax.devices()[:4])
    q = jnp.asarray(arrays["q"])
    want = {}
    for label, fn in (("divisible", lambda: jax_ring(q[:, :, :30], q[:, :, :30], q[:, :, :30], mesh=mesh)),
                      ("trailing", lambda: jax_ring(q, q, q, jnp.zeros((1, H, 1, T)), mesh=mesh)),
                      ("gate", lambda: jax_ring(q, q, q, mesh=mesh, gate=jnp.ones((B, H, T, 1))))):
        with pytest.raises(ValueError) as err:
            fn()
        want[label] = str(err.value)
    for r in ranks["group"].results():
        assert r["ring_op"]["errors"] == want


def test_ring_of_one_is_dot_product_attention():
    """A ring of one rank is ``dot_product_attention`` on ``gate · bias`` plus
    the padding bias (a fully padded row gives its NaN there, as in JAX)."""
    arrays = _arrays()
    mesh = jax_make_mesh(data=1, model=1, devices=jax.devices()[:1])
    inputs = [jnp.asarray(arrays[k]) for k in GRADS]
    want = jax_ring(*inputs[:4], mesh=mesh, gate=inputs[4], key_padding_mask=jnp.asarray(arrays["mask"]))
    one = Mesh(size=1, rank=0, group=None, device=torch.device("cpu"))
    got = ring_attention(*(torch.from_numpy(arrays[k]) for k in GRADS[:4]), mesh=one,
                         gate=torch.from_numpy(arrays["gate"]), key_padding_mask=torch.from_numpy(arrays["mask"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), equal_nan=True, **OUT_TOL)
    assert np.isnan(got.numpy()[6]).all() and np.isnan(np.asarray(want)[6]).all()
    q, k, v = (torch.from_numpy(arrays[key]) for key in GRADS[:3])
    layer = ring_self_attention(torch.zeros(B, T, 1), lambda x, shared: (q, k, v, None), mesh=one, scale=D**-0.5)
    np.testing.assert_array_equal(layer.numpy(), ring_attention(q, k, v, mesh=one).numpy())
    assert ring_bytes(torch.zeros(B, H, T, D), 4) == 3 * 2 * B * H * (T // 4) * D * 4


@pytest.mark.parametrize("name", list(MODELS))
def test_enable_ring_attention_matches_jax(ranks, name):
    """Each model's features with ring attention over four ranks, on JAX's
    weights, against JAX's ring features; every rank the same."""
    results = ranks["group"].results()
    got = results[0]["ring_models"][name]["features"]
    for r in results[1:]:
        np.testing.assert_array_equal(r["ring_models"][name]["features"], got)
    np.testing.assert_allclose(got, ranks["models"][name], **MODEL_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_ring_model_gradients_match_one_process(ranks, name):
    """Each rank's parameter gradients with ring attention (each rank projects
    its own positions; the parameters read there are summed over the ring)
    against the same model's without the ring: every tensor at rel L2 1e-5
    (fp32 roundoff is ~2e-6 here), the key biases, whose exact gradient is 0,
    within 1e-5 of the largest gradient entry."""
    for rank, r in enumerate(ranks["group"].results()):
        case = r["ring_models"][name]
        ring, alone = case["ring_grads"], case["alone_grads"]
        assert sorted(ring) == sorted(alone) and len(alone) > 10
        largest = max(np.abs(g).max() for g in alone.values())
        for key in alone:
            if key.endswith("k_proj.bias"):  # softmax ignores a key bias: its exact gradient is 0
                assert np.abs(ring[key]).max() <= ZERO_GRAD * largest, f"rank {rank} {key}"
                continue
            rel = np.linalg.norm(ring[key] - alone[key]) / np.linalg.norm(alone[key])
            assert rel <= MODEL_GRAD_REL, f"rank {rank} {key}: rel L2 {rel:.3e}"


def test_blocks_ring_over_the_model_axis_only():
    """EAT's, AVES's and Bird-MAE's ``enable_ring_attention`` take JAX's
    ``axis`` argument, which their blocks do not read: any other axis than
    ``model`` raises instead of ringing over ``model``."""
    one = Mesh(size=1, rank=0, group=None, device=torch.device("cpu"))
    for name in ("eat", "aves", "birdmae"):
        arch, init, _, _ = MODELS[name]
        extra = {"model_id": "DBD-research-group/Bird-MAE-base"} if arch == "birdmae" else {}
        spec = ModelSpec(name=arch, pretrained=False, init_config=init, audio_config=RAW_AUDIO, device="cpu", **extra)
        model = build_model_from_spec(spec, num_classes=NUM_CLASSES)
        with pytest.raises(ValueError, match="model axis, not 'data'"):
            model.enable_ring_attention(one, axis="data")
        model.enable_ring_attention(one, axis="model")
