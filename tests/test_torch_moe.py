"""The port's single-device MoEMLP against the JAX package's.

The same flax-initialised parameters (carried across by
``probes.params_from_jax``) and the same seeded tokens: with ample capacity
both equal the dense top-k mixture; under overflow both drop the same
(token, choice) pairs; the auxiliary load-balancing loss, the dispatch guard
and the one-process placement; the port's own initialisation follows flax's
lecun-normal statistics.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.ops.moe import MoEMLP as JaxMoEMLP
from avex_tpu.ops.moe import switch_load_balancing_loss as jax_aux_loss

from avex_tpu_torch.ops.moe import MoEMLP, lecun_normal_, shard_moe_params, switch_load_balancing_loss
from avex_tpu_torch.parallel import Mesh
from avex_tpu_torch.probes import params_from_jax
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

FP32_TOL = dict(atol=5e-5, rtol=1e-4)
N, E, X, H, O = 32, 12, 4, 24, 10


def _pair(k=2, capacity_factor=10.0, seed=0):
    """(JAX module, its variables, port module) with the same parameters."""
    jax_mod = JaxMoEMLP(num_experts=X, hidden_dim=H, out_dim=O, k=k, capacity_factor=capacity_factor)
    variables = jax_mod.init(jax.random.PRNGKey(seed), jnp.zeros((N, E), jnp.float32))
    port = MoEMLP(E, X, H, O, k=k, capacity_factor=capacity_factor)
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, variables["params"]))
    assert set(state) == set(port.state_dict())
    port.load_state_dict({key: torch.tensor(v) for key, v in state.items()})
    return jax_mod, variables, port


def _tokens(seed=1):
    return np.random.default_rng(seed).standard_normal((N, E)).astype(np.float32)


def _apply(jax_mod, variables, x):
    out, state = jax_mod.apply(variables, jnp.asarray(x), mutable=["intermediates"])
    return np.asarray(out), float(state["intermediates"]["moe_aux_loss"][0])


@pytest.mark.parametrize("k", [1, 2])
def test_matches_jax_and_the_dense_mixture_with_ample_capacity(k):
    jax_mod, variables, port = _pair(k=k)
    x = _tokens()
    want, want_aux = _apply(jax_mod, variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)
    assert abs(port.aux_loss.item() - want_aux) <= 1e-5 * abs(want_aux)
    # the dense top-k mixture, token by token (tanh GELU in the experts)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        probs = torch.softmax(port.router(xt), -1)
        vals, idx = torch.topk(probs, k)
        weights = vals / vals.sum(-1, keepdim=True)
        dense = torch.zeros(N, O)
        for n in range(N):
            for j in range(k):
                e = int(idx[n, j])
                h = torch.nn.functional.gelu(xt[n] @ port.w1[e] + port.b1[e], approximate="tanh")
                dense[n] += weights[n, j] * (h @ port.w2[e] + port.b2[e])
    torch.testing.assert_close(got, dense, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("capacity_factor", [0.5, 0.25])
def test_overflow_drops_the_same_pairs_as_jax(capacity_factor):
    jax_mod, variables, port = _pair(capacity_factor=capacity_factor)
    x = _tokens(seed=2)
    want, want_aux = _apply(jax_mod, variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **FP32_TOL)
    assert abs(port.aux_loss.item() - want_aux) <= 1e-5 * abs(want_aux)
    assert port.capacity(N) == max(1, min(math.ceil(2 * N / X * capacity_factor), N))
    dropped = (got.abs().sum(-1) == 0).numpy()  # both choices past capacity
    assert dropped.any() and np.array_equal(dropped, np.abs(want).sum(-1) == 0)


def test_aux_loss_matches_jax():
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(X), size=N).astype(np.float32)
    dispatch = (rng.random((N, X, 5)) < 0.2).astype(np.float32)
    want = float(jax_aux_loss(jnp.asarray(probs), jnp.asarray(dispatch)))
    got = switch_load_balancing_loss(torch.from_numpy(probs), torch.from_numpy(dispatch)).item()
    assert abs(got - want) <= 1e-6 * abs(want)


def test_dispatch_guard_and_refusals():
    port = MoEMLP(E, X, H, O, k=2, capacity_factor=2.0, max_dispatch_elements=1000)
    with pytest.raises(ValueError, match="max_dispatch_elements"):
        port(torch.zeros(N, E))
    with pytest.raises(ValueError, match="k=5"):
        MoEMLP(E, X, H, O, k=5)(torch.zeros(N, E))
    with pytest.raises(ValueError, match=r"\[N, E\]"):
        MoEMLP(E, X, H, O)(torch.zeros(2, N, E))
    # the mesh is JAX's placement field; here shard_moe_params places the
    # experts (tests/test_torch_expert_parallel.py); on one process nothing is cut
    with pytest.raises(ValueError, match="shard_moe_params"):
        MoEMLP(E, X, H, O, mesh=object())
    mesh = Mesh(size=1, rank=0, group=None, device=torch.device("cpu"))
    head = torch.nn.ModuleDict({"moe": MoEMLP(E, X, H, O)})
    assert shard_moe_params(head, mesh).cut == {} and head["moe"].w1.shape == (X, E, H)


def test_gradients_reach_router_and_experts():
    _, _, port = _pair()
    out = port(torch.from_numpy(_tokens(seed=4)))
    (out.square().sum() + port.aux_loss).backward()
    for name, param in port.named_parameters():
        assert param.grad is not None and torch.isfinite(param.grad).all(), name
        assert param.grad.abs().max() > 0, name


def test_lecun_normal_statistics():
    """flax's lecun_normal: truncated at ±2 of its scale, variance 1/fan_in,
    fan_in = every dimension but the last."""
    gen = torch.Generator().manual_seed(0)
    w = lecun_normal_(torch.empty(8, 64, 512), gen)
    fan_in = 8 * 64
    assert abs(w.var().item() * fan_in - 1.0) < 0.02
    assert w.abs().max().item() <= 2.0 * math.sqrt(1.0 / fan_in) / 0.87962566103423978 + 1e-7
    again = lecun_normal_(torch.empty(8, 64, 512), torch.Generator().manual_seed(0))
    assert torch.equal(w, again)
