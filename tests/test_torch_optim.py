"""The port's losses, schedules, optimizers, metrics and metrics tracker
against the JAX package's (optax, scikit-learn) on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import SchedulerConfig as JaxSched
from avex_tpu import metrics as jax_metrics
from avex_tpu.training import losses as jax_losses
from avex_tpu.training import optimizers as jax_optim
from avex_tpu.training.metrics_tracker import MetricsTracker as JaxTracker

import avex_tpu_torch
from avex_tpu_torch import metrics
from avex_tpu_torch.configs import ModelSpec, SchedulerConfig
from avex_tpu_torch.models.beats import params_from_jax
from avex_tpu_torch.training import losses, optimizers
from avex_tpu_torch.training.metrics_tracker import MetricsTracker
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

# fp32: the same operations in the same order up to the rounding of a few
# scalars (optax evaluates its schedules in fp32, the port in fp64).
REL = 1e-6
TINY = {
    "encoder_layers": 1,
    "encoder_embed_dim": 64,
    "encoder_ffn_embed_dim": 96,
    "encoder_attention_heads": 4,
    "embed_dim": 32,
}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("targets", ["indices", "one_hot", "multi_hot"])
@pytest.mark.parametrize("name", ["cross_entropy", "bce", "focal"])
def test_losses_match_jax(rng, name, targets):
    logits = (rng.standard_normal((16, 5)) * 3).astype(np.float32)
    idx = rng.integers(0, 5, 16)
    labels = {
        "indices": idx,
        "one_hot": np.eye(5, dtype=np.float32)[idx],
        "multi_hot": (rng.random((16, 5)) < 0.3).astype(np.float32),
    }[targets]
    want = jax_losses.build_criterion(name)(jnp.asarray(logits), jnp.asarray(labels))
    got = losses.build_criterion(name)(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert _rel(got.item(), float(want)) < REL


def test_bf16_logits_compute_in_fp32(rng):
    logits = rng.standard_normal((8, 5)).astype(np.float32)
    idx = rng.integers(0, 5, 8)
    want = jax_losses.cross_entropy_loss(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(idx))
    got = losses.cross_entropy_loss(torch.from_numpy(logits).bfloat16(), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and _rel(got.item(), float(want)) < REL


def test_clip_loss_matches_jax(rng):
    audio, text = (rng.standard_normal((12, 16)).astype(np.float32) for _ in range(2))
    for scale in (np.float32(2.0), np.float32(9.0)):  # 9 > ln(100): clamped
        want, want_aux = jax_losses.clip_loss(jnp.asarray(audio), jnp.asarray(text), jnp.asarray(scale))
        got, aux = losses.clip_loss(torch.from_numpy(audio), torch.from_numpy(text), torch.tensor(scale))
        assert _rel(got.item(), float(want)) < REL
        for key in ("a2t_correct", "t2a_correct"):
            assert int(aux[key]) == int(want_aux[key])
    with pytest.raises(ValueError, match="Unknown loss"):
        losses.build_criterion("hinge")


SCHEDULES = [(name, warmup) for name in ("none", "cosine", "linear") for warmup in (0, 5)]


@pytest.mark.parametrize("name,warmup", SCHEDULES)
def test_schedules_match_optax_step_by_step(name, warmup):
    total, lr, min_lr = 40, 3e-3, 1e-4
    want = jax_optim.build_scheduler(name, lr, warmup, total, min_lr)
    got = optimizers.build_scheduler(name, lr, warmup, total, min_lr)
    for step in range(total + 3):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=REL, atol=REL * lr)
    if warmup:
        assert got(0) == 0.0  # the first update of a warmup uses lr 0


def _tiny_pair():
    jax_model = avex_tpu.build_model_from_spec(
        JaxModelSpec(name="beats", pretrained=False, init_config=TINY), num_classes=3, seed=1
    )
    port = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="beats", pretrained=False, init_config=TINY), device="cpu", num_classes=3
    )
    params = jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])
    port.load_port_state_dict(params_from_jax(params), strict=True)
    return params, port


def test_decay_mask_matches_jax():
    """The port's mask against JAX's, carried through ``params_from_jax``'s
    key map: each JAX leaf becomes a constant tensor of its mask bit."""
    params, port = _tiny_pair()
    want_tree = jax_optim._weight_decay_mask(params)
    as_arrays = jax.tree_util.tree_map(lambda p, m: np.full(np.shape(p), float(m), np.float32), params, want_tree)
    want = {k: bool(v.flat[0]) for k, v in params_from_jax(as_arrays).items()}
    got = optimizers._weight_decay_mask(port.module)
    assert got == want
    enc = "backbone.encoder."
    assert not got[enc + "relative_attention_bias.weight"] and not got[enc + "layers.0.self_attn.grep_a"]
    assert got[enc + "pos_conv.weight"] and got["backbone.patch_embedding.weight"]


CHAINS = {
    "adam": dict(optimizer="adam", weight_decay=0.0, gradient_clip_val=None),
    "adamw": dict(optimizer="adamw", weight_decay=0.05, gradient_clip_val=None),
    "adamw8bit": dict(optimizer="adamw8bit", weight_decay=0.05, gradient_clip_val=None),
    "adamw_clipped": dict(optimizer="adamw", weight_decay=0.05, gradient_clip_val=0.5),
}


class _Params:
    def __init__(self, **kw):
        self.__dict__.update(dict(lr=2e-2, adam_betas=None, scheduler_type="none"), **kw)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_optimizer_updates_match_optax(rng, chain):
    """Five updates on the same numpy gradients: optax on the JAX tree, the
    port in place on the module's parameters (a cosine schedule with warmup,
    so the count each update reads matters)."""
    params, port = _tiny_pair()
    cfg = _Params(**CHAINS[chain])
    tx, _ = jax_optim.make_optimizer(cfg, JaxSched(name="cosine", warmup_steps=2), total_steps=8, params=params)
    port_tx, _ = optimizers.make_optimizer(cfg, SchedulerConfig(name="cosine", warmup_steps=2), total_steps=8,
                                           params=port.module)
    named = dict(port.module.named_parameters())
    state, port_state = tx.init(params), port_tx.init(named)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for _ in range(5):
        grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32), params)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        port_grads = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params_from_jax(grads).items()}
        port_tx.step(named, port_grads, port_state)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert port_state["count"] == 5
    for key, value in want.items():
        assert _rel(named[key].detach().numpy(), value) < REL, key
    if chain == "adamw8bit":
        assert all(m.dtype == torch.bfloat16 for m in port_state["mu"].values())


def test_unknown_optimizer_and_scheduler_raise():
    with pytest.raises(ValueError, match="Unknown optimizer"):
        optimizers.get_optimizer("sgd", 1e-3)
    with pytest.raises(ValueError, match="Unknown scheduler"):
        optimizers.build_scheduler("exponential")


METRICS = ["accuracy", "balanced_accuracy", "multiclass_f1", "map", "average_precision", "roc_auc"]


@pytest.mark.parametrize("name", METRICS)
def test_metrics_match_jax(rng, name):
    ours, theirs = metrics.get_metric_class(name, 4), jax_metrics.get_metric_class(name, 4)
    for _ in range(3):
        logits = rng.standard_normal((20, 4)).astype(np.float32)
        labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 20)]
        ours.update(logits, labels)
        theirs.update(logits, labels)
    np.testing.assert_allclose(ours.get_primary_metric(), theirs.get_primary_metric(), rtol=1e-12)


def test_binary_metrics_and_edge_cases_match_jax(rng):
    logits = rng.standard_normal((30, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 30)
    logits[:6, 1] = 0.25  # ties among the scores
    for name in ("binary_f1", "roc_auc", "accuracy"):
        ours, theirs = metrics.get_metric_class(name), jax_metrics.get_metric_class(name)
        ours.update(logits, labels)
        theirs.update(logits, labels)
        np.testing.assert_allclose(ours.get_primary_metric(), theirs.get_primary_metric(), rtol=1e-12)
    one_class = metrics.get_metric_class("roc_auc")
    one_class.update(logits, np.zeros(30, int))
    assert one_class.get_primary_metric() == 0.0
    with pytest.raises(ValueError, match="Unknown metric"):
        metrics.get_metric_class("top5")


def test_metrics_tracker_matches_jax(rng):
    ours = MetricsTracker("supervised", ["accuracy", "balanced_accuracy"], 3)
    theirs = JaxTracker("supervised", ["accuracy", "balanced_accuracy"], 3)
    for _ in range(3):
        logits = rng.standard_normal((8, 3)).astype(np.float32)
        labels = rng.integers(0, 3, 8)
        loss = np.float32(rng.random())
        step = {"logits": logits, "correct": int((logits.argmax(1) == labels).sum()), "count": 8,
                "nonfinite_logits": 0}
        theirs.update(loss, step, labels=labels)
        ours.update(torch.tensor(loss), {k: torch.as_tensor(v) for k, v in step.items()}, labels=labels)
    want, got = theirs.epoch_metrics(), ours.epoch_metrics()
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    assert ours.primary_metric() == theirs.primary_metric()
