"""EAT-SSL pretraining in the PyTorch port against the JAX package, with the same weights.

A 2-block student and teacher (dim 128, 2 heads of 64), a 1-block decoder
of 128 (2 heads), ``mask_ratio`` 0.75 over a 128-frame fbank: 64 patches, 48
masked, 16 visible. JAX's variables are carried across with
``params_from_jax``. JAX's mask draw is captured by wrapping
``jax.random.uniform`` around an un-jitted ``apply`` (or, through
``jax.debug.callback``, a jitted Trainer step) and handed to the port's
draw, ``eat_ssl.mask_noise``.
JAX takes plain attention on the CPU; the port runs its plain path and,
with ``use_pallas``, the K5/K6 twins.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avex_tpu.configs import DatasetCollectionConfig, DatasetConfig
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import RunConfig as JaxRunConfig
from avex_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from avex_tpu.configs import TrainingParams as JaxTrainingParams
from avex_tpu.models.eat_ssl import Model as JaxEATSSL
from avex_tpu.models.eat_ssl import ema_update as jax_ema_update
from avex_tpu.parallel import shard_batch
from avex_tpu.training import Trainer as JaxTrainer

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.models import eat_ssl
from avex_tpu_torch.models.registry import register_model_class
from avex_tpu_torch.training import Trainer, make_strategy
from avex_tpu_torch.training.strategies import EATSSLStrategy
from tests.test_torch_beats import BF16_POOLED_REL, FP32_TOL, _np, _rel
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

CFG = dict(dim=128, depth=2, heads=2, decoder_dim=128, decoder_depth=1, mask_ratio=0.75, target_length=128)
N_PATCHES, N_MASKED = 64, 48
BATCH = 8
LOSS_REL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
TRAINING = dict(train_epochs=1, lr=1e-3, batch_size=BATCH, optimizer="adamw", weight_decay=0.01, log_steps=100)
ROUTES = pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "k5_k6_twins"])
ADAM_EPS = 1e-8  # optax's scale_by_adam


def adam_direction(grad):
    """Adam's first update of a gradient, ``m̂ / (sqrt(v̂) + eps)``: ``g / (|g| + eps)``."""
    g = np.asarray(grad, np.float64)
    return g / (np.abs(g) + ADAM_EPS)


def hold_adam_step(got, want, key, got_grad, want_grad, lr, share=1.0, tol=PARAM_TOL):
    """A parameter after one AdamW step against another step's: within
    ``tol`` plus, entry by entry, lr times the distance between the Adam
    directions of the gradients the two steps applied (``share`` of it for an
    EMA teacher, from its student's). Adam's first update is lr·g/(|g| + eps),
    about ±lr however small g is, so an entry whose gradient is rounding
    noise (the key bias's: exactly 0 in exact arithmetic) or near eps moves
    by what its noise says; the gradients themselves are held on their own."""
    slack = share * lr * np.abs(adam_direction(got_grad) - adam_direction(want_grad))
    excess = np.abs(got.astype(np.float64) - want) - (tol["atol"] + tol["rtol"] * np.abs(want) + slack)
    worst = np.unravel_index(np.argmax(excess), excess.shape) if excess.size else ()
    assert excess.size == 0 or excess[worst] <= 0, (key, worst, got[worst], want[worst], slack[worst])


def build_pair(use_pallas=False, compute_dtype="float32", **cfg):
    """(JAX ``Model``, port ``Model`` on the CPU) with the same weights."""
    eat_cfg = dict(CFG, **cfg)
    jax_model = JaxEATSSL(eat_cfg=dict(eat_cfg), compute_dtype=compute_dtype, seed=0)
    port = eat_ssl.Model(device="cpu", eat_cfg=dict(eat_cfg), compute_dtype=compute_dtype, use_pallas=use_pallas,
                         seed=5)
    state = eat_ssl.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.variables["params"]))
    assert set(state) == set(port.state_dict()), set(state) ^ set(port.state_dict())
    port.load_port_state_dict(state, strict=True)
    return jax_model, port


def capture_jax_noise(monkeypatch):
    """Record every ``jax.random.uniform`` draw: a concrete one (outside jit)
    at once, a traced one through ``jax.debug.callback`` when its program
    runs (``jax.effects_barrier()`` waits for it)."""
    seen = []
    real = jax.random.uniform

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        if isinstance(out, jax.core.Tracer):
            jax.debug.callback(lambda value: seen.append(np.asarray(value)), out)
        else:
            seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "uniform", recording)
    return seen


def give_port_noise(monkeypatch, noise):
    monkeypatch.setattr(eat_ssl, "mask_noise", lambda bsz, n, generator, device: torch.from_numpy(noise.copy()).to(device))


def _wav(seed, batch=2):
    return (np.random.default_rng(seed).standard_normal((batch, 16000)) * 0.1).astype(np.float32)


def _jax_loss_and_grads(jax_model, wav):
    """JAX's strategy total (regression / sample size), its predictions and
    the gradient of every parameter, un-jitted so the mask draw is concrete."""
    key = jax.random.PRNGKey(7)

    def loss_fn(params):
        result, _ = jax_model.module.apply({"params": params}, wav, deterministic=False,
                                           rngs={"mask": key, "dropout": key})
        return result["losses"]["regression"] / result["sample_size"], result

    (loss, result), grads = jax.value_and_grad(loss_fn, has_aux=True)(jax_model.variables["params"])
    return loss, result, grads


@ROUTES
def test_loss_predictions_and_gradients_match_jax(monkeypatch, use_pallas):
    jax_model, port = build_pair(use_pallas)
    wav = _wav(1)
    seen = capture_jax_noise(monkeypatch)
    loss_j, result_j, grads_j = _jax_loss_and_grads(jax_model, wav)
    assert len(seen) == 1 and seen[0].shape == (2, N_PATCHES)
    give_port_noise(monkeypatch, seen[0])

    port.module.train()
    trainable = {n: p for n, p in port.module.named_parameters() if not n.startswith("teacher.")}
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in port.module.teacher.parameters())
    loss_t, metrics = EATSSLStrategy().forward_loss(port.train_forward, {"raw_wav": torch.from_numpy(wav)},
                                                    torch.Generator().manual_seed(0), train=True)
    assert metrics["count"] == result_j["sample_size"] == 2 * N_MASKED
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=LOSS_REL)
    np.testing.assert_allclose(metrics["loss_regression"].item(), float(result_j["losses"]["regression"]),
                               rtol=LOSS_REL)
    # predictions: re-run the port forward on the same draw
    with torch.no_grad():
        result_t, _ = port.module(torch.from_numpy(wav), deterministic=False, generator=torch.Generator())
    assert result_t["predictions"].shape == (2, N_MASKED, CFG["dim"])
    np.testing.assert_allclose(_np(result_t["predictions"]), _np(result_j["predictions"]), **FP32_TOL)

    grads_t = torch.autograd.grad(loss_t, list(trainable.values()))
    want = eat_ssl.params_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    for (name, _), got in zip(trainable.items(), grads_t):
        np.testing.assert_allclose(got.numpy(), want[name], err_msg=name, **FP32_TOL)
    # the teacher takes no gradient in JAX either (a stopped target)
    assert all(not np.any(v) for k, v in want.items() if k.startswith("teacher."))


@ROUTES
def test_deterministic_path_encodes_the_first_visible_patches(use_pallas):
    """As in JAX, the inference path's order is arange(n): the student sees
    the first n - int(mask_ratio·n) patches."""
    jax_model, port = build_pair(use_pallas)
    wav = _wav(2)
    want, aux_j = jax_model.module.apply(jax_model.variables, wav, deterministic=True)
    with torch.no_grad():
        got, aux_t = port.module(torch.from_numpy(wav))
    assert got.shape == (2, N_PATCHES - N_MASKED, CFG["dim"])
    np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)
    np.testing.assert_allclose(_np(aux_t["intermediates"]["student.norm"]),
                               _np(aux_j["intermediates"]["student.norm"]), **FP32_TOL)
    # the wrapper's extraction reads the same tap
    port.register_hooks_for_layers(["last_layer"])
    assert port.get_model_layers() == ["student.norm"]
    emb = port.extract_embeddings(wav, aggregation="mean")
    np.testing.assert_allclose(emb.numpy(), _np(want).mean(axis=1), **FP32_TOL)


def test_bf16_loss_matches_jax(monkeypatch):
    jax_model, port = build_pair(True, compute_dtype="bfloat16")
    wav = _wav(3)
    seen = capture_jax_noise(monkeypatch)
    loss_j, result_j, _ = _jax_loss_and_grads(jax_model, wav)
    give_port_noise(monkeypatch, seen[0])
    with torch.no_grad():
        result_t, _ = port.module(torch.from_numpy(wav), deterministic=False, generator=torch.Generator())
    assert result_t["predictions"].dtype == torch.bfloat16
    assert _rel(result_t["predictions"].float().mean(dim=1), result_j["predictions"].astype(jnp.float32).mean(axis=1)) \
        <= BF16_POOLED_REL
    np.testing.assert_allclose(result_t["losses"]["regression"].item(), float(result_j["losses"]["regression"]),
                               rtol=BF16_POOLED_REL)


def test_ema_update_matches_jax():
    jax_model, port = build_pair()
    params = jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])
    params["student"] = jax.tree_util.tree_map(lambda x: x + 0.5 * np.sign(x) + 0.25, params["student"])
    want = eat_ssl.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_ema_update(params, 0.9)))
    port.load_port_state_dict(eat_ssl.params_from_jax(params), strict=True)
    port.ema_decay = 0.9
    port.post_optimizer_step()
    state = port.state_dict()
    for key, value in want.items():
        np.testing.assert_allclose(state[key].numpy(), value, err_msg=key, **FP32_TOL)
    # fresh storage: the teacher is a copy, not the student's tensors
    assert port.module.teacher.norm.weight.data_ptr() != port.module.student.norm.weight.data_ptr()


def _batches(seed, n=1):
    return [{"raw_wav": _wav(seed + i, BATCH), "label": np.zeros(BATCH, np.int64)} for i in range(n)]


def _configs(tmp_path, warmup_steps=1, **eat_cfg):
    cfg = dict(CFG, ema_decay=0.9, **eat_cfg)
    jax_config = JaxRunConfig(
        model_spec=JaxModelSpec(name="beats", pretrained=False),  # the JAX package's placeholder spec
        training_params=JaxTrainingParams(**TRAINING),
        dataset_config=DatasetCollectionConfig(
            train_datasets=[DatasetConfig(name="s", kind="synthetic", num_samples=8, num_classes=2)]),
        output_dir=str(tmp_path / "jax"), scheduler=JaxSchedulerConfig(name="cosine", warmup_steps=warmup_steps),
        label_type="self_supervised", seed=0,
    )
    config = RunConfig(
        model_spec=ModelSpec(name="eat_ssl", pretrained=False, eat_cfg=cfg, device="cpu"),
        training_params=TrainingParams(**TRAINING), output_dir=str(tmp_path / "port"),
        scheduler=SchedulerConfig(name="cosine", warmup_steps=warmup_steps), label_type="self_supervised", seed=0,
        device="cpu",
    )
    return jax_config, config


@ROUTES
def test_trainer_step_with_its_ema_matches_jax(tmp_path, monkeypatch, use_pallas):
    """One AdamW step of JAX's Trainer and the port's, at the full learning
    rate (no warmup: a warmup step would update at lr 0): the loss, the
    gradient the step applied, the student after the update and the teacher
    after the EMA refresh. JAX's step runs jitted, as its Trainer runs it:
    un-jitted, its thousands of eager dispatches once aborted an xdist
    worker in JAX's runtime."""
    jax_model, port = build_pair(use_pallas, ema_decay=0.9)
    jax_config, config = _configs(tmp_path, warmup_steps=0)
    batch = _batches(seed=20)[0]
    jax_trainer = JaxTrainer(jax_model, jax_config, [batch], steps_per_epoch=2)
    seen = capture_jax_noise(monkeypatch)
    jax_trainer.state, want_loss, want_metrics = jax_trainer._train_step(
        jax_trainer.state, shard_batch(batch, jax_trainer.mesh))
    jax.effects_barrier()
    assert len(seen) == 1
    give_port_noise(monkeypatch, seen[0])

    register_model_class("eat_ssl", eat_ssl.Model)
    trainer = Trainer(port, config, [batch], steps_per_epoch=2)
    assert set(trainer._trainable) == {n for n, _ in port.module.named_parameters() if not n.startswith("teacher.")}
    before = {k: v.clone() for k, v in port.state_dict().items()}
    loss, metrics = trainer._train_step(batch)
    assert abs(loss.item() - float(want_loss)) <= LOSS_REL * abs(float(want_loss))
    assert metrics["count"] == int(want_metrics["count"]) == BATCH * N_MASKED
    np.testing.assert_allclose(metrics["loss_regression"].item(), float(want_metrics["loss_regression"]),
                               rtol=LOSS_REL)
    want = eat_ssl.params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_trainer.state.params)))
    # the gradient each step applied: after one step Adam's first moment is (1 - b1)·g
    adam = next(x for x in jax.tree_util.tree_leaves(jax_trainer.state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu"))
    want_grads = eat_ssl.params_from_jax(jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1,
                                                                jax.device_get(adam.mu)))
    got_grads = {k: v.numpy() / np.float32(0.1) for k, v in trainer.state.opt_state["mu"].items()}
    assert set(got_grads) == set(trainer._trainable)
    for key, got in got_grads.items():
        value = want_grads[key]
        if key.endswith("attn.qkv.bias"):  # the key third's exact gradient is 0: rounding noise on both sides
            third = value.shape[0] // 3
            got, value = np.delete(got, np.s_[third:2 * third]), np.delete(value, np.s_[third:2 * third])
        np.testing.assert_allclose(got, value, err_msg=key, **FP32_TOL)
    state = port.state_dict()
    assert not torch.equal(state["student.blocks.0.mlp.fc1.weight"], before["student.blocks.0.mlp.fc1.weight"])
    for key, value in want.items():
        source = "student." + key[len("teacher."):] if key.startswith("teacher.") else key
        hold_adam_step(state[key].numpy(), value, key, got_grads[source], want_grads[source], TRAINING["lr"],
                       share=0.1 if key.startswith("teacher.") else 1.0)
    # the teacher moved by the EMA and only by it
    for name, value in before.items():
        if name.startswith("teacher."):
            student = state["student." + name[len("teacher."):]]
            torch.testing.assert_close(state[name], 0.9 * value + 0.1 * student, atol=1e-6, rtol=1e-6)


def test_eval_step_raises_as_jax_fails(tmp_path):
    _, config = _configs(tmp_path)
    port = eat_ssl.Model(device="cpu", eat_cfg=dict(CFG))
    trainer = Trainer(port, config, _batches(seed=30), val_loader=_batches(seed=31))
    with pytest.raises(ValueError, match="no validation loss"):
        trainer._eval_step(_batches(seed=31)[0])
    with pytest.raises(ValueError, match="no validation loss"):
        trainer.train()


def test_checkpoint_round_trip_keeps_the_teacher(tmp_path):
    register_model_class("eat_ssl", eat_ssl.Model)
    _, config = _configs(tmp_path)
    model = avex_tpu_torch.build_model_from_spec(config.model_spec)
    assert isinstance(model, eat_ssl.Model) and model.ema_decay == 0.9
    trainer = Trainer(model, config, _batches(seed=40, n=2))
    initial_teacher = model.module.teacher.norm.bias.clone()
    result = trainer.train()
    assert np.isfinite(result["history"][0]["train"]["loss"])
    assert result["history"][0]["train"]["loss_regression"] > 0
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    assert not torch.equal(trained["teacher.norm.bias"], initial_teacher)
    assert not torch.equal(trained["teacher.norm.bias"], trained["student.norm.bias"])

    fresh = eat_ssl.Model(device="cpu", eat_cfg=dict(CFG, ema_decay=0.9), seed=9)
    resumed = Trainer(fresh, config.replace(resume_from_checkpoint=result["final_checkpoint"]), _batches(seed=40))
    for key, value in trained.items():
        assert torch.equal(fresh.state_dict()[key], value), key
    assert set(resumed.state.opt_state["mu"]) == set(resumed._trainable)


def test_strategy_totals_and_registration():
    assert isinstance(make_strategy("self_supervised"), EATSSLStrategy)

    def apply_fn(wav, mask, deterministic=True, generator=None):
        return {"losses": {"main": torch.tensor([2.0, 4.0]), "decay": torch.tensor(6.0)}, "sample_size": 4}, {}

    loss, metrics = EATSSLStrategy().forward_loss(apply_fn, {"raw_wav": torch.zeros(4, 10)}, None, train=True)
    assert loss.item() == pytest.approx((2 + 4 + 6) / 4)
    assert metrics["loss_main"].item() == 6.0 and metrics["loss_decay"].item() == 6.0 and metrics["count"] == 4
    with pytest.raises(ValueError, match="torch.Generator"):
        eat_ssl.Model(device="cpu", eat_cfg=dict(CFG)).module(torch.zeros(1, 16000), deterministic=False)
    register_model_class("eat_ssl", eat_ssl.Model)
    assert avex_tpu_torch.get_model_class("eat_ssl") is eat_ssl.Model
