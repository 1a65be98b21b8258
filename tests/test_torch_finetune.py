"""Probe training in the port (``FineTuneTrainer``) against the JAX package's.

The same probe parameters (``probes.params_from_jax``), the same backbone
weights (``models.beats.params_from_jax``) and the same seeded numpy batches
go through three JAX train steps (``_make_steps``; Pallas in interpret mode)
and three port ``_train_step`` calls (plain twins on the CPU), dropout 0:
AdamW with no decay mask, global-norm clipping in front, a cosine schedule.
Per-step loss within rel 1e-5 and the final parameters within atol 1e-5 /
rtol 1e-4, as in ``test_torch_training.py``. Cases: offline linear and
transformer probes; online frozen over a tiny BEATs, plain and on the K1
twin; online unfrozen with ``fused_qkv`` (the K2/K3 twins), the backbone's
parameters included; a multilabel BCE probe. Then the loop itself: the
best-validation restore and the offline and online entry points.
"""

import numpy as np
import pytest
import torch

import jax

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import ProbeConfig as JaxProbeConfig
from avex_tpu.configs import TrainingParams as JaxTrainingParams
from avex_tpu.evaluation.finetune import FineTuneTrainer as JaxFineTuneTrainer
from avex_tpu.parallel import replicate, shard_batch
from avex_tpu.probes import build_probe_from_config as jax_build_probe

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec, ProbeConfig, TrainingParams
from avex_tpu_torch.evaluation import FineTuneTrainer, train_and_eval_offline, train_and_eval_online
from avex_tpu_torch.models import beats
from avex_tpu_torch.parallel import make_mesh
from avex_tpu_torch.probes import build_probe_from_config, params_from_jax
from tests.test_torch_training import _zero_gradient
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

LOSS_REL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
BATCH, STEPS, NUM_CLASSES = 8, 3, 4
TRAINING = dict(train_epochs=2, lr=1e-3, batch_size=BATCH, weight_decay=0.01, gradient_clip_val=1.0,
                scheduler_type="cosine")
BEATS_TINY = {
    "encoder_layers": 2, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 96,
    "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0,
    "attention_dropout": 0.0, "encoder_layerdrop": 0.0,
}
BEATS_FUSED = dict(BEATS_TINY, encoder_embed_dim=128, encoder_attention_heads=2, fused_qkv=True, use_pallas=True)
RAW_AUDIO = {"representation": "raw", "normalize": False, "target_length_seconds": 1}


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


def _offline_batches(seed, dims, multilabel=False, n=STEPS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {f"embeddings_{i}": rng.standard_normal((BATCH,) + d).astype(np.float32) for i, d in enumerate(dims)}
        batch["label"] = ((rng.random((BATCH, NUM_CLASSES)) > 0.5).astype(np.float32) if multilabel
                          else rng.integers(0, NUM_CLASSES, BATCH))
        out.append(batch)
    return out


def _audio_batches(seed, n=STEPS):
    rng = np.random.default_rng(seed)
    return [{"raw_wav": (rng.standard_normal((BATCH, 16000)) * 0.1).astype(np.float32),
             "label": rng.integers(0, NUM_CLASSES, BATCH)} for _ in range(n)]


def _backbones(init_config):
    jax_model = avex_tpu.build_model_from_spec(JaxModelSpec(
        name="beats", pretrained=False, init_config=init_config, audio_config=RAW_AUDIO))
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(
        name="beats", pretrained=False, init_config=init_config, audio_config=RAW_AUDIO, device="cpu"))
    port.load_port_state_dict(beats.params_from_jax(_tree(jax_model.variables["params"])), strict=True)
    return jax_model, port


def _run(config, mode, batches, input_dim=None, backbone=None, multilabel=False):
    """Three steps of each trainer; returns (port trainer, JAX final
    trainable tree as numpy)."""
    jax_model, port_model = _backbones(backbone) if backbone else (None, None)
    jax_probe = jax_build_probe(JaxProbeConfig(**config), num_classes=NUM_CLASSES, base_model=jax_model,
                                input_dim=input_dim)
    probe = build_probe_from_config(config, num_classes=NUM_CLASSES, base_model=port_model, input_dim=input_dim,
                                    device=None if backbone else "cpu")
    probe.module.load_state_dict({k: torch.tensor(v) for k, v in
                                  params_from_jax(_tree(jax_probe.variables["params"])).items()})
    jax_trainer = JaxFineTuneTrainer(jax_probe, JaxTrainingParams(**TRAINING), multilabel=multilabel, mode=mode)
    trainer = FineTuneTrainer(probe, TrainingParams(**TRAINING), multilabel=multilabel, mode=mode)
    assert {k.split(".", 1)[0] for k in trainer._trainable} == set(jax_trainer._trainable)

    tx, train_step, _ = jax_trainer._make_steps(4)
    trainable = jax_trainer._place_trainable(jax_trainer._trainable)
    opt_state = replicate(tx.init(jax_trainer._trainable), jax_trainer.mesh)
    trainer._init_optimizer(4)
    rng = jax.random.PRNGKey(0)
    for batch in batches:
        rng, step_rng = jax.random.split(rng)
        trainable, opt_state, want, _ = train_step(trainable, opt_state, shard_batch(batch, jax_trainer.mesh), step_rng)
        got, logits = trainer._train_step(batch)
        assert logits.shape == (BATCH, NUM_CLASSES)
        assert abs(got.item() - float(want)) <= LOSS_REL * abs(float(want))
    return trainer, _tree(trainable)


def _assert_close_but_noise(state, want):
    """Every parameter within PARAM_TOL, but those whose exact gradient is 0:
    the key projection's bias, in a head's attention as in the backbone's.
    Their computed gradients are rounding noise, different in the two
    frameworks, which Adam scales up to ±lr per step."""
    for key, value in want.items():
        got = state[key].numpy()
        noise = np.ones(value.shape, bool) if key.endswith(".key.bias") else _zero_gradient(key, value.shape)
        np.testing.assert_allclose(got[~noise], value[~noise], err_msg=key, **PARAM_TOL)
        assert np.abs(got[noise] - value[noise]).max(initial=0.0) <= 2 * STEPS * TRAINING["lr"], key


def _assert_probe_params(trainer, want_tree):
    _assert_close_but_noise(trainer.probe.module.state_dict(), params_from_jax(want_tree["probe"]))


OFFLINE = {
    "linear": (dict(probe_type="linear"), [(24,)]),
    "transformer": (dict(probe_type="transformer", aggregation="none", num_heads=4, num_layers=1, attention_dim=32,
                         dropout_rate=0.0, use_positional_encoding=True, max_sequence_length=12), [(10, 16)]),
}


@pytest.mark.parametrize("name", list(OFFLINE))
def test_offline_steps_match_jax(name):
    config, dims = OFFLINE[name]
    trainer, want = _run(config, "offline", _offline_batches(7, dims), input_dim=dims[0])
    _assert_probe_params(trainer, want)


def test_multilabel_bce_steps_match_jax():
    dims = [(24,)]
    trainer, want = _run(dict(probe_type="mlp", hidden_dims=[16], dropout_rate=0.0), "offline",
                         _offline_batches(8, dims, multilabel=True), input_dim=dims[0], multilabel=True)
    _assert_probe_params(trainer, want)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "k1_twin"])
def test_online_frozen_steps_match_jax(use_pallas):
    """Frozen: only the probe trains; the backbone's weights stay bit for bit."""
    config = dict(probe_type="linear", aggregation="mean", target_layers=[1, "last_layer"])
    backbone = dict(BEATS_TINY, use_pallas=use_pallas)
    trainer, want = _run(config, "online", _audio_batches(9), backbone=backbone)
    _assert_probe_params(trainer, want)
    assert set(want) == {"probe"} and all(k.startswith("probe.") for k in trainer._trainable)
    base = trainer.probe.base_model
    before = beats.params_from_jax(_tree(_backbones(backbone)[0].variables["params"]))
    for key, value in base.state_dict().items():
        assert np.array_equal(value.numpy(), before[key]), key


def test_online_unfrozen_fused_qkv_steps_match_jax():
    """Unfrozen with fused_qkv: the backbone trains through the K2/K3 twins
    (JAX: Pallas in interpret mode) with the probe; the extraction forward
    (no dropout, no LayerDrop)."""
    config = dict(probe_type="attention", aggregation="none", target_layers=["last_layer"], num_heads=2,
                  num_layers=1, dropout_rate=0.0, freeze_backbone=False)
    trainer, want = _run(config, "online", _audio_batches(10), backbone=BEATS_FUSED)
    _assert_probe_params(trainer, want)
    _assert_close_but_noise(trainer.probe.base_model.state_dict(), beats.params_from_jax(want["backbone"]))
    assert trainer.train_backbone and any(k.startswith("backbone.") for k in trainer._trainable)


class _Loader(list):
    """A list of batches that counts its epochs."""

    epochs = 0

    def set_epoch(self, epoch):
        self.epochs = epoch + 1


def test_train_restores_best_validation_params_and_evaluates():
    dims = [(24,)]
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((NUM_CLASSES, 24)).astype(np.float32) * 3

    def split(n, seed):
        r = np.random.default_rng(seed)
        labels = r.integers(0, NUM_CLASSES, n)
        embs = centers[labels] + r.standard_normal((n, 24)).astype(np.float32)
        return _Loader({"embeddings_0": embs[s:s + BATCH], "label": labels[s:s + BATCH]} for s in range(0, n, BATCH))

    train, val, test = split(64, 1), split(32, 2), split(32, 3)
    metrics, trainer = train_and_eval_offline(
        ProbeConfig(probe_type="linear"), TrainingParams(train_epochs=6, lr=0.05, batch_size=BATCH), train, test,
        input_dims=dims, num_classes=NUM_CLASSES, val_loader=val, metrics=("accuracy", "balanced_accuracy"),
        device="cpu")
    assert train.epochs == 6
    assert metrics["accuracy"] > 0.9 and set(metrics) == {"accuracy", "balanced_accuracy", "loss"}
    assert trainer._best_params is not None
    for name, value in trainer._best_params.items():
        assert torch.equal(trainer._trainable[name].detach(), value), name
    assert trainer.evaluate(val)["accuracy"] == trainer.best_val_metric


def test_online_entry_point_trains_the_probe_only():
    model = avex_tpu_torch.build_model_from_spec(ModelSpec(
        name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW_AUDIO, device="cpu"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batches = _audio_batches(12, n=2)
    metrics, trainer = train_and_eval_online(
        ProbeConfig(probe_type="mlp", hidden_dims=[16], dropout_rate=0.5), TrainingParams(train_epochs=2, lr=1e-3,
                                                                                           batch_size=BATCH),
        model, batches, batches, num_classes=NUM_CLASSES, metrics=("accuracy",))
    assert set(metrics) == {"accuracy", "loss"} and np.isfinite(metrics["loss"])
    history_losses = [r["train_loss"] for r in trainer.train(batches)["history"]]
    assert all(np.isfinite(history_losses))
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key
    # a mesh of one process trains as no mesh does (two ranks: tests/test_torch_parallel_training.py)
    meshed = FineTuneTrainer(trainer.probe, TrainingParams(train_epochs=1, lr=1e-3, batch_size=2),
                             mesh=make_mesh(device="cpu"))
    assert meshed.mesh is None
