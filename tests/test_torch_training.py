"""Supervised fine-tuning in the port against the JAX package's Trainer.

Tiny BEATs (the 2-layer, 64-d, 4-head model of the JAX package's own
training tests, and a 128-d, 2-head ``fused_qkv`` one whose attention takes
the K2/K3 route) and a tiny EAT (the K5/K6 route) start from the same
weights (``params_from_jax``) and take the same seeded numpy batches; three
JAX ``Trainer._train_step`` calls (Pallas kernels in interpret mode) are held
against three port steps (plain twins on the CPU). Then the port alone:
two-stage training, checkpoints and resume, the rolling ``_next`` recovery,
SIGTERM, gradient checkpointing, and dropout / LayerDrop statistics (their
random streams cannot match JAX's).
"""

import signal

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

import avex_tpu
from avex_tpu.configs import DatasetCollectionConfig, DatasetConfig
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import RunConfig as JaxRunConfig
from avex_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from avex_tpu.configs import TrainingParams as JaxTrainingParams
from avex_tpu.models.eat import EATModel as JaxEATModel
from avex_tpu.parallel import shard_batch
from avex_tpu.training import Trainer as JaxTrainer

import avex_tpu_torch
from avex_tpu_torch.configs import MeshConfig, ModelSpec, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.models import beats, eat
from avex_tpu_torch.models.common import dropout
from avex_tpu_torch.parallel import make_mesh
from avex_tpu_torch.training import Trainer, TrainerFactory, make_strategy
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

# Per-step loss and final parameters: fp32 on both sides, the same operations
# summed in other orders (fbank, attention, the optimizer's global sums).
LOSS_REL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
NUM_CLASSES, BATCH, STEPS = 4, 8, 3

BEATS_TINY = {  # the JAX package's tests/unittests/test_training.py model
    "encoder_layers": 2, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 96,
    "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0,
    "attention_dropout": 0.0, "encoder_layerdrop": 0.0,
}
BEATS_FUSED = dict(BEATS_TINY, encoder_embed_dim=128, encoder_attention_heads=2, fused_qkv=True, use_pallas=True)
EAT_TINY = dict(depth=2, dim=128, heads=2, target_length=64)
RAW_AUDIO = {"representation": "raw", "normalize": False, "target_length_seconds": 1,
             "window_selection": "random"}
TRAINING = dict(train_epochs=2, lr=1e-3, batch_size=BATCH, optimizer="adamw", weight_decay=0.01, log_steps=100)


def _batches(seed, n=STEPS, one_hot=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, NUM_CLASSES, BATCH)
        out.append({
            "raw_wav": (rng.standard_normal((BATCH, 16000)) * 0.1).astype(np.float32),
            "label": np.eye(NUM_CLASSES, dtype=np.float32)[labels] if one_hot else labels,
        })
    return out


def _port_config(tmp_path, name, init_config, **overrides):
    training = dict(TRAINING, **overrides.pop("training", {}))
    return RunConfig(
        model_spec=ModelSpec(name=name, pretrained=False, init_config=init_config, device="cpu",
                             audio_config=RAW_AUDIO if name == "beats" else None),
        training_params=TrainingParams(**training),
        output_dir=str(tmp_path / "port"),
        scheduler=SchedulerConfig(name="cosine", warmup_steps=1),
        seed=0,
        device="cpu",
        **overrides,
    )


def _port_model(config, **kwargs):
    return avex_tpu_torch.build_model_from_spec(config.model_spec, num_classes=NUM_CLASSES, **kwargs)


def _jax_pair(tmp_path, name, init_config):
    """(JAX model, port model) with the same weights, and both run configs."""
    jax_init = {k: v for k, v in init_config.items() if k != "use_pallas"} if name == "eat_hf" else init_config
    jax_config = JaxRunConfig(
        model_spec=JaxModelSpec(name=name, pretrained=False, init_config=jax_init,
                                audio_config=RAW_AUDIO if name == "beats" else None),
        training_params=JaxTrainingParams(**TRAINING),
        dataset_config=DatasetCollectionConfig(
            train_datasets=[DatasetConfig(name="synth", kind="synthetic", num_samples=8, num_classes=4)]
        ),
        output_dir=str(tmp_path / "jax"),
        scheduler=JaxSchedulerConfig(name="cosine", warmup_steps=1),
        seed=0,
    )
    jax_model = avex_tpu.build_model_from_spec(jax_config.model_spec, num_classes=NUM_CLASSES)
    if name == "eat_hf":  # the JAX wrapper does not expose use_pallas: K5/K6 on its module
        jax_model.module = JaxEATModel(**jax_model._module_kwargs, use_pallas=True)
    config = _port_config(tmp_path, name, init_config)
    port = _port_model(config)
    params = jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])
    module = beats if name == "beats" else eat
    port.load_port_state_dict(module.params_from_jax(params), strict=True)
    return jax_model, port, jax_config, config


PAIRS = {
    "beats": ("beats", BEATS_TINY),
    "beats_fused_k3": ("beats", BEATS_FUSED),
    "eat_k6": ("eat_hf", dict(EAT_TINY, use_pallas=True)),
}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_train_steps_match_jax_trainer(tmp_path, pair):
    """Three AdamW steps (masked weight decay, cosine schedule with warmup):
    per-step loss and the final parameters."""
    name, init_config = PAIRS[pair]
    jax_model, port, jax_config, config = _jax_pair(tmp_path, name, init_config)
    batches = _batches(seed=11)
    jax_trainer = JaxTrainer(jax_model, jax_config, batches, steps_per_epoch=4)
    trainer = Trainer(port, config, batches, steps_per_epoch=4)
    for batch in batches:
        jax_trainer.state, want, _ = jax_trainer._train_step(jax_trainer.state, shard_batch(batch, jax_trainer.mesh))
        got, metrics = trainer._train_step(batch)
        assert abs(got.item() - float(want)) <= LOSS_REL * abs(float(want))
        assert metrics["count"] == BATCH and int(metrics["nonfinite_logits"]) == 0
    module = beats if name == "beats" else eat
    want_params = module.params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_trainer.state.params)))
    state = port.state_dict()
    for key, value in want_params.items():
        got, noise = state[key].numpy(), _zero_gradient(key, value.shape)
        np.testing.assert_allclose(got[~noise], value[~noise], err_msg=key, **PARAM_TOL)
        # Adam scales a gradient of rounding noise up to ±lr per step
        assert np.abs(got[noise] - value[noise]).max(initial=0.0) <= 2 * STEPS * TRAINING["lr"], key
    assert trainer.state.step == STEPS and trainer.state.opt_state["count"] == STEPS


def _zero_gradient(key, shape):
    """The entries whose exact gradient is 0: the key projection's bias (a
    softmax does not see a shift that is the same for every key). Their
    computed gradients are rounding noise, different in the two frameworks."""
    noise = np.zeros(shape, bool)
    if key.endswith("k_proj.bias"):
        noise[:] = True
    elif key.endswith(("qkv_proj.bias", "attn.qkv.bias")):
        noise[shape[0] // 3: 2 * shape[0] // 3] = True
    return noise


def test_stage_one_freezes_the_backbone_as_jax_does(tmp_path):
    """Two-stage fine-tuning, stage 1: the classifier trains, the backbone
    takes no update and no weight decay; the same as JAX's stage 1."""
    jax_model, port, jax_config, config = _jax_pair(tmp_path, "beats", BEATS_TINY)
    jax_config = jax_config.model_copy(update={"training_params": JaxTrainingParams(**TRAINING, freeze_backbone_epochs=1)})
    config = config.replace(training_params=TrainingParams(**TRAINING, freeze_backbone_epochs=1))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    batches = _batches(seed=12, n=2)
    jax_trainer = JaxTrainer(jax_model, jax_config, batches, steps_per_epoch=2)
    trainer = Trainer(port, config, batches, steps_per_epoch=2)
    trainer._run_epoch(batches, train=True, epoch=0)
    for batch in batches:
        jax_trainer.state, *_ = jax_trainer._train_step(jax_trainer.state, shard_batch(batch, jax_trainer.mesh))
    after = port.state_dict()
    for key, value in before.items():
        if key.startswith("backbone."):
            assert torch.equal(after[key], value), key  # bit-identical
    assert not torch.equal(after["classifier.weight"], before["classifier.weight"])
    want = beats.params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_trainer.state.params)))
    np.testing.assert_allclose(after["classifier.weight"].numpy(), want["classifier.weight"], **PARAM_TOL)
    assert set(trainer._trainable) == {"classifier.weight", "classifier.bias"}


def test_stage_two_rebuilds_the_optimizer(tmp_path):
    """After the frozen epochs: the whole model trains, at second_stage_lr
    (default 0.1 · lr), from fresh optimizer state (the schedule restarts)."""
    config = _port_config(tmp_path, "beats", BEATS_TINY,
                          training=dict(freeze_backbone_epochs=1, train_epochs=2))
    config = config.replace(scheduler=SchedulerConfig(name="none"))
    port = _port_model(config)
    initial = {k: v.clone() for k, v in port.state_dict().items()}
    batches = _batches(seed=13, n=2, one_hot=False)
    trainer = Trainer(port, config, batches)
    assert trainer._schedule(0) == TRAINING["lr"]
    result = trainer.train()
    assert trainer._stage == 2 and trainer._schedule(0) == pytest.approx(0.1 * TRAINING["lr"])
    assert trainer.state.opt_state["count"] == len(batches)  # restarted at stage 2
    assert set(trainer._trainable) == set(dict(port.module.named_parameters()))
    final = port.state_dict()
    assert not torch.equal(final["backbone.encoder.layers.0.fc1.weight"], initial["backbone.encoder.layers.0.fc1.weight"])
    assert len(result["history"]) == 2 and trainer.checkpoints.exists("final_model")


def test_checkpoint_round_trip_and_resume(tmp_path):
    """A step checkpoint restores the parameters, the optimizer state, the
    step, the position in the epoch and the generator; the resumed run then
    takes the same next step as the uninterrupted one."""
    config = _port_config(tmp_path, "beats", dict(BEATS_TINY, dropout=0.1, encoder_layerdrop=0.2),
                          checkpoint_every_steps=2)
    batches = _batches(seed=14, n=3)
    trainer = Trainer(_port_model(config), config, batches)
    for batch in batches[:2]:
        trainer._train_step(batch)
    path = trainer._save_step_checkpoint(epoch=0, step_in_epoch=2)
    assert not trainer.checkpoints.exists("step_checkpoint_next")
    want_loss, _ = trainer._train_step(batches[2])

    resumed_config = config.replace(resume_from_checkpoint=path)
    resumed = Trainer(_port_model(resumed_config, seed=5), resumed_config, batches)  # other init weights
    assert resumed.state.step == 2 and resumed._resume_step_in_epoch == 2 and resumed.start_epoch == 0
    saved = resumed.checkpoints.load(path)
    for key, value in saved["params"].items():
        assert torch.equal(resumed.model.state_dict()[key], value), key
    for part in ("mu", "nu"):
        for key, value in saved["opt_state"][part].items():
            assert torch.equal(resumed.state.opt_state[part][key], value), key
    assert resumed.state.opt_state["count"] == 2
    got_loss, _ = resumed._train_step(batches[2])
    assert got_loss.item() == want_loss.item()  # same weights, state and dropout draws
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value), key


def test_rolling_checkpoint_recovers_from_next(tmp_path):
    """A crash inside the rolling swap leaves only ``step_checkpoint_next``:
    resuming from ``step_checkpoint`` falls back to it."""
    config = _port_config(tmp_path, "beats", BEATS_TINY)
    batches = _batches(seed=15, n=1)
    trainer = Trainer(_port_model(config), config, batches)
    trainer._train_step(batches[0])
    path = trainer._save_step_checkpoint(epoch=1, step_in_epoch=1)
    out = trainer.checkpoints.output_dir
    (out / "step_checkpoint").rename(out / "step_checkpoint_next")
    (out / "step_checkpoint.meta.json").rename(out / "step_checkpoint_next.meta.json")
    resumed_config = config.replace(resume_from_checkpoint=path)
    resumed = Trainer(_port_model(resumed_config, seed=9), resumed_config, batches)
    assert resumed.start_epoch == 1 and resumed.state.step == 1
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[key], value), key
    with pytest.raises(ValueError, match="local paths only"):
        trainer.checkpoints.load("gs://bucket/step_checkpoint")


def test_train_loop_validates_saves_and_resumes_mid_epoch(tmp_path):
    config = _port_config(tmp_path, "beats", BEATS_TINY, checkpoint_every_steps=1,
                          metrics=["accuracy", "balanced_accuracy"])
    batches, val = _batches(seed=16, n=2), _batches(seed=17, n=1)
    trainer = Trainer(_port_model(config), config, batches, val, checkpoint_every_epochs=1)
    result = trainer.train()
    out = trainer.checkpoints.output_dir
    for name in ("best_model", "final_model", "checkpoint_epoch_0", "checkpoint_epoch_1", "step_checkpoint"):
        assert trainer.checkpoints.exists(name), name
    assert (out / "metadata" / "experiment_metadata.csv").exists()
    assert [r["epoch"] for r in result["history"]] == [0, 1]
    assert 0.0 <= result["history"][-1]["val"]["balanced_accuracy"] <= 1.0
    assert trainer.model._training is False  # back in inference mode

    resumed_config = config.replace(resume_from_checkpoint=str(out / "checkpoint_epoch_0"))
    assert Trainer(_port_model(resumed_config), resumed_config, batches).start_epoch == 1
    # A step checkpoint taken after batch 1 of epoch 1: the resumed run skips that batch.
    trainer._save_step_checkpoint(epoch=1, step_in_epoch=1)
    mid_config = config.replace(resume_from_checkpoint=str(out / "step_checkpoint"))
    history = Trainer(_port_model(mid_config), mid_config, batches).train()["history"]
    assert history[0]["epoch"] == 1 and history[0]["train"]["samples"] == BATCH  # one batch left


def test_sigterm_saves_and_stops(tmp_path):
    config = _port_config(tmp_path, "beats", BEATS_TINY)
    batches = _batches(seed=18, n=3)

    def loader():
        for i, batch in enumerate(batches):
            if i == 1:  # what a SIGTERM delivers to the handler train() installs
                signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
            yield batch

    class Loader:
        def __iter__(self):
            return loader()

        def __len__(self):
            return len(batches)

    trainer = Trainer(_port_model(config), config, Loader())
    before = signal.getsignal(signal.SIGTERM)
    result = trainer.train()
    assert result["preempted"] and trainer.checkpoints.exists("step_checkpoint")
    assert trainer.checkpoints.load("step_checkpoint")["step_in_epoch"] == 2
    assert signal.getsignal(signal.SIGTERM) is before  # the previous handler is back


def test_dropout_keep_rate_and_scale():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = dropout(x, 0.1, False, gen)
    kept = (y != 0).float().mean().item()
    sigma = (0.9 * 0.1 / x.numel()) ** 0.5
    assert abs(kept - 0.9) < 3 * sigma
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.9))
    assert dropout(x, 0.1, True, gen) is x and dropout(x, 0.0, False, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, False, None)
    assert y.dtype == x.dtype and dropout(x.bfloat16(), 0.5, False, gen).dtype == torch.bfloat16


def test_layerdrop_one_skips_every_layer():
    init = dict(BEATS_TINY, encoder_layerdrop=1.0)
    model = avex_tpu_torch.build_model_from_spec(
        ModelSpec(name="beats", pretrained=False, init_config=init), device="cpu", num_classes=NUM_CLASSES)
    wav = torch.from_numpy(_batches(seed=19, n=1)[0]["raw_wav"])
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        _, kept = model.module(wav, deterministic=False, disable_layerdrop=True, generator=gen)
        _, dropped = model.module(wav, deterministic=False, disable_layerdrop=False, generator=gen)
        encoder = model.module.backbone.encoder
        x = kept["intermediates"]["backbone.post_extract_proj"]
        x = x + torch.nn.functional.gelu(beats.conv_positions(encoder.pos_conv, x, torch.float32))
        x = beats.layer_norm(encoder.layer_norm, x, torch.float32)
    for i in range(init["encoder_layers"]):
        assert not dropped["intermediates"][f"backbone.encoder.layers.{i}.fc2"].any()
        assert kept["intermediates"][f"backbone.encoder.layers.{i}.fc2"].any()
    torch.testing.assert_close(dropped["features"], x)  # every layer passed its input on


def test_gradient_checkpointing_replays_the_draws(tmp_path):
    """remat with dropout and LayerDrop: the same loss and gradients as
    without it, from the same generator state (the recompute replays the
    layer's draws), and the generator ends where it would without remat."""
    init = dict(BEATS_TINY, dropout=0.2, activation_dropout=0.1, encoder_layerdrop=0.3)
    config = _port_config(tmp_path, "beats", init, training=dict(gradient_checkpointing=True))
    batch = _batches(seed=20, n=1)[0]
    results = []
    for remat in (False, True):
        model = _port_model(config)
        if remat:
            TrainerFactory.create_trainer(model, config, [batch])
            assert model.cfg.remat
        gen = torch.Generator().manual_seed(3)
        strategy = make_strategy("supervised", "cross_entropy")
        loss, _ = strategy.forward_loss(model.train_forward,
                                        {k: torch.from_numpy(v) for k, v in batch.items()}, gen, train=True)
        grads = torch.autograd.grad(loss, list(model.module.parameters()), allow_unused=True)
        results.append((loss, grads, gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = results
    assert l0.item() == l1.item() and torch.equal(s0, s1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


class _CountOps(TorchDispatchMode):
    """Counts the aten operators run inside it."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_policy_dots_keeps_the_dense_products(tmp_path):
    """``remat_policy="dots"`` on the fused K2/K3 route (the CPU twins), with
    dropout and LayerDrop: the loss and every gradient equal those of
    ``remat=False``; the backward recomputes the attention (its batched
    products) but none of the dense layers' products, which plain remat
    recomputes."""
    init = dict(BEATS_FUSED, dropout=0.2, activation_dropout=0.1, encoder_layerdrop=0.3)
    batch = {k: torch.from_numpy(v) for k, v in _batches(seed=21, n=1)[0].items()}
    results = {}
    for name, options in (("off", {}), ("nothing", {"remat": True}), ("dots", {"remat": True, "remat_policy": "dots"})):
        config = _port_config(tmp_path, "beats", dict(init, **options))
        model = _port_model(config)
        model.module.train()
        gen = torch.Generator().manual_seed(4)
        loss, _ = make_strategy("supervised", "cross_entropy").forward_loss(model.train_forward, batch, gen, train=True)
        params = list(model.module.parameters())
        with _CountOps() as ops:
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        results[name] = (loss.item(), grads, gen.get_state(), ops.counts)
    loss_off, grads_off, state_off, ops_off = results["off"]
    for name in ("nothing", "dots"):
        loss, grads, state, _ = results[name]
        assert loss == loss_off and torch.equal(state, state_off), name
        for a, b in zip(grads, grads_off):
            assert (a is None) == (b is None)
            if a is not None:
                torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    addmm = torch.ops.aten.addmm.default
    dense_layers = 4 * BEATS_FUSED["encoder_layers"]  # qkv, out_proj, fc1, fc2 of each layer
    assert results["nothing"][3].get(addmm, 0) == ops_off.get(addmm, 0) + dense_layers
    assert results["dots"][3].get(addmm, 0) == ops_off.get(addmm, 0)
    bmm = torch.ops.aten.bmm.default
    assert results["dots"][3].get(bmm, 0) == results["nothing"][3].get(bmm, 0) > ops_off.get(bmm, 0)


def test_unported_training_options_raise(tmp_path, monkeypatch):
    config = _port_config(tmp_path, "beats", BEATS_TINY)
    model = _port_model(config)
    # a one-process mesh is what no mesh is; a model axis of 2 needs two processes
    # (tests/test_torch_model_parallel.py)
    assert Trainer(model, config, [], mesh=make_mesh(device="cpu")).mesh.size == 1
    with pytest.raises(ValueError, match="model=2"):
        make_mesh(model=2, device="cpu")
    # the text and self-supervised strategies are ported (tests/test_torch_clip.py, tests/test_torch_eat_ssl.py)
    assert type(make_strategy("text")).__name__ == "CLIPStrategy"
    assert type(make_strategy("self_supervised")).__name__ == "EATSSLStrategy"
    with pytest.raises(ValueError, match="model=2"):
        Trainer(model, config.replace(mesh={"model": 2}), [])
    # augmentations are ported with the data pipeline: each dict becomes its config
    augmented = config.replace(augmentations=[{"kind": "mixup", "alpha": 0.2, "augmentation_prob": 0.5}])
    assert augmented.augmentations[0].kind == "mixup" and augmented.augmentations[0].alpha == 0.2
    # clustering evaluation is ported: the dict becomes its config
    assert config.replace(clustering_eval={"enabled": True}).clustering_eval.enabled
    assert config.replace(mesh={"data": -1}).mesh == MeshConfig(data=-1)
    with pytest.raises(ValueError, match="multilabel"):
        config.replace(multilabel=True)
    assert config.replace(loss_function="binary_cross_entropy").loss_function == "bce"
    with pytest.raises(ValueError, match="optimizer"):
        TrainingParams(**dict(TRAINING, optimizer="sgd"))
    # AVEX_PROFILE_DIR is ported: the first epoch runs under the profiler and writes its trace there
    monkeypatch.setenv("AVEX_PROFILE_DIR", str(tmp_path / "profile"))
    Trainer(model, config.replace(training_params=TrainingParams(**dict(TRAINING, train_epochs=1))),
            _batches(seed=21, n=1)).train()
    assert list((tmp_path / "profile").glob("*.pt.trace.json"))
    # EAT has no gradient checkpointing: the factory builds the trainer anyway
    eat_config = _port_config(tmp_path, "eat_hf", EAT_TINY, training=dict(gradient_checkpointing=True))
    eat_model = _port_model(eat_config)
    with pytest.raises(NotImplementedError):
        eat_model.enable_gradient_checkpointing()
    assert isinstance(TrainerFactory.create_trainer(eat_model, eat_config, []), Trainer)
