"""AVES in training mode: the port's dropout and LayerDrop against the JAX model's.

A tiny AVES (2 layers, 128-d, 2 heads, FFN 256, the full HuBERT conv stack)
starts from the JAX package's weights (``params_from_jax``). With every
dropout rate and LayerDrop at 0, three port ``Trainer._train_step`` calls are
held to three JAX ``Trainer`` steps, on the plain path and on the fused K5/K6
route (JAX: Pallas in interpret mode; the port: its plain twins on the CPU).
With the rates above 0 the random streams cannot match JAX's, so the port
alone is held to what the JAX model applies: the dropout sites and rates,
each keeping about ``1 - p`` of its activations scaled by ``1 / (1 - p)``,
LayerDrop, and the generator as the only source of draws.
"""

import numpy as np
import pytest
import torch

import jax

import avex_tpu
from avex_tpu.configs import DatasetCollectionConfig, DatasetConfig
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import RunConfig as JaxRunConfig
from avex_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from avex_tpu.configs import TrainingParams as JaxTrainingParams
from avex_tpu.parallel import shard_batch
from avex_tpu.training import Trainer as JaxTrainer

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.models import aves
from avex_tpu_torch.models.common import conv_positions, dense, gelu, layer_norm
from avex_tpu_torch.training import Trainer, make_strategy
from tests.test_torch_training import LOSS_REL, PARAM_TOL, _zero_gradient
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

NUM_CLASSES, BATCH, STEPS = 4, 4, 3
TINY = {"encoder_num_layers": 2, "encoder_embed_dim": 128, "encoder_num_heads": 2,
        "encoder_ff_interm_features": 256}
NO_DROPOUT = dict(TINY, encoder_projection_dropout=0.0, encoder_attention_dropout=0.0,
                  encoder_ff_interm_dropout=0.0, encoder_dropout=0.0, encoder_layer_drop=0.0)
# Distinct rates, so that each recorded dropout call names its site.
RATES = dict(TINY, encoder_projection_dropout=0.1, encoder_attention_dropout=0.4,
             encoder_ff_interm_dropout=0.3, encoder_dropout=0.2, encoder_layer_drop=0.0)
TRAINING = dict(train_epochs=2, lr=1e-3, batch_size=BATCH, optimizer="adamw", weight_decay=0.01, log_steps=100)


def _batches(seed, n=STEPS):
    """1 s clips at 16 kHz; the second clip of each batch padded from 0.6 s."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = np.zeros((BATCH, 16000), bool)
        mask[1, 9600:] = True
        out.append({
            "raw_wav": (rng.standard_normal((BATCH, 16000)) * 0.1).astype(np.float32),
            "padding_mask": mask,
            "label": np.eye(NUM_CLASSES, dtype=np.float32)[rng.integers(0, NUM_CLASSES, BATCH)],
        })
    return out


def _port_model(aves_cfg, use_pallas=False):
    spec = ModelSpec(name="aves_bio", pretrained=False, device="cpu",
                     init_config={"aves_cfg": aves_cfg, "use_pallas": use_pallas})
    return avex_tpu_torch.build_model_from_spec(spec, num_classes=NUM_CLASSES)


def _jax_pair(tmp_path, use_pallas):
    """(JAX model, port model) with the same weights and the rates at 0, and both run configs."""
    init = {"aves_cfg": NO_DROPOUT, "use_pallas": use_pallas}
    jax_config = JaxRunConfig(
        model_spec=JaxModelSpec(name="aves_bio", pretrained=False, init_config=init),
        training_params=JaxTrainingParams(**TRAINING),
        dataset_config=DatasetCollectionConfig(
            train_datasets=[DatasetConfig(name="synth", kind="synthetic", num_samples=8, num_classes=4)]
        ),
        output_dir=str(tmp_path / "jax"),
        scheduler=JaxSchedulerConfig(name="cosine", warmup_steps=1),
        seed=0,
    )
    config = RunConfig(
        model_spec=ModelSpec(name="aves_bio", pretrained=False, init_config=init, device="cpu"),
        training_params=TrainingParams(**TRAINING),
        output_dir=str(tmp_path / "port"),
        scheduler=SchedulerConfig(name="cosine", warmup_steps=1),
        seed=0,
        device="cpu",
    )
    jax_model = avex_tpu.build_model_from_spec(jax_config.model_spec, num_classes=NUM_CLASSES)
    port = _port_model(NO_DROPOUT, use_pallas)
    port.load_port_state_dict(aves.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])),
                              strict=True)
    return jax_model, port, jax_config, config


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "k5_k6"])
def test_aves_train_steps_match_jax_trainer(tmp_path, use_pallas):
    """Rates at 0: three AdamW steps (masked weight decay, cosine schedule
    with warmup) on padded batches; per-step loss and the final parameters,
    with the tolerances of the BEATs and EAT steps."""
    jax_model, port, jax_config, config = _jax_pair(tmp_path, use_pallas)
    batches = _batches(seed=31)
    jax_trainer = JaxTrainer(jax_model, jax_config, batches, steps_per_epoch=4)
    trainer = Trainer(port, config, batches, steps_per_epoch=4)
    for batch in batches:
        jax_trainer.state, want, _ = jax_trainer._train_step(jax_trainer.state, shard_batch(batch, jax_trainer.mesh))
        got, metrics = trainer._train_step(batch)
        assert abs(got.item() - float(want)) <= LOSS_REL * abs(float(want))
        assert metrics["count"] == BATCH and int(metrics["nonfinite_logits"]) == 0
    want_params = aves.params_from_jax(jax.tree_util.tree_map(np.asarray, jax.device_get(jax_trainer.state.params)))
    state = port.state_dict()
    for key, value in want_params.items():
        got, noise = state[key].numpy(), _zero_gradient(key, value.shape)
        np.testing.assert_allclose(got[~noise], value[~noise], err_msg=key, **PARAM_TOL)
        assert np.abs(got[noise] - value[noise]).max(initial=0.0) <= 2 * STEPS * TRAINING["lr"], key
    assert trainer.state.step == STEPS


def _inputs(seed=32):
    batch = _batches(seed, n=1)[0]
    return torch.from_numpy(batch["raw_wav"]), torch.from_numpy(batch["padding_mask"])


def test_aves_dropout_sites_rates_and_scale(monkeypatch):
    """In training mode dropout runs at the JAX model's sites with its rates
    (feature projection; after the positional conv's residual and the
    encoder LayerNorm; per layer after out_proj, the FFN's intermediate and
    its output), never on the attention probabilities; each keeps about
    1 - p of its activations and scales them by 1 / (1 - p)."""
    model = _port_model(RATES)
    calls = []
    real = aves.dropout

    def recording(x, rate, deterministic, generator):
        y = real(x, rate, deterministic, generator)
        calls.append((rate, x.detach(), y.detach()))
        return y

    monkeypatch.setattr(aves, "dropout", recording)
    wav, mask = _inputs()
    with torch.no_grad():
        model.module(wav, mask, deterministic=False, generator=torch.Generator().manual_seed(0))
    per_layer = [RATES["encoder_dropout"], RATES["encoder_ff_interm_dropout"], RATES["encoder_dropout"]]
    want = [RATES["encoder_projection_dropout"], RATES["encoder_dropout"]] + per_layer * TINY["encoder_num_layers"]
    assert [rate for rate, _, _ in calls] == want
    for rate, x, y in calls:
        dropped = (y == 0) & (x != 0)
        kept = ~dropped
        sigma = (rate * (1 - rate) / x.numel()) ** 0.5
        assert abs(float(kept.float().mean()) - (1 - rate)) < 5 * sigma, rate
        torch.testing.assert_close(y[kept], x[kept] / (1 - rate))


def test_aves_layerdrop_one_skips_every_layer():
    """encoder_layer_drop = 1: every layer passes its input on and reports a
    zero FFN output; with LayerDrop disabled every layer runs."""
    cfg = dict(NO_DROPOUT, encoder_layer_drop=1.0)
    model = _port_model(cfg)
    wav, mask = _inputs()
    gen = torch.Generator().manual_seed(0)
    m, dt = model.module, torch.float32
    with torch.no_grad():
        _, kept = m(wav, mask, deterministic=False, disable_layerdrop=True, generator=gen)
        _, dropped = m(wav, mask, deterministic=False, disable_layerdrop=False, generator=gen)
        proj, tr = m.encoder.feature_projection, m.encoder.transformer
        h = dense(proj.projection, layer_norm(proj.layer_norm, m.feature_extractor(wav), dt), dt)
        h = h.masked_fill(dropped["padding_mask"][:, :, None], 0.0)
        h = h + gelu(conv_positions(tr.pos_conv_embed.conv, h, dt))
        h = layer_norm(tr.layer_norm, h, dt)
    for i in range(TINY["encoder_num_layers"]):
        name = f"model.encoder.transformer.layers.{i}.feed_forward.output_dense"
        assert not dropped["intermediates"][name].any() and kept["intermediates"][name].any()
    torch.testing.assert_close(dropped["features"], h)


def test_aves_same_generator_same_step():
    """Through ``train_forward`` and the supervised strategy (the Trainer's
    path, which the knobs used to miss): the same seeded generator gives the
    same loss and gradients twice; another seed, and inference mode, give
    another loss."""
    model = _port_model(dict(RATES, encoder_layer_drop=0.3))
    batch = {k: torch.from_numpy(v) for k, v in _batches(seed=33, n=1)[0].items()}
    strategy = make_strategy("supervised", "cross_entropy")
    params = list(model.module.parameters())

    def step(seed, train=True):
        gen = torch.Generator().manual_seed(seed)
        loss, _ = strategy.forward_loss(model.train_forward, batch, gen, train=train)
        return loss, torch.autograd.grad(loss, params, allow_unused=True)

    (l0, g0), (l1, g1) = step(3), step(3)
    assert l0.item() == l1.item()
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    assert step(4)[0].item() != l0.item()
    assert step(3, train=False)[0].item() != l0.item()


def test_aves_deterministic_is_inference():
    """deterministic=True gives the inference output exactly and draws
    nothing, whatever the rates and the LayerDrop switch."""
    model = _port_model(dict(RATES, encoder_layer_drop=0.5))
    wav, mask = _inputs()
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    with torch.no_grad():
        want, _ = model.module(wav, mask)
        got, _ = model.module(wav, mask, deterministic=True, disable_layerdrop=False, generator=gen)
    assert torch.equal(got, want) and torch.equal(gen.get_state(), state)


def test_aves_layerdrop_without_generator_raises():
    model = _port_model(dict(NO_DROPOUT, encoder_layer_drop=0.05))
    wav, mask = _inputs()
    with pytest.raises(ValueError, match="LayerDrop"):
        model.module(wav, mask, deterministic=False, disable_layerdrop=False)
    with pytest.raises(ValueError, match="Generator"):
        _port_model(RATES).module(wav, mask, deterministic=False)
