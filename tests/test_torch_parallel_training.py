"""Data parallelism in the port, two gloo processes on the CPU, against JAX on the global batch.

The JAX package's layouts treat a data-sharded batch as one logical global
batch; the port's ranks each hold their rows, and the global batch is their
concatenation in rank order. So each JAX side here runs in this process, on
one device, on the concatenated batch, and the port's two ranks
(``tests/test_torch_parallel_ranks.py``: one spawned group runs every
scenario, started once for the file while this process computes the JAX
side) run on their halves:

- the dry run's tiny supervised BEATs (dropout 0): one ``Trainer`` step in
  the DDP and the ZeRO-3 layouts, the loss and every parameter after AdamW
  with global-norm clipping engaged;
  the ZeRO-3 run's checkpoint, written by rank 0 from whole tensors,
  restored in one process (JAX's ``test_fsdp_restore_on_smaller_mesh``);
- EfficientNet-B0 in train mode: the averaged gradients and BatchNorm's
  running statistics, over the global batch's statistics;
- CLIP (train mode): the loss over the gathered features and the gradients;
  and one ``Trainer`` step on a 1 x 2 mesh whose model axis cuts CLIP's two
  projections (``_tp_shard_params``'s ``fc1``/``fc2``), the loss, every
  gradient tensor and every parameter after the update;
- EAT-SSL: the loss, the student and the EMA teacher, each rank's mask draw
  its rows of JAX's global draw;
- every ``Trainer`` step here runs at the full learning rate (a cosine
  schedule with no warmup: with one warmup step the first update is lr 0
  and no parameter moves);
- extraction into the cache under the mesh with a remainder batch (cell 5
  of the dry run), ``gather_metrics``, a data-parallel probe (scored by mAP
  on the gathered validation set) and
  ``run_train`` with ``distributed=True``, where only rank 0 writes.

Tolerances are those of the single-process tests of the same pieces.
"""

import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import avex_tpu
from avex_tpu.configs import DatasetCollectionConfig, DatasetConfig
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.configs import RunConfig as JaxRunConfig
from avex_tpu.configs import SchedulerConfig as JaxSchedulerConfig
from avex_tpu.configs import TrainingParams as JaxTrainingParams
from avex_tpu.evaluation.embedding_cache import extract_embeddings_to_cache as jax_extract_to_cache
from avex_tpu.evaluation.embedding_cache import load_cached_embeddings as jax_load_cache
from avex_tpu.parallel import shard_batch
from avex_tpu.training import Trainer as JaxTrainer
from avex_tpu.training.optimizers import make_optimizer as jax_make_optimizer
from avex_tpu.training.strategies import CLIPStrategy as JaxCLIPStrategy

import avex_tpu_torch
from avex_tpu_torch.configs import MeshConfig, ModelSpec, ProbeConfig, RunConfig, SchedulerConfig, TrainingParams
from avex_tpu_torch.evaluation.finetune import FineTuneTrainer
from avex_tpu_torch.models import beats, clip, eat_ssl
from avex_tpu_torch.models import efficientnet as eff
from avex_tpu_torch.probes import build_probe_from_config
from avex_tpu_torch.training import Trainer
from chip_smoke import shift_free_biases
from tests.test_torch_beats import FP32_TOL
from tests.test_torch_clip import TEXTS, TRAIN_GRAD_REL, _jax_apply_fn, _spec, _wav, clip_pair
from tests.test_torch_data import EVAL_YAML
from tests.test_torch_eat_ssl import CFG as EAT_CFG
from tests.test_torch_eat_ssl import _configs as eat_ssl_configs
from tests.test_torch_eat_ssl import build_pair as eat_ssl_pair
from tests.test_torch_eat_ssl import capture_jax_noise, hold_adam_step
from tests.test_torch_efficientnet import _tree, module_pair
from tests.test_torch_parallel_ranks import WORLD, RankGroup
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

# fp32 on both sides, the same operations summed in other orders (the
# single-process Trainer tests' bounds, tests/test_torch_training.py)
LOSS_REL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
EXTRACT_TOL = dict(rtol=1e-5, atol=1e-6)  # cell 5's bound
PROBE_METRICS = ("mAP", "accuracy")  # best epoch by mAP, which is no mean of its shares' scores

BEATS_DRYRUN = {  # __graft_entry__._supervised_config, dropout 0
    "encoder_layers": 2, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 128, "encoder_attention_heads": 4,
    "embed_dim": 32, "dropout": 0.0, "attention_dropout": 0.0, "encoder_layerdrop": 0.0,
}
RAW_AUDIO = {"representation": "raw", "normalize": False, "target_length_seconds": 1, "window_selection": "random"}
TRAINING = dict(train_epochs=1, lr=1e-3, batch_size=2 * WORLD, optimizer="adamw", weight_decay=0.01, log_steps=100)
NO_WARMUP = dict(name="cosine", warmup_steps=0)  # the first update at the full learning rate
# the tiny BEATs' global gradient norm is ~13.5 at this batch: a clip at 1 scales it
BEATS_TRAINING = dict(TRAINING, gradient_clip_val=1.0)
NUM_CLASSES, STEPS_PER_EPOCH, FSDP_MIN_SIZE = 4, 4, 1024  # JAX's FSDP lifecycle tests' min size
EXTRACT_BEATS = dict(encoder_layers=1, encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_attention_heads=4,
                     embed_dim=32)


def _beats_batch():
    rng = np.random.default_rng(11)
    labels = rng.integers(0, NUM_CLASSES, 2 * WORLD)
    return {"raw_wav": (rng.standard_normal((2 * WORLD, 16000)) * 0.1).astype(np.float32),
            "label": np.eye(NUM_CLASSES, dtype=np.float32)[labels]}


def _jax_beats(tmp_path):
    config = JaxRunConfig(
        model_spec=JaxModelSpec(name="beats", pretrained=False, init_config=BEATS_DRYRUN, audio_config=RAW_AUDIO),
        training_params=JaxTrainingParams(**BEATS_TRAINING),
        dataset_config=DatasetCollectionConfig(
            train_datasets=[DatasetConfig(name="dryrun", kind="synthetic", num_samples=8, num_classes=4)]),
        output_dir=str(tmp_path / "jax_beats"), scheduler=JaxSchedulerConfig(**NO_WARMUP),
        seed=0,
    )
    return avex_tpu.build_model_from_spec(config.model_spec, num_classes=NUM_CLASSES), config


def _eat_ssl_jax_step(tmp_path):
    """JAX's jitted EAT-SSL Trainer step on the global batch of 8 and its mask draw."""
    monkeypatch = pytest.MonkeyPatch()
    try:
        jax_model, port = eat_ssl_pair(False, ema_decay=0.9)
        jax_config, _ = eat_ssl_configs(tmp_path / "eat_ssl", warmup_steps=0)
        batch = {"raw_wav": (np.random.default_rng(20).standard_normal((8, 16000)) * 0.1).astype(np.float32),
                 "label": np.zeros(8, np.int64)}
        jax_trainer = JaxTrainer(jax_model, jax_config, [batch], steps_per_epoch=2)
        seen = capture_jax_noise(monkeypatch)
        jax_trainer.state, loss, metrics = jax_trainer._train_step(jax_trainer.state,
                                                                   shard_batch(batch, jax_trainer.mesh))
        jax.effects_barrier()
    finally:
        monkeypatch.undo()
    assert len(seen) == 1 and seen[0].shape == (8, 64)
    state = {k: v.numpy().copy() for k, v in port.state_dict().items()}
    after = eat_ssl.params_from_jax(_tree(jax_trainer.state.params))
    adam = next(x for x in jax.tree_util.tree_leaves(jax_trainer.state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu"))
    grads = eat_ssl.params_from_jax(jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, jax.device_get(adam.mu)))
    return {"state": state, "batch": batch, "noise": seen[0], "loss": float(loss), "grads": grads,
            "count": int(metrics["count"]), "regression": float(metrics["loss_regression"]), "after": after}


def _dump(inputs, path):
    """Write ``inputs`` where the ranks read them, whole or not at all."""
    with open(path.with_suffix(".tmp"), "wb") as f:
        pickle.dump(inputs, f)
    path.with_suffix(".tmp").rename(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The JAX-side inputs, the rank group started on them, and what the tests
    compare. The ranks start on the inputs that cost little to make; the
    rest (JAX's EfficientNet, CLIP and EAT-SSL step) follow while they run."""
    work = tmp_path_factory.mktemp("ranks")
    jax_beats, jax_beats_config = _jax_beats(work)
    beats_state = beats.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_beats.variables["params"]))
    extract_model = avex_tpu.build_model_from_spec(JaxModelSpec(name="beats", pretrained=False,
                                                                init_config=EXTRACT_BEATS), return_features_only=True)
    rng = np.random.default_rng(5)
    extract_batches = [
        {"raw_wav": (rng.standard_normal((2 * WORLD, 16000)) * 0.1).astype(np.float32), "label": np.arange(4)},
        {"raw_wav": (rng.standard_normal((3, 16000)) * 0.1).astype(np.float32), "label": np.arange(3)},  # remainder
    ]
    probe_rng = np.random.default_rng(8)
    probe_batches = [{"embeddings_0": probe_rng.standard_normal((8, 16)).astype(np.float32),
                      "label": probe_rng.integers(0, 3, 8)} for _ in range(2)]
    beats_spec = dict(init_config=BEATS_DRYRUN, audio_config=RAW_AUDIO, training=BEATS_TRAINING,
                      fsdp_min_size=FSDP_MIN_SIZE, num_classes=NUM_CLASSES, state=beats_state, batch=_beats_batch(),
                      steps_per_epoch=STEPS_PER_EPOCH)
    inputs = {
        "supervised_beats_dp": beats_spec,
        "supervised_beats_fsdp": beats_spec,
        "extraction": {"spec": dict(name="beats", pretrained=False, init_config=EXTRACT_BEATS),
                       "state": beats.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                             extract_model.variables["params"])),
                       "batches": extract_batches},
        "metrics_mean": {},
        "finetune": {"probe": {"probe_type": "linear"}, "num_classes": 3, "input_dim": (16,), "metrics": PROBE_METRICS,
                     "training": dict(train_epochs=2, lr=1e-2, batch_size=8), "batches": probe_batches},
        "run_train_distributed": {"config": _run_train_config()},
        "run_evaluate_distributed": {"yaml": str(EVAL_YAML), "patches": ["device=cpu", "eval_modes=[probe,retrieval]"]},
    }
    _dump(inputs, work / "inputs.pkl")
    group = RankGroup(work)

    jax_effnet, effnet_variables, _ = module_pair("b0", num_classes=7)
    jax_clip, _ = clip_pair()
    eat = _eat_ssl_jax_step(work)
    images = np.random.default_rng(42).standard_normal((4, 3, 64, 50)).astype(np.float32)
    late = {
        "efficientnet_batchnorm": {"num_classes": 7, "state": eff.params_from_jax(effnet_variables, "b0"),
                                   "images": images, "labels": np.array([1, 2, 3, 0])},
        "clip_global_batch": {"spec": _spec(), "state": clip.params_from_jax(jax_clip.variables), "wav": _wav(5),
                              "tokens": np.asarray(jax_clip.tokenize(TEXTS))},
        "clip_model_axis": {"spec": _spec(), "state": clip.params_from_jax(jax_clip.variables), "wav": _wav(5),
                            "tokens": np.asarray(jax_clip.tokenize(TEXTS)), "training": TRAINING,
                            "steps_per_epoch": STEPS_PER_EPOCH},
        "eat_ssl_step": {"eat_cfg": dict(EAT_CFG, ema_decay=0.9), "state": eat["state"], "batch": eat["batch"],
                         "noise": eat["noise"], "training": dict(TRAINING, batch_size=8),
                         "fsdp_min_size": FSDP_MIN_SIZE},
    }
    _dump(late, work / "inputs_late.pkl")
    return {"group": group, "work": work, "inputs": {**inputs, **late}, "jax_beats": (jax_beats, jax_beats_config),
            "jax_effnet": (jax_effnet, effnet_variables), "jax_clip": jax_clip, "eat": eat,
            "jax_extract": extract_model}


def _run_train_config():
    return {
        "model_spec": {"name": "beats", "pretrained": False, "init_config": BEATS_DRYRUN, "audio_config": RAW_AUDIO,
                       "device": "cpu"},
        "training_params": dict(TRAINING, train_epochs=1),
        "dataset_config": {"train_datasets": [{"name": "synth", "kind": "synthetic", "num_samples": 10,
                                               "num_classes": NUM_CLASSES, "clip_seconds": 1.0}],
                           "val_datasets": [{"name": "synth_val", "kind": "synthetic", "num_samples": 8,
                                             "num_classes": NUM_CLASSES, "clip_seconds": 1.0}]},
        "distributed": True, "device": "cpu", "num_workers": 0, "seed": 0, "output_dir": "unused",
        "scheduler": {"name": "cosine", "warmup_steps": 1},
    }


def _results(ranks, name):
    return [r[name] for r in ranks["group"].results()]


def _jax_beats_step(ranks):
    """JAX's step, once for the file (its Trainer donates the model's arrays)."""
    if "jax_beats_step" not in ranks:
        ranks["jax_beats_step"] = _run_jax_beats_step(ranks)
    return ranks["jax_beats_step"]


def _run_jax_beats_step(ranks):
    jax_model, config = ranks["jax_beats"]
    trainer = JaxTrainer(jax_model, config, [], steps_per_epoch=STEPS_PER_EPOCH)
    batch = ranks["inputs"]["supervised_beats_dp"]["batch"]
    trainer.state, loss, _ = trainer._train_step(trainer.state, shard_batch(batch, trainer.mesh))
    # after one step Adam's first moment is (1 - b1)·g: the gradient the step applied
    adam = next(x for x in jax.tree_util.tree_leaves(trainer.state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(x, "mu"))
    grads = beats.params_from_jax(jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, jax.device_get(adam.mu)))
    return float(loss), beats.params_from_jax(_tree(trainer.state.params)), grads


def _zero_gradient(key, value):
    """The entries whose exact gradient is 0: the key projection's bias
    (BEATs' ``k_proj.bias``, the middle third of EAT's fused ``qkv.bias``),
    which a softmax cannot see. Their computed gradients are rounding noise."""
    noise = np.zeros(value.shape, bool)
    if key.endswith("self_attn.k_proj.bias"):
        noise[:] = True
    elif key.endswith("attn.qkv.bias"):
        noise[value.shape[0] // 3:2 * value.shape[0] // 3] = True
    return noise


def _assert_moved(before, after):
    """The step moved every tensor that has an entry with a gradient (a step
    at lr 0 would leave them all as they were)."""
    still = [k for k, v in after.items() if (~_zero_gradient(k, v)).any() and np.array_equal(v, before[k])]
    assert not still, still


def _hold_beats_step(results, want_loss, want_params, want_grads, before):
    """The loss, every parameter after the step and the gradient it applied
    (first moment / (1 - b1)) against JAX's step on the global batch."""
    # the mean of the ranks' local means is JAX's mean over the global batch (equal shares)
    assert [r["count"] for r in results] == [2, 2]
    got_loss = float(np.mean([r["loss"] for r in results]))
    assert abs(got_loss - want_loss) <= LOSS_REL * abs(want_loss)
    _assert_moved(before, results[0]["params"])
    for key, value in want_params.items():
        hold_adam_step(results[0]["params"][key], value, key, results[0]["mu"][key] / np.float32(0.1),
                       want_grads[key], TRAINING["lr"])
        np.testing.assert_array_equal(results[1]["params"][key], results[0]["params"][key],
                                      err_msg=key)  # the ranks stay equal
    assert set(want_grads) == set(results[0]["mu"])
    for key, value in want_grads.items():
        got, noise = results[0]["mu"][key] / np.float32(0.1), _zero_gradient(key, value)
        np.testing.assert_allclose(got[~noise], value[~noise], err_msg=key, **FP32_TOL)


def test_data_parallel_beats_step_matches_jax(ranks):
    _hold_beats_step(_results(ranks, "supervised_beats_dp"), *_jax_beats_step(ranks),
                     ranks["inputs"]["supervised_beats_dp"]["state"])


def test_fsdp_beats_step_matches_jax_and_restores_in_one_process(ranks, tmp_path):
    results = _results(ranks, "supervised_beats_fsdp")
    _hold_beats_step(results, *_jax_beats_step(ranks), ranks["inputs"]["supervised_beats_fsdp"]["state"])
    dp = _results(ranks, "supervised_beats_dp")[0]
    for key, value in dp["params"].items():  # the two layouts take one step
        hold_adam_step(results[0]["params"][key], value, key, results[0]["mu"][key], dp["mu"][key], TRAINING["lr"])
    # the placement: JAX's axis, the moments follow their parameters, half the bytes stay
    shards = results[0]
    assert shards["cut"]
    for name, axis in shards["cut"].items():
        full = dp["params"][name].shape
        assert shards["moment_shapes"][name] == full[:axis] + (full[axis] // WORLD,) + full[axis + 1:], name
    cut_bytes = sum(dp["params"][n].nbytes for n in shards["cut"])
    assert shards["resident_bytes"][0] * WORLD == cut_bytes
    # rank 0 wrote the whole tensors; one process restores them
    assert results[0]["written"] and not results[1]["written"]
    config = RunConfig(
        model_spec=ModelSpec(name="beats", pretrained=False, init_config=BEATS_DRYRUN, device="cpu",
                             audio_config=RAW_AUDIO),
        training_params=TrainingParams(**BEATS_TRAINING), output_dir=str(tmp_path / "restored"),
        scheduler=SchedulerConfig(**NO_WARMUP), seed=0, device="cpu",
        mesh=MeshConfig(param_sharding="fsdp", fsdp_min_size=FSDP_MIN_SIZE),
        resume_from_checkpoint=results[0]["checkpoint"],
    )
    model = avex_tpu_torch.build_model_from_spec(config.model_spec, num_classes=NUM_CLASSES, seed=3)
    trainer = Trainer(model, config, [], steps_per_epoch=STEPS_PER_EPOCH)
    assert trainer.mesh.size == 1 and trainer.state.step == 1
    for key, value in model.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), results[0]["params"][key], err_msg=key)
    for moment in ("mu", "nu"):
        for key, value in trainer.state.opt_state[moment].items():
            np.testing.assert_array_equal(value.numpy(), results[0][moment][key], err_msg=key)
    loss, _ = trainer._train_step(ranks["inputs"]["supervised_beats_dp"]["batch"])  # it trains on
    assert np.isfinite(loss.item())


def test_efficientnet_global_batchnorm_matches_jax(ranks):
    jax_module, variables = ranks["jax_effnet"]
    spec = ranks["inputs"]["efficientnet_batchnorm"]
    x, labels = spec["images"], spec["labels"]

    def loss_fn(params):
        (out, _aux), mutated = jax_module.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                                jnp.asarray(x), train=True, deterministic=True,
                                                mutable=["batch_stats"])
        return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(4), labels]), mutated

    (want_loss, mutated), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    results = _results(ranks, "efficientnet_batchnorm")
    got_loss = float(np.mean([r["loss"] for r in results]))
    assert abs(got_loss - float(want_loss)) <= LOSS_REL * abs(float(want_loss))
    want = eff.params_from_jax({"params": _tree(grads), "batch_stats": _tree(mutated["batch_stats"])})
    assert any(k.endswith("running_var") for k in want)
    for key, value in want.items():
        got = results[0]["grads"].get(key, results[0]["buffers"].get(key))
        np.testing.assert_allclose(got, value, err_msg=key, **FP32_TOL)
        other = results[1]["grads"].get(key, results[1]["buffers"].get(key))
        np.testing.assert_array_equal(other, got, err_msg=key)  # one global batch, one result


def _jax_clip_step(ranks):
    """JAX's train-mode CLIP loss and gradients on the global batch (stochastic
    depth keeping every item) and the parameters after one AdamW step of the
    JAX package's optimizer from them, once for the file: the loss, the
    gradients and the updated running statistics, and the parameters after,
    in the port's names."""
    if "jax_clip_step" in ranks:
        return ranks["jax_clip_step"]
    jax_model = ranks["jax_clip"]
    spec = ranks["inputs"]["clip_global_batch"]
    variables = jax_model.variables
    apply_fn = _jax_apply_fn(jax_model)

    def loss_fn(params):
        return JaxCLIPStrategy().forward_loss(apply_fn, params, {"batch_stats": variables["batch_stats"]},
                                              {"raw_wav": spec["wav"], "text_tokens": spec["tokens"]},
                                              jax.random.PRNGKey(0), train=True)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.ones(shape, bool))
        (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    tx, _ = jax_make_optimizer(JaxTrainingParams(**TRAINING), JaxSchedulerConfig(**NO_WARMUP),
                               total_steps=STEPS_PER_EPOCH, params=variables["params"])
    after = jax.jit(lambda p, g: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(variables["params"], grads)
    ranks["jax_clip_step"] = {
        "loss": float(loss),
        "grads": clip.params_from_jax({"params": _tree(grads),
                                       "batch_stats": _tree(metrics["_updated_variables"]["batch_stats"])}),
        "after": clip.params_from_jax({"params": _tree(after)}),
    }
    return ranks["jax_clip_step"]


def hold_clip_gradients(got, want):
    """Every tensor by its rel L2 at the bound that the single-process
    train-mode test puts on all of them together (ill-conditioned
    BatchNorm); the tensors whose exact gradient is 0 (RoBERTa's key bias,
    the projection BatchNorm biases: rounding noise, rel ~2 apart) left out
    and their noise bounded. Returns those tensors' names."""
    grads_only = {k: v for k, v in want.items() if k in got}
    assert set(grads_only) == set(got)
    zero = shift_free_biases(got) | {k for k in got if k.endswith(".k.bias")}
    assert len(zero) == 16 + 2  # one per MBConv of B0, one per RoBERTa layer
    scale = max(float(np.abs(v).max()) for v in grads_only.values())
    for key, value in grads_only.items():
        diff = np.linalg.norm(got[key].astype(np.float64) - value)
        if key in zero:
            assert max(np.abs(got[key]).max(), np.abs(value).max()) <= 1e-5 * scale, key
        else:
            assert diff <= TRAIN_GRAD_REL * np.linalg.norm(value), (key, diff / np.linalg.norm(value))
    return zero


def test_clip_global_batch_loss_matches_jax(ranks):
    jax_step = _jax_clip_step(ranks)
    results = _results(ranks, "clip_global_batch")
    for r in results:  # every rank computes the global batch's loss
        np.testing.assert_allclose(r["loss"], jax_step["loss"], **FP32_TOL)
        assert r["count"] == 4
    want = jax_step["grads"]
    for key in (k for k in want if "running" in k):
        np.testing.assert_allclose(results[0]["buffers"][key], want[key], err_msg=key, **FP32_TOL)
    got = results[0]["grads"]
    hold_clip_gradients(got, want)
    for key, value in got.items():
        np.testing.assert_array_equal(results[1]["grads"][key], value, err_msg=key)


def test_clip_model_axis_step_matches_jax(ranks):
    """CLIP's projections cut over a model axis of two ranks (column-parallel
    fc1, row-parallel fc2, fc1's bias read in part): the towers below them
    take the gradient summed over the axis. The loss, every gradient tensor
    and every parameter after the update against JAX's one-device step on
    the same weights and batch; the ranks equal."""
    jax_step = _jax_clip_step(ranks)
    results = _results(ranks, "clip_model_axis")
    projections = [f"{p}_projection" for p in ("audio", "text")]
    assert results[0]["cut"] == {f"{p}.{fc}.weight": int(fc == "fc2") for p in projections for fc in ("fc1", "fc2")}
    assert results[0]["partial"] == [f"{p}.fc1.bias" for p in projections]
    for r in results:
        np.testing.assert_allclose(r["loss"], jax_step["loss"], **FP32_TOL)
    got = results[0]["grads"]
    zero = hold_clip_gradients(got, jax_step["grads"])
    for key, value in jax_step["after"].items():
        mine = results[0]["params"][key]
        assert key in zero or not np.array_equal(mine, ranks["inputs"]["clip_model_axis"]["state"][key]), key
        hold_adam_step(mine, value, key, got[key], jax_step["grads"][key], TRAINING["lr"])
    for key in results[0]["params"]:
        np.testing.assert_array_equal(results[1]["params"][key], results[0]["params"][key], err_msg=key)


def test_eat_ssl_step_with_its_ema_matches_jax(ranks):
    eat = ranks["eat"]
    results = _results(ranks, "eat_ssl_step")
    # sample size summed over ranks: each rank's loss is its share times the rank count
    assert [r["count"] for r in results] == [eat["count"] // WORLD] * WORLD
    got_loss = float(np.mean([r["loss"] for r in results]))
    assert abs(got_loss - eat["loss"]) <= LOSS_REL * abs(eat["loss"])
    np.testing.assert_allclose(sum(r["regression"] for r in results), eat["regression"], rtol=LOSS_REL)
    state = results[0]["state"]
    _assert_moved(eat["state"], state)
    mu = results[0]["mu"]  # the gradient the step applied, first moment / (1 - b1)

    def grads(key, source):
        """(the port's, JAX's) applied gradient of ``key`` (a teacher's: its
        student's, of which it takes the EMA's share)."""
        key = "student." + key[len("teacher."):] if key.startswith("teacher.") else key
        if key not in source:  # a buffer: no gradient
            return np.zeros(()), np.zeros(())
        return source[key] / np.float32(0.1), eat["grads"][key]

    for key, value in eat["after"].items():  # the student, the decoder and the teacher
        hold_adam_step(state[key], value, key, *grads(key, mu), TRAINING["lr"],
                       share=0.1 if key.startswith("teacher.") else 1.0)
    assert set(mu) == {k for k in eat["grads"] if not k.startswith("teacher.")}
    for key, got in mu.items():
        want, got = eat["grads"][key], got / np.float32(0.1)
        if key.endswith("attn.qkv.bias"):
            third = want.shape[0] // 3
            got, want = np.delete(got, np.s_[third:2 * third]), np.delete(want, np.s_[third:2 * third])
        np.testing.assert_allclose(got, want, err_msg=key, **FP32_TOL)
    for key, value in state.items():
        np.testing.assert_array_equal(results[1]["state"][key], value, err_msg=key)
        # ZeRO-3 takes the same step; its teacher, cut as its student is, takes the same EMA
        hold_adam_step(results[0]["fsdp"][key], value, key, grads(key, results[0]["fsdp_mu"])[0], grads(key, mu)[0],
                       TRAINING["lr"], share=0.1 if key.startswith("teacher.") else 1.0)
        if key.startswith("teacher."):  # the EMA of the averaged update, the same on every rank
            student = state["student." + key[len("teacher."):]]
            np.testing.assert_allclose(value, 0.9 * results[0]["teacher_before"][key] + 0.1 * student,
                                       atol=1e-6, rtol=1e-6)


def test_mesh_extraction_with_a_remainder_batch(ranks, tmp_path):
    """Cell 5: rank 0's cache equals JAX's single-device extraction (labels
    exactly, embeddings within cell 5's bound); rank 1 wrote nothing."""
    spec = ranks["inputs"]["extraction"]
    model = ranks["jax_extract"]
    model.register_hooks_for_layers(["last_layer"])
    jax_extract_to_cache(model, iter(spec["batches"]), tmp_path / "jax.h5", aggregation="mean")
    want_embs, want_labels, _ = jax_load_cache(tmp_path / "jax.h5")
    results = _results(ranks, "extraction")
    assert results[0]["written"] and not results[1]["written"]
    np.testing.assert_array_equal(results[0]["labels"], want_labels)
    assert results[0]["embeddings"].shape == (7, 64)
    np.testing.assert_allclose(results[0]["embeddings"], want_embs[0], **EXTRACT_TOL)


def test_gather_metrics_is_the_mean(ranks):
    for result in _results(ranks, "metrics_mean"):
        assert result == {"value": 1.5, "rank": 0.5}


def test_data_parallel_probe_matches_one_process(ranks):
    """FineTuneTrainer(mesh=...) on the ranks' halves against the port's
    single-process probe on the whole batches (itself held to JAX in
    tests/test_torch_finetune.py): parameters, training loss and the
    validation scores, mAP first (it picks the best epoch)."""
    spec = ranks["inputs"]["finetune"]
    probe = build_probe_from_config(ProbeConfig(**spec["probe"]), num_classes=spec["num_classes"],
                                    input_dim=spec["input_dim"], seed=0, device="cpu")
    trainer = FineTuneTrainer(probe, TrainingParams(**spec["training"]), metrics=spec["metrics"])
    history = trainer.train(spec["batches"], spec["batches"])["history"]
    results = _results(ranks, "finetune")
    for key, value in probe.module.named_parameters():
        for r in results:
            np.testing.assert_allclose(r["params"][key], value.detach().numpy(), err_msg=key, **PARAM_TOL)
    for r in results:
        for got, want in zip(r["history"], history):
            np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=LOSS_REL)
            for metric in (*PROBE_METRICS, "loss"):  # the whole validation set's scores
                np.testing.assert_allclose(got["val"][metric], want["val"][metric], rtol=LOSS_REL, err_msg=metric)


def test_run_train_distributed_shards_the_data_and_writes_on_rank_0(ranks):
    results = _results(ranks, "run_train_distributed")
    config = RunConfig.from_dict(dict(ranks["inputs"]["run_train_distributed"]["config"]))
    from avex_tpu.data.loader import DataLoader as JaxDataLoader

    n, batch = 10, config.training_params.batch_size
    for rank, r in enumerate(results):  # JAX's shard: the rank's strided slice, then batches, remainder dropped
        jax_loader = JaxDataLoader(list(range(n)), batch, collate_fn=lambda items: items, shuffle=True,
                                   drop_last=True, seed=0, shard_process=rank, num_shards=WORLD)
        assert r["train_indices"] == [chunk.tolist() for chunk in jax_loader._chunks()]
    assert {"final_model", "final_model.meta.json", "metadata", "metrics.jsonl", "label_map.json",
            "best_model"} <= set(results[0]["files"])
    assert results[1]["files"] == []
    assert results[0]["loss"] == results[1]["loss"]  # the epoch's metrics are averaged over ranks
    saved = torch.load(results[0]["final"] + "/checkpoint.pt", weights_only=True)
    assert np.isfinite(float(saved["params"]["classifier.weight"].sum()))


def test_run_evaluate_distributed_extracts_on_the_mesh_and_writes_once(ranks):
    """``run_evaluate`` on two ranks with one save directory: every rank
    gets the same metrics (the caches rank 0 wrote from the gathered rows),
    and the metadata holds one record per experiment and set."""
    results = [[{k: v for k, v in m.items() if k != "duration_seconds"} for m in r]
               for r in _results(ranks, "run_evaluate_distributed")]
    assert results[0] == results[1] and results[0][0]["probe"] and results[0][0]["retrieval"]
    save_dir = ranks["work"] / "evaluate"
    assert len((save_dir / "evaluation_metadata.jsonl").read_text().splitlines()) == len(results[0]) == 1
    assert sorted(str(p.relative_to(save_dir / "embeddings")) for p in save_dir.glob("embeddings/*/*")) == [
        "s_test_beats/embedding_test_last_layer.h5", "s_test_beats/embedding_test_pooled_last_layer.h5",
        "s_train_beats/embedding_train_last_layer.h5", "s_val_beats/embedding_val_last_layer.h5"]
