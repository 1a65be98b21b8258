"""Expert parallelism, the 3-D cell and Bird-MAE's model axis on gloo processes, against JAX.

Three of JAX's ``__graft_entry__.dryrun_multichip`` cells and Bird-MAE's
layer-stack options, run by the port over four spawned gloo ranks
(``tests/test_torch_model_axis_ranks.py``, one group for the file) on
JAX's weights carried across, each held to JAX's **one-device** run of the
same model, weights and batch (JAX's 2x2 meshes double BEATs' ``pos_conv``
gradient, ROADMAP queue 3; sharding changes no value):

- cell 8, the MoE probe (8 experts, top-2) trained by ``FineTuneTrainer``
  on a 2x2 mesh, its expert tensors cut over the model axis
  (``shard_moe_params``): the epoch's loss at rtol 1e-4, every parameter
  after training at atol 1e-5 / rtol 1e-4, and the cut set against the one
  JAX's ``_place_trainable`` gives a 2x2 mesh and ``shard_moe_params``'s
  placement (``tests/unittests/test_moe.py:93``);
- cell 9, the 3-D dp x pp x tp cell on a 1x2x2 mesh: BEATs' stacked
  encoder in two GPipe stages (M=2), each stage's products cut over ``tp``;
  the loss before and after one SGD step at rtol 1e-4 / atol 1e-5
  (``__graft_entry__.py:163-168``) and every parameter after it at
  atol 1e-5 / rtol 1e-4;
- Bird-MAE with ``scan_layers`` through the ``Trainer`` on a 2x2 mesh:
  GPipe (two stages, M=2) and Megatron-SP with tensor parallelism (its 1 +
  32 tokens cut unevenly over the axis), the port on its K5/K6 twins, JAX
  plain: the loss, every gradient tensor and every parameter after one
  update, as ``tests/test_torch_model_parallel.py`` holds its cells.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import avex_tpu
from __graft_entry__ import _count_sharded
from avex_tpu.configs import TrainingParams as JaxTrainingParams
from avex_tpu.evaluation.finetune import FineTuneTrainer as JaxFineTuneTrainer
from avex_tpu.models.beats import BEATsBackbone as JaxBEATsBackbone
from avex_tpu.models.beats import BEATsConfig as JaxBEATsConfig
from avex_tpu.ops.moe import shard_moe_params as jax_shard_moe_params
from avex_tpu.parallel import make_mesh as jax_make_mesh
from avex_tpu.probes import build_probe_from_config as jax_build_probe

from avex_tpu_torch.models import beats, birdmae
from avex_tpu_torch.probes import params_from_jax
from tests.test_torch_efficientnet import _tree
from tests.test_torch_model_axis_ranks import WORLD, rank_main
from tests.test_torch_model_parallel import RAW_AUDIO, _dump, _spec, hold_step, jax_cell
from tests.test_torch_parallel_ranks import RankGroup
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
MOE = {"probe_type": "moe", "num_experts": 8, "moe_k": 2, "moe_hidden_dim": 16, "capacity_factor": 2.0,
       "dropout_rate": 0.0}
MOE_DIM, MOE_CLASSES, MOE_BATCH = 32, 4, 16  # the cell's widths; its global batch of 2 x devices at 8
# the cell's step; a clip the gradient's norm passes, so the cut experts' share of it counts
MOE_TRAINING = dict(train_epochs=1, lr=1e-3, batch_size=MOE_BATCH, gradient_clip_val=0.05)
THREE_D = dict(encoder_layers=4, encoder_embed_dim=64, encoder_ffn_embed_dim=128, encoder_attention_heads=4,
               embed_dim=32, dropout=0.0, attention_dropout=0.0, encoder_layerdrop=0.0, dropout_input=0.0,
               scan_layers=True)  # the cell's BEATs (__graft_entry__._dryrun_3d_pp_tp)
SGD_LR = 0.1
BIRDMAE = {"depth": 2, "dim": 128, "heads": 2, "target_length": 64, "scan_layers": True}  # dh 64: K5/K6


def _moe_batches():
    rng = np.random.default_rng(11)
    return [{"embeddings_0": rng.standard_normal((MOE_BATCH, MOE_DIM)).astype(np.float32),
             "label": rng.integers(0, MOE_CLASSES, size=MOE_BATCH)} for _ in range(2)]


def _jax_moe():
    """JAX's probe weights in the port's names, its one-device run (the loss
    of each epoch, the parameters after), and the names it places over the
    model axis of a 2x2 mesh."""
    probe = jax_build_probe(MOE, num_classes=MOE_CLASSES, input_dim=MOE_DIM, seed=0)
    state = params_from_jax(_tree(probe.variables["params"]))
    two = JaxFineTuneTrainer(probe, JaxTrainingParams(**MOE_TRAINING),
                             mesh=jax_make_mesh(data=2, model=2, devices=jax.devices()[:4]), seed=0)
    placed = two._place_trainable(two._trainable)
    marks = jax.tree_util.tree_map(
        lambda leaf: np.full(leaf.shape, float("model" in str(leaf.sharding.spec)), np.float32), placed["probe"])
    cut = {k for k, v in params_from_jax(_tree(marks)).items() if v.min() == 1.0}
    one = JaxFineTuneTrainer(probe, JaxTrainingParams(**MOE_TRAINING),
                             mesh=jax_make_mesh(data=1, model=1, devices=jax.devices()[:1]), seed=0)
    result = one.train(_moe_batches())
    return {"state": state, "losses": [h["train_loss"] for h in result["history"]],
            "params": params_from_jax(_tree(one._trainable["probe"])), "cut": cut,
            "n_cut": _count_sharded(placed, "model")}


def _jax_three_d():
    """The cell's BEATs and batch, its weights in the port's names, and JAX's
    one-device SGD step: the loss before and after, the parameters after
    (the port's names). The step moves the
    parameters only: the dry run's ``tree_map`` over all of ``variables``
    also moves the fbank's ``constants`` (their gradient is not 0), which
    the port holds as buffers (ROADMAP queue 3)."""
    solo = JaxBEATsBackbone(cfg=JaxBEATsConfig(**THREE_D), dtype=jnp.float32)
    wav = (np.random.default_rng(13).standard_normal((8, 16000)) * 0.1).astype(np.float32)
    variables = jax.jit(solo.init)(jax.random.PRNGKey(3), jnp.asarray(wav[:2]))

    def loss_fn(v, w):
        return jnp.mean(solo.apply(v, w)[0].astype(jnp.float32) ** 2)

    def step(v, w):
        loss0, grads = jax.value_and_grad(loss_fn)(v, w)
        params = jax.tree_util.tree_map(lambda p, g: p - SGD_LR * g, v["params"], grads["params"])
        return loss0, loss_fn({**v, "params": params}, w), params

    loss0, loss1, after = jax.jit(step)(variables, jnp.asarray(wav))
    state = beats.params_from_jax(_tree({"backbone": variables["params"]}))
    spec = {"model_spec": dict(name="beats", pretrained=False, init_config=THREE_D, audio_config=RAW_AUDIO),
            "state": state, "wav": wav, "microbatches": 2, "lr": SGD_LR}
    return spec, {"losses": (float(loss0), float(loss1)), "params": beats.params_from_jax(_tree({"backbone": after}))}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """JAX's weights go to the ranks as they are made; JAX's runs follow
    while the ranks take theirs."""
    work = tmp_path_factory.mktemp("expert_parallel")
    moe = _jax_moe()
    three_d, three_d_want = _jax_three_d()
    bird = avex_tpu.build_model_from_spec(
        avex_tpu.configs.ModelSpec(name="birdmae", pretrained=False, init_config=BIRDMAE, audio_config=RAW_AUDIO),
        num_classes=4)
    bird_weights = jax.tree_util.tree_map(np.asarray, dict(bird.variables))
    bird_state = birdmae.params_from_jax(bird_weights["params"])
    port_init = dict(BIRDMAE, use_pallas=True)  # the port on its K5/K6 twins
    _dump({"moe_expert_parallel": {"probe": MOE, "num_classes": MOE_CLASSES, "input_dim": MOE_DIM,
                                   "state": moe["state"], "training": MOE_TRAINING, "batches": _moe_batches()},
           "three_d": three_d,
           "birdmae_pipeline": _spec("birdmae", port_init, bird_state,
                                     {"data": 2, "model": 2, "pipeline_microbatches": 2}),
           "birdmae_sp": _spec("birdmae", port_init, bird_state, {"data": 2, "model": 2, "sequence_parallel": True})},
          work / "inputs.pkl")
    _dump({}, work / "inputs_late.pkl")
    group = RankGroup(work, world=WORLD, timeout=240.0, main=rank_main)
    oracle = jax_cell("birdmae", BIRDMAE, work / "birdmae_one", birdmae.params_from_jax, variables=bird_weights,
                      data=1, model=1)
    return {"group": group, "moe": moe, "three_d": three_d_want, "birdmae": oracle,
            "three_d_size": sum(v.size for v in three_d["state"].values())}


def test_moe_expert_parallel_matches_jax(ranks):
    """Cell 8: each model rank held its four experts of eight while training,
    the router and the classifier whole; the loss and the trained parameters
    are JAX's one-device run's, and every rank ends with the whole probe."""
    results = [r["moe_expert_parallel"] for r in ranks["group"].results()]
    want = ranks["moe"]
    assert [r["coords"] for r in results] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert set(results[0]["cut"]) == want["cut"] and len(results[0]["cut"]) == want["n_cut"] == 4
    for r in results:
        for name, shape in r["held"].items():
            whole = want["params"][name].shape
            assert shape == ((whole[0] // 2,) + whole[1:] if name in want["cut"] else whole), name
    for r in results:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-4)
        assert set(r["params"]) == set(want["params"])
        for name, value in want["params"].items():
            np.testing.assert_allclose(r["params"][name], value, err_msg=name, **PARAM_TOL)
            np.testing.assert_array_equal(r["params"][name], results[0]["params"][name])
    moved = [n for n, v in want["params"].items() if not np.array_equal(results[0]["params"][n], want["state"][n])]
    assert set(want["cut"]) <= set(moved)


def test_shard_moe_params_places_experts_only():
    """JAX's placement rule (``tests/unittests/test_moe.py:93``): under a
    ``moe`` module the expert-major tensors are cut on their expert axis,
    the router stays whole; a bare MoE layer has no ``moe`` path."""
    from avex_tpu.ops.moe import MoEMLP as JaxMoEMLP
    from avex_tpu_torch.ops.moe import moe_sharding

    mod = JaxMoEMLP(num_experts=8, hidden_dim=16, out_dim=16)
    variables = mod.init(jax.random.PRNGKey(0), jnp.zeros((4, MOE_DIM)))
    placed = jax_shard_moe_params({"head": {"moe": variables["params"]}}, jax_make_mesh(data=2, model=4))
    moe = placed["head"]["moe"]
    want = {k for k in ("w1", "b1", "w2", "b2") if moe[k].sharding.spec[0] == "model"}
    assert want == {"w1", "b1", "w2", "b2"} and moe["router"]["kernel"].sharding.is_fully_replicated
    shapes = {"w1": (8, MOE_DIM, 16), "b1": (8, 16), "w2": (8, 16, 16), "b2": (8, 16), "router.weight": (8, MOE_DIM)}
    got = {k for k, shape in shapes.items() if moe_sharding(f"head.moe.{k}", shape, 4) == 0}
    assert got == want
    assert all(moe_sharding(k, shape, 4) is None for k, shape in shapes.items())  # no "moe" on the path
    assert moe_sharding("head.moe.w1", (6, MOE_DIM, 16), 4) is None  # the axis does not divide the experts


def test_three_d_cell_matches_jax(ranks):
    """Cell 9: the loss before and after one SGD step of the 1x2x2 cell is
    JAX's one-device step's, and so is every parameter after it (gathered
    whole from the stages and the tp ranks); every rank agrees; the stages
    hold their own layers and their products are cut over ``tp``."""
    results = [r["three_d"] for r in ranks["group"].results()]
    assert [r["coords"] for r in results] == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    want = ranks["three_d"]
    for r in results:
        np.testing.assert_allclose(r["losses"], want["losses"], **LOSS_TOL)
        assert r["losses"] == results[0]["losses"]
    got = results[0]["params"]
    assert set(want["params"]) <= set(got)
    for name, value in want["params"].items():
        np.testing.assert_allclose(got[name], value, err_msg=name, **PARAM_TOL)
    # tp cuts q/k/v/out_proj and fc1/fc2 of every layer; each stage holds two layers of four
    assert len(results[0]["tp_cut"]) == 4 * 6 and all(".layers." in n for n in results[0]["tp_cut"])
    assert results[0]["stage_owned"] > 0 and all(r["held"] < ranks["three_d_size"] for r in results)


@pytest.mark.parametrize("scenario", ["birdmae_pipeline", "birdmae_sp"])
def test_birdmae_model_axis_step_matches_jax(ranks, scenario):
    """Bird-MAE's GPipe and Megatron-SP steps on a 2x2 mesh against JAX's
    one-device step on the same stacked weights."""
    oracle = ranks["birdmae"]
    hold_step(ranks["group"].results(), scenario, oracle["loss"], oracle["params"], oracle["grads"],
              oracle["initial"])
