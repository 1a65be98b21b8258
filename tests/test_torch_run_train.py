"""The port's training entry point against the JAX package's.

``configs/run_configs/beats_supervised_example.yml`` (a tiny BEATs on
synthetic clips, 3 epochs of 8 steps, AdamW, cosine schedule, validation and
per-epoch checkpoints) with ``model_spec.init_config.dropout=0.0`` goes
through both ``run_train.main``: the JAX package's with its loader in the
calling process, the port's with two loader worker processes (its batches do
not depend on the worker count). Each module's ``build_model_from_spec`` is
wrapped so that the port's model starts from the JAX model's initial
weights (``models.beats.params_from_jax``). Held: each epoch's training and
validation loss within rel 1e-5, the final parameters within atol 1e-5 /
rtol 1e-4 (as ``test_torch_training.py``, with its allowance for the key
projection's bias, whose exact gradient is 0), the same ``metrics.jsonl``
lines and keys, the same checkpoints and label map.
"""

import json

import numpy as np
import pytest

import jax

import avex_tpu
import avex_tpu.run_train as jax_run_train
from avex_tpu.configs import RunConfig as JaxRunConfig

import avex_tpu_torch
import avex_tpu_torch.run_train as run_train
from avex_tpu_torch.configs import RunConfig
from avex_tpu_torch.data import GrainDataLoader
from avex_tpu_torch.models import beats
from tests.test_torch_data import RUN_YAML
from tests.test_torch_training import _zero_gradient
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

LOSS_REL = 1e-5
PARAM_TOL = dict(atol=1e-5, rtol=1e-4)
PATCHES = ["model_spec.init_config.dropout=0.0"]


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


def _lines(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_run_train_matches_jax(tmp_path, monkeypatch):
    built = {}

    def jax_build(spec, **kwargs):
        model = avex_tpu.build_model_from_spec(spec, **kwargs)
        built["initial"] = _tree(model.variables["params"])
        built["jax"] = model
        return model

    def port_build(spec, **kwargs):
        model = avex_tpu_torch.build_model_from_spec(spec, **kwargs)
        model.load_port_state_dict(beats.params_from_jax(built["initial"]), strict=True)
        built["port"] = model
        return model

    monkeypatch.setattr(jax_run_train, "build_model_from_spec", jax_build)
    monkeypatch.setattr(run_train, "build_model_from_spec", port_build)
    want = jax_run_train.main(JaxRunConfig.from_sources(
        RUN_YAML, PATCHES + ["num_workers=0", f"output_dir={tmp_path / 'jax'}"]))
    config = RunConfig.from_sources(RUN_YAML, PATCHES + ["num_workers=2", "device=cpu",
                                                         f"output_dir={tmp_path / 'port'}"])
    got = run_train.main(config)

    assert built["port"].device.type == "cpu" and built["port"].num_classes == 4
    assert built["port"].label_mapping == built["jax"].label_mapping == {f"class_{i}": i for i in range(4)}
    assert len(got["history"]) == len(want["history"]) == 3
    for mine, ref in zip(got["history"], want["history"]):
        for split in ("train", "val"):
            assert set(mine[split]) == set(ref[split]), split
            assert mine[split]["samples"] == ref[split]["samples"]
            assert abs(mine[split]["loss"] - ref[split]["loss"]) <= LOSS_REL * abs(ref[split]["loss"]), \
                (mine["epoch"], split)
    assert got["best_val_acc"] == want["best_val_acc"]

    state = built["port"].state_dict()
    for key, value in beats.params_from_jax(_tree(built["jax"].variables["params"])).items():
        mine, noise = state[key].numpy(), _zero_gradient(key, value.shape)
        np.testing.assert_allclose(mine[~noise], value[~noise], err_msg=key, **PARAM_TOL)
        assert np.abs(mine[noise] - value[noise]).max(initial=0.0) <= 2 * 24 * config.training_params.lr, key

    mine, ref = _lines(tmp_path / "port" / "metrics.jsonl"), _lines(tmp_path / "jax" / "metrics.jsonl")
    assert [(r["type"], sorted(r.get("metrics", r.get("params")))) for r in mine] == \
        [(r["type"], sorted(r.get("metrics", r.get("params")))) for r in ref]
    assert mine[0] == ref[0]  # the params line
    for m, r in zip(mine[1:], ref[1:]):
        assert m["step"] == r["step"]
        for key, value in r["metrics"].items():
            if key.endswith("/loss"):
                assert abs(m["metrics"][key] - value) <= LOSS_REL * abs(value), key
    written = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert written == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert {"checkpoint_epoch_2", "best_model", "final_model", "label_map.json", "metadata"} <= set(written)
    assert json.loads((tmp_path / "port" / "label_map.json").read_text()) == built["port"].label_mapping


def test_run_train_refuses_what_is_not_ported(tmp_path):
    config = RunConfig.from_sources(RUN_YAML, ["device=cpu", f"output_dir={tmp_path}"])
    # distributed=True and the model axis are ported (tests/test_torch_parallel_training.py,
    # tests/test_torch_model_parallel.py); sequence parallelism needs the stacked layout, as in JAX
    with pytest.raises(ValueError, match="scan_layers"):
        run_train.main(config.replace(mesh={"sequence_parallel": True}))
    # data_pipeline="grain" is ported: the checkpointable loader (tests/test_torch_grain_loader.py)
    assert isinstance(run_train.build_dataloaders(config.replace(data_pipeline="grain"))[0], GrainDataLoader)
