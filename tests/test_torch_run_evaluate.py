"""The port's evaluation entry point against the JAX package's.

``configs/eval_configs/synthetic_benchmark_example.yml`` (a tiny BEATs, a
linear probe over the last layer trained offline on the HDF5 embedding
cache, then retrieval and clustering over the pooled test embeddings) goes
through both ``run_evaluate.main``, on the CPU. The backbone and the probe
start from the same weights: each package's ``build_model_from_spec`` and
``build_probe_from_config`` are wrapped so that the port's copies take the
JAX ones' (``models.beats.params_from_jax``, ``probes.params_from_jax``, as
``test_torch_finetune.py`` does). Held: every HDF5 cache within atol 5e-5 /
rtol 1e-4 with equal labels and attributes, retrieval within abs 1e-5,
clustering within abs 1e-4, the probe's test metrics equal (its test loss,
and each epoch's training loss, within rel 1e-5), equal ``probe_info``,
JSONL keys and CSV columns. Then the same with the probe trained online
through the frozen backbone, on two evaluation sets: the backbone is built
once and serves both.
"""

import csv
import copy
import json

import h5py
import numpy as np
import pytest
import torch
import yaml

import jax

import avex_tpu
import avex_tpu.evaluation.finetune as jax_finetune
import avex_tpu.run_evaluate as jax_run_evaluate
from avex_tpu.configs import EvaluateConfig as JaxEvaluateConfig

import avex_tpu_torch
import avex_tpu_torch.evaluation.finetune as finetune
import avex_tpu_torch.run_evaluate as run_evaluate
from avex_tpu_torch.configs import EvaluateConfig
from avex_tpu_torch.models import beats
from avex_tpu_torch.probes import params_from_jax
from tests.test_torch_data import EVAL_YAML
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

CACHE_TOL = dict(atol=5e-5, rtol=1e-4)
RETRIEVAL_ABS, CLUSTERING_ABS, LOSS_REL = 1e-5, 1e-4, 1e-5


def _tree(x):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(x))


def _carry_weights(monkeypatch):
    """Wrap both packages' model and probe builders and both trainers' loop:
    the port's backbone and probe take the JAX ones' initial weights; every
    built model and training history is recorded."""
    seen = {"jax_models": [], "port_models": [], "jax_probes": [], "jax_history": [], "port_history": []}
    build_jax_probe, build_probe = jax_finetune.build_probe_from_config, finetune.build_probe_from_config

    def jax_model(spec, **kwargs):
        model = avex_tpu.build_model_from_spec(spec, **kwargs)
        seen["jax_models"].append(model)
        return model

    def port_model(spec, **kwargs):
        model = avex_tpu_torch.build_model_from_spec(spec, **kwargs)
        jax_params = _tree(seen["jax_models"][len(seen["port_models"])].variables["params"])
        model.load_port_state_dict(beats.params_from_jax(jax_params), strict=True)
        seen["port_models"].append(model)
        return model

    def jax_probe(*args, **kwargs):
        probe = build_jax_probe(*args, **kwargs)
        seen["jax_probes"].append(_tree(probe.variables["params"]))
        return probe

    def port_probe(*args, **kwargs):
        probe = build_probe(*args, **kwargs)
        state = params_from_jax(seen["jax_probes"][seen["port_probes"]])
        probe.module.load_state_dict({k: torch.tensor(v) for k, v in state.items()})
        seen["port_probes"] += 1
        return probe

    def recording(cls, key):
        train = cls.train

        def wrapped(self, *args, **kwargs):
            result = train(self, *args, **kwargs)
            seen[key].append(result["history"])
            return result
        return wrapped

    seen["port_probes"] = 0
    monkeypatch.setattr(jax_run_evaluate, "build_model_from_spec", jax_model)
    monkeypatch.setattr(run_evaluate, "build_model_from_spec", port_model)
    monkeypatch.setattr(jax_finetune, "build_probe_from_config", jax_probe)
    monkeypatch.setattr(finetune, "build_probe_from_config", port_probe)
    monkeypatch.setattr(jax_finetune.FineTuneTrainer, "train", recording(jax_finetune.FineTuneTrainer, "jax_history"))
    monkeypatch.setattr(finetune.FineTuneTrainer, "train", recording(finetune.FineTuneTrainer, "port_history"))
    return seen


def _run_both(tmp_path, monkeypatch, raw):
    """Both ``main``s on the same config dict; returns (port results, JAX results, seen)."""
    seen = _carry_weights(monkeypatch)
    want = jax_run_evaluate.main(JaxEvaluateConfig.model_validate(dict(raw, save_dir=str(tmp_path / "jax"))))
    got = run_evaluate.main(EvaluateConfig.from_dict(dict(raw, save_dir=str(tmp_path / "port"), device="cpu")))
    return got, want, seen


def _assert_records_match(tmp_path, got, want, seen):
    assert len(got) == len(want)
    for mine, ref in zip(got, want):
        assert mine["probe_info"] == ref["probe_info"]
        probe, ref_probe = mine["metrics"]["probe"], ref["metrics"]["probe"]
        assert set(probe) == set(ref_probe)
        for key, value in ref_probe.items():
            if key == "test_loss":
                assert abs(probe[key] - value) <= LOSS_REL * abs(value)
            else:
                assert probe[key] == value, key
    assert len(seen["port_history"]) == len(seen["jax_history"]) == len(got)
    for mine, ref in zip(seen["port_history"], seen["jax_history"]):
        assert len(mine) == len(ref)
        for m, r in zip(mine, ref):
            assert abs(m["train_loss"] - r["train_loss"]) <= LOSS_REL * abs(r["train_loss"]), m["epoch"]
            assert abs(m["val"]["loss"] - r["val"]["loss"]) <= LOSS_REL * abs(r["val"]["loss"]), m["epoch"]
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    mine = [json.loads(x) for x in (port_dir / "evaluation_metadata.jsonl").read_text().splitlines()]
    ref = [json.loads(x) for x in (jax_dir / "evaluation_metadata.jsonl").read_text().splitlines()]
    assert [list(r) for r in mine] == [list(r) for r in ref]
    assert [sorted(r["metrics"]) for r in mine] == [sorted(r["metrics"]) for r in ref]
    for name in ("summary.csv", "summary_simple.csv"):
        with open(port_dir / name) as f, open(jax_dir / name) as g:
            assert next(csv.reader(f)) == next(csv.reader(g)), name
    assert sorted(p.name for p in (port_dir / "summaries").iterdir()) == \
        sorted(p.name for p in (jax_dir / "summaries").iterdir())


def test_offline_probe_retrieval_and_clustering_match_jax(tmp_path, monkeypatch):
    raw = yaml.safe_load(EVAL_YAML.read_text())
    got, want, seen = _run_both(tmp_path, monkeypatch, raw)
    _assert_records_match(tmp_path, got, want, seen)
    mine, ref = got[0]["metrics"], want[0]["metrics"]
    for key, value in ref["retrieval"].items():
        assert abs(mine["retrieval"][key] - value) <= RETRIEVAL_ABS, key
    for key, value in ref["clustering"].items():
        assert abs(mine["clustering"][key] - value) <= CLUSTERING_ABS, key

    caches = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.h5"))
    assert len(caches) == 4  # train, val, test, and the pooled test split
    assert caches == sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.h5"))
    for rel in caches:
        with h5py.File(tmp_path / "port" / rel) as f, h5py.File(tmp_path / "jax" / rel) as g:
            assert sorted(f) == sorted(g) and dict(f.attrs).keys() == dict(g.attrs).keys(), rel
            for key in f.attrs:
                np.testing.assert_array_equal(f.attrs[key], g.attrs[key], err_msg=f"{rel} {key}")
            np.testing.assert_array_equal(f["labels"][()], g["labels"][()])
            np.testing.assert_allclose(f["embeddings_0"][()], g["embeddings_0"][()], err_msg=str(rel), **CACHE_TOL)


def test_online_probe_on_two_sets_reuses_the_backbone(tmp_path, monkeypatch):
    raw = yaml.safe_load(EVAL_YAML.read_text())
    raw["experiments"][0]["probe_config"]["online_training"] = True
    second = copy.deepcopy(raw["dataset_config"]["evaluation_sets"][0])
    second["name"] = "synth_b"
    for split, seed in (("train", 10), ("val", 11), ("test", 12)):
        second[split].update(name=f"b_{split}", seed=seed, num_samples=24 if split == "train" else 8)
    raw["dataset_config"]["evaluation_sets"].append(second)
    raw.update(eval_modes=["probe"], training_params={"train_epochs": 2, "lr": 5e-3, "batch_size": 8})
    got, want, seen = _run_both(tmp_path, monkeypatch, raw)
    _assert_records_match(tmp_path, got, want, seen)
    assert len(seen["port_models"]) == len(seen["jax_models"]) == 1  # one frozen backbone for both sets
    assert [r["evaluation_set"] for r in got] == ["synth", "synth_b"]
    assert not list((tmp_path / "port").rglob("*.h5"))  # online: no embedding cache


def test_evaluate_needs_the_card_unless_the_cpu_is_named(tmp_path):
    raw = yaml.safe_load(EVAL_YAML.read_text())
    config = EvaluateConfig.from_dict(dict(raw, save_dir=str(tmp_path)))
    assert config.device == "cuda"  # the YAML's device: tpu
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_evaluate.run_experiment(config.experiments[0], config.dataset_config.evaluation_sets[0], config)
