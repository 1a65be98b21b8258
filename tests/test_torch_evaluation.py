"""The port's evaluation library against the JAX package's.

A tiny BEATs with the same weights in both packages (``params_from_jax``):
HDF5 caches written by each package and read by the other (same datasets,
same attributes); the extraction loop; ``EmbeddingDataSource`` computing,
reusing, streaming past the memory limit, invalidating on an aggregation
mismatch and overwriting. Retrieval against JAX's scikit-learn numbers
(abs 1e-6; ties, a single label, cross-set), clustering equal to JAX's on
the same arrays, and the ``ClusteringEvaluator`` inside a port ``Trainer``.
"""

import pickle

import numpy as np
import pytest
import torch

import jax

import avex_tpu
from avex_tpu.configs import ModelSpec as JaxModelSpec
from avex_tpu.evaluation import clustering as jax_clustering
from avex_tpu.evaluation import embedding_cache as jax_cache
from avex_tpu.evaluation import retrieval as jax_retrieval

import avex_tpu_torch
from avex_tpu_torch.configs import ClusteringEvalConfig, ModelSpec, RunConfig, TrainingParams
from avex_tpu_torch.evaluation import (
    EmbeddingDataSource,
    HDF5EmbeddingDataset,
    InMemoryEmbeddingDataset,
    cache_path,
    compute_embeddings,
    embedding_cache_matches,
    eval_clustering,
    eval_clustering_multi_k,
    eval_retrieval,
    eval_retrieval_cross_set,
    extract_embeddings,
    extract_embeddings_to_cache,
    load_cached_embeddings,
)
from avex_tpu_torch.evaluation.retrieval import cosine_similarity, roc_auc
from avex_tpu_torch.models import beats
from avex_tpu_torch.parallel import make_mesh
from avex_tpu_torch.training import Trainer
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

FP32_TOL = dict(atol=5e-5, rtol=1e-4)
BEATS_TINY = {
    "encoder_layers": 2, "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 96,
    "encoder_attention_heads": 4, "embed_dim": 32, "dropout": 0.0,
    "attention_dropout": 0.0, "encoder_layerdrop": 0.0,
}
RAW_AUDIO = {"representation": "raw", "normalize": False, "target_length_seconds": 1}
LAYERS = [1, "last_layer"]


@pytest.fixture(scope="module")
def models():
    """(JAX BEATs, port BEATs on the CPU) holding the same weights."""
    jax_model = avex_tpu.build_model_from_spec(JaxModelSpec(
        name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW_AUDIO), return_features_only=True)
    port = avex_tpu_torch.build_model_from_spec(ModelSpec(
        name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW_AUDIO, device="cpu"),
        return_features_only=True)
    port.load_port_state_dict(beats.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_model.variables["params"])),
                              strict=True)
    return jax_model, port


def _loader(n_batches=3, batch=4, seed=0, classes=3):
    rng = np.random.default_rng(seed)
    return [{"raw_wav": (rng.standard_normal((batch, 8000)) * 0.1).astype(np.float32),
             "label": rng.integers(0, classes, batch)} for _ in range(n_batches)]


@pytest.mark.parametrize("aggregation", ["none", "mean"])
def test_hdf5_caches_cross_read(tmp_path, models, aggregation):
    """Each package reads the other's file: the same datasets and attributes."""
    jax_model, port = models
    loader = _loader()
    jax_path = jax_cache.extract_embeddings_to_cache(jax_model, loader, tmp_path / "jax.h5", aggregation, LAYERS)
    port_path = extract_embeddings_to_cache(port, loader, tmp_path / "port.h5", aggregation, LAYERS)
    assert not (tmp_path / "port.h5.tmp").exists()
    from_jax = load_cached_embeddings(jax_path)  # the port reads JAX's file
    from_port = jax_cache.load_cached_embeddings(port_path)  # JAX reads the port's
    # mean pooling concatenates the two layers into one dataset
    assert len(from_jax[0]) == len(from_port[0]) == (2 if aggregation == "none" else 1)
    for want, got in zip(from_jax[0], from_port[0]):
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **FP32_TOL)
    np.testing.assert_array_equal(from_jax[1], from_port[1])
    assert from_port[1].dtype == from_jax[1].dtype
    meta_jax, meta_port = from_jax[2], from_port[2]
    assert set(meta_jax) == set(meta_port) == {"aggregation", "layer_names", "multi_layer", "num_samples",
                                                 "embedding_dims"}
    for key in meta_jax:
        assert np.array_equal(np.asarray(meta_jax[key]), np.asarray(meta_port[key])), key
    assert embedding_cache_matches(jax_path, aggregation, port._hook_layers)
    assert jax_cache.embedding_cache_matches(port_path, aggregation, jax_model._hook_layers)
    assert not embedding_cache_matches(jax_path, "max", port._hook_layers)
    lazy = HDF5EmbeddingDataset(jax_path)
    item = pickle.loads(pickle.dumps(lazy))[5]
    np.testing.assert_array_equal(item[f"embeddings_{len(from_jax[0]) - 1}"], from_jax[0][-1][5])
    assert item["label"] == from_jax[1][5] and len(lazy) == 12


def test_cache_naming_matches_jax():
    for layers in (["last_layer"], [1, "backbone.encoder.layers.0.fc2"], []):
        assert cache_path("out", "esc50", "beats", "test", layers) == jax_cache.cache_path(
            "out", "esc50", "beats", "test", layers)


def test_extraction_loop_yields_each_batch_in_order(models):
    _, port = models
    loader = _loader(seed=1)
    port.register_hooks_for_layers(LAYERS)
    parts = list(extract_embeddings(port, loader, aggregation="none"))
    assert len(parts) == 3
    for (embs, labels), batch in zip(parts, loader):
        want = port.extract_embeddings(batch["raw_wav"], aggregation="none")
        for got, w in zip(embs, want):
            assert isinstance(got, np.ndarray) and got.dtype == np.float32
            np.testing.assert_array_equal(got, w.numpy())
        np.testing.assert_array_equal(labels, batch["label"])
    per_layer, labels = compute_embeddings(port, loader, aggregation="mean", layers=["last_layer"])
    assert [p.shape for p in per_layer] == [(12, 64)] and labels.shape == (12,)


def test_embedding_source_compute_reuse_stream_invalidate_overwrite(tmp_path, models, monkeypatch):
    _, port = models
    calls = []
    real = port.extract_embeddings
    monkeypatch.setattr(port, "extract_embeddings", lambda *a, **k: calls.append(1) or real(*a, **k))
    path = tmp_path / "cache" / "emb.h5"
    loader = _loader(seed=2)

    ds = EmbeddingDataSource(port, path, layers=["last_layer"], aggregation="mean").get_dataset(loader)
    assert isinstance(ds, InMemoryEmbeddingDataset) and len(ds) == 12 and len(calls) == 3  # computed
    assert ds[0]["embeddings_0"].shape == (64,) and "label" in ds[0]
    assert EmbeddingDataSource(port, path, layers=["last_layer"], aggregation="mean").embedding_dims() == [64]

    ds = EmbeddingDataSource(port, path, layers=["last_layer"], aggregation="mean").get_dataset(loader)
    assert len(calls) == 3 and isinstance(ds, InMemoryEmbeddingDataset)  # reused

    lazy = EmbeddingDataSource(port, path, layers=["last_layer"], aggregation="mean",
                               memory_limit_bytes=1).get_dataset(loader)
    assert len(calls) == 3 and isinstance(lazy, HDF5EmbeddingDataset)  # streamed past the limit
    np.testing.assert_array_equal(lazy[3]["embeddings_0"], ds[3]["embeddings_0"])

    ds = EmbeddingDataSource(port, path, layers=["last_layer"], aggregation="none").get_dataset(loader)
    assert len(calls) == 6 and ds[0]["embeddings_0"].shape == (24, 64)  # aggregation mismatch: recomputed

    EmbeddingDataSource(port, path, layers=["last_layer"], aggregation="none", overwrite=True).get_dataset(loader)
    assert len(calls) == 9  # overwritten
    # a mesh of one process extracts what no mesh does (two ranks: tests/test_torch_parallel_training.py)
    meshed = EmbeddingDataSource(port, tmp_path / "x.h5", layers=["last_layer"], aggregation="mean",
                                 mesh=make_mesh(device="cpu")).get_dataset(loader)
    np.testing.assert_array_equal(meshed[3]["embeddings_0"], lazy[3]["embeddings_0"])


def _retrieval_sets():
    rng = np.random.default_rng(3)
    labels = rng.integers(0, 4, 40)
    embs = (np.eye(4, 16)[labels] * 2 + rng.standard_normal((40, 16))).astype(np.float32)
    tied = np.round(embs, 0)  # coarse values: many tied similarities
    return {"random": (embs, labels), "ties": (tied, labels), "one_hot": (embs, np.eye(4)[labels]),
            "single_label": (embs, np.zeros(40, int))}


@pytest.mark.parametrize("case", ["random", "ties", "one_hot", "single_label"])
def test_retrieval_matches_jax(case):
    embs, labels = _retrieval_sets()[case]
    got, want = eval_retrieval(embs, labels, device="cpu"), jax_retrieval.eval_retrieval(embs, labels)
    assert set(got) == set(want)
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])
    if case == "single_label":
        assert got["roc_auc"] == 0.0
    q_embs, q_labels = _retrieval_sets()["random"]
    got = eval_retrieval_cross_set(q_embs[:15], labels[:15], embs[15:], labels[15:], device="cpu")
    want = jax_retrieval.eval_retrieval_cross_set(q_embs[:15], labels[:15], embs[15:], labels[15:])
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-6, (key, got[key], want[key])


def test_roc_auc_is_sklearns_with_ties():
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(4)
    for _ in range(5):
        y = rng.integers(0, 2, 300)
        scores = rng.integers(0, 6, 300).astype(np.float32)  # heavy ties
        assert abs(roc_auc(y, scores) - roc_auc_score(y, scores)) <= 1e-12


def test_similarity_is_fp32_on_the_named_device():
    embs = _retrieval_sets()["random"][0]
    sim = cosine_similarity(torch.from_numpy(embs), embs[:7], device="cpu")
    assert sim.dtype == torch.float32 and sim.shape == (40, 7) and sim.device.type == "cpu"
    ref = embs.astype(np.float64)
    ref = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    np.testing.assert_allclose(sim.numpy(), ref @ ref[:7].T, atol=1e-6)
    assert cosine_similarity(np.zeros((2, 3)), np.ones((1, 3)), device="cpu").abs().max() == 0  # the norm floor


def test_retrieval_runs_on_the_card_unless_the_cpu_is_named(monkeypatch):
    """Numpy input (what the extraction loop returns) goes to CUDA by default,
    and with no card that raises instead of computing on the CPU."""
    embs, labels = _retrieval_sets()["random"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: cosine_similarity(embs, embs), lambda: eval_retrieval(embs, labels),
                 lambda: eval_retrieval_cross_set(embs[:15], labels[:15], embs[15:], labels[15:])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_clustering_equals_jax():
    embs, labels = _retrieval_sets()["random"]
    assert eval_clustering(embs, labels) == jax_clustering.eval_clustering(embs, labels)
    assert eval_clustering(torch.from_numpy(embs), np.eye(4)[labels], n_clusters=3, seed=7) == \
        jax_clustering.eval_clustering(embs, np.eye(4)[labels], n_clusters=3, seed=7)
    assert eval_clustering_multi_k(embs, labels, [2, 5]) == jax_clustering.eval_clustering_multi_k(embs, labels, [2, 5])


def test_clustering_evaluator_in_a_trainer_run(tmp_path):
    """RunConfig.clustering_eval: scored every epoch on the validation loader,
    and, as in the JAX ``Trainer``, not before training even when
    ``run_before_training`` is set."""
    config = RunConfig(
        model_spec=ModelSpec(name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW_AUDIO,
                             device="cpu"),
        training_params=TrainingParams(train_epochs=2, lr=1e-3, batch_size=4),
        output_dir=str(tmp_path), device="cpu", seed=0,
        clustering_eval={"enabled": True, "frequency": 1, "max_samples": 100, "run_before_training": True},
    )
    model = avex_tpu_torch.build_model_from_spec(config.model_spec, num_classes=3)
    trainer = Trainer(model, config, _loader(n_batches=2, seed=5), _loader(n_batches=2, seed=6))
    result = trainer.train()
    assert [record["epoch"] for record in result["history"]] == [0, 1]
    for record in result["history"]:
        assert set(record["clustering"]) == {"ari", "nmi", "v_measure", "n_clusters"}
        assert record["clustering"]["n_clusters"] == 3.0 and np.isfinite(record["clustering"]["nmi"])
    assert isinstance(config.clustering_eval, ClusteringEvalConfig)
    with pytest.raises(ValueError, match="frequency"):
        ClusteringEvalConfig(frequency=0)
    with pytest.raises(ValueError, match="max_samples"):
        ClusteringEvalConfig(max_samples=10)


def test_trainer_runs_without_sklearn(tmp_path, monkeypatch, caplog):
    """Without scikit-learn the evaluator is disabled and logged, as the JAX
    Trainer disables it when it cannot be built."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "sklearn" else real(name, *a))
    config = RunConfig(
        model_spec=ModelSpec(name="beats", pretrained=False, init_config=BEATS_TINY, audio_config=RAW_AUDIO,
                             device="cpu"),
        training_params=TrainingParams(train_epochs=1, lr=1e-3, batch_size=4),
        output_dir=str(tmp_path), device="cpu", clustering_eval={"enabled": True, "frequency": 1},
    )
    model = avex_tpu_torch.build_model_from_spec(config.model_spec, num_classes=3)
    trainer = Trainer(model, config, _loader(n_batches=1), _loader(n_batches=1, seed=7))
    assert trainer.clustering_evaluator is None and "scikit-learn" in caplog.text
    assert "clustering" not in trainer.train()["history"][0]


def test_probe_config_from_yaml(tmp_path):
    from avex_tpu_torch.probes import load_probe_config

    path = tmp_path / "probe.yml"
    path.write_text("probe_type: mlp\nhidden_dims: [32, 16]\ntarget_layers: [3, last_layer]\n")
    config = load_probe_config(path)
    assert config.probe_type == "mlp" and config.hidden_dims == [32, 16] and config.target_layers == [3, "last_layer"]
