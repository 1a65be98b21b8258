"""The BirdNet host adapter of the PyTorch port against the JAX package's.

No TFLite graph is needed: a fake backend (the interface of
``TFLiteBackend``: ``input_samples``, ``num_classes``, ``predict``,
``embed``) drives both adapters, so the windowing (``_chunk``: padding, the
half-window rule for a trailing chunk), the score max over windows and the
embedding aggregations are held to JAX's. Then the missing-backend error,
through the constructor and the factory.
"""

import numpy as np
import pytest

from avex_tpu.models.birdnet import Model as JaxBirdNet

import avex_tpu_torch
from avex_tpu_torch.configs import ModelSpec
from avex_tpu_torch.models import birdnet
from tests.test_torch_threads import one_intra_op_thread  # noqa: F401  (autouse: one intra-op thread a worker)

WINDOW, CLASSES, DIM = 1200, 5, 16


class FakeBackend:
    """A deterministic stand-in for a TFLite graph: scores and embeddings
    are fixed random projections of the window."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.w_scores = rng.standard_normal((WINDOW, CLASSES)).astype(np.float32)
        self.w_embed = rng.standard_normal((WINDOW, DIM)).astype(np.float32)
        self.input_samples, self.num_classes = WINDOW, CLASSES

    def predict(self, clip):
        return np.asarray(clip, np.float32) @ self.w_scores

    def embed(self, clip):
        return np.asarray(clip, np.float32) @ self.w_embed


def _pair():
    jax_model, port = JaxBirdNet.__new__(JaxBirdNet), birdnet.Model.__new__(birdnet.Model)
    for model in (jax_model, port):
        model._backend = FakeBackend()
    return jax_model, port


@pytest.mark.parametrize("samples", [WINDOW // 2, WINDOW, 2 * WINDOW, 2 * WINDOW + WINDOW // 3,
                                     2 * WINDOW + 2 * WINDOW // 3, 3 * WINDOW - 1])
def test_chunk_matches_jax(rng, samples):
    """Short clips pad to one window; a trailing chunk of at least half a
    window is padded and kept, a shorter one dropped."""
    jax_model, port = _pair()
    clip = rng.standard_normal(samples).astype(np.float32)
    want, got = jax_model._chunk(clip), port._chunk(clip)
    assert got.shape == want.shape and got.shape[1] == WINDOW
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("aggregation", ["mean", "max", "none", "cls_token"])
def test_scores_and_embeddings_match_jax(rng, aggregation):
    jax_model, port = _pair()
    wav = rng.standard_normal((2, 2 * WINDOW + 2 * WINDOW // 3)).astype(np.float32)  # 3 windows
    np.testing.assert_array_equal(port(wav), jax_model(wav))
    assert port(wav[0]).shape == (1, CLASSES)
    got = port.extract_embeddings({"raw_wav": wav}, aggregation=aggregation)
    want = jax_model.extract_embeddings({"raw_wav": wav}, aggregation=aggregation)
    assert got.shape == ((2, 3, DIM) if aggregation == "none" else (2, DIM))
    np.testing.assert_array_equal(got, want)


def test_missing_backend_raises_clearly(tmp_path):
    """Without a model path and without birdnetlib the adapter names both;
    the factory resolves ``birdnet`` and raises the same, on a machine with
    or without a card (the adapter runs on the host)."""
    with pytest.raises(ImportError, match="birdnetlib"):
        birdnet.Model()
    with pytest.raises(ImportError, match="birdnetlib"):
        avex_tpu_torch.build_model_from_spec(ModelSpec(name="birdnet", pretrained=False))
    assert avex_tpu_torch.get_model_class("birdnet") is birdnet.Model
    labels = tmp_path / "labels.txt"
    labels.write_text("Turdus merula_Eurasian Blackbird\n\nParus major_Great Tit\n")
    assert birdnet.load_species_list(str(labels)) == ["Turdus merula_Eurasian Blackbird", "Parus major_Great Tit"]
    assert birdnet.load_species_list(None) == []
