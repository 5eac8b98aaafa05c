"""The port's fusion-weighted data layer (``repro_torch.data.fusion_weights``)
against the JAX package's ``repro.data.fusion_weights``.

Both packages hash document spans with Python's ``hash``, salted per
process, so within this process the claims equal the JAX package's exactly.
``fusion_weights`` (the ``hybrid`` detector in both) gives equal rounds,
equal copying decisions and equal document weights, and source weights
within rtol 2e-5 / atol 1e-4 (ROADMAP C3–C4). The port's twin of the JAX
package's quality test, the train CLI's ``--fusion-weighted`` run (in
``test_torch_train.py``) and the example twin at a tiny size follow; the
``gpu`` case holds the card against the CPU.
"""
import torch_threads  # noqa: F401  (caps torch's threads a worker)
import numpy as np
import pytest
import torch

from repro.core.types import CopyConfig as JConfig
from repro.data.fusion_weights import corpus_to_claims as jax_corpus_to_claims
from repro.data.fusion_weights import fusion_weights as jax_fusion_weights
from repro.data.tokens import synthetic_corpus as jax_synthetic_corpus
from repro_torch.core.types import CopyConfig
from repro_torch.data.fusion_weights import corpus_to_claims, fusion_weights
from repro_torch.data.tokens import synthetic_corpus
from repro_torch.examples import fusion_weighted_training

RTOL, ATOL = 2e-5, 1e-4          # ROADMAP C4
CORPORA = {
    "copiers-4": dict(n_sources=12, docs_per_source=10, doc_len=96,
                      n_copiers=4, seed=0),
    "copiers-5": dict(n_sources=16, docs_per_source=12, doc_len=96,
                      n_copiers=5, seed=1),
}


def _corpora(name):
    kw = CORPORA[name]
    t, j = synthetic_corpus(**kw), jax_synthetic_corpus(**kw)
    assert all(np.array_equal(a, b) for a, b in zip(t.docs, j.docs))
    return t, j


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_corpus_to_claims_equals_jax(name):
    t, j = _corpora(name)
    got, want = corpus_to_claims(t), jax_corpus_to_claims(j)
    assert got.values.dtype == want.values.dtype == np.int32
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.accuracy, want.accuracy)
    # copier pairs share many items
    prov = got.provided_mask.astype(int)
    shared = prov @ prov.T
    assert all(shared[c, o] >= 5 for c, o in t.copy_edges)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_fusion_weights_equal_jax(name):
    t, j = _corpora(name)
    src_w, doc_w, res = fusion_weights(t, CopyConfig(alpha=0.1, s=0.8,
                                                     n=100.0), device="cpu")
    j_src, j_doc, j_res = jax_fusion_weights(j, JConfig(alpha=0.1, s=0.8,
                                                        n=100.0))
    assert res.rounds == j_res.rounds
    np.testing.assert_array_equal(res.detection.copying, j_res.detection.copying)
    np.testing.assert_array_equal(doc_w, j_doc)
    assert src_w.dtype == j_src.dtype == np.float64
    np.testing.assert_allclose(src_w, j_src, RTOL, ATOL)


def test_fusion_weights_find_copiers_and_quality():
    corpus = synthetic_corpus(**CORPORA["copiers-5"])
    src_w, doc_w, fus = fusion_weights(corpus, CopyConfig(alpha=0.1, s=0.8,
                                                          n=100.0),
                                       device="cpu")
    planted = {(min(a, b), max(a, b)) for a, b in corpus.copy_edges}
    recall = len(fus.detection.copying_pairs() & planted) / len(planted)
    assert recall >= 0.8, recall
    assert doc_w.min() < 1.0 and np.isclose(doc_w.max(), 1.0)
    assert np.corrcoef(src_w, corpus.source_accuracy)[0, 1] > 0.3


def test_fusion_weighted_training_example_runs_on_cpu(capsys):
    losses = fusion_weighted_training.main([
        "--device", "cpu", "--steps", "2", "--layers", "1", "--batch", "2",
        "--seq", "32"])
    assert set(losses) == {"uniform", "weighted"}
    assert all(np.isfinite(v) for v in losses.values())
    out = capsys.readouterr().out
    assert "planted recall" in out and "clean eval loss" in out


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


@pytest.mark.gpu
def test_fusion_weights_on_card_equals_cpu(cuda_device):
    corpus = synthetic_corpus(**CORPORA["copiers-5"])
    src_c, doc_c, res_c = fusion_weights(corpus, device=cuda_device)
    src, doc, res = fusion_weights(corpus, device="cpu")
    np.testing.assert_array_equal(doc_c, doc)
    np.testing.assert_allclose(src_c, src, RTOL, ATOL)
    np.testing.assert_array_equal(res_c.detection.copying,
                                  res.detection.copying)
