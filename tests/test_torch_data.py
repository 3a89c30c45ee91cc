"""The port's data layer against ``multiverso_tpu.data`` (Python backend).

For a fixed corpus and seed both packages must give identical vocab,
counts, encoded ids, Huffman arrays and skip-gram / CBOW streams: the
data layer is integer work, so the comparison is exact.
"""

import numpy as np
import pytest

from multiverso_tpu.data import corpus as jcorpus
from multiverso_tpu.data.pydata import PyData as JPyData
from multiverso_tpu_torch.data import Corpus, PyData, synthetic_text


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "zipf.txt"
    synthetic_text(str(path), num_tokens=6_000, vocab_size=300, seed=5)
    return str(path)


def test_synthetic_text_matches(text, tmp_path):
    ref = tmp_path / "ref.txt"
    jcorpus.synthetic_text(str(ref), num_tokens=6_000, vocab_size=300,
                           seed=5)
    with open(text) as a, open(ref) as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("min_count", [1, 3])
def test_build_corpus_matches(text, min_count):
    j = JPyData().build_corpus(text, min_count)
    t = PyData().build_corpus(text, min_count)
    assert t.words == j.words
    np.testing.assert_array_equal(t.counts, j.counts)
    np.testing.assert_array_equal(t.ids, j.ids)
    assert t.total_raw_tokens == j.total_raw_tokens


@pytest.mark.parametrize("max_len", [20, 40])
def test_huffman_matches(text, max_len):
    counts = PyData().build_corpus(text, 1).counts
    for a, b in zip(PyData().huffman(counts, max_len),
                    JPyData().huffman(counts, max_len)):
        np.testing.assert_array_equal(a, b)


def test_huffman_too_deep_raises_in_both(text):
    counts = PyData().build_corpus(text, 1).counts
    for backend in (PyData(), JPyData()):
        with pytest.raises(ValueError, match="max_len=8"):
            backend.huffman(counts, 8)


def _corpora(text, monkeypatch):
    """The same corpus in both packages; the JAX one pinned to its Python
    backend (its native backend is another generator)."""
    monkeypatch.setattr(jcorpus, "backend", lambda: JPyData())
    j = jcorpus.Corpus.from_file(text, min_count=1, subsample=1e-3)
    t = Corpus.from_file(text, min_count=1, subsample=1e-3)
    return j, t


def test_corpus_accessors_match(text, monkeypatch):
    j, t = _corpora(text, monkeypatch)
    assert (t.vocab_size, t.num_tokens) == (j.vocab_size, j.num_tokens)
    np.testing.assert_array_equal(t.keep_prob(), j.keep_prob())
    np.testing.assert_array_equal(t.unigram_probs(0.75),
                                  j.unigram_probs(0.75))
    t.set_subsample(0)
    assert t.keep_prob() is None


@pytest.mark.parametrize("window", [2, 5])
def test_skipgram_stream_matches(text, monkeypatch, window):
    j, t = _corpora(text, monkeypatch)
    kw = dict(window=window, seed=9, epochs=2, block_tokens=2_048)
    ja = list(j.skipgram_batches(64, **kw))
    ta = list(t.skipgram_batches(64, **kw))
    assert len(ta) == len(ja) > 10
    for (a0, a1), (b0, b1) in zip(ta, ja):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)


def test_cbow_stream_matches(text, monkeypatch):
    j, t = _corpora(text, monkeypatch)
    kw = dict(window=3, seed=4, epochs=1, block_tokens=2_048, pad_id=999)
    ja = list(j.cbow_batches(32, **kw))
    ta = list(t.cbow_batches(32, **kw))
    assert len(ta) == len(ja) > 10
    for (a0, a1), (b0, b1) in zip(ta, ja):
        assert a0.shape == (32, 6)
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)


def test_pair_generators_match(text):
    data = PyData().build_corpus(text, 1)
    kp = np.full(len(data.words), 0.8, np.float32)
    for fn in ("skipgram_pairs", "cbow_examples"):
        a = getattr(PyData(), fn)(data.ids[:500], 4, kp, seed=3)
        b = getattr(JPyData(), fn)(data.ids[:500], 4, kp, seed=3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
