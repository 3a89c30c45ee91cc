"""The port's native data backend against ``multiverso_tpu.data.native``.

Both packages build the same C++ source (the port its own copy, into
``build/torch_kernels/``); on the same numpy inputs every output must be
equal bit for bit: corpus build, Huffman codes, skip-gram and CBOW
streams at one and more threads (and the chunked single-thread oracle of
the multi-threaded fills), the small-cap fallback, the LDA doc reader,
and the ``Corpus`` batch streams with ``gen_threads``.
"""

import ctypes
from pathlib import Path

import numpy as np
import pytest

from multiverso_tpu.data import corpus as jcorpus
from multiverso_tpu.data import native as jnative
from multiverso_tpu_torch.data import (Corpus, NativeData, PyData, backend,
                                       default_gen_threads, synthetic_docs,
                                       synthetic_text)
from multiverso_tpu_torch.data import _native_build
from multiverso_tpu_torch.data import corpus as tcorpus
from multiverso_tpu_torch.data import native as tnative

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jnat():
    lib = jnative.load_native()
    assert lib is not None, "the reference's native library did not load"
    return lib


@pytest.fixture(scope="module")
def tnat():
    return tnative.load_native()


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    path = tmp_path_factory.mktemp("native") / "zipf.txt"
    synthetic_text(str(path), num_tokens=30_000, vocab_size=400, seed=6)
    return str(path)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# -- the library ---------------------------------------------------------------


def test_library_lives_under_build_torch_kernels(tnat):
    path = Path(tnat.path)
    assert path.parent == REPO / "build" / "torch_kernels"
    assert path.name.startswith("libmvtpu_data_") and path.exists()
    assert path == _native_build.library_path(_native_build.flags())
    # never the reference's build
    assert "native" not in path.parts
    # a CDLL (not a PyDLL): its calls release the GIL
    assert type(tnat._lib) is ctypes.CDLL
    assert backend() is tnat and isinstance(backend(), NativeData)
    assert tnative.ABI_VERSION == jnative.ABI_VERSION
    assert tnative.CHUNK_SEED_STEP == jnative.CHUNK_SEED_STEP


def test_source_is_the_reference_source():
    assert _native_build.SOURCE.read_bytes() == \
        (REPO / "native" / "mvtpu_data.cpp").read_bytes()


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(_native_build, "SOURCE", bad)
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        _native_build.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "out").glob("*.so"))
    # load_native raises too: no fallback to the Python backend
    monkeypatch.setattr(tnative, "_CACHED", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.load_native()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        Corpus.from_file(__file__)


def test_abi_mismatch_raises(tmp_path, monkeypatch):
    src = tmp_path / "old.cpp"
    src.write_text('extern "C" int mv_data_abi_version() { return 4; }\n')
    monkeypatch.setattr(_native_build, "SOURCE", src)
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(tnative, "_CACHED", None)
    with pytest.raises(RuntimeError, match="ABI 4, expected 5"):
        tnative.load_native()


def test_cached_build_is_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path)
    first = _native_build.build()
    assert _native_build.build_seconds > 0
    assert _native_build.build() == first
    assert _native_build.build_seconds == 0.0
    assert [p.name for p in tmp_path.iterdir()] == [first.name]


# -- corpus and Huffman ----------------------------------------------------------


@pytest.mark.parametrize("min_count", [1, 5])
def test_build_corpus_matches(jnat, tnat, text, min_count):
    j = jnat.build_corpus(text, min_count)
    t = tnat.build_corpus(text, min_count)
    assert t.words == j.words
    _equal((t.counts, t.ids), (j.counts, j.ids))
    assert t.total_raw_tokens == j.total_raw_tokens == 30_000


def test_build_corpus_missing_file_raises(jnat, tnat, tmp_path):
    for be in (jnat, tnat):
        with pytest.raises(FileNotFoundError):
            be.build_corpus(str(tmp_path / "nope.txt"))


@pytest.mark.parametrize("max_len", [24, 64])
def test_huffman_matches(jnat, tnat, text, max_len):
    counts = tnat.build_corpus(text, 1).counts
    _equal(tnat.huffman(counts, max_len), jnat.huffman(counts, max_len))
    # the Python backend builds the same codes
    _equal(tnat.huffman(counts, max_len), PyData().huffman(counts, max_len))


def test_huffman_max_len_overflow_raises(jnat, tnat, text):
    counts = tnat.build_corpus(text, 1).counts
    for be in (jnat, tnat):
        with pytest.raises(ValueError, match="max_len=6"):
            be.huffman(counts, 6)


# -- pair streams --------------------------------------------------------------


def _ids(n=20_003, vocab=60, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.mark.parametrize("fn", ["skipgram_pairs", "cbow_examples"])
@pytest.mark.parametrize("threads", [1, 3, 4])
@pytest.mark.parametrize("subsample", [False, True])
def test_example_streams_match(jnat, tnat, fn, threads, subsample):
    ids = _ids()
    kp = np.linspace(0.2, 1.0, 60).astype(np.float32) if subsample else None
    got = getattr(tnat, fn)(ids, 4, kp, seed=31, threads=threads)
    want = getattr(jnat, fn)(ids, 4, kp, seed=31, threads=threads)
    _equal(got, want)
    assert len(got[1]) > 1000


@pytest.mark.parametrize("fn,threads", [("skipgram_pairs", 3),
                                        ("cbow_examples", 4)])
def test_mt_equals_chunked_single_thread_oracle(tnat, fn, threads):
    ids = _ids(n=10_001, vocab=40, seed=2)
    kp = np.linspace(0.3, 1.0, 40).astype(np.float32)
    seed, n = 2**64 - 5, len(ids)       # the chunk seeds wrap around
    got = getattr(tnat, fn)(ids, 3, kp, seed=seed, threads=threads)
    parts = [getattr(tnat, fn)(
        ids[n * t // threads:n * (t + 1) // threads], 3, kp,
        seed=(seed + t * tnative.CHUNK_SEED_STEP) % 2**64)
        for t in range(threads)]
    _equal(got, [np.concatenate([p[i] for p in parts]) for i in (0, 1)])


@pytest.mark.parametrize("fn,worst", [("skipgram_pairs", 2 * 3 * 75 + 16),
                                      ("cbow_examples", 75 + 16)])
def test_small_cap_falls_back_with_one_warning(jnat, tnat, monkeypatch, fn,
                                               worst):
    """A cap under the 4-thread chunked worst case takes the
    single-thread stream (cut at cap), and says so once per entry
    point."""
    warned = []
    monkeypatch.setattr(tnative.log, "warn",
                        lambda fmt, *a: warned.append(fmt % a))
    monkeypatch.setattr(tnative, "_warned_cap_fallback", set())
    monkeypatch.setattr(jnative, "_warned_cap_fallback", set())
    ids = np.arange(300, dtype=np.int32) % 10
    cap = 4 * worst - 1
    for _ in range(2):
        got = getattr(tnat, fn)(ids, 3, None, seed=5, cap=cap, threads=4)
        _equal(got, getattr(jnat, fn)(ids, 3, None, seed=5, cap=cap,
                                      threads=4))
        _equal(got, getattr(tnat, fn)(ids, 3, None, seed=5, cap=cap))
    assert len(warned) == 1 and fn in warned[0] and "SINGLE" in warned[0]
    # a cap that holds every chunk runs chunked, with no warning
    getattr(tnat, fn)(ids, 3, None, seed=5, cap=4 * worst, threads=4)
    assert len(warned) == 1
    small = getattr(tnat, "skipgram_pairs")(ids, 3, None, seed=5, cap=50)
    assert len(small[0]) == 50


# -- LDA docs ---------------------------------------------------------------------


def test_lda_read_docs_matches(jnat, tnat, tmp_path):
    p = tmp_path / "docs.txt"
    synthetic_docs(str(p), num_docs=300, vocab_size=500, avg_doc_len=40,
                   seed=3)
    _equal(tnat.lda_read_docs(str(p)), jnat.lda_read_docs(str(p)))


def test_lda_read_docs_malformed_tokens(jnat, tnat, tmp_path):
    p = tmp_path / "docs.txt"
    p.write_text("0:2 garbage 3:x 4:1 -1:3 5:0 6:-2 7:\n\n \t \n"
                 ":4 8:1:2 9:3\n10:1")
    got = tnat.lda_read_docs(str(p))
    _equal(got, jnat.lda_read_docs(str(p)))
    assert list(got[1][:2]) == [0, 4]
    for be in (jnat, tnat):
        with pytest.raises(FileNotFoundError):
            be.lda_read_docs(str(tmp_path / "nope"))


def test_lightlda_reads_docs_natively(tmp_path, monkeypatch):
    from multiverso_tpu.apps import lightlda as jlda
    from multiverso_tpu_torch.apps import lightlda as tlda
    p = tmp_path / "docs.txt"
    synthetic_docs(str(p), num_docs=120, vocab_size=300, seed=4)
    calls = []
    real = tnative.NativeData.lda_read_docs

    def spy(self, path):
        calls.append(path)
        return real(self, path)

    monkeypatch.setattr(tnative.NativeData, "lda_read_docs", spy)
    got = tlda.load_docs(str(p))
    assert calls == [str(p)]
    want = jlda.load_docs(str(p))
    assert got[2] == want[2]
    _equal(got[:2], want[:2])


# -- generation threads ----------------------------------------------------------


@pytest.mark.parametrize("env,want", [(None, 1), ("3", 3), ("0", 1),
                                      ("-2", 1), ("many", 1)])
def test_default_gen_threads(monkeypatch, env, want):
    warned = []
    monkeypatch.setattr(tcorpus.log, "warn",
                        lambda fmt, *a: warned.append(fmt % a))
    if env is None:
        monkeypatch.delenv("MVTPU_GEN_THREADS", raising=False)
    else:
        monkeypatch.setenv("MVTPU_GEN_THREADS", env)
    assert default_gen_threads() == want == jcorpus.default_gen_threads()
    assert len(warned) == (env == "many")
    be = backend()
    assert Corpus._resolve_gen_threads(be, None) == want
    assert Corpus._resolve_gen_threads(be, 5) == 5
    assert Corpus._resolve_gen_threads(be, 0) == 1
    assert Corpus._resolve_gen_threads(PyData(), 5) == 1


def _corpora(text):
    j = jcorpus.Corpus.from_file(text, min_count=1, subsample=1e-3)
    t = Corpus.from_file(text, min_count=1, subsample=1e-3)
    return j, t


@pytest.mark.parametrize("gen_threads", [None, 1, 3])
def test_skipgram_batches_match(text, monkeypatch, gen_threads):
    monkeypatch.setenv("MVTPU_GEN_THREADS", "2")
    j, t = _corpora(text)
    kw = dict(window=4, seed=9, epochs=2, block_tokens=7_000,
              gen_threads=gen_threads)
    ja = list(j.skipgram_batches(128, **kw))
    ta = list(t.skipgram_batches(128, **kw))
    assert len(ta) == len(ja) > 100
    for a, b in zip(ta, ja):
        _equal(a, b)


@pytest.mark.parametrize("gen_threads", [1, 4])
def test_cbow_batches_match(text, gen_threads):
    j, t = _corpora(text)
    kw = dict(window=3, seed=4, epochs=1, block_tokens=5_000, pad_id=999,
              gen_threads=gen_threads)
    ja = list(j.cbow_batches(64, **kw))
    ta = list(t.cbow_batches(64, **kw))
    assert len(ta) == len(ja) > 100
    for a, b in zip(ta, ja):
        assert a[0].shape == (64, 6)
        _equal(a, b)


def test_threads_change_the_stream(text):
    """gen_threads scopes the stream: 1 and 3 threads give different
    (equally valid) pairs."""
    t = Corpus.from_file(text, min_count=1)
    one = np.concatenate([a for a, _ in t.skipgram_batches(
        128, window=4, seed=9, gen_threads=1)])
    three = np.concatenate([a for a, _ in t.skipgram_batches(
        128, window=4, seed=9, gen_threads=3)])
    assert not np.array_equal(one[:len(three)], three[:len(one)])
    assert abs(len(one) - len(three)) / len(one) < 0.05
