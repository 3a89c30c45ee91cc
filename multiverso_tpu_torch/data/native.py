"""ctypes binding to the native data library
(``data/csrc/mvtpu_data.cpp``).

Counterpart of ``multiverso_tpu/data/native.py``: the host-side data
pipeline (corpus build, Huffman codes, skip-gram / CBOW example
generation, LDA doc reading) in C++, so that the host outruns the card.
The ABI is flat C consumed through ``ctypes.CDLL``, whose calls release
the GIL: a prefetch thread generating pairs leaves the training thread
free, and the multi-threaded fills get real cores.

:func:`load_native` builds the library on first use
(:mod:`multiverso_tpu_torch.data._native_build`) and returns a
:class:`NativeData`. Unlike the reference, which logs a warning and falls
back to the Python backend, a failed build or an ABI mismatch raises: the
two backends draw different pair streams, so a quiet fallback would change
the training data.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from multiverso_tpu_torch.data import _native_build
from multiverso_tpu_torch.data.corpus_data import CorpusData
from multiverso_tpu_torch.utils import log

ABI_VERSION = 5

# Per-chunk seed step of the multi-threaded generators (mirrors
# chunk_seed() in csrc/mvtpu_data.cpp): chunk t of a threads=T call is
# bit-identical to the single-thread call on that chunk with seed
# ``(seed + t * CHUNK_SEED_STEP) % 2**64`` — the oracle the parity tests
# use.
CHUNK_SEED_STEP = 0x9E3779B97F4A7C15

_warned_cap_fallback = set()


def _warn_mt_cap_fallback(fn: str, n: int, threads: int, cap: int,
                          chunk_worst) -> None:
    """Surface the silent C-side mt→single-thread fallback: the native
    multi-threaded fill runs chunked only when ``cap`` holds every
    chunk's worst case (``chunk_worst(chunk_len)`` summed over the
    C's contiguous split, mirrored here) — otherwise it silently takes
    the single-thread path, which changes the (seed, threads)-scoped
    pair stream the caller asked for. Logged once per entry point."""
    if threads <= 1 or n <= 0 or fn in _warned_cap_fallback:
        return
    t_eff = min(threads, n)
    if t_eff <= 1:
        return
    need = sum(chunk_worst(n * (t + 1) // t_eff - n * t // t_eff)
               for t in range(t_eff))
    if cap < need:
        _warned_cap_fallback.add(fn)
        log.warn("%s: cap=%d < %d (the %d-thread chunked worst case) — "
                 "native generation falls back to the SINGLE-thread "
                 "stream; raise cap or drop gen_threads to 1 to make "
                 "the stream scope explicit", fn, cap, need, t_eff)


class NativeData:
    def __init__(self, lib: ctypes.CDLL, path: str = "") -> None:
        self._lib = lib
        #: the shared library's path (under build/torch_kernels/)
        self.path = path
        lib.mv_corpus_build.restype = ctypes.c_uint64
        lib.mv_corpus_build.argtypes = [ctypes.c_char_p, ctypes.c_int32]
        lib.mv_corpus_vocab_size.restype = ctypes.c_int32
        lib.mv_corpus_vocab_size.argtypes = [ctypes.c_uint64]
        lib.mv_corpus_num_tokens.restype = ctypes.c_int64
        lib.mv_corpus_num_tokens.argtypes = [ctypes.c_uint64]
        lib.mv_corpus_total_raw_tokens.restype = ctypes.c_int64
        lib.mv_corpus_total_raw_tokens.argtypes = [ctypes.c_uint64]
        lib.mv_corpus_counts.restype = ctypes.c_int32
        lib.mv_corpus_counts.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int32]
        lib.mv_corpus_ids.restype = ctypes.c_int64
        lib.mv_corpus_ids.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
        lib.mv_corpus_word.restype = ctypes.c_char_p
        lib.mv_corpus_word.argtypes = [ctypes.c_uint64, ctypes.c_int32]
        lib.mv_corpus_free.restype = None
        lib.mv_corpus_free.argtypes = [ctypes.c_uint64]
        lib.mv_huffman_build.restype = ctypes.c_int32
        lib.mv_huffman_build.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib.mv_skipgram_pairs.restype = ctypes.c_int64
        lib.mv_skipgram_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64]
        lib.mv_cbow_examples.restype = ctypes.c_int64
        lib.mv_cbow_examples.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64]
        lib.mv_skipgram_pairs_mt.restype = ctypes.c_int64
        lib.mv_skipgram_pairs_mt.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64]
        lib.mv_cbow_examples_mt.restype = ctypes.c_int64
        lib.mv_cbow_examples_mt.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64]
        lib.mv_lda_read_docs.restype = ctypes.c_int64
        lib.mv_lda_read_docs.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64]

    # -- corpus ------------------------------------------------------------

    def build_corpus(self, path: str, min_count: int = 5) -> CorpusData:
        handle = self._lib.mv_corpus_build(path.encode(), min_count)
        if handle == 0:
            raise FileNotFoundError(f"cannot read corpus file {path!r}")
        try:
            vocab = self._lib.mv_corpus_vocab_size(handle)
            ntok = self._lib.mv_corpus_num_tokens(handle)
            counts = np.empty(vocab, np.int64)
            ids = np.empty(ntok, np.int32)
            if vocab and self._lib.mv_corpus_counts(
                    handle, counts.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int64)), vocab) < 0:
                raise RuntimeError("mv_corpus_counts failed")
            if ntok and self._lib.mv_corpus_ids(
                    handle, ids.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)), ntok) < 0:
                raise RuntimeError("mv_corpus_ids failed")
            words = [self._lib.mv_corpus_word(handle, i).decode()
                     for i in range(vocab)]
            raw = self._lib.mv_corpus_total_raw_tokens(handle)
        finally:
            self._lib.mv_corpus_free(handle)
        return CorpusData(words, counts, ids, raw)

    # -- huffman -----------------------------------------------------------

    def huffman(self, counts: np.ndarray, max_len: int = 64
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        counts = np.ascontiguousarray(counts, np.int64)
        vocab = len(counts)
        codes = np.empty((vocab, max_len), np.int8)
        points = np.empty((vocab, max_len), np.int32)
        lengths = np.empty(vocab, np.int32)
        used = self._lib.mv_huffman_build(
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), vocab,
            max_len, codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            points.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if used < 0:
            raise ValueError(f"huffman code exceeded max_len={max_len}")
        return codes, points, lengths

    # -- training examples -------------------------------------------------

    def skipgram_pairs(self, ids: np.ndarray, window: int,
                       keep_prob: Optional[np.ndarray], seed: int,
                       cap: Optional[int] = None, threads: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """``threads > 1`` uses the native multi-threaded fill (chunked
        generation, the reference word2vec's worker-partitioning shape);
        the ctypes call releases the GIL so the workers get real cores.
        With threads > 1 the default cap grows by the per-chunk slack
        the mt path needs to run chunked instead of falling back."""
        ids = np.ascontiguousarray(ids, np.int32)
        if cap is None:
            cap = 2 * window * len(ids) + 16 * max(threads, 1)
        else:
            _warn_mt_cap_fallback("skipgram_pairs", len(ids), threads,
                                  cap, lambda ln: 2 * window * ln + 16)
        centers = np.empty(cap, np.int32)
        contexts = np.empty(cap, np.int32)
        kp = None
        if keep_prob is not None:
            keep_prob = np.ascontiguousarray(keep_prob, np.float32)
            kp = keep_prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        ids_p = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        c_p = centers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        x_p = contexts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        if threads > 1:
            n = self._lib.mv_skipgram_pairs_mt(
                ids_p, len(ids), window, kp, seed, threads, c_p, x_p, cap)
        else:
            n = self._lib.mv_skipgram_pairs(
                ids_p, len(ids), window, kp, seed, c_p, x_p, cap)
        return centers[:n].copy(), contexts[:n].copy()

    def cbow_examples(self, ids: np.ndarray, window: int,
                      keep_prob: Optional[np.ndarray], seed: int,
                      cap: Optional[int] = None, threads: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.ascontiguousarray(ids, np.int32)
        if cap is None:
            cap = len(ids) + 16 * max(threads, 1)
        else:
            _warn_mt_cap_fallback("cbow_examples", len(ids), threads,
                                  cap, lambda ln: ln + 16)
        width = 2 * window
        contexts = np.empty((cap, width), np.int32)
        targets = np.empty(cap, np.int32)
        kp = None
        if keep_prob is not None:
            keep_prob = np.ascontiguousarray(keep_prob, np.float32)
            kp = keep_prob.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        ids_p = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        ctx_p = contexts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        tgt_p = targets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        if threads > 1:
            n = self._lib.mv_cbow_examples_mt(
                ids_p, len(ids), window, kp, seed, threads, ctx_p, tgt_p,
                cap)
        else:
            n = self._lib.mv_cbow_examples(
                ids_p, len(ids), window, kp, seed, ctx_p, tgt_p, cap)
        return contexts[:n].copy(), targets[:n].copy()

    # -- LDA ---------------------------------------------------------------

    def lda_read_docs(self, path: str
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns CSR (doc_offsets[int64 D+1], word_ids, word_counts)."""
        ndocs = ctypes.c_int64()
        nnz = ctypes.c_int64()
        rc = self._lib.mv_lda_read_docs(
            path.encode(), ctypes.byref(ndocs), ctypes.byref(nnz),
            None, None, None, 0, 0)
        if rc != 0:
            raise FileNotFoundError(f"cannot read docs file {path!r}")
        offsets = np.empty(ndocs.value + 1, np.int64)
        word_ids = np.empty(max(nnz.value, 1), np.int32)
        word_counts = np.empty(max(nnz.value, 1), np.int32)
        rc = self._lib.mv_lda_read_docs(
            path.encode(), ctypes.byref(ndocs), ctypes.byref(nnz),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            word_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            word_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ndocs.value, max(nnz.value, 1))
        if rc != 0:
            raise RuntimeError(f"lda_read_docs second pass failed: {path!r}")
        return offsets, word_ids[:nnz.value], word_counts[:nnz.value]


_LOCK = threading.Lock()
_CACHED: Optional[NativeData] = None


def load_native() -> NativeData:
    """The native backend, its library built on first call; raises
    ``RuntimeError`` when the build fails or the library's ABI is not
    :data:`ABI_VERSION`."""
    global _CACHED
    with _LOCK:
        if _CACHED is None:
            path = _native_build.build()
            lib = ctypes.CDLL(str(path))
            lib.mv_data_abi_version.restype = ctypes.c_int32
            version = lib.mv_data_abi_version()
            if version != ABI_VERSION:
                raise RuntimeError(f"native data library {path} has ABI "
                                   f"{version}, expected {ABI_VERSION}")
            _CACHED = NativeData(lib, str(path))
        return _CACHED
