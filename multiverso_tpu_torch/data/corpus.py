"""Corpus-level helpers: vocabulary, subsampling, negative-sampling
distribution, Huffman codes, and batch iterators.

Counterpart of ``multiverso_tpu/data/corpus.py`` on the Python backend
(:class:`~multiverso_tpu_torch.data.pydata.PyData`); the reference's
native C++ backend is not ported yet. Host-only (numpy).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.data.corpus_data import CorpusData
from multiverso_tpu_torch.data.pydata import PyData
from multiverso_tpu_torch.utils.async_buffer import prefetch_iterator


def backend() -> PyData:
    """The data backend (the Python one in this port)."""
    return PyData()


class Corpus:
    """An encoded corpus + vocab with word2vec-style accessors."""

    def __init__(self, data: CorpusData, subsample: float = 1e-3) -> None:
        self.data = data
        self.subsample = subsample
        self._keep_prob: Optional[np.ndarray] = None
        self._unigram: Optional[Tuple[float, np.ndarray]] = None

    def set_subsample(self, subsample: float) -> None:
        """Change the subsampling threshold (drops the keep-prob cache)."""
        self.subsample = subsample
        self._keep_prob = None

    @classmethod
    def from_file(cls, path: str, min_count: int = 5,
                  subsample: float = 1e-3) -> "Corpus":
        return cls(backend().build_corpus(path, min_count),
                   subsample=subsample)

    @property
    def vocab_size(self) -> int:
        return len(self.data.words)

    @property
    def num_tokens(self) -> int:
        return len(self.data.ids)

    @property
    def words(self):
        return self.data.words

    @property
    def counts(self) -> np.ndarray:
        return self.data.counts

    @property
    def ids(self) -> np.ndarray:
        return self.data.ids

    def keep_prob(self) -> Optional[np.ndarray]:
        """word2vec subsampling keep-probability per word id:
        ``min(1, sqrt(t/f) + t/f)`` with f the corpus frequency fraction."""
        if self.subsample <= 0:
            return None
        if self._keep_prob is None:
            total = max(self.counts.sum(), 1)
            f = self.counts / total
            with np.errstate(divide="ignore"):
                kp = np.sqrt(self.subsample / f) + self.subsample / f
            self._keep_prob = np.minimum(kp, 1.0).astype(np.float32)
        return self._keep_prob

    def unigram_probs(self, power: float = 0.75) -> np.ndarray:
        """Negative-sampling distribution ∝ count^0.75 (word2vec)."""
        if self._unigram is None or self._unigram[0] != power:
            p = self.counts.astype(np.float64) ** power
            self._unigram = (power, (p / p.sum()).astype(np.float32))
        return self._unigram[1]

    def huffman(self, max_len: int = 64):
        """(codes int8 [V, L], points int32 [V, L], lengths int32 [V])."""
        return backend().huffman(self.counts, max_len)

    # -- batch iterators ---------------------------------------------------

    def _block_batches(self, example_fn, batch_size: int, epochs: int,
                       block_tokens: int, prefetch: int
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Cut the corpus into blocks (the reference's DataBlock), run
        ``example_fn(block, seed)`` per block on a prefetch thread, carry
        leftovers across blocks and yield fixed-size batch pairs."""

        def gen():
            left_a = left_b = None
            for epoch in range(epochs):
                for start in range(0, self.num_tokens, block_tokens):
                    block = self.ids[start:start + block_tokens]
                    a, b = example_fn(
                        block, 0x9E3779B9 * (epoch + 1) + start)
                    if left_a is not None:
                        a = np.concatenate([left_a, a])
                        b = np.concatenate([left_b, b])
                    n_full = (len(b) // batch_size) * batch_size
                    for i in range(0, n_full, batch_size):
                        yield a[i:i + batch_size], b[i:i + batch_size]
                    left_a, left_b = a[n_full:], b[n_full:]

        return prefetch_iterator(gen(), depth=prefetch)

    def skipgram_batches(self, batch_size: int, window: int = 5,
                         seed: int = 1, epochs: int = 1,
                         block_tokens: int = 1 << 20,
                         prefetch: int = 2
                         ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield fixed-size (centers, contexts) int32 batches."""
        be = backend()
        kp = self.keep_prob()

        def examples(block, salt):
            return be.skipgram_pairs(block, window, kp, seed=seed + salt)

        return self._block_batches(examples, batch_size, epochs,
                                   block_tokens, prefetch)

    def cbow_batches(self, batch_size: int, window: int = 5,
                     seed: int = 1, epochs: int = 1,
                     block_tokens: int = 1 << 20, prefetch: int = 2,
                     pad_id: Optional[int] = None
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield fixed-size (contexts [B, 2w], targets [B]) int32 batches.

        Context rows are padded to 2*window with ``pad_id`` (a scratch-row
        id keeps every gather in range); ``pad_id=None`` keeps the raw -1
        sentinels for numpy consumers that mask explicitly."""
        be = backend()
        kp = self.keep_prob()

        def examples(block, salt):
            ctx, tgt = be.cbow_examples(block, window, kp, seed=seed + salt)
            if pad_id is not None:
                ctx = np.where(ctx < 0, pad_id, ctx)
            return ctx, tgt

        return self._block_batches(examples, batch_size, epochs,
                                   block_tokens, prefetch)


def synthetic_text(path: str, num_tokens: int = 200_000,
                   vocab_size: int = 2_000, seed: int = 0,
                   zipf_a: float = 1.2) -> None:
    """Write a synthetic Zipf-distributed corpus (the no-network stand-in
    for text8: training throughput depends on shapes, not on the tokens
    being English)."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf_a, size=num_tokens)
    ranks = np.clip(ranks, 1, vocab_size)
    with open(path, "w") as f:
        line = []
        for r in ranks:
            line.append(f"w{r}")
            if len(line) == 1000:
                f.write(" ".join(line) + "\n")
                line = []
        if line:
            f.write(" ".join(line) + "\n")
