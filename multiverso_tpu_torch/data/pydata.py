"""The Python data backend: corpus build, Huffman codes, skip-gram and
CBOW example generation, LDA doc reading.

Copied from ``multiverso_tpu/data/pydata.py`` (numpy only). The default
backend is the native one (``data/native.py``), as in the reference; this
one stays for tests. Its RNG streams differ from the native backend's, as
pair generation is stochastic by contract.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional, Tuple

import numpy as np

from multiverso_tpu_torch.data.corpus_data import CorpusData


class PyData:
    def build_corpus(self, path: str, min_count: int = 5) -> CorpusData:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            tokens = f.read().split()
        freq = Counter(tokens)
        vocab = sorted(
            ((w, c) for w, c in freq.items() if c >= min_count),
            key=lambda kv: (-kv[1], kv[0]))
        word2id = {w: i for i, (w, _) in enumerate(vocab)}
        words = [w for w, _ in vocab]
        counts = np.asarray([c for _, c in vocab], np.int64)
        ids = np.asarray([word2id[t] for t in tokens if t in word2id],
                         np.int32)
        return CorpusData(words, counts, ids, len(tokens))

    def huffman(self, counts: np.ndarray, max_len: int = 64
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        counts = np.asarray(counts, np.int64)
        n = len(counts)
        codes = np.full((n, max_len), -1, np.int8)
        points = np.full((n, max_len), -1, np.int32)
        lengths = np.zeros(n, np.int32)
        if n < 1:
            raise ValueError("empty vocab")
        if n == 1:
            return codes, points, lengths
        # two-queue O(V) merge over ascending counts (same as native)
        count = np.empty(2 * n - 1, np.int64)
        count[:n] = counts[::-1]
        count[n:] = np.iinfo(np.int64).max
        parent = np.full(2 * n - 1, -1, np.int32)
        branch = np.zeros(2 * n - 1, np.int8)
        pos1, pos2 = 0, n
        for a in range(n - 1):
            picks = []
            for _ in range(2):
                if pos1 < n and (pos2 >= n + a or count[pos1] <= count[pos2]):
                    picks.append(pos1)
                    pos1 += 1
                else:
                    picks.append(pos2)
                    pos2 += 1
            m1, m2 = picks
            count[n + a] = count[m1] + count[m2]
            parent[m1] = parent[m2] = n + a
            branch[m2] = 1
        for w in range(n):
            leaf = n - 1 - w
            code_rev, point_rev = [], []
            node = leaf
            while parent[node] != -1:
                if len(code_rev) >= max_len:
                    raise ValueError(f"huffman code exceeded "
                                     f"max_len={max_len}")
                code_rev.append(branch[node])
                point_rev.append(parent[node] - n)
                node = parent[node]
            ln = len(code_rev)
            lengths[w] = ln
            codes[w, :ln] = code_rev[::-1]
            points[w, :ln] = point_rev[::-1]
        return codes, points, lengths

    def skipgram_pairs(self, ids: np.ndarray, window: int,
                       keep_prob: Optional[np.ndarray], seed: int,
                       cap: Optional[int] = None, threads: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray]:
        # `threads` accepted for backend-interface parity; the Python
        # fallback is GIL-bound, so it always generates single-threaded
        del threads
        rng = np.random.default_rng(seed)
        ids = np.asarray(ids, np.int32)
        if keep_prob is not None:
            kept = ids[rng.random(len(ids)) < keep_prob[ids]]
        else:
            kept = ids
        m = len(kept)
        if cap is None:
            cap = 2 * window * max(m, 1) + 16
        centers, contexts = [], []
        bs = rng.integers(1, window + 1, size=m)
        for i in range(m):
            b = bs[i]
            lo, hi = max(0, i - b), min(m, i + b + 1)
            for j in range(lo, hi):
                if j == i:
                    continue
                centers.append(kept[i])
                contexts.append(kept[j])
                if len(centers) >= cap:
                    break
            if len(centers) >= cap:
                break
        return (np.asarray(centers, np.int32),
                np.asarray(contexts, np.int32))

    def cbow_examples(self, ids: np.ndarray, window: int,
                      keep_prob: Optional[np.ndarray], seed: int,
                      cap: Optional[int] = None, threads: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
        del threads                       # see skipgram_pairs
        rng = np.random.default_rng(seed)
        ids = np.asarray(ids, np.int32)
        if keep_prob is not None:
            kept = ids[rng.random(len(ids)) < keep_prob[ids]]
        else:
            kept = ids
        m = len(kept)
        if cap is None:
            cap = m + 16
        width = 2 * window
        ctx_rows, targets = [], []
        bs = rng.integers(1, window + 1, size=m)
        for i in range(m):
            b = bs[i]
            row = [kept[j] for j in range(max(0, i - b), min(m, i + b + 1))
                   if j != i]
            if not row:
                continue
            row = row[:width] + [-1] * (width - min(len(row), width))
            ctx_rows.append(row)
            targets.append(kept[i])
            if len(targets) >= cap:
                break
        return (np.asarray(ctx_rows, np.int32).reshape(-1, width),
                np.asarray(targets, np.int32))

    def lda_read_docs(self, path: str
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        offsets = [0]
        word_ids: List[int] = []
        word_counts: List[int] = []
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:  # empty lines are not docs (native parity)
                    continue
                for tok in line.split():
                    if ":" not in tok:
                        continue
                    w, _, c = tok.partition(":")
                    try:
                        wi, ci = int(w), int(c)
                    except ValueError:
                        continue
                    if ci <= 0 or wi < 0:
                        continue
                    word_ids.append(wi)
                    word_counts.append(ci)
                offsets.append(len(word_ids))
        return (np.asarray(offsets, np.int64),
                np.asarray(word_ids, np.int32),
                np.asarray(word_counts, np.int32))
