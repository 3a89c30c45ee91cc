"""word2vec on the port's tables: skip-gram and CBOW, negative sampling
(unigram-table or alias sampler) and hierarchical softmax, embeddings in
two MatrixTables.

Counterpart of ``multiverso_tpu/apps/word_embedding.py``. One superstep
call trains S minibatches of B pairs; each step gathers rows with the
row gather kernel, computes the analytic sigmoid gradients with dense
torch ops, and adds the row deltas with the duplicate-safe scatter-add
kernel (duplicate rows within a minibatch accumulate, the reference's
Aggregator semantics). The reference's ``lax.scan`` over the S steps is a
Python loop; its ``jax.random`` negatives are draws from a
``torch.Generator`` on the device, seeded per call from (seed, call
number). The superstep also takes the negatives as an input, so a caller
can feed both packages the same ones.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiverso_tpu_torch import core
from multiverso_tpu_torch.data.corpus import Corpus
from multiverso_tpu_torch.tables import MatrixTable, make_superstep
from multiverso_tpu_torch.tables.superstep import gather_rows, row_scatter_add
from multiverso_tpu_torch.utils import log
from multiverso_tpu_torch.utils.async_buffer import prefetch_iterator


@dataclasses.dataclass
class W2VConfig:
    """The reference app's argv config (word2vec-style flags)."""
    embedding_dim: int = 100
    window: int = 5
    negative: int = 5           # negatives per positive (NS objective)
    model: str = "skipgram"     # "skipgram" | "cbow"
    objective: str = "ns"       # "ns" (negative sampling) | "hs" (Huffman)
    batch_size: int = 1024      # pairs per step
    steps_per_call: int = 16    # steps per superstep: pairs/call = B * S
    learning_rate: float = 0.025
    min_lr_frac: float = 1e-4   # linear decay floor (lr * frac)
    epochs: int = 1
    subsample: Optional[float] = None   # None -> keep the corpus's setting
    unigram_power: float = 0.75
    ns_sampler: str = "table"   # "table": the reference word2vec's unigram
    # table (one uniform + one gather per draw) | "alias": exact Vose alias
    ns_table_size: int = 1 << 20    # unigram-table slots
    max_code_len: int = 40      # HS: Huffman code pad length
    checkpoint_prefix: str = ""     # periodic mid-train checkpoints
    checkpoint_interval: int = 0    # store every N superstep calls
    seed: int = 0
    dtype: str = "float32"


def _normalized_rows(emb: np.ndarray) -> np.ndarray:
    """Rows scaled to unit norm (zero rows guarded)."""
    return emb / np.maximum(
        np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)


def _topk_excluding(norm: np.ndarray, q: np.ndarray,
                    exclude, k: int) -> np.ndarray:
    """Top-k row ids of ``norm`` by dot with ``q``, excluding ids."""
    sims = norm @ q
    sims[list(exclude)] = -np.inf
    return np.argsort(-sims)[:k]


def build_alias(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vose alias-table construction, O(V).

    Returns (prob f32[V], alias int32[V]): sample j ~ U[0,V), u ~ U[0,1);
    result = j if u < prob[j] else alias[j].
    """
    v = len(probs)
    prob = np.zeros(v, np.float64)
    alias = np.zeros(v, np.int32)
    scaled = probs.astype(np.float64) * v
    small = [i for i in range(v) if scaled[i] < 1.0]
    large = [i for i in range(v) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias


def build_unigram_table(probs: np.ndarray, size: int) -> np.ndarray:
    """The reference word2vec's ``InitUnigramTable``: an int32[size] table
    where word w fills a run of slots proportional to probs[w]."""
    cum = np.cumsum(probs.astype(np.float64))
    cum /= cum[-1]
    return np.searchsorted(
        cum, (np.arange(size) + 0.5) / size).astype(np.int32)


def table_sample(gen: torch.Generator, table: torch.Tensor,
                 shape) -> torch.Tensor:
    """Draw ids from the unigram table: uniform -> slot -> id."""
    u = torch.rand(shape, generator=gen, device=table.device)
    idx = (u * table.shape[0]).long().clamp_max(table.shape[0] - 1)
    return table[idx]


def alias_sample(gen: torch.Generator, prob: torch.Tensor,
                 alias: torch.Tensor, shape) -> torch.Tensor:
    """Draw ids from the alias table (two gathers)."""
    j = torch.randint(0, prob.shape[0], shape, generator=gen,
                      device=prob.device)
    u = torch.rand(shape, generator=gen, device=prob.device)
    return torch.where(u < prob[j], j, alias[j].long()).to(torch.int32)


class WordEmbedding:
    """The app: two MatrixTables + the superstep."""

    META_MAGIC = "mvtpu.w2v.meta.v1"

    def __init__(self, corpus: Corpus, config: W2VConfig, *,
                 device: core.DeviceLike = None, name: str = "w2v") -> None:
        self.corpus = corpus
        self.config = config
        self.device = dev = core.resolve(device)
        c = config
        if c.subsample is not None:
            corpus.set_subsample(c.subsample)
        v, d = corpus.vocab_size, c.embedding_dim
        rng = np.random.default_rng(c.seed)
        # reference init: input embeddings ~ U(-0.5/dim, 0.5/dim), output 0
        w_in_init = rng.uniform(-0.5 / d, 0.5 / d, (v, d)).astype(c.dtype)
        self.w_in = MatrixTable(v, d, c.dtype, init_value=w_in_init,
                                updater="default", device=dev,
                                name=f"{name}_in")
        self.w_out = MatrixTable(v, d, c.dtype, init_value=0,
                                 updater="default", device=dev,
                                 name=f"{name}_out")
        self._scratch = self.w_in.padded_shape[0] - 1  # masked-lane row
        if c.objective == "ns":
            if c.ns_sampler == "table":
                self._ns_table = core.place(build_unigram_table(
                    corpus.unigram_probs(c.unigram_power),
                    c.ns_table_size), device=dev)
            elif c.ns_sampler == "alias":
                p, a = build_alias(corpus.unigram_probs(c.unigram_power))
                self._alias_prob = core.place(p, device=dev)
                self._alias_idx = core.place(a, device=dev)
            else:
                raise ValueError(f"ns_sampler must be 'table' or "
                                 f"'alias', got {c.ns_sampler!r}")
            # per-lane labels of [target, negatives...]
            k1 = c.negative + 1
            self._ns_labels = torch.zeros(k1, device=dev)
            self._ns_labels[0] = 1.0
            self._ns_sign = 2.0 * self._ns_labels - 1.0
        elif c.objective == "hs":
            codes, points, lengths = corpus.huffman(c.max_code_len)
            L = c.max_code_len
            # mask beyond each word's code length; masked lanes point at
            # the scratch row, so every step has the same shapes
            msk = np.arange(L)[None, :] < lengths[:, None]
            pts = np.where(msk, points[:, :L], self._scratch)
            self._hs_points = core.place(pts.astype(np.int32), device=dev)
            self._hs_codes = core.place(codes[:, :L].astype(np.float32),
                                        device=dev)
            self._hs_mask = core.place(msk.astype(np.float32), device=dev)
        else:
            raise ValueError(f"objective must be 'ns' or 'hs', "
                             f"got {c.objective!r}")
        if c.model not in ("skipgram", "cbow"):
            raise ValueError(f"model must be 'skipgram' or 'cbow', "
                             f"got {c.model!r}")
        self._step_no = 0
        self._last_store = ()       # (prefix, step) of the last store
        self.loss_history: list = []
        self.words_per_sec = 0.0    # of the last train()
        self._fused = make_superstep((self.w_in, self.w_out), self._body,
                                     name="w2v_superstep")

    # -- the superstep --------------------------------------------------------

    def negatives(self, call_no: int, steps: int) -> torch.Tensor:
        """The NS negatives of one call, ``[S, B, K]`` int32, drawn on the
        device from a generator seeded by (seed, call number)."""
        c = self.config
        gen = core.generator(c.seed * 0x9E3779B1 + call_no, device=self.device)
        shape = (steps, c.batch_size, c.negative)
        if c.ns_sampler == "table":
            return table_sample(gen, self._ns_table, shape)
        return alias_sample(gen, self._alias_prob, self._alias_idx, shape)

    def _pos_neg_step(self, w_out, v, tgt, negs, lr):
        """NS inner math: v [B,D] input vectors vs target ids [B] and
        negatives [B,K]. Returns (w_out', -grad wrt v [B,D], mean loss)."""
        ids = torch.cat([tgt[:, None], negs], dim=1).reshape(-1)  # B(1+K)
        b, d = v.shape
        u = gather_rows(w_out, ids).view(b, -1, d)            # [B, 1+K, D]
        logits = torch.bmm(u, v[:, :, None]).squeeze(2)      # [B, 1+K]
        # binary CE on (pos, negs); analytic dL/dlogit = sig - label
        loss = -F.logsigmoid(self._ns_sign * logits).sum(dim=1).mean()
        ng = (self._ns_labels - torch.sigmoid(logits)) * lr  # -dL/dlogit*lr
        neg_grad_v = torch.bmm(ng[:, None, :], u).squeeze(1)
        neg_grad_u = ng[:, :, None] * v[:, None, :]          # [B, 1+K, D]
        w_out = row_scatter_add(w_out, ids, neg_grad_u.reshape(-1, d))
        return w_out, neg_grad_v, loss

    def _hs_step(self, w_out, v, tgt, lr):
        """Hierarchical-softmax inner math along the Huffman path."""
        tgt = tgt.long()
        pts = self._hs_points.index_select(0, tgt)           # [B, L]
        code = self._hs_codes.index_select(0, tgt)           # [B, L] 0/1
        msk = self._hs_mask.index_select(0, tgt)             # [B, L]
        b, d = v.shape
        u = gather_rows(w_out, pts.reshape(-1)).view(b, -1, d)  # [B, L, D]
        logits = torch.bmm(u, v[:, :, None]).squeeze(2)
        # label = code bit: P(go-right) modeled by sigmoid
        loss = -torch.sum(msk * (code * F.logsigmoid(logits)
                                 + (1 - code) * F.logsigmoid(-logits))
                          ) / torch.clamp_min(torch.sum(msk), 1.0)
        ng = (code - torch.sigmoid(logits)) * msk * lr       # [B, L]
        neg_grad_v = torch.bmm(ng[:, None, :], u).squeeze(1)
        neg_grad_u = ng[:, :, None] * v[:, None, :]
        w_out = row_scatter_add(w_out, pts.reshape(-1),
                                neg_grad_u.reshape(-1, d))
        return w_out, neg_grad_v, loss

    def _step(self, w_in, w_out, src, tgt, negs, lr):
        """One minibatch: returns (w_in', w_out', loss)."""
        c = self.config
        d = w_in.shape[1]
        if c.model == "cbow":
            # src [B, 2w] context ids (scratch row = padding), tgt [B]
            b, width = src.shape
            ctx_mask = (src != self._scratch).to(w_in.dtype)
            n_ctx = torch.clamp_min(ctx_mask.sum(dim=1, keepdim=True), 1.0)
            vecs = gather_rows(w_in, src.reshape(-1)).view(b, width, d)
            v = torch.bmm(ctx_mask[:, None, :], vecs).squeeze(1) / n_ctx
        else:
            v = gather_rows(w_in, src)                        # [B, D]
        if c.objective == "ns":
            w_out, neg_grad_v, loss = self._pos_neg_step(w_out, v, tgt,
                                                         negs, lr)
        else:
            w_out, neg_grad_v, loss = self._hs_step(w_out, v, tgt, lr)
        if c.model == "cbow":
            # spread the input-side gradient over the context words
            gctx = (neg_grad_v / n_ctx)[:, None, :] * ctx_mask[:, :, None]
            w_in = row_scatter_add(w_in, src.reshape(-1),
                                   gctx.reshape(-1, d))
        else:
            w_in = row_scatter_add(w_in, src, neg_grad_v)
        return w_in, w_out, loss

    def _body(self, params, states, locals_, options, pairs, negatives,
              lrs):
        """The superstep body: ``pairs`` [S, B, ctx+1] (context ids and
        the target in one operand), ``negatives`` [S, B, K] or None (HS),
        ``lrs`` [S]."""
        w_in, w_out = params
        pairs = pairs.to(torch.int32)
        if self.config.model == "cbow":
            srcs = pairs[..., :-1].contiguous()
        else:
            srcs = pairs[..., 0].contiguous()
        tgts = pairs[..., -1].contiguous()
        losses = []
        for s in range(pairs.shape[0]):
            negs = negatives[s] if negatives is not None else None
            w_in, w_out, loss = self._step(w_in, w_out, srcs[s], tgts[s],
                                           negs, lrs[s])
            losses.append(loss)
        return (w_in, w_out), states, locals_, torch.stack(losses).mean()

    # -- data placement ----------------------------------------------------

    def _place(self, srcs: np.ndarray, tgts: np.ndarray) -> torch.Tensor:
        """One combined [S, B, ctx+1] host-to-device copy per call; ids
        ship as int16 when the padded vocab fits (half the bytes), and the
        body widens them on the device."""
        if srcs.ndim == 2:      # skipgram: [S, B] -> [S, B, 1]
            srcs = srcs[..., None]
        pairs = np.concatenate([srcs, tgts[..., None]], axis=-1)
        if self._scratch < np.iinfo(np.int16).max:
            pairs = pairs.astype(np.int16)
        return core.place(pairs, device=self.device)

    # -- training ----------------------------------------------------------

    def _batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        c = self.config
        if c.model == "skipgram":
            return self.corpus.skipgram_batches(
                c.batch_size, window=c.window, seed=c.seed, epochs=c.epochs)
        return self.corpus.cbow_batches(
            c.batch_size, window=c.window, seed=c.seed, epochs=c.epochs,
            pad_id=self._scratch)

    def train(self, total_steps: Optional[int] = None,
              batches: Optional[Iterable[Tuple[np.ndarray, np.ndarray]]]
              = None) -> float:
        """Run the training loop; returns the final mean loss.

        ``batches`` (optional) replaces the corpus's own pair stream with
        the caller's ``(src, tgt)`` minibatches (e.g. generated ahead of
        time). ``total_steps`` bounds the run."""
        c = self.config
        # linear lr decay over the whole corpus (reference's alpha decay);
        # skip-gram emits ~2b pairs per center, b ~ U[1, window] -> E = w+1
        tokens = self.corpus.num_tokens
        est_pairs = tokens * c.epochs * (c.window + 1) \
            if c.model == "skipgram" else tokens * c.epochs
        est_calls = max(int(est_pairs) //
                        (c.batch_size * c.steps_per_call), 1)
        if total_steps is not None:
            est_calls = max(total_steps // c.steps_per_call, 1)
        srcs_buf, tgts_buf = [], []
        losses, call_no = [], 0
        t0 = time.perf_counter()
        source = self._batches() if batches is None else batches
        for src, tgt in prefetch_iterator(source,
                                          depth=2 * c.steps_per_call):
            srcs_buf.append(src)
            tgts_buf.append(tgt)
            if len(srcs_buf) < c.steps_per_call:
                continue
            losses.append(self._dispatch(np.stack(srcs_buf),
                                         np.stack(tgts_buf), call_no,
                                         est_calls))
            srcs_buf, tgts_buf = [], []
            call_no += 1
            if c.checkpoint_interval > 0 and c.checkpoint_prefix \
                    and call_no % c.checkpoint_interval == 0:
                self.store(c.checkpoint_prefix)
            if total_steps is not None \
                    and call_no * c.steps_per_call >= total_steps:
                break
        if call_no == 0 and srcs_buf:
            # corpus smaller than one superstep: cycle the buffered batches
            # to the full call length
            log.warn("w2v corpus yields < %d batches; cycling %d to fill "
                     "one superstep", c.steps_per_call, len(srcs_buf))
            reps = [srcs_buf[i % len(srcs_buf)]
                    for i in range(c.steps_per_call)]
            rept = [tgts_buf[i % len(tgts_buf)]
                    for i in range(c.steps_per_call)]
            losses.append(self._dispatch(np.stack(reps), np.stack(rept),
                                         0, est_calls))
            call_no = 1
        self.w_in.wait()
        dt = time.perf_counter() - t0
        pairs_done = call_no * c.steps_per_call * c.batch_size
        est_ppt = (c.window + 1) if c.model == "skipgram" else 1.0
        self.words_per_sec = pairs_done / est_ppt / dt
        # one device-to-host copy for the whole loss list
        self.loss_history = torch.stack(losses).tolist() if losses else []
        final = float(np.mean(self.loss_history[-10:])) \
            if losses else float("nan")
        log.info("w2v train done: %d calls, loss=%.4f, %.0f words/s",
                 call_no, final, self.words_per_sec)
        return final

    def _dispatch(self, srcs: np.ndarray, tgts: np.ndarray,
                  call_no: int, est_calls: int,
                  negatives: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One superstep call over ``[S, B]`` batches; returns the mean
        loss as a device scalar. ``negatives`` [S, B, K] overrides the
        call's own draw (NS only)."""
        c = self.config
        s = srcs.shape[0]
        frac = min(call_no / est_calls, 1.0)
        lr_hi = c.learning_rate * (1.0 - frac)
        lr_lo = c.learning_rate * (1.0 - min((call_no + 1) / est_calls, 1.0))
        floor = c.learning_rate * c.min_lr_frac
        lrs = np.maximum(np.linspace(lr_hi, lr_lo, s), floor) \
            .astype(np.float32)
        if c.objective == "ns":
            negatives = self.negatives(call_no, s) if negatives is None \
                else core.place(negatives, device=self.device)
        else:
            negatives = None
        _, loss = self._fused((), self._place(srcs, tgts), negatives,
                              core.place(lrs, device=self.device))
        self._step_no += s
        return loss

    # -- embeddings out / eval --------------------------------------------

    def embeddings(self) -> np.ndarray:
        """The trained input embeddings [V, D] (the reference saves W_in)."""
        return self.w_in.get()

    def nearest(self, word_id: int, k: int = 10) -> np.ndarray:
        """Top-k neighbor ids by cosine similarity (excluding self)."""
        norm = _normalized_rows(self.embeddings())
        return _topk_excluding(norm, norm[word_id], (word_id,), k)

    def similarity(self, a: int, b: int) -> float:
        emb = self.embeddings()
        va, vb = emb[a], emb[b]
        return float(va @ vb / max(np.linalg.norm(va) * np.linalg.norm(vb),
                                   1e-12))

    def analogy(self, a: int, b: int, c: int, k: int = 1) -> np.ndarray:
        """``a : b :: c : ?`` — top-k ids by cosine to (b - a + c)."""
        norm = _normalized_rows(self.embeddings())
        q = norm[b] - norm[a] + norm[c]
        q = q / max(np.linalg.norm(q), 1e-12)
        return _topk_excluding(norm, q, (a, b, c), k)

    def save_text(self, path: str) -> None:
        """The reference word2vec's text output: a ``vocab_size dim``
        header, then one ``word v1 .. vD`` line per word."""
        emb = self.w_in.get()
        with open(path, "w", encoding="utf-8") as f:
            f.write(f"{len(self.corpus.words)} {emb.shape[1]}\n")
            for w, row in zip(self.corpus.words, emb):
                f.write(w + " " + " ".join(f"{x:.6g}" for x in row) + "\n")

    def store(self, uri_prefix: str) -> None:
        """Checkpoint both tables + a meta manifest (written last, with
        each table's step, so load() detects a torn set)."""
        from multiverso_tpu_torch.tables.base import savez_stream
        self.w_in.store(f"{uri_prefix}.in.npz")
        self.w_out.store(f"{uri_prefix}.out.npz")
        savez_stream(f"{uri_prefix}.meta.npz",
                     {"magic": self.META_MAGIC,
                      "step_no": self._step_no,
                      "steps_per_call": self.config.steps_per_call,
                      "w_in_step": self.w_in.default_option.step,
                      "w_out_step": self.w_out.default_option.step}, {})
        self._last_store = (uri_prefix, self._step_no)

    def load(self, uri_prefix: str) -> None:
        from multiverso_tpu_torch.tables.base import loadz_stream
        self.w_in.load(f"{uri_prefix}.in.npz")
        self.w_out.load(f"{uri_prefix}.out.npz")
        try:
            manifest, _ = loadz_stream(f"{uri_prefix}.meta.npz",
                                       self.META_MAGIC)
        except FileNotFoundError:
            return          # tables-only checkpoint
        for table, key in ((self.w_in, "w_in_step"),
                           (self.w_out, "w_out_step")):
            if key in manifest and \
                    table.default_option.step != int(manifest[key]):
                raise ValueError(
                    f"w2v checkpoint {uri_prefix!r} is torn: "
                    f"{key}={manifest[key]} in the meta but the loaded "
                    f"table is at step {table.default_option.step}")
        self._step_no = int(manifest["step_no"])

    def load_numpy(self, weights) -> None:
        """Install ``{"w_in": ..., "w_out": ...}`` numpy weights, e.g. a
        ``multiverso_tpu`` WordEmbedding's
        (:func:`multiverso_tpu_torch.convert.load_word_embedding`)."""
        from multiverso_tpu_torch.convert import load_word_embedding
        load_word_embedding(self, weights)
