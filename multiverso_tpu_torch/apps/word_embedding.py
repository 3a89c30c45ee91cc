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

On a (1, S) mesh (``mesh=``) both tables split their rows over the S
model shards and the superstep hands the body each one as a
``ShardedParam``: every gather and scatter-add of a step then launches
once per card over that card's shards, and the tables end bit-identical
to a (1, 1) run. The NS table or alias and the negatives' generator live
on the first shard's device.

On a (D, S) mesh with D above 1 (data parallelism, the reference's
default deployment) both tables hold D replicas and the pair stream is
split over the data axis, as the reference's ``P(None, DATA_AXIS,
None)``: replica ``d`` trains on the contiguous block ``d`` of B/D lanes
of every step, with the same block of the negatives (drawn once as
``[S, B, K]``, so the draws equal a one-replica run's), on its own
copy of the tables. Each scatter-add exchanges the replicas' lanes and
applies all of them in the global lane order on every replica (the
superstep's counterpart of the reference's psum), and the loss is the
whole batch's (:func:`~multiverso_tpu_torch.tables.superstep.replica_sum`).
The constants the body reads (the NS labels, the HS paths) live on each
replica's first device. ``python -m
multiverso_tpu_torch.apps.word_embedding`` is the command line (:func:`main`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multiverso_tpu_torch import client, core, telemetry
from multiverso_tpu_torch.data.corpus import Corpus
from multiverso_tpu_torch.tables import MatrixTable, make_superstep
from multiverso_tpu_torch.tables.superstep import (DataSplit, gather_rows,
                                                   replica_sum,
                                                   row_scatter_add)
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
    local_data: bool = False    # multi-process: each process generates
    # ONLY its replicas' share of every batch from ITS OWN corpus shard
    # (seed folded with the rank so streams differ), the reference's
    # workers-each-stream-their-own-corpus model. batch_size stays the
    # GLOBAL batch; processes must own disjoint data lanes (validated).
    # Call counts are agreed collectively from the shards' sizes; each
    # process cycles its local corpus to fill the agreed schedule
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


def local_batches(corpus: Corpus, config: W2VConfig, rank: int,
                  batch: int, pad_id: int
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """``local_data``: rank ``rank``'s ``[batch]`` share of every batch
    from its corpus shard, epoch after epoch with the seed ``seed + 7919
    * (rank + 1) + 104729 * epoch`` (the reference's rule), forever; the
    caller bounds the loop. An empty shard raises: it would leave this
    process out of the agreed collective schedule (a deadlock)."""
    c = config
    epoch = 0
    while True:
        seed = c.seed + 7919 * (rank + 1) + 104729 * epoch
        if c.model == "skipgram":
            it = corpus.skipgram_batches(batch, window=c.window, seed=seed,
                                         epochs=1)
        else:
            it = corpus.cbow_batches(batch, window=c.window, seed=seed,
                                     epochs=1, pad_id=pad_id)
        got = False
        for item in it:
            got = True
            yield item
        if not got:
            raise ValueError(
                f"local_data: this process's corpus shard yields no "
                f"{batch}-pair batches; every process must contribute "
                "data (or drop local_data)")
        epoch += 1


class WordEmbedding:
    """The app: two MatrixTables + the superstep, on ``mesh`` (default:
    the runtime's) or the (1, 1) mesh of ``device``."""

    META_MAGIC = "mvtpu.w2v.meta.v1"

    def __init__(self, corpus: Corpus, config: W2VConfig, *,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None,
                 name: str = "w2v") -> None:
        self.corpus = corpus
        self.config = config
        self.mesh = core.resolve_mesh(mesh, device)
        self.device = dev = self.mesh.row_device(self.mesh.local_rows[0])
        self.n_replicas = self.mesh.shape[core.DATA_AXIS]
        c = config
        if c.subsample is not None:
            corpus.set_subsample(c.subsample)
        v, d = corpus.vocab_size, c.embedding_dim
        rng = np.random.default_rng(c.seed)
        # reference init: input embeddings ~ U(-0.5/dim, 0.5/dim), output 0
        w_in_init = rng.uniform(-0.5 / d, 0.5 / d, (v, d)).astype(c.dtype)
        self.w_in = MatrixTable(v, d, c.dtype, init_value=w_in_init,
                                updater="default", mesh=self.mesh,
                                name=f"{name}_in")
        self.w_out = MatrixTable(v, d, c.dtype, init_value=0,
                                 updater="default", mesh=self.mesh,
                                 name=f"{name}_out")
        self._scratch = self.w_in.padded_shape[0] - 1  # masked-lane row
        # MVTPU_STALENESS=S: embeddings() reads a bounded-staleness
        # cached view of w_in (the reference's client-side cache)
        self._emb_view = client.maybe_cached_view(self.w_in)
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
            labels = torch.zeros(c.negative + 1, device=dev)
            labels[0] = 1.0
            consts = dict(ns_labels=labels, ns_sign=2.0 * labels - 1.0)
        elif c.objective == "hs":
            codes, points, lengths = corpus.huffman(c.max_code_len)
            L = c.max_code_len
            # mask beyond each word's code length; masked lanes point at
            # the scratch row, so every step has the same shapes
            msk = np.arange(L)[None, :] < lengths[:, None]
            pts = np.where(msk, points[:, :L], self._scratch)
            consts = dict(
                hs_points=core.place(pts.astype(np.int32), device=dev),
                hs_codes=core.place(codes[:, :L].astype(np.float32),
                                    device=dev),
                hs_mask=core.place(msk.astype(np.float32), device=dev))
        else:
            raise ValueError(f"objective must be 'ns' or 'hs', "
                             f"got {c.objective!r}")
        if c.model not in ("skipgram", "cbow"):
            raise ValueError(f"model must be 'skipgram' or 'cbow', "
                             f"got {c.model!r}")
        # the constants the body reads, on each replica's first device
        self._consts = {}
        for row in self.w_in.replica_ids:
            rdev = self.mesh.row_device(row)
            self._consts.setdefault(rdev, {
                k: v.to(rdev) for k, v in consts.items()})
        self._step_no = 0
        # a resume continues the stored run's LR decay and negative-draw
        # sequence: its planned call count and the calls already done
        self._sched_offset = 0
        self._sched_plan = 0
        self._train_plan = 0        # the last train()'s effective plan
        self.run_ckpt = None        # ft.checkpoint.wire_app attaches it
        self._last_store = ()       # (prefix, step) of the last store
        self.loss_history: list = []
        self.words_per_sec = 0.0    # of the last train()
        # local_data: [(b0, b1)] of the global batch this process's
        # replicas own, in offset order (None: every lane is generated
        # from this process's corpus)
        self._local_chunks = None
        if c.local_data and self.mesh.processes > 1:
            self._setup_local_data()
        self._fused = make_superstep((self.w_in, self.w_out), self._body,
                                     name="w2v_superstep")

    def _setup_local_data(self) -> None:
        """Per-process data lanes: the contiguous chunks of the global
        batch this process's replicas own, with a single-owner check
        across processes and a shared-dictionary check (the NS table, the
        Huffman arrays and the table shapes all come from the local
        corpus, so every process must hold the SAME dictionary; only the
        token stream is per-process)."""
        import zlib

        from multiverso_tpu_torch.parallel.multihost import (
            allgather_i64, owned_axis_slices, validate_single_owner)
        c = self.config
        B = c.batch_size
        slices = owned_axis_slices(self.mesh, (c.steps_per_call, B, 1),
                                   axis=1)
        # distinct chunks (a row's model shards share one), in order
        self._local_chunks = sorted({(b0, b1) for _, b0, b1 in slices})
        self._local_batch = sum(b1 - b0 for b0, b1 in self._local_chunks)
        mask = np.zeros(B, np.int32)
        for b0, b1 in self._local_chunks:
            mask[b0:b1] = 1
        validate_single_owner(mask, "local_data")
        counts = np.ascontiguousarray(
            np.asarray(self.corpus.unigram_probs(c.unigram_power),
                       np.float64))
        digest = np.array([self.corpus.vocab_size,
                           zlib.crc32(counts.tobytes())], np.int64)
        gathered = allgather_i64(digest)
        if not np.all(gathered == gathered[0]):
            raise ValueError(
                "local_data requires the SAME dictionary (vocab + "
                "frequencies) on every process — only the token stream "
                f"is per-process; got per-rank (vocab, counts-crc32) = "
                f"{gathered.tolist()}")

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

    def _pos_neg_step(self, w_out, v, tgt, negs, lr, k):
        """NS inner math: v [B,D] input vectors vs target ids [B] and
        negatives [B,K], constants ``k``. Returns (w_out', -grad wrt v
        [B,D], the loss summed over the lanes, the lane count)."""
        ids = torch.cat([tgt[:, None], negs], dim=1).reshape(-1)  # B(1+K)
        b, d = v.shape
        u = gather_rows(w_out, ids).view(b, -1, d)            # [B, 1+K, D]
        logits = torch.bmm(u, v[:, :, None]).squeeze(2)      # [B, 1+K]
        # binary CE on (pos, negs); analytic dL/dlogit = sig - label
        loss = -F.logsigmoid(k["ns_sign"] * logits).sum()
        ng = (k["ns_labels"] - torch.sigmoid(logits)) * lr  # -dL/dlogit*lr
        neg_grad_v = torch.bmm(ng[:, None, :], u).squeeze(1)
        neg_grad_u = ng[:, :, None] * v[:, None, :]          # [B, 1+K, D]
        w_out = row_scatter_add(w_out, ids, neg_grad_u.reshape(-1, d))
        return w_out, neg_grad_v, loss, torch.full_like(loss, b)

    def _hs_step(self, w_out, v, tgt, lr, k):
        """Hierarchical-softmax inner math along the Huffman path; the
        loss summed over the unmasked lanes, and their count."""
        tgt = tgt.long()
        pts = k["hs_points"].index_select(0, tgt)            # [B, L]
        code = k["hs_codes"].index_select(0, tgt)            # [B, L] 0/1
        msk = k["hs_mask"].index_select(0, tgt)              # [B, L]
        b, d = v.shape
        u = gather_rows(w_out, pts.reshape(-1)).view(b, -1, d)  # [B, L, D]
        logits = torch.bmm(u, v[:, :, None]).squeeze(2)
        # label = code bit: P(go-right) modeled by sigmoid
        loss = -torch.sum(msk * (code * F.logsigmoid(logits)
                                 + (1 - code) * F.logsigmoid(-logits)))
        ng = (code - torch.sigmoid(logits)) * msk * lr       # [B, L]
        neg_grad_v = torch.bmm(ng[:, None, :], u).squeeze(1)
        neg_grad_u = ng[:, :, None] * v[:, None, :]
        w_out = row_scatter_add(w_out, pts.reshape(-1),
                                neg_grad_u.reshape(-1, d))
        return w_out, neg_grad_v, loss, torch.sum(msk)

    def _step(self, w_in, w_out, src, tgt, negs, lr, k):
        """One minibatch: returns (w_in', w_out', summed loss, lanes)."""
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
            w_out, neg_grad_v, loss, lanes = self._pos_neg_step(
                w_out, v, tgt, negs, lr, k)
        else:
            w_out, neg_grad_v, loss, lanes = self._hs_step(w_out, v, tgt,
                                                           lr, k)
        if c.model == "cbow":
            # spread the input-side gradient over the context words
            gctx = (neg_grad_v / n_ctx)[:, None, :] * ctx_mask[:, :, None]
            w_in = row_scatter_add(w_in, src.reshape(-1),
                                   gctx.reshape(-1, d))
        else:
            w_in = row_scatter_add(w_in, src, neg_grad_v)
        return w_in, w_out, loss, lanes

    def _body(self, params, states, locals_, options, pairs, negatives,
              lrs):
        """The superstep body: ``pairs`` [S, B, ctx+1] (context ids and
        the target in one operand), ``negatives`` [S, B, K] or None (HS),
        ``lrs`` [S] (on a data axis, this replica's B/D lanes of each
        step). The loss of each step is the whole batch's: its sum over
        the lanes divided by their count, both summed over the
        replicas."""
        w_in, w_out = params
        k = self._consts[pairs.device]
        pairs = pairs.to(torch.int32)
        if self.config.model == "cbow":
            srcs = pairs[..., :-1].contiguous()
        else:
            srcs = pairs[..., 0].contiguous()
        tgts = pairs[..., -1].contiguous()
        sums = []
        for s in range(pairs.shape[0]):
            negs = negatives[s] if negatives is not None else None
            w_in, w_out, loss, lanes = self._step(
                w_in, w_out, srcs[s], tgts[s], negs, lrs[s], k)
            sums.append(torch.stack([loss, lanes]))
        sums = replica_sum(torch.stack(sums))                 # [S, 2]
        losses = sums[:, 0] / torch.clamp_min(sums[:, 1], 1.0)
        return (w_in, w_out), states, locals_, losses.mean()

    # -- data placement ----------------------------------------------------

    def _place(self, srcs: np.ndarray, tgts: np.ndarray):
        """One combined [S, B, ctx+1] host-to-device copy per call (per
        replica on a data axis, each its B/D lanes of every step); ids
        ship as int16 when the padded vocab fits (half the bytes), and the
        body widens them on the device."""
        if srcs.ndim == 2:      # skipgram: [S, B] -> [S, B, 1]
            srcs = srcs[..., None]
        pairs = np.concatenate([srcs, tgts[..., None]], axis=-1)
        if self._scratch < np.iinfo(np.int16).max:
            pairs = pairs.astype(np.int16)
        if self._local_chunks is not None:
            # local_data: ``pairs`` is this process's [S, B_local, C]
            # share, its replicas' chunks in order: each replica gets its
            # own, and no process ships another's lanes
            parts, at = [], 0
            for (b0, b1), row in zip(self._local_chunks,
                                     self.mesh.local_rows):
                parts.append(torch.as_tensor(np.ascontiguousarray(
                    pairs[:, at:at + b1 - b0]),
                    device=self.mesh.row_device(row)))
                at += b1 - b0
            return DataSplit(parts)
        if self.n_replicas > 1:
            return DataSplit.of(pairs, self.mesh, axis=1)
        return core.place(pairs, device=self.device)

    # -- training ----------------------------------------------------------

    def _batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        c = self.config
        if self._local_chunks is not None:
            return local_batches(self.corpus, c, self.mesh.rank,
                                 self._local_batch, self._scratch)
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
        if c.batch_size % self.n_replicas:
            raise ValueError(f"batch_size {c.batch_size} not divisible by "
                             f"data-axis size {self.n_replicas}")
        # linear lr decay over the whole corpus (reference's alpha decay);
        # skip-gram emits ~2b pairs per center, b ~ U[1, window] -> E = w+1
        tokens = self.corpus.num_tokens
        if self._local_chunks is not None:
            # local_data: the schedule must be the same on every process:
            # agree on the GLOBAL token count
            from multiverso_tpu_torch.parallel.multihost import \
                allgather_i64
            tokens = int(allgather_i64([tokens]).sum())
        est_pairs = tokens * c.epochs * (c.window + 1) \
            if c.model == "skipgram" else tokens * c.epochs
        est_calls = max(int(est_pairs) //
                        (c.batch_size * c.steps_per_call), 1)
        if total_steps is not None:
            est_calls = max(total_steps // c.steps_per_call, 1)
        elif self._local_chunks is not None and batches is None:
            # the cycling local stream never ends: the agreed schedule
            # is the stop condition
            total_steps = est_calls * c.steps_per_call
        # the plan a run checkpoint records: the original schedule when
        # resumed, else this run's own estimate
        self._train_plan = self._sched_plan or est_calls
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
            if telemetry.health.maybe_rollback(self) is not None:
                # divergence rollback: tables and the step cursor are back
                # at the last clean generation (the LR decay and the
                # negatives' seeds re-align through _step_no). The pair
                # stream cannot rewind: training goes on with fresh
                # batches from the restored parameters. Checked before
                # maybe_save so a diverged state is never committed.
                continue
            if self.run_ckpt is not None:
                self.run_ckpt.maybe_save(
                    self._step_no // c.steps_per_call, self.run_state)
            elif c.checkpoint_interval > 0 and c.checkpoint_prefix \
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
        telemetry.counter("w2v.pairs").inc(pairs_done)
        telemetry.emit("w2v.words_per_sec", self.words_per_sec, "words/s")
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
        if self._sched_plan:
            # a resume continues the original run's decay and draws (past
            # the plan's end the LR floor holds)
            call_no += self._sched_offset
            est_calls = max(self._sched_plan, 1)
        frac = min(call_no / est_calls, 1.0)
        lr_hi = c.learning_rate * (1.0 - frac)
        lr_lo = c.learning_rate * (1.0 - min((call_no + 1) / est_calls, 1.0))
        floor = c.learning_rate * c.min_lr_frac
        lrs = np.maximum(np.linspace(lr_hi, lr_lo, s), floor) \
            .astype(np.float32)
        if c.objective == "ns":
            negatives = self.negatives(call_no, s) if negatives is None \
                else core.place(negatives, device=self.device)
            if self.n_replicas > 1:
                negatives = DataSplit.of(negatives, self.mesh, axis=1)
        else:
            negatives = None
        pd = self._place(srcs, tgts)
        t_step = time.perf_counter()
        with telemetry.span("w2v.superstep"):
            _, loss = self._fused((), pd, negatives,
                                  core.place(lrs, device=self.device))
        telemetry.step_timeline("w2v", call_no, pairs=s * c.batch_size,
                                dispatch_s=time.perf_counter() - t_step)
        telemetry.histogram(
            "app.step.seconds", telemetry.LATENCY_BUCKETS,
            app="w2v").observe(time.perf_counter() - t_step)
        telemetry.beat()    # flight recorder: one heartbeat per dispatch
        self._step_no += s
        return loss

    # -- embeddings out / eval --------------------------------------------

    def embeddings(self) -> np.ndarray:
        """The trained input embeddings [V, D] (the reference saves
        W_in). Under ``MVTPU_STALENESS`` this is a bounded-staleness
        cached read — mid-train eval (nearest/similarity/analogy) stops
        paying a blocking whole-table fetch per call."""
        if self._emb_view is not None:
            return self._emb_view.get()
        return self.w_in.get()

    def close(self) -> None:
        """Close the cached view (``MVTPU_STALENESS``): the app is done."""
        if self._emb_view is not None:
            self._emb_view.close()

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
        header, then one ``word v1 .. vD`` line per word. Over several
        processes only process 0 writes."""
        emb = self.w_in.get()
        if self.mesh.rank != 0:
            return
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

    # -- run state (the run checkpoint manager's contract) ------------------

    def run_state(self) -> dict:
        """The train state for the run checkpoint manager: the step cursor
        and the ORIGINAL planned call count, so a resumed run continues
        the stored run's LR decay and negative draws instead of restarting
        them."""
        return {"step_no": self._step_no,
                "steps_per_call": self.config.steps_per_call,
                "sched_plan": self._sched_plan or self._train_plan}

    def restore_run_state(self, restored) -> None:
        spc = int(restored.get("steps_per_call",
                               self.config.steps_per_call))
        if spc != self.config.steps_per_call:
            raise ValueError(
                f"run checkpoint was written with steps_per_call={spc}, "
                f"this app uses {self.config.steps_per_call}: the resume "
                "offset and the negatives' seeds are call-indexed — "
                "construct the app with the original steps_per_call")
        self._step_no = int(restored.get("step_no", 0))
        self._sched_plan = int(restored.get("sched_plan", 0))
        if self._sched_plan:
            self._sched_offset = \
                self._step_no // self.config.steps_per_call

    def load_numpy(self, weights) -> None:
        """Install ``{"w_in": ..., "w_out": ...}`` numpy weights, e.g. a
        ``multiverso_tpu`` WordEmbedding's
        (:func:`multiverso_tpu_torch.convert.load_word_embedding`)."""
        from multiverso_tpu_torch.convert import load_word_embedding
        load_word_embedding(self, weights)


USAGE = """python -m multiverso_tpu_torch.apps.word_embedding -train_file=PATH
    [-size=100] [-window=5] [-negative=5 (0: hierarchical softmax)]
    [-cbow=false] [-epoch=1] [-batch_size=1024] [-alpha=0.025]
    [-sample=1e-3] [-min_count=5] [-output_file=PREFIX]
    [-output_text=PATH] [-checkpoint_interval=0]
    [-data_parallel=0] [-model_parallel=1] [-device=cpu]
    [-run_dir=DIR] [-resume=false] [-ckpt_every=0]

The mesh is -data_parallel x -model_parallel over every CUDA device, or
over one device repeated with -device (-device=cpu: the CPU); with a data
axis above 1 each row of the mesh holds a replica of the tables and
trains on its share of every batch (-batch_size must divide by it).
-run_dir (or MVTPU_RUN_DIR) keeps a run directory of checkpoint
generations, one every -ckpt_every superstep calls (default: the
-checkpoint_interval, else 50); -resume (or MVTPU_RESUME=1) restarts from
its latest complete one. Without -run_dir, -output_file with
-checkpoint_interval stores the tables every N superstep calls."""


def main(argv=None) -> None:
    """CLI mirroring the reference's word2vec-style argv (its ``main``);
    ``-help`` prints the flags."""
    from multiverso_tpu_torch.utils import configure
    flags = [
        (configure.define_string, "train_file", "", "corpus text file"),
        (configure.define_int, "size", 100, "embedding dimension"),
        (configure.define_int, "window", 5, "context window"),
        (configure.define_int, "negative", 5, "negative samples (0 -> HS)"),
        (configure.define_bool, "cbow", False, "CBOW instead of skip-gram"),
        (configure.define_int, "epoch", 1, "epochs"),
        (configure.define_int, "batch_size", 1024, "pairs per step"),
        (configure.define_float, "alpha", 0.025, "initial learning rate"),
        (configure.define_float, "sample", 1e-3, "subsampling threshold"),
        (configure.define_int, "min_count", 5, "vocab min count"),
        (configure.define_string, "output_file", "",
         "embedding checkpoint prefix"),
        (configure.define_string, "output_text", "",
         "text-format embedding dump (the reference's output format)"),
        (configure.define_int, "checkpoint_interval", 0,
         "store -output_file every N superstep calls (0 = only at end)"),
        (configure.define_string, "device", "",
         "one torch device for every shard (default: the CUDA devices as "
         "a mesh of -data_parallel x -model_parallel)"),
    ]
    for define, name, default, help_str in flags:
        define(name, default, help_str, overwrite=True)
    from multiverso_tpu_torch.ft.checkpoint import define_run_flags, wire_app
    define_run_flags()
    argv = list(argv or [])
    if any(a.lstrip("-") in ("help", "h") for a in argv):
        print(USAGE + "\n\n" + configure.describe_flags())
        return
    rest = configure.parse_flags(argv)
    if rest:
        raise SystemExit(f"unknown arguments {rest}\n\n{USAGE}")
    train_file = configure.get_flag("train_file")
    if not train_file:
        raise SystemExit(f"-train_file is required\n\n{USAGE}")
    dp = configure.get_flag("data_parallel")
    mp = configure.get_flag("model_parallel")
    dev = configure.get_flag("device")
    mesh = core.init(devices=[dev] * (max(dp, 1) * mp) if dev else None,
                     data_parallel=dp, model_parallel=mp)
    corpus = Corpus.from_file(train_file,
                              min_count=configure.get_flag("min_count"),
                              subsample=configure.get_flag("sample"))
    neg = configure.get_flag("negative")
    cfg = W2VConfig(
        embedding_dim=configure.get_flag("size"),
        window=configure.get_flag("window"),
        negative=max(neg, 1),
        objective="ns" if neg > 0 else "hs",
        model="cbow" if configure.get_flag("cbow") else "skipgram",
        batch_size=configure.get_flag("batch_size"),
        learning_rate=configure.get_flag("alpha"),
        epochs=configure.get_flag("epoch"),
        subsample=configure.get_flag("sample"),
        checkpoint_prefix=configure.get_flag("output_file"),
        checkpoint_interval=configure.get_flag("checkpoint_interval"),
    )
    app = WordEmbedding(corpus, cfg, mesh=mesh)
    # fault tolerance: run-level checkpoint/resume, cadence in superstep
    # calls (-ckpt_every / MVTPU_CKPT_EVERY; else the -checkpoint_interval
    # cadence, else 50 calls)
    mgr = wire_app(app, [app.w_in, app.w_out],
                   every_default=cfg.checkpoint_interval or 50)
    # flight recorder: MVTPU_WATCHDOG=<s> arms a stall watchdog (the
    # per-dispatch beat is in _dispatch); MVTPU_PROFILE_DIR captures a
    # torch.profiler trace of the whole training run
    with telemetry.maybe_watchdog("w2v"), telemetry.profile_window("w2v"):
        app.train()
    if mgr is not None:
        mgr.close()     # drain pending background checkpoint writes
    telemetry.record_device_memory()
    out = configure.get_flag("output_file")
    # skip the end-of-train store when the last periodic one wrote this
    # exact state
    if out and app._last_store != (out, app._step_no):
        app.store(out)
    out_text = configure.get_flag("output_text")
    if out_text:
        app.save_text(out_text)
    app.close()
    core.barrier()


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
