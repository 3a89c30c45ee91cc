"""LightLDA on the port's tables: collapsed-Gibbs topic modelling over a
word-topic count matrix (SparseMatrixTable) and a topic-summary row
(ArrayTable), with worker-local doc-topic counts and per-token topics.

Counterpart of ``multiverso_tpu/apps/lightlda.py``, with its samplers:

1. ``sampler="gibbs"``: exact vectorized collapsed Gibbs in plain torch:
   per step the batch's own counts leave the tables, the posterior's CDF
   is drawn from with one uniform per token, the counts come back.
2. ``sampler="mh"``: LightLDA's own O(1)-per-token Metropolis-Hastings
   sampler, the reference's algorithm-parity mode: ``mh_steps`` rounds of
   a word proposal (a binary search of the per-sweep stale word CDF) and
   a doc proposal (the z-array trick), each accepted against the live
   counts. Plain torch single-element reads (the reference's body reaches
   no Pallas kernel).
3. ``sampler="tiled"``: tile-aligned ``[*, C, 128]`` counts and the fused
   posterior + two-level draw kernel (``ops.gibbs_sample_tiled``).
   ``stale_words=True`` gathers word rows from a bf16 mirror refreshed per
   sweep, keeps doc counts in int16 and rebuilds the int32 word table from
   z at sweep end.
4. ``doc_blocked=True`` (the production mode): whole documents packed into
   kernel blocks that own exclusive slices of a blocked doc-count array,
   so the doc side never leaves the sampler kernel
   (``ops.gibbs_sample_docblock``). ``stream_blocks=True`` keeps the
   packed stream, z and the doc counts on the host and stages one call at
   a time; the kernel then builds each block's counts from z
   (``ops.gibbs_sample_docblock_build``) and the word table accumulates
   from each call's z.

Every count build and move of the word table is a COO add through the
port's ``coo_scatter_add`` kernel; the tiled modes gather word and doc
rows with the row gather kernel, the doc-blocked kernel reads its word
rows from the mirror itself. The reference's ``lax.scan`` over the S
steps of a call is a Python loop, and its ``jax.random`` draws are draws
from a ``torch.Generator`` on the device, seeded per call from (seed,
call number); :meth:`LightLDA.sweep` also takes them as inputs, so a
caller can feed both packages the same ones.

Meshes (``mesh=``, as ``core.resolve_mesh`` takes it): every mode runs on
a ``(D, S)`` mesh, and equals the ``(1, 1)`` run fed the same draws bit
for bit (every row lives in one shard, every count is an integer, and
each lane's posterior reads the same counts).

- On the model axis the word table (and a stale mode's bf16 mirror, and
  mh's stale CDF and count copy) stays split by vocab rows: rows are read
  through the mesh gather, counts move through the mesh COO add, and mh
  reads its single elements from the shard that owns each row. The
  doc-blocked kernel then takes gathered rows instead of ``words=``.
- On the data axis the tables hold D replicas. Replica ``d`` samples the
  contiguous ``B / D`` lanes ``d`` of every step from its block of the
  call's draws. In the shuffled-stream modes z and the doc counts are
  whole on every replica (``Replicated``): each replica removes and adds
  every lane's counts, the new topics exchanged with ``replica_cat`` (and
  a tiled kernel's summary deltas summed with ``replica_sum``). In the
  doc-blocked mode each replica owns its blocks of every step
  (``DataSplit``), their doc counts and z, and the summary deltas are
  summed over the replicas. The sweep-end rebuild scatters every
  replica's tokens into every replica's table. The streamed mode stages
  each call once on the host, pinned, and gives replica ``d`` its
  contiguous ``B / D`` lanes of every step (its whole blocks, the
  reference's ``P(None, None, data)``); each replica adds every
  replica's (word, topic) lanes, exchanged with ``replica_cat``, to its
  own word-count accumulator, and the call's z comes back from replica 0
  in replica order, each replica's lanes written where the host layout
  puts them (:meth:`LightLDA._block_rows`).

Over several processes (``core``'s module doc) each process holds the
replicas of its data rows: its parts of the ``DataSplit`` and
``Replicated`` carries, and its lanes of each staged call. The streamed
mode stages and reads back only this process's lanes; the count rebuilds
take every process's lanes over the group, and a full-z consumer
(``doc_topics``, ``store``) first completes the host z
(:meth:`LightLDA._sync_z_host`). Under ``local_corpus`` each process
passes only its own docs and packs them into the block slots its
replicas own; z starts from :func:`_hash_z` of the global slot, and the
sampler state is stored per rank.

When the model axis crosses processes (a data row whose cells lie in
several processes, ``mesh.rows_split``) each process holds its cells'
shards of the word table and the summary, and every process of a row
runs that row's body on every lane of it, so each holds the row's z and
doc counts whole. Count moves exchange nothing: each process adds the
lanes whose rows its shards hold (the mesh COO add over the shards it
holds). Word-row reads do, each mode in its own way, and a run equals
the one-process run on the same global mesh fed the same draws, bit for
bit:

- the stale modes (tiled stale, doc-blocked, streamed) read no word row
  across processes within a sweep: at its start each process converts
  its shards to bf16 and the row's processes all-gather them, so every
  process holds the WHOLE ``[V_pad, C, 128]`` mirror as one tensor, and
  the doc-blocked kernels read it with ``words=`` (the tiled kernel's
  rows through the row gather). That trades memory for traffic: at V
  50,000, K 1,024 the mirror is 102.4 MB on every process, less than
  the ``[B, C, 128]`` bf16 rows of one 512,000-lane step (1.05 GB) that
  a one-process split mirror gathers, and its foreign half crosses
  once a sweep where lane partials would cross every step;
- the exact modes (gibbs, tiled exact, loglik) read a step's DISTINCT
  rows from the split table (``torch.unique``), the row's processes'
  partials of that ``[U, C]`` block OR-merged, and give each lane its
  row from the block through the row gather;
- mh reads single elements: the process whose shard holds a lane's row
  runs that lane's proposal and acceptance (the stale CDF's search and
  the live reads), the others write zero bits, and the lanes' new
  topics OR-merge, 4 bytes a lane twice a round. Its stale CDF and count
  copy stay split;
- whole-table reads (``word_topics``, ``dump_model``, ``store``, the
  run checkpoints, the summary inside a body) go through the tables'
  collectives.

``local_corpus`` on a row two processes share raises, as in the
reference (each data lane must have one owner).

The run checkpoint manager (``run_state`` / ``restore_run_state``) and
the health rollback ride the sweep loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import client, core, telemetry
from multiverso_tpu_torch.data.corpus import backend as data_backend
from multiverso_tpu_torch.io import open_stream
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.ops.lda_sampler import (gibbs_sample_docblock,
                                                  gibbs_sample_docblock_build,
                                                  gibbs_sample_tiled)
from multiverso_tpu_torch.tables import (ArrayTable, SparseMatrixTable,
                                         make_superstep)
from multiverso_tpu_torch.tables.base import (_record_events, loadz_stream,
                                              savez_stream)
from multiverso_tpu_torch.tables.superstep import (DataSplit, Replicated,
                                                   ShardedParam,
                                                   gather_rows,
                                                   local_replica_index,
                                                   replica_cat,
                                                   replica_index,
                                                   replica_sum)
from multiverso_tpu_torch.utils import log
from multiverso_tpu_torch.utils.async_buffer import prefetch_iterator

STATE_MAGIC = "multiverso_tpu.lda_state.v1"

#: ``uniforms(call_no) -> [S, n, B]`` float32: n = 1 for gibbs, 2 for the
#: kernel samplers, 5 * mh_steps for mh
Uniforms = Callable[[int], "torch.Tensor | np.ndarray"]
#: ``integers(call_no) -> [S, mh_steps, B]`` int32 in [0, K) (mh only)
Integers = Callable[[int], "torch.Tensor | np.ndarray"]


@dataclasses.dataclass
class LDAConfig:
    """The reference app's flag set (lightlda argv)."""
    num_topics: int = 100
    alpha: Optional[float] = None   # doc-topic prior; default 50/K
    beta: float = 0.01              # word-topic prior
    batch_tokens: int = 4096        # tokens per step
    steps_per_call: int = 16        # steps per superstep call
    num_iterations: int = 10        # full Gibbs sweeps
    eval_every: int = 1             # likelihood eval cadence (sweeps)
    checkpoint_prefix: str = ""     # periodic mid-train checkpoints
    checkpoint_interval: int = 0    # store every N sweeps (0 = off)
    sampler: str = "gibbs"          # "gibbs" (exact O(K), plain torch)
    #                               | "mh" (O(1) Metropolis-Hastings)
    #                               | "tiled" (sampler kernel, K%128==0)
    stale_words: bool = False       # tiled only: word rows from a bf16
    # mirror refreshed per sweep, int16 doc counts, word table rebuilt
    # from z each sweep
    doc_blocked: bool = False       # tiled only (implies stale_words):
    # whole-doc kernel blocks owning exclusive doc-count slices
    block_tokens: int = 512         # doc_blocked: tokens per kernel block
    block_docs: int = 16            # doc_blocked: max docs per block
    stream_blocks: bool = False     # doc_blocked only: stream, z and doc
    # counts stay on the host; one call is staged at a time
    local_corpus: bool = False      # stream_blocks only: PER-PROCESS
    # corpus shards: each process passes ONLY its own (token_words,
    # token_docs) slice (global doc ids, disjoint doc sets) and packs its
    # docs into exactly the block slots its replicas own; calls per sweep
    # and the global doc and token counts are agreed at init, and z
    # starts from a hash of (seed, global block, position)
    mh_steps: int = 2               # MH rounds (sampler "mh")
    precision: str = "float32"      # gibbs posterior/CDF dtype (bfloat16)
    seed: int = 0

    def resolved_alpha(self) -> float:
        return self.alpha if self.alpha is not None \
            else 50.0 / self.num_topics


def load_docs(path: str) -> Tuple[np.ndarray, np.ndarray, int]:
    """Read 'word:count' bag-of-words docs into a flat token stream.

    Returns (token_words [T], token_docs [T], vocab_size): counts expanded
    to one entry per token occurrence (Gibbs assigns a topic per
    occurrence)."""
    offsets, word_ids, word_counts = data_backend().lda_read_docs(path)
    doc_of_entry = np.repeat(
        np.arange(len(offsets) - 1, dtype=np.int32),
        np.diff(offsets).astype(np.int64))
    token_words = np.repeat(word_ids.astype(np.int32), word_counts)
    token_docs = np.repeat(doc_of_entry, word_counts)
    vocab = int(word_ids.max()) + 1 if len(word_ids) else 1
    return token_words, token_docs, vocab


def _hash_z(seed: int, gblocks: np.ndarray, tb: int, K: int) -> np.ndarray:
    """Process-independent z init for local_corpus mode: splitmix64 of
    (seed, global block, position) mod K, so any process computes the
    same draw for a slot without the global stream (the reference's)."""
    x = (gblocks.astype(np.uint64)[:, None] * np.uint64(tb)
         + np.arange(tb, dtype=np.uint64)[None, :]
         + (np.uint64(seed & 0xFFFFFFFF) << np.uint64(32)))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(K)).astype(np.int32)


def _predictive_ll(A, W, S, m, alpha, beta, K, vbeta) -> torch.Tensor:
    """Per-token predictive log-likelihood under point estimates,
    log sum_k theta_dk * phi_wk (the reference's `Eval` math), summed over
    the tokens of mask ``m``. A/W are gathered 2-D float32 count rows, S
    the [K] summary."""
    theta = (A + alpha) / (A.sum(1, keepdim=True) + K * alpha)
    phi = (W + beta) / (S + vbeta)
    ll = torch.log(torch.clamp_min((theta * phi).sum(1), 1e-30))
    return (ll * m).sum()


def _eval_chunk(n: int) -> int:
    """Largest chunk of ~64k tokens that divides ``n``: eval gathers
    materialise [chunk, K] float32 rows, which must stay bounded however
    large a call is."""
    c = n
    while c > (1 << 16) and c % 2 == 0:
        c //= 2
    return c


def _whole(view) -> torch.Tensor:
    """A table view as one tensor: a one-shard table's own tensor, a split
    one's shards concatenated on the first held shard's device, the
    shards of other processes merged in (a body that returns it whole
    has the superstep split it back)."""
    if isinstance(view, ShardedParam):
        return view.whole()
    return view


def _per_shard(view, fn):
    """``fn`` of each shard of a table view held here, in the view's form
    (a shard of another process stays None)."""
    if isinstance(view, ShardedParam):
        return ShardedParam([None if t is None else fn(t)
                             for t in view.shards], view.merge)
    return fn(view)


def _split_view(view) -> bool:
    """True for a view whose shards lie partly in other processes (its
    reads merge over the row's processes)."""
    return isinstance(view, ShardedParam) and view.merge is not None


def _read_rows(view, ids: torch.Tensor) -> torch.Tensor:
    """Word rows ``view[ids]`` -> ``[n, C]``. Off a split row the row
    gather itself; on one, the distinct rows are gathered (their partials
    OR-merged over the row's processes: ``[U, C]``, not ``[n, C]``) and
    each lane takes its row from them through the row gather."""
    if not _split_view(view):
        return gather_rows(view, ids)
    uniq, inv = torch.unique(ids, return_inverse=True)
    return gather_rows(gather_rows(view, uniq), inv)


def _held(view, rows: torch.Tensor) -> Optional[torch.Tensor]:
    """Which of ``rows`` lie in a shard of the view held here (None when
    every shard is)."""
    if not _split_view(view):
        return None
    rps = view.rows_per_shard
    held = torch.tensor([t is not None for t in view.shards],
                        device=rows.device)
    return held[(rows // rps).clamp_max(len(view.shards) - 1)]


def _elements(view, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``view[rows[i], cols[i]]`` of a ``[R, C]`` table view (int64
    indices on the caller's device), each read from the shard that owns
    its row, in plain torch: the mh sampler's single-element reads. A row
    of a shard another process holds reads as some element of a held
    shard (:func:`_held` says which lanes are right)."""
    if not isinstance(view, ShardedParam):
        return view.view(view.shape[0], -1)[rows, cols]
    rps, out = view.rows_per_shard, None
    for s, shard in enumerate(view.shards):
        if shard is None:
            continue
        local = rows - s * rps
        vals = shard.view(rps, -1)[local.clamp(0, rps - 1).to(shard.device),
                                   cols.to(shard.device)].to(rows.device)
        # every row lies in one shard: the first shard's reads of the
        # other rows are overwritten by their owners'
        out = vals if out is None else torch.where(
            (local >= 0) & (local < rps), vals, out)
    return out


class LightLDA:
    """The app: count tables + the Gibbs-sweep superstep, on ``mesh``
    (default: the runtime's) or the (1, 1) mesh of ``device``."""

    def __init__(self, token_words: np.ndarray, token_docs: np.ndarray,
                 vocab_size: int, config: LDAConfig, *,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None,
                 name: str = "lightlda") -> None:
        self.config = c = config
        self.mesh = core.resolve_mesh(mesh, device)
        # this process's first device of its first data row (of its
        # first local replica): its constants, draws and host reads
        self.device = dev = self.mesh.row_device(self.mesh.local_rows[0])
        self.n_replicas = D = self.mesh.shape[core.DATA_AXIS]
        # each local replica's first device: its locals, constants and
        # draws (every replica's on one process)
        self._devs = [self.mesh.row_device(d) for d in self.mesh.local_rows]
        self.V = vocab_size
        self.K = c.num_topics
        self.num_docs = int(token_docs.max()) + 1 if len(token_docs) else 1
        self.num_tokens = len(token_words)
        if c.local_corpus and not c.stream_blocks:
            raise ValueError("local_corpus requires stream_blocks=True")
        if c.local_corpus and self.mesh.processes > 1:
            # per-process corpus shards: agree on the global doc-id space
            # and token count (loglik normalisation, count invariants)
            # before any geometry is derived
            from multiverso_tpu_torch.parallel.multihost import \
                allgather_i64
            g = allgather_i64([self.num_docs, self.num_tokens])
            self.num_docs = int(g[:, 0].max())
            self.num_tokens = int(g[:, 1].sum())
        if c.sampler not in ("gibbs", "mh", "tiled"):
            raise ValueError(f"sampler must be 'gibbs', 'mh' or 'tiled', "
                             f"got {c.sampler!r}")
        if c.sampler == "mh" and len(token_docs) \
                and np.any(np.diff(token_docs) < 0):
            # doc_start offsets (the doc proposal) assume a doc-contiguous
            # stream; an interleaved one would sample another doc's topics
            raise ValueError("token_docs must be doc-contiguous "
                             "(non-decreasing doc ids) for sampler='mh'")
        if c.precision not in ("float32", "bfloat16"):
            raise ValueError(f"precision must be 'float32' or 'bfloat16', "
                             f"got {c.precision!r}")
        self.alpha = c.resolved_alpha()
        self.beta = c.beta
        tiled = c.sampler == "tiled"
        if tiled and self.K % 128:
            raise ValueError(f"sampler='tiled' needs num_topics % 128 "
                             f"== 0, got {self.K}")
        if (c.stale_words or c.doc_blocked) and not tiled:
            raise ValueError(
                f"stale_words/doc_blocked are sampler='tiled' modes; "
                f"got sampler={c.sampler!r}")
        if c.stream_blocks and not c.doc_blocked:
            raise ValueError("stream_blocks requires doc_blocked=True")
        if c.batch_tokens % D:
            raise ValueError(f"batch_tokens {c.batch_tokens} not divisible "
                             f"by data-axis size {D}")

        # tables (the reference's server-side state); tiled storage puts
        # one word's topic row in one [C, 128] tile
        self.word_topic = SparseMatrixTable(
            self.V, self.K, "int32", updater="default", mesh=self.mesh,
            name=f"{name}_word_topic", tiled=tiled)
        self.summary = ArrayTable(self.K, "int32", updater="default",
                                  mesh=self.mesh, name=f"{name}_summary")
        # MVTPU_STALENESS=S: word_topics() reads a bounded-staleness
        # cached view of the word table (logging / eval reads skip the
        # blocking whole-table fetch)
        self._wt_view = client.maybe_cached_view(self.word_topic)
        self._scratch_word = self.word_topic.padded_shape[0] - 1
        self._scratch_doc = self.num_docs
        self._docblock = tiled and c.doc_blocked
        self._stale = tiled and (c.stale_words or c.doc_blocked)
        ndk_dtype = torch.int32
        if self._stale:
            max_len = int(np.bincount(token_docs).max()) \
                if len(token_docs) else 0
            if max_len >= 32767:
                raise ValueError(
                    f"stale_words stores doc counts int16; a document "
                    f"has {max_len} tokens (>= 32767)")
            ndk_dtype = torch.int16
        self._ndk_dtype = ndk_dtype
        self._calls_done = 0
        self.ll_history: list = []
        self.doc_tokens_per_sec = 0.0   # of the last train()
        self._last_store = ()
        # fault tolerance (ft.checkpoint.wire_app): the run checkpoint
        # manager and the sweep cursor; the restored offset is consumed by
        # the FIRST train() after a resume
        self.run_ckpt = None
        self._sweep_done = 0
        self._resume_sweeps = 0
        if self._docblock:
            self._setup_docblock(token_words, token_docs, ndk_dtype)
            if c.stream_blocks:
                self._init_streamed_counts()
                self._fused = make_superstep((self.summary,),
                                             self._stream_body,
                                             name="lda_docblock_stream")
            else:
                self._fused = make_superstep((self.summary,),
                                             self._docblock_body,
                                             name="lda_docblock")
            return

        self._ndk_shape = (self.num_docs + 1, self.K // 128, 128) if tiled \
            else (self.num_docs + 1, self.K)
        # token stream, padded to a whole number of superstep calls
        call_tokens = c.batch_tokens * c.steps_per_call
        T_pad = -(-max(self.num_tokens, 1) // call_tokens) * call_tokens
        mask = np.zeros(T_pad, bool)
        mask[: self.num_tokens] = True
        tw = np.full(T_pad, self._scratch_word, np.int32)
        tw[: self.num_tokens] = token_words
        td = np.full(T_pad, self._scratch_doc, np.int32)
        td[: self.num_tokens] = token_docs
        # shuffle the stream: doc-contiguous order would put a whole doc
        # in one batch, zeroing its doc-topic row under the batch-stale
        # decrement; a fixed permutation spreads each doc/word over the
        # sweep (padded lanes shuffle in too, masked)
        perm = np.random.default_rng(c.seed ^ 0x5EED).permutation(T_pad)
        host = dict(tw=tw[perm], td=td[perm],
                    mask=mask[perm].astype(np.int32))
        if c.sampler == "mh":
            # the doc proposal's z-array trick: the stream is doc-
            # contiguous (checked above), so doc d's tokens sit at original
            # positions [doc_start[d], doc_start[d] + doc_len[d]); inv_perm
            # maps an original position to its shuffled one (z's index).
            # One scratch-doc entry covers the padding
            doc_len = np.bincount(token_docs, minlength=self.num_docs) \
                if len(token_docs) else np.zeros(self.num_docs, np.int64)
            doc_len = np.append(doc_len, max(T_pad - self.num_tokens, 1))
            host.update(
                doc_len=doc_len.astype(np.int32),
                doc_start=np.concatenate([[0], np.cumsum(doc_len)])[:-1]
                .astype(np.int32),
                inv_perm=np.argsort(perm).astype(np.int32))
        # the whole stream on each replica's device (read-only: replicas
        # on one device share it)
        per_dev: dict = {}
        self._consts = [per_dev.setdefault(d, {
            k: torch.as_tensor(v, device=d) for k, v in host.items()})
            for d in self._devs]
        self._tw, self._td, self._mask = (self._consts[0][k]
                                          for k in ("tw", "td", "mask"))
        self.calls_per_sweep = T_pad // call_tokens
        rng = np.random.default_rng(c.seed)
        z0 = torch.as_tensor(rng.integers(0, self.K, T_pad).astype(np.int32),
                             device=dev)
        self._z_l = Replicated.of(z0, self.mesh)
        self._init_counts()
        if tiled:
            self._fused = make_superstep(
                (self.summary,) if self._stale
                else (self.word_topic, self.summary),
                self._tiled_body,
                name="lda_tiled_stale" if self._stale else "lda_tiled")
        elif c.sampler == "mh":
            self._fused = make_superstep((self.word_topic, self.summary),
                                         self._mh_body, name="lda_mh")
        else:
            self._fused = make_superstep((self.word_topic, self.summary),
                                         self._gibbs_body, name="lda_gibbs")

    # -- doc-blocked stream / state ---------------------------------------

    def _setup_docblock(self, token_words, token_docs, ndk_dtype) -> None:
        """Pack the doc-sorted stream into whole-doc kernel blocks and
        build the blocked doc-topic counts (see LDAConfig.doc_blocked)."""
        c = self.config
        TB, MAXD = c.block_tokens, c.block_docs
        B, S = c.batch_tokens, c.steps_per_call
        if TB % 8 or B % TB:
            raise ValueError(f"block_tokens {TB} must be a multiple of 8 "
                             f"dividing batch_tokens {B}")
        nbs = B // TB                       # blocks per step
        if nbs % self.n_replicas:
            raise ValueError(f"doc_blocked: blocks per step {nbs} not "
                             f"divisible by data-axis size "
                             f"{self.n_replicas}")
        order = np.argsort(token_docs, kind="stable")
        tw, td = token_words[order], token_docs[order]
        doc_ids, doc_starts = np.unique(td, return_index=True) \
            if len(td) else (np.zeros(0, np.int64), np.zeros(0, np.int64))
        doc_ends = np.append(doc_starts[1:], len(td)) if len(td) \
            else doc_starts
        lens = doc_ends - doc_starts
        if len(lens) and lens.max() > TB:
            raise ValueError(f"a document has {lens.max()} tokens > "
                             f"block_tokens {TB}")
        # greedy whole-doc block assignment (a scalar loop over doc
        # lengths; the token-level copy below is vectorized)
        n_real = len(doc_ids)
        blk = np.empty(n_real, np.int64)
        row = np.empty(n_real, np.int64)
        off = np.empty(n_real, np.int64)
        b = 0
        cur_r = cur_tok = 0
        for di, ln in enumerate(lens.tolist()):
            if cur_tok + ln > TB or cur_r >= MAXD:
                b += 1
                cur_r = cur_tok = 0
            blk[di], row[di], off[di] = b, cur_r, cur_tok
            cur_r += 1
            cur_tok += ln
        n_blocks = (b + 1) if n_real else 1
        per_call = S * nbs
        self._per_call, self._nbs = per_call, nbs
        self._tb, self._maxd = TB, MAXD
        local = c.stream_blocks and c.local_corpus
        if local:
            # per-process corpus shard: this process packs its docs into
            # ONLY the block slots its replicas own; the other processes
            # fill the rest of the global block space
            self._own_offs = self._owned_call_offsets()
            self._own_per_call = cap = len(self._own_offs)
            n_calls = -(-n_blocks // cap)
            if self.mesh.processes > 1:
                from multiverso_tpu_torch.parallel.multihost import (
                    allgather_i64, validate_single_owner)
                mask = np.zeros(per_call, np.int32)
                mask[self._own_offs] = 1
                validate_single_owner(mask, "local_corpus")
                n_calls = int(allgather_i64([n_calls]).max())
        else:
            cap = per_call
            n_calls = -(-n_blocks // cap)
        nb_alloc = n_calls * cap            # blocks on THIS process
        nb_pad = n_calls * per_call         # the global padded block count
        self.calls_per_sweep = n_calls
        self._nb_pad = nb_pad

        tw_p = np.full((nb_alloc, TB), self._scratch_word, np.int32)
        drel_p = np.full((nb_alloc, TB), MAXD - 1, np.int32)
        mask_p = np.zeros((nb_alloc, TB), np.int32)
        # -1 = document with zero tokens (never packed into any block)
        self._blk_of_doc = np.full(self.num_docs, -1, np.int64)
        self._row_of_doc = np.full(self.num_docs, -1, np.int64)
        if n_real:
            tok_within = np.arange(len(td), dtype=np.int64) \
                - np.repeat(doc_starts, lens)
            flat = np.repeat(blk * TB + off, lens) + tok_within
            tw_p.reshape(-1)[flat] = tw
            drel_p.reshape(-1)[flat] = np.repeat(row, lens)
            mask_p.reshape(-1)[flat] = 1
            self._blk_of_doc[doc_ids] = blk
            self._row_of_doc[doc_ids] = row
        self.packing_fill = float(mask_p.sum() / max(nb_alloc * TB, 1))
        log.info("lda doc_blocked: %d blocks (%d/call, %.0f%% fill)",
                 nb_alloc, cap, 100 * self.packing_fill)
        # init z, shared by both residency modes so the streamed and
        # in-memory runs are bit-identical for the same seed; local mode
        # hashes (seed, GLOBAL block, position) instead, so a slot's
        # draw does not depend on the process that owns it
        if local:
            z0 = _hash_z(c.seed, self._global_of_local(
                np.arange(nb_alloc, dtype=np.int64)), TB, self.K)
        else:
            rng = np.random.default_rng(c.seed)
            z0 = rng.integers(0, self.K, (nb_pad, TB)).astype(np.int32)
        dev = self.device
        if c.stream_blocks:
            self._tw_host, self._drel_host, self._z_host = tw_p, drel_p, z0
            self._z_synced = True    # the initial z is globally complete
            self._z_l = self._ndk_l = None
            # inverse packing map for doc_topics(): (block, row) -> doc
            self._doc_of_row = np.full((nb_alloc, MAXD), -1, np.int64)
            valid = self._blk_of_doc >= 0
            self._doc_of_row[self._blk_of_doc[valid],
                             self._row_of_doc[valid]] = np.nonzero(valid)[0]
            return

        self._tw = torch.as_tensor(tw_p, device=dev)
        self._drel = torch.as_tensor(drel_p, device=dev)
        self._mask = torch.as_tensor(mask_p, device=dev)
        # eval-only doc-count rows of each token
        self._rows = torch.as_tensor(
            (np.arange(nb_pad)[:, None] * MAXD + drel_p).astype(np.int32),
            device=dev)
        # each replica's blocks of the stream (the whole of it on one)
        parts = {k: self._split_blocks(v) for k, v in
                 (("tw", self._tw), ("drel", self._drel),
                  ("mask", self._mask))}
        self._consts = [{k: v[d] for k, v in parts.items()}
                        for d in range(len(self._devs))]
        self._ndk_shape = (nb_pad, MAXD, self.K // 128, 128)
        self._z_l = DataSplit(self._split_blocks(
            torch.as_tensor(z0, device=dev)))
        self._word_counts_from_z()
        K = self.K
        rows, z, mask = (t.view(-1) for t in (self._rows, self._z,
                                               self._mask))
        ndk = torch.zeros(nb_pad * MAXD, K, dtype=torch.int32, device=dev)
        ndk.view(-1).index_add_(0, rows.long() * K + z.long(), mask)
        self._set_ndk(ndk.to(ndk_dtype).view(self._ndk_shape))
        nk = torch.zeros(self.summary.padded_shape, dtype=torch.int32,
                         device=dev)
        nk.index_add_(0, z.long(), mask)
        self.summary.put_raw(nk)

    def _split_blocks(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A doc-blocked array ``[nb_pad, ...]`` as the parts the replicas
        own: of each step's ``nbs`` blocks, replica ``d`` owns the
        contiguous ``q = nbs / D`` blocks ``d`` (the reference's blocks
        split over ``data``), step after step, ``[steps * q, ...]`` on its
        device (this process's replicas' parts). One replica owns all of
        ``x``."""
        D = self.n_replicas
        if D == 1:
            return [x]
        tail = tuple(x.shape[1:])
        steps = x.view(-1, D, self._nbs // D, *tail)
        return [steps[:, d].reshape((-1,) + tail).to(dev)
                for d, dev in zip(self.mesh.local_rows, self._devs)]

    def _join_blocks(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The inverse of :meth:`_split_blocks`, on the first device; over
        several processes the other processes' parts come over the group
        (a collective)."""
        if self.n_replicas == 1:
            return parts[0]
        parts = self._every_row(parts)
        tail = tuple(parts[0].shape[1:])
        q = self._nbs // len(parts)
        return torch.stack([p.to(self.device).view(-1, q, *tail)
                            for p in parts], 1).reshape((-1,) + tail)

    @property
    def _rows_everywhere(self) -> bool:
        """True when every process holds every data row (one process, or
        a data axis of 1): no row's state need cross processes."""
        m = self.mesh
        return all(len(m.rows_of(p)) == self.n_replicas
                   for p in range(m.processes))

    def _every_row(self, parts: list) -> list:
        """Every data row's part, in row order, given this process's
        replicas' ``parts``: its own, and the others from the first
        process that owns a cell of each row, over the group (a
        collective unless every process holds every row; a row two
        processes share is sent once)."""
        m = self.mesh
        if self._rows_everywhere:
            return list(parts)
        from multiverso_tpu_torch.parallel.multihost import \
            allgather_tensors
        rows_of = [m.rows_of(p) for p in range(m.processes)]
        source = [min(p for p, rows in enumerate(rows_of) if g in rows)
                  for g in range(self.n_replicas)]
        sent = [[g for g in rows if source[g] == p]
                for p, rows in enumerate(rows_of)]
        got = allgather_tensors([parts[m.local_rows.index(g)]
                                 for g in sent[m.rank]])
        return [parts[m.local_rows.index(g)] if g in m.local_rows
                else got[source[g]][sent[source[g]].index(g)]
                for g in range(self.n_replicas)]

    # -- sampler state: z and the doc-topic counts (app-local) -------------

    @property
    def _z(self) -> torch.Tensor:
        """z in the (1, 1) layout, on the first device (replica 0's, or
        the replicas' blocks joined)."""
        if self._docblock:
            return self._join_blocks(self._z_l.parts)
        return self._z_l.parts[0]

    @property
    def _ndk(self) -> torch.Tensor:
        """The doc-topic counts in the (1, 1) layout, on the first
        device."""
        if self._docblock:
            return self._join_blocks(self._ndk_l.parts)
        return self._ndk_l.parts[0]

    def _set_z(self, z: torch.Tensor) -> None:
        self._z_l = DataSplit(self._split_blocks(z)) if self._docblock \
            else Replicated.of(z, self.mesh)

    def _set_ndk(self, ndk: torch.Tensor) -> None:
        self._ndk_l = DataSplit(self._split_blocks(ndk)) \
            if self._docblock else Replicated.of(ndk, self.mesh)

    def _token_lanes(self) -> list:
        """(words, topics, mask) of every token, on each local replica's
        device: its own whole stream, or every replica's blocks (over
        several processes, the whole stream in the (1, 1) layout, joined
        once: the int32 counts do not depend on the lanes' order)."""
        if not self._docblock:
            return [(k["tw"], z, k["mask"])
                    for k, z in zip(self._consts, self._z_l.parts)]
        if self.mesh.processes > 1:
            whole = [t.reshape(-1) for t in (self._tw, self._z, self._mask)]
        else:
            whole = [torch.cat([p.reshape(-1).to(self.device)
                                for p in parts])
                     for parts in ([k["tw"] for k in self._consts],
                                   self._z_l.parts,
                                   [k["mask"] for k in self._consts])]
        return [tuple(t.to(dev) for t in whole) for dev in self._devs]

    def _zero_word_views(self) -> list:
        """A zero word table for each replica, in the form its superstep
        view takes (a tensor, or a ShardedParam of the shards held
        here)."""
        views = []
        for devs in self.word_topic.replica_devices:
            shards = core.sharded_zeros(self.word_topic.storage_shape,
                                        torch.int32, devs)
            views.append(shards[0] if len(shards) == 1
                         else ShardedParam(shards, self.word_topic._merger))
        return views

    def _word_counts_from_z(self) -> None:
        """Install the word-topic counts of z on every replica: one COO add
        of (word, topic, mask) per token into a zero table (the mesh form
        on a split one, over the shards held here)."""
        views = self._zero_word_views()
        for view, lanes in zip(views, self._token_lanes()):
            tk.coo_scatter_add(view, *lanes)
        self.word_topic.put_views(views)

    def _init_counts(self) -> None:
        """Counts of the initial z (shuffled-stream modes)."""
        self._word_counts_from_z()
        K = self.K
        z = self._z
        ndk = torch.zeros(self._ndk_shape[0], K, dtype=torch.int32,
                          device=self.device)
        ndk.view(-1).index_add_(0, self._td.long() * K + z.long(),
                                self._mask)
        self._set_ndk(ndk.to(self._ndk_dtype).view(self._ndk_shape))
        nk = torch.zeros(self.summary.padded_shape, dtype=torch.int32,
                         device=self.device)
        nk.index_add_(0, z.long(), self._mask)
        self.summary.put_raw(nk)

    # -- draws ---------------------------------------------------------------

    def _generator(self, call_no: int, stream: int) -> torch.Generator:
        return core.generator(self.config.seed * 0x9E3779B1 + call_no
                              + (stream << 48), device=self.device)

    def uniforms(self, call_no: int) -> torch.Tensor:
        """The call's uniforms, ``[S, n, B]`` float32 (n = 1 for gibbs, 2
        for the kernel samplers, 5 per round for mh: the word proposal's
        target and acceptance, the doc proposal's slot, mixture choice and
        acceptance), drawn on the device from a generator seeded by (seed,
        call number)."""
        c = self.config
        n = {"gibbs": 1, "mh": 5 * c.mh_steps}.get(c.sampler, 2)
        return torch.rand((c.steps_per_call, n, c.batch_tokens),
                          generator=self._generator(call_no, 0),
                          device=self.device)

    def integers(self, call_no: int) -> torch.Tensor:
        """mh: the call's uniform topics of the doc proposals, ``[S,
        mh_steps, B]`` int32 in ``[0, K)``, from a generator of its own."""
        c = self.config
        return torch.randint(0, self.K, (c.steps_per_call, c.mh_steps,
                                         c.batch_tokens),
                             generator=self._generator(call_no, 1),
                             device=self.device, dtype=torch.int32)

    def _call_draws(self, uniforms: Optional[Uniforms],
                    integers: Optional[Integers]) -> list:
        """The next call's draws (the app's own, or the caller's), each
        split over the data axis along its lanes."""
        call_no = self._calls_done
        self._calls_done += 1
        u = self.uniforms(call_no) if uniforms is None else core.place(
            uniforms(call_no), dtype=torch.float32, device=self.device)
        draws = [u]
        if self.config.sampler == "mh":
            draws.append(self.integers(call_no) if integers is None
                         else core.place(integers(call_no),
                                         dtype=torch.int32,
                                         device=self.device))
        if self.n_replicas > 1:
            draws = [DataSplit.of(x, self.mesh, axis=2) for x in draws]
        return draws

    def _sinv(self, nk: torch.Tensor) -> torch.Tensor:
        """1 / (summary + V*beta) as the kernels' [C, 128] float32."""
        return 1.0 / (nk[:self.K].to(torch.float32).view(-1, 128)
                      + self.V * self.beta)

    # -- superstep bodies --------------------------------------------------
    #
    # A body runs once per replica (once off a data axis). In the shuffled-
    # stream modes ``lo`` is the call's first stream position; the replica
    # samples its lanes ``mine`` of each step and moves every lane's counts.

    def _lanes(self, u: torch.Tensor) -> Tuple[dict, slice]:
        """The running replica's constants and its lanes of a step."""
        d = replica_index()
        b = u.shape[-1]
        return self._consts[local_replica_index()], slice(d * b, (d + 1) * b)

    @staticmethod
    def _move(nwk, ndk, nk, w, d, topics, delta) -> None:
        """Every lane's count move of one step, on this replica's copies:
        the word counts through the COO kernel, the doc counts and the
        summary in plain torch."""
        tk.coo_scatter_add(nwk, w, topics, delta)
        t = topics.long()
        ndk.index_put_((d.long(), t), delta, accumulate=True)
        nk.index_add_(0, t, delta)

    def _gibbs_body(self, params, states, locals_, options, lo: int, u):
        """Exact collapsed Gibbs, plain torch: S steps of B tokens from
        stream position ``lo``."""
        c = self.config
        nwk, nk = params[0], _whole(params[1])
        ndk, z = locals_
        k, mine = self._lanes(u)
        K, B = self.K, c.batch_tokens
        vbeta = self.V * self.beta
        ft = torch.bfloat16 if c.precision == "bfloat16" else torch.float32
        for s in range(c.steps_per_call):
            sl = slice(lo + s * B, lo + (s + 1) * B)
            w, d, one = k["tw"][sl], k["td"][sl], k["mask"][sl]
            zi = z[sl]
            # remove the batch's own counts (proper collapsed Gibbs)
            self._move(nwk, ndk, nk, w, d, zi, -one)
            A = ndk.index_select(0, d[mine].long()).to(ft)
            W = _read_rows(nwk, w[mine]).to(ft)
            Sd = (nk[:K].to(torch.float32) + vbeta).to(ft)
            # linear-space posterior + inverse-CDF draw; batch-stale
            # decrements can dip below zero: clamp (AD-LDA)
            probs = torch.clamp_min((A + self.alpha) * (W + self.beta),
                                    0.0) / Sd
            cdf = torch.cumsum(probs, 1)
            t = u[s, 0].to(ft)[:, None] * cdf[:, -1:]
            znew = replica_cat((cdf < t).sum(1).clamp_max(K - 1)
                               .to(torch.int32))
            self._move(nwk, ndk, nk, w, d, znew, one)
            z[sl] = znew
        return (nwk, nk), states, (ndk, z), None

    def _mh_body(self, params, states, locals_, options, lo: int, u, ints,
                 wcdf, nwk_stale):
        """LightLDA's Metropolis-Hastings sampler (the reference's
        ``_build_mh_superstep``): per step the batch's own counts leave
        the tables, then ``mh_steps`` rounds of a word proposal and a doc
        proposal, each accepted against the live counts; ``wcdf`` and
        ``nwk_stale`` are the sweep's stale word CDF and counts. No
        ``[B, K]`` tensor: every count is a single-element read. On a row
        split over processes each lane's proposals run on the process
        that holds its word row, and their outcomes merge (module doc)."""
        c = self.config
        nwk, nk = params[0], _whole(params[1])
        ndk, z = locals_
        k, mine = self._lanes(u)
        K, B = self.K, c.batch_tokens
        alpha, beta, vbeta = self.alpha, self.beta, self.V * self.beta
        f32 = torch.float32
        # K * alpha as the reference's float32 operand
        ka = torch.tensor(K * alpha, dtype=f32, device=u.device)
        n_search = max(1, (K - 1).bit_length())
        last = torch.full((u.shape[-1],), K - 1, dtype=torch.long,
                          device=u.device)
        for s in range(c.steps_per_call):
            sl = slice(lo + s * B, lo + (s + 1) * B)
            w_all, d_all, one = k["tw"][sl], k["td"][sl], k["mask"][sl]
            zi_all = z[sl]
            self._move(nwk, ndk, nk, w_all, d_all, zi_all, -one)
            w, d, zi = (x[mine].long() for x in (w_all, d_all, zi_all))
            own = _held(nwk, w)

            def settle(t):
                # the topics of the lanes whose word row is held here,
                # OR-merged with the other processes' (zero bits for the
                # lanes they do not hold)
                if own is None:
                    return t
                t = torch.where(own, t, 0).to(torch.int32)
                nwk.merge((t,))
                return t.long()

            def p_live(t):
                # the collapsed posterior from the LIVE counts (own token
                # removed); transient negatives clamped (AD-LDA)
                return (torch.clamp_min(ndk[d, t].to(f32) + alpha, 1e-12)
                        * torch.clamp_min(_elements(nwk, w, t).to(f32)
                                          + beta, 1e-12)
                        / torch.clamp_min(nk[t].to(f32) + vbeta, 1e-12))

            def q_word(t):
                # the stale proposal density, from the pre-sweep counts
                return _elements(nwk_stale, w, t).to(f32) + beta

            def q_doc(t):
                # the z-array density: z still holds the own topic zi
                return ndk[d, t].to(f32) + (t == zi).to(f32) + alpha

            cur = zi
            wtot = _elements(wcdf, w, last)
            dlen = k["doc_len"][d].to(f32)
            dstart = k["doc_start"][d].long()
            for r in range(c.mh_steps):
                u_target, u_word, u_slot, u_mix, u_doc = u[s, 5 * r:5 * r + 5]
                # word proposal: binary search of the stale CDF
                target = u_target * wtot
                low, high = torch.zeros_like(cur), torch.full_like(cur, K)
                for _ in range(n_search):
                    mid = (low + high) // 2
                    go = _elements(wcdf, w, mid.clamp_max(K - 1)) < target
                    low = torch.where(go, mid + 1, low)
                    high = torch.where(go, high, mid)
                prop = low.clamp(0, K - 1)
                ratio = p_live(prop) * q_word(cur) \
                    / (p_live(cur) * q_word(prop))
                cur = settle(torch.where(u_word < ratio, prop, cur))
                # doc proposal: a random slot of the doc's tokens, or
                # (with the alpha mass) a uniform topic
                pa = ka / (dlen + ka)
                slot = torch.minimum((u_slot * dlen).to(torch.int32),
                                     torch.clamp_min(dlen.to(torch.int32)
                                                     - 1, 0))
                zslot = z[k["inv_perm"][dstart + slot].long()].long()
                prop = torch.where(u_mix < pa, ints[s, r].long(), zslot)
                ratio = p_live(prop) * q_doc(cur) / torch.clamp_min(
                    p_live(cur) * q_doc(prop), 1e-20)
                cur = settle(torch.where(u_doc < ratio, prop, cur))
            znew = replica_cat(torch.where(one[mine] > 0, cur, zi)
                               .to(torch.int32))
            self._move(nwk, ndk, nk, w_all, d_all, znew, one)
            z[sl] = znew
        return (nwk, nk), states, (ndk, z), None

    def _tiled_body(self, params, states, locals_, options, lo: int, u,
                    wstale=None):
        """The sampler kernel over tile-aligned counts: S steps of B
        tokens from stream position ``lo``. Exact mode moves the word
        counts by one COO add per step; stale mode (``wstale``, the bf16
        mirror) leaves them to the sweep-end rebuild."""
        c = self.config
        K, B = self.K, c.batch_tokens
        nk = _whole(params[-1])
        ndk3, z = locals_
        nwk3 = None if wstale is not None else params[0]
        k, mine = self._lanes(u)
        b = u.shape[-1]
        ndk_flat = ndk3.view(-1)
        for s in range(c.steps_per_call):
            sl = slice(lo + s * B, lo + (s + 1) * B)
            w, d, msk = k["tw"][sl], k["td"][sl], k["mask"][sl]
            zi = z[sl]
            W3 = _read_rows(nwk3 if wstale is None else wstale, w[mine])
            A3 = gather_rows(ndk3, d[mine])
            znew, nkd = gibbs_sample_tiled(
                A3.view(b, -1, 128), W3.view(b, -1, 128), self._sinv(nk),
                zi[mine], msk[mine], u[s, 0], u[s, 1], alpha=self.alpha,
                beta=self.beta)
            znew = replica_cat(znew)
            one = msk.to(ndk3.dtype)
            dk = d.long() * K
            ndk_flat.index_add_(0, dk + zi.long(), -one)
            ndk_flat.index_add_(0, dk + znew.long(), one)
            nk[:K] += replica_sum(nkd).view(-1)
            if nwk3 is not None:
                tk.coo_scatter_add(nwk3, torch.cat([w, w]),
                                   torch.cat([zi, znew]),
                                   torch.cat([-msk, msk]))
            z[sl] = znew
        new = (nk,) if nwk3 is None else (nwk3, nk)
        return new, states, (ndk3, z), None

    def _docblock_body(self, params, states, locals_, options, t0: int, u,
                       wstale):
        """The production step: per step ``t0 + s``, the doc-blocked
        kernel over this replica's ``q`` blocks of the step, which reads
        the tokens' word rows from the bf16 mirror itself (on a split
        mirror, from rows the mesh gather fetched) and moves their doc
        counts in place."""
        c = self.config
        nk = _whole(params[0])
        ndk, z = locals_
        k = self._consts[local_replica_index()]
        TB = self._tb
        q = self._nbs // self.n_replicas
        b = q * TB
        for s in range(c.steps_per_call):
            blocks = slice((t0 + s) * q, (t0 + s + 1) * q)
            words = k["tw"][blocks].reshape(b)
            W = wstale
            if isinstance(wstale, ShardedParam):
                W, words = gather_rows(wstale, words).view(b, -1, 128), None
            _, znew, nkd = gibbs_sample_docblock(
                ndk[blocks], W, self._sinv(nk), z[blocks].reshape(b),
                k["drel"][blocks].reshape(b), k["mask"][blocks].reshape(b),
                u[s, 0], u[s, 1], alpha=self.alpha, beta=self.beta, tb=TB,
                words=words)
            z[blocks] = znew.view(q, TB)
            nk[:self.K] += replica_sum(nkd).view(-1)
        return (nk,), states, (ndk, z), None

    def _stream_body(self, params, states, locals_, options, wstale,
                     staged, u):
        """One staged call of the out-of-core mode on one replica:
        ``staged`` [3, S, b] holds (words, doc rows, z) of its ``q`` blocks
        of every step (all of them off a data axis). The kernel builds
        each block's doc counts from z, reading its word rows from the
        mirror itself (``words=``), or from rows the mesh gather fetched
        off a split mirror; the call's word counts, every replica's lanes,
        are added to ``acc``, which after a sweep IS the new word table
        (the per-call +/- deltas of an incremental update telescope to
        counts(z_end)). Returns every replica's new z as aux, ``[D, S,
        b]`` in replica order."""
        c = self.config
        nk = _whole(params[0])
        (acc,) = locals_
        S, TB = c.steps_per_call, self._tb
        q = self._nbs // self.n_replicas
        b = q * TB
        tw, drel = staged[0], staged[1]
        msk = (tw != self._scratch_word).to(torch.int32)
        z = staged[2].reshape(S * q, TB)
        for s in range(S):
            blocks = slice(s * q, (s + 1) * q)
            W, words = wstale, tw[s]
            if isinstance(wstale, ShardedParam):
                W, words = gather_rows(wstale, words).view(b, -1, 128), None
            znew, nkd = gibbs_sample_docblock_build(
                W, self._sinv(nk), z[blocks].reshape(b), drel[s], msk[s],
                u[s, 0], u[s, 1], alpha=self.alpha, beta=self.beta, tb=TB,
                maxd=self._maxd, words=words)
            z[blocks] = znew.view(q, TB)
            nk[:self.K] += replica_sum(nkd).view(-1)
        # every replica's (word, topic) lanes, in replica order
        lanes = replica_cat(torch.stack([tw.reshape(-1), z.reshape(-1)]
                                        ).view(1, 2, -1))
        tw_all, z_all = lanes[:, 0].reshape(-1), lanes[:, 1].reshape(-1)
        tk.coo_scatter_add(acc, tw_all, z_all,
                           (tw_all != self._scratch_word).to(torch.int32))
        return (nk,), states, (acc,), lanes[:, 1].view(-1, S, b)

    # -- out-of-core (streamed) doc-blocked mode ---------------------------

    def _block_rows(self, k: int, d: int) -> np.ndarray:
        """The global blocks of replica ``d``'s lanes of call ``k``, ``[S,
        q]``: of step s, blocks ``d * q .. (d + 1) * q - 1`` (the
        reference's ``_block_rows``, the one (step, lane) -> block map
        that staging, the z readback and the z sync share; under
        local_corpus :meth:`_local_of_global` maps it to the host
        arrays)."""
        q = self._nbs // self.n_replicas
        return (k * self._per_call
                + np.arange(self.config.steps_per_call)[:, None] * self._nbs
                + d * q + np.arange(q)[None, :])

    def _owned_call_offsets(self) -> np.ndarray:
        """The sorted per-call block offsets this process's replicas own
        (call 0's global blocks are the offsets)."""
        return np.sort(np.concatenate([
            self._block_rows(0, d).reshape(-1)
            for d in self.mesh.local_rows])).astype(np.int64)

    def _global_of_local(self, l: np.ndarray) -> np.ndarray:
        """local_corpus: host-array block index -> global block id (the
        identity otherwise: the host arrays are globally indexed)."""
        if not (self.config.stream_blocks and self.config.local_corpus):
            return l
        k, pos = np.divmod(l, self._own_per_call)
        return k * self._per_call + self._own_offs[pos]

    def _local_of_global(self, g: np.ndarray) -> np.ndarray:
        """local_corpus: global block id -> host-array index, for blocks
        this process owns (the identity otherwise)."""
        if not (self.config.stream_blocks and self.config.local_corpus):
            return g
        k, off = np.divmod(g, self._per_call)
        return k * self._own_per_call + np.searchsorted(self._own_offs,
                                                        off)

    def _stream_stage(self, k: int) -> np.ndarray:
        """Host side of staging call ``k``: one stacked int32 array
        ``[n, 3, S, b]``, each of this process's n replicas' (words, doc
        rows, z) of its lanes of every step (``[1, 3, S, B]``, the whole
        call, off a data axis). The host never reads another process's
        lanes."""
        S = self.config.steps_per_call
        out = []
        for d in self.mesh.local_rows:
            rows = self._local_of_global(self._block_rows(k, d))
            out.append(np.stack([h[rows].reshape(S, -1) for h in (
                self._tw_host, self._drel_host, self._z_host)]))
        return np.stack(out)

    def _stream_calls(self):
        """Double-buffered staging: host slices are stacked on a prefetch
        thread and copied to each replica's device (asynchronously from
        pinned memory on a card), so call k+1's copy overlaps call k's
        sweep. Yields ``(k, DataSplit of the replicas' [3, S, b])``."""
        def gen():
            for k in range(self.calls_per_sweep):
                host = torch.from_numpy(self._stream_stage(k))
                if self.device.type == "cuda":
                    host = host.pin_memory()
                yield k, host

        for k, host in prefetch_iterator(gen(), depth=2):
            yield k, DataSplit([host[d].to(dev, non_blocking=True)
                                for d, dev in enumerate(self._devs)])

    def _whole_call(self, staged: DataSplit) -> torch.Tensor:
        """A staged call as ``[3, S, n * b]`` on the first device, this
        process's n replicas' lanes joined along each step (the whole
        ``[3, S, B]`` call on one process)."""
        return torch.cat([p.to(self.device) for p in staged.parts], 2)

    def _all_parts(self, staged: DataSplit) -> list:
        """Every replica's ``[3, S, b]`` part of a staged call, in replica
        order: this process's, and over several processes the others'
        (:meth:`_every_row`)."""
        return self._every_row(staged.parts)

    def _init_streamed_counts(self) -> None:
        """The word counts and the summary of the initial z, one staged
        call at a time, on every replica: each replica's table takes every
        replica's lanes (the mesh COO add on a split one; over several
        processes the others' lanes come over the group)."""
        views = self._zero_word_views()
        nk = torch.zeros(self.summary.padded_shape, dtype=torch.int32,
                         device=self.device)
        for _k, staged in self._stream_calls():
            for part in self._all_parts(staged):
                tw, zf = part[0].reshape(-1), part[2].reshape(-1)
                msk = (tw != self._scratch_word).to(torch.int32)
                for view, dev in zip(views, self._devs):
                    tk.coo_scatter_add(view, tw.to(dev), zf.to(dev),
                                       msk.to(dev))
                nk.index_add_(0, zf.long().to(self.device),
                              msk.to(self.device))
        self.word_topic.put_views(views)
        self.summary.put_raw(nk)

    def _sweep_streamed(self, uniforms: Optional[Uniforms]) -> None:
        views = self._word_views()
        wstale = self._mirrors(views)
        acc = Replicated([_per_shard(v, torch.zeros_like) for v in views])
        TB = self._tb
        pending: list = []

        rows = self.mesh.local_rows

        def drain(item):
            # each process writes back only its own replicas' lanes
            k, host, events = item
            for event in events:
                event.synchronize()
            z = host.numpy()                        # [n, S, b]
            for i, d in enumerate(rows):
                self._z_host[self._local_of_global(
                    self._block_rows(k, d)).reshape(-1)] = \
                    z[i].reshape(-1, TB)

        for k, staged in self._stream_calls():
            (u,) = self._call_draws(uniforms, None)
            (acc,), z_out = self._fused((acc,), wstale, staged, u)
            mine = z_out[rows[0]:rows[-1] + 1]
            pending.append((k, mine.to("cpu", non_blocking=True),
                            _record_events([self.device])))
            if len(pending) > 2:
                drain(pending.pop(0))
        for item in pending:
            drain(item)
        # the lanes of rows a process lacks are now stale in its host z
        self._z_synced = self._rows_everywhere
        self.word_topic.put_views(acc.parts)

    def _sync_z_host(self) -> None:
        """Make the host z globally complete (several processes, not
        local_corpus). Training never needs it: each process stages and
        reads back its own lanes. Full-z consumers (doc_topics, store)
        call it: the owned slabs of each call are exchanged with one
        all-gather per call (every process owns as many lanes), which
        keeps the host transfer of one exchange bounded. A collective.
        Under local_corpus z is per-process by design: nothing to do."""
        if self._z_synced or self.config.local_corpus:
            return
        from multiverso_tpu_torch.parallel.multihost import \
            allgather_tensors
        offs = self._owned_call_offsets()
        # processes may own different numbers of rows
        all_offs = [o.numpy() for (o,) in allgather_tensors(
            [torch.from_numpy(offs)])]
        for k in range(self.calls_per_sweep):
            vals = allgather_tensors([torch.from_numpy(
                self._z_host[k * self._per_call + offs])])
            for p, (theirs,) in enumerate(vals):
                self._z_host[k * self._per_call + all_offs[p]] = \
                    theirs.numpy()
        self._z_synced = True

    # -- training ----------------------------------------------------------

    def _word_views(self) -> list:
        """Each replica's word table as a superstep body reads it."""
        return [self.word_topic.superstep_view(d)[0]
                for d in range(self.word_topic.n_replicas)]

    def _mirrors(self, views: list) -> Replicated:
        """The stale modes' bf16 mirror of each replica's word table, in
        its view's form. On a row split over processes, the whole mirror
        as one ``[V_pad, C, 128]`` tensor on each replica's device: the
        shards held here converted, the others' converted by their
        holders and all-gathered (row 0's owner of each; a collective,
        once a sweep), so that the sweep's steps read their rows with
        ``words=`` and exchange none (module doc)."""
        if not self.mesh.rows_split:
            return Replicated([_per_shard(v, lambda t: t.to(torch.bfloat16))
                               for v in views])
        wt = self.word_topic
        shards = wt._filled([None if t is None else t.to(torch.bfloat16)
                             for t in wt._read_shards()])
        whole: dict = {}
        return Replicated([whole.setdefault(dev, torch.cat(
            [t.to(dev) for t in shards])) for dev in self._devs])

    def _sweep_inputs(self) -> tuple:
        """The per-sweep inputs of each replica, from its own word table:
        the stale modes' bf16 mirror, or mh's stale word CDF over
        ``max(N_wk, 0) + beta`` (the reference's per-slice alias tables)
        and its copy of the counts."""
        views = self._word_views()
        if self._stale:
            return (self._mirrors(views),)
        if self.config.sampler != "mh":
            return ()
        beta = self.beta
        return (Replicated([_per_shard(v, lambda t: torch.cumsum(
                    torch.clamp_min(t.to(torch.float32), 0.0) + beta, 1))
                    for v in views]),
                Replicated([_per_shard(v, torch.clone) for v in views]))

    def sweep(self, uniforms: Optional[Uniforms] = None,
              integers: Optional[Integers] = None) -> None:
        """One full sampling pass over the corpus. ``uniforms`` (and, for
        mh, ``integers``) map a call number to that call's draws and
        replace the app's own (see :meth:`uniforms`, :meth:`integers`)."""
        c = self.config
        if self._docblock and c.stream_blocks:
            self._sweep_streamed(uniforms)
            return
        # a call's first step (doc-blocked) or stream position
        per_call = c.steps_per_call if self._docblock \
            else c.batch_tokens * c.steps_per_call
        extra = self._sweep_inputs()
        for call in range(self.calls_per_sweep):
            draws = self._call_draws(uniforms, integers)
            (self._ndk_l, self._z_l), _ = self._fused(
                (self._ndk_l, self._z_l), call * per_call, *draws, *extra)
        if self._stale:
            # fold the sweep's moves into the int32 table (the reference's
            # block-end Add of accumulated deltas)
            self._word_counts_from_z()

    def train(self, num_iterations: Optional[int] = None,
              uniforms: Optional[Uniforms] = None,
              integers: Optional[Integers] = None) -> float:
        """Run Gibbs sweeps; returns the final per-token log-likelihood.
        Eval runs every ``eval_every`` sweeps and on the last."""
        c = self.config
        iters = num_iterations if num_iterations is not None \
            else c.num_iterations
        every = max(c.eval_every, 1)
        t0 = time.perf_counter()
        # the restored cursor applies ONCE (the resume); later train()
        # calls start from 0
        it = start = min(self._resume_sweeps, iters)
        self._resume_sweeps = 0
        while it < iters:
            # divergence rollback (MVTPU_HEALTH_ACTION=rollback):
            # restore_run_state moved the sweep cursor back to the last
            # clean generation; replay from there (the draws derive from
            # _calls_done, which the restore rewound too)
            if telemetry.health.maybe_rollback(self) is not None:
                it = min(self._resume_sweeps, iters)
                self._resume_sweeps = 0
                continue
            t_sweep = time.perf_counter()
            with telemetry.span("lda.sweep"):
                self.sweep(uniforms, integers)
            telemetry.step_timeline(
                "lda", it, tokens=self.num_tokens,
                dispatch_s=time.perf_counter() - t_sweep)
            telemetry.histogram(
                "app.step.seconds", telemetry.LATENCY_BUCKETS,
                app="lda").observe(time.perf_counter() - t_sweep)
            telemetry.beat()    # flight recorder: a heartbeat per sweep
            self._sweep_done = it + 1
            if self.run_ckpt is not None:
                self.run_ckpt.maybe_save(it + 1, self.run_state)
            elif c.checkpoint_interval > 0 and c.checkpoint_prefix \
                    and (it + 1) % c.checkpoint_interval == 0:
                self.store(c.checkpoint_prefix)
            it += 1
            if it % every and it != iters:
                continue
            ll = self.loglik()
            self.ll_history.append(ll)
            log.info("lightlda iter %d: loglik/token=%.4f", it - 1, ll)
        self.summary.wait()
        dt = time.perf_counter() - t0
        tokens = self.num_tokens * (iters - start)
        self.doc_tokens_per_sec = tokens / max(dt, 1e-12)
        telemetry.counter("lda.tokens").inc(tokens)
        telemetry.emit("lda.doc_tokens_per_sec", self.doc_tokens_per_sec,
                       "tokens/s")
        log.info("lightlda done: %d iters, %.0f doc-tokens/s", iters,
                 self.doc_tokens_per_sec)
        return self.ll_history[-1] if self.ll_history else float("nan")

    # -- eval / output -----------------------------------------------------

    def _chunked_ll(self, nwk3, ndk_flat, ws, rows, m) -> torch.Tensor:
        """The predictive log-likelihood of one call's tokens, summed in
        float32 over chunks of ~64k tokens (eval rows stay bounded)."""
        K = self.K
        S = self.summary.logical_tensor().to(torch.float32)
        n = _eval_chunk(ws.shape[0])
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        for lo in range(0, ws.shape[0], n):
            sl = slice(lo, lo + n)
            A = ndk_flat.index_select(0, rows[sl].long()).to(torch.float32)
            W = _read_rows(nwk3, ws[sl]).to(torch.float32)
            tot = tot + _predictive_ll(A, W, S, m[sl].to(torch.float32),
                                       self.alpha, self.beta, K,
                                       self.V * self.beta)
        return tot

    def loglik(self) -> float:
        """Mean per-token predictive log-likelihood (the reference's
        `Eval` role) over the device-resident stream, from replica 0."""
        c = self.config
        K = self.K
        nwk = self.word_topic.superstep_view(0)[0]
        total = 0.0
        if self._docblock and c.stream_blocks:
            # this process's lanes of each call; over several processes
            # the partial sums are added in rank order. Where processes
            # share a row, each takes every row's lanes (the reads of a
            # split table merge over processes that read the same lanes)
            S, TB, MAXD = c.steps_per_call, self._tb, self._maxd
            split = self.mesh.rows_split
            n = self.n_replicas if split else len(self._devs)
            B = c.batch_tokens * n // self.n_replicas
            rows = ((torch.arange(S * B, device=self.device) // TB) * MAXD)
            for _k, staged in self._stream_calls():
                whole = self._whole_call(
                    DataSplit(self._all_parts(staged)) if split else staged)
                tw, drel, zf = (whole[i].reshape(-1) for i in range(3))
                msk = (tw != self._scratch_word).to(torch.int32)
                r = rows + drel
                ndk = torch.zeros(S * B // TB * MAXD, K, dtype=torch.int32,
                                  device=self.device)
                ndk.view(-1).index_add_(0, r * K + zf.long(), msk)
                total += float(self._chunked_ll(nwk, ndk.to(torch.int16),
                                                tw, r, msk))
            if self.mesh.processes > 1 and not split:
                from multiverso_tpu_torch.parallel.multihost import \
                    allgather_tensors
                total = sum(float(t) for (t,) in allgather_tensors(
                    [torch.tensor([total], dtype=torch.float64)]))
            return total / max(self.num_tokens, 1)
        call_tokens = c.batch_tokens * c.steps_per_call
        ndk_flat = self._ndk.view(-1, K)
        if self._docblock:
            ws, rows, ms = (t.view(-1) for t in (self._tw, self._rows,
                                                 self._mask))
        else:
            ws, rows, ms = self._tw, self._td, self._mask
        for lo in range(0, ws.shape[0], call_tokens):
            sl = slice(lo, lo + call_tokens)
            if c.sampler in ("gibbs", "mh"):
                # the reference's one-shot gibbs eval: no chunks
                A = ndk_flat.index_select(0, rows[sl].long()).to(
                    torch.float32)
                W = _read_rows(nwk, ws[sl]).to(torch.float32)
                total += float(_predictive_ll(
                    A, W, self.summary.logical_tensor().to(torch.float32),
                    ms[sl].to(torch.float32), self.alpha, self.beta, K,
                    self.V * self.beta))
            else:
                total += float(self._chunked_ll(nwk, ndk_flat, ws[sl],
                                                rows[sl], ms[sl]))
        return total / max(self.num_tokens, 1)

    def doc_topics(self) -> np.ndarray:
        """[num_docs, K] doc-topic counts (worker-local state). Over
        several processes a collective (the z sync, or the join of the
        replicas' doc counts); under local_corpus the counts of THIS
        process's docs, the other rows zero."""
        if self._docblock and self.config.stream_blocks:
            self._sync_z_host()
            out = np.zeros((self.num_docs, self.K), np.int32)
            chunk = max(1, (1 << 22) // self._tb)     # ~4M tokens
            for lo in range(0, len(self._tw_host), chunk):
                sl = slice(lo, lo + chunk)
                tw, drel = self._tw_host[sl], self._drel_host[sl]
                z = self._z_host[sl]
                blocks = np.arange(lo, lo + len(tw))[:, None]
                docs = self._doc_of_row[blocks, drel]
                valid = (tw != self._scratch_word) & (docs >= 0)
                np.add.at(out, (docs[valid], z[valid]), 1)
            return out
        ndk = self._ndk.cpu().numpy()
        if self._docblock:
            out = np.zeros((self.num_docs, self.K), np.int32)
            valid = self._blk_of_doc >= 0
            out[valid] = ndk[self._blk_of_doc[valid],
                             self._row_of_doc[valid]].reshape(
                int(valid.sum()), self.K)
            return out
        return ndk[: self.num_docs].reshape(self.num_docs, self.K).astype(
            np.int32)

    def word_topics(self) -> np.ndarray:
        """[V, K] word-topic counts from the table (a bounded-staleness
        cached view under ``MVTPU_STALENESS`` — logging/eval reads skip
        the per-call blocking fetch)."""
        if self._wt_view is not None:
            return self._wt_view.get()
        return self.word_topic.get()

    def close(self) -> None:
        """Close the cached view (``MVTPU_STALENESS``): the app is done."""
        if self._wt_view is not None:
            self._wt_view.close()

    def top_words(self, topic: int, k: int = 10) -> np.ndarray:
        return np.argsort(-self.word_topics()[:, topic])[:k]

    def dump_model(self, uri: str, rows_per_fetch: int = 4096) -> None:
        """Write the word-topic model in the reference's sparse text
        format: one line per word, ``word_id topic:count ...`` with only
        the NONZERO entries. Fetches go through
        :meth:`SparseMatrixTable.get_rows_sparse`, so only nonzero entries
        leave the device."""
        with open_stream(uri, "wb") as stream:
            for lo in range(0, self.V, rows_per_fetch):
                ids = np.arange(lo, min(lo + rows_per_fetch, self.V))
                indptr, cols, vals = self.word_topic.get_rows_sparse(ids)
                lines = []
                for i, w in enumerate(ids):
                    ent = " ".join(
                        f"{k}:{v}" for k, v in
                        zip(cols[indptr[i]:indptr[i + 1]],
                            vals[indptr[i]:indptr[i + 1]]))
                    lines.append(f"{w} {ent}".rstrip())
                stream.write(("\n".join(lines) + "\n").encode())

    # -- checkpoint (the shared lda_state.v1 format) -----------------------

    def _z_numpy(self) -> np.ndarray:
        if self._docblock and self.config.stream_blocks:
            self._sync_z_host()
            return self._z_host.reshape(-1)
        return self._z.cpu().numpy().reshape(-1)

    def _export_sampler_state(self):
        """(manifest scalars, payload arrays) of the sampler state: z and
        the doc-topic counts (dense [D+1, K]); under local_corpus this
        process's z alone (its shard's blocks). Over several processes a
        collective (:meth:`doc_topics`)."""
        if self._docblock and self.config.local_corpus:
            dense = np.zeros((0, self.K), np.int16)
            layout = "docblock"
        elif self._docblock:
            ndk_dtype = np.int16 if self.config.stream_blocks \
                else torch.empty(0, dtype=self._ndk_dtype).numpy().dtype
            dense = np.zeros((self.num_docs + 1, self.K), ndk_dtype)
            dense[:self.num_docs] = self.doc_topics()
            layout = "docblock"
        else:
            dense = self._ndk.cpu().numpy().reshape(
                self.num_docs + 1, self.K)
            layout = "stream"
        z = self._z_numpy()
        manifest = {"magic": STATE_MAGIC,
                    "num_tokens": self.num_tokens,
                    "word_topic_step": self.word_topic.default_option.step,
                    "perm_seed": self.config.seed,
                    "t_pad": int(z.shape[0]),
                    "layout": layout,
                    "calls_done": self._calls_done}
        if self._docblock:
            manifest["block_tokens"] = self.config.block_tokens
            manifest["block_docs"] = self.config.block_docs
        if self.config.local_corpus:
            # a per-process shard: the same process layout and the same
            # shard (its digest) are required to resume
            manifest["layout"] = "docblock_local"
            manifest["processes"] = self.mesh.processes
            crc, ntok = self._local_shard_digest()
            manifest["shard_crc32"] = crc
            manifest["local_tokens"] = ntok
        return manifest, {"z": z, "ndk": dense}

    def _local_shard_digest(self) -> Tuple[int, int]:
        """(crc32, local token count) of THIS process's shard and its
        packing: the words, the doc rows and the owned block offsets, so
        a resume with another split or ordering of equal sizes is
        refused."""
        import zlib
        crc = zlib.crc32(self._tw_host.tobytes())
        crc = zlib.crc32(self._drel_host.tobytes(), crc)
        crc = zlib.crc32(np.ascontiguousarray(
            np.asarray(self._own_offs, np.int64)).tobytes(), crc)
        return int(crc), int((self._tw_host != self._scratch_word).sum())

    def _state_path(self, uri_prefix: str) -> str:
        """The sampler state's file: one per rank under local_corpus,
        else one that every process writes with the same bytes."""
        if self.config.local_corpus:
            return f"{uri_prefix}.state.rank{self.mesh.rank}.npz"
        return f"{uri_prefix}.state.npz"

    def store(self, uri_prefix: str) -> None:
        """Checkpoint tables AND sampler state (z, doc-topic counts), in
        the format ``multiverso_tpu``'s LightLDA reads and writes."""
        self.word_topic.store(f"{uri_prefix}.word_topic.npz")
        self.summary.store(f"{uri_prefix}.summary.npz")
        manifest, payload = self._export_sampler_state()
        # every process writes: the table files and a shared state file
        # with the same bytes (atomic renames), a local_corpus state file
        # per rank
        savez_stream(self._state_path(uri_prefix), manifest, payload)
        self._last_store = (uri_prefix, self._calls_done)

    def load(self, uri_prefix: str) -> None:
        self.word_topic.load(f"{uri_prefix}.word_topic.npz")
        self.summary.load(f"{uri_prefix}.summary.npz")
        manifest, data = loadz_stream(self._state_path(uri_prefix),
                                      STATE_MAGIC)
        self._import_sampler_state(manifest, data)

    def _import_sampler_state(self, manifest, data) -> None:
        """Validate sampler state against the live tables and install it."""
        if self.config.local_corpus and \
                manifest.get("processes") != self.mesh.processes:
            raise ValueError(
                f"local_corpus checkpoint was written by "
                f"{manifest.get('processes')} processes, app has "
                f"{self.mesh.processes}: z shards are per-process")
        if self.config.local_corpus and "shard_crc32" in manifest:
            crc, ntok = self._local_shard_digest()
            if (manifest["shard_crc32"], manifest["local_tokens"]) \
                    != (crc, ntok):
                raise ValueError(
                    f"local_corpus checkpoint rank shard mismatch "
                    f"(crc32 {manifest['shard_crc32']:#x}/"
                    f"{manifest['local_tokens']} tokens != this app's "
                    f"{crc:#x}/{ntok}): the doc-to-process split and "
                    "device order must match the checkpointing run — "
                    "loading z against a different shard silently "
                    "corrupts counts")
        if manifest["num_tokens"] != self.num_tokens:
            raise ValueError(
                f"checkpoint has {manifest['num_tokens']} tokens, app has "
                f"{self.num_tokens} — same corpus required to resume")
        if "word_topic_step" in manifest and \
                self.word_topic.default_option.step \
                != int(manifest["word_topic_step"]):
            raise ValueError(
                "lda checkpoint is torn: state was "
                f"written at word_topic step "
                f"{manifest['word_topic_step']} but the loaded table "
                f"is at step {self.word_topic.default_option.step} — a "
                "crash interrupted the multi-file store; use an older "
                "complete checkpoint")
        if manifest["perm_seed"] != self.config.seed:
            raise ValueError(
                f"checkpoint was written with seed "
                f"{manifest['perm_seed']}, app has seed "
                f"{self.config.seed}: z is indexed in the seed-derived "
                "stream permutation, so the seeds must match to resume")
        my_layout = "stream" if not self._docblock else \
            ("docblock_local" if self.config.local_corpus else "docblock")
        ck_layout = manifest.get("layout", "stream")
        if ck_layout != my_layout:
            raise ValueError(
                f"checkpoint z layout {ck_layout!r} != app layout "
                f"{my_layout!r}: z indexing is layout-specific")
        if self._docblock:
            want = (self.config.block_tokens, self.config.block_docs)
            got = (manifest.get("block_tokens"), manifest.get("block_docs"))
            if got != want:
                raise ValueError(
                    f"checkpoint block geometry {got} != app {want}: "
                    "z packing must match to resume")
        self._install_sampler_state(np.asarray(data["z"]),
                                    np.asarray(data["ndk"]))
        self._calls_done = int(manifest.get("calls_done", 0))

    # -- run state (the run checkpoint manager's contract) ------------------

    def run_state(self) -> dict:
        """The train state for the run checkpoint manager: the sampler
        state (z and the doc-topic counts, as :meth:`store` writes them)
        and the sweep cursor. The tables ride the manager's own table
        export."""
        manifest, payload = self._export_sampler_state()
        # the scalars flatten into the app-state manifest, the arrays into
        # its payload; restore_run_state reassembles both
        return {**manifest, **payload, "sweep_done": self._sweep_done}

    def restore_run_state(self, restored) -> None:
        self._import_sampler_state(restored.state, restored.arrays)
        self._sweep_done = int(restored.get("sweep_done", 0))
        self._resume_sweeps = self._sweep_done

    def _install_sampler_state(self, z: np.ndarray, dense: np.ndarray) -> None:
        """Install z (in this app's layout, flattened) and the dense doc
        counts ([D, K] or [D+1, K]) on every replica."""
        streamed = self._docblock and self.config.stream_blocks
        z_shape = self._z_host.shape if streamed \
            else tuple(self._z.shape)
        if z.size != int(np.prod(z_shape)):
            raise ValueError(
                f"checkpoint z length {z.size} != app stream "
                f"length {int(np.prod(z_shape))}: batch/block "
                "geometry must match the checkpointing run to resume")
        z = z.reshape(z_shape).astype(np.int32)
        if streamed:
            # host z is the sampler state; blocked doc counts are derived
            # from it per call (a stored z is globally complete)
            self._z_host = z
            self._z_synced = True
            return
        self._set_z(torch.as_tensor(z, device=self.device))
        dense = dense[:self.num_docs].reshape(self.num_docs, self.K)
        np_dtype = torch.empty(0, dtype=self._ndk_dtype).numpy().dtype
        if self._docblock:
            blocked = np.zeros((self._nb_pad * self._maxd, self.K),
                               np_dtype)
            valid = self._blk_of_doc >= 0
            rows = (self._blk_of_doc[valid] * self._maxd
                    + self._row_of_doc[valid])
            blocked[rows] = dense[valid]
        else:
            blocked = np.zeros((self.num_docs + 1, self.K), np_dtype)
            blocked[:self.num_docs] = dense
        self._set_ndk(torch.as_tensor(blocked, device=self.device).view(
            self._ndk_shape))

    def load_numpy(self, state) -> None:
        """Install ``{"z", "ndk", "word_topic", "summary"}`` numpy state,
        e.g. a ``multiverso_tpu`` LightLDA's
        (:func:`multiverso_tpu_torch.convert.load_lightlda`)."""
        from multiverso_tpu_torch.convert import load_lightlda
        load_lightlda(self, state)


USAGE = """python -m multiverso_tpu_torch.apps.lightlda -input_file=PATH
    [-num_topics=100] [-alpha=-1 (50/K)] [-beta=0.01]
    [-num_iterations=10] [-eval_every=1] [-batch_tokens=4096]
    [-steps_per_call=16] [-sampler=gibbs|mh|tiled] [-mh_steps=2]
    [-stale_words=false] [-doc_blocked=false] [-block_tokens=512]
    [-block_docs=16] [-stream_blocks=false] [-seed=0]
    [-output_file=PREFIX] [-dump_file=PATH] [-checkpoint_interval=0]
    [-data_parallel=0] [-model_parallel=1] [-device=cpu]
    [-run_dir=DIR] [-resume=false] [-ckpt_every=0]

The mesh is -data_parallel x -model_parallel over every CUDA device, or
over one device repeated with -device (-device=cpu: the CPU); with a data
axis above 1 each row of the mesh holds a replica of the tables and
samples its share of every batch (-batch_tokens must divide by it, and
in doc-blocked mode the blocks of a step). -run_dir (or MVTPU_RUN_DIR)
keeps a run directory of checkpoint generations (tables and sampler
state), one every -ckpt_every sweeps (default: the -checkpoint_interval,
else 1); -resume (or MVTPU_RESUME=1) restarts from its latest complete
one. Over several processes (-machine_file, -num_processes, -process_id)
every process reads the whole -input_file (local_corpus, each process
its own shard, is a LightLDA(..., LDAConfig(local_corpus=True)) option,
as in the reference); with -device, -data_parallel x -model_parallel is
the whole grid and each process names its share of it, so
-data_parallel=1 -model_parallel=2 over two processes splits the word
table's rows between them."""


def main(argv=None) -> None:
    """CLI mirroring the reference lightlda binary's flags; ``-help``
    prints them."""
    from multiverso_tpu_torch.utils import configure
    flags = [
        (configure.define_string, "input_file", "",
         "docs in word:count format"),
        (configure.define_int, "num_topics", 100, "topics"),
        (configure.define_float, "alpha", -1.0,
         "doc-topic prior (<0 -> 50/K)"),
        (configure.define_float, "beta", 0.01, "word-topic prior"),
        (configure.define_int, "num_iterations", 10, "Gibbs sweeps"),
        (configure.define_int, "eval_every", 1,
         "likelihood eval cadence in sweeps"),
        (configure.define_int, "batch_tokens", 4096, "tokens per step"),
        (configure.define_int, "steps_per_call", 16,
         "steps per superstep call"),
        (configure.define_string, "output_file", "",
         "model checkpoint prefix"),
        (configure.define_string, "dump_file", "",
         "sparse text model dump (word k:count ...)"),
        (configure.define_string, "sampler", "gibbs",
         "gibbs | mh (Metropolis-Hastings) | tiled (K%128==0; sampler "
         "kernel)"),
        (configure.define_int, "mh_steps", 2,
         "mh: rounds of word + doc proposal per token"),
        (configure.define_bool, "stale_words", False,
         "tiled: bf16 word mirror"),
        (configure.define_bool, "doc_blocked", False,
         "tiled: doc-blocked sampler (production mode)"),
        (configure.define_int, "block_tokens", 512,
         "doc_blocked: tokens per block"),
        (configure.define_int, "block_docs", 16,
         "doc_blocked: docs per block"),
        (configure.define_bool, "stream_blocks", False,
         "doc_blocked: host-resident stream and z"),
        (configure.define_int, "seed", 0, "random seed"),
        (configure.define_string, "device", "",
         "one torch device for every shard (default: the CUDA devices as "
         "a mesh of -data_parallel x -model_parallel)"),
        (configure.define_int, "checkpoint_interval", 0,
         "store -output_file every N sweeps (0 = only at end)"),
    ]
    for define, name, default, help_str in flags:
        define(name, default, help_str, overwrite=True)
    from multiverso_tpu_torch.ft.checkpoint import define_run_flags, wire_app
    define_run_flags()
    argv = list(argv or [])
    if any(a.lstrip("-") in ("help", "h") for a in argv):
        print(USAGE + "\n\n" + configure.describe_flags())
        return
    configure.parse_flags(argv)
    path = configure.get_flag("input_file")
    if not path:
        raise SystemExit(f"-input_file is required\n\n{USAGE}")
    dp = configure.get_flag("data_parallel")
    mp = configure.get_flag("model_parallel")
    dev = configure.get_flag("device")
    # -device names every device of a -data_parallel x -model_parallel
    # grid; under -machine_file each process names its share of it (with
    # -data_parallel 0, a row of -model_parallel each)
    n = max(dp, 1) * mp
    if dp > 0:
        n //= core.flag_processes()
    mesh = core.init(devices=[dev] * n if dev else None,
                     data_parallel=dp, model_parallel=mp)
    tw, td, vocab = load_docs(path)
    a = configure.get_flag("alpha")
    cfg = LDAConfig(
        num_topics=configure.get_flag("num_topics"),
        alpha=None if a < 0 else a,
        beta=configure.get_flag("beta"),
        batch_tokens=configure.get_flag("batch_tokens"),
        steps_per_call=configure.get_flag("steps_per_call"),
        num_iterations=configure.get_flag("num_iterations"),
        eval_every=configure.get_flag("eval_every"),
        sampler=configure.get_flag("sampler"),
        mh_steps=configure.get_flag("mh_steps"),
        stale_words=configure.get_flag("stale_words"),
        doc_blocked=configure.get_flag("doc_blocked"),
        block_tokens=configure.get_flag("block_tokens"),
        block_docs=configure.get_flag("block_docs"),
        stream_blocks=configure.get_flag("stream_blocks"),
        seed=configure.get_flag("seed"),
        checkpoint_prefix=configure.get_flag("output_file"),
        checkpoint_interval=configure.get_flag("checkpoint_interval"),
    )
    app = LightLDA(tw, td, vocab, cfg, mesh=mesh)
    # fault tolerance: run-level checkpoint/resume, cadence in SWEEPS;
    # -run_dir routes the periodic trigger through the manager, the
    # -checkpoint_interval value still sets the cadence
    mgr = wire_app(app, [app.word_topic, app.summary],
                   every_default=cfg.checkpoint_interval or 1)
    # flight recorder: env-gated stall watchdog + device capture (the
    # per-sweep beat is in train)
    with telemetry.maybe_watchdog("lda"), telemetry.profile_window("lda"):
        app.train()
    if mgr is not None:
        mgr.close()     # drain pending background checkpoint writes
    telemetry.record_device_memory()
    out = configure.get_flag("output_file")
    if out and app._last_store != (out, app._calls_done):
        app.store(out)
    dump = configure.get_flag("dump_file")
    if dump:
        app.dump_model(dump)
    app.close()
    core.barrier()


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
