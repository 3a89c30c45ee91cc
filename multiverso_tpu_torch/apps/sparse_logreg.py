"""Sparse-feature logistic regression on a KVTable.

Counterpart of ``multiverso_tpu/apps/sparse_logreg.py``, the reference's
``Applications/LogisticRegression`` sparse path: the weights live in a
:class:`~multiverso_tpu_torch.tables.KVTable` keyed by the 64-bit hashed
feature id, so the feature space is unbounded (the hashing trick) and only
the features a minibatch touches are fetched and updated.

Per minibatch (the reference worker's Get -> train -> Add loop):

- the minibatch's UNIQUE feature keys are resolved on the host and their
  weight rows fetched in one lookup: ``[U, C]``, missing keys at 0;
- one step on the device computes the logits by a gather and an einsum
  over the fixed-width padded (feature position, value) arrays, the
  softmax cross-entropy (plus lazy L2 on the touched rows) and its
  gradient written out: the per-key delta sums every lane's contribution
  with the sorted row scatter-add (``ops.table_kernels.row_scatter_add``,
  the client-side Aggregator role), in lane order, so a step gives the
  same bits on every run and on every shard count;
- ``table.add(uniq_keys, delta)`` folds the delta through the table's
  updater (sgd / adagrad / ftrl; the state lives with the table, per key),
  the delta staying on the device. Under ``MVTPU_COALESCE=K`` the adds
  go through a :class:`~multiverso_tpu_torch.client.CoalescingBuffer`:
  K minibatches' deltas pre-sum by key on the device and flush as ONE
  probe + commit (the reference's client-side Aggregator), and the Gets
  then serve weights up to K minibatches stale.

Samples are padded to ``max_features`` features (more raise), unique-key
counts to powers of two, and padding lanes point at a zero sentinel row.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import client, core, telemetry
from multiverso_tpu_torch.apps.logreg import _parse_libsvm
from multiverso_tpu_torch.ops.table_kernels import row_scatter_add
from multiverso_tpu_torch.tables import KVTable
from multiverso_tpu_torch.tables.hashing import _bucket
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import log

BIAS_KEY = np.uint64(0xB1A5B1A5B1A5B1A5)


@dataclasses.dataclass
class SparseLRConfig:
    num_classes: int = 2
    max_features: int = 64        # per-sample nnz pad width (bias incl.)
    capacity: int = 1 << 20       # KVTable capacity (keys)
    slots_per_bucket: int = 16    # hash-bucket width (overflow headroom)
    minibatch_size: int = 4096
    learning_rate: float = 0.1
    regular_lambda: float = 0.0   # lazy L2 on touched rows
    updater: str = "sgd"          # "sgd" | "adagrad" | "ftrl"
    ftrl_l1: float = 0.0          # updater="ftrl": L1 / L2 / beta — the
    ftrl_l2: float = 0.0          # AddOption lam/rho/momentum fields
    ftrl_beta: float = 1.0        # (see updaters docstring mapping)
    epochs: int = 1
    use_bias: bool = True
    seed: int = 0


def read_libsvm_sparse(path: str) -> Tuple[List[List[Tuple[int, float]]],
                                           np.ndarray]:
    """Parse libsvm rows WITHOUT densifying: ([(idx, val), ...] per
    sample, labels). Indices are used as hash keys directly; labels in
    {-1, +1} become {0, 1}."""
    labels, rows = _parse_libsvm(path)
    y = np.asarray(labels)
    if set(np.unique(y)) <= {-1.0, 1.0}:
        y = (y > 0).astype(np.int32)
    return rows, y.astype(np.int32)


def synthetic_sparse(n: int, dim: int, num_classes: int, nnz: int = 20,
                     seed: int = 0) -> Tuple[List[List[Tuple[int, float]]],
                                             np.ndarray]:
    """Sparse classification data with a planted linear model over a
    ``dim``-sized feature space (the reference's generator)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1.0, (dim, num_classes))
    rows, ys = [], []
    for _ in range(n):
        idx = rng.choice(dim, size=nnz, replace=False)
        val = rng.normal(0, 1.0, nnz)
        logits = val @ w[idx]
        ys.append(int(np.argmax(logits)))
        rows.append(list(zip(idx.tolist(), val.tolist())))
    return rows, np.asarray(ys, np.int32)


def lr_step(w: torch.Tensor, pos: torch.Tensor, vals: torch.Tensor,
            y: torch.Tensor, regular_lambda: float, lanes: torch.Tensor):
    """One minibatch's loss and gradient, written out. ``w`` [U+1, C] (the
    last row the zero sentinel), ``pos`` [B, F] int64 rows of ``w``,
    ``vals`` [B, F], ``y`` [B] int64 -> (loss 0-d, dw [U+1, C]). The loss
    is the mean NLL of softmax(sum_f vals * w[pos]) plus
    0.5 * lambda * |w[:-1]|^2. The gradient sums the terms of ``lanes``
    (flat ``b * F + f`` indices) only: the app passes the real lanes, so
    the padding lanes, which all point at the sentinel row, do not form
    one long serial run of the scatter (their terms are zero and the
    sentinel row's gradient is unused)."""
    b, c = y.shape[0], w.shape[1]
    rows = w[pos]                                        # [B, F, C]
    logits = torch.einsum("bf,bfc->bc", vals, rows)
    logp = torch.log_softmax(logits, dim=1)
    nll = -logp.gather(1, y[:, None]).mean()
    loss = nll + 0.5 * regular_lambda * (w[:-1] ** 2).sum()
    # d nll / d logits = (softmax - onehot(y)) / B
    g = torch.exp(logp)
    g[torch.arange(b, device=w.device), y] -= 1.0
    g = g / b
    drows = vals[:, :, None] * g[:, None, :]             # [B, F, C]
    dw = row_scatter_add(torch.zeros_like(w), pos.reshape(-1)[lanes],
                         drows.reshape(-1, c)[lanes])
    if regular_lambda:
        dw[:-1] += regular_lambda * w[:-1]
    return loss, dw


class SparseLogisticRegression:
    """The app: a KVTable-backed linear model over hashed sparse
    features. The table lives on ``mesh`` (split over its model axis,
    replicated over its data axis: a step's Get reads replica 0, its
    Add writes every replica), or on the (1, 1) mesh of ``device``, or
    on the runtime's mesh; the step runs on the mesh's first device."""

    def __init__(self, config: SparseLRConfig, *,
                 device: core.DeviceLike = None,
                 mesh: Optional[core.Mesh] = None,
                 name: str = "sparse_logreg") -> None:
        self.config = config
        c = config
        if c.num_classes < 2:
            raise ValueError("num_classes must be >= 2")
        opt = AddOption.for_ftrl(c.learning_rate, c.ftrl_l1, c.ftrl_l2,
                                 c.ftrl_beta) if c.updater == "ftrl" \
            else AddOption(learning_rate=c.learning_rate)
        self.table = KVTable(
            c.capacity, value_dim=c.num_classes, dtype="float32",
            slots_per_bucket=c.slots_per_bucket, updater=c.updater,
            device=device, mesh=mesh, name=name, default_option=opt)
        self.device = self.table.device
        # MVTPU_COALESCE=K: the per-minibatch add coalesces (see the
        # module docstring)
        self._coalescer = client.maybe_coalescing(self.table)
        #: one dict per trained epoch: loss, seconds, samples
        self.epoch_stats: List[dict] = []
        # fault tolerance (ft.checkpoint.wire_app): the epoch cursor; the
        # restored offset is consumed by the FIRST train() after a resume
        self.run_ckpt = None
        self._epoch_done = 0
        self._resume_epochs = 0

    # -- batch packing -----------------------------------------------------

    def _pack(self, rows: Sequence[Sequence[Tuple[int, float]]]):
        """Fixed-shape (keys [B,F] uint64, vals [B,F] f32) + the unique
        key set; padded lanes carry key 0 with value 0 (they map to the
        sentinel row, so the key identity is irrelevant)."""
        c = self.config
        b = len(rows)
        f = c.max_features
        keys = np.zeros((b, f), np.uint64)
        vals = np.zeros((b, f), np.float32)
        for i, row in enumerate(rows):
            feats = list(row)
            if c.use_bias:
                feats.append((None, 1.0))
            if len(feats) > f:
                raise ValueError(
                    f"sample {i} has {len(feats)} features (incl. bias) "
                    f"> max_features={f}")
            for j, (idx, val) in enumerate(feats):
                keys[i, j] = BIAS_KEY if idx is None \
                    else np.uint64(idx) + np.uint64(1)  # avoid key 0 pad
                vals[i, j] = val
        uniq = np.unique(keys[vals != 0.0])
        return keys, vals, uniq

    def _positions(self, keys: np.ndarray, vals: np.ndarray,
                   uniq: np.ndarray, upad: int) -> np.ndarray:
        """Map each (sample, feature) lane to its row in the fetched
        unique-weight block; zero-value pad lanes -> sentinel row upad."""
        if len(uniq) == 0:      # all-zero minibatch: every lane is padding
            return np.full(keys.shape, upad, np.int32)
        pos = np.searchsorted(uniq, keys.ravel()).astype(np.int32)
        pos = np.minimum(pos, len(uniq) - 1)
        hit = uniq[pos] == keys.ravel()
        pos = np.where(hit & (vals.ravel() != 0.0), pos, upad)
        return pos.reshape(keys.shape).astype(np.int32)

    def _fetch(self, uniq: np.ndarray):
        """The minibatch's weight block [upad + 1, C] on the device (the
        padding keys are an unused real key; the last row is the zero
        sentinel) and upad."""
        upad = _bucket(len(uniq))
        uniq_pad = np.zeros(upad, np.uint64)
        uniq_pad[: len(uniq)] = uniq
        uniq_pad[len(uniq):] = BIAS_KEY ^ np.uint64(1)
        w, _found = self.table.get_tensor(uniq_pad)
        zero = torch.zeros((1, self.config.num_classes), dtype=w.dtype,
                           device=w.device)
        return torch.cat([w, zero]), upad

    # -- training ----------------------------------------------------------

    def train_batch(self, rows, y: np.ndarray) -> float:
        """One Get -> gradient -> Add round (the reference's per-block
        worker loop)."""
        keys, vals, uniq = self._pack(rows)
        w_ext, upad = self._fetch(uniq)
        pos = self._positions(keys, vals, uniq, upad)
        dev = self.device
        loss, dw = lr_step(
            w_ext, torch.as_tensor(pos, device=dev).long(),
            torch.as_tensor(vals, device=dev),
            torch.as_tensor(np.asarray(y), device=dev).long(),
            self.config.regular_lambda,
            torch.as_tensor(np.flatnonzero(pos.ravel() != upad),
                            device=dev))
        if len(uniq):           # all-zero minibatch has nothing to update
            if self._coalescer is not None:
                self._coalescer.add_kv(uniq, dw[:len(uniq)])
            else:
                self.table.add(uniq, dw[:len(uniq)])
        return float(loss)

    def train(self, rows, y: np.ndarray) -> float:
        """``epochs`` passes over the data in minibatches, each epoch in
        the permutation of ``seed + epoch``; returns the last epoch's mean
        minibatch loss and appends each epoch's stats to ``epoch_stats``."""
        c = self.config
        n = len(rows)
        loss = float("nan")
        t_train = time.perf_counter()
        step_no = 0
        # a resume applies ONCE: the table is restored exactly at an epoch
        # boundary and each epoch's permutation seed derives from its
        # index, so the remaining epochs replay as in the uninterrupted run
        e = min(self._resume_epochs, c.epochs)
        self._resume_epochs = 0
        while e < c.epochs:
            # divergence rollback (MVTPU_HEALTH_ACTION=rollback):
            # restore_run_state just moved the cursor; replay from the
            # last clean generation
            if telemetry.health.maybe_rollback(self) is not None:
                e = min(self._resume_epochs, c.epochs)
                self._resume_epochs = 0
                continue
            t0 = time.perf_counter()
            order = np.random.default_rng(c.seed + e).permutation(n)
            losses = []
            for s in range(0, n, c.minibatch_size):
                idx = order[s:s + c.minibatch_size]
                t_step = time.perf_counter()
                with telemetry.span("sparse_logreg.step"):
                    losses.append(self.train_batch([rows[i] for i in idx],
                                                   y[idx]))
                telemetry.step_timeline(
                    "sparse_logreg", step_no, samples=len(idx),
                    dispatch_s=time.perf_counter() - t_step)
                telemetry.histogram(
                    "app.step.seconds", telemetry.LATENCY_BUCKETS,
                    app="sparse_logreg").observe(
                    time.perf_counter() - t_step)
                telemetry.beat()
                step_no += 1
            self.table.wait()
            loss = float(np.mean(losses))
            self.epoch_stats.append(dict(
                epoch=e, loss=loss, seconds=time.perf_counter() - t0,
                samples=n, steps=len(losses)))
            log.info("sparse_logreg epoch %d: loss=%.4f", e, loss)
            self._epoch_done = e + 1
            if self.run_ckpt is not None:
                # the export flushes the coalescer, so the checkpoint
                # observes every buffered delta
                self.run_ckpt.maybe_save(self._epoch_done, self.run_state)
            e += 1
        if self._coalescer is not None:
            # the tail partial group must land before eval/checkpoint
            self._coalescer.flush()
        dt = time.perf_counter() - t_train
        telemetry.counter("sparse_logreg.samples").inc(n * c.epochs)
        telemetry.emit("sparse_logreg.samples_per_sec",
                       n * c.epochs / dt, "samples/s")
        return loss

    # -- run state (the run checkpoint manager's contract) ------------------

    def run_state(self) -> dict:
        """The epoch cursor: the KVTable (weights, updater state, key
        layout) rides the manager's table export; minibatch order derives
        from the epoch index."""
        return {"epoch_done": self._epoch_done}

    def restore_run_state(self, restored) -> None:
        self._epoch_done = int(restored.get("epoch_done", 0))
        self._resume_epochs = self._epoch_done

    # -- inference ---------------------------------------------------------

    def predict(self, rows) -> np.ndarray:
        if self._coalescer is not None:
            self._coalescer.flush()     # eval reads are exact
        keys, vals, uniq = self._pack(rows)
        w_ext, upad = self._fetch(uniq)
        pos = self._positions(keys, vals, uniq, upad)
        logits = np.einsum("bf,bfc->bc", vals, w_ext.cpu().numpy()[pos])
        return np.argmax(logits, axis=1).astype(np.int32)

    def accuracy(self, rows, y: np.ndarray) -> float:
        return float(np.mean(self.predict(rows) == y))

    def close(self) -> None:
        """Flush and drop the coalescer (``MVTPU_COALESCE``): the app is
        done."""
        if self._coalescer is not None:
            self._coalescer.flush()
            self._coalescer = None

    # -- checkpoint --------------------------------------------------------

    def store(self, uri: str) -> None:
        self.table.store(uri)

    def load(self, uri: str) -> None:
        self.table.load(uri)


def main(argv=None) -> None:
    """CLI mirroring the reference LR app's sparse configuration."""
    from multiverso_tpu_torch.utils import configure
    flags = [
        (configure.define_string, "train_file", "", "libsvm training data"),
        (configure.define_string, "test_file", "", "libsvm eval data"),
        (configure.define_int, "num_classes", 2, "classes"),
        (configure.define_int, "max_features", 64, "per-sample nnz pad"),
        (configure.define_int, "capacity", 1 << 20, "KVTable capacity"),
        (configure.define_int, "minibatch_size", 4096, "samples per step"),
        (configure.define_float, "learning_rate", 0.1, "lr"),
        (configure.define_float, "regular_lambda", 0.0, "L2"),
        (configure.define_int, "epoch", 1, "epochs"),
        (configure.define_string, "output_file", "", "checkpoint uri"),
        (configure.define_string, "device", "",
         "one torch device (default: the CUDA devices as a mesh of "
         "-data_parallel x -model_parallel)"),
    ]
    for define, name, default, help_str in flags:
        define(name, default, help_str, overwrite=True)
    from multiverso_tpu_torch.ft.checkpoint import define_run_flags, wire_app
    define_run_flags()
    configure.parse_flags(argv or [])
    core.init(device=configure.get_flag("device") or None)
    path = configure.get_flag("train_file")
    if not path:
        raise SystemExit("-train_file is required")
    rows, y = read_libsvm_sparse(path)
    cfg = SparseLRConfig(
        num_classes=configure.get_flag("num_classes"),
        max_features=configure.get_flag("max_features"),
        capacity=configure.get_flag("capacity"),
        minibatch_size=configure.get_flag("minibatch_size"),
        learning_rate=configure.get_flag("learning_rate"),
        regular_lambda=configure.get_flag("regular_lambda"),
        epochs=configure.get_flag("epoch"))
    app = SparseLogisticRegression(cfg)
    # fault tolerance: run-level checkpoint/resume, cadence in epochs
    mgr = wire_app(app, [app.table], every_default=1)
    # flight recorder: env-gated stall watchdog + device capture (the
    # per-step beat is in train)
    with telemetry.maybe_watchdog("sparse_logreg"), \
            telemetry.profile_window("sparse_logreg"):
        app.train(rows, y)
    if mgr is not None:
        mgr.close()     # drain pending background checkpoint writes
    telemetry.record_device_memory()
    log.info("train accuracy: %.4f", app.accuracy(rows, y))
    test = configure.get_flag("test_file")
    if test:
        trows, ty = read_libsvm_sparse(test)
        log.info("test accuracy: %.4f", app.accuracy(trows, ty))
    out = configure.get_flag("output_file")
    if out:
        app.store(out)
    app.close()
    core.barrier()


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
