"""Distributed logistic regression over a dense ArrayTable.

Counterpart of ``multiverso_tpu/apps/logreg.py``, the reference's
``Applications/LogisticRegression``: linear classification of
libsvm-style data, the weights in one dense
:class:`~multiverso_tpu_torch.tables.ArrayTable` (``(input_dim + 1) *
num_classes`` float32: the weight matrix, then the bias row), SGD-family
updaters.

The reference's per-minibatch Get -> gradient -> Add round trip is one
fused superstep (:func:`~multiverso_tpu_torch.tables.make_superstep`):
the body computes the softmax (or binary sigmoid) cross-entropy with L2,
its gradient written out, and runs the table's updater on the table's
tensors. Full minibatches go ``steps_per_call`` to a call, looped in the
body where the reference scans; the rest (a partial group and the short
last minibatch) go one step a call.

On a mesh whose data axis D is above 1 the table holds D replicas and
the superstep runs the body once per replica: replica ``d`` takes block
``d`` of each minibatch (padded to a multiple of D by repeating its first
samples, as the reference pads), and the gradient and the loss are summed
over the replicas (:func:`~multiverso_tpu_torch.tables.superstep.replica_sum`)
before the updater runs, each already divided by the global (padded)
batch, so the replicas stay bit-identical. This is the port's counterpart
of the sum XLA puts under the reference's data-sharded mean. Under
``shard_update`` each replica updates its row block of the weights (its
part of the updater state) and the blocks are exchanged
(:func:`~multiverso_tpu_torch.tables.superstep.replica_cat`).

No TPU kernel stands behind this app: the products are ``torch.matmul``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from multiverso_tpu_torch import client, core, telemetry
from multiverso_tpu_torch.tables import ArrayTable, make_superstep
from multiverso_tpu_torch.tables.superstep import (DataSplit, replica_cat,
                                                   replica_index,
                                                   replica_sum)
from multiverso_tpu_torch.updaters import AddOption
from multiverso_tpu_torch.utils import log


@dataclasses.dataclass
class LogRegConfig:
    """Flag set of the reference app's key=value `Configure` file."""
    input_dim: int
    num_classes: int
    minibatch_size: int = 256
    steps_per_call: int = 8         # minibatches per fused dispatch
    epochs: int = 1
    learning_rate: float = 0.1
    updater: str = "sgd"
    regular_lambda: float = 0.0     # L2 coefficient ("regular=L2" analog)
    ftrl_l1: float = 0.0            # updater="ftrl": L1 / L2 / beta — the
    ftrl_l2: float = 0.0            # AddOption lam/rho/momentum fields
    ftrl_beta: float = 1.0          # (see updaters docstring mapping)
    objective: str = "softmax"      # "softmax" | "sigmoid"
    shard_update: bool = False      # updater state split over the data axis
    seed: int = 0

    def __post_init__(self) -> None:
        if self.objective == "sigmoid" and self.num_classes != 2:
            raise ValueError(
                "objective='sigmoid' is the binary objective; it requires "
                f"num_classes == 2, got {self.num_classes}")


def read_libsvm(path: str, input_dim: int, dtype=np.float32,
                one_based: Optional[bool] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse libsvm/sparse text: `label idx:val idx:val ...` per line, as
    dense (X, y).

    Canonical libsvm is 1-based; ``one_based=None`` autodetects: a file
    containing index 0 is 0-based, one containing index == input_dim is
    1-based; ambiguous files default to 1-based (pass the SAME explicit
    ``one_based`` for train and test files so an ambiguous one cannot
    silently shift feature columns between them)."""
    labels, rows = _parse_libsvm(path)
    if one_based is None:
        one_based = _resolve_base(*_base_markers(rows, input_dim),
                                  what=repr(path), input_dim=input_dim)
    return _densify(labels, rows, input_dim, one_based, dtype)


def _parse_libsvm(path: str):
    """One parse pass: (labels list, rows list of [(idx, val), ...])."""
    labels, rows = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            rows.append([(int(t[0]), float(t[1])) for t in
                         (tok.split(":") for tok in parts[1:])])
    return labels, rows


def _base_markers(rows, input_dim: int) -> Tuple[bool, bool]:
    has_zero = has_dim = False
    for r in rows:
        for i, _ in r:
            has_zero |= i == 0
            has_dim |= i == input_dim
    return has_zero, has_dim


def _resolve_base(has_zero: bool, has_dim: bool, *, what: str,
                  input_dim: int) -> bool:
    """The autodetect rule (one definition: read_libsvm and
    detect_libsvm_base must never disagree on the same file): index 0 ⇒
    0-based, index == input_dim ⇒ 1-based, both ⇒ error, neither ⇒
    1-based (the libsvm convention)."""
    if has_zero and has_dim:
        raise ValueError(
            f"{what}: contains both index 0 and index {input_dim} — "
            "cannot autodetect base; pass one_based explicitly")
    return not has_zero


def _densify(labels, rows, input_dim: int, one_based: bool, dtype
             ) -> Tuple[np.ndarray, np.ndarray]:
    off = 1 if one_based else 0
    xs = []
    for r in rows:
        row = np.zeros(input_dim, dtype=dtype)
        for i, val in r:
            j = i - off
            if j < 0 or j >= input_dim:
                raise ValueError(
                    f"feature index {i} out of range for input_dim "
                    f"{input_dim} (one_based={one_based})")
            row[j] = val
        xs.append(row)
    X = np.stack(xs) if xs else np.zeros((0, input_dim), dtype)
    y = np.asarray(labels)
    # labels may be {-1,+1} (binary libsvm) or {0..C-1}
    if set(np.unique(y)) <= {-1.0, 1.0}:
        y = (y > 0).astype(np.int32)
    return X, y.astype(np.int32)


def detect_libsvm_base(paths, input_dim: int) -> bool:
    """Detect the index base JOINTLY over several libsvm files (train +
    test must agree or feature columns silently shift between them), by
    ``read_libsvm``'s rule."""
    has_zero = has_dim = False
    for path in paths:
        hz, hd = _base_markers(_parse_libsvm(path)[1], input_dim)
        has_zero |= hz
        has_dim |= hd
    return _resolve_base(has_zero, has_dim, what=repr(list(paths)),
                         input_dim=input_dim)


def synthetic_blobs(n: int, input_dim: int, num_classes: int,
                    seed: int = 0, spread: float = 3.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian class blobs — the test/benchmark stand-in dataset."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, spread, (num_classes, input_dim))
    y = rng.integers(0, num_classes, n).astype(np.int32)
    X = centers[y] + rng.normal(0.0, 1.0, (n, input_dim))
    return X.astype(np.float32), y


def _pad_to(xs: np.ndarray, ys: np.ndarray, d: int, axis: int):
    """Pad ``axis`` (the batch) to a multiple of ``d`` by repeating its
    first samples (the reference's ``_shard_batch`` / ``_shard_scan``)."""
    n = xs.shape[axis]
    if n % d == 0:
        return xs, ys
    reps = np.arange(-n % d) % max(n, 1)
    return (np.concatenate([xs, np.take(xs, reps, axis)], axis),
            np.concatenate([ys, np.take(ys, reps, axis)], axis))


class LogisticRegression:
    """The app: ArrayTable-backed linear model + fused train step."""

    def __init__(self, config: LogRegConfig, *,
                 mesh: Optional[core.Mesh] = None,
                 device: core.DeviceLike = None,
                 name: str = "logreg") -> None:
        self.config = config
        self.mesh = core.resolve_mesh(mesh, device)
        self.n_replicas = self.mesh.shape[core.DATA_AXIS]
        c = config
        self.n_weights = (c.input_dim + 1) * c.num_classes  # + bias row
        rng = np.random.default_rng(c.seed)
        init = np.zeros(self.n_weights, np.float32)
        init[: c.input_dim * c.num_classes] = rng.normal(
            0.0, 0.01, c.input_dim * c.num_classes)
        opt = AddOption.for_ftrl(c.learning_rate, c.ftrl_l1, c.ftrl_l2,
                                 c.ftrl_beta) if c.updater == "ftrl" \
            else AddOption(learning_rate=c.learning_rate)
        if c.shard_update:
            core.refuse_model_split(self.mesh, "logreg's shard_update")
        self.table = ArrayTable(
            self.n_weights, "float32", init_value=init, updater=c.updater,
            mesh=self.mesh, name=name, default_option=opt,
            shard_update=c.shard_update)
        self.device = self.table.device
        # MVTPU_STALENESS=S: weights() and the epoch's weight-norm gauge
        # read a bounded-staleness cached view (logging-only reads)
        self._view = client.maybe_cached_view(self.table)
        # _epoch_done counts completed epochs (what run_state records);
        # _resume_epochs is a restored offset, consumed by the FIRST
        # train() after a restore
        self._epoch_done = 0
        self._resume_epochs = 0
        # fault tolerance: the run checkpoint manager wire_app attaches
        self.run_ckpt = None
        self._fused = make_superstep((self.table,), self._body,
                                     name="logreg_superstep")

    # -- model math --------------------------------------------------------

    def _data_term(self, w_flat: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor, m: int) -> torch.Tensor:
        """This replica's share of the data term over a global batch of
        ``m`` samples, as the one vector the replicas sum: its gradient
        over the padded weights (written out), then the sum of its
        samples' nll over ``m``."""
        c = self.config
        k = c.input_dim * c.num_classes
        w = w_flat[:k].view(c.input_dim, c.num_classes)
        b = w_flat[k:k + c.num_classes]
        logits = x @ w + b
        if c.objective == "sigmoid":
            # binary: y in {0,1}, logits[:, 1] - logits[:, 0] as score
            score = logits[:, 1] - logits[:, 0]
            yf = y.to(score.dtype)
            nll = torch.logaddexp(torch.zeros_like(score), score) \
                - yf * score
            ds = (torch.sigmoid(score) - yf) / m
            dlogits = torch.stack([-ds, ds], 1)
        else:
            logp = torch.log_softmax(logits, 1)
            nll = -logp.gather(1, y[:, None].long())[:, 0]
            dlogits = torch.exp(logp)
            dlogits[torch.arange(len(y), device=y.device), y.long()] -= 1.0
            dlogits = dlogits / m
        parts = [(x.t() @ dlogits).reshape(-1), dlogits.sum(0)]
        pad = w_flat.numel() - self.n_weights
        if pad:
            parts.append(dlogits.new_zeros(pad))
        parts.append((nll.sum() / m).reshape(1))
        return torch.cat(parts)

    def _update(self, w: torch.Tensor, state: dict, grad: torch.Tensor,
                opt: AddOption) -> Tuple[torch.Tensor, dict]:
        """The updater on the (whole, padded) weights; under shard_update
        on this replica's row block of each shard, the updated blocks
        then exchanged."""
        t = self.table
        if not t.shard_update:
            return t.updater.apply(w, state, grad, opt)
        n_shards, n_rep = len(t.devices), t.n_data
        rows = t._rows_per_shard
        q = rows // n_rep
        d = replica_index()
        blocks = [slice(s * rows + d * q, s * rows + (d + 1) * q)
                  for s in range(n_shards)]

        def mine(x):
            return torch.cat([x[blk] for blk in blocks])

        block, state = t.updater.apply(mine(w), state, mine(grad), opt)
        # [D, S, q] in replica order -> the padded weights, shard by shard
        parts = replica_cat(block).view(n_rep, n_shards, q)
        return parts.transpose(0, 1).reshape(-1), state

    def _body(self, params, states, locals_, options, xs, ys):
        """The superstep body: ``xs`` [S, B, input_dim], ``ys`` [S, B] (on
        a data axis this replica's B/D samples of each step); returns the
        loss of each step [S]."""
        (param,), (state,), (opt,) = params, states, options
        c = self.config
        k = c.input_dim * c.num_classes
        w = _whole(param)
        st = {key: _whole(v) for key, v in state.items()}
        m = xs.shape[1] * self.n_replicas
        losses = []
        for s in range(xs.shape[0]):
            # one exchange for the gradient and the loss
            summed = replica_sum(self._data_term(w, xs[s], ys[s], m))
            grad, loss = summed[:-1], summed[-1]
            if c.regular_lambda:
                # L2 on the weight matrix (not the bias)
                wk = w[:k]
                loss = loss + 0.5 * c.regular_lambda * torch.sum(wk * wk)
                grad[:k] += c.regular_lambda * wk
            losses.append(loss)
            w, st = self._update(w, st, grad, opt)
        return (w,), (st,), locals_, torch.stack(losses)

    # -- data placement ----------------------------------------------------

    def _place(self, xs: np.ndarray, ys: np.ndarray):
        """A stacked [S, B, ...] group on the device; on a data axis the
        batch padded to a multiple of D and split over the replicas."""
        xs = xs.astype(np.float32, copy=False)
        ys = ys.astype(np.int32, copy=False)
        if self.n_replicas > 1:
            xs, ys = _pad_to(xs, ys, self.n_replicas, axis=1)
            return (DataSplit.of(xs, self.mesh, axis=1),
                    DataSplit.of(ys, self.mesh, axis=1))
        return (core.place(xs, device=self.device),
                core.place(ys, device=self.device))

    # -- training ----------------------------------------------------------

    def train_epoch(self, X: np.ndarray, y: np.ndarray,
                    shuffle_seed: Optional[int] = None) -> float:
        c = self.config
        n = len(X)
        order = np.arange(n)
        if shuffle_seed is not None:
            np.random.default_rng(shuffle_seed).shuffle(order)
        losses: List[torch.Tensor] = []
        t0 = time.perf_counter()
        # full minibatches group into S-step calls; the trailing partial
        # group and the short last minibatch go one step a call
        starts = list(range(0, n, c.minibatch_size))
        full = [s for s in starts if s + c.minibatch_size <= n]
        tail = [s for s in starts if s + c.minibatch_size > n]
        S = max(c.steps_per_call, 1)
        groups = [full[g:g + S]
                  for g in range(0, len(full) - len(full) % S, S)]
        n_scan = len(groups)
        groups += [[s] for s in full[len(full) - len(full) % S:] + tail]
        for step_no, grp in enumerate(groups):
            idx = [order[s:s + c.minibatch_size] for s in grp]
            xs = np.stack([X[i] for i in idx])
            ys = np.stack([y[i] for i in idx])
            placed = self._place(xs, ys)
            # the reference's names: an S-step group is a superstep, the
            # trailing partial group and the short minibatch single steps
            scan = step_no < n_scan
            t_step = time.perf_counter()
            with telemetry.span("logreg.superstep" if scan
                                else "logreg.step"):
                _, lg = self._fused((), *placed)
            telemetry.step_timeline(
                "logreg", step_no,
                samples=S * c.minibatch_size if scan else len(idx[0]),
                dispatch_s=time.perf_counter() - t_step)
            telemetry.histogram(
                "app.step.seconds", telemetry.LATENCY_BUCKETS,
                app="logreg").observe(time.perf_counter() - t_step)
            telemetry.beat()
            losses.append(lg)
        # one device-to-host copy for the whole loss list
        mean_loss = float(torch.cat(losses).cpu().numpy().mean()) \
            if losses else float("nan")
        dt = time.perf_counter() - t0
        telemetry.counter("logreg.samples").inc(n)
        telemetry.emit("logreg.samples_per_sec", n / dt, "samples/s")
        if self._view is not None:
            # logging-only read off the cached view: within the staleness
            # bound, no extra snapshot
            telemetry.gauge("logreg.weight_norm").set(
                float(np.linalg.norm(self._view.get())))
        log.info("logreg epoch done: loss=%.4f %.0f samples/s",
                 mean_loss, n / dt)
        return mean_loss

    def train(self, X: np.ndarray, y: np.ndarray) -> float:
        loss = float("nan")
        # a restore picks up at the restored epoch cursor (applied ONCE):
        # each epoch's shuffle seed derives from its index, so the
        # remaining epochs replay as in the uninterrupted run
        e = min(self._resume_epochs, self.config.epochs)
        self._resume_epochs = 0
        while e < self.config.epochs:
            # divergence rollback (MVTPU_HEALTH_ACTION=rollback): the
            # restore ran restore_run_state, so re-read the cursor and
            # replay from the last clean generation
            if telemetry.health.maybe_rollback(self) is not None:
                e = min(self._resume_epochs, self.config.epochs)
                self._resume_epochs = 0
                continue
            loss = self.train_epoch(X, y, shuffle_seed=self.config.seed + e)
            self._epoch_done = e + 1
            if self.run_ckpt is not None:
                self.run_ckpt.maybe_save(self._epoch_done, self.run_state)
            e += 1
        return loss

    # -- run state ---------------------------------------------------------

    def run_state(self) -> dict:
        """The app's train state for the run checkpoint manager: the epoch
        cursor (the shuffle seeds fold the epoch index)."""
        return {"epoch_done": self._epoch_done}

    def restore_run_state(self, restored) -> None:
        self._epoch_done = int(restored.get("epoch_done", 0))
        self._resume_epochs = self._epoch_done

    # -- inference / eval --------------------------------------------------

    def predict(self, X: np.ndarray) -> np.ndarray:
        c = self.config
        k = c.input_dim * c.num_classes
        w_flat = self.table.logical_tensor()
        x = core.place(np.asarray(X, np.float32), device=self.device)
        logits = x @ w_flat[:k].view(c.input_dim, c.num_classes) \
            + w_flat[k:]
        return torch.argmax(logits, 1).cpu().numpy()

    def accuracy(self, X: np.ndarray, y: np.ndarray) -> float:
        return float(np.mean(self.predict(X) == y))

    def weights(self) -> Tuple[np.ndarray, np.ndarray]:
        w_flat = self._view.get() if self._view is not None \
            else self.table.get()
        c = self.config
        w = w_flat[: c.input_dim * c.num_classes].reshape(
            c.input_dim, c.num_classes)
        b = w_flat[c.input_dim * c.num_classes:].reshape(c.num_classes)
        return w, b

    def close(self) -> None:
        """Close the cached view (``MVTPU_STALENESS``): the app is done."""
        if self._view is not None:
            self._view.close()

    # -- checkpoint --------------------------------------------------------

    def store(self, uri: str) -> None:
        self.table.store(uri)

    def load(self, uri: str) -> None:
        self.table.load(uri)


def _whole(value) -> torch.Tensor:
    """A superstep view (a tensor, or a ShardedParam of a split table) as
    one tensor on its first shard's device (the shards of other
    processes merged in, :meth:`ShardedParam.whole`)."""
    if isinstance(value, torch.Tensor):
        return value
    return value.whole()


USAGE = """python -m multiverso_tpu_torch.apps.logreg [-train_file=PATH]
    [-test_file=PATH] [-input_dimension=784] [-output_dimension=10]
    [-minibatch_size=256] [-train_epoch=1] [-learning_rate=0.1]
    [-regular_lambda=0.0] [-updater_type=sgd] [-shard_update=false]
    [-output_model_file=URI] [-data_parallel=0] [-model_parallel=1]
    [-device=cpu] [-run_dir=DIR] [-resume=false] [-ckpt_every=0]

Without -train_file it trains on 20,000 synthetic Gaussian blobs. The mesh
is -data_parallel x -model_parallel over every CUDA device, or over one
device repeated with -device (-device=cpu: the CPU); with a data axis
above 1 each row of the mesh holds a replica of the weights and trains on
its share of every minibatch. -run_dir (or MVTPU_RUN_DIR) keeps a run
directory of checkpoint generations, one every -ckpt_every epochs
(default 1); -resume (or MVTPU_RESUME=1) restarts from its latest complete
one. Not ported: the cached weight view (MVTPU_STALENESS)."""


def main(argv=None) -> None:
    """CLI entry mirroring the reference binary's config-file interface;
    ``-help`` prints the flags."""
    from multiverso_tpu_torch.utils import configure
    flags = [
        (configure.define_string, "train_file", "", "libsvm training data"),
        (configure.define_string, "test_file", "", "libsvm test data"),
        (configure.define_int, "input_dimension", 784, "feature dimension"),
        (configure.define_int, "output_dimension", 10, "number of classes"),
        (configure.define_int, "minibatch_size", 256, "minibatch size"),
        (configure.define_int, "train_epoch", 1, "epochs"),
        (configure.define_float, "learning_rate", 0.1, "learning rate"),
        (configure.define_float, "regular_lambda", 0.0, "L2 coefficient"),
        (configure.define_bool, "shard_update", False,
         "updater state split over the data axis"),
        (configure.define_string, "output_model_file", "",
         "checkpoint URI"),
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
    dp = configure.get_flag("data_parallel")
    mp = configure.get_flag("model_parallel")
    dev = configure.get_flag("device")
    mesh = core.init(devices=[dev] * (max(dp, 1) * mp) if dev else None,
                     data_parallel=dp, model_parallel=mp)
    # the global updater_type default is "default" (plain add) — for a
    # gradient-descent app that means ascent; this app's default is sgd
    updater = configure.get_flag("updater_type")
    if updater == "default":
        updater = "sgd"
    cfg = LogRegConfig(
        input_dim=configure.get_flag("input_dimension"),
        num_classes=configure.get_flag("output_dimension"),
        minibatch_size=configure.get_flag("minibatch_size"),
        epochs=configure.get_flag("train_epoch"),
        learning_rate=configure.get_flag("learning_rate"),
        regular_lambda=configure.get_flag("regular_lambda"),
        updater=updater,
        shard_update=configure.get_flag("shard_update"),
    )
    app = LogisticRegression(cfg, mesh=mesh)
    train_file = configure.get_flag("train_file")
    test_file = configure.get_flag("test_file")
    # parse each file ONCE, then detect the index base jointly over all of
    # them: per-file detection could assign different bases to train and
    # test, silently shifting feature columns between them
    parsed = {f: _parse_libsvm(f) for f in (train_file, test_file) if f}
    base = True
    if parsed:
        has_zero = has_dim = False
        for _, rows in parsed.values():
            hz, hd = _base_markers(rows, cfg.input_dim)
            has_zero |= hz
            has_dim |= hd
        base = _resolve_base(has_zero, has_dim,
                             what=repr(list(parsed)),
                             input_dim=cfg.input_dim)
    if train_file:
        X, y = _densify(*parsed[train_file], cfg.input_dim, base,
                        np.float32)
    else:
        X, y = synthetic_blobs(20000, cfg.input_dim, cfg.num_classes)
    # fault tolerance: -run_dir/-resume (or MVTPU_RUN_DIR/MVTPU_RESUME)
    # enable run-level checkpoint/resume, cadence in EPOCHS (default:
    # every epoch once a run dir is configured)
    mgr = wire_app(app, [app.table], every_default=1)
    # flight recorder: MVTPU_WATCHDOG=<s> arms a stall watchdog (the
    # per-step beat is in train_epoch); MVTPU_PROFILE_DIR captures a
    # torch.profiler trace of the whole training run
    with telemetry.maybe_watchdog("logreg"), \
            telemetry.profile_window("logreg"):
        app.train(X, y)
    if mgr is not None:
        mgr.close()     # drain pending background checkpoint writes
    telemetry.record_device_memory()
    log.info("train accuracy: %.4f", app.accuracy(X, y))
    if test_file:
        Xt, yt = _densify(*parsed[test_file], cfg.input_dim, base,
                          np.float32)
        log.info("test accuracy: %.4f", app.accuracy(Xt, yt))
    out = configure.get_flag("output_model_file")
    if out:
        app.store(out)
    app.close()
    core.barrier()


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
