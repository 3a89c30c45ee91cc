"""The port's client pipeline (``multiverso_tpu_torch/client``) against the
JAX package's, case by case after ``tests/test_client.py``.

Both packages run the same calls from the same numpy arrays, the
reference on a one-device CPU mesh (and a (2, 2) mesh where a case
names it), the port on the CPU, where the pre-sum runs the row
scatter-add's plain version. The coalesced sums are bit for bit, and
so are dense and row tables under the ``default`` updater and stateless
row scatters; a stateful updater's arithmetic keeps the dense tables'
tolerance (rtol 1e-6, atol 1e-7, ``tests/test_torch_tables.py``) and KV
results the KV tolerance of ROADMAP queue C (rtol 1e-6, atol 1e-7: a
few ulps through XLA's FMA; the state rtol 1e-5); keys, found masks and
counts exact. Dispatch counts are ``profile.calls`` deltas, compared with the
reference's (its engine series summed).

Not carried over here: the reference's ``TestGetAsync`` (a JAX future
type), ``test_bucketed_signature_reuse`` (jit compile counts) and the
wire transport (``tests/test_torch_wire*.py``). The overflow deferral
reads the port's ``(flag, events, host_buckets)`` entries (ROADMAP queue
C, reference failure 3). Card-only cases (the pre-sum through the CUDA
kernel, the pinned staging buffer) are in ``tests/test_torch_cuda.py``.
"""

import time

import jax
import numpy as np
import pytest
import torch

from multiverso_tpu import client as jclient
from multiverso_tpu import core as jcore
from multiverso_tpu.tables import (ArrayTable as JArrayTable,
                                   KVTable as JKVTable,
                                   MatrixTable as JMatrixTable,
                                   SparseMatrixTable as JSparseMatrixTable,
                                   make_superstep as jmake_superstep)
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu.updaters import AddOption as JAddOption
from multiverso_tpu_torch import client, core
from multiverso_tpu_torch.client import coalesce
from multiverso_tpu_torch.tables import (ArrayTable, KVTable, MatrixTable,
                                         SparseMatrixTable, make_superstep)
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.updaters import AddOption

KV_RTOL, KV_ATOL = 1e-6, 1e-7
# the dense tables' updater tolerance (tests/test_torch_tables.py)
TABLE_RTOL, TABLE_ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _fresh():
    for m in (jmetrics, tmetrics):
        m.registry().reset()
    yield
    for m in (jmetrics, tmetrics):
        m.registry().reset()
    jcore.shutdown()
    core.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


@pytest.fixture()
def mesh1(devices):
    return jcore.init(devices=devices[:1], data_parallel=1,
                      model_parallel=1)


def _meshes(devices, shape):
    dp, mp = shape
    jm = jcore.init(devices=devices[:dp * mp], data_parallel=dp,
                    model_parallel=mp)
    return jm, core._build_mesh(["cpu"] * (dp * mp), dp, mp)


def _calls(metrics, fn: str) -> float:
    """``profile.calls{fn=...}``, the reference's engine series summed."""
    snap = metrics.registry().snapshot()["counters"]
    return sum(v for k, v in snap.items()
               if k in (f"profile.calls{{fn={fn}}}",
                        f"profile.calls{{fn={fn}.pallas}}"))


def _dense(t):
    return np.asarray(t.get())


# -- coalescing: dense --------------------------------------------------------


def test_k_adds_one_dispatch(mesh1):
    got = {}
    for pkg, Table, cl, m, mesh in (
            ("j", JArrayTable, jclient, jmetrics, mesh1),
            ("t", ArrayTable, client, tmetrics, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(32, "float32", name="cl_dense1", **kw)
        buf = cl.CoalescingBuffer(t, max_deltas=4)
        c0 = _calls(m, "table.apply.cl_dense1")
        hs = [buf.add(np.full(32, float(i + 1), np.float32))
              for i in range(4)]
        assert buf.flush_generation == 1 and buf.pending_deltas == 0
        assert _calls(m, "table.apply.cl_dense1") - c0 == 1
        hs[0].wait()
        got[pkg] = _dense(t)
    np.testing.assert_array_equal(got["t"], got["j"])
    np.testing.assert_allclose(got["t"], 10.0)


def test_wait_forces_flush(mesh1):
    for pkg, Table, cl, mesh in (("j", JArrayTable, jclient, mesh1),
                                 ("t", ArrayTable, client, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(8, "float32", name="cl_dense2", **kw)
        buf = cl.CoalescingBuffer(t, max_deltas=100)
        h = buf.add(np.ones(8, np.float32))
        assert not h.flushed() and not h.done()
        assert float(_dense(t)[0]) == 0.0     # buffered = invisible
        h.wait()
        assert h.flushed()
        np.testing.assert_allclose(_dense(t), 1.0)


def test_flush_returns_handle_and_observes_all():
    t = ArrayTable(8, "float32", device="cpu", name="cl_dense3")
    buf = client.CoalescingBuffer(t, max_deltas=100)
    buf.add(np.ones(8, np.float32))
    buf.add(2 * np.ones(8, np.float32))
    buf.flush().wait()
    np.testing.assert_allclose(t.get(), 3.0)
    assert buf.flush() is None          # empty flush: no dispatch


def test_byte_budget_triggers():
    t = ArrayTable(8, "float32", device="cpu", name="cl_dense4")
    buf = client.CoalescingBuffer(t, max_deltas=100, max_bytes=64)
    buf.add(np.ones(8, np.float32))     # 32 bytes: under budget
    assert buf.flush_generation == 0
    buf.add(np.ones(8, np.float32))     # 64 bytes: flush
    assert buf.flush_generation == 1


def test_age_budget_triggers(monkeypatch):
    t = ArrayTable(8, "float32", device="cpu", name="cl_dense_age")
    buf = client.CoalescingBuffer(t, max_deltas=100, max_age_s=5.0)
    now = [1000.0]
    monkeypatch.setattr(coalesce.time, "monotonic", lambda: now[0])
    buf.add(np.ones(8, np.float32))
    buf.maybe_flush()
    assert buf.flush_generation == 0
    now[0] += 5.0                       # the group's first add is 5 s old
    buf.maybe_flush()
    assert buf.flush_generation == 1
    np.testing.assert_allclose(t.get(), 1.0)


def test_option_change_flushes_boundary(mesh1):
    got = {}
    for pkg, Table, cl, Opt, mesh in (
            ("j", JArrayTable, jclient, JAddOption, mesh1),
            ("t", ArrayTable, client, AddOption, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(8, "float32", updater="sgd", name="cl_dense5", **kw)
        buf = cl.CoalescingBuffer(t, max_deltas=100)
        buf.add(np.ones(8, np.float32), Opt(learning_rate=0.5))
        buf.add(np.ones(8, np.float32), Opt(learning_rate=1.0))
        assert buf.flush_generation == 1   # the boundary flushed group 1
        buf.flush()
        got[pkg] = _dense(t)
    np.testing.assert_array_equal(got["t"], got["j"])
    np.testing.assert_allclose(got["t"], -1.5)


@pytest.mark.parametrize("updater", ["default", "sgd", "adagrad"])
def test_dense_coalescing_matches_reference(mesh1, updater):
    """The coalesced sum equals the reference's bit for bit, and so does
    the table under ``default``; the stateful updaters' arithmetic keeps
    the dense tables' tolerance (``tests/test_torch_tables.py``: XLA
    contracts ``p - lr * d`` into an FMA). The linear updater's K
    coalesced adds also equal K sequential adds within a sum order."""
    rng = np.random.default_rng(0)
    deltas = [rng.normal(size=16).astype(np.float32) for _ in range(6)]
    got, accs = {}, {}
    for pkg, Table, cl, mesh in (("j", JArrayTable, jclient, mesh1),
                                 ("t", ArrayTable, client, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(16, "float32", updater=updater, name="cl_coal", **kw)
        buf = cl.CoalescingBuffer(t, max_deltas=4)
        for d in deltas:
            buf.add(d)
        accs[pkg] = np.asarray(buf._acc).copy()
        buf.flush()
        got[pkg] = _dense(t)
    np.testing.assert_array_equal(accs["t"], accs["j"])
    if updater == "default":
        np.testing.assert_array_equal(got["t"], got["j"])
    else:
        np.testing.assert_allclose(got["t"], got["j"], rtol=TABLE_RTOL,
                                   atol=TABLE_ATOL)
    if updater == "sgd":
        seq = ArrayTable(16, "float32", updater="sgd", device="cpu",
                         name="cl_seq")
        for d in deltas:
            seq.add(d)
        np.testing.assert_allclose(got["t"], seq.get(), rtol=1e-5)


def test_dense_tensor_deltas_accumulate_on_their_device():
    """Tensor deltas sum with ``+=`` where they live; a host delta joins
    them; the result equals the numpy group's bit for bit."""
    rng = np.random.default_rng(5)
    ds = [rng.normal(size=(6, 3)).astype(np.float32) for _ in range(3)]
    a = ArrayTable(18, "float32", device="cpu", name="cl_np")
    b = MatrixTable(6, 3, "float32", device="cpu", name="cl_tensor")
    ba = client.CoalescingBuffer(a, max_deltas=3)
    bb = client.CoalescingBuffer(b, max_deltas=3)
    for i, d in enumerate(ds):
        ba.add(d.reshape(-1))
        bb.add(torch.from_numpy(d) if i != 1 else d)
    assert bb._acc is None and bb.flush_generation == 1
    np.testing.assert_array_equal(b.get().reshape(-1), a.get())


def test_superstep_flushes_buffer_first(mesh1):
    """F5: a superstep flushes the attached coalescers before its body
    reads the storage (the reference's ``test_superstep_flushes_buffer_
    first`` on a MatrixTable with a pending ``add_rows``)."""
    got = {}
    for pkg, Table, cl, mk, mesh in (
            ("j", JMatrixTable, jclient, jmake_superstep, mesh1),
            ("t", MatrixTable, client, make_superstep, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(8, 4, "float32", name="cl_ss", **kw)
        buf = cl.CoalescingBuffer(t, max_deltas=100)

        def body(params, states, locals_, options):
            (p,), (s,) = params, states
            return (p * 2.0,), (s,), locals_, None

        step = mk((t,), body, name="cl_ss_step")
        buf.add_rows([1, 3, 3], np.ones((3, 4), np.float32))
        step(())
        assert buf.pending_deltas == 0
        got[pkg] = np.asarray(t.get())
    np.testing.assert_array_equal(got["t"], got["j"])
    # the buffered rows landed BEFORE the fused double: (0 + 1) * 2, (0 +
    # 2) * 2
    np.testing.assert_array_equal(got["t"][[1, 3, 0], 0], [2.0, 4.0, 0.0])


def test_superstep_flushes_dense_buffer_first():
    t = ArrayTable(8, "float32", device="cpu", name="cl_ss2")
    buf = client.CoalescingBuffer(t, max_deltas=100)

    def body(params, states, locals_, options):
        (p,), (s,) = params, states
        return (p * 2.0,), (s,), locals_, None

    step = make_superstep((t,), body, name="cl_ss2_step")
    buf.add(np.ones(8, np.float32))
    step(())
    np.testing.assert_allclose(t.get(), 2.0)


def test_store_includes_buffered(mesh1, tmp_path):
    got = {}
    for pkg, Table, cl, mesh in (("j", JArrayTable, jclient, mesh1),
                                 ("t", ArrayTable, client, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(8, "float32", name="cl_store", **kw)
        buf = cl.CoalescingBuffer(t, max_deltas=100)
        buf.add(np.ones(8, np.float32))
        uri = str(tmp_path / f"{pkg}.npz")
        t.store(uri)
        got[pkg] = uri
    # each package's file loads in the other with the buffered delta in it
    for pkg, Table, mesh in (("j", JArrayTable, mesh1),
                             ("t", ArrayTable, "cpu")):
        for src in ("j", "t"):
            kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
            t2 = Table(8, "float32", name="cl_store2", **kw)
            t2.load(got[src])
            np.testing.assert_allclose(_dense(t2), 1.0)


def test_load_flushes_buffered_first(tmp_path):
    t = ArrayTable(8, "float32", device="cpu", name="cl_load")
    t.add(np.full(8, 5.0, np.float32))
    t.store(str(tmp_path / "a.npz"))
    buf = client.CoalescingBuffer(t, max_deltas=100)
    buf.add(np.ones(8, np.float32))
    t.load(str(tmp_path / "a.npz"))     # the buffered delta lands first
    assert buf.pending_deltas == 0 and buf.flush_generation == 1
    np.testing.assert_allclose(t.get(), 5.0)


# -- coalescing: KV ------------------------------------------------------------


def _kv_state(t):
    """(keys, values, state leaves) of either package's one-shard KV."""
    if isinstance(t, KVTable):
        return (t.keys.numpy(), t.values.numpy(),
                [t.state[k].numpy() for k in sorted(t.state)])
    return (np.asarray(t.keys).view(np.int32), np.asarray(t.values),
            [np.asarray(x) for x in jax.tree.leaves(t.state)])


def _assert_kv_equal(tt, jt):
    (tk, tv, ts), (jk, jv, js) = _kv_state(tt), _kv_state(jt)
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(tv, jv, rtol=KV_RTOL, atol=KV_ATOL)
    assert len(ts) == len(js)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=KV_ATOL)
    assert len(tt) == len(jt)


def test_dup_keys_presummed_one_dispatch(mesh1):
    tabs = {}
    for pkg, KV, cl, m, mesh in (("j", JKVTable, jclient, jmetrics, mesh1),
                                 ("t", KVTable, client, tmetrics, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        kv = KV(1024, value_dim=2, name="cl_kv1", **kw)
        buf = cl.CoalescingBuffer(kv, max_deltas=3)
        c0 = _calls(m, "kv.apply.cl_kv1")
        buf.add_kv(np.array([1, 2], np.uint64), np.ones((2, 2), np.float32))
        buf.add_kv(np.array([2, 3], np.uint64), np.ones((2, 2), np.float32))
        buf.add_kv(np.array([3, 4], np.uint64), np.ones((2, 2), np.float32))
        assert _calls(m, "kv.apply.cl_kv1") - c0 == 1
        vals, found = kv.get(np.array([1, 2, 3, 4], np.uint64))
        assert np.asarray(found).all()
        np.testing.assert_allclose(np.asarray(vals)[:, 0],
                                   [1.0, 2.0, 2.0, 1.0])
        tabs[pkg] = kv
    _assert_kv_equal(tabs["t"], tabs["j"])


@pytest.mark.parametrize("updater", ["sgd", "adagrad", "ftrl"])
@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_kv_coalescing_matches_reference(mesh1, updater, form):
    """Overlapping key batches through K=3 groups under a stateful
    updater: the port (host deltas, or tensor deltas and keys pre-summed
    by the row scatter-add's plain version) equals the reference."""
    rng = np.random.default_rng(11)
    batches = []
    for _ in range(7):
        keys = rng.choice(np.arange(1, 200, dtype=np.uint64), size=40,
                          replace=False)
        batches.append((keys, rng.normal(size=(40, 2)).astype(np.float32)))
    tabs = {}
    for pkg, KV, cl, mesh in (("j", JKVTable, jclient, mesh1),
                              ("t", KVTable, client, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        kv = KV(1024, value_dim=2, updater=updater, name="cl_kv", **kw)
        buf = cl.CoalescingBuffer(kv, max_deltas=3)
        for keys, d in batches:
            if pkg == "t" and form == "tensor":
                keys = torch.from_numpy(keys.view(np.int64))
                d = torch.from_numpy(d)
            buf.add_kv(keys, d)
        buf.flush()
        tabs[pkg] = kv
    _assert_kv_equal(tabs["t"], tabs["j"])


def test_kv_tensor_keys_sort_as_unsigned():
    """Keys past 2^63 (negative as int64 tensors) unique in uint64 order,
    so their lanes reach the table in the host path's order: the tables
    equal bit for bit."""
    rng = np.random.default_rng(2)
    keys = [rng.integers(1, 2 ** 64 - 2, size=30, dtype=np.uint64)
            for _ in range(4)]
    keys = [np.unique(k) for k in keys]
    ds = [rng.normal(size=len(k)).astype(np.float32) for k in keys]
    out = []
    for form in ("numpy", "tensor"):
        kv = KVTable(512, value_dim=0, slots_per_bucket=4, updater="adagrad",
                     device="cpu", name=f"cl_kv_{form}")
        buf = client.CoalescingBuffer(kv, max_deltas=4)
        for k, d in zip(keys, ds):
            if form == "tensor":
                k, d = torch.from_numpy(k.view(np.int64)), torch.from_numpy(d)
            buf.add_kv(k, d)
        assert buf.flush_generation == 1
        out.append(_kv_state(kv))
    for a, b in zip(out[0][:2], out[1][:2]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(out[0][2], out[1][2]):
        np.testing.assert_array_equal(a, b)


def test_presum_equals_numpy_left_fold():
    """The tensor pre-sum (the row scatter-add's plain version on the CPU)
    against ``np.add.at`` at widths 1 and 2, with runs of a key longer
    than 32 lanes: bit for bit."""
    rng = np.random.default_rng(9)
    for width in (1, 2):
        inv = np.concatenate([rng.integers(0, 50, 300),
                              np.full(70, 7)]).astype(np.int64)
        rng.shuffle(inv)
        d = (rng.normal(size=(len(inv), width)) * 10.0 ** rng.integers(
            -3, 4, (len(inv), 1))).astype(np.float32)
        want = np.zeros((50, width), np.float32)
        np.add.at(want, inv, d)
        got = torch.zeros(50, width)
        coalesce.presum(got, torch.from_numpy(inv), torch.from_numpy(d))
        np.testing.assert_array_equal(got.numpy(), want)


def test_kv_wait_observes_buffered(mesh1):
    for pkg, KV, cl, mesh in (("j", JKVTable, jclient, mesh1),
                              ("t", KVTable, client, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        kv = KV(512, value_dim=0, name="cl_kv2", **kw)
        buf = cl.CoalescingBuffer(kv, max_deltas=100)
        h = buf.add_kv(np.array([7], np.uint64), np.ones(1, np.float32))
        h.wait()
        vals, found = kv.get(np.array([7], np.uint64))
        assert bool(np.asarray(found)[0]) and float(np.asarray(vals)[0]) == 1.0


# -- coalescing: rows and COO ---------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_rows_coalesce_one_scatter(devices, shape):
    jm, tm = _meshes(devices, shape)
    got = {}
    for pkg, Table, cl, m, mesh in (
            ("j", JMatrixTable, jclient, jmetrics, jm),
            ("t", MatrixTable, client, tmetrics, tm)):
        t = Table(16, 4, "float32", mesh=mesh, name="cl_rows")
        buf = cl.CoalescingBuffer(t, max_deltas=2)
        c0 = _calls(m, "table.scatter_add.cl_rows")
        buf.add_rows([1, 3], np.ones((2, 4), np.float32))
        buf.add_rows([3, 5], np.ones((2, 4), np.float32))
        assert _calls(m, "table.scatter_add.cl_rows") - c0 == 1
        got[pkg] = np.asarray(t.get_rows([1, 3, 5]))
    np.testing.assert_array_equal(got["t"], got["j"])
    np.testing.assert_allclose(got["t"][:, 0], [1.0, 2.0, 1.0])


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_rows_stateful_updater_dedup(mesh1, form):
    """Duplicate row ids across buffered adds pre-sum, satisfying the
    stateful-updater unique-ids rule: the flushed (ids, summed deltas)
    equal the reference's bit for bit, the adagrad tables within the
    dense tables' tolerance."""
    rng = np.random.default_rng(4)
    adds = [(rng.integers(0, 16, 6), rng.normal(size=(6, 4)).astype(
        np.float32)) for _ in range(4)]
    adds = [(np.unique(i), d[:len(np.unique(i))]) for i, d in adds]
    got, flushed = {}, {}
    for pkg, Table, cl, mesh in (("j", JMatrixTable, jclient, mesh1),
                                 ("t", MatrixTable, client, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(16, 4, "float32", updater="adagrad", name="cl_rows_st",
                  **kw)
        seen, add_rows = flushed.setdefault(pkg, []), t.add_rows

        def recording(ids, deltas, *a, _add=add_rows, _seen=seen, **k):
            _seen.append((np.asarray(ids), np.asarray(deltas)))
            return _add(ids, deltas, *a, **k)

        t.add_rows = recording
        buf = cl.CoalescingBuffer(t, max_deltas=2)
        for ids, d in adds:
            if pkg == "t" and form == "tensor":
                ids, d = torch.from_numpy(ids), torch.from_numpy(d)
            buf.add_rows(ids, d)
        got[pkg] = np.asarray(t.get())
    assert len(flushed["t"]) == len(flushed["j"]) == 2
    for (ti, td), (ji, jd) in zip(flushed["t"], flushed["j"]):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(got["t"], got["j"], rtol=TABLE_RTOL,
                               atol=TABLE_ATOL)
    assert np.any(got["t"] != 0)


@pytest.mark.parametrize("form", ["numpy", "tensor"])
def test_coo_coalesce(mesh1, form):
    got = {}
    for pkg, Table, cl, m, mesh in (
            ("j", JSparseMatrixTable, jclient, jmetrics, mesh1),
            ("t", SparseMatrixTable, client, tmetrics, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(16, 8, "int32", name="cl_coo", **kw)
        buf = cl.CoalescingBuffer(t, max_deltas=2)
        c0 = _calls(m, "table.coo_scatter_add.cl_coo")
        adds = [([1, 2], [3, 4], [1, 1]), ([2, 5], [4, 6], [1, 1])]
        for r, c, v in adds:
            if pkg == "t" and form == "tensor":
                r, c, v = (torch.tensor(x) for x in (r, c, v))
            buf.add_sparse(r, c, v)
        assert _calls(m, "table.coo_scatter_add.cl_coo") - c0 == 1
        got[pkg] = np.asarray(t.get_rows([1, 2, 5]))
    np.testing.assert_array_equal(got["t"], got["j"])
    assert got["t"][0, 3] == 1 and got["t"][1, 4] == 2 \
        and got["t"][2, 6] == 1


def test_kind_change_flushes_boundary():
    t = MatrixTable(8, 2, "float32", device="cpu", name="cl_kind")
    buf = client.CoalescingBuffer(t, max_deltas=100)
    buf.add_rows([1], np.ones((1, 2), np.float32))
    buf.add(np.ones((8, 2), np.float32))     # dense closes the rows group
    assert buf.flush_generation == 1
    buf.flush()
    np.testing.assert_array_equal(t.get()[:2, 0], [1.0, 2.0])


def test_flush_through_and_context_manager():
    t = ArrayTable(4, "float32", device="cpu", name="cl_ft")
    with client.CoalescingBuffer(t, max_deltas=100) as buf:
        h1 = buf.add(np.ones(4, np.float32))
        buf.flush_through(5)             # a later ticket: nothing pending
        assert buf.flush_generation == 1 and h1.flushed()
        h2 = buf.add(np.ones(4, np.float32))
        buf.flush_through(0)             # ticket 0 already flushed
        assert buf.flush_generation == 1 and not h2.flushed()
    assert buf.flush_generation == 2     # exit flushed the rest
    np.testing.assert_allclose(t.get(), 2.0)


def test_coalescer_knob_binding_moves_k_live():
    from multiverso_tpu_torch.control import knobs
    t = ArrayTable(4, "float32", device="cpu", name="cl_knob")
    buf = client.CoalescingBuffer(t, max_deltas=2)
    lbl = f"{t.table_id}:cl_knob"
    assert knobs.current()["client.coalesce_k"][lbl] == 2
    assert knobs.step("client.coalesce_k", 1, label=lbl) == [(lbl, 2, 4)]
    for _ in range(3):
        buf.add(np.ones(4, np.float32))
    assert buf.flush_generation == 0     # K is 4 now
    buf.add(np.ones(4, np.float32))
    assert buf.flush_generation == 1


# -- cached view ----------------------------------------------------------------


def test_never_exceeds_staleness_bound(mesh1):
    for pkg, Table, cl, mesh in (("j", JArrayTable, jclient, mesh1),
                                 ("t", ArrayTable, client, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(16, "float32", name="cl_view1", **kw)
        view = cl.CachedView(t, max_staleness=2)
        try:
            for i in range(10):
                t.add(np.ones(16, np.float32))
                got = view.get()
                assert t.generation - view.generation <= 2, (pkg, i)
                # what it serves is the table at the served generation
                assert float(got[0]) == view.generation
        finally:
            view.close()


def test_hit_serves_cached_without_dispatch(mesh1):
    for pkg, Table, cl, m, mesh in (
            ("j", JArrayTable, jclient, jmetrics, mesh1),
            ("t", ArrayTable, client, tmetrics, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(16, "float32", name="cl_view2", **kw)
        view = cl.CachedView(t, max_staleness=0, background=False)
        c0 = _calls(m, "table.snapshot.cl_view2")
        for _ in range(5):
            view.get()
        assert _calls(m, "table.snapshot.cl_view2") - c0 == 0
        lbl = f"{t.table_id}:{t.name}"
        assert m.registry().counter("client.cache.hits",
                                    table=lbl).value >= 5


def test_refresh_after_update_sync(mesh1):
    for pkg, Table, cl, m, mesh in (
            ("j", JArrayTable, jclient, jmetrics, mesh1),
            ("t", ArrayTable, client, tmetrics, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(8, "float32", name="cl_view3", **kw)
        view = cl.CachedView(t, max_staleness=0, background=False)
        t.add(np.ones(8, np.float32))
        np.testing.assert_allclose(view.get(), 1.0)
        lbl = f"{t.table_id}:{t.name}"
        assert m.registry().counter("client.cache.misses",
                                    table=lbl).value >= 1


def test_background_refresh_catches_up():
    t = ArrayTable(8, "float32", device="cpu", name="cl_view4")
    view = client.CachedView(t, max_staleness=1)
    try:
        t.add(np.ones(8, np.float32))   # wakes the refresher
        deadline = time.time() + 10.0
        while view.staleness() > 0 and time.time() < deadline:
            view.get()                  # absorbs finished refreshes
            time.sleep(0.01)
        assert view.staleness() == 0
        np.testing.assert_allclose(view.get(), 1.0)
        assert view.staging_allocs == 1
    finally:
        view.close()


def test_superstep_advances_generation_for_view(mesh1):
    for pkg, Table, cl, mk, mesh in (
            ("j", JArrayTable, jclient, jmake_superstep, mesh1),
            ("t", ArrayTable, client, make_superstep, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(8, "float32", name="cl_view5", **kw)
        view = cl.CachedView(t, max_staleness=0, background=False)

        def body(params, states, locals_, options):
            (p,), (s,) = params, states
            return (p + 1.0,), (s,), locals_, None

        step = mk((t,), body, name="cl_view5_step")
        step(())
        np.testing.assert_allclose(view.get(), 1.0)


def test_close_idempotent():
    t = ArrayTable(8, "float32", device="cpu", name="cl_view6")
    view = client.CachedView(t, max_staleness=1)
    view.close()
    view.close()
    t.add(np.ones(8, np.float32))       # a closed view queues nothing
    np.testing.assert_allclose(view.get(max_staleness=0), 1.0)


def test_per_get_staleness_override(mesh1):
    for pkg, Table, cl, m, mesh in (
            ("j", JArrayTable, jclient, jmetrics, mesh1),
            ("t", ArrayTable, client, tmetrics, "cpu")):
        kw = {"mesh": mesh} if pkg == "j" else {"device": mesh}
        t = Table(8, "float32", name="cl_view7", **kw)
        view = cl.CachedView(t, max_staleness=0, background=False)
        view.get()
        c0 = _calls(m, "table.snapshot.cl_view7")
        t.add(np.ones(8, np.float32))
        np.testing.assert_allclose(view.get(max_staleness=5), 0.0)
        assert _calls(m, "table.snapshot.cl_view7") - c0 == 0
        np.testing.assert_allclose(view.get(max_staleness=0), 1.0)
        assert _calls(m, "table.snapshot.cl_view7") - c0 >= 1
        t.add(np.ones(8, np.float32))
        np.testing.assert_allclose(view.get(), 2.0)
        with pytest.raises(ValueError):
            view.get(max_staleness=-1)


def test_served_array_never_mutated_by_later_refresh():
    """An array a ``get`` returned stays as it was through later adds and
    background refreshes (the worker copies out of the one staging
    buffer); the view keeps that one buffer."""
    t = MatrixTable(6, 3, "float32", device="cpu", name="cl_view8")
    view = client.CachedView(t, max_staleness=0)
    try:
        served = []
        for i in range(6):
            t.add_rows([i % 6], np.ones((1, 3), np.float32))
            got = view.get()
            served.append((got, got.copy()))
            time.sleep(0.005)
        for got, snap in served:
            np.testing.assert_array_equal(got, snap)
        assert len({id(g) for g, _ in served}) == len(served)
        assert view.staging_allocs <= 1
    finally:
        view.close()


def test_view_knob_binding_widens_bound_live():
    from multiverso_tpu_torch.control import knobs
    t = ArrayTable(4, "float32", device="cpu", name="cl_view9")
    view = client.CachedView(t, max_staleness=0, background=False)
    lbl = f"{t.table_id}:cl_view9"
    knobs.set("client.staleness", 3, label=lbl)
    assert view.max_staleness == 3
    t.add(np.ones(4, np.float32))
    np.testing.assert_allclose(view.get(), 0.0)   # within the new bound


# -- staging ----------------------------------------------------------------------


def _staging_batches(seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(6):
        keys = rng.choice(np.arange(1, 64, dtype=np.uint64), size=16,
                          replace=False)
        out.append((keys, rng.normal(size=16).astype(np.float32)))
    return out


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_staged_equals_direct(mesh1, depth):
    batches = _staging_batches()
    a = KVTable(512, value_dim=0, updater="adagrad", device="cpu",
                name="cl_st_direct")
    for keys, deltas in batches:
        a.add(keys, deltas)
    b = KVTable(512, value_dim=0, updater="adagrad", device="cpu",
                name="cl_st_staged")
    client.stage_kv_adds(b, batches, depth=depth).wait()
    for x, y in zip(_kv_state(a)[:2], _kv_state(b)[:2]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(_kv_state(a)[2], _kv_state(b)[2]):
        np.testing.assert_array_equal(x, y)
    # and the reference's staged run
    j = JKVTable(512, value_dim=0, updater="adagrad", mesh=mesh1,
                 name="cl_st_ref")
    jclient.stage_kv_adds(j, batches, depth=depth).wait()
    _assert_kv_equal(b, j)


def test_staged_tensor_deltas_equal_direct():
    batches = [(k, torch.from_numpy(d)) for k, d in _staging_batches(3)]
    a = KVTable(512, value_dim=0, device="cpu", name="cl_st_t1")
    for keys, deltas in batches:
        a.add(keys, deltas)
    b = KVTable(512, value_dim=0, device="cpu", name="cl_st_t2")
    client.stage_kv_adds(b, batches, depth=2).wait()
    np.testing.assert_array_equal(a.values.numpy(), b.values.numpy())
    np.testing.assert_array_equal(a.keys.numpy(), b.keys.numpy())


def test_prepare_error_surfaces():
    kv = KVTable(512, value_dim=0, device="cpu", name="cl_st_err")
    w = client.KVStagingWriter(kv, depth=1)
    w.add(np.array([1, 1], np.uint64), np.ones(2, np.float32))
    with pytest.raises(ValueError, match="duplicate keys"):
        w.flush()
    w.close()


def test_non_pow2_batch_padded():
    kv = KVTable(512, value_dim=0, device="cpu", name="cl_st_pad")
    with client.KVStagingWriter(kv, depth=2) as w:
        w.add(np.arange(1, 6, dtype=np.uint64), np.ones(5, np.float32))
    assert len(kv) == 5
    vals, found = kv.get(np.arange(1, 9, dtype=np.uint64))
    assert found[:5].all() and not found[5:].any()
    np.testing.assert_allclose(vals[:5], 1.0)


# -- the table hooks ------------------------------------------------------------


def test_overflow_deferral_reads_the_ports_entries():
    """The port's pending-overflow entries are ``(flag, events,
    host_buckets)`` (ROADMAP queue C, reference failure 3): an entry whose
    event has not completed stays pending through the add path's poll
    and surfaces at the next blocking table op."""

    class _Pending:
        def query(self):
            return False

        def synchronize(self):
            pass

    kv = KVTable(64, value_dim=0, device="cpu", name="cl_over")
    kv.add(np.array([1], np.uint64), np.ones(1, np.float32))
    kv._pending_over.append((torch.tensor(3), [_Pending()], None))
    kv._poll_overflow()
    assert any(int(e[0]) == 3 for e in kv._pending_over)
    with pytest.raises(RuntimeError, match="overflowed"):
        kv.wait()


def test_snapshot_kv_async_survives_the_next_add():
    kv = KVTable(64, value_dim=2, device="cpu", name="cl_snap")
    kv.add(np.array([1, 2], np.uint64), np.ones((2, 2), np.float32))
    keys, vals = kv.snapshot_kv_async()
    k0, v0 = keys.clone(), vals.clone()
    kv.add(np.array([1, 3], np.uint64), np.ones((2, 2), np.float32))
    assert torch.equal(keys, k0) and torch.equal(vals, v0)
    assert not torch.equal(vals, kv.values)


def test_hooks_hold_weakrefs_and_kv_notifies_views():
    kv = KVTable(64, value_dim=0, device="cpu", name="cl_refs")

    class _View:
        n = 0

        def _on_table_update(self):
            _View.n += 1

    v = _View()
    kv._attach_view(v)
    kv.add(np.array([1], np.uint64), np.ones(1, np.float32))
    assert _View.n == 1
    del v
    kv.add(np.array([2], np.uint64), np.ones(1, np.float32))
    assert _View.n == 1 and kv._view_refs == []
    buf = client.CoalescingBuffer(kv, max_deltas=10)
    buf.add_kv(np.array([3], np.uint64), np.ones(1, np.float32))
    kv.flush_coalesced()
    assert buf.pending_deltas == 0
    del buf
    kv.flush_coalesced()
    assert kv._coalescer_refs == []


@pytest.mark.parametrize("op", ["put_raw", "put_views", "load"])
def test_every_generation_bump_wakes_views(tmp_path, op):
    t = ArrayTable(8, "float32", device="cpu", name="cl_bump")
    t.store(str(tmp_path / "t.npz"))
    view = client.CachedView(t, max_staleness=0)
    try:
        if op == "put_raw":
            t.put_raw(torch.ones(8))
        elif op == "put_views":
            t.put_views([torch.ones(8)])
        else:
            t.load(str(tmp_path / "t.npz"))
        assert view._inflight or view.generation == t.generation
    finally:
        view.close()


# -- env knobs ----------------------------------------------------------------


def test_coalesce_from_env(monkeypatch):
    for cl in (jclient, client):
        monkeypatch.delenv("MVTPU_COALESCE", raising=False)
        assert cl.coalesce_from_env() == 0
        monkeypatch.setenv("MVTPU_COALESCE", "8")
        assert cl.coalesce_from_env() == 8
        monkeypatch.setenv("MVTPU_COALESCE", "junk")
        assert cl.coalesce_from_env() == 0
    monkeypatch.setenv("MVTPU_COALESCE", "8")
    t = ArrayTable(8, "float32", device="cpu", name="cl_env1")
    buf = client.maybe_coalescing(t)
    assert isinstance(buf, client.CoalescingBuffer) and buf.max_deltas == 8
    monkeypatch.setenv("MVTPU_COALESCE", "1")
    assert client.maybe_coalescing(t) is None
    assert (client.COALESCE_ENV, client.STALENESS_ENV) == \
        (jclient.COALESCE_ENV, jclient.STALENESS_ENV)


def test_staleness_from_env(monkeypatch):
    for cl in (jclient, client):
        monkeypatch.delenv("MVTPU_STALENESS", raising=False)
        assert cl.staleness_from_env() is None
        monkeypatch.setenv("MVTPU_STALENESS", "0")
        assert cl.staleness_from_env() == 0
        monkeypatch.setenv("MVTPU_STALENESS", "5000")
        assert cl.staleness_from_env() == 1024      # clamped
        monkeypatch.setenv("MVTPU_STALENESS", "junk")
        assert cl.staleness_from_env() is None
    monkeypatch.delenv("MVTPU_STALENESS")
    t = ArrayTable(8, "float32", device="cpu", name="cl_env2")
    assert client.maybe_cached_view(t) is None
    monkeypatch.setenv("MVTPU_STALENESS", "0")
    view = client.maybe_cached_view(t)
    assert isinstance(view, client.CachedView)
    view.close()


# -- ASyncBuffer (utils/async_buffer.py) ------------------------------------------


def test_async_buffer_ordered_fills():
    from multiverso_tpu_torch.utils import ASyncBuffer
    buf = ASyncBuffer(lambda i: i * i)
    assert [buf.get() for _ in range(5)] == [0, 1, 4, 9, 16]
    buf.stop()


def test_async_buffer_overlaps_fill_with_consumption():
    """The next fill runs while the caller still holds the last value:
    shown by conditions, not by a time margin (ROADMAP queue C, reference
    failure 9). Fill k+1 starts before the caller releases value k."""
    import threading
    from multiverso_tpu_torch.utils import ASyncBuffer
    started = [threading.Event() for _ in range(4)]

    def fill(i):
        started[i].set()
        return i

    buf = ASyncBuffer(fill)
    try:
        for i in range(3):
            assert buf.get() == i
            # still "consuming" i: the fill of i + 1 starts meanwhile
            assert started[i + 1].wait(10.0)
    finally:
        buf.stop()


def test_async_buffer_one_persistent_worker_and_stop():
    import threading
    from multiverso_tpu_torch.utils import ASyncBuffer
    idents = []

    def fill(i):
        idents.append(threading.get_ident())
        return i

    buf = ASyncBuffer(fill, name="t_async")
    for _ in range(5):
        buf.get()
    buf.stop()
    assert len(set(idents)) == 1 and idents[0] != threading.get_ident()
    assert not buf._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        buf.get()


def test_async_buffer_poll_and_errors():
    import threading
    from multiverso_tpu_torch.utils import ASyncBuffer
    gate = threading.Event()
    buf = ASyncBuffer(lambda i: (gate.wait(10.0), i * 10)[1])
    assert buf.poll() is None           # the fill is blocked: not ready
    gate.set()
    deadline = time.time() + 10.0
    got = None
    while got is None and time.time() < deadline:
        got = buf.poll()
        time.sleep(0.005)
    assert got == 0
    buf.stop()

    def boom(i):
        raise ValueError("fill boom")

    bad = ASyncBuffer(boom)
    with pytest.raises(ValueError, match="fill boom"):
        bad.get()
    with pytest.raises(RuntimeError, match="stopped"):
        bad.poll()


def test_bfloat16_kv_table_is_refused():
    kv = KVTable(64, value_dim=2, dtype="bfloat16", device="cpu",
                 name="cl_bf16")
    with pytest.raises(TypeError, match="bfloat16"):
        client.CoalescingBuffer(kv)


def test_float16_kv_host_presum_matches_reference(mesh1):
    """float16 host deltas pre-sum with ``np.add.at`` in float16, as the
    reference's do: the flushed batch is bit for bit the reference's."""
    rng = np.random.default_rng(6)
    batches = [(rng.choice(np.arange(1, 100, dtype=np.uint64), 30,
                           replace=False),
                rng.normal(size=(30, 2)).astype(np.float32))
               for _ in range(5)]
    sums = {}
    for pkg, KV, cl, kw in (("j", JKVTable, jclient, {"mesh": mesh1}),
                            ("t", KVTable, client, {"device": "cpu"})):
        kv = KV(1024, value_dim=2, dtype="float16", name="cl_f16", **kw)
        buf = cl.CoalescingBuffer(kv, max_deltas=100)
        for k, d in batches:
            buf.add_kv(k, d)
        sums[pkg] = buf._summed_unique()
    np.testing.assert_array_equal(sums["t"][0], sums["j"][0])
    assert sums["t"][1].dtype == np.float16
    np.testing.assert_array_equal(sums["t"][1], np.asarray(sums["j"][1]))
