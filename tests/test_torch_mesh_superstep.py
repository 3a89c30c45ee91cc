"""The superstep over tables split on the model axis: the port's functional
forms over a ``ShardedParam`` and ``FusedSuperstep`` over (1, S) tables,
against the JAX package's functional forms and superstep on (1, S) meshes.

The reference runs ``gather_rows`` / ``row_scatter_add`` /
``coo_scatter_add`` under ``kernel_mesh_scope`` in its XLA engine
(``MVTPU_KERNELS=xla``) on a (1, S) mesh of its virtual CPU devices, on a
param sharded over ``model``; its sharded Pallas engine is not the oracle,
since it disagrees with its own XLA engine on this tree (ROADMAP queue
C). The port's forms take the same global arrays as S CPU shards, where
they run their plain versions.

Tolerances: everything here is exact, bit for bit. Gathers and int32 adds
are exact in any order; a float32 row (or COO element) takes its deltas in
lane order in both packages (XLA's CPU scatter goes lane by lane, the
port stable-sorts by row and adds each run in lane order). A (1, S)
superstep and the (1, 1) one end bit-identical. The one exception is a
superstep's aux, a float32 sum over a whole gather, which the two
frameworks reduce in another order: rtol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from multiverso_tpu import core as jcore
from multiverso_tpu.ops import table_kernels as jtk
from multiverso_tpu.tables import MatrixTable as JMatrixTable
from multiverso_tpu.tables import SparseMatrixTable as JSparseMatrixTable
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.tables import make_superstep as jmake_superstep
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import (MatrixTable, SparseMatrixTable,
                                         make_superstep)
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.tables import superstep as tss

SHARDS = [2, 4]


@pytest.fixture(autouse=True)
def _xla(monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    yield
    jcore.shutdown()
    tcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


def _jmesh(devices, s):
    return jcore.init(devices=devices[:s], data_parallel=1,
                      model_parallel=s)


def _tmesh(s):
    return tcore.Mesh([["cpu"] * s])


def _sharded(mesh, x):
    x = np.asarray(x)
    return jax.device_put(x, NamedSharding(
        mesh, P("model", *([None] * (x.ndim - 1)))))


def _param(x, s):
    return tk.ShardedParam(torch.from_numpy(np.ascontiguousarray(b).copy())
                           for b in np.split(np.asarray(x), s))


def _host(param):
    return torch.cat(param.shards).numpy()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _table(rng, rows, cols, dtype, tiled=False):
    if dtype == np.int32:
        x = rng.integers(-50, 50, (rows, cols)).astype(np.int32)
    else:
        x = rng.standard_normal((rows, cols)).astype(np.float32)
    return x.reshape(rows, cols // 128, 128) if tiled else x


def _in_scope(mesh, fn, *args):
    """``fn(*args)`` jitted inside the reference's kernel mesh scope, as
    its FusedSuperstep traces a body."""
    with jtk.kernel_mesh_scope(mesh, "model"):
        return np.asarray(jax.jit(fn)(*args))


# -- the three forms against the reference ------------------------------------


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dtype,tiled", [(np.float32, False),
                                         (np.int32, False),
                                         (np.float32, True)])
def test_gather_matches_reference(devices, s, dtype, tiled):
    rng = np.random.default_rng(s)
    jm = _jmesh(devices, s)
    x = _table(rng, 24, 256 if tiled else 6, dtype, tiled)
    ids = rng.integers(0, 24, 50).astype(np.int32)   # duplicates, any order
    want = _in_scope(jm, jtk.gather_rows, _sharded(jm, x), ids)
    param = _param(x, s)
    got = tss.gather_rows(param, torch.from_numpy(ids))
    _same(got.numpy(), want)
    assert tuple(got.shape) == (50, want.shape[1])
    _same(_host(param), x)                            # untouched


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_row_scatter_add_matches_reference(devices, s, dtype):
    rng = np.random.default_rng(10 + s)
    jm = _jmesh(devices, s)
    x = _table(rng, 32, 5, dtype)
    # Zipf-skewed: long runs of the low rows, every shard touched
    ids = np.clip(rng.zipf(1.3, 300) - 1, 0, 31).astype(np.int32)
    ids[:8] = np.arange(0, 32, 4)
    d = _table(rng, 300, 5, dtype)
    want = _in_scope(jm, jtk.row_scatter_add, _sharded(jm, x), ids, d)
    param = _param(x, s)
    out = tss.row_scatter_add(param, torch.from_numpy(ids),
                              torch.from_numpy(d))
    assert out is param
    _same(_host(param), want)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("dtype,tiled", [(np.int32, False),
                                         (np.int32, True),
                                         (np.float32, False),
                                         (np.float32, True)])
def test_coo_scatter_add_matches_reference(devices, s, dtype, tiled):
    rng = np.random.default_rng(20 + s)
    jm = _jmesh(devices, s)
    cols = 256
    x = _table(rng, 16, cols, dtype, tiled)
    n = 400
    rows = np.clip(rng.zipf(1.2, n) - 1, 0, 15).astype(np.int32)
    cc = rng.integers(0, cols, n).astype(np.int32)
    cc[:50] = 3                      # repeated elements in one row
    vals = (rng.integers(-3, 4, n) if dtype == np.int32
            else rng.standard_normal(n)).astype(dtype)
    want = _in_scope(jm, jtk.coo_scatter_add, _sharded(jm, x), rows, cc,
                     vals)
    param = _param(x, s)
    tss.coo_scatter_add(param, *(torch.from_numpy(a)
                                 for a in (rows, cc, vals)))
    _same(_host(param), want)


# -- the sharded param --------------------------------------------------------


def test_sharded_param_reads_like_a_global_array():
    param = _param(np.zeros((12, 3), np.float32), 4)
    assert param.shape == torch.Size((12, 3)) and param.shape[1] == 3
    assert param.dtype == torch.float32
    assert param.device == torch.device("cpu")
    assert param.rows_per_shard == 3
    tiled = _param(np.zeros((8, 2, 128), np.int32), 2)
    assert tiled.shape == torch.Size((8, 2, 128))


def test_uneven_or_mixed_shards_raise():
    with pytest.raises(ValueError, match="evenly"):
        tk.ShardedParam([torch.zeros(3, 2), torch.zeros(2, 2)])
    with pytest.raises(ValueError, match="evenly"):
        tk.ShardedParam([torch.zeros(3, 2), torch.zeros(3, 2,
                                                       dtype=torch.int32)])
    meta = tk.ShardedParam([torch.zeros(3, 2),
                            torch.zeros(3, 2, device="meta")])
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        tk.gather_rows(meta, torch.zeros(2, dtype=torch.int32))


def test_plain_versions_are_the_global_ops():
    """The mesh forms' plain versions equal the flat plain versions on the
    shards concatenated, and write the result back into the shards."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    ids = torch.tensor([7, 0, 7, 3], dtype=torch.int32)
    d = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    param = _param(x, 2)
    _same(tk.gather_rows_mesh_plain(param, ids).numpy(), x[ids.numpy()])
    shards_before = [t.data_ptr() for t in param.shards]
    tk.row_scatter_add_mesh_plain(param, ids, d)
    assert [t.data_ptr() for t in param.shards] == shards_before
    _same(_host(param), tk.row_scatter_add_plain(
        torch.from_numpy(x.copy()), ids, d).numpy())
    tk.coo_scatter_add_mesh_plain(param, ids, ids % 4, d[:, 0])
    want = tk.row_scatter_add_plain(torch.from_numpy(x.copy()), ids, d)
    tk.coo_scatter_add_plain(want, ids, ids % 4, d[:, 0])
    _same(_host(param), want.numpy())


def test_launch_counts_stay_zero_on_the_cpu():
    tk.reset_launches()
    param = _param(np.zeros((8, 2), np.float32), 4)
    ids = torch.tensor([1, 5], dtype=torch.int32)
    tss.gather_rows(param, ids)
    tss.row_scatter_add(param, ids, torch.ones(2, 2))
    tss.coo_scatter_add(param, ids, ids % 2, torch.ones(2))
    assert all(v == 0 for v in tk.LAUNCHES.values())


# -- FusedSuperstep over (1, S) tables ----------------------------------------


def _body(ss):
    def body(params, states, locals_, options, ids, deltas, rows, cols,
             vals):
        w, c = params
        g = ss.gather_rows(w, ids)
        w = ss.row_scatter_add(w, ids, g * 0.5 + deltas)
        c = ss.coo_scatter_add(c, rows, cols, vals)
        (calls,) = locals_
        return (w, c), states, (calls + 1,), g.sum()
    return body


def _superstep_inputs(seed):
    rng = np.random.default_rng(seed)
    ids = np.clip(rng.zipf(1.3, 40) - 1, 0, 22).astype(np.int32)
    deltas = rng.standard_normal((40, 8)).astype(np.float32)
    rows = np.clip(rng.zipf(1.2, 300) - 1, 0, 20).astype(np.int32)
    cols = rng.integers(0, 256, 300).astype(np.int32)
    vals = rng.integers(-2, 3, 300).astype(np.int32)
    return ids, deltas, rows, cols, vals


@pytest.mark.parametrize("s", SHARDS)
def test_superstep_matches_reference(devices, s):
    """The reference's own sharded-superstep test body (a gather, a row
    scatter-add of gathered rows and a COO add into a tiled int32 table)
    on (1, S) tables of both packages, two calls."""
    from multiverso_tpu.tables import superstep as jss
    jm, tm = _jmesh(devices, s), _tmesh(s)
    init = np.random.default_rng(5).standard_normal((23, 8)).astype(
        np.float32)
    jw = JMatrixTable(23, 8, init_value=init, mesh=jm, name="j_w")
    jc = JSparseMatrixTable(21, 256, "int32", tiled=True, mesh=jm,
                            name="j_c")
    tw = MatrixTable(23, 8, init_value=init, mesh=tm, name="t_w")
    tc = SparseMatrixTable(21, 256, "int32", tiled=True, mesh=tm,
                           name="t_c")
    jstep = jmake_superstep([jw, jc], _body(jss), name="j_ss")
    tstep = make_superstep([tw, tc], _body(tss), name="t_ss")
    for call in range(2):
        args = _superstep_inputs(call)
        jl, jaux = jstep((call,), *(jcore.place(a, mesh=jm) for a in args))
        tl, taux = tstep((call,), *(torch.from_numpy(a) for a in args))
        assert tl == (call + 1,) and int(jl[0]) == call + 1
        # the aux is a sum over all of g: another order in each package
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    jw.wait()
    _same(tw.get(), jw.get())
    _same(tc.get(), jc.get())
    assert len(tw.shards) == s and len(tc.shards) == s
    assert tw.default_option.step == jw.default_option.step == 2
    assert tw.generation == 2 and tstep.handle().generation == 2


@pytest.mark.parametrize("s", SHARDS)
def test_superstep_sharded_equals_one_shard(s):
    """The same superstep on (1, S) and (1, 1) tables: bit-identical
    tables and aux; the storage of the split tables stays their shards,
    updated in place."""
    init = np.random.default_rng(6).standard_normal((23, 8)).astype(
        np.float32)
    out = []
    for mesh in (_tmesh(1), _tmesh(s)):
        w = MatrixTable(23, 8, init_value=init, mesh=mesh, name="w")
        c = SparseMatrixTable(21, 256, "int32", tiled=True, mesh=mesh,
                              name="c")
        ptrs = [t.data_ptr() for t in w.shards]
        step = make_superstep([w, c], _body(tss))
        auxes = [float(step((0,), *(torch.from_numpy(a) for a in
                                    _superstep_inputs(seed)))[1])
                 for seed in (1, 2)]
        assert [t.data_ptr() for t in w.shards] == ptrs
        out.append((w.get(), c.get(), auxes))
    _same(out[1][0], out[0][0])
    _same(out[1][1], out[0][1])
    assert out[1][2] == out[0][2]


def test_superstep_takes_state_and_whole_tensors_back():
    """A split table with updater state: the body gets each leaf as a
    ShardedParam and may hand back a whole tensor of the storage shape,
    which is cut into the table's shards."""
    t = MatrixTable(10, 3, updater="adagrad", mesh=_tmesh(2), name="ada")
    t.add_rows([1, 7], np.ones((2, 3), np.float32))
    before = t.get()

    def body(params, states, locals_, options):
        (p,), (st,) = params, states
        assert isinstance(p, tk.ShardedParam) and p.shape == (12, 3)
        assert sorted(st) == ["h"] and isinstance(st["h"], tk.ShardedParam)
        whole = torch.cat(p.shards) * 2.0
        return (whole,), (st,), locals_, None

    make_superstep([t], body)(())
    np.testing.assert_array_equal(t.get(), before * 2.0)
    assert [tuple(x.shape) for x in t.shards] == [(6, 3), (6, 3)]
    assert float(t.shard_states[1]["h"][1].sum()) == 3.0   # row 7's state


def test_superstep_refuses_mixed_meshes():
    a = MatrixTable(8, 2, mesh=_tmesh(2), name="mix_a")
    b = MatrixTable(8, 2, device="cpu", name="mix_b")
    with pytest.raises(ValueError, match="different devices"):
        make_superstep([a, b], lambda *x: x)
