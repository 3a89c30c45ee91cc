"""``create_table`` (the reference's ``MV_CreateTable`` factory) and its
option dataclasses in the port against the JAX package's.

For each option type both factories build the table kind it selects,
with the same geometry (padded shape or bucket count), type, updater,
name and ``shard_update``; the port's option dataclasses carry the
reference's fields and defaults. The tables then take the same Add and
give the same Get: dense tables within rtol 1e-6 (the updaters' float32
rounding, as in ``tests/test_torch_tables.py``), integer counts and KV
keys exactly. The reference runs on its virtual CPU devices, the port on
``"cpu"`` meshes of the same shape.
"""

import dataclasses

import numpy as np
import pytest

import multiverso_tpu.tables as jtables
from multiverso_tpu import core as jcore
from multiverso_tpu.tables import base as jbase
import multiverso_tpu_torch.tables as ttables
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.tables import base as tbase

RTOL, ATOL = 1e-6, 1e-7
OPTIONS = ["ArrayTableOption", "MatrixTableOption",
           "SparseMatrixTableOption", "KVTableOption"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    yield
    jcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


@pytest.mark.parametrize("name", OPTIONS)
def test_option_fields_and_defaults_match(name):
    jf = dataclasses.fields(getattr(jtables, name))
    tf = dataclasses.fields(getattr(ttables, name))
    assert [(f.name, f.default) for f in tf] == \
        [(f.name, f.default) for f in jf]


def _options(kind, shard_update):
    """The same option in both packages."""
    kw = {
        "ArrayTableOption": dict(size=37, updater="adagrad",
                                 shard_update=shard_update),
        "MatrixTableOption": dict(num_rows=13, num_cols=5, updater="adam",
                                  shard_update=shard_update),
        "SparseMatrixTableOption": dict(num_rows=11, num_cols=256,
                                        dtype="int32", updater="default",
                                        tiled=True),
        "KVTableOption": dict(capacity=200, value_dim=2, updater="ftrl",
                              shard_update=shard_update),
    }[kind]
    kw["name"] = f"f_{kind}"
    return getattr(jtables, kind)(**kw), getattr(ttables, kind)(**kw)


def _exercise(kind, jt, tt, rng):
    """One Add and a Get through both tables."""
    if kind == "KVTableOption":
        keys = rng.choice(2 ** 40, 30, replace=False).astype(np.uint64)
        d = rng.normal(size=(30, 2)).astype(np.float32)
        jt.add(keys, d, sync=True)
        tt.add(keys, d, sync=True)
        jv, jf = jt.get(keys)
        tv, tf = tt.get(keys)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=ATOL)
        return
    if kind == "SparseMatrixTableOption":
        r = rng.integers(0, 11, 100)
        c = rng.integers(0, 256, 100)
        v = rng.integers(1, 4, 100).astype(np.int32)
        jt.add_sparse(r, c, v, sync=True)
        tt.add_sparse(r, c, v, sync=True)
        np.testing.assert_array_equal(tt.get(), np.asarray(jt.get()))
        return
    d = rng.normal(size=tt.logical_shape).astype(np.float32)
    jt.add(d, sync=True)
    tt.add(d, sync=True)
    np.testing.assert_allclose(tt.get(), np.asarray(jt.get()), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("kind", OPTIONS)
def test_create_table_matches_reference_factory(devices, kind, shape):
    dp, mp = shape
    jmesh = jcore.init(devices=devices[:dp * mp], data_parallel=dp,
                       model_parallel=mp)
    tmesh = tcore._build_mesh(["cpu"] * (dp * mp), dp, mp)
    jopt, topt = _options(kind, shard_update=dp > 1)
    jt = jtables.create_table(jopt)
    tt = ttables.create_table(topt, mesh=tmesh)
    assert type(tt).__name__ == type(jt).__name__
    assert tt.name == jt.name and tt.updater.name == jt.updater.name
    assert tt.mesh is tmesh and jt.mesh is jmesh
    if kind == "KVTableOption":
        assert (tt.num_buckets, tt.slots, tt.value_dim) == \
            (jt.num_buckets, jt.slots, jt.value_dim)
        assert tt.shard_update == jt.shard_update == (dp > 1)
        assert tt.dtype_name == jt.dtype.name
    else:
        assert tt.logical_shape == jt.logical_shape
        assert tt.padded_shape == jt.padded_shape
        assert tt.np_dtype == np.dtype(jt.dtype)
        assert tt.shard_update == getattr(jt, "shard_update", False)
    if kind == "SparseMatrixTableOption":
        assert tt.tiled and jt.tiled
    _exercise(kind, jt, tt, np.random.default_rng(OPTIONS.index(kind)))


def test_create_table_device_and_refusal():
    t = ttables.create_table(ttables.ArrayTableOption(5, init_value=2.0),
                             device="cpu")
    assert isinstance(t, ttables.ArrayTable) and t.mesh.size == 1
    np.testing.assert_array_equal(t.get(), np.full(5, 2.0, np.float32))
    kv = ttables.create_table(ttables.KVTableOption(64, slots_per_bucket=4),
                              device="cpu")
    assert kv.slots == 4 and kv.num_buckets == 16
    with pytest.raises(TypeError, match="unknown table option type"):
        ttables.create_table(object(), device="cpu")
    with pytest.raises(TypeError, match="unknown table option type"):
        jtables.create_table(object())
