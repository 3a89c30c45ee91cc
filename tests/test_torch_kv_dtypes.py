"""KVTable values in bfloat16 and float16: the port against the JAX package,
under all six updaters, and checkpoints of both types across the packages.

The reference's KVTable takes any value ``dtype``; its updaters meet a
2-byte param or delta with float32 option scalars, so every expression
that touches one is float32, and the result is cast back to the value's
type where the updater casts (``.astype(p.dtype)``) and at the write
(``multiverso_tpu/ops/table_kernels.py`` casts the Pallas result the same
way). The updater state stays float32. The port's plain twins (here, on
the CPU) follow that op order, and its CUDA kernels equal the twins bit
for bit (``tests/test_torch_cuda.py``).

Tolerances: keys, ``found`` and the overflow verdicts exact; values
within one unit in the last place of their type (``rtol`` 2^-8 for
bfloat16, 2^-11 for float16, the half-ulp bound of one rounding apart;
on these streams they came out bit-equal); updater state, float32, within
rtol 1e-5, atol 1e-7 (XLA contracts a*b + c into an FMA in momentum and
adam, a few float32 ulps). Checkpoints: every array bit for bit. The
reference writes a bfloat16 array as numpy's raw two-byte ``V2`` (numpy
has no bfloat16) and cannot read it back, its own files included (its
``astype`` of ``V2`` to bfloat16 raises; ROADMAP queue C); the port reads
and writes those bytes itself, under the reference's ``dtype`` name.
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.tables import KVTable as JKVTable
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import convert
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch import updaters as tup
from multiverso_tpu_torch.ops import table_kernels as tk
from multiverso_tpu_torch.tables import KVTable, create_table, KVTableOption
from multiverso_tpu_torch.tables import base as tbase

UPDATERS = ["default", "sgd", "adagrad", "momentum", "adam", "ftrl"]
DTYPES = {"bfloat16": (torch.bfloat16, 2.0 ** -8),
          "float16": (torch.float16, 2.0 ** -11)}
STATE_RTOL, STATE_ATOL = 1e-5, 1e-7


@pytest.fixture()
def mesh1(devices, monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    m = jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()


def _f32(x):
    """Values of either package as float32 (exact for 2-byte types)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _assert_close(jt, tt, dtype, where=""):
    rtol = DTYPES[dtype][1]
    np.testing.assert_array_equal(tt.keys.numpy(),
                                  np.asarray(jt.keys).view(np.int32))
    assert tt.values.dtype == DTYPES[dtype][0]
    np.testing.assert_allclose(_f32(tt.values), _f32(jt.values), rtol=rtol,
                               atol=0, err_msg=f"values {where}")
    for a, b in zip([tt.state[k] for k in sorted(tt.state)],
                    jax.tree.leaves(jt.state)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=f"state {where}")


@pytest.mark.parametrize("value_dim", [0, 3])
@pytest.mark.parametrize("updater", UPDATERS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_two_byte_values_match_reference(mesh1, dtype, updater, value_dim):
    """Adds of float32 deltas over a key pool, gets of present and missing
    keys: the port's 2-byte table against the reference's, step by
    step; a Get returns the values' type (a host Get of bfloat16 as
    float32, which numpy can hold)."""
    rng = np.random.default_rng(UPDATERS.index(updater) * 3 + value_dim)
    jt = JKVTable(1024, value_dim=value_dim, dtype=dtype, updater=updater,
                  mesh=mesh1, name="j", default_value=0.3)
    tt = KVTable(1024, value_dim=value_dim, dtype=dtype, updater=updater,
                 device="cpu", name="t", default_value=0.3)
    pool = rng.choice(2 ** 40, 120, replace=False).astype(np.uint64)
    for step in range(5):
        keys = rng.choice(pool, 50, replace=False)
        shape = (50, value_dim) if value_dim else (50,)
        deltas = rng.normal(size=shape).astype(np.float32)
        jt.add(keys, deltas, sync=True)
        tt.add(keys, deltas, sync=True)
        _assert_close(jt, tt, dtype, f"after add {step}")
    q = np.concatenate([pool[:20], np.arange(1, 6, dtype=np.uint64)])
    jv, jf = jt.get(q)
    tv, tf = tt.get_tensor(q)
    assert tv.dtype == DTYPES[dtype][0]
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_allclose(_f32(tv), _f32(jv), rtol=DTYPES[dtype][1],
                               atol=0)
    hv, _ = tt.get(q)
    assert hv.dtype == (np.float32 if dtype == "bfloat16" else np.float16)
    assert hv.tobytes() == tv.to(torch.from_numpy(hv).dtype).numpy().tobytes()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_two_byte_deltas_match_reference(mesh1, dtype):
    """Deltas in the values' own type: the reference keeps the caller's
    delta type, and so does the port (exact to float32 in the kernel)."""
    rng = np.random.default_rng(4)
    jt = JKVTable(512, value_dim=2, dtype=dtype, updater="sgd", mesh=mesh1,
                  name="j")
    tt = KVTable(512, value_dim=2, dtype=dtype, updater="sgd", device="cpu",
                 name="t")
    keys = rng.choice(2 ** 30, 40, replace=False).astype(np.uint64)
    for _ in range(3):
        d32 = rng.normal(size=(40, 2)).astype(np.float32)
        tdelta = torch.from_numpy(d32).to(DTYPES[dtype][0])
        jdelta = d32.astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                            else np.float16)
        jt.add(keys, jdelta, sync=True)
        tt.add(keys, tdelta, sync=True)
        _assert_close(jt, tt, dtype)


def _npz(path):
    data = np.load(path)
    return {k: data[k] for k in data.files}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_checkpoints_cross_the_packages_bit_for_bit(mesh1, tmp_path, dtype):
    """The same adds in both packages, stored: every array of the two
    files bit for bit (a bfloat16 one raw two-byte), the manifests'
    dtype the reference's name. The port loads the reference's file and
    stores it back unchanged; a float16 port file loads in the reference
    too, and a bfloat16 one raises there as the reference's own does."""
    rng = np.random.default_rng(6)
    kw = dict(capacity=512, value_dim=2, dtype=dtype, updater="adagrad")
    jt = JKVTable(mesh=mesh1, name="j", **kw)
    tt = KVTable(device="cpu", name="t", **kw)
    keys = rng.choice(2 ** 40, 60, replace=False).astype(np.uint64)
    deltas = rng.normal(size=(60, 2)).astype(np.float32)
    jt.add(keys, deltas, sync=True)
    tt.add(keys, deltas, sync=True)
    jt.store(str(tmp_path / "j.npz"))
    tt.store(str(tmp_path / "t.npz"))
    a, b = _npz(tmp_path / "j.npz"), _npz(tmp_path / "t.npz")
    assert sorted(a) == sorted(b)
    ma, mb = (json.loads(str(x.pop("manifest"))) for x in (a, b))
    assert ma["dtype"] == mb["dtype"] == dtype
    assert ma["crc32"] == mb["crc32"]
    for k in a:
        assert a[k].dtype.itemsize == b[k].dtype.itemsize, k
        assert a[k].tobytes() == b[k].tobytes(), k
    # the reference's file into a fresh port table and back out
    back = KVTable(device="cpu", name="back", **kw)
    back.load(str(tmp_path / "j.npz"))
    assert back.values.dtype == DTYPES[dtype][0]
    back.store(str(tmp_path / "back.npz"))
    c = _npz(tmp_path / "back.npz")
    c.pop("manifest")
    for k in a:
        assert a[k].tobytes() == c[k].tobytes(), k
    j2 = JKVTable(mesh=mesh1, name="j2", **kw)
    if dtype == "float16":
        j2.load(str(tmp_path / "t.npz"))
        _assert_close(j2, tt, dtype, "the reference loaded the port's")
    else:
        for f in ("t.npz", "j.npz"):
            with pytest.raises(ValueError, match="cast"):
                j2.load(str(tmp_path / f))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rehash_and_replicas_keep_the_bits(tmp_path, dtype):
    """A 2-byte checkpoint loads into another geometry (the rehash moves
    the raw values) and onto a (2, 2) mesh under shard_update, whose
    replicas hold the same bits; Gets agree bit for bit."""
    rng = np.random.default_rng(2)
    src = KVTable(256, value_dim=2, dtype=dtype, updater="ftrl",
                  device="cpu", name="src", default_value=0.1)
    keys = rng.choice(2 ** 40, 50, replace=False).astype(np.uint64)
    src.add(keys, rng.normal(size=(50, 2)).astype(np.float32))
    src.store(str(tmp_path / "s.npz"))
    mesh = tcore._build_mesh(["cpu"] * 4, 2, 2)
    for dst in (KVTable(100, value_dim=2, dtype=dtype, updater="ftrl",
                        device="cpu", slots_per_bucket=4, name="small",
                        default_value=0.1),
                KVTable(256, value_dim=2, dtype=dtype, updater="ftrl",
                        mesh=mesh, shard_update=True, name="mesh",
                        default_value=0.1)):
        dst.load(str(tmp_path / "s.npz"))
        q = np.concatenate([keys, np.arange(1, 4, dtype=np.uint64)])
        got, want = dst.get_tensor(q), src.get_tensor(q)
        assert got[0].dtype == DTYPES[dtype][0]
        assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
        assert torch.equal(got[1], want[1])
        for r in range(1, dst.n_replicas):
            for s in range(len(dst.devices)):
                assert torch.equal(dst.replica_values[r][s].view(torch.int16),
                                   dst.value_shards[s].view(torch.int16))


def test_load_kv_table_takes_ml_dtypes_bfloat16(mesh1):
    """convert.load_kv_table installs a reference bfloat16 table's
    ml_dtypes arrays bit for bit."""
    rng = np.random.default_rng(3)
    kw = dict(capacity=256, value_dim=3, dtype="bfloat16", updater="adam")
    jt = JKVTable(mesh=mesh1, name="j", **kw)
    tt = KVTable(device="cpu", name="t", **kw)
    keys = rng.choice(2 ** 40, 30, replace=False).astype(np.uint64)
    jt.add(keys, rng.normal(size=(30, 3)).astype(np.float32), sync=True)
    jv = np.asarray(jt.values)
    assert jv.dtype == ml_dtypes.bfloat16
    convert.load_kv_table(tt, np.asarray(jt.keys), jv,
                          [np.asarray(x) for x in jax.tree.leaves(jt.state)])
    assert tt.values.view(torch.int16).numpy().tobytes() == jv.tobytes()


def test_torch_dtype_parses_bfloat16_and_the_factory_takes_it():
    for name, want in (("bfloat16", torch.bfloat16),
                       ("float16", torch.float16),
                       (torch.bfloat16, torch.bfloat16),
                       (np.float32, torch.float32)):
        assert tbase.torch_dtype(name) == want
    t = create_table(KVTableOption(64, 2, dtype="bfloat16"), device="cpu")
    assert t.values.dtype == torch.bfloat16 and t.dtype_name == "bfloat16"


def test_card_refuses_other_types_naming_the_three(monkeypatch):
    """The CUDA branch (on CPU tensors with the launch replaced) refuses
    float64 values, naming the three types it takes, and state leaves
    that are not float32 (the updaters make every leaf float32)."""
    monkeypatch.setattr(tk, "_launch", lambda *a, **k: None)
    keys = torch.full((4, 2, 2), -1, dtype=torch.int32)
    q = torch.zeros(3, 2, dtype=torch.int32)
    b = torch.zeros(3, dtype=torch.int32)
    monkeypatch.setattr(tk, "_shard_kind", lambda shards: "cuda")
    with pytest.raises(TypeError, match="float32, bfloat16, float16"):
        tk.kv_lookup_sharded([keys], [torch.zeros(4, 2, dtype=torch.float64)],
                             q[None], b[None], torch.zeros(3, dtype=torch.int32))
    for vdt in (torch.float32, torch.bfloat16, torch.float16):
        for sdt in (torch.bfloat16, torch.float16, torch.float64):
            values = torch.zeros(4, 2, dtype=vdt)
            state = {"h": torch.zeros(4, 2, dtype=sdt)}
            with pytest.raises(TypeError, match="float32 state leaves"):
                tk._kv_leaves(values, state, tup.get_updater("adagrad"))
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        v = torch.zeros(4, 2, dtype=dt)
        assert len(tk._kv_leaves(v, {"h": torch.zeros(4, 2)},
                                 tup.get_updater("adagrad"))) == 1


def test_ctypes_signatures_match_the_c_entry_points():
    """Every C entry point of ``ops/csrc/*.cu`` has as many parameters as
    its ctypes signature in ``ops/_build.py`` (the KV lookup and commit
    took the value type, the replicas and the state block here): a
    mismatch would pass a float where a pointer goes, on the card only."""
    import re
    from multiverso_tpu_torch.ops import _build
    found = {}
    for src in _build.CSRC.glob("*.cu"):
        text = src.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"',
                                text, re.S):
            for name, params in re.findall(r"\bint (mv_\w+)\((.*?)\)\s*\{",
                                           block, re.S):
                found[name] = len([p for p in params.split(",")
                                   if p.strip()])
    assert set(found) == set(_build._SIGNATURES)
    for name, n in found.items():
        assert len(_build._SIGNATURES[name]) == n, name
