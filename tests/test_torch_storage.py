"""Tiered KV storage in the port (``multiverso_tpu_torch/storage``) against
the JAX package's (``multiverso_tpu/storage``).

Every case of ``tests/test_storage.py`` is mirrored here on the port under
its own name (the host arena + CRC-stamped disk spill file, the EWMA
placement policy, the TieredKVTable fault-in path against a plain
KVTable, the resume guarantee under a chaos kill storm). Where a case
checks something, the same history also runs through the JAX package —
its ``mesh8`` 4 x 2 CPU mesh, its XLA engine (``MVTPU_KERNELS=xla``), each
package a ``spill_dir`` of its own under ``tmp_path`` (a table of one
name writes ``<spill_dir>/<name>.spill`` in both packages) — and the two
are compared.

Tolerances: keys, ``found``, ``len()``, placement (``tier``, ``slot_of``,
``bucket_at``, each plan's victims), overflow verdicts, record and spill
bytes, option steps and generations are exact. Values and updater state
after adds agree with the JAX package within rtol 1e-6, atol 1e-7, as in
``tests/test_torch_kv_table.py`` (the two frameworks may round an
elementwise expression a few ulps apart); a lookup of loaded bytes and
everything between the port's own tables is bit for bit. bfloat16 records
and checkpoint payloads are compared as bytes (the reference cannot read
its own bfloat16 KV checkpoints; the port reads back only its own).
"""

import os
import re

import ml_dtypes
import numpy as np
import pytest
import torch

from multiverso_tpu import storage as jst
from multiverso_tpu.control import knobs as jknobs
from multiverso_tpu.ft import chaos as jchaos
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.control import knobs as tknobs
from multiverso_tpu_torch.ft.chaos import (ChaosCrash, install_chaos,
                                           uninstall_chaos)
from multiverso_tpu_torch.storage import (TIER_DEVICE, TIER_DISK, TIER_HOST,
                                          TIER_VIRGIN, DiskTier, HostTier,
                                          RecordSpec, TierConfig, TierManager,
                                          TieredKVTable, status_all)
from multiverso_tpu_torch.tables import KVTable, reset_tables
from multiverso_tpu_torch.telemetry import metrics as telemetry

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    yield
    uninstall_chaos()
    jchaos.uninstall_chaos()
    reset_tables()
    jbase.reset_tables()


def _spec(slots=4, value_dim=2, n_state=1):
    return RecordSpec(slots, value_dim, np.float32,
                      [np.float32] * n_state, 0.0)


def _rec(spec, seed=0):
    rng = np.random.default_rng(seed)
    rec = spec.empty()
    rec.keys[0] = [seed + 1, seed + 2]
    rec.values[:] = rng.normal(size=spec.val_shape).astype(np.float32)
    for leaf in rec.state:
        leaf[:] = rng.normal(size=spec.val_shape).astype(np.float32)
    return rec


def _assert_rec_equal(a, b):
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.values, b.values)
    assert len(a.state) == len(b.state)
    for x, y in zip(a.state, b.state):
        np.testing.assert_array_equal(x, y)


# the same record in both packages, values of each type: the port holds
# bfloat16 as its uint16 bit patterns, the reference as ml_dtypes' type
DTYPES = {"float32": (np.float32, np.float32),
          "float16": (np.float16, np.float16),
          "bfloat16": ("bfloat16", ml_dtypes.bfloat16)}


def _rec_pair(dtype, seed, slots=4, value_dim=2, n_state=2):
    tdt, jdt = DTYPES[dtype]
    tspec = RecordSpec(slots, value_dim, tdt, [np.float32] * n_state, 0.5)
    jspec = jst.RecordSpec(slots, value_dim, jdt, [np.float32] * n_state,
                           0.5)
    rng = np.random.default_rng(seed)
    jrec = jspec.empty()
    jrec.keys[:2] = rng.integers(0, 2 ** 32 - 1, (2, 2), dtype=np.uint32)
    jrec.values[:] = rng.normal(size=jspec.val_shape).astype(jdt)
    for leaf in jrec.state:
        leaf[:] = rng.normal(size=jspec.val_shape).astype(np.float32)
    trec = tspec.empty()
    trec.keys[:] = jrec.keys
    trec.values[:] = jrec.values.view(tspec.dtype)
    for a, b in zip(trec.state, jrec.state):
        a[:] = b
    return tspec, trec, jspec, jrec


class TestRecordSpec:
    def test_pack_unpack_roundtrip(self):
        spec = _spec(n_state=2)
        rec = _rec(spec, seed=3)
        got = spec.unpack(spec.pack(rec))
        _assert_rec_equal(rec, got)
        jspec = jst.RecordSpec(4, 2, np.float32, [np.float32] * 2, 0.0)
        assert jspec.pack(jst.BucketRecord(rec.keys, rec.values,
                                           rec.state)) == spec.pack(rec)

    def test_scalar_values_shape(self):
        spec = _spec(value_dim=0)
        assert spec.val_shape == (4,)
        _assert_rec_equal(spec.empty(),
                          spec.unpack(spec.pack(spec.empty())))
        jspec = jst.RecordSpec(4, 0, np.float32, [np.float32], 0.0)
        assert jspec.val_shape == spec.val_shape
        assert jspec.pack(jspec.empty()) == spec.pack(spec.empty())

    def test_bad_payload_length_rejected(self):
        spec = _spec()
        with pytest.raises(ValueError, match="bytes"):
            spec.unpack(b"\x00" * (spec.payload_nbytes - 1))

    def test_empty_is_all_empty(self):
        assert _spec().empty().live() == 0
        assert _rec(_spec()).live() == 1

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_pack_bytes_match_reference(self, dtype):
        """RecordSpec.pack of the same record: the same bytes in both
        packages, for float32, float16 and bfloat16 values (and the
        empty record's default value in each type)."""
        tspec, trec, jspec, jrec = _rec_pair(dtype, seed=7)
        assert tspec.payload_nbytes == jspec.payload_nbytes
        assert tspec.pack(trec) == jspec.pack(jrec)
        assert tspec.pack(tspec.empty()) == jspec.pack(jspec.empty())
        _assert_rec_equal(tspec.unpack(jspec.pack(jrec)), trec)


class TestHostTier:
    def test_put_take_roundtrip(self):
        spec = _spec()
        h = HostTier(2, spec)
        r0, r1 = _rec(spec, 0), _rec(spec, 1)
        h.put(10, r0)
        h.put(20, r1)
        assert h.full and len(h) == 2
        assert 10 in h and 30 not in h
        _assert_rec_equal(h.peek(10), r0)      # peek keeps the row
        _assert_rec_equal(h.take(10), r0)      # take frees it
        assert 10 not in h and not h.full
        _assert_rec_equal(h.take(20), r1)

    def test_duplicate_put_rejected(self):
        h = HostTier(2, _spec())
        h.put(1, _rec(_spec()))
        with pytest.raises(ValueError, match="already"):
            h.put(1, _rec(_spec()))

    def test_put_beyond_capacity_rejected(self):
        h = HostTier(1, _spec())
        h.put(1, _rec(_spec()))
        with pytest.raises(RuntimeError, match="full"):
            h.put(2, _rec(_spec()))

    def test_live_keys(self):
        spec = _spec()
        h = HostTier(3, spec)
        h.put(1, _rec(spec, 0))   # 1 live lane each
        h.put(2, _rec(spec, 1))
        h.put(3, spec.empty())
        assert h.live_keys() == 2
        assert not h.pinned       # plain memory unless asked


class TestDiskTier:
    def test_spill_fill_roundtrip(self, tmp_path):
        spec = _spec(n_state=2)
        d = DiskTier(str(tmp_path / "t.spill"), spec)
        r0, r1 = _rec(spec, 0), _rec(spec, 1)
        d.spill(5, r0)
        d.spill(9, r1)
        assert len(d) == 2 and 5 in d
        _assert_rec_equal(d.peek(5), r0)       # peek keeps the slot
        _assert_rec_equal(d.fill(5), r0)       # fill frees it
        assert 5 not in d
        d.spill(7, _rec(spec, 2))              # reuses slot 0
        assert d.nbytes() == 2 * d.record_nbytes
        _assert_rec_equal(d.fill(9), r1)

    def test_respill_overwrites_in_place(self, tmp_path):
        spec = _spec()
        d = DiskTier(str(tmp_path / "t.spill"), spec)
        d.spill(3, _rec(spec, 0))
        d.spill(3, _rec(spec, 1))
        assert len(d) == 1
        assert d.nbytes() == d.record_nbytes
        _assert_rec_equal(d.fill(3), _rec(spec, 1))

    def test_torn_record_fails_crc(self, tmp_path):
        spec = _spec()
        path = tmp_path / "t.spill"
        d = DiskTier(str(path), spec)
        d.spill(3, _rec(spec, 0))
        raw = bytearray(path.read_bytes())
        raw[-1] ^= 0xFF                        # flip a payload byte
        path.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="CRC mismatch"):
            d.fill(3)

    def test_stale_slot_fails_bucket_stamp(self, tmp_path):
        spec = _spec()
        path = tmp_path / "t.spill"
        d = DiskTier(str(path), spec)
        d.spill(3, _rec(spec, 0))
        raw = bytearray(path.read_bytes())
        raw[0] ^= 0xFF                         # corrupt the bucket id
        path.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="expected bucket 3"):
            d.fill(3)

    def test_byte_counters(self, tmp_path):
        spec = _spec()
        d = DiskTier(str(tmp_path / "t.spill"), spec)

        def bytes_ctr(direction):
            snap = telemetry.snapshot()
            return sum(v for k, v in snap["counters"].items()
                       if k.startswith("storage.bytes")
                       and f"dir={direction}" in k)

        s0, f0 = bytes_ctr("spill"), bytes_ctr("fill")
        d.spill(1, _rec(spec, 0))
        d.fill(1)
        assert bytes_ctr("spill") - s0 == d.record_nbytes
        assert bytes_ctr("fill") - f0 == d.record_nbytes

    def test_chaos_transient_fault_retried(self, tmp_path):
        """storage.spill/storage.fill sit INSIDE the retry closure: one
        injected transient error per op is invisible."""
        spec = _spec()
        d = DiskTier(str(tmp_path / "t.spill"), spec)
        install_chaos("storage.spill:error:times=1;"
                      "storage.fill:error:times=1")
        d.spill(1, _rec(spec, 0))
        _assert_rec_equal(d.fill(1), _rec(spec, 0))

    def test_chaos_crash_never_swallowed(self, tmp_path):
        spec = _spec()
        d = DiskTier(str(tmp_path / "t.spill"), spec)
        install_chaos("storage.spill:crash:times=1")
        with pytest.raises(ChaosCrash):
            d.spill(1, _rec(spec, 0))
        uninstall_chaos()
        assert 1 not in d                      # nothing committed
        d.spill(1, _rec(spec, 0))              # clean state: works

    def test_peek_all_reads_every_record_in_one_pass(self, tmp_path):
        """The export's one-pass read: every record a per-record peek
        gives, freed slots skipped, one transient fault retried, a torn
        record caught by its CRC; nothing freed."""
        spec = _spec(n_state=2)
        path = tmp_path / "t.spill"
        d = DiskTier(str(path), spec)
        assert d.peek_all() == {}
        for b in (5, 9, 2, 40):
            d.spill(b, _rec(spec, b))
        d.fill(9)                              # a free slot in the file
        install_chaos("storage.fill:error:times=1")
        got = d.peek_all()
        uninstall_chaos()
        assert sorted(got) == [2, 5, 40] and len(d) == 3
        for b, rec in got.items():
            _assert_rec_equal(rec, d.peek(b))
        raw = bytearray(path.read_bytes())
        raw[-1] ^= 0xFF                        # the last slot's payload
        path.write_bytes(bytes(raw))
        with pytest.raises(IOError, match="CRC mismatch"):
            d.peek_all()

    @pytest.mark.parametrize("dtype", sorted(DTYPES))
    def test_spill_file_bytes_match_reference(self, tmp_path, dtype):
        """The same spills, a re-spill and a fill that frees a slot for
        reuse, in both packages: the two spill files are the same bytes."""
        pairs = [_rec_pair(dtype, seed=s) for s in range(4)]
        tspec, jspec = pairs[0][0], pairs[0][2]
        t = DiskTier(str(tmp_path / "t.spill"), tspec)
        j = jst.DiskTier(str(tmp_path / "j.spill"), jspec)
        for disk, recs in ((t, [p[1] for p in pairs]),
                           (j, [p[3] for p in pairs])):
            disk.spill(11, recs[0])
            disk.spill(4, recs[1])
            disk.spill(11, recs[2])            # in place
            disk.fill(4)
            disk.spill(900, recs[3])           # reuses slot 1
        assert t.record_nbytes == j.record_nbytes == 16 + \
            tspec.payload_nbytes
        assert (tmp_path / "t.spill").read_bytes() == \
            (tmp_path / "j.spill").read_bytes()
        _assert_rec_equal(t.peek(900), pairs[3][1])


def _managers(tmp_path, total=8, device=2, host=1, alpha=0.5):
    """The same TierManager in both packages (port, reference)."""
    cfg = dict(device_buckets=device, host_buckets=host, alpha=alpha)
    t = TierManager("tm", total, TierConfig(
        spill_dir=str(tmp_path / "t"), **cfg), _spec())
    j = jst.TierManager("tm", total, jst.TierConfig(
        spill_dir=str(tmp_path / "j"), **cfg), jst.RecordSpec(
        4, 2, np.float32, [np.float32], 0.0))
    return t, j


def _same_manager(t, j):
    for name in ("tier", "slot_of", "bucket_at", "_score", "_stamp"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert list(t._free_slots) == list(j._free_slots)
    assert list(t.host.buckets()) == list(j.host.buckets())
    assert sorted(t.disk.buckets()) == sorted(j.disk.buckets())
    assert t.counts() == j.counts()


class TestTierManager:
    def test_virgin_fills_are_free(self, tmp_path):
        m, jm = _managers(tmp_path)
        plan = m.plan(np.array([0, 1]))
        jplan = jm.plan(np.array([0, 1]))
        assert plan.victims.size == 0
        assert sorted(plan.fills) == [0, 1]
        np.testing.assert_array_equal(plan.fills, jplan.fills)
        for b in plan.fills:
            rec, src = m.fetch(int(b))
            assert (rec, src) == jm.fetch(int(b))
            assert rec is None and src == "virgin"
            slot, was_used = m.assign_slot(int(b))
            assert (slot, was_used) == jm.assign_slot(int(b))
            assert not was_used                # no device write needed
        assert m.counts()["device"] == 2
        _same_manager(m, jm)

    def test_coldest_bucket_is_victim(self, tmp_path):
        for m in _managers(tmp_path):
            for b in (0, 1):
                m.fetch(b)
                m.assign_slot(b)
            m.touch(np.array([0]))
            m.touch(np.array([0]))             # 0 is hot, 1 cold
            plan = m.plan(np.array([0, 5]))
            assert list(plan.victims) == [1]
            assert list(plan.fills) == [5]
        _same_manager(*_managers(tmp_path / "again"))

    def test_demote_cascades_host_to_disk(self, tmp_path):
        m, jm = _managers(tmp_path, host=1)
        spec = m.spec
        for mgr in (m, jm):
            for b in (0, 1):
                mgr.fetch(b)
                mgr.assign_slot(b)
            mgr.demote(0, _rec(spec, 0))       # host has room
            assert mgr.tier[0] == TIER_HOST and 0 in mgr.host
            mgr.demote(1, _rec(spec, 1))       # host full: 0 spills
            assert mgr.tier[1] == TIER_HOST
            assert mgr.tier[0] == TIER_DISK and 0 in mgr.disk
        _same_manager(m, jm)
        assert (tmp_path / "t" / "tm.spill").read_bytes() == \
            (tmp_path / "j" / "tm.spill").read_bytes()
        # round trips preserve content through the cascade
        rec, src = m.fetch(0)
        assert src == "disk"
        _assert_rec_equal(rec, _rec(spec, 0))
        rec, src = m.fetch(1)
        assert src == "host"
        _assert_rec_equal(rec, _rec(spec, 1))

    def test_zero_host_budget_spills_direct(self, tmp_path):
        for m in _managers(tmp_path, host=0):
            m.fetch(0)
            m.assign_slot(0)
            m.demote(0, _rec(_spec(), 0))
            assert m.tier[0] == TIER_DISK

    def test_plan_wider_than_device_rejected(self, tmp_path):
        for m in _managers(tmp_path, device=2):
            with pytest.raises(ValueError, match="chunk"):
                m.plan(np.array([0, 1, 2]))

    def test_status_counts(self, tmp_path):
        m, jm = _managers(tmp_path)
        for mgr in (m, jm):
            mgr.fetch(0)
            mgr.assign_slot(0)
        st = m.status()
        assert st["table"] == "tm" and st["resident"] == 1
        assert st["virgin"] == 7
        c = m.counts()
        assert c["device"] == 1 and c["virgin"] == 7
        assert m.tier[0] == TIER_DEVICE
        assert (m.tier == TIER_VIRGIN).sum() == 7
        jst_ = jm.status()
        assert {k: v for k, v in st.items() if k != "spill_path"} == \
            {k: v for k, v in jst_.items() if k != "spill_path"}


def _kw(kw):
    kw.setdefault("value_dim", 3)
    kw.setdefault("updater", "adagrad")
    kw.setdefault("slots_per_bucket", 8)
    kw.setdefault("device_buckets", 16)
    kw.setdefault("host_buckets", 8)
    return kw


def _tiered(name, tmp_path, capacity=2048, mesh=None, **kw):
    """The port's tiered table (on the CPU, or on a port ``mesh``)."""
    return TieredKVTable(capacity, name=name,
                         spill_dir=str(tmp_path / name), mesh=mesh,
                         device=None if mesh is not None else "cpu",
                         **_kw(kw))


def _jtiered(name, tmp_path, capacity=2048, **kw):
    """The reference's tiered table on the JAX runtime's mesh."""
    return jst.TieredKVTable(capacity, name=name,
                             spill_dir=str(tmp_path / "jax" / name),
                             **_kw(kw))


def _same_placement(t, j):
    for name in ("tier", "slot_of", "bucket_at"):
        np.testing.assert_array_equal(getattr(t.tiers, name),
                                      getattr(j.tiers, name), err_msg=name)
    assert list(t.tiers.host.buckets()) == list(j.tiers.host.buckets())
    assert sorted(t.tiers.disk.buckets()) == sorted(j.tiers.disk.buckets())


def _close(t_vals, j_vals):
    np.testing.assert_allclose(np.asarray(t_vals), np.asarray(j_vals),
                               rtol=RTOL, atol=ATOL)


def _record_victims(table):
    """Wrap the table's manager's ``plan`` to log each plan's victims."""
    log, plan = [], table.tiers.plan

    def logged(needed):
        p = plan(needed)
        log.append(p.victims.copy())
        return p
    table.tiers.plan = logged
    return log


class TestTieredKVTable:
    def test_parity_with_plain_kv(self, mesh8, tmp_path):
        """Same op history through the tiers and through a plain
        device-resident KVTable -> same values, exactly (state rides the
        demote/spill/fill round trips); the reference's tiered table on
        the same history places every bucket alike."""
        rng = np.random.default_rng(0)
        plain = KVTable(2048, value_dim=3, updater="adagrad",
                        name="par_plain", device="cpu")
        tiered = _tiered("par_tiered", tmp_path)
        jt = _jtiered("par_tiered", tmp_path)
        assert tiered.tiers.device_buckets < tiered.total_buckets
        keys = rng.choice(2 ** 50, size=300, replace=False) \
            .astype(np.uint64)
        for _ in range(2):
            d = rng.normal(size=(300, 3)).astype(np.float32)
            plain.add(keys, d, sync=True)
            tiered.add(keys, d, sync=True)
            jt.add(keys, d, sync=True)
        vp, fp = plain.get(keys)
        vt, ft = tiered.get(keys)
        vj, fj = jt.get(keys)
        assert fp.all() and ft.all()
        np.testing.assert_array_equal(vp, vt)
        np.testing.assert_array_equal(ft, np.asarray(fj))
        _close(vt, vj)
        _same_placement(tiered, jt)
        assert len(tiered) == len(plain) == len(jt) == 300
        # missing keys behave identically too
        miss = np.array([999999999999], np.uint64)
        assert not tiered.get(miss)[1].any()

    def test_batch_wider_than_device_tier_chunks(self, mesh8, tmp_path):
        """A single get/add touching more distinct buckets than the device
        budget holds must chunk, not raise."""
        rng = np.random.default_rng(1)
        t = _tiered("wide", tmp_path, device_buckets=4, host_buckets=2)
        jt = _jtiered("wide", tmp_path, device_buckets=4, host_buckets=2)
        keys = rng.choice(2 ** 40, size=200, replace=False) \
            .astype(np.uint64)
        buckets = np.unique(t._buckets_of(keys))
        assert len(buckets) > t.tiers.device_buckets
        np.testing.assert_array_equal(t._buckets_of(keys),
                                      jt._buckets_of(keys))
        d = rng.normal(size=(200, 3)).astype(np.float32)
        t.add(keys, d, sync=True)
        jt.add(keys, d, sync=True)
        vals, found = t.get(keys)
        assert found.all()
        _close(vals, jt.get(keys)[0])
        # get order is caller order even through the chunk unpermute
        v2, f2 = t.get(keys[::-1])
        np.testing.assert_array_equal(np.asarray(v2),
                                      np.asarray(vals)[::-1])
        jt.get(keys[::-1])
        _same_placement(t, jt)

    def test_overflow_names_logical_buckets_and_capacity(self, mesh8,
                                                         tmp_path):
        kw = dict(capacity=64, value_dim=0, updater="default",
                  slots_per_bucket=2, device_buckets=4, host_buckets=2)
        t = _tiered("ovf", tmp_path, **kw)
        jt = _jtiered("ovf", tmp_path, **kw)
        # find 3 keys hashing to one LOGICAL bucket (slots=2)
        probe = np.arange(1, 4096, dtype=np.uint64)
        buckets = t._buckets_of(probe)
        ids, counts = np.unique(buckets, return_counts=True)
        target = int(ids[np.argmax(counts)])
        assert counts.max() >= 3
        bad = probe[buckets == target][:3]
        msgs = []
        for table in (t, jt):
            with pytest.raises(RuntimeError) as ei:
                table.add(bad, np.ones(3, np.float32), sync=True)
            msgs.append(str(ei.value))
        msg = msgs[0]
        assert f"configured capacity {t.capacity} keys" in msg
        assert f"{t.capacity // t.slots} buckets" in msg
        assert str(target) in msg              # the logical bucket id
        named = [re.search(r"keys overflowed.*at capacity for the batch: "
                           r"\[[0-9, ]*\]", m).group(0) for m in msgs]
        assert named[0] == named[1]

    def test_len_counts_all_tiers(self, mesh8, tmp_path):
        rng = np.random.default_rng(2)
        t = _tiered("len3", tmp_path, device_buckets=8, host_buckets=4)
        jt = _jtiered("len3", tmp_path, device_buckets=8, host_buckets=4)
        keys = rng.choice(2 ** 40, size=150, replace=False) \
            .astype(np.uint64)
        d = rng.normal(size=(150, 3)).astype(np.float32)
        t.add(keys, d, sync=True)
        jt.add(keys, d, sync=True)
        c = t.tiers.counts()
        assert c["host"] > 0 and c["disk"] > 0
        assert c == jt.tiers.counts()
        assert len(t) == len(jt) == 150

    def test_store_load_bitident_across_tiers(self, mesh8, tmp_path):
        """A checkpoint taken with buckets in ALL THREE tiers restores
        bit-identically — values, found flags, adagrad state
        (continuation adds agree) — and the placement is re-established,
        as the reference's restore re-establishes it."""
        rng = np.random.default_rng(3)
        t = _tiered("ckpt_src", tmp_path)
        jt = _jtiered("ckpt_src", tmp_path)
        keys = rng.choice(2 ** 45, size=400, replace=False) \
            .astype(np.uint64)
        for _ in range(2):
            d = rng.normal(size=(400, 3)).astype(np.float32)
            t.add(keys, d, sync=True)
            jt.add(keys, d, sync=True)
        c = t.tiers.counts()
        assert c["device"] > 0 and c["host"] > 0 and c["disk"] > 0
        uri = str(tmp_path / "tiered.ckpt")
        t.store(uri)
        juri = str(tmp_path / "jtiered.ckpt")
        jt.store(juri)
        r = _tiered("ckpt_dst", tmp_path)
        r.load(uri)
        jr = _jtiered("ckpt_dst", tmp_path)
        jr.load(juri)
        _same_placement(r, jr)
        vt, ft = t.get(keys)
        vr, fr = r.get(keys)
        np.testing.assert_array_equal(np.asarray(ft), np.asarray(fr))
        np.testing.assert_array_equal(np.asarray(vt), np.asarray(vr))
        assert len(r) == 400
        rc = r.tiers.counts()
        assert rc["disk"] > 0                  # placement restored too
        # adagrad accumulators came along: continuation adds agree
        d = rng.normal(size=(400, 3)).astype(np.float32)
        t.add(keys, d, sync=True)
        r.add(keys, d, sync=True)
        np.testing.assert_array_equal(np.asarray(t.get(keys)[0]),
                                      np.asarray(r.get(keys)[0]))

    def test_staging_writer_split(self, mesh8, tmp_path):
        """The KVStagingWriter seam: prepare off-thread, dispatch (and
        fault-in) on the caller's thread — same result as sync adds."""
        from multiverso_tpu_torch.client import stage_kv_adds
        rng = np.random.default_rng(5)
        t = _tiered("stage_t", tmp_path)
        ref = _tiered("stage_ref", tmp_path)
        batches = []
        for i in range(4):
            ks = rng.choice(2 ** 40, size=100, replace=False) \
                .astype(np.uint64)
            batches.append((ks, rng.normal(size=(100, 3))
                            .astype(np.float32)))
        h = stage_kv_adds(t, batches, depth=2)
        h.wait()
        for ks, d in batches:
            ref.add(ks, d, sync=True)
        all_keys = np.unique(np.concatenate([b[0] for b in batches]))
        np.testing.assert_array_equal(np.asarray(t.get(all_keys)[0]),
                                      np.asarray(ref.get(all_keys)[0]))

    def test_geometry_mismatch_rejected(self, mesh8, tmp_path):
        t = _tiered("geo_a", tmp_path, capacity=2048)
        t.add(np.array([5], np.uint64), np.ones((1, 3), np.float32),
              sync=True)
        uri = str(tmp_path / "geo.ckpt")
        t.store(uri)
        r = _tiered("geo_b", tmp_path, capacity=4096)
        with pytest.raises(ValueError, match="num_buckets"):
            r.load(uri)
        jr = _jtiered("geo_b", tmp_path, capacity=4096)
        with pytest.raises(ValueError, match="num_buckets"):
            jr.load(uri)

    def test_statusz_storage_section(self, mesh8, tmp_path):
        """The reference's statusz storage rows are ``status_all()``
        (statusz itself comes with the server): the port's row of a table
        equals its manager's ``status()`` and the reference's row for the
        same history (the spill path aside, each package's own)."""
        rng = np.random.default_rng(6)
        t = _tiered("statz", tmp_path)
        jt = _jtiered("statz", tmp_path)
        keys = rng.choice(2 ** 40, size=200, replace=False) \
            .astype(np.uint64)
        d = rng.normal(size=(200, 3)).astype(np.float32)
        t.add(keys, d, sync=True)
        jt.add(keys, d, sync=True)
        rows = [r for r in status_all() if r["table"] == "statz"]
        jrows = [r for r in jst.status_all() if r["table"] == "statz"]
        assert rows == [t.tiers.status()] and len(jrows) == 1
        assert rows[0]["disk_records"] > 0
        assert os.path.basename(rows[0].pop("spill_path")) == \
            os.path.basename(jrows[0].pop("spill_path")) == "statz.spill"
        assert rows[0] == jrows[0]


class _Kill(BaseException):
    """Simulated eviction: BaseException so nothing 'recovers' it."""


class TestTieredKillStormResume:
    def test_killed_under_chaos_resumes_bitident(self, mesh8, tmp_path):
        """Kill a checkpointed tiered run mid-stream WITH chaos injecting
        transient faults into both the checkpoint writes and the
        spill/fill paths; resume a fresh table from the latest complete
        generation (buckets in all three tiers) and finish — final state
        matches the uninterrupted run bit-for-bit, and the reference's
        uninterrupted run within the stated tolerance."""
        from multiverso_tpu_torch.ft.checkpoint import RunCheckpointManager
        rng = np.random.default_rng(4)
        pop = rng.choice(2 ** 44, size=500, replace=False) \
            .astype(np.uint64)
        batches = []
        for _ in range(6):
            ks = rng.choice(pop, size=120, replace=False)
            batches.append((ks, rng.normal(size=(120, 3))
                            .astype(np.float32)))

        def run(t, mgr, start, kill_at=None):
            for i in range(start, len(batches)):
                if kill_at is not None and i == kill_at:
                    raise _Kill()
                ks, d = batches[i]
                t.add(ks, d, sync=True)
                if mgr is not None:
                    mgr.save(i + 1, {"round": i + 1})

        # reference: uninterrupted, no checkpoints
        ref = _tiered("storm_ref", tmp_path)
        run(ref, None, 0)
        want_v, want_f = ref.get(pop)
        jref = _jtiered("storm_ref", tmp_path)
        run(jref, None, 0)
        _close(want_v, jref.get(pop)[0])

        # interrupted run: transient chaos on checkpoint writes AND the
        # tier movement paths (spaced so the 3-attempt retry always
        # recovers), killed before round 5
        ckpt_dir = str(tmp_path / "run")
        t = _tiered("storm_kv", tmp_path / "a")
        mgr = RunCheckpointManager(ckpt_dir, keep=2, tables=[t],
                                   background=False)
        install_chaos("io.write:error:times=1;"
                      "io.write:error:after=40,times=1;"
                      "storage.spill:error:times=1;"
                      "storage.spill:error:after=30,times=1;"
                      "storage.fill:error:times=1")
        with pytest.raises(_Kill):
            run(t, mgr, 0, kill_at=4)
        mgr.close()
        uninstall_chaos()
        reset_tables()

        # fresh process-equivalent: resume from the latest complete
        # generation, verify all three tiers repopulate, finish
        res = _tiered("storm_kv", tmp_path / "b")
        mgr2 = RunCheckpointManager(ckpt_dir, keep=2, tables=[res],
                                    background=False)
        st = mgr2.resume()
        assert st is not None and st.state["round"] == 4
        c = res.tiers.counts()
        assert c["device"] > 0 and c["host"] > 0 and c["disk"] > 0
        run(res, mgr2, st.state["round"])
        mgr2.close()
        got_v, got_f = res.get(pop)
        np.testing.assert_array_equal(np.asarray(want_f),
                                      np.asarray(got_f))
        np.testing.assert_array_equal(np.asarray(want_v),
                                      np.asarray(got_v))


# -- the port against the JAX package, beyond the mirrored cases -------------


def _keys(rng, n, hi=2 ** 46):
    return rng.choice(hi, size=n, replace=False).astype(np.uint64)


def test_get_tensor_goes_through_get_with_buckets(monkeypatch):
    """KVTable.get_tensor is the identity translation over the seam the
    tiered table drives."""
    t = KVTable(256, value_dim=2, name="seam", device="cpu")
    keys = np.array([3, 5, 7], np.uint64)
    t.add(keys, np.ones((3, 2), np.float32))
    calls, inner = [], t._get_with_buckets

    def spy(k, b):
        calls.append((k.copy(), b.copy()))
        return inner(k, b)
    monkeypatch.setattr(t, "_get_with_buckets", spy)
    vals, found = t.get_tensor(keys)
    assert found.all() and torch.equal(vals, torch.ones(3, 2))
    np.testing.assert_array_equal(calls[0][0], keys)
    np.testing.assert_array_equal(calls[0][1], t._buckets_of(keys))


def test_placement_history_equals_reference(mesh8, tmp_path):
    """One op history of adds and gets (narrow and chunked ones, hits and
    misses) through both packages: the same victims in every plan, and
    after every op the same tier, slot_of, bucket_at, host order and disk
    set; Gets within the stated tolerance."""
    rng = np.random.default_rng(9)
    kw = dict(device_buckets=12, host_buckets=6, updater="sgd",
              value_dim=2)
    t = _tiered("hist", tmp_path, **kw)
    jt = _jtiered("hist", tmp_path, **kw)
    tv, jv = _record_victims(t), _record_victims(jt)
    pool = _keys(rng, 600)
    for step in range(8):
        ks = rng.choice(pool, size=int(rng.integers(20, 160)),
                        replace=False)
        if step % 3 == 2:
            _close(t.get(ks)[0], jt.get(ks)[0])
        else:
            d = rng.normal(size=(len(ks), 2)).astype(np.float32)
            t.add(ks, d, sync=True)
            jt.add(ks, d, sync=True)
        _same_placement(t, jt)
    assert len(tv) == len(jv) > 8
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(a, b)
    assert sum(len(v) for v in tv) > 0
    assert t.tiers.counts()["disk"] > 0


@pytest.mark.parametrize("updater", ["adam", "ftrl"])
def test_chunked_add_step_and_generation(mesh8, tmp_path, updater):
    """A chunked Add advances the option step and the generation once a
    chunk, as the reference's does; the step reaches adam's bias
    correction and ftrl's schedule, and the values agree."""
    rng = np.random.default_rng(10)
    kw = dict(device_buckets=4, host_buckets=2, updater=updater,
              value_dim=2)
    t = _tiered(f"step_{updater}", tmp_path, **kw)
    jt = _jtiered(f"step_{updater}", tmp_path, **kw)
    keys = _keys(rng, 120)
    chunks = len(t._chunk_spans(np.sort(t._buckets_of(keys))))
    assert chunks > 1
    for _ in range(3):
        d = rng.normal(size=(120, 2)).astype(np.float32)
        t.add(keys, d, sync=True)
        jt.add(keys, d, sync=True)
    assert t.default_option.step == jt.default_option.step == 3 * chunks
    assert t.generation == jt.generation == 3 * chunks
    _close(t.get(keys)[0], jt.get(keys)[0])
    _same_placement(t, jt)


def test_lowered_budget_evicts_same_victims(mesh8, tmp_path):
    """storage.device_buckets set below the resident count through each
    package's knob table: the soft budget moves, plan() stops growing the
    resident set past it (never past a batch's working set), and both
    packages pick the same victims."""
    rng = np.random.default_rng(11)
    t = _tiered("budget_t", tmp_path, device_buckets=16)
    jt = _jtiered("budget_t", tmp_path, device_buckets=16)
    pool = _keys(rng, 300)
    d = rng.normal(size=(100, 3)).astype(np.float32)
    t.add(pool[:100], d, sync=True)
    jt.add(pool[:100], d, sync=True)
    assert t.tiers.counts()["device"] == 16
    moved = tknobs.set("storage.device_buckets", 6, label="budget_t")
    jknobs.set("storage.device_buckets", 6, label="budget_t")
    assert moved == [("budget_t", 16, 6)]
    assert t.tiers.device_budget == jt.tiers.device_budget == 6
    tv, jv = _record_victims(t), _record_victims(jt)
    for lo in (100, 103, 140):
        ks = pool[lo:lo + 3]
        d = rng.normal(size=(3, 3)).astype(np.float32)
        t.add(ks, d, sync=True)
        jt.add(ks, d, sync=True)
        _same_placement(t, jt)
    assert [list(v) for v in tv] == [list(v) for v in jv]
    assert sum(len(v) for v in tv) > 0
    _close(t.get(pool[:150])[0], jt.get(pool[:150])[0])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_across_packages(mesh8, tmp_path, direction):
    """A float32 tiered checkpoint with buckets in all three tiers, written
    by either package, loads in the other: the same content (a lookup of
    the loaded bytes is exact) and the same ``tier_of`` placement; the two
    packages' payloads agree array by array."""
    rng = np.random.default_rng(12)
    t = _tiered("x_src", tmp_path)
    jt = _jtiered("x_src", tmp_path)
    keys = _keys(rng, 400)
    for _ in range(2):
        d = rng.normal(size=(400, 3)).astype(np.float32)
        t.add(keys, d, sync=True)
        jt.add(keys, d, sync=True)
    tm, tp = t.export_checkpoint_async()()
    jm, jp = jt.export_checkpoint_async()()
    assert sorted(tp) == sorted(jp)
    for k in ("keys", "bucket_fill", "tier_of"):
        np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
    for k in tp:
        if k not in ("keys", "bucket_fill", "tier_of"):
            _close(tp[k], jp[k])
    assert {k: v for k, v in tm.items() if k not in ("name", "crc32")} == \
        {k: v for k, v in jm.items() if k not in ("name", "crc32")}
    src, dst = (t, _jtiered("x_dst", tmp_path)) \
        if direction == "port_to_jax" else (jt, _tiered("x_dst", tmp_path))
    tier_of = src.tiers.tier.copy()
    assert all(c > 0 for c in (np.sum(tier_of == x) for x in
                               (TIER_DEVICE, TIER_HOST, TIER_DISK)))
    uri = str(tmp_path / "x.ckpt")
    src.store(uri)
    dst.load(uri)
    np.testing.assert_array_equal(dst.tiers.tier, tier_of)
    vs, fs = src.get(keys)
    vd, fd = dst.get(keys)
    np.testing.assert_array_equal(np.asarray(fd), np.asarray(fs))
    np.testing.assert_array_equal(np.asarray(vd), np.asarray(vs))
    assert len(dst) == 400
    assert dst.default_option.step == src.default_option.step


def test_bfloat16_payload_bytes_match_reference(mesh8, tmp_path):
    """A bfloat16 tiered table with buckets in every tier: the export's
    payload arrays are the reference's bytes (values as raw ``V2``), its
    spill records too, and the port loads its own file back."""
    rng = np.random.default_rng(13)
    kw = dict(dtype="bfloat16", updater="default", value_dim=2,
              default_value=0.5)
    t = _tiered("bf_src", tmp_path, **kw)
    jt = _jtiered("bf_src", tmp_path, **kw)
    keys = _keys(rng, 400)
    for _ in range(2):
        # deltas on a coarse grid: every sum is exact in bfloat16
        d = (rng.integers(-8, 8, size=(400, 2)) / 4).astype(np.float32)
        t.add(keys, d, sync=True)
        jt.add(keys, d, sync=True)
    _same_placement(t, jt)
    tm, tp = t.export_checkpoint_async()()
    jm, jp = jt.export_checkpoint_async()()
    assert tm["dtype"] == jm["dtype"] == "bfloat16"
    assert tp["values"].dtype == np.dtype("V2")
    for k in jp:
        assert np.ascontiguousarray(tp[k]).tobytes() == \
            np.ascontiguousarray(jp[k]).tobytes(), k
    for b in list(t.tiers.disk.buckets())[:20]:
        assert t.tiers.spec.pack(t.tiers.disk.peek(b)) == \
            jt.tiers.spec.pack(jt.tiers.disk.peek(b))
    uri = str(tmp_path / "bf.ckpt")
    t.store(uri)
    r = _tiered("bf_dst", tmp_path, **kw)
    r.load(uri)
    vt, ft = t.get_tensor(keys)
    vr, fr = r.get_tensor(keys)
    assert vr.dtype == torch.bfloat16 and fr.all()
    assert torch.equal(vt.view(torch.int16), vr.view(torch.int16))
    np.testing.assert_array_equal(r.tiers.tier, t.tiers.tier)


def _bits(x):
    kind = {2: torch.int16, 4: torch.int32}[x.element_size()]
    return x.contiguous().view(kind)


@pytest.mark.parametrize("shape,flag", [((1, 2), False), ((2, 1), False),
                                        ((2, 2), False), ((2, 2), True)])
def test_tiered_on_meshes_matches_one_device(tmp_path, shape, flag):
    """The tiered table on (1, S), (D, 1) and (D, S) meshes of the CPU,
    with and without shard_update: every Get (chunked ones too) and the
    export bit for bit the (1, 1) table's on the same history, the
    placement the same, the replicas identical after every op."""
    dp, mp = shape
    mesh = tcore._build_mesh(["cpu"] * (dp * mp), dp, mp)
    rng = np.random.default_rng(14)
    kw = dict(device_buckets=12, host_buckets=6, updater="adagrad")
    one = _tiered("mesh_one", tmp_path, **kw)
    t = _tiered("mesh_t", tmp_path, mesh=mesh, shard_update=flag, **kw)
    assert t.shard_update == (flag and dp > 1)
    pool = _keys(rng, 400)
    for step in range(6):
        ks = rng.choice(pool, size=int(rng.integers(40, 200)),
                        replace=False)
        d = rng.normal(size=(len(ks), 3)).astype(np.float32)
        one.add(ks, d, sync=True)
        t.add(ks, d, sync=True)
        for r in range(1, t.n_replicas):
            for s in range(len(t.devices)):
                assert torch.equal(t.replica_keys[r][s], t.key_shards[s])
                assert torch.equal(_bits(t.replica_values[r][s]),
                                   _bits(t.value_shards[s]))
                if not t.shard_update:
                    for k, leaf in t.state_shards[s].items():
                        assert torch.equal(t.replica_states[r][s][k], leaf)
        q = np.concatenate([ks[:50], pool[:150]])
        vo, fo = one.get_tensor(q)
        vt, ft = t.get_tensor(q)
        assert torch.equal(fo, ft) and torch.equal(_bits(vo), _bits(vt))
        for name in ("tier", "slot_of", "bucket_at"):
            np.testing.assert_array_equal(getattr(one.tiers, name),
                                          getattr(t.tiers, name))
    assert t.tiers.counts()["disk"] > 0
    _, po = one.export_checkpoint_async()()
    _, pt = t.export_checkpoint_async()()
    assert sorted(po) == sorted(pt)
    for k in po:
        assert po[k].tobytes() == pt[k].tobytes(), k
