"""The port's wire codec (multiverso_tpu_torch/server/wire.py): the
cases of tests/test_wire.py mirrored — frame roundtrips + zero-copy
decode, numpy/torch quantizer bit-parity, geometry-keyed error-feedback
state, unbiasedness THROUGH the wire codec, the transport chaos kinds —
and the codec against the reference's, byte for byte: frames of every
dtype the reference puts on the wire, quantized deltas, partition maps
and fleet files; and the port's module names after ``import
multiverso_tpu``."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from multiverso_tpu_torch.ft import chaos
from multiverso_tpu_torch.server import wire
from multiverso_tpu_torch.utils.quantization import (OneBitQuantizer,
                                               RoundingQuantizer)



@pytest.fixture(autouse=True)
def _both_packages_unchaosed():
    """Each package keeps its own chaos rules: none survives a case."""
    from multiverso_tpu.ft import chaos as ref_chaos
    yield
    for c in (chaos, ref_chaos):
        c.uninstall_chaos()


def _frame_bytes(header, arrays=()):
    bufs, nbytes = wire.encode_frame(header, arrays)
    flat = b"".join(bytes(b) for b in bufs)
    assert len(flat) == nbytes
    return flat


def _decode(flat):
    magic, body_len, header_len = wire._PREFIX.unpack(
        flat[:wire.PREFIX_BYTES])
    assert magic == wire.MAGIC
    body = bytearray(flat[wire.PREFIX_BYTES:])
    assert len(body) == body_len
    return wire.decode_frame_body(body, header_len), body


class TestFrameCodec:
    def test_roundtrip_multi_dtype(self):
        arrays = [np.arange(7, dtype=np.float32),
                  np.arange(12, dtype=np.uint64).reshape(3, 4),
                  np.frombuffer(b"\x01\x02\x03", np.uint8),
                  np.full((2, 3), 3.5, np.float64)]
        header = {"op": "x", "rid": 9, "quant": {"mode": "raw"}}
        (got_header, got_arrays), _ = _decode(
            _frame_bytes(header, arrays))
        assert got_header["op"] == "x" and got_header["rid"] == 9
        assert len(got_arrays) == len(arrays)
        for a, b in zip(arrays, got_arrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)

    def test_decode_is_zero_copy(self):
        a = np.arange(64, dtype=np.float32)
        (_, got), body = _decode(_frame_bytes({"op": "x"}, [a]))
        # the decoded array is a VIEW into the receive buffer
        assert np.shares_memory(got[0], np.frombuffer(body, np.uint8))

    def test_payloads_eight_byte_aligned(self):
        arrays = [np.frombuffer(b"abc", np.uint8),
                  np.arange(4, dtype=np.float64)]
        (header, got), body = _decode(
            _frame_bytes({"op": "x"}, arrays))
        # offsets are derivable (not stored): re-walk the align-8 rule
        for arr in got:
            off = arr.__array_interface__["data"][0] \
                - np.frombuffer(body, np.uint8) \
                .__array_interface__["data"][0]
            assert off % wire._ALIGN == 0

    def test_corrupt_header_raises_protocol_error(self):
        flat = _frame_bytes({"op": "x"}, [np.ones(4, np.float32)])
        body = bytearray(flat[wire.PREFIX_BYTES:])
        body[0] = 0xFF                    # not JSON any more
        _, _, header_len = wire._PREFIX.unpack(flat[:wire.PREFIX_BYTES])
        with pytest.raises(wire.WireProtocolError):
            wire.decode_frame_body(body, header_len)

    def test_truncated_payload_raises_protocol_error(self):
        flat = _frame_bytes({"op": "x"}, [np.ones(64, np.float32)])
        _, _, header_len = wire._PREFIX.unpack(flat[:wire.PREFIX_BYTES])
        body = bytearray(flat[wire.PREFIX_BYTES:-8])   # torn frame
        with pytest.raises(wire.WireProtocolError):
            wire.decode_frame_body(body, header_len)

    def test_bad_magic_raises_over_socket(self):
        a, b = socket.socketpair()
        try:
            a.sendall(b"HTTP" + b"\0" * 64)
            with pytest.raises(wire.WireProtocolError):
                wire.recv_frame(b)
        finally:
            for s in (a, b):
                try:
                    s.close()
                except OSError:
                    pass

    def test_send_recv_over_socketpair(self):
        a, b = socket.socketpair()
        try:
            payload = np.arange(100, dtype=np.float32)
            wire.send_frame(a, {"op": "ping", "rid": 1}, [payload])
            header, arrays, nbytes = wire.recv_frame(b)
            assert header["op"] == "ping"
            np.testing.assert_array_equal(arrays[0], payload)
            assert nbytes > payload.nbytes
        finally:
            for s in (a, b):
                wire._close_socket(s)


class TestQuantizerParity:
    """The numpy wire twins must match the torch quantizers BIT-for-bit
    (a worker quantizes with numpy; anything else dequantizes with
    either implementation)."""

    def test_one_bit_packed_signs_match_jax(self):
        block = 64
        x = np.random.default_rng(0).normal(
            0, 1, (block * 3 - 5,)).astype(np.float32)
        packed_np, pos_np, neg_np, res_np = wire.one_bit_quantize_np(
            x, None, block)
        q = OneBitQuantizer(block=block)
        sign, pos_j, neg_j, res_j = q.quantize(torch.from_numpy(x))
        packed_j = np.asarray(q.pack_signs(sign))
        np.testing.assert_array_equal(packed_np, packed_j)
        np.testing.assert_allclose(pos_np, np.asarray(pos_j), rtol=1e-6)
        np.testing.assert_allclose(neg_np, np.asarray(neg_j), rtol=1e-6)
        np.testing.assert_allclose(res_np, np.asarray(res_j), atol=1e-5)

    def test_one_bit_dequant_matches_jax(self):
        block = 32
        x = np.random.default_rng(1).normal(
            0, 2, (block * 2 + 7,)).astype(np.float32)
        packed, pos, neg, _ = wire.one_bit_quantize_np(x, None, block)
        deq_np = wire.one_bit_dequantize_np(packed, pos, neg, x.shape,
                                            block)
        q = OneBitQuantizer(block=block)
        deq_j = np.asarray(q.dequantize(
            q.unpack_signs(torch.from_numpy(packed)),
            torch.from_numpy(pos), torch.from_numpy(neg), x.shape))
        np.testing.assert_allclose(deq_np, deq_j, rtol=1e-6)

    def test_rounding_dequant_matches_jax(self):
        # RNG streams differ; the DEQUANT grids must agree exactly
        block = 128
        x = np.random.default_rng(2).normal(
            0, 1, (block + 17,)).astype(np.float32)
        qv, scale = wire.rounding_quantize_np(
            x, np.random.default_rng(3), bits=8, block=block)
        deq_np = wire.rounding_dequantize_np(qv, scale, x.shape)
        rq = RoundingQuantizer(bits=8, block=block)
        deq_j = np.asarray(rq.dequantize(torch.from_numpy(qv),
                                         torch.from_numpy(scale), x.shape))
        np.testing.assert_allclose(deq_np, deq_j, rtol=1e-6)
        # grid bound: |x - deq| <= scale per block element
        err = np.abs(deq_np - x)
        per_block = np.repeat(scale, block)[:x.size]
        assert (err <= per_block + 1e-6).all()


class TestResidualStore:
    def test_geometry_keyed(self):
        """The satellite fix: residuals for DIFFERENT shapes (or
        tables, or kinds) to one store never cross-contaminate."""
        store = wire.ResidualStore()
        r16 = np.full(16, 0.5, np.float32)
        r32 = np.full(32, -1.0, np.float32)
        store.put(0, "dense", (16,), 64, r16)
        store.put(0, "dense", (32,), 64, r32)
        store.put(1, "dense", (16,), 64, r16 * 2)
        store.put(0, "kv", (16,), 64, r16 * 3)
        assert len(store) == 4
        np.testing.assert_array_equal(
            store.take(0, "dense", (32,), 64), r32)
        np.testing.assert_array_equal(
            store.take(1, "dense", (16,), 64), r16 * 2)
        # take pops: second take sees first-use None
        assert store.take(0, "dense", (32,), 64) is None
        assert store.take(0, "dense", (999,), 64) is None

    def test_encode_delta_variable_shapes_one_table(self):
        """Interleaved shapes to the SAME table each converge under
        their own residual — the bug the store exists to prevent."""
        store = wire.ResidualStore()
        rng = np.random.default_rng(4)
        shapes = [(256,), (130,)]
        true = {s: np.zeros(s, np.float32) for s in shapes}
        acc = {s: np.zeros(s, np.float32) for s in shapes}
        for _ in range(120):
            for s in shapes:
                d = rng.normal(0, 1, s).astype(np.float32)
                true[s] += d
                meta, arrays = wire.encode_delta(
                    d, "1bit", table=7, kind="dense",
                    residuals=store, block=64)
                acc[s] += wire.decode_delta(meta, arrays)
        for s in shapes:
            resid = store.take(7, "dense", s, 64)
            gap = np.abs(true[s] - acc[s])
            assert gap.max() <= np.abs(resid).max() + 1e-3


class TestDeltaCodecOverWire:
    def _roundtrip(self, meta, arrays):
        """Push the quantized payload through the ACTUAL frame codec."""
        (header, got), _ = _decode(
            _frame_bytes({"op": "add", "quant": meta}, arrays))
        return wire.decode_delta(header["quant"], got)

    def test_small_and_integer_payloads_ship_raw(self):
        small = np.ones(8, np.float32)
        meta, arrays = wire.encode_delta(small, "1bit", table=0,
                                         kind="dense")
        assert meta["mode"] == "raw"
        ints = np.arange(1024, dtype=np.int32)
        meta, arrays = wire.encode_delta(ints, "int8", table=0,
                                         kind="dense")
        assert meta["mode"] == "raw"
        np.testing.assert_array_equal(self._roundtrip(meta, arrays),
                                      ints)

    def test_kv_under_1bit_falls_back_to_int8(self):
        d = np.random.default_rng(5).normal(
            0, 1, (64, 4)).astype(np.float32)
        meta, _ = wire.encode_delta(d, "1bit", table=0, kind="kv",
                                    block=64)
        assert meta["mode"] == "int8"

    def test_rounding_unbiased_through_wire(self):
        """E[decode(encode(x))] == x with the int8 payload riding the
        real frame format (the satellite-2 acceptance test)."""
        rng = np.random.default_rng(6)
        x = rng.normal(0, 1, 256).astype(np.float32)
        acc = np.zeros_like(x)
        n = 300
        for _ in range(n):
            meta, arrays = wire.encode_delta(
                x, "int8", table=0, kind="kv", rng=rng, block=64)
            assert meta["mode"] == "int8"
            acc += self._roundtrip(meta, arrays)
        np.testing.assert_allclose(acc / n, x, atol=0.01)

    def test_one_bit_bytes_on_wire(self):
        d = np.zeros(4096, np.float32)
        meta, arrays = wire.encode_delta(d, "1bit", table=0,
                                         kind="dense", block=512)
        quant_bytes = sum(a.nbytes for a in arrays)
        # sign bits (1/8 byte per elem) + 2 f32 scales per 512-block
        assert quant_bytes * 4 < d.nbytes
        np.testing.assert_allclose(self._roundtrip(meta, arrays), 0.0)


class TestEnvKnobs:
    def test_quant_mode_typo_raises(self, monkeypatch):
        monkeypatch.setenv(wire.QUANT_ENV, "2bit")
        with pytest.raises(ValueError):
            wire.quant_mode_from_env()
        monkeypatch.setenv(wire.QUANT_ENV, "int8")
        assert wire.quant_mode_from_env() == "int8"
        monkeypatch.setenv(wire.QUANT_ENV, "off")
        assert wire.quant_mode_from_env() is None

    def test_wire_block_multiple_of_eight(self, monkeypatch):
        monkeypatch.setenv(wire.BLOCK_ENV, "100")
        assert wire.wire_block() == 96
        monkeypatch.setenv(wire.BLOCK_ENV, "nonsense")
        assert wire.wire_block() == 512


class TestWireChaos:
    """The three transport fault points: every
    kind surfaces as ConnectionError (retryable via reconnect), never
    as a silent half-frame."""

    def teardown_method(self):
        chaos.uninstall_chaos()

    def _pair(self):
        a, b = socket.socketpair()
        b.settimeout(5.0)
        return a, b

    def test_send_drop_raises_connection_error(self):
        chaos.install_chaos("wire.send:drop:times=1")
        a, b = self._pair()
        with pytest.raises(ConnectionError):
            wire.send_frame(a, {"op": "ping"})
        # peer sees clean EOF, not a torn frame
        with pytest.raises(ConnectionError):
            wire.recv_frame(b)
        wire._close_socket(b)

    def test_send_torn_puts_half_frame_on_wire(self):
        chaos.install_chaos("wire.send:torn:times=1")
        a, b = self._pair()
        with pytest.raises(ConnectionError):
            wire.send_frame(a, {"op": "ping"},
                            [np.ones(64, np.float32)])
        # receiver dies mid-frame (EOF inside the body)
        with pytest.raises(ConnectionError):
            wire.recv_frame(b)
        wire._close_socket(b)

    def test_recv_drop_raises_connection_error(self):
        chaos.install_chaos("wire.recv:drop:times=1")
        a, b = self._pair()
        try:
            with pytest.raises(ConnectionError):
                wire.recv_frame(b)
        finally:
            for s in (a, b):
                wire._close_socket(s)

    def test_drop_kind_parses_in_spec_grammar(self):
        inj = chaos.parse_chaos_spec(
            "seed=3;wire.send:drop:p=0.5;wire.accept:error:times=1")
        kinds = sorted(r.kind for r in inj.rules)
        assert kinds == ["drop", "error"]

    def test_crash_kind_is_never_a_connection_error(self):
        chaos.install_chaos("wire.send:crash:times=1")
        a, b = self._pair()
        try:
            with pytest.raises(chaos.ChaosCrash):
                wire.send_frame(a, {"op": "ping"})
            assert not issubclass(chaos.ChaosCrash, Exception)
        finally:
            for s in (a, b):
                wire._close_socket(s)


def test_quantization_module_reexports_wire_twins():
    """utils/quantization is the one import site for quantizer math;
    the numpy twins ride along for package users."""
    from multiverso_tpu_torch.utils import quantization as q
    assert q.one_bit_quantize_np is wire.one_bit_quantize_np
    assert q.ResidualStore is wire.ResidualStore


def test_worker_side_modules_stay_jax_free():
    """The modules a worker PROCESS file-path loads must never import
    jax or torch (the whole point of the process split) — guard the
    source (utils/quantization.py imports torch inside its torch
    quantizers only)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        wire.__file__)))
    for rel in (("server", "wire.py"), ("client", "transport.py"),
                ("io", "wiresock.py"), ("io", "shmring.py"),
                ("ft", "chaos.py"), ("ft", "retry.py"),
                ("server", "partition.py"), ("tables", "hashing.py")):
        with open(os.path.join(root, *rel)) as f:
            src = f.read()
        assert "import jax" not in src, f"{'/'.join(rel)} imports jax"
        assert "\nimport torch" not in src, \
            f"{'/'.join(rel)} imports torch"


# -- the port's codec against the reference's -------------------------------

from multiverso_tpu.server import partition as ref_partition  # noqa: E402
from multiverso_tpu.server import wire as ref_wire  # noqa: E402
from multiverso_tpu_torch.server import partition  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: every dtype the reference puts on the wire
WIRE_DTYPES = ("float32", "float16", "int8", "int32", "uint8", "uint32",
               "uint64")


def _ref_frame_bytes(header, arrays=()):
    bufs, nbytes = ref_wire.encode_frame(header, arrays)
    flat = b"".join(bytes(b) for b in bufs)
    assert len(flat) == nbytes
    return flat


class TestAgainstReference:
    @pytest.mark.parametrize("dtype", WIRE_DTYPES)
    def test_frame_bytes_equal(self, dtype):
        rng = np.random.default_rng(21)
        dt = np.dtype(dtype)
        shapes = [(17,), (5, 3), (0,), (2, 2, 2)]
        if dt.kind == "f":
            arrays = [rng.normal(0, 3, s).astype(dt) for s in shapes]
        else:
            hi = min(np.iinfo(dt).max, 1 << 40)
            arrays = [rng.integers(0, hi, s, dtype=np.uint64).astype(dt)
                      for s in shapes]
        header = {"op": "kv_add", "table": 3, "rid": 41,
                  "quant": {"mode": "raw"}, "option": {"learning_rate":
                                                       0.25},
                  "deadline": 1234.5, "trace": {"req": "r1", "pid": 7}}
        mine = _frame_bytes(dict(header), arrays)
        assert mine == _ref_frame_bytes(dict(header), arrays)
        (h, got), _ = _decode(mine)
        for a, b in zip(arrays, got):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    def test_one_bit_deltas_equal_with_the_same_residuals(self):
        rng = np.random.default_rng(22)
        mine, ref = wire.ResidualStore(), ref_wire.ResidualStore()
        for step in range(4):
            delta = rng.normal(0, 1, (300,)).astype(np.float32)
            a = wire.encode_delta(delta, "1bit", table=2, kind="dense",
                                  residuals=mine, block=64)
            b = ref_wire.encode_delta(delta, "1bit", table=2,
                                      kind="dense", residuals=ref,
                                      block=64)
            assert a[0] == b[0]
            assert _frame_bytes({"quant": a[0]}, a[1]) \
                == _ref_frame_bytes({"quant": b[0]}, b[1])
            np.testing.assert_array_equal(
                wire.decode_delta(a[0], a[1]),
                ref_wire.decode_delta(b[0], b[1]))
        assert mine.take(2, "dense", (300,), 64).tobytes() \
            == ref.take(2, "dense", (300,), 64).tobytes()

    @pytest.mark.parametrize("kind", ["kv", "dense"])
    def test_int8_deltas_equal_with_the_same_generator(self, kind):
        delta = np.random.default_rng(23).normal(
            0, 2, (96, 4)).astype(np.float32)
        a = wire.encode_delta(delta, "int8", table=0, kind=kind,
                              rng=np.random.default_rng(5), block=128)
        b = ref_wire.encode_delta(delta, "int8", table=0, kind=kind,
                                  rng=np.random.default_rng(5), block=128)
        assert a[0] == b[0] and a[0]["mode"] == "int8"
        assert _frame_bytes({"quant": a[0]}, a[1]) \
            == _ref_frame_bytes({"quant": b[0]}, b[1])
        assert wire.decoded_nbytes(*a) == ref_wire.decoded_nbytes(*b)

    def test_kv_one_bit_ships_int8_like_the_reference(self):
        delta = np.ones((80, 2), np.float32)
        a = wire.encode_delta(delta, "1bit", table=1, kind="kv",
                              rng=np.random.default_rng(1))
        b = ref_wire.encode_delta(delta, "1bit", table=1, kind="kv",
                                  rng=np.random.default_rng(1))
        assert a[0] == b[0] and a[0]["mode"] == "int8"

    def test_repl_and_migrate_headers_equal(self):
        orig = {"op": "kv_add", "table": 1, "rid": 9}
        assert wire.repl_wrap(orig, origin="w0", pgen=3, tid=1,
                              origins=[("w0", 9)]) \
            == ref_wire.repl_wrap(orig, origin="w0", pgen=3, tid=1,
                                  origins=[("w0", 9)])
        arrays = [np.arange(6, dtype=np.uint64), np.ones(6, np.float32)]
        assert wire.migrate_chunk_header(
            "p", table=1, kind="kv", lo=0, hi=8, seq=2, from_rank=1,
            arrays=arrays) == ref_wire.migrate_chunk_header(
            "p", table=1, kind="kv", lo=0, hi=8, seq=2, from_rank=1,
            arrays=arrays)
        assert wire.MIGRATE_OPS == ref_wire.MIGRATE_OPS

    @pytest.mark.parametrize("n,version,kv_buckets,replicas",
                             [(1, 1, None, 1), (3, 2, 1000, 2),
                              (4, 7, 8192, 1)])
    def test_partition_map_and_fleet_file_equal(self, tmp_path, n,
                                                version, kv_buckets,
                                                replicas):
        mine = partition.PartitionMap(n, version=version,
                                      kv_buckets=kv_buckets,
                                      replicas=replicas)
        ref = ref_partition.PartitionMap(n, version=version,
                                         kv_buckets=kv_buckets,
                                         replicas=replicas)
        assert mine.to_wire() == ref.to_wire()
        keys = np.random.default_rng(n).integers(
            0, 1 << 63, 500, dtype=np.uint64)
        np.testing.assert_array_equal(mine.kv_owner(keys),
                                      ref.kv_owner(keys))
        assert mine.dense_bounds(10007) == ref.dense_bounds(10007)
        members = [{"rank": r, "addresses": [f"unix:/x.{r}"],
                    "pid": 100 + r} for r in range(n)]
        partition.write_fleet_file(str(tmp_path / "a.json"), mine,
                                   members)
        ref_partition.write_fleet_file(str(tmp_path / "b.json"), ref,
                                       members)
        assert (tmp_path / "a.json").read_bytes() \
            == (tmp_path / "b.json").read_bytes()
        for r in range(n):
            assert partition.PartitionMember(mine, r).describe() \
                == ref_partition.PartitionMember(ref, r).describe()

    def test_port_modules_after_importing_the_reference(self):
        """The reference's ``_dep`` resolves ``multiverso_tpu.<mod>``;
        the port's names its own package everywhere, so a process that
        imported both keeps two sets of chaos rules and metrics."""
        import multiverso_tpu  # noqa: F401
        from multiverso_tpu_torch.client import transport
        from multiverso_tpu_torch.ft import chaos as port_chaos
        from multiverso_tpu_torch.telemetry import metrics as port_metrics
        assert wire._chaos is port_chaos
        assert wire._metrics is port_metrics
        assert wire.wiresock.__name__ == "multiverso_tpu_torch.io.wiresock"
        assert wire.shmring.__name__ == "multiverso_tpu_torch.io.shmring"
        assert transport.wire is wire
        assert transport._chaos is port_chaos
        assert transport._retry.__name__ == "multiverso_tpu_torch.ft.retry"
        assert transport._trace.__name__ \
            == "multiverso_tpu_torch.telemetry.trace"
        assert partition.hashing.__name__ \
            == "multiverso_tpu_torch.tables.hashing"
        assert ref_wire._chaos is not port_chaos

    def test_no_dep_names_the_reference(self):
        root = os.path.join(REPO, "multiverso_tpu_torch")
        for rel in (("server", "wire.py"), ("server", "partition.py"),
                    ("client", "transport.py")):
            with open(os.path.join(root, *rel)) as f:
                src = f.read()
            assert '"multiverso_tpu.' not in src, rel
            assert '"multiverso_tpu"' not in src, rel


LOADER_SRC = """
import sys
port_dir, ref_dir, first = sys.argv[1:4]
sys.path.insert(0, ref_dir)
if first == "ref":
    import multiverso_tpu  # noqa: F401
import importlib.util, os
spec = importlib.util.spec_from_file_location(
    "_port_loader", os.path.join(port_dir, "multiverso_tpu_torch",
                                 "client", "transport.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
port = mod.load_transport(os.path.join(port_dir, "multiverso_tpu_torch"))
assert "torch" not in sys.modules, "the port's transport pulled torch in"
assert first == "ref" or "jax" not in sys.modules
assert port.__name__ == "multiverso_tpu_torch.client.transport"
assert port.wire.__name__ == "multiverso_tpu_torch.server.wire"
assert port.wire._chaos.__name__ == "multiverso_tpu_torch.ft.chaos"
if first == "ref":
    from multiverso_tpu.client import transport as ref
    assert ref is not port
    assert ref.wire is not port.wire
    assert ref.wire._chaos is not port.wire._chaos
print("ok")
"""


@pytest.mark.parametrize("first", ["port", "ref"])
def test_bare_process_loads_the_port_transport(tmp_path, first):
    """A bare worker loads the port's transport by file path with
    neither torch nor jax; after ``import multiverso_tpu`` it still
    gets the port's modules, two transports and not one."""
    script = tmp_path / "load.py"
    script.write_text(LOADER_SRC)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(script), REPO, REPO, first],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path), env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")
