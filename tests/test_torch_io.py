"""The port's stream layer (``multiverso_tpu_torch/io/stream.py``) against
the JAX package's on the same calls.

- The ``file`` and ``mem://`` schemes: round trips, parent directories,
  append, a registered scheme, ranged reads, the atomic temp + rename
  write (a failed or torn write leaves the last good file), and the
  ``io.*`` byte counters, equal to the reference's registry.
- Table checkpoints through ``mem://`` and through fsspec's memory
  filesystem; a file the port writes through the stream layer is
  byte-equal to the reference's and loads in it.
- The fsspec overwrite's crash window (the reference's
  ``tests/test_io.py`` fuzz), through an in-memory filesystem whose
  ``mv`` refuses to overwrite, as hdfs does: the last good file is always
  at ``final`` or ``final.bak``.
- Chaos ``io.write`` errors are retried by ``savez_stream``'s policy.
"""

import glob

import numpy as np
import pytest

from multiverso_tpu.ft import chaos as jchaos
from multiverso_tpu.io import stream as jstream
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu_torch.ft import chaos as tchaos
from multiverso_tpu_torch.io import stream as tstream
from multiverso_tpu_torch.tables import ArrayTable, base as tbase
from multiverso_tpu_torch.telemetry import metrics as tmetrics

STREAMS = [jstream, tstream]


@pytest.fixture(autouse=True)
def _clean():
    for m in (jmetrics, tmetrics):
        m.registry().reset()
    yield
    for s in STREAMS:
        s.mem_store_clear()
    for c in (jchaos, tchaos):
        c.uninstall_chaos()
    jbase.reset_tables()
    tbase.reset_tables()


def _io_counters(m):
    return {k: v for k, v in m.snapshot()["counters"].items()
            if k.startswith("io.")}


@pytest.mark.parametrize("uri", ["file", "mem"])
def test_roundtrip_and_counters_match_reference(tmp_path, uri):
    for s in STREAMS:
        base = f"mem://{s.__name__}/" if uri == "mem" \
            else f"file://{tmp_path}/{s.__name__}/deep/"
        with s.open_stream(base + "blob.bin", "wb") as f:
            f.write(b"pay")
            f.write(b"load")
        with s.open_stream(base + "blob.bin", "ab") as f:
            f.write(b"+")
        with s.StreamFactory.get_stream(base + "blob.bin") as f:
            assert f.read() == b"payload+"
        assert s.pread(base + "blob.bin", 3, 4) == b"load"
        with pytest.raises(EOFError):
            s.pread(base + "blob.bin", 6, 9)
    assert _io_counters(tmetrics) == _io_counters(jmetrics)
    assert _io_counters(tmetrics)[f"io.write.bytes{{scheme={uri}}}"] == 8


def test_missing_and_unknown(tmp_path):
    for s in STREAMS:
        with pytest.raises(FileNotFoundError):
            s.open_stream("mem://nothing/here", "rb")
        with pytest.raises(FileNotFoundError):
            s.open_stream(str(tmp_path / "absent.bin"), "rb")
        with pytest.raises(ValueError, match="unsupported stream scheme"):
            s.open_stream("nosuchscheme-xyz://a/b", "rb")


def test_registered_scheme():
    import io
    calls = []

    def opener(path, mode):
        calls.append((path, mode))
        return io.BytesIO(b"custom")

    tstream.register_scheme("nullport", opener)
    with tstream.open_stream("nullport://whatever") as f:
        assert f.read() == b"custom"
    assert calls == [("whatever", "rb")]


def test_atomic_local_write(tmp_path):
    for s in STREAMS:
        target = str(tmp_path / f"{s.__name__}.bin")
        with s.open_stream(target, "wb") as f:
            f.write(b"v1")
        with pytest.raises(RuntimeError):
            with s.open_stream(target, "wb") as f:
                f.write(b"partial v2")
                raise RuntimeError("simulated crash")
        with open(target, "rb") as f:
            assert f.read() == b"v1"
        assert not glob.glob(target + ".tmp.*")


def test_torn_write_leaves_last_good_payload(tmp_path):
    for s, c in zip(STREAMS, (jchaos, tchaos)):
        target = str(tmp_path / f"{s.__name__}.t")
        with s.open_stream(target, "wb") as f:
            f.write(b"v1")
        c.install_chaos("io.rename:torn:times=1")
        with pytest.raises(c.ChaosTornWrite):
            with s.open_stream(target, "wb") as f:
                f.write(b"v2-half")
        c.uninstall_chaos()
        with open(target, "rb") as f:
            assert f.read() == b"v1"


def _table(pkg_base, name):
    t = pkg_base(17, "float32", updater="adagrad", name=name)
    t.add(np.arange(17, dtype=np.float32))
    return t


def test_table_checkpoint_through_mem_and_across_packages(devices,
                                                          tmp_path):
    from multiverso_tpu import core as jcore
    from multiverso_tpu.tables import ArrayTable as JArrayTable
    jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    try:
        t = _table(lambda *a, **k: ArrayTable(*a, device="cpu", **k), "io")
        t.store("mem://ck/arr.npz")
        back = ArrayTable(17, "float32", updater="adagrad", device="cpu",
                          name="io2")
        back.load("mem://ck/arr.npz")
        np.testing.assert_array_equal(back.get(), t.get())
        # the same bytes as the reference's store of the same values
        j = _table(JArrayTable, "io")
        t.store(f"file://{tmp_path}/t.npz")
        j.store(str(tmp_path / "j.npz"))
        assert (tmp_path / "t.npz").read_bytes() \
            == (tmp_path / "j.npz").read_bytes()
        j.load(f"file://{tmp_path}/t.npz")
        np.testing.assert_array_equal(np.asarray(j.get()), t.get())
    finally:
        jcore.shutdown()


def test_table_checkpoint_through_fsspec_memory():
    fsspec = pytest.importorskip("fsspec")
    try:
        t = _table(lambda *a, **k: ArrayTable(*a, device="cpu", **k), "fs")
        t.store("memory://ckpt/arr_fs.npz")
        back = ArrayTable(17, "float32", updater="adagrad", device="cpu",
                          name="fs2")
        back.load("memory://ckpt/arr_fs.npz")
        np.testing.assert_array_equal(back.get(), t.get())
    finally:
        fsspec.filesystem("memory").store.clear()


def test_chaos_write_errors_are_retried(tmp_path):
    t = _table(lambda *a, **k: ArrayTable(*a, device="cpu", **k), "ch")
    tchaos.install_chaos("io.write:error:times=2")
    t.store(str(tmp_path / "c.npz"))
    tchaos.uninstall_chaos()
    snap = tmetrics.snapshot()["counters"]
    assert snap["retry.failures{policy=io.store}"] == 2
    assert snap["chaos.fired{kind=error,point=io.write}"] == 2
    back = ArrayTable(17, "float32", updater="adagrad", device="cpu",
                      name="ch2")
    back.load(str(tmp_path / "c.npz"))
    np.testing.assert_array_equal(back.get(), t.get())


class TestOverwriteCrashWindow:
    """The fsspec overwrite (``final -> final.bak``, then ``tmp ->
    final``) under a fault or a kill at every point of the window."""

    @pytest.fixture
    def hdfsish(self):
        fsspec = pytest.importorskip("fsspec")
        from fsspec.implementations.memory import MemoryFileSystem

        class RefuseOverwriteFS(MemoryFileSystem):
            protocol = "hdfsish_port"

            def mv(self, path1, path2, **kwargs):
                if self.exists(self._strip_protocol(path2)):
                    raise OSError(f"destination exists: {path2}")
                return super().mv(path1, path2, **kwargs)

        fsspec.register_implementation("hdfsish_port", RefuseOverwriteFS,
                                       clobber=True)
        fs = fsspec.filesystem("hdfsish_port")
        try:
            yield fs
        finally:
            fs.store.clear()

    def _write(self, uri, payload):
        with tstream.open_stream(uri, "wb") as s:
            s.write(payload)

    def _recoverable(self, fs, base):
        for p in (base, base + ".bak"):
            if fs.exists(p):
                with fs.open(p, "rb") as f:
                    return f.read()
        return None

    def test_overwrite_goes_through_bak_window(self, hdfsish):
        uri = "hdfsish_port://win/ck.bin"
        self._write(uri, b"v1")
        self._write(uri, b"v2")
        assert self._recoverable(hdfsish, uri) == b"v2"
        assert not hdfsish.exists(uri + ".bak")

    @pytest.mark.parametrize("spec", [
        "io.mv.aside:error:times=1", "io.mv.replace:error:times=1",
        "io.mv.aside:crash:times=1", "io.mv.replace:crash:times=1",
        "io.write:error:times=1"])
    def test_fault_at_every_window_point(self, hdfsish, spec):
        uri = "hdfsish_port://" + "".join(
            c if c.isalnum() else "_" for c in spec) + "/ck.bin"
        self._write(uri, b"v1")
        inj = tchaos.install_chaos(spec)
        try:
            self._write(uri, b"v2")
        except BaseException:
            pass
        tchaos.uninstall_chaos()
        assert self._recoverable(hdfsish, uri) in (b"v1", b"v2"), \
            inj.counts()
        self._write(uri, b"v3")
        with tstream.open_stream(uri, "rb") as s:
            assert s.read() == b"v3"

    def test_crash_in_window_leaves_bak_for_resume(self, hdfsish):
        uri = "hdfsish_port://crash/ck.bin"
        self._write(uri, b"v1")
        tchaos.install_chaos("io.mv.replace:crash:times=1")
        with pytest.raises(tchaos.ChaosCrash):
            self._write(uri, b"v2")
        tchaos.uninstall_chaos()
        assert not hdfsish.exists(uri)
        with hdfsish.open(uri + ".bak", "rb") as f:
            assert f.read() == b"v1"
