"""The port's telemetry hooks against the JAX package's, after the same
calls.

- Tables: ``table.{get,add,store,load}.{ops,elems,bytes}`` and the
  ``table.{get,add}.seconds`` histograms' counts of ArrayTable,
  MatrixTable, SparseMatrixTable and KVTable equal the JAX tables', on
  (1, 1) and (2, 2) meshes (the reference's virtual CPU devices, the
  port's ``["cpu"] * 4``). ``profile.calls`` per dispatch name equals the
  sum of the reference's engine series (``name`` and ``name.pallas``):
  the port has one engine a device and counts every dispatch under the
  bare name. The reference's store/load also count ``io.*`` bytes
  (``tests/test_telemetry.py::test_store_load_accounting``); the port's
  ``io`` layer waits for ROADMAP queue A item 8, so they are not held
  here.
- Apps: each app's spans, ``step`` records (every field but the times),
  ``app.step.seconds`` counts and throughput counters equal the JAX
  app's on the same small run. The reference's ``profile.lower`` /
  ``profile.compile`` spans (its per-signature jit compiles) and
  ``kernel.<name>`` spans (its kernel-engine selection layer), which the
  port does not have, are left out of its records.
- The superstep: ``profile.calls{fn=superstep.<name>}`` counts calls, not
  steps, and no ``table.*`` counter moves inside a call (nothing in a
  body records telemetry).
- ``core``: ``init`` and ``barrier`` record what the reference records.
"""

import itertools

import numpy as np
import pytest

from multiverso_tpu import core as jcore
from multiverso_tpu.apps import lightlda as jlda
from multiverso_tpu.apps import logreg as jlr
from multiverso_tpu.apps import sparse_logreg as jslr
from multiverso_tpu.apps import word_embedding as jw2v
from multiverso_tpu.data import corpus as jcorpus
from multiverso_tpu.tables import (ArrayTable as JArrayTable,
                                   KVTable as JKVTable,
                                   MatrixTable as JMatrixTable,
                                   SparseMatrixTable as JSparseMatrixTable)
from multiverso_tpu.tables import base as jbase
from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu.telemetry import trace as jtrace
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.apps import lightlda as tlda
from multiverso_tpu_torch.apps import logreg as tlr
from multiverso_tpu_torch.apps import sparse_logreg as tslr
from multiverso_tpu_torch.apps import word_embedding as tw2v
from multiverso_tpu_torch.data import Corpus, synthetic_docs, synthetic_text
from multiverso_tpu_torch.tables import (ArrayTable, KVTable, MatrixTable,
                                         SparseMatrixTable, make_superstep)
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.telemetry import trace as ttrace
from multiverso_tpu_torch.utils import configure

PAIRS = [(jmetrics, jtrace), (tmetrics, ttrace)]
TIMES = ("ts", "dur_s", "tid", "dispatch_s", "pid")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("MVTPU_KERNELS", "xla")
    for m, t in PAIRS:
        m.registry().reset()
        t.set_trace_file(None)
        monkeypatch.setattr(t, "_IDS", itertools.count(1))
    jbase.reset_tables()
    tbase.reset_tables()
    yield
    for m, t in PAIRS:
        m.registry().reset()
        t.set_trace_file(None)
    jcore.shutdown()
    tcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()
    configure.reset_flags()


def _meshes(devices, shape):
    dp, mp = shape
    jm = jcore.init(devices=devices[:dp * mp], data_parallel=dp,
                    model_parallel=mp)
    return jm, tcore._build_mesh(["cpu"] * (dp * mp), dp, mp)


def _table_metrics(m) -> dict:
    """``table.*`` counters, and the ``table.*`` histograms' counts."""
    snap = m.snapshot()
    out = {k: v for k, v in snap["counters"].items()
           if k.startswith("table.")}
    out.update({k: h["count"] for k, h in snap["histograms"].items()
                if k.startswith("table.")})
    return out


def _calls(m) -> dict:
    """``profile.calls`` by dispatch name, engine series summed, zero
    series (wrappers built but never called) dropped."""
    out = {}
    for k, v in m.snapshot()["counters"].items():
        if not k.startswith("profile.calls{fn=") or not v:
            continue
        fn = k[len("profile.calls{fn="):-1]
        fn = fn[:-len(".pallas")] if fn.endswith(".pallas") else fn
        out[fn] = out.get(fn, 0) + v
    return out


def _assert_same_accounting():
    want, got = _table_metrics(jmetrics), _table_metrics(tmetrics)
    assert got == want
    assert _calls(tmetrics) == _calls(jmetrics)
    return got


SHAPES = [(1, 1), (2, 2)]


# -- the tables ---------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("updater", ["default", "adagrad"])
def test_array_table(devices, tmp_path, shape, updater):
    jm, tm = _meshes(devices, shape)
    rng = np.random.default_rng(0)
    deltas = [rng.standard_normal(37).astype(np.float32) for _ in range(3)]
    for pkg, Table, mesh in (("j", JArrayTable, jm),
                             ("t", ArrayTable, tm)):
        t = Table(37, "float32", updater=updater, mesh=mesh, name="arr")
        t.add(deltas[0])
        t.add(deltas[1], sync=True)
        t.get()
        t.get_async().wait()
        uri = str(tmp_path / f"{pkg}.npz")
        t.store(uri)
        t.add(deltas[2])
        t.load(uri)
        t.get()
    got = _assert_same_accounting()
    lbl = "{table=0:arr}"
    assert got[f"table.add.ops{lbl}"] == 3
    assert got[f"table.add.bytes{lbl}"] == 3 * 37 * 4
    assert got[f"table.get.ops{lbl}"] == got[f"table.get.seconds{lbl}"] == 3
    assert got[f"table.store.ops{lbl}"] == got[f"table.load.ops{lbl}"] == 1
    assert _calls(tmetrics)["table.apply.arr"] == 3


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("updater", ["default", "sgd", "adagrad"])
def test_matrix_table(devices, tmp_path, shape, updater):
    jm, tm = _meshes(devices, shape)
    rng = np.random.default_rng(1)
    dup = updater != "adagrad"
    ids = [rng.integers(0, 23, 9) if dup else rng.permutation(23)[:9]
           for _ in range(3)]
    deltas = [rng.standard_normal((9, 5)).astype(np.float32)
              for _ in range(3)]
    whole = rng.standard_normal((23, 5)).astype(np.float32)
    for pkg, Table, mesh in (("j", JMatrixTable, jm),
                             ("t", MatrixTable, tm)):
        t = Table(23, 5, updater=updater, mesh=mesh, name="mat")
        for i, d in zip(ids, deltas):
            t.add_rows(i, d)
        t.get_rows([0, 3, 3, 22])
        t.get_rows_async([5]).wait()
        t.add(whole)
        t.get()
        uri = str(tmp_path / f"{pkg}.npz")
        t.store(uri)
        t.load(uri)
    got = _assert_same_accounting()
    lbl = "{table=0:mat}"
    assert got[f"table.add.elems{lbl}"] == 3 * 45 + 115
    assert got[f"table.get.elems{lbl}"] == 5 * 5 + 115
    calls = _calls(tmetrics)
    assert calls["table.gather.mat"] == 2
    assert calls.get("table.scatter_add.mat", 0) == (3 if dup else 0)
    assert calls.get("table.apply_rows.mat", 0) == (0 if dup else 3)


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_matrix_table_engines(devices, monkeypatch, engine):
    """The reference's Pallas engine counts under ``name.pallas``; the
    port's one series equals the sum."""
    monkeypatch.setenv("MVTPU_KERNELS", engine)
    jm, tm = _meshes(devices, (1, 1))
    rng = np.random.default_rng(2)
    ids, d = rng.integers(0, 16, 12), rng.standard_normal((12, 128))
    for Table, mesh in ((JMatrixTable, jm), (MatrixTable, tm)):
        t = Table(16, 128, mesh=mesh, name="eng")
        t.add_rows(ids, d.astype(np.float32))
        t.get_rows(ids)
    _assert_same_accounting()
    series = [k for k in jmetrics.snapshot()["counters"]
              if k.startswith("profile.calls{fn=table.gather.eng")
              and jmetrics.snapshot()["counters"][k]]
    assert series == ["profile.calls{fn=table.gather.eng"
                      + (".pallas}" if engine == "pallas" else "}")]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tiled", [False, True])
def test_sparse_matrix_table(devices, tmp_path, shape, tiled):
    jm, tm = _meshes(devices, shape)
    rng = np.random.default_rng(3)
    cols = 256 if tiled else 12
    adds = [(rng.integers(0, 19, 40), rng.integers(0, cols, 40),
             rng.integers(1, 5, 40).astype(np.int32)) for _ in range(2)]
    for pkg, Table, mesh in (("j", JSparseMatrixTable, jm),
                             ("t", SparseMatrixTable, tm)):
        t = Table(19, cols, "int32", mesh=mesh, name="sp", tiled=tiled)
        for r, c, v in adds:
            t.add_sparse(r, c, v)
        t.get_rows_sparse([0, 4, 4, 18])
        t.get_rows([1, 2])
        t.get()
        uri = str(tmp_path / f"{pkg}.npz")
        t.store(uri)
        t.load(uri)
    got = _assert_same_accounting()
    lbl = "{table=0:sp}"
    assert got[f"table.add.elems{lbl}"] == 80
    assert got[f"table.add.bytes{lbl}"] == 320
    assert _calls(tmetrics)["table.coo_scatter_add.sp"] == 2


def _kv_run(KV, mesh, tmp_path, pkg, dtype, value_dim, updater, store):
    rng = np.random.default_rng(4)
    keys = rng.choice(np.arange(1, 10_000, dtype=np.uint64), 60,
                      replace=False)
    shape = (30, value_dim) if value_dim else (30,)
    t = KV(256, value_dim, dtype, updater=updater, mesh=mesh, name="kv")
    for sl in (slice(0, 30), slice(15, 45), slice(30, 60)):
        t.add(keys[sl], rng.standard_normal(shape).astype(np.float32))
    t.get(np.concatenate([keys[:20], np.arange(20_000, 20_010,
                                               dtype=np.uint64)]))
    t.wait()
    if store:
        uri = str(tmp_path / f"{pkg}.npz")
        t.store(uri)
        t.load(uri)
        t.get(keys[:5])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("updater,value_dim", [("sgd", 0), ("adagrad", 2),
                                               ("ftrl", 2)])
def test_kv_table(devices, tmp_path, shape, updater, value_dim):
    jm, tm = _meshes(devices, shape)
    for pkg, KV, mesh in (("j", JKVTable, jm), ("t", KVTable, tm)):
        _kv_run(KV, mesh, tmp_path, pkg, "float32", value_dim, updater,
                store=True)
    got = _assert_same_accounting()
    lbl = "{table=0:kv}"
    per = max(value_dim, 1)
    assert got[f"table.add.bytes{lbl}"] == 90 * per * 4
    assert got[f"table.get.elems{lbl}"] == 35 * per
    calls = _calls(tmetrics)
    assert calls["kv.apply.kv"] == 3 and calls["kv.lookup.kv"] == 2


def test_kv_table_bfloat16_counts_two_bytes(devices, tmp_path):
    """``table.add.bytes`` is the delta's size times the value type's
    itemsize (``multiverso_tpu/tables/kv_table.py:651-652``): 2 bytes a
    value of a bfloat16 table, whatever the delta's own type."""
    jm, tm = _meshes(devices, (1, 1))
    for pkg, KV, mesh in (("j", JKVTable, jm), ("t", KVTable, tm)):
        _kv_run(KV, mesh, tmp_path, pkg, "bfloat16", 2, "sgd", store=False)
    got = _assert_same_accounting()
    assert got["table.add.bytes{table=0:kv}"] == 90 * 2 * 2


# -- the superstep ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 1)])
def test_superstep_counts_calls_and_records_nothing_inside(shape):
    import torch
    from multiverso_tpu_torch.tables.superstep import (DataSplit,
                                                       gather_rows,
                                                       row_scatter_add)
    dp, mp = shape
    mesh = tcore._build_mesh(["cpu"] * (dp * mp), dp, mp)
    table = MatrixTable(40, 4, mesh=mesh, name="w")
    seen = []

    def body(params, states, locals_, options, ids):
        (p,), (s,) = params, states
        for step in range(ids.shape[0]):
            seen.append(_table_metrics(tmetrics))
            rows = gather_rows(p, ids[step])
            p = row_scatter_add(p, ids[step], rows * 0 + 1.0)
        return (p,), (s,), locals_, None

    fused = make_superstep([table], body, name="sstep")
    ids = torch.arange(24).reshape(3, 8) % 40
    before = _table_metrics(tmetrics)
    for _ in range(2):
        fused((), DataSplit.of(ids, mesh, axis=1) if dp > 1 else ids)
    assert _table_metrics(tmetrics) == before
    assert all(s == before for s in seen)
    assert len(seen) == 2 * 3 * dp
    assert tmetrics.counter("profile.calls", fn="superstep.sstep").value \
        == 2


# -- core ------------------------------------------------------------------


def test_core_init_and_barrier_gauges(devices):
    _meshes(devices, (2, 2))
    tcore.init(devices=["cpu"] * 4, data_parallel=2, model_parallel=2)
    jcore.barrier()
    tcore.barrier()
    tcore.barrier()
    for name in ("core.devices", "core.data_parallel", "core.model_parallel",
                 "core.processes", "core.process_index"):
        assert tmetrics.gauge(name).value == jmetrics.gauge(name).value
    assert tmetrics.counter("core.init.ops").value == 1
    assert tmetrics.counter("core.barrier.ops").value == 2
    assert tmetrics.snapshot()["histograms"][
        "core.barrier.seconds"]["count"] == 2


# -- the apps ---------------------------------------------------------------


def _normalized(records):
    """Trace records without times, span ids renumbered in order of
    appearance, and without the reference's compile spans and its
    kernel-engine spans (``kernel.<name>``, one a dispatch through its
    ``MVTPU_KERNELS`` selection layer, which the port does not have)."""
    keep = [r for r in records
            if r.get("name") not in ("profile.lower", "profile.compile")
            and not r.get("name", "").startswith("kernel.")]
    ids = {r["id"]: i + 1 for i, r in enumerate(
        r for r in keep if r["kind"] == "span")}
    out = []
    for r in keep:
        r = {k: v for k, v in r.items() if k not in TIMES}
        if "id" in r:
            r["id"] = ids[r["id"]]
        if r.get("parent") is not None:
            r["parent"] = ids[r["parent"]]
        if "attrs" in r:
            r["attrs"] = {k: v for k, v in r["attrs"].items()
                          if k != "engine"}
        out.append(r)
    return out


def _app_metrics(m, prefix):
    snap = m.snapshot()
    return ({k: v for k, v in snap["counters"].items()
             if k.startswith(prefix)},
            {k: h["count"] for k, h in snap["histograms"].items()
             if k.startswith("app.step.seconds")},
            sorted(k for k in snap["gauges"] if k.startswith(prefix)))


def _run_both(tmp_path, run_j, run_t, prefix):
    out = {}
    for pkg, (m, t), run in (("j", PAIRS[0], run_j), ("t", PAIRS[1], run_t)):
        path = str(tmp_path / f"trace-{pkg}.jsonl")
        t.set_trace_file(path)
        run()
        t.set_trace_file(None)
        out[pkg] = (_normalized(jtrace.read_trace(path)),
                    _app_metrics(m, prefix))
    assert out["t"][0] == out["j"][0]
    assert out["t"][1] == out["j"][1]
    return out["t"]


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    path = tmp_path_factory.mktemp("w2v") / "zipf.txt"
    synthetic_text(str(path), num_tokens=6_000, vocab_size=150, seed=2)
    return str(path)


def test_word2vec_telemetry(devices, text, tmp_path):
    jm, _ = _meshes(devices, (1, 1))
    kw = dict(embedding_dim=8, window=2, negative=2, batch_size=32,
              steps_per_call=3, learning_rate=0.025, seed=5)
    japp = jw2v.WordEmbedding(jcorpus.Corpus.from_file(text, min_count=1),
                              jw2v.W2VConfig(**kw), mesh=jm)
    tapp = tw2v.WordEmbedding(Corpus.from_file(text, min_count=1),
                              tw2v.W2VConfig(**kw), device="cpu")
    records, (counters, hists, gauges) = _run_both(
        tmp_path, lambda: japp.train(total_steps=9),
        lambda: tapp.train(total_steps=9), "w2v.")
    steps = [r for r in records if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert all(r["pairs"] == 3 * 32 for r in steps)
    assert [r["name"] for r in records if r["kind"] == "span"] \
        == ["w2v.superstep"] * 3
    assert counters == {"w2v.pairs": 9 * 32}
    assert hists == {"app.step.seconds{app=w2v}": 3}
    assert gauges == ["w2v.words_per_sec"]
    # a call is one profile.calls, in both packages
    assert tmetrics.counter("profile.calls",
                            fn="superstep.w2v_superstep").value \
        == jmetrics.counter("profile.calls",
                            fn="superstep.w2v_superstep").value == 3


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    path = tmp_path_factory.mktemp("lda") / "docs.txt"
    synthetic_docs(str(path), num_docs=60, vocab_size=120, avg_doc_len=30,
                   num_topics=4, seed=0)
    return tlda.load_docs(str(path))


def test_lightlda_telemetry(devices, docs, tmp_path):
    jm, _ = _meshes(devices, (1, 1))
    tw, td, V = docs
    cfg = dict(num_topics=8, batch_tokens=512, steps_per_call=2, seed=1,
               eval_every=2)
    japp = jlda.LightLDA(tw, td, V, jlda.LDAConfig(**cfg), mesh=jm,
                         name="j")
    tapp = tlda.LightLDA(tw, td, V, tlda.LDAConfig(**cfg), device="cpu",
                         name="t")
    records, (counters, hists, gauges) = _run_both(
        tmp_path, lambda: japp.train(num_iterations=3),
        lambda: tapp.train(num_iterations=3), "lda.")
    steps = [r for r in records if r["kind"] == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert all(r["tokens"] == len(tw) for r in steps)
    assert counters == {"lda.tokens": 3 * len(tw)}
    assert hists == {"app.step.seconds{app=lda}": 3}
    assert gauges == ["lda.doc_tokens_per_sec"]


@pytest.mark.parametrize("n", [347, 320])
def test_logreg_telemetry(devices, tmp_path, n):
    """347 samples: two 4-step supersteps, two single steps and a short
    one; 320: the two supersteps and two single steps."""
    jm, _ = _meshes(devices, (1, 1))
    X, y = tlr.synthetic_blobs(n, 6, 3, seed=1)
    kw = dict(input_dim=6, num_classes=3, minibatch_size=32,
              steps_per_call=4, learning_rate=0.2, seed=3, epochs=2)
    japp = jlr.LogisticRegression(jlr.LogRegConfig(**kw), mesh=jm)
    tapp = tlr.LogisticRegression(tlr.LogRegConfig(**kw), device="cpu")
    records, (counters, hists, gauges) = _run_both(
        tmp_path, lambda: japp.train(X, y), lambda: tapp.train(X, y),
        "logreg.")
    names = [r["name"] for r in records if r["kind"] == "span"]
    per_epoch = ["logreg.superstep"] * 2 \
        + ["logreg.step"] * (3 if n == 347 else 2)
    assert names == per_epoch * 2
    samples = [r["samples"] for r in records if r["kind"] == "step"]
    assert sum(samples) == 2 * n
    assert counters == {"logreg.samples": 2 * n}
    assert gauges == ["logreg.samples_per_sec"]


def test_sparse_logreg_telemetry(devices, tmp_path):
    jm, _ = _meshes(devices, (1, 1))
    rows, y = tslr.synthetic_sparse(n=150, dim=2000, num_classes=2, nnz=6,
                                    seed=7)
    cfg = tslr.SparseLRConfig(num_classes=2, max_features=8,
                              capacity=1 << 12, minibatch_size=64,
                              learning_rate=0.3, epochs=2)
    japp = jslr.SparseLogisticRegression(
        jslr.SparseLRConfig(**{f: getattr(cfg, f)
                               for f in cfg.__dataclass_fields__}),
        mesh=jm, name="slr")
    tapp = tslr.SparseLogisticRegression(cfg, device="cpu", name="slr")
    records, (counters, hists, gauges) = _run_both(
        tmp_path, lambda: japp.train(rows, y), lambda: tapp.train(rows, y),
        "sparse_logreg.")
    steps = [r for r in records if r["kind"] == "step"]
    assert [r["samples"] for r in steps] == [64, 64, 22] * 2
    # each step's span holds the KV table's Get and Add spans
    spans = [r for r in records if r["kind"] == "span"]
    assert [r["name"] for r in spans[:3]] \
        == ["table.get", "table.add", "sparse_logreg.step"]
    assert spans[0]["parent"] == spans[2]["id"]
    assert counters == {"sparse_logreg.samples": 300}
    assert hists == {"app.step.seconds{app=sparse_logreg}": 6}
    assert gauges == ["sparse_logreg.samples_per_sec"]
    assert _table_metrics(tmetrics) == _table_metrics(jmetrics)
