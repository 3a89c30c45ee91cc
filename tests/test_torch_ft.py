"""The port's fault tolerance (``multiverso_tpu_torch/ft``) against the
JAX package's.

- Chaos: the same spec parses to the same rules and fires at the same
  hits; the ``nan`` kind poisons the same flat indices of a torch tensor
  as the reference does of a numpy array.
- Retry: the same seed gives the same backoff sequence; what retries and
  what never does, with the ``retry.*`` counters.
- The run checkpoint manager: save / scan / resume, keep-K retention,
  fallback past an incomplete or corrupt generation, a background write
  failure that surfaces, a changed config that fails loudly, the
  watchdog's restart point, a KVTable, and a generation rewritten after a
  rollback replays its step.
- A run directory crosses both ways between the packages (tables, app
  state, the dense logreg app). The two packages' config dataclasses
  differ in fields, so their ``config_fingerprint``s differ: these tests
  pass the same explicit fingerprint on both sides.
- A table file of a generation is byte-equal to the same table's
  ``store()``.
- Kill and resume: the port's logreg (killed under chaos IO faults) and
  LightLDA, resumed in a fresh app, equal their uninterrupted runs bit
  for bit.
- The four apps' CLIs take ``-run_dir``, ``-resume`` and ``-ckpt_every``.
"""

import json
import os

import numpy as np
import pytest
import torch

from multiverso_tpu import core as jcore
from multiverso_tpu.ft import chaos as jchaos
from multiverso_tpu.ft import checkpoint as jckpt
from multiverso_tpu.ft import retry as jretry
from multiverso_tpu.tables import base as jbase
from multiverso_tpu_torch import core as tcore
from multiverso_tpu_torch.ft import chaos as tchaos
from multiverso_tpu_torch.ft import checkpoint as tckpt
from multiverso_tpu_torch.ft import retry as tretry
from multiverso_tpu_torch.tables import (ArrayTable, KVTable,
                                         SparseMatrixTable)
from multiverso_tpu_torch.tables import base as tbase
from multiverso_tpu_torch.telemetry import health as thealth
from multiverso_tpu_torch.telemetry import metrics as tmetrics
from multiverso_tpu_torch.utils import configure


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for m in (jckpt, tckpt):
        monkeypatch.setattr(m, "_LATEST_GOOD", None)
    for k in ("MVTPU_RUN_DIR", "MVTPU_RESUME", "MVTPU_CKPT_EVERY",
              "MVTPU_CHAOS", "MVTPU_HEALTH"):
        monkeypatch.delenv(k, raising=False)
    yield
    for c in (jchaos, tchaos):
        c.uninstall_chaos()
    thealth.uninstall()
    jcore.shutdown()
    tcore.shutdown()
    jbase.reset_tables()
    tbase.reset_tables()
    configure.reset_flags()


def _counter(prefix):
    return sum(v for k, v in tmetrics.snapshot()["counters"].items()
               if k.startswith(prefix))


# -- chaos and retry ---------------------------------------------------------

SPECS = ["seed=7;io.write:error:p=0.5,times=3;io.*:latency:ms=2",
         "pt:error:after=2,times=1", "seed=11;pt:error:p=0.3",
         "table.add:nan:frac=0.25;pt:torn:p=0.7,after=1"]


def _rules(inj):
    return [(r.pattern, r.kind, r.p, r.after, r.times, r.ms, r.frac)
            for r in inj.rules], inj.seed


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_fires_at_the_same_hits(spec):
    injs = [c.parse_chaos_spec(spec) for c in (jchaos, tchaos)]
    assert _rules(injs[1]) == _rules(injs[0])
    fired = []
    for inj in injs:
        hits = []
        for i in range(80):
            try:
                inj.hit("pt" if i % 3 else "io.write")
                hits.append(None)
            except BaseException as e:          # noqa: B036 (crash kinds)
                hits.append(type(e).__name__)
        fired.append(hits)
    assert fired[1] == fired[0]
    assert injs[1].counts() == injs[0].counts()


def test_malformed_chaos_specs_raise_alike():
    for bad in ("io.write", "io.write:explode", "io.write:error:freq=2",
                "io.write:error:p"):
        for c in (jchaos, tchaos):
            with pytest.raises(ValueError):
                c.parse_chaos_spec(bad)


@pytest.mark.parametrize("spec,shape", [
    ("seed=3;table.add:nan:times=2", (64,)),
    ("seed=5;table.add:nan:frac=0.1", (16, 12)),
    ("table.add:nan:after=1,frac=0.3", (7, 3, 5))])
def test_nan_poisons_the_same_flat_indices(spec, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jinj, tinj = jchaos.parse_chaos_spec(spec), tchaos.parse_chaos_spec(spec)
    for _ in range(3):
        want = jinj.corrupt("table.add", x)
        got = tinj.corrupt("table.add", torch.from_numpy(x))
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_array_equal(got.numpy(), want)
        # the numpy form too
        np.testing.assert_array_equal(
            tchaos.parse_chaos_spec(spec).corrupt("table.add", x),
            jchaos.parse_chaos_spec(spec).corrupt("table.add", x))
    assert not np.isnan(x).any()


def test_chaos_from_env(monkeypatch):
    assert tchaos.chaos_from_env() is None
    monkeypatch.setenv("MVTPU_CHAOS", "seed=9;core.barrier:error:times=1")
    tcore.init(device="cpu")
    with pytest.raises(tchaos.ChaosError):
        tcore.barrier()
    tcore.barrier()


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_backoff_sequences_are_equal(seed):
    kw = dict(max_attempts=8, base_delay_s=0.01, max_delay_s=0.05,
              seed=seed)
    j, t = jretry.RetryPolicy(**kw), tretry.RetryPolicy(**kw)
    assert [t.backoff_s(a) for a in range(1, 9)] \
        == [j.backoff_s(a) for a in range(1, 9)]
    assert max(t.backoff_s(a) for a in range(1, 40)) <= 0.05


def test_retry_policy_semantics():
    tmetrics.registry().reset()
    pol = tretry.RetryPolicy(max_attempts=3, base_delay_s=0.0, seed=1,
                             name="t")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise tchaos.ChaosError("transient")
        return "ok"

    assert pol.call(flaky) == "ok" and len(calls) == 3
    with pytest.raises(tretry.RetryError):
        pol.call(lambda: (_ for _ in ()).throw(OSError("dead")))
    for exc in (FileNotFoundError("x"), ValueError("x"),
                tchaos.ChaosCrash("x")):
        seen = []

        def fail(exc=exc):
            seen.append(1)
            raise exc
        with pytest.raises(type(exc)):
            pol.call(fail)
        assert len(seen) == 1
    snap = tmetrics.snapshot()["counters"]
    assert snap["retry.recoveries{policy=t}"] == 1
    assert snap["retry.giveups{policy=t,reason=attempts}"] == 1
    assert tretry.io_retry_policy().max_attempts == 3


# -- the run checkpoint manager ----------------------------------------------

def _arr(name, n=11):
    t = ArrayTable(n, "float32", updater="adagrad", device="cpu", name=name)
    t.add(np.arange(n, dtype=np.float32))
    return t


def test_save_scan_resume_roundtrip(tmp_path):
    t = _arr("m_arr")
    want = t.get()
    with tckpt.RunCheckpointManager(str(tmp_path), keep=3,
                                    tables=[t]) as mgr:
        mgr.save(5, {"cursor": 7, "rng": np.arange(3)})
        mgr.flush()
        assert [g.step for g in mgr.scan()] == [5]
    t2 = ArrayTable(11, "float32", updater="adagrad", device="cpu",
                    name="m_arr")
    st = tckpt.RunCheckpointManager(str(tmp_path), tables=[t2],
                                    background=False).resume()
    assert st.step == 5 and st.get("cursor") == 7
    np.testing.assert_array_equal(st.get("rng"), np.arange(3))
    np.testing.assert_array_equal(t2.get(), want)
    assert tckpt.latest_good_checkpoint().endswith("gen-0000000005")


def test_retention_keeps_exactly_last_k(tmp_path):
    t = _arr("gc_arr")
    mgr = tckpt.RunCheckpointManager(str(tmp_path), keep=2, tables=[t],
                                     background=False)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step)
    assert [g.step for g in mgr.scan()] == [4, 5]
    assert sorted(os.listdir(tmp_path)) == ["gen-0000000004",
                                            "gen-0000000005"]


@pytest.mark.parametrize("damage", ["manifest", "payload"])
def test_fallback_past_a_torn_generation(tmp_path, damage):
    t = _arr("fb_arr")
    mgr = tckpt.RunCheckpointManager(str(tmp_path), keep=5, tables=[t],
                                     background=False)
    mgr.save(1)
    want = t.get()
    t.add(np.ones(11, np.float32))
    mgr.save(2)
    gen2 = os.path.join(str(tmp_path), "gen-0000000002")
    if damage == "manifest":
        with open(os.path.join(gen2, tckpt.MANIFEST_NAME), "w") as f:
            f.write('{"magic": "multiverso_tpu.run_ck')
        assert [g.step for g in mgr.scan()] == [1]
    else:
        p2 = os.path.join(gen2, "table-fb_arr.npz")
        raw = bytearray(open(p2, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(p2, "wb").write(bytes(raw))
    before = _counter("ft.recover.fallbacks")
    assert mgr.resume().step == 1
    np.testing.assert_array_equal(t.get(), want)
    assert _counter("ft.recover.fallbacks") - before \
        == (1 if damage == "payload" else 0)


def test_fingerprint_mismatch_raises(tmp_path):
    t = _arr("fp_arr")
    tckpt.RunCheckpointManager(str(tmp_path), tables=[t], fingerprint="aaaa",
                               background=False).save(1)
    with pytest.raises(ValueError, match="fingerprint"):
        tckpt.RunCheckpointManager(str(tmp_path), tables=[t],
                                   fingerprint="bbbb",
                                   background=False).resume()


def test_maybe_save_cadence_and_replay_after_resume(tmp_path):
    t = _arr("cad_arr")
    mgr = tckpt.RunCheckpointManager(str(tmp_path), every=3, tables=[t],
                                     background=False, keep=5)
    evaluated = []

    def state():
        evaluated.append(1)
        return {"x": len(evaluated)}

    for step in range(1, 8):
        mgr.maybe_save(step, state)
    assert [g.step for g in mgr.scan()] == [3, 6] and len(evaluated) == 2
    assert not mgr.maybe_save(6, state)
    # after a resume (a rollback) the replayed step commits again
    assert mgr.resume(max_step=3).step == 3
    assert mgr.maybe_save(6, state)
    assert mgr.resume().get("x") == 3


def test_background_write_failure_surfaces(tmp_path):
    t = _arr("bg_arr")
    mgr = tckpt.RunCheckpointManager(str(tmp_path), tables=[t])
    tchaos.install_chaos("io.write:error")
    mgr.save(1)
    with pytest.raises(RuntimeError, match="background run-checkpoint"):
        mgr.flush()
    tchaos.uninstall_chaos()
    mgr.save(2)
    mgr.flush()
    assert [g.step for g in mgr.scan()] == [2]
    mgr.close()


def test_watchdog_dump_names_restart_point(tmp_path):
    from multiverso_tpu_torch.telemetry.watchdog import Watchdog
    t = _arr("wd_arr")
    tckpt.RunCheckpointManager(str(tmp_path / "run"), tables=[t],
                               background=False).save(9)
    path = Watchdog(60.0, name="ft-test",
                    dump_dir=str(tmp_path / "dump")).dump()
    with open(os.path.join(path, "watchdog.json")) as f:
        doc = json.load(f)
    assert doc["latest_checkpoint"] == tckpt.latest_good_checkpoint()
    assert "gen-0000000009" in doc["latest_checkpoint"]


# -- across the packages ------------------------------------------------------

KEYS = np.array([3, 11, 12345, 77], np.uint64)


def _fill(pkg, kw):
    """The same three tables in either package, updated alike."""
    a = pkg.ArrayTable(11, "float32", updater="adagrad", name="x_arr", **kw)
    a.add(np.arange(11, dtype=np.float32))
    m = pkg.MatrixTable(6, 4, "float32", updater="default", name="x_mat",
                        **kw)
    m.add_rows([1, 4], np.full((2, 4), 0.5, np.float32))
    k = pkg.KVTable(1 << 10, value_dim=2, updater="adagrad", name="x_kv",
                    **kw)
    k.add(KEYS, np.arange(8, dtype=np.float32).reshape(4, 2))
    return a, m, k


def _values(tables):
    a, m, k = tables
    return [np.asarray(a.get()), np.asarray(m.get()),
            np.asarray(k.get(KEYS)[0])]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_run_dir_crosses_between_packages(devices, tmp_path, writer):
    import multiverso_tpu.tables as jtables
    import multiverso_tpu_torch.tables as ttables
    jcore.init(devices=devices[:1], data_parallel=1, model_parallel=1)
    pkgs = {"jax": (jtables, {}, jckpt), "torch": (ttables,
                                                   {"device": "cpu"}, tckpt)}
    reader = "torch" if writer == "jax" else "jax"
    wt, wkw, wck = pkgs[writer]
    src = _fill(wt, wkw)
    wck.RunCheckpointManager(str(tmp_path), tables=list(src),
                             fingerprint="shared", background=False).save(
        4, {"cursor": 9, "rng": np.arange(5, dtype=np.int32)})
    rt, rkw, rck = pkgs[reader]
    dst = (rt.ArrayTable(11, "float32", updater="adagrad", name="x_arr",
                         **rkw),
           rt.MatrixTable(6, 4, "float32", updater="default", name="x_mat",
                          **rkw),
           rt.KVTable(1 << 10, value_dim=2, updater="adagrad", name="x_kv",
                      **rkw))
    st = rck.RunCheckpointManager(str(tmp_path), tables=list(dst),
                                  fingerprint="shared",
                                  background=False).resume()
    assert st.step == 4 and st.get("cursor") == 9
    np.testing.assert_array_equal(st.get("rng"), np.arange(5))
    for got, want in zip(_values(dst), _values(src)):
        np.testing.assert_array_equal(got, want)
    # the updater state crossed too: one more identical add stays equal
    src[0].add(np.ones(11, np.float32))
    dst[0].add(np.ones(11, np.float32))
    np.testing.assert_array_equal(np.asarray(dst[0].get()),
                                  np.asarray(src[0].get()))


def test_logreg_run_dir_crosses_from_the_reference(devices, tmp_path):
    from multiverso_tpu.apps import logreg as jlr
    from multiverso_tpu_torch.apps import logreg as tlr
    kw = dict(input_dim=6, num_classes=3, minibatch_size=32, epochs=3,
              updater="adagrad", seed=2)
    X, y = tlr.synthetic_blobs(96, 6, 3, seed=1)
    japp = jlr.LogisticRegression(jlr.LogRegConfig(**kw), mesh=jcore.init(
        devices=devices[:1], data_parallel=1, model_parallel=1))
    japp.run_ckpt = jckpt.RunCheckpointManager(
        str(tmp_path), every=1, tables=[japp.table], fingerprint="lr",
        background=False)
    japp.train(X, y)
    tapp = tlr.LogisticRegression(tlr.LogRegConfig(**kw), device="cpu")
    st = tckpt.RunCheckpointManager(str(tmp_path), tables=[tapp.table],
                                    fingerprint="lr",
                                    background=False).resume()
    tapp.restore_run_state(st)
    assert tapp._epoch_done == 3
    np.testing.assert_array_equal(tapp.table.get(),
                                  np.asarray(japp.table.get()))


def _npz_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", ["adagrad", "sharded", "shard_update",
                                  "tiled", "kv_bf16"])
def test_generation_file_equals_store(tmp_path, case):
    mesh = tcore._build_mesh(["cpu"] * 4, 2, 2)
    if case == "kv_bf16":
        t = KVTable(1 << 10, value_dim=3, dtype="bfloat16", updater="adagrad",
                    mesh=mesh, name="g")
        t.add(KEYS, np.linspace(-1, 1, 12, dtype=np.float32).reshape(4, 3))
    elif case == "tiled":
        t = SparseMatrixTable(16, 256, "float32", tiled=True, device="cpu",
                              name="g")
        t.add_sparse([1, 5, 5], [3, 200, 201],
                     np.array([1.0, 2.0, 3.0], np.float32))
    else:
        t = ArrayTable(13, "float32", updater="adagrad", name="g",
                       **({"device": "cpu"} if case == "adagrad" else
                          {"mesh": mesh,
                           "shard_update": case == "shard_update"}))
        t.add(np.linspace(0, 3, 13, dtype=np.float32))
    tckpt.RunCheckpointManager(str(tmp_path / "run"), tables=[t],
                               background=False).save(1)
    t.store(str(tmp_path / "store.npz"))
    assert _npz_bytes(tmp_path / "run" / "gen-0000000001" / "table-g.npz") \
        == _npz_bytes(tmp_path / "store.npz")
    if case not in ("kv_bf16",):
        # the bytes the port's store wrote before the export split: the
        # shards and state leaves gathered on the first device
        manifest = t._manifest()
        keys = tbase.state_keys(t.shard_states[0])
        payload = {"param": t._whole().view(t.padded_shape).numpy()}
        for i, key in enumerate(keys):
            payload[f"state_{i}"] = t._state_leaf(key).numpy()
        manifest["n_state_leaves"] = len(keys)
        tbase.savez_stream(str(tmp_path / "old.npz"), manifest, payload)
        assert _npz_bytes(tmp_path / "old.npz") \
            == _npz_bytes(tmp_path / "store.npz")


def test_export_holds_the_values_before_a_later_add(tmp_path):
    t = _arr("ex_arr")
    before = t.get().copy()
    finish = t.export_checkpoint_async()
    t.add(np.ones(11, np.float32))
    _, payload = finish()
    np.testing.assert_array_equal(payload["param"][:11], before)
    assert not np.array_equal(t.get(), before)


# -- kill and resume ----------------------------------------------------------

class _Kill(BaseException):
    """Simulated eviction: BaseException so nothing recovers it."""


def _logreg():
    from multiverso_tpu_torch.apps.logreg import (LogisticRegression,
                                                  LogRegConfig)
    return LogisticRegression(LogRegConfig(
        input_dim=10, num_classes=3, minibatch_size=32, steps_per_call=2,
        epochs=4, learning_rate=0.1, updater="adagrad", seed=3),
        device="cpu", name="eq_lr")


def _state(table):
    return [table.state[k].numpy().copy() for k in sorted(table.state)]


def test_logreg_killed_under_chaos_resumes_equal(tmp_path):
    from multiverso_tpu_torch.apps.logreg import synthetic_blobs
    X, y = synthetic_blobs(192, 10, 3, seed=5)
    full = _logreg()
    full.train(X, y)
    want, want_state = full.table.get(), _state(full.table)
    tbase.reset_tables()

    app = _logreg()
    mgr = tckpt.RunCheckpointManager(str(tmp_path), keep=2, every=1,
                                     tables=[app.table])
    app.run_ckpt = mgr
    # write calls 1, 6 and 12 fail; the 3-attempt retry recovers each
    tchaos.install_chaos("io.write:error:times=1;"
                         "io.write:error:after=5,times=1;"
                         "io.write:error:after=11,times=1")
    orig, seen = app.train_epoch, []

    def dying_epoch(X, y, shuffle_seed=None):
        if len(seen) == 2:
            raise _Kill()
        r = orig(X, y, shuffle_seed=shuffle_seed)
        seen.append(1)
        return r

    app.train_epoch = dying_epoch
    with pytest.raises(_Kill):
        app.train(X, y)
    mgr.close()
    tchaos.uninstall_chaos()
    tbase.reset_tables()

    res = _logreg()
    mgr2 = tckpt.RunCheckpointManager(str(tmp_path), keep=2, every=1,
                                      tables=[res.table])
    st = mgr2.resume()
    assert st is not None and st.step == 2
    res.restore_run_state(st)
    res.run_ckpt = mgr2
    res.train(X, y)
    mgr2.close()
    np.testing.assert_array_equal(res.table.get(), want)
    for a, b in zip(_state(res.table), want_state):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", [
    {}, {"sampler": "tiled", "doc_blocked": True, "block_tokens": 64,
         "block_docs": 4, "num_topics": 128}])
def test_lightlda_sweep_resume_equal(tmp_path, mode):
    from multiverso_tpu_torch.apps.lightlda import LDAConfig, LightLDA
    rng = np.random.default_rng(0)
    T, D, V = 600, 24, 40
    td = np.sort(rng.integers(0, D, T)).astype(np.int32)
    tw = rng.integers(0, V, T).astype(np.int32)
    cfg = dict(num_topics=8, batch_tokens=64, steps_per_call=2,
               num_iterations=4, eval_every=10, seed=2)
    cfg.update(mode)

    def make():
        return LightLDA(tw, td, V, LDAConfig(**cfg), device="cpu",
                        name="eq_lda")

    full = make()
    full.train()
    want = (full.word_topics(), full.doc_topics())
    tbase.reset_tables()
    app = make()
    mgr = tckpt.RunCheckpointManager(str(tmp_path), keep=2, every=1,
                                     tables=[app.word_topic, app.summary])
    app.run_ckpt = mgr
    app.train(num_iterations=2)                 # "killed" after sweep 2
    mgr.close()
    tbase.reset_tables()
    res = make()
    mgr2 = tckpt.RunCheckpointManager(str(tmp_path), keep=2, every=1,
                                      tables=[res.word_topic, res.summary])
    st = mgr2.resume()
    assert st.step == 2
    res.restore_run_state(st)
    assert res._sweep_done == 2
    res.run_ckpt = mgr2
    res.train()
    mgr2.close()
    np.testing.assert_array_equal(res.word_topics(), want[0])
    np.testing.assert_array_equal(res.doc_topics(), want[1])


# -- the CLIs -------------------------------------------------------------------

def _run_main(main, argv):
    try:
        main(argv)
    finally:
        configure.reset_flags()
        tcore.shutdown()
        tbase.reset_tables()


def _cli_inputs(tmp_path, app):
    if app == "word_embedding":
        from multiverso_tpu_torch.data import synthetic_text
        path = str(tmp_path / "text.txt")
        synthetic_text(path, num_tokens=3000, vocab_size=80, seed=2)
        return [f"-train_file={path}", "-size=8", "-window=2", "-epoch=1",
                "-batch_size=64", "-min_count=1"]
    if app == "lightlda":
        from multiverso_tpu_torch.data import synthetic_docs
        path = str(tmp_path / "docs.txt")
        synthetic_docs(path, num_docs=20, vocab_size=30, avg_doc_len=15,
                       num_topics=4, seed=1)
        return [f"-input_file={path}", "-num_topics=8", "-batch_tokens=64",
                "-steps_per_call=2", "-num_iterations=2"]
    if app == "sparse_logreg":
        from multiverso_tpu_torch.apps.sparse_logreg import synthetic_sparse
        rows, y = synthetic_sparse(n=64, dim=100, num_classes=2, nnz=4,
                                   seed=6)
        path = tmp_path / "train.txt"
        path.write_text("".join(
            f"{2 * int(lab) - 1} " + " ".join(f"{i}:{v:.4f}" for i, v in r)
            + "\n" for r, lab in zip(rows, y)))
        return [f"-train_file={path}", "-epoch=2", "-minibatch_size=32",
                "-capacity=1024", "-max_features=8"]
    return ["-input_dimension=6", "-output_dimension=3",
            "-minibatch_size=64", "-train_epoch=2"]


@pytest.mark.parametrize("app", ["logreg", "word_embedding",
                                 "sparse_logreg", "lightlda"])
def test_cli_takes_the_run_flags(tmp_path, app):
    import importlib
    main = importlib.import_module(
        f"multiverso_tpu_torch.apps.{app}").main
    argv = _cli_inputs(tmp_path, app) + ["-device=cpu"]
    run = tmp_path / "run"
    _run_main(main, argv + [f"-run_dir={run}", "-ckpt_every=1"])
    gens = tckpt.RunCheckpointManager(str(run)).scan()
    assert gens and all(g.manifest["fingerprint"] for g in gens)
    before = _counter("ft.recover.ops")
    _run_main(main, argv + [f"-run_dir={run}", "-ckpt_every=1",
                            "-resume=true"])
    assert _counter("ft.recover.ops") == before + 1
