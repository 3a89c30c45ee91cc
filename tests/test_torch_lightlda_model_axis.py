"""LightLDA with its word-topic table split across processes, on the CPU.

Process ``p`` of P owns the cells of the global ``[data, model]`` grid
whose row-major position lies in ``[p * L, (p + 1) * L)`` (the layouts of
``tests/test_torch_model_axis_processes.py``):

- (1, 2) over P = 2: each process one shard of the one data row;
- (1, 4) over P = 2: two shards a process;
- (2, 2) over P = 4: each row over two processes;
- (2, 3) over P = 3: process 1 owns ``[0, 2]`` and ``[1, 0]``, a cell of
  each row (processes hold unequal numbers of rows).

One spawn a layout runs all six modes in each child (gibbs, mh, tiled
exact, tiled stale, doc-blocked, doc-blocked streamed; two sweeps each,
the app's own draws, which every rank draws alike), and one more child
runs them in ONE process on the same global mesh. Every rank's z, word
table (the whole, and each shard it holds), summary, doc counts and
loglik history equal the one-process run's bit for bit, and each rank
allocates only its own cells' shards. The traffic counters
(``multihost.TRAFFIC``) bound each sweep's bytes:

- the stale modes move the whole bf16 mirror's foreign shards once, at
  the sweep's start, and in each step no more than a few lanes' worth
  (the summary row a call, topics and deltas between replicas);
- the exact modes move at most a step's distinct word rows (``U``, the
  largest over the data rows, times the most rows a process holds: the
  superstep's merge round sends every local replica's partial) a step,
  never ``[B, C]`` partials;
- mh moves no row: its lanes' topics, 4 bytes a lane a merge.

On (1, 2) the child also stores and loads the app, runs the CLI under
``-machine_file`` (a gloo group over ``tcp://127.0.0.1``), resumes it
from its run directory, and checks that ``local_corpus`` on the shared
row raises the reference's ``validate_single_owner`` error.

The one-process (1, 2) and (1, 4) runs of gibbs and mh are held against
the JAX package's data-parallel (2, 1) run, one sweep at a time from one
state (ROADMAP.md queue C's LightLDA rule), as
``tests/test_torch_lightlda_mesh.py`` holds (2, 1).

Run the child by hand: ``python tests/test_torch_lightlda_model_axis.py
<P> <rank or -1> <store> <out.npz> <layout> <docs file> <port>``.
"""

from __future__ import annotations

import os
import socket
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_multihost import _spawn  # noqa: E402

#: layout -> (data, model, processes)
LAYOUTS = {"1x2": (1, 2, 2), "1x4": (1, 4, 2), "2x2": (2, 2, 4),
           "2x3": (2, 3, 3)}
#: seconds one spawn (all its processes) may take
SPAWN_TIMEOUT_S = 240
K = 128
MODES = {
    "gibbs": dict(batch_tokens=512, steps_per_call=2),
    "mh": dict(batch_tokens=512, steps_per_call=2, sampler="mh"),
    "tiled": dict(batch_tokens=512, steps_per_call=2, sampler="tiled"),
    "tiled_stale": dict(batch_tokens=512, steps_per_call=2, sampler="tiled",
                        stale_words=True),
    "doc_blocked": dict(batch_tokens=1024, steps_per_call=2,
                        sampler="tiled", doc_blocked=True, block_tokens=256,
                        block_docs=8),
    "streamed": dict(batch_tokens=1024, steps_per_call=2, sampler="tiled",
                     doc_blocked=True, block_tokens=256, block_docs=8,
                     stream_blocks=True),
}
STALE = ("tiled_stale", "doc_blocked", "streamed")
EXACT = ("gibbs", "tiled")
SWEEPS = 2


def _lane_bytes(B: int) -> int:
    """A step's bound on the lane exchanges and merges that carry no word
    row (topics, deltas, the summary, headers), in bytes from each other
    process."""
    return 12 * B + 4 * K + 4096


def _docs(path: str) -> None:
    from multiverso_tpu_torch.data import synthetic_docs
    synthetic_docs(path, num_docs=120, vocab_size=300, avg_doc_len=30,
                   num_topics=8, seed=0)


# -- the child ----------------------------------------------------------------


def _held(table) -> list:
    """``(data row, shard)`` of every shard tensor the table allocated."""
    return sorted((table.replica_ids[r], s)
                  for r, shards in enumerate(table.replicas)
                  for s, x in enumerate(shards) if x is not None)


def _distinct_rows(app) -> list:
    """Each step's largest count of distinct word rows over the data
    rows' lanes (the exact modes' shuffled stream)."""
    c = app.config
    tw = app._consts[0]["tw"].numpy()
    B, D = c.batch_tokens, app.n_replicas
    b = B // D
    return [max(len(np.unique(tw[lo + d * b:lo + (d + 1) * b]))
                for d in range(D))
            for lo in range(0, len(tw), B)]


def _mode(tl, multihost, mode: str, docs, res: dict) -> None:
    """``mode`` trained SWEEPS sweeps on the runtime mesh: its state,
    what it allocated and each sweep's traffic into ``res``."""
    import torch
    tw, td, V = docs
    app = tl.LightLDA(tw, td, V, tl.LDAConfig(num_topics=K, seed=1,
                                              **MODES[mode]),
                      name=f"lda_{mode}")
    sweep, moved = app.sweep, []

    def counted(*args, **kwargs):
        multihost.reset_traffic()
        sweep(*args, **kwargs)
        moved.append(multihost.TRAFFIC["bytes"])

    app.sweep = counted
    app.train(num_iterations=SWEEPS)
    wt = app.word_topic
    res[f"{mode}_z"] = app._z_numpy()
    res[f"{mode}_wt"] = app.word_topics()
    res[f"{mode}_dt"] = app.doc_topics()
    res[f"{mode}_nk"] = app.summary.get()
    res[f"{mode}_ll"] = np.array(app.ll_history, np.float64)
    for r, shards in enumerate(wt.replicas):
        for s, x in enumerate(shards):
            if x is not None:
                res[f"{mode}_shard_{wt.replica_ids[r]}_{s}"] = \
                    x.contiguous().view(torch.int32).numpy()
    res[f"{mode}_padded"] = wt._whole().view(torch.int32).numpy()
    res[f"{mode}_moved"] = np.array(moved, np.int64)
    if mode in STALE:
        # the mirror's posts: each process's row-0 cells' bf16 shards,
        # the all-gather padded to the most any process sends
        mesh = app.mesh
        posts = max(sum(mesh.owner(0, s) == p
                        for s in range(mesh.shape["model"]))
                    for p in range(mesh.processes))
        res[f"{mode}_mirror"] = np.array(
            [(mesh.processes - 1) * posts * wt._rows_per_shard * K * 2],
            np.int64)
    res[f"{mode}_steps"] = np.array(
        [app.calls_per_sweep * app.config.steps_per_call], np.int64)
    if mode in EXACT:
        mesh = app.mesh
        res[f"{mode}_rows"] = np.array(_distinct_rows(app), np.int64)
        # a merge round sends each process's every local partial
        res[f"{mode}_posts"] = np.array([max(
            len(mesh.rows_of(p)) for p in range(mesh.processes))])
    res[f"own_{mode}"] = np.array(
        _held(wt) + _held(app.summary), np.int64).reshape(-1, 2)


def _checkpoints(tl, docs, prefix: str, res: dict) -> None:
    """(1, 2) only: the doc-blocked app stored after a sweep and loaded
    into a fresh one, which then sweeps as the stored one does."""
    tw, td, V = docs
    cfg = tl.LDAConfig(num_topics=K, seed=1, **MODES["doc_blocked"])
    a = tl.LightLDA(tw, td, V, cfg, name="ck_a")
    a.train(num_iterations=1)
    a.store(prefix)
    b = tl.LightLDA(tw, td, V, cfg, name="ck_b")
    b.load(prefix)
    np.testing.assert_array_equal(b._z_numpy(), a._z_numpy())
    np.testing.assert_array_equal(b.word_topics(), a.word_topics())
    assert b._calls_done == a._calls_done
    for app in (a, b):
        app.train(num_iterations=1)
    np.testing.assert_array_equal(b._z_numpy(), a._z_numpy())
    np.testing.assert_array_equal(b.word_topics(), a.word_topics())
    res["ck_z"] = b._z_numpy()
    res["ck_ll"] = np.array(b.ll_history, np.float64)


def _cli(tl, core, configure, path: str, out: str, extra: list,
         res: dict) -> None:
    """The CLI on the doc-blocked mode: 3 sweeps into a run directory (a
    generation a sweep); then, its last generation removed as if the run
    had died after sweep 2, the same command resumed. Both runs' output
    files into ``res``, which must agree."""
    import shutil
    base = [f"-input_file={path}", f"-num_topics={K}", "-sampler=tiled",
            "-doc_blocked=true", "-batch_tokens=1024", "-steps_per_call=2",
            "-block_tokens=256", "-block_docs=8", "-device=cpu",
            "-data_parallel=1", "-model_parallel=2", "-seed=1",
            "-num_iterations=3", f"-run_dir={out}.run",
            f"-output_file={out}.cli", f"-dump_file={out}.dump", *extra]
    for run, more in (("cli", []), ("resumed", ["-resume=true"])):
        try:
            tl.main(base + more)
        finally:
            configure.reset_flags()
        for part in ("state", "word_topic", "summary"):
            with np.load(f"{out}.cli.{part}.npz") as f:
                for k in f.files:
                    if k != "manifest":
                        res[f"{run}_{part}_{k}"] = f[k]
        with open(f"{out}.dump", "rb") as f:
            res[f"{run}_dump"] = np.frombuffer(f.read(), np.uint8)
        if run == "cli":
            core.barrier()
            if core.rank() == 0:
                shutil.rmtree(f"{out}.run/gen-0000000003")
            core.barrier()
    for k in [k for k in res if k.startswith("cli_")]:
        np.testing.assert_array_equal(res[k.replace("cli_", "resumed_")],
                                      res[k], err_msg=k)


def child(P: int, rank: int, store: str, out: str, layout: str,
          path: str, port: str) -> None:
    """Every mode of ``layout`` at P processes (``rank`` >= 0, over the
    group) or in one process on the same global mesh (``rank`` -1)."""
    import torch

    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps import lightlda as tl
    from multiverso_tpu_torch.parallel import multihost
    from multiverso_tpu_torch.tables import reset_tables
    from multiverso_tpu_torch.utils import configure

    torch.manual_seed(0)
    D, M, _ = LAYOUTS[layout]
    L = D * M // P
    multi = rank >= 0
    res: dict = {}
    if layout == "1x2":
        # the CLI first: under -machine_file it makes the process group,
        # which the runtime's init below keeps
        extra = [f"-machine_file=127.0.0.1:{port}", f"-num_processes={P}",
                 f"-process_id={rank}"] if multi else []
        _cli(tl, core, configure, path, store if multi else out, extra,
             res)
        if multi:
            assert core.mesh().rows_split
        else:
            core.shutdown()
    if multi:
        mesh = core.init([f"-num_processes={P}", f"-process_id={rank}",
                          f"-data_parallel={D}", f"-model_parallel={M}"],
                         devices=["cpu"] * L,
                         store=torch.distributed.FileStore(store, P))
        assert mesh.rows_split and mesh.cells == [
            divmod(i, M) for i in range(rank * L, (rank + 1) * L)]
    else:
        mesh = core.init(devices=["cpu"] * (D * M), data_parallel=D,
                         model_parallel=M)
    docs = tl.load_docs(path)
    for mode in MODES:
        _mode(tl, multihost, mode, docs, res)
        reset_tables()
    if layout == "1x2":
        _checkpoints(tl, docs, f"{store if multi else out}.ck", res)
        reset_tables()
    if multi:
        # local_corpus needs each data lane owned by one process: a row
        # two processes share raises, in the reference's words
        tw, td, V = docs
        with pytest.raises(ValueError, match="exactly one process"):
            tl.LightLDA(tw, td, V, tl.LDAConfig(
                num_topics=K, seed=1, local_corpus=True,
                **MODES["streamed"]), name="lda_local")
        reset_tables()
        for mode in MODES:
            assert [tuple(c) for c in res[f"own_{mode}"]] == \
                sorted(mesh.cells) * 2, mode
        # every process's results, the same bits on each
        digest = b"".join(np.ascontiguousarray(v).tobytes()
                          for k, v in sorted(res.items())
                          if not k.startswith("own_") and "_shard_" not in k)
        assert len(set(multihost.allgather_bytes(digest))) == 1
    np.savez(out, **res)
    core.shutdown()
    print(f"MULTIHOST_OK rank={rank}", flush=True)


# -- the parent ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def docs_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lda_ma") / "docs.txt")
    _docs(path)
    return path


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_p_processes_equal_one_process(layout, docs_file, tmp_path):
    """Every rank equals the one-process run on the same global mesh bit
    for bit in every mode, holds its own cells' shards only (asserted in
    the child), and each sweep's traffic stays within the mode's design
    (module doc)."""
    D, M, P = LAYOUTS[layout]
    args = dict(script=__file__, args=(layout, docs_file,
                                       str(_free_port())),
                tag=layout, timeout=SPAWN_TIMEOUT_S)
    runs = _spawn(P, list(range(P)), tmp_path, **args)
    (one,) = _spawn(P, [-1], tmp_path, **args)
    for r, got in enumerate(runs):
        for key, want in one.items():
            if key.startswith("own_") or key.endswith(
                    ("_moved", "_mirror", "_posts")) or "_shard_" in key:
                continue
            np.testing.assert_array_equal(got[key], want,
                                          err_msg=f"rank {r}: {key}")
        for mode in MODES:
            # the shards it holds are the one-process table's rows
            padded = one[f"{mode}_padded"]
            rps = padded.shape[0] // M
            shards = [k for k in got if k.startswith(f"{mode}_shard_")]
            assert len(shards) == D * M // P, (mode, shards)
            for k in shards:
                s = int(k.rsplit("_", 1)[1])
                np.testing.assert_array_equal(
                    got[k], padded[s * rps:(s + 1) * rps], err_msg=k)
            _check_traffic(got, mode, P, MODES[mode]["batch_tokens"])
    if layout == "1x2":
        assert any(k.startswith("resumed_state") for k in one)
        assert any(k.startswith("ck_") for k in one)


def _check_traffic(got: dict, mode: str, P: int, B: int) -> None:
    """Each sweep's bytes from the other processes, against the mode's
    design (module doc)."""
    moved, steps = got[f"{mode}_moved"], int(got[f"{mode}_steps"][0])
    assert len(moved) == SWEEPS
    lanes = steps * (P - 1) * _lane_bytes(B)
    for b in moved:
        if mode in STALE:
            mirror = int(got[f"{mode}_mirror"][0])
            # the mirror's foreign shards once; no step moves a row
            assert mirror <= b <= mirror + lanes, (mode, b, mirror, lanes)
            assert b - mirror < B * K * 2, (mode, b, mirror)
        elif mode in EXACT:
            rows = got[f"{mode}_rows"]
            assert len(rows) == steps
            cap = int(rows.sum()) * int(got[f"{mode}_posts"][0]) \
                * (P - 1) * K * 4
            assert b <= cap + lanes, (mode, b, cap)
            assert b < steps * (P - 1) * B * K * 4
        else:
            # mh: lane results only
            assert b <= lanes, (mode, b, lanes)


# -- the one-process port against the JAX package -----------------------------


@pytest.fixture()
def jmesh21(devices):
    from multiverso_tpu import core as jcore
    from multiverso_tpu.tables import base as jbase
    m = jcore.init(devices=devices[:2], data_parallel=2, model_parallel=1)
    yield m
    jcore.shutdown()
    jbase.reset_tables()


@pytest.mark.parametrize("mode", ["gibbs", "mh"])
@pytest.mark.parametrize("model", [2, 4])
def test_split_rows_match_reference(docs_file, jmesh21, mode, model):
    """The port's one-process (1, 2) and (1, 4) runs against the JAX
    package's (2, 1) run, one sweep at a time from one state: z agrees on
    at least 99% of tokens, the loglik within rtol 1e-3, the counts are
    those of the port's z."""
    from multiverso_tpu.apps import lightlda as jl
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.apps import lightlda as tl
    from multiverso_tpu_torch.tables import base as tbase
    from test_torch_lightlda import reference_uniforms
    from test_torch_lightlda_mh import (_assert_counts_of_own_z,
                                        _compare_sweeps)
    tw, td, V = tl.load_docs(docs_file)
    cfg = dict(num_topics=K, seed=1, **MODES[mode])
    try:
        japp = jl.LightLDA(tw, td, V, jl.LDAConfig(**cfg), mesh=jmesh21,
                           name="j")
        tapp = tl.LightLDA(tw, td, V, tl.LDAConfig(**cfg),
                           mesh=core.Mesh([["cpu"] * model]), name="t")
        np.testing.assert_array_equal(tapp._z_numpy(),
                                      np.asarray(japp._z).reshape(-1))
        np.testing.assert_array_equal(tapp.word_topics(),
                                      japp.word_topics())
        if mode == "mh":
            _compare_sweeps(japp, tapp, tw, td, sweeps=2)
            return
        uniforms = reference_uniforms(japp)
        for sweep in range(2):
            japp.train(num_iterations=1)
            tapp.train(num_iterations=1, uniforms=uniforms)
            jz = np.asarray(japp._z).reshape(-1)
            assert float(np.mean(tapp._z_numpy() == jz)) >= 0.99
            _assert_counts_of_own_z(tapp, tw, td)
            np.testing.assert_allclose(tapp.ll_history[-1],
                                       japp.ll_history[-1], rtol=1e-3)
            tapp.load_numpy({"z": jz, "ndk": japp.doc_topics(),
                             "word_topic": japp.word_topics(),
                             "summary": np.asarray(japp.summary.get())})
    finally:
        tbase.reset_tables()


if __name__ == "__main__":
    child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
          sys.argv[5], sys.argv[6], sys.argv[7])
