"""The port's fleet metrics aggregation (``telemetry/aggregate.py``) and
its host collectives (``parallel/multihost.py``) against the JAX
package's.

- ``merge_snapshots`` equals the reference's on the same snapshots
  (written by the port's registry, and each package's own), both errors
  included: a wrong ``kind`` and histogram bounds that differ.
- A single process dispatches no collective: ``allgather_i64`` gives
  ``[1, n]``, ``allgather_bytes`` ``[payload]``, ``validate_single_owner``
  wants every lane, ``gather_metrics`` the local snapshot; the
  ``multihost.allgather`` chaos point fires as the reference's does.
- The world size is read through ``sys.modules`` (a fake
  ``torch.distributed`` in its place), never imported.
- A 2-rank gloo run (two subprocesses over a ``FileStore``):
  ``allgather_i64`` of values past 2^31 and negative ones,
  ``allgather_bytes`` of unequal payloads (one empty),
  ``validate_single_owner`` with a lane owned twice and a lane owned by
  none, and ``gather_metrics`` whose merge equals the reference's merge
  of the two ranks' snapshots.
"""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from multiverso_tpu.telemetry import aggregate as jaggregate
from multiverso_tpu.telemetry import metrics as jmetrics
from multiverso_tpu_torch.ft import chaos as tchaos
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.telemetry import aggregate as taggregate
from multiverso_tpu_torch.telemetry import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 2-rank run's wall: two interpreters importing torch, one gather
GLOO_TIMEOUT_S = 180


@pytest.fixture(autouse=True)
def _fresh():
    tmetrics.registry().reset()
    jmetrics.registry().reset()
    tchaos.uninstall_chaos()
    yield
    tmetrics.registry().reset()
    jmetrics.registry().reset()
    tchaos.uninstall_chaos()


def _port_snapshot(seed: int) -> dict:
    """A registry snapshot written by the port: counters with labels,
    gauges, and histograms on the latency bounds and on bounds of its
    own."""
    rng = np.random.default_rng(seed)
    reg = tmetrics.MetricRegistry()
    for i in range(3):
        reg.counter("wire.requests", op=f"op{i}").inc(float(rng.integers(9)))
    reg.counter(f"only.host{seed}").inc(seed + 0.5)
    reg.gauge("server.queue.depth", server="s").set(float(rng.integers(5)))
    reg.gauge(f"g.host{seed}").set(-float(seed))
    h = reg.histogram("table.add.seconds", tmetrics.LATENCY_BUCKETS)
    for v in rng.lognormal(-6, 2, 50):
        h.observe(float(v))
    own = reg.histogram("batch.rows", [1.0, 10.0, 100.0])
    for v in rng.integers(0, 200, 20):
        own.observe(float(v))
    return reg.snapshot()


@pytest.mark.parametrize("hosts", [1, 2, 3, 5])
def test_merge_equals_reference(hosts):
    snaps = [_port_snapshot(s) for s in range(hosts)]
    got = taggregate.merge_snapshots(snaps)
    assert json.dumps(got, sort_keys=True) \
        == json.dumps(jaggregate.merge_snapshots(snaps), sort_keys=True)
    assert got["hosts"] == hosts
    assert got["counters"]["wire.requests{op=op0}"] == sum(
        s["counters"]["wire.requests{op=op0}"] for s in snaps)
    assert got["gauges"]["server.queue.depth{server=s}"] == max(
        s["gauges"]["server.queue.depth{server=s}"] for s in snaps)


def test_merge_of_both_packages_snapshots():
    """A port snapshot and a reference snapshot merge the same in either
    package (one kind, one layout)."""
    jreg = jmetrics.registry()
    jreg.counter("wire.requests", op="op0").inc(4)
    jreg.histogram("table.add.seconds",
                   jmetrics.LATENCY_BUCKETS).observe(0.002)
    snaps = [_port_snapshot(0), jmetrics.snapshot()]
    assert taggregate.merge_snapshots(snaps) \
        == jaggregate.merge_snapshots(snaps)


@pytest.mark.parametrize("fault", ["kind", "bounds"])
def test_merge_errors_equal_reference(fault):
    a, b = _port_snapshot(0), _port_snapshot(1)
    if fault == "kind":
        b = dict(b, kind="mvtpu.series.v1")
    else:
        b["histograms"]["batch.rows"]["bounds"] = [1.0, 10.0, 50.0]
    with pytest.raises(ValueError) as want:
        jaggregate.merge_snapshots([a, b])
    with pytest.raises(ValueError) as got:
        taggregate.merge_snapshots([a, b])
    assert str(got.value) == str(want.value)


def test_single_process_dispatches_nothing():
    assert multihost.process_count() == 1
    v = [1 << 40, -3, 0]
    got = multihost.allgather_i64(v)
    assert got.dtype == np.int64 and got.tolist() == [v]
    assert multihost.allgather_i64(7).tolist() == [[7]]
    assert multihost.allgather_bytes(b"abc") == [b"abc"]
    multihost.validate_single_owner(np.ones(5, np.int32), "lanes")
    with pytest.raises(ValueError, match="single process must own"):
        multihost.validate_single_owner(np.array([1, 0, 1]), "lanes")
    tmetrics.counter("agg.local").inc(2)
    (snap,) = taggregate.gather_metrics()
    assert snap["counters"]["agg.local"] == 2
    fleet = taggregate.fleet_snapshot()
    assert fleet["hosts"] == 1 and fleet["counters"]["agg.local"] == 2


def test_allgather_chaos_point():
    """``multihost.allgather`` is a fault point, as in the reference."""
    inj = tchaos.install_chaos("multihost.allgather:error:times=1")
    with pytest.raises(tchaos.ChaosError):
        multihost.allgather_i64([1])
    assert multihost.allgather_i64([1]).tolist() == [[1]]
    assert inj.counts() == {"multihost.allgather:error": 1}


def test_world_size_read_through_sys_modules(monkeypatch):
    """The world size comes from whatever ``torch.distributed`` is
    already loaded: a fake one in ``sys.modules`` answers 3, a group
    that is not initialised 1."""
    state = {"up": True}
    dist = types.SimpleNamespace(
        is_available=lambda: True, is_initialized=lambda: state["up"],
        get_world_size=lambda: 3)
    monkeypatch.setitem(sys.modules, "torch",
                        types.SimpleNamespace(distributed=dist))
    assert taggregate._process_count() == 3
    state["up"] = False
    assert taggregate._process_count() == 1


_CHILD = r"""
import json, sys
import numpy as np
import torch.distributed as dist
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
from multiverso_tpu_torch.parallel import multihost
from multiverso_tpu_torch.telemetry import aggregate, metrics
res = {"world": multihost.process_count(),
       "host": metrics.host_index()}
vals = [(1 << 33) + rank, -(1 << 35) - rank, -1, (1 << 62) + 7 * rank]
res["i64"] = multihost.allgather_i64(vals).tolist()
payload = b"" if rank == 1 else bytes(range(200)) * 3
res["bytes"] = [p.hex() for p in multihost.allgather_bytes(payload)]
errors = []
for mask in ([1, 0, 1, 0], [1, 1, 0, 0], [1, 0, 0, 1]):
    mine = np.array(mask if rank == 0 else [1 - m for m in mask])
    if rank == 1 and mask == [1, 1, 0, 0]:
        mine = np.array([1, 0, 0, 1])      # lane 0 twice, lane 2 none
    try:
        multihost.validate_single_owner(mine, "lanes")
        errors.append(None)
    except ValueError as e:
        errors.append(str(e))
res["owner_errors"] = errors
reg = metrics.registry()
reg.counter("wire.requests", op="kv_add").inc(10 + rank)
reg.counter(f"only.rank{rank}").inc(1)
reg.gauge("server.queue.depth").set(5 - 3 * rank)
h = reg.histogram("table.add.seconds", metrics.LATENCY_BUCKETS)
for v in (0.001 * (rank + 1), 0.5, 3.0 + rank):
    h.observe(v)
res["local"] = metrics.snapshot()
res["gathered"] = aggregate.gather_metrics()
res["fleet"] = aggregate.fleet_snapshot()
with open(out, "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
"""


def test_two_rank_gloo_run(tmp_path):
    world = 2
    store = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("MVTPU_HOST_ID", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(r), str(world), store,
         str(tmp_path / f"r{r}.json")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=GLOO_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = [json.loads((tmp_path / f"r{r}.json").read_text())
           for r in range(world)]
    want_i64 = [[(1 << 33) + r, -(1 << 35) - r, -1, (1 << 62) + 7 * r]
                for r in range(world)]
    # the reference ships each value as two int32 halves and joins them
    # back; its contract is that join, which the whole int64 matches
    v = np.array(want_i64, np.int64)
    hi = (v >> np.int64(32)).astype(np.int32)
    lo = (v & np.int64(0xFFFFFFFF)).astype(np.int32)
    joined = (hi.astype(np.int64) << np.int64(32)) \
        | (lo.astype(np.int64) & np.int64(0xFFFFFFFF))
    assert joined.tolist() == want_i64
    want_bytes = [(bytes(range(200)) * 3).hex(), ""]
    for r, got in enumerate(res):
        assert got["world"] == world and got["host"] == r
        assert got["i64"] == want_i64
        assert got["bytes"] == want_bytes
        assert got["owner_errors"][0] is None
        assert "lanes requires every data lane" in got["owner_errors"][1]
        assert "[0, 1, 2]" in got["owner_errors"][1]
        assert got["owner_errors"][2] is None
        assert [s["host"] for s in got["gathered"]] == [0, 1]
    locals_ = [r["local"] for r in res]
    assert [s["counters"] for s in res[0]["gathered"]] \
        == [s["counters"] for s in locals_]
    want = jaggregate.merge_snapshots(locals_)
    for got in res:
        assert got["fleet"] == want
    assert want["counters"]["wire.requests{op=kv_add}"] == 21
    assert want["gauges"]["server.queue.depth"] == 5
    assert want["histograms"]["table.add.seconds"]["count"] == 6
