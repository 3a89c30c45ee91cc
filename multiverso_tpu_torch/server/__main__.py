"""``python -m multiverso_tpu_torch.server``: run one table-server
process — or launch a sharded fleet of N of them.

Counterpart of ``multiverso_tpu/server/__main__.py``, with the same
flags, fleet file and admin protocol, plus ``--device``: init the
runtime on ``--device`` (chaos from the environment), serve the wire
address until SIGTERM/SIGINT, then drain. With ``--fleet N`` this
process becomes a LAUNCHER instead: it spawns N member processes
(``python -m multiverso_tpu_torch.server``, each on ``--device``; rank r
listens on rank-derived addresses, owns partition r of every table per
``server/partition.py``), waits for every member's ready file, then
writes one fleet file naming the whole fleet — addresses, pids, and the
authoritative partition map — which ``client/router.py``'s
``connect_fleet_file`` consumes (either package's router reads it).
Every member serves statusz: the launcher (and ``--grow``) sets
``MVTPU_STATUSZ_PORT=0`` for the members unless the caller set it, a
member appends ``,statusz:<port>`` to its ready file, and the fleet file
names each member's ``statusz_port`` — what ``report --fleet``,
``FleetController`` and ``/statusz?fleet=1`` scrape.

Flags:

``--address unix:/path | tcp:host:port | shm:///path [, ...]``
    wire address(es) to listen on, comma-separated (default
    ``unix:/tmp/mvtpu.sock``; ``tcp:host:0`` picks an ephemeral port —
    see ``--ready-file``; ``shm://`` serves the shared-memory ring
    transport, falling back to socket frames per connection for
    clients that dial it as plain unix).
``--device DEV``
    where the tables live (default ``cuda:0``; ``cpu`` for the CPU).
    There is no fallback: without the card a member fails to start.
    The launcher and ``--grow`` pass it to every member they spawn.
``--name NAME``
    server name for logs/telemetry (default ``tables``).
``--fuse K``
    drain + fuse up to K queued frames per dispatch cycle (default:
    ``MVTPU_SERVER_FUSE`` env, else 1 = off).
``--qos SPEC``
    admission QoS classes (default: ``MVTPU_SERVER_QOS`` env, else
    none — every client in one unlimited class). See
    ``server/admission.py`` for the grammar.
``--queue N``
    bound on admitted-but-undispatched frames; excess load is shed
    with a retry-after reply (default: ``MVTPU_SERVER_QUEUE`` env,
    else 0 = unbounded).
``--ready-file PATH``
    after binding, atomically write the RESOLVED dialable address list
    here (comma-separated, same order as ``--address``): how a launcher
    waits for the bind, and how an ephemeral tcp port gets back to the
    workers; ``,statusz:<port>`` follows when statusz is armed
    (``MVTPU_STATUSZ_PORT``). Under ``--fleet`` the launcher's ready
    file is the fleet file itself (JSON, ``mvtpu.fleet.v1``).

Fleet flags:

``--fleet N``
    launcher mode: spawn N member processes. Rank r's addresses derive
    from ``--address`` (unix/shm paths gain a ``.r`` suffix; an
    explicit tcp port becomes port+r, an ephemeral ``:0`` stays
    ephemeral). Members get statusz armed (ephemeral) unless
    ``MVTPU_STATUSZ_PORT`` is already set. SIGTERM/SIGINT forward to
    every member; one member dying does NOT take the rest down (a
    partition outage is partial by design — the launcher keeps the
    survivors).
``--fleet-file PATH``
    where the fleet file lands (default: ``--ready-file``, else
    ``<first unix/shm path>.fleet.json``).
``--fleet-version V``
    partition-map version claimed by every member (default 1).
``--kv-buckets B``
    logical KV bucket space (default 8192, rounded up to a multiple
    of N).
``--fleet-rank R`` / ``--fleet-n N``
    internal: member mode (set by the launcher).
``--replicas R``
    replication factor per rank (default 1 = no followers). R-1
    FOLLOWER processes spawn next to each rank's primary (unix/shm
    paths gain a ``fJ`` suffix; explicit tcp ports offset by ``n*J``),
    listed under the member's ``replicas`` row in the fleet file. The
    primary streams applied deltas to them (``server/replication.py``)
    and the router load-balances bounded-staleness reads across the
    replica set, promoting a follower if the primary dies.
``--replica-of RANK`` / ``--replica-idx J``
    internal: follower member mode (set by the launcher).
``--replicate-to ADDR[,ADDR...]``
    internal: static follower address override for this member's
    replication tap (set by ``--grow`` for the joining member, whose
    followers are not in the fleet file until the reshard commits).

Admin ops (run against a LIVE fleet, addressed by ``--fleet-file``):

``--grow``
    online reshard v→v+1 with N+1 members: spawn the joining member
    (rank N; addresses derive from ``--address`` exactly like the
    launcher, so pass the same base, and ``--device``), drive
    ``migrate_begin`` on every existing member, poll until every donor
    has streamed its moved ranges, commit donors-first, rewrite the
    fleet file atomically, and print a one-line JSON summary. On any
    failure or timeout (``MVTPU_RESHARD_TIMEOUT_S``, default 120) the
    abort wave rolls every member back to v — the fleet keeps serving
    throughout.
``--shrink``
    the reverse: evict rank N-1 (its ranges stream to the survivors),
    commit, rewrite the fleet file with N-1 members, linger
    ``MVTPU_SHRINK_LINGER_S`` (default 2s) so stale clients get their
    writes relayed + a remap hint, then shut the evicted member down.

A member logs its KV and table kernel launches when it stops
(``kernel launches {...}``).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time


def _rank_address(addr: str, rank: int) -> str:
    """Rank-derive one listen address (see module docstring)."""
    addr = addr.strip()
    if addr.startswith("tcp:"):
        host, _, port = addr[4:].rpartition(":")
        p = int(port or 0)
        return f"tcp:{host}:{p + rank if p else 0}"
    return f"{addr}.{rank}"


def _replica_address(addr: str, rank: int, n: int, idx: int) -> str:
    """Follower idx (1-based) of rank's listen address: path suffix
    ``.RfJ``; explicit tcp ports offset by ``n*J`` past the primary
    block so primaries and followers never collide."""
    addr = addr.strip()
    if addr.startswith("tcp:"):
        host, _, port = addr[4:].rpartition(":")
        p = int(port or 0)
        return f"tcp:{host}:{p + rank + n * idx if p else 0}"
    return f"{addr}.{rank}f{idx}"


def _write_ready(path: str, content: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, path)


def _member_main(args, server_cls, partition) -> int:
    """One fleet member (or a plain standalone server when no
    partition flags are set)."""
    from multiverso_tpu_torch import core
    from multiverso_tpu_torch.ops import table_kernels as tk
    from multiverso_tpu_torch.utils import log

    member = None
    if args.fleet_n:
        pmap = partition.PartitionMap(args.fleet_n,
                                      version=args.fleet_version,
                                      kv_buckets=args.kv_buckets,
                                      replicas=args.replicas or 1)
        member = partition.PartitionMember(pmap, args.fleet_rank)
    core.init(device=args.device)
    follower = args.replica_idx is not None
    replicate_to = [a.strip() for a
                    in str(args.replicate_to or "").split(",")
                    if a.strip()] or None
    server = server_cls(args.address, name=args.name, fuse=args.fuse,
                        qos=args.qos, queue_bound=args.queue,
                        partition=member, fleet_file=args.fleet_file,
                        follower=follower,
                        replica_idx=args.replica_idx,
                        replicate_to=replicate_to, device=args.device)
    bound = server.start()
    if args.ready_file:
        ready = bound
        from multiverso_tpu_torch.telemetry import statusz
        http = statusz.server()
        if http is not None:
            # the launcher lifts this into the fleet file; ?fleet=1
            # scrapes peers through it
            ready += f",statusz:{http.port}"
        _write_ready(args.ready_file, ready)

    def _stop(signum, frame):
        server.stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        server.serve_forever()
    finally:
        server.stop()
        log.info("table server %r: kernel launches %s", args.name,
                 json.dumps({k: v for k, v in tk.LAUNCHES.items() if v}))
        core.shutdown()
    return 0


def _fleet_main(args, partition) -> int:
    """Launcher: N member processes + one fleet file."""
    n = int(args.fleet)
    r = max(int(args.replicas or 1), 1)
    pmap = partition.PartitionMap(n, version=args.fleet_version,
                                  kv_buckets=args.kv_buckets,
                                  replicas=r)
    addresses = [a.strip() for a in str(args.address).split(",")
                 if a.strip()]
    fleet_file = args.fleet_file or args.ready_file
    if not fleet_file:
        stem = next((a.split(":", 1)[1].lstrip("/") for a in addresses
                     if a.startswith(("unix:", "shm:"))), None)
        fleet_file = ("/" + stem if stem else "/tmp/mvtpu") \
            + ".fleet.json"

    env = dict(os.environ)
    env.setdefault("MVTPU_STATUSZ_PORT", "0")
    # one spec per process: rank's primary (idx None) then its
    # followers (idx 1..R-1), all partition-member rank — a follower
    # sizes its shard exactly like its primary
    specs = []
    for rank in range(n):
        specs.append((rank, None,
                      [_rank_address(a, rank) for a in addresses]))
        for idx in range(1, r):
            specs.append((rank, idx,
                          [_replica_address(a, rank, n, idx)
                           for a in addresses]))
    procs, ready_files = [], []
    for rank, idx, addrs in specs:
        tag = f"r{rank}" if idx is None else f"r{rank}f{idx}"
        ready = f"{fleet_file}.{tag}.ready"
        try:
            os.unlink(ready)
        except OSError:
            pass
        ready_files.append(ready)
        name = f"{args.name}-{rank}" if idx is None \
            else f"{args.name}-{rank}f{idx}"
        cmd = [sys.executable, "-m", "multiverso_tpu_torch.server",
               "--address", ",".join(addrs),
               "--device", args.device,
               "--name", name,
               "--ready-file", ready,
               "--fleet-rank", str(rank), "--fleet-n", str(n),
               "--fleet-version", str(args.fleet_version),
               "--fleet-file", fleet_file,
               "--replicas", str(r)]
        if idx is not None:
            cmd += ["--replica-of", str(rank),
                    "--replica-idx", str(idx)]
        if args.kv_buckets:
            cmd += ["--kv-buckets", str(args.kv_buckets)]
        if args.fuse is not None:
            cmd += ["--fuse", str(args.fuse)]
        if args.qos is not None:
            cmd += ["--qos", args.qos]
        if args.queue is not None:
            cmd += ["--queue", str(args.queue)]
        procs.append(subprocess.Popen(cmd, env=env))

    def _kill_all(sig=signal.SIGTERM):
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except OSError:
                    pass

    # every process ready — primaries AND followers — before the
    # fleet file exists (clients and the primaries' replication taps
    # both gate on it, so nothing dials a follower that isn't up)
    members = {}
    deadline = time.monotonic() + float(
        os.environ.get("MVTPU_FLEET_STARTUP_S", "") or 60.0)
    for i, (rank, idx, _addrs) in enumerate(specs):
        ready = ready_files[i]
        tag = f"{rank}" if idx is None else f"{rank} follower {idx}"
        while not os.path.exists(ready):
            rc = procs[i].poll()
            if rc is not None:
                print(f"fleet member {tag} exited rc={rc} before "
                      "ready", file=sys.stderr)
                _kill_all()
                return 1
            if time.monotonic() > deadline:
                print(f"fleet member {tag} not ready in time",
                      file=sys.stderr)
                _kill_all()
                return 1
            time.sleep(0.02)
        with open(ready) as f:
            parts = [p for p in f.read().strip().split(",") if p]
        statusz_port = next(
            (int(p.split(":", 1)[1]) for p in parts
             if p.startswith("statusz:")), None)
        row = {"name": f"{args.name}-{rank}" if idx is None
               else f"{args.name}-{rank}f{idx}",
               "addresses": [p for p in parts
                             if not p.startswith("statusz:")],
               "statusz_port": statusz_port, "pid": procs[i].pid}
        if idx is None:
            row["rank"] = rank
            row["replicas"] = []
            members[rank] = row
        else:
            row["idx"] = idx
            members[rank]["replicas"].append(row)
    members = [members[rank] for rank in range(n)]

    partition.write_fleet_file(fleet_file, pmap, members)
    if args.ready_file and args.ready_file != fleet_file:
        with open(fleet_file) as f:
            _write_ready(args.ready_file, f.read())
    print(f"fleet of {n} x{r} up; fleet file {fleet_file}",
          flush=True)

    stopping = []

    def _stop(signum, frame):
        stopping.append(signum)
        _kill_all()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    # a member dying alone is a PARTIAL outage, not fleet shutdown:
    # keep waiting on the rest (the bench SIGKILLs rank 0 and asserts
    # rank 1 still serves through exactly this launcher)
    rcs = [p.wait() for p in procs]
    if stopping:
        return 0
    return 0 if all(rc == 0 for rc in rcs) else 1


def _reshard_summary(ok: bool, **fields) -> int:
    print(json.dumps({"ok": ok, **fields}), flush=True)
    return 0 if ok else 1


def _reshard_main(args, partition, grow: bool) -> int:
    """The admin of one online reshard (``--grow``/``--shrink``):
    begin on every existing member, poll donors to "shipped", commit
    donors-first, rewrite the fleet file. Any failure or timeout turns
    into an abort wave — v keeps serving, bit-exactly."""
    from multiverso_tpu_torch.client import transport as _transport
    from multiverso_tpu_torch.telemetry import trace as _trace

    mode = "grow" if grow else "shrink"
    fleet_file = args.fleet_file or args.ready_file
    if not fleet_file:
        print("--grow/--shrink need --fleet-file", file=sys.stderr)
        return 2
    doc = partition.read_fleet_file(fleet_file)
    if doc is None:
        print(f"no fleet file at {fleet_file}", file=sys.stderr)
        return 2
    old_map = partition.PartitionMap.from_wire(doc["map"])
    n, v = old_map.n, old_map.version
    new_n = n + 1 if grow else n - 1
    if new_n < 1:
        print(f"cannot shrink a fleet of {n}", file=sys.stderr)
        return 2
    r = max(int(old_map.replicas or 1), 1)
    new_map = partition.PartitionMap(
        new_n, version=v + 1, kv_buckets=old_map.kv_buckets,
        replicas=r)
    rows = sorted(doc.get("members", ()),
                  key=lambda m: int(m.get("rank", 0)))
    if len(rows) != n:
        print(f"fleet file lists {len(rows)} members for a map of "
              f"{n}", file=sys.stderr)
        return 2
    plan = f"{mode}-v{v}to{v + 1}-{os.getpid()}-{int(time.time())}"
    t0 = time.monotonic()
    timeout_s = float(
        os.environ.get("MVTPU_RESHARD_TIMEOUT_S", "") or 120.0)

    # -- grow: spawn the joining member (+ its followers) first, so
    # donors have somewhere to stream the moment begin lands
    procs, new_row = [], None
    addresses = [a.strip() for a in str(args.address).split(",")
                 if a.strip()]
    if grow:
        env = dict(os.environ)
        env.setdefault("MVTPU_STATUSZ_PORT", "0")
        fol_addrs = [[_replica_address(a, n, new_n, idx)
                      for a in addresses] for idx in range(1, r)]
        specs = [(None, [_rank_address(a, n) for a in addresses])] \
            + list(zip(range(1, r), fol_addrs))
        ready_files = []
        for idx, addrs in specs:
            tag = f"r{n}" if idx is None else f"r{n}f{idx}"
            ready = f"{fleet_file}.{tag}.ready"
            try:
                os.unlink(ready)
            except OSError:
                pass
            ready_files.append(ready)
            name = f"{args.name}-{n}" if idx is None \
                else f"{args.name}-{n}f{idx}"
            cmd = [sys.executable, "-m", "multiverso_tpu_torch.server",
                   "--address", ",".join(addrs),
                   "--device", args.device,
                   "--name", name, "--ready-file", ready,
                   "--fleet-rank", str(n), "--fleet-n", str(new_n),
                   "--fleet-version", str(v + 1),
                   "--fleet-file", fleet_file,
                   "--replicas", str(r),
                   "--kv-buckets", str(old_map.kv_buckets)]
            if idx is not None:
                cmd += ["--replica-of", str(n),
                        "--replica-idx", str(idx)]
            elif fol_addrs:
                # the fleet file is still at v (no rank-N row), so the
                # joining member's tap would latch "no followers" —
                # hand it its follower addresses explicitly
                cmd += ["--replicate-to",
                        ",".join(a[0] for a in fol_addrs)]
            # the member outlives this admin: detach it from our
            # stdio too, or a pipe-capturing caller of --grow waits
            # forever for EOF the daemon never sends
            mlog = open(f"{fleet_file}.{tag}.log", "ab")
            try:
                procs.append(subprocess.Popen(
                    cmd, env=env, start_new_session=True,
                    stdin=subprocess.DEVNULL, stdout=mlog,
                    stderr=mlog))
            finally:
                mlog.close()
        deadline = time.monotonic() + timeout_s
        ready_parts = []
        for i, ready in enumerate(ready_files):
            while not os.path.exists(ready):
                if procs[i].poll() is not None \
                        or time.monotonic() > deadline:
                    for p in procs:
                        if p.poll() is None:
                            p.terminate()
                    return _reshard_summary(
                        False, op=mode, plan=plan,
                        error="joining member failed to start",
                        elapsed_s=round(time.monotonic() - t0, 3))
                time.sleep(0.02)
            with open(ready) as f:
                ready_parts.append(
                    [p for p in f.read().strip().split(",") if p])

        def _row(i, idx):
            parts = ready_parts[i]
            port = next((int(p.split(":", 1)[1]) for p in parts
                         if p.startswith("statusz:")), None)
            return {"name": f"{args.name}-{n}" if idx is None
                    else f"{args.name}-{n}f{idx}",
                    "addresses": [p for p in parts
                                  if not p.startswith("statusz:")],
                    "statusz_port": port, "pid": procs[i].pid}
        new_row = _row(0, None)
        new_row.update(rank=n, replicas=[
            dict(_row(i, idx), idx=idx)
            for i, (idx, _a) in enumerate(specs) if idx is not None])

    # recipients every donor may dial: all ranks of the NEW map
    member_addrs = {int(m["rank"]): str(m["addresses"][0])
                    for m in rows if int(m["rank"]) < new_n}
    if new_row is not None:
        member_addrs[n] = str(new_row["addresses"][0])

    links = {}

    def _link(rank, addr):
        if rank not in links:
            links[rank] = _transport.WireClient(
                addr, client="reshard-admin", quant=None)
        return links[rank]

    def _close_all():
        for c in links.values():
            try:
                c.close()
            except Exception:   # noqa: BLE001
                pass

    def _abort(reason, states=None):
        for m in rows:
            try:
                _link(int(m["rank"]), str(m["addresses"][0])).call(
                    "migrate_abort", {"plan": plan, "reason": reason})
            except Exception:   # noqa: BLE001 — best-effort rollback
                pass
        for p in procs:
            if p.poll() is None:
                p.terminate()
        _close_all()
        return _reshard_summary(
            False, op=mode, plan=plan, error=reason,
            states=states or {},
            elapsed_s=round(time.monotonic() - t0, 3))

    with _trace.request(f"reshard.{mode}", plan=plan,
                        from_version=v, to_version=v + 1):
        # -- begin wave (existing members only: the joining member is
        # born at v+1 and learns its tables from donor manifests)
        donors = set()
        for m in rows:
            rank = int(m["rank"])
            try:
                reply, _ = _link(rank, str(m["addresses"][0])).call(
                    "migrate_begin",
                    {"plan": plan, "map": new_map.to_wire(),
                     "members": member_addrs})
            except Exception as exc:    # noqa: BLE001
                return _abort(f"begin at rank {rank} failed: {exc}")
            if reply.get("donor"):
                donors.add(rank)

        # -- poll donors until every moved range is streamed
        deadline = time.monotonic() + timeout_s
        while True:
            states = {}
            for m in rows:
                rank = int(m["rank"])
                try:
                    st, _ = _link(rank,
                                  str(m["addresses"][0])).call(
                        "migrate_state", {"plan": plan})
                except Exception as exc:    # noqa: BLE001
                    return _abort(
                        f"state poll at rank {rank} failed: {exc}")
                states[rank] = st
            if any(s.get("state") in ("failed", "aborted")
                   for s in states.values()):
                bad = {r_: s for r_, s in states.items()
                       if s.get("state") in ("failed", "aborted")}
                return _abort(
                    "stream failed: " + "; ".join(
                        f"rank {r_}: {s.get('error')}"
                        for r_, s in bad.items()),
                    {r_: s.get("state")
                     for r_, s in states.items()})
            if all(states[r_].get("state") == "shipped"
                   for r_ in states):
                break
            if time.monotonic() > deadline:
                return _abort(
                    f"reshard timed out after {timeout_s}s",
                    {r_: s.get("state") for r_, s in states.items()})
            time.sleep(0.05)
        moved_bytes = sum(int(s.get("moved_bytes") or 0)
                          for s in states.values())
        chunks = sum(int(s.get("chunks") or 0)
                     for s in states.values())
        forwards = sum(int(s.get("forwards") or 0)
                       for s in states.values())

        # -- commit wave: donors FIRST (sequential — each donor drains
        # its links under the migration lock before flipping), then
        # the rest, then the joining member if it staged anything
        order = [r_ for r_ in sorted(states) if r_ in donors] \
            + [r_ for r_ in sorted(states) if r_ not in donors]
        for rank in order:
            try:
                reply, _ = _link(
                    rank, member_addrs.get(
                        rank, str(rows[rank]["addresses"][0]))).call(
                    "migrate_commit", {"plan": plan})
            except Exception as exc:    # noqa: BLE001
                return _abort(f"commit at rank {rank} failed: {exc}")
            if not reply.get("ok"):
                return _abort(f"commit at rank {rank} refused: "
                              f"{reply.get('error')}")
        if grow:
            try:
                c = _link(n, member_addrs[n])
                st, _ = c.call("migrate_state", {"plan": plan})
                if st.get("state") not in ("idle",):
                    c.call("migrate_commit", {"plan": plan})
            except Exception as exc:    # noqa: BLE001
                return _abort(f"commit at joining rank failed: "
                              f"{exc}")

    # -- flip the fleet file atomically to v+1
    if grow:
        members = rows + [new_row]
    else:
        members = [m for m in rows if int(m["rank"]) < new_n]
    partition.write_fleet_file(fleet_file, new_map, members)

    evicted_pid = None
    if not grow:
        # linger so stale clients hit the relay path (their writes
        # forward to the survivors + they get the remap hint), then
        # retire the evicted member and its followers
        time.sleep(float(
            os.environ.get("MVTPU_SHRINK_LINGER_S", "") or 2.0))
        ev = rows[-1]
        evicted_pid = ev.get("pid")
        for addr in [str(ev["addresses"][0])] + [
                str(rep["addresses"][0])
                for rep in ev.get("replicas", ())
                if rep.get("addresses")]:
            try:
                _transport.WireClient(
                    addr, client="reshard-admin",
                    quant=None).call("shutdown", {})
            except Exception:   # noqa: BLE001 — already gone is fine
                pass
    _close_all()
    return _reshard_summary(
        True, op=mode, plan=plan, from_version=v, to_version=v + 1,
        n_from=n, n_to=new_n, moved_bytes=moved_bytes, chunks=chunks,
        forwards=forwards, evicted_pid=evicted_pid,
        joined_pid=procs[0].pid if procs else None,
        elapsed_s=round(time.monotonic() - t0, 3))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m multiverso_tpu_torch.server",
        description="multiverso_tpu_torch table-server process / fleet "
                    "launcher")
    parser.add_argument("--address", default="unix:/tmp/mvtpu.sock")
    parser.add_argument("--device", default="cuda:0")
    parser.add_argument("--name", default="tables")
    parser.add_argument("--fuse", type=int, default=None)
    parser.add_argument("--qos", default=None)
    parser.add_argument("--queue", type=int, default=None)
    parser.add_argument("--ready-file", default=None)
    parser.add_argument("--fleet", type=int, default=None)
    parser.add_argument("--fleet-file", default=None)
    parser.add_argument("--fleet-version", type=int, default=1)
    parser.add_argument("--kv-buckets", type=int, default=None)
    parser.add_argument("--fleet-rank", type=int, default=0)
    parser.add_argument("--fleet-n", type=int, default=0)
    parser.add_argument("--replicas", type=int, default=1)
    parser.add_argument("--replica-of", type=int, default=None)
    parser.add_argument("--replica-idx", type=int, default=None)
    parser.add_argument("--replicate-to", default=None)
    parser.add_argument("--grow", action="store_true")
    parser.add_argument("--shrink", action="store_true")
    args = parser.parse_args(argv)

    from multiverso_tpu_torch.server import partition

    if args.grow or args.shrink:
        return _reshard_main(args, partition, grow=bool(args.grow))
    if args.fleet:
        return _fleet_main(args, partition)

    from multiverso_tpu_torch.server.table_server import TableServer
    return _member_main(args, TableServer, partition)


if __name__ == "__main__":
    sys.exit(main())
