"""``python -m multiverso_tpu_torch.server``: run one table-server process.

Counterpart of ``multiverso_tpu/server/__main__.py``'s standalone server
(its ``main`` and ``_member_main``): init the runtime on ``--device``
(chaos from the environment), serve the wire address until
SIGTERM/SIGINT, then drain. The fleet launcher (``--fleet``), the live
reshards (``--grow``, ``--shrink``) and the replicas (``--replicas``
above 1, ``--replica-of``, ``--replica-idx``, ``--replicate-to``), and
``--fleet-file``, wait for ROADMAP queue A item 11b: each exits with
status 2 and says so.

Flags:

``--address unix:/path | tcp:host:port | shm:///path [, ...]``
    wire address(es) to listen on, comma-separated (default
    ``unix:/tmp/mvtpu.sock``; ``tcp:host:0`` picks an ephemeral port —
    see ``--ready-file``; ``shm://`` serves the shared-memory ring
    transport, falling back to socket frames per connection for
    clients that dial it as plain unix).
``--device DEV``
    where the tables live (default ``cuda:0``; ``cpu`` for the CPU).
    There is no fallback: without the card the first create fails.
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
    workers. It holds the bound addresses only: the reference appends
    the statusz port, which comes with ROADMAP queue A item 11e.
``--fleet-rank R`` / ``--fleet-n N`` / ``--fleet-version V`` /
``--kv-buckets B``
    serve partition R of an N-member map (version V, B logical KV
    buckets): every create builds only this rank's shard, and hello
    refuses a client claiming another map.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

#: the flags of the fleet, the reshards and the replicas
_NOT_PORTED = ("fleet", "fleet_file", "grow", "shrink", "replica_of",
               "replica_idx", "replicate_to")


def _write_ready(path: str, content: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, path)


def _member_main(args, server_cls, partition) -> int:
    """One standalone server (a partition member when the fleet-rank
    flags are set)."""
    from multiverso_tpu_torch import core

    member = None
    if args.fleet_n:
        pmap = partition.PartitionMap(args.fleet_n,
                                      version=args.fleet_version,
                                      kv_buckets=args.kv_buckets,
                                      replicas=args.replicas or 1)
        member = partition.PartitionMember(pmap, args.fleet_rank)
    core.init(device=args.device)
    server = server_cls(args.address, name=args.name, fuse=args.fuse,
                        qos=args.qos, queue_bound=args.queue,
                        partition=member, device=args.device)
    bound = server.start()
    if args.ready_file:
        _write_ready(args.ready_file, bound)

    def _stop(signum, frame):
        server.stop()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    try:
        server.serve_forever()
    finally:
        server.stop()
        core.shutdown()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m multiverso_tpu_torch.server",
        description="multiverso_tpu_torch table-server process")
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

    refused = [f"--{k.replace('_', '-')}" for k in _NOT_PORTED
               if getattr(args, k) is not None
               and getattr(args, k) is not False]
    if (args.replicas or 1) > 1:
        refused.append("--replicas > 1")
    if refused:
        print(f"{', '.join(refused)}: the server fleet, its replicas and "
              "live resharding are not ported yet (ROADMAP A11b)",
              file=sys.stderr)
        return 2

    from multiverso_tpu_torch.server import partition
    from multiverso_tpu_torch.server.table_server import TableServer
    return _member_main(args, TableServer, partition)


if __name__ == "__main__":
    sys.exit(main())
