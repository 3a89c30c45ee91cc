"""Report CLI: render a metrics snapshot or span trace as a table,
Chrome/Perfetto trace, or top-N hot list (counterpart of
``multiverso_tpu/telemetry/report.py``: the same flags, renderings and
outputs, byte for byte on the same artifacts).

    python -m multiverso_tpu_torch.telemetry.report <file> [--prometheus]
        [--chrome-trace [OUT]] [--top N] [--health]
    python -m multiverso_tpu_torch.telemetry.report --fleet FLEET_FILE
        [--client-trace JSONL ...] [--snapshot-out OUT]
        [--chrome-trace [OUT]] [--top N] [--window S] [--vars-out OUT]

Accepts any of the telemetry layer's on-disk artifacts (either
package's: the records are the same JSON) and autodetects which it got:

- a registry snapshot (``write_snapshot`` / ``fleet_snapshot`` JSON,
  ``kind == "mvtpu.metrics.v1"``) → counters/gauges tables + histogram
  summaries (or ``--prometheus`` text exposition),
- a span/step trace JSONL (``trace.set_trace_file`` output) → per-name
  span aggregates plus the step timeline tail,
- a metric-event JSONL (``MVTPU_METRICS_JSONL`` sink) → last value per
  metric,
- a windowed-series doc (``/vars?window=`` output or a
  ``report --fleet --vars-out`` merge, ``kind == "mvtpu.series.v1"``)
  → windowed rates / gauges / quantile tables,
- a flight-recorder series dump (watchdog ``series.json``,
  ``kind == "mvtpu.series.dump.v1"``) → per-series sparklines of the
  trailing window,
- a heavy-hitter doc (``/topk`` output, ``kind == "mvtpu.topk.v1"``)
  → top-talkers table + per-range heat strips.

``--chrome-trace [OUT]`` converts a span/step/metric JSONL into Chrome
trace-event JSON (default OUT ``-`` = stdout) loadable in Perfetto
(ui.perfetto.dev) or chrome://tracing: one process track per
(host, pid), one thread lane per host thread, spans as nested complete
events, step heartbeats as instants, metric events as counter series.

``--top N`` prints the N slowest individual spans of a trace (with
their timestamps — "what was in flight when it died"), or a snapshot's
N largest counters (hottest tables by bytes/ops) and histograms by
total time.

``--fleet`` treats PATH as a launcher fleet file and scrapes every
member's statusz (``/trace`` tail + ``/metrics?json=1``) — each rank's
primary and, unlike the reference, its followers too — merges in any
``--client-trace`` JSONLs, clock-aligns the timelines from the trace's
per-connection offset records, and reports the fleet as ONE system: a
merged ``--chrome-trace`` with a process track per (host, pid) and flow
arrows stitching each request's cross-process tree, plus a fleet-total
metrics snapshot (``--snapshot-out``). The default table view also
scrapes the usage plane — merged ``/vars?window=`` (``--window``,
``--vars-out``) and merged ``/topk`` rendered as a fleet top-talkers
table with per-range heat strips aligned member by member.

Stdlib plus the port's telemetry modules; it imports no torch of its
own, so it runs against the artifacts of a hung run on a host whose
card is exactly what's broken (the post-mortem path).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

from multiverso_tpu_torch.telemetry import attribution as _attribution
from multiverso_tpu_torch.telemetry import metrics as _metrics
from multiverso_tpu_torch.telemetry import timeseries as _timeseries
from multiverso_tpu_torch.telemetry import trace as _trace


def _table(rows: List[List[str]], header: List[str]) -> str:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header)]
    lines += [fmt.format(*(str(c) for c in r)) for r in rows]
    return "\n".join(lines)


def _num(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


def render_snapshot(snap: dict) -> str:
    out = []
    hosts = snap.get("hosts")
    if hosts:
        out.append(f"fleet snapshot over {hosts} host(s)")
    counters = snap.get("counters", {})
    if counters:
        rows = [[k, _num(v)] for k, v in sorted(counters.items())]
        out.append("counters:\n" + _table(rows, ["name", "value"]))
    gauges = snap.get("gauges", {})
    if gauges:
        rows = [[k, _num(v)] for k, v in sorted(gauges.items())]
        out.append("gauges:\n" + _table(rows, ["name", "value"]))
    hists = snap.get("histograms", {})
    if hists:
        rows = []
        for k, h in sorted(hists.items()):
            count, total = h["count"], h["sum"]
            mean = total / count if count else 0.0
            rows.append([k, _num(count), f"{total:.4f}",
                         f"{mean * 1e3:.3f}", _q_ms(h, 0.5),
                         _q_ms(h, 0.99)])
        out.append("histograms:\n" + _table(
            rows, ["name", "count", "sum", "mean_ms", "p50_ms",
                   "p99_ms"]))
    if not out:
        return "(empty snapshot)"
    return "\n\n".join(out)


def _q_ms(h: dict, q: float) -> str:
    """Interpolated quantile as milliseconds ("-" while empty) —
    bucket-resolution accurate, like every pNN this layer reports."""
    v = _metrics.snapshot_quantile(h, q)
    return "-" if v is None else f"{v * 1e3:.3f}"


def render_decisions(records: List[dict]) -> str:
    """Autotuning audit trail: every ``control.decision`` span in the
    (merged) trace, time-ordered — a fleet tuning episode reads as one
    table across processes, knob by knob."""
    rows = []
    for r in records:
        if r.get("kind") != "span" or r.get("name") != \
                "control.decision":
            continue
        at = r.get("attrs") or {}
        rows.append([f"{float(r.get('ts', 0)):.3f}",
                     str(r.get("host", "")),
                     str(at.get("knob", "")),
                     str(at.get("label", "")),
                     f"{at.get('from')} -> {at.get('to')}",
                     str(at.get("origin", "")),
                     str(at.get("rule", ""))])
    if not rows:
        return ""
    return ("control decisions:\n" + _table(
        rows, ["ts", "host", "knob", "label", "change", "origin",
               "rule"]))


def render_trace(records: List[dict]) -> str:
    spans: Dict[str, List[float]] = {}
    steps: List[dict] = []
    other = 0
    for r in records:
        kind = r.get("kind")
        if kind == "span":
            spans.setdefault(r["name"], []).append(float(r["dur_s"]))
        elif kind == "step":
            steps.append(r)
        else:
            other += 1
    out = []
    if spans:
        rows = []
        for name, durs in sorted(spans.items()):
            rows.append([name, len(durs), f"{sum(durs):.4f}",
                         f"{sum(durs) / len(durs) * 1e3:.3f}",
                         f"{max(durs) * 1e3:.3f}"])
        out.append("spans:\n" + _table(
            rows, ["name", "count", "total_s", "mean_ms", "max_ms"]))
    if steps:
        rows = []
        for r in steps[-20:]:
            extra = ", ".join(
                f"{k}={_num(v) if isinstance(v, (int, float)) else v}"
                for k, v in sorted(r.items())
                if k not in ("kind", "name", "step", "ts", "parent",
                             "host", "pid", "tid"))
            rows.append([r["name"], r["step"], f"{r['ts']:.3f}", extra])
        out.append(f"steps (last {len(rows)} of {len(steps)}):\n"
                   + _table(rows, ["name", "step", "ts", "fields"]))
    if other:
        out.append(f"({other} unrecognized record(s) skipped)")
    if not out:
        return "(empty trace)"
    return "\n\n".join(out)


def clock_offsets(records: List[dict]) -> Dict[tuple, float]:
    """Per-process timestamp corrections from ``{"kind": "clock"}``
    records: ``(host, pid) -> seconds to ADD`` to that process's
    timestamps to land them on the recorder's (the client's) timeline.

    A clock record says ``offset_us = peer_clock - my_clock`` (the
    RTT-midpoint estimate the transport samples per connection), so the
    peer's records shift by ``-offset``. A process that recorded clock
    samples itself IS a reference — it never gets shifted, even when it
    also appears as someone's peer (the in-process test topology).
    Latest estimate per peer wins."""
    offs: Dict[tuple, float] = {}
    refs = set()
    for r in records:
        if r.get("kind") != "clock":
            continue
        refs.add((r.get("host", 0), r.get("pid", 0)))
        peer = r.get("peer") or {}
        key = (peer.get("host", 0), peer.get("pid", 0))
        offs[key] = -float(r.get("offset_us", 0.0)) / 1e6
    for key in refs:
        offs.pop(key, None)
    return offs


def to_chrome_trace(records: List[dict]) -> dict:
    """Span/step/metric JSONL records → Chrome trace-event JSON
    (Perfetto / chrome://tracing loadable).

    Tracks: each distinct (host, pid) becomes one chrome "process"
    (renamed ``host<h>/pid<p>`` via metadata events) and each distinct
    host thread one lane inside it — chrome pids/tids are small
    synthetic ints so two hosts reusing an OS pid can't merge tracks.
    Spans map to "X" complete events (ts/dur in µs; same-thread nesting
    renders as stacked slices), step heartbeats to "i" instants, and
    metric events to "C" counter series.

    Cross-process: timestamps are clock-aligned per process using the
    trace's ``clock`` records (see :func:`clock_offsets`), and every
    span carrying an ``rparent`` (a server-side root serving a remote
    request) gets a flow arrow ("s"/"f" event pair) from the originating
    client span — one fleet get renders as one arrow-linked tree
    spanning N+1 process tracks."""
    events: List[dict] = []
    procs: Dict[tuple, int] = {}
    threads: Dict[tuple, int] = {}
    offsets = clock_offsets(records)

    def track(r: dict) -> tuple:
        host, pid = r.get("host", 0), r.get("pid", 0)
        cpid = procs.get((host, pid))
        if cpid is None:
            cpid = procs[(host, pid)] = len(procs) + 1
            shift = offsets.get((host, pid))
            label = f"host{host}/pid{pid}"
            if shift:
                label += f" (clock {shift * 1e6:+.0f}us)"
            events.append({"ph": "M", "name": "process_name",
                           "pid": cpid, "tid": 0,
                           "args": {"name": label}})
        tkey = (host, pid, r.get("tid", 0))
        ctid = threads.get(tkey)
        if ctid is None:
            ctid = threads[tkey] = \
                sum(1 for k in threads if k[:2] == (host, pid)) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": cpid, "tid": ctid,
                           "args": {"name": f"thread-{tkey[2]}"}})
        return cpid, ctid

    def ts_us(r: dict) -> float:
        shift = offsets.get((r.get("host", 0), r.get("pid", 0)), 0.0)
        return (float(r.get("ts", 0)) + shift) * 1e6

    # (host, pid, span_id) -> (cpid, ctid, ts_us, dur_us): the flow
    # stitcher resolves rparent references against this index
    span_pos: Dict[tuple, tuple] = {}
    links: List[tuple] = []
    for r in records:
        kind = r.get("kind")
        if kind == "span":
            cpid, ctid = track(r)
            args = dict(r.get("attrs") or {})
            args["span_id"] = r.get("id")
            if r.get("parent") is not None:
                args["parent"] = r["parent"]
            if r.get("req") is not None:
                args["req"] = r["req"]
            ts = ts_us(r)
            dur = max(float(r.get("dur_s", 0)), 0) * 1e6
            span_pos[(r.get("host", 0), r.get("pid", 0),
                      r.get("id"))] = (cpid, ctid, ts, dur)
            rp = r.get("rparent")
            if isinstance(rp, dict):
                args["rparent"] = (f"h{rp.get('host', 0)}:"
                                   f"p{rp.get('pid', 0)}:"
                                   f"s{rp.get('span')}")
                links.append(((cpid, ctid, ts, dur), rp))
            events.append({"name": r["name"], "ph": "X", "cat": "span",
                           "ts": ts, "dur": dur,
                           "pid": cpid, "tid": ctid, "args": args})
        elif kind == "step":
            cpid, ctid = track(r)
            args = {k: v for k, v in r.items()
                    if k not in ("kind", "ts", "host", "pid", "tid",
                                 "parent")}
            events.append({"name": f"{r['name']} step {r['step']}",
                           "ph": "i", "cat": "step", "s": "t",
                           "ts": ts_us(r),
                           "pid": cpid, "tid": ctid, "args": args})
        elif "metric" in r:
            cpid, _ = track(r)
            events.append({"name": r["metric"], "ph": "C",
                           "ts": ts_us(r), "pid": cpid,
                           "args": {"value": r.get("value", 0)}})
    # flow arrows: remote parent span -> server-side root span. The
    # "s" binds inside the parent slice, the "f" inside the child.
    flow = 0
    for (cpid, ctid, ts, dur), rp in links:
        parent = span_pos.get((rp.get("host", 0), rp.get("pid", 0),
                               rp.get("span")))
        if parent is None:
            continue
        flow += 1
        ppid, ptid, pts, pdur = parent
        events.append({"ph": "s", "id": flow, "name": "req",
                       "cat": "req", "ts": pts + pdur / 2,
                       "pid": ppid, "tid": ptid})
        events.append({"ph": "f", "bp": "e", "id": flow, "name": "req",
                       "cat": "req", "ts": ts + dur / 2,
                       "pid": cpid, "tid": ctid})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_top(kind: str, data, n: int) -> str:
    """The N hottest items of any artifact (see module docstring)."""
    out: List[str] = []
    if kind == "snapshot":
        counters = sorted(data.get("counters", {}).items(),
                          key=lambda kv: -kv[1])[:n]
        if counters:
            rows = [[k, _num(v)] for k, v in counters]
            out.append(f"top {len(rows)} counters:\n"
                       + _table(rows, ["name", "value"]))
        hists = sorted(data.get("histograms", {}).items(),
                       key=lambda kv: -kv[1]["sum"])[:n]
        if hists:
            rows = [[k, _num(h["count"]), f"{h['sum']:.4f}",
                     f"{(h['sum'] / h['count'] if h['count'] else 0) * 1e3:.3f}"]
                    for k, h in hists]
            out.append(f"top {len(rows)} histograms by total time:\n"
                       + _table(rows, ["name", "count", "sum_s",
                                       "mean_ms"]))
    else:
        spans = sorted((r for r in data if r.get("kind") == "span"),
                       key=lambda r: -float(r.get("dur_s", 0)))[:n]
        if spans:
            rows = [[r["name"], f"{float(r['dur_s']) * 1e3:.3f}",
                     f"{r['ts']:.3f}",
                     f"h{r.get('host', 0)}:{r.get('pid', 0)}"]
                    for r in spans]
            out.append(f"top {len(rows)} slowest spans:\n"
                       + _table(rows, ["name", "dur_ms", "ts", "who"]))
    if not out:
        return "(nothing to rank)"
    return "\n\n".join(out)


def render_health(snap: dict) -> str:
    """Training-health view of a snapshot: the ``health.*`` gauges
    (latest per-table numerics stats), the violation/rollback counters,
    and the chaos-fired counters a health incident usually pairs with."""
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    out = []
    stat_rows = [[k, _num(v)] for k, v in sorted(gauges.items())
                 if k.startswith("health.")]
    if stat_rows:
        out.append("health stats (latest per table/kind):\n"
                   + _table(stat_rows, ["stat", "value"]))
    count_rows = [[k, _num(v)] for k, v in sorted(counters.items())
                  if k.startswith("health.")
                  or k.startswith("chaos.fired")]
    if count_rows:
        out.append("health counters:\n"
                   + _table(count_rows, ["name", "value"]))
    if not out:
        return ("(no health.* metrics in this snapshot — was "
                "MVTPU_HEALTH set on the run?)")
    return "\n\n".join(out)


_BLOCKS = " ▁▂▃▄▅▆▇█"


def _spark(values: List[float], peak: Optional[float] = None) -> str:
    """Unicode block sparkline, scaled to ``peak`` (default: own max)
    so strips sharing a peak are visually comparable."""
    if not values:
        return ""
    top = peak if peak else max(values)
    if top <= 0:
        return _BLOCKS[0] * len(values)
    hi = len(_BLOCKS) - 1
    return "".join(
        _BLOCKS[min(max(int(v / top * hi + 0.5), 0), hi)]
        for v in values)


def _heat_parts(heat: dict) -> Dict[str, List[dict]]:
    """Normalize member-doc heat (``{table: part}``) and merged-doc
    heat (``{table: [part, ...]}``) to the list form."""
    out: Dict[str, List[dict]] = {}
    for table, h in (heat or {}).items():
        out[table] = list(h) if isinstance(h, list) else [dict(h)]
    return out


def render_topk(doc: dict, n: int = 10) -> str:
    """Top-talkers table + per-range heat strips of an
    ``mvtpu.topk.v1`` document (single member or merged fleet).

    One row per (client, table, op) in ``ops`` rank order, with the
    same key's standing in every other dimension joined in — "-" when
    a dimension's sketch is not tracking that key. Heat strips lay a
    table's per-member ranges side by side (sorted by range start)
    scaled to one shared peak, so the hottest bucket of the FLEET is
    the tallest block of the whole strip."""
    if doc.get("disabled"):
        return "(attribution plane disabled — MVTPU_TOPK_K=0)"
    dims = doc.get("dims", {})
    out: List[str] = []
    members = doc.get("members")
    label = (f"fleet top talkers ({members} member(s))"
             if members else "top talkers")
    by_key: Dict[str, Dict[str, tuple]] = {}
    for dim in _attribution.DIMS:
        for r in (dims.get(dim) or {}).get("top", []):
            key = _attribution.key_str(r.get("client", ""),
                                       r.get("table", ""),
                                       r.get("op", ""))
            by_key.setdefault(key, {})[dim] = (
                float(r.get("estimate", 0.0)),
                float(r.get("error", 0.0)))
    ranked = sorted(by_key.items(),
                    key=lambda kv: -kv[1].get("ops", (0.0, 0.0))[0])

    def cell(cells: Dict[str, tuple], dim: str) -> str:
        c = cells.get(dim)
        if c is None:
            return "-"
        est, err = c
        return _num(est) if not err else f"{_num(est)}±{_num(err)}"

    rows = [[*_attribution.split_key(key), cell(cells, "ops"),
             cell(cells, "bytes"), cell(cells, "queue_ms"),
             cell(cells, "sheds")]
            for key, cells in ranked[:n]]
    if rows:
        totals = ", ".join(
            f"{d}={_num(float((dims.get(d) or {}).get('total', 0.0)))}"
            for d in _attribution.DIMS
            if (dims.get(d) or {}).get("total"))
        out.append(f"{label} (totals: {totals or 'none'}):\n" + _table(
            rows, ["client", "table", "op", "ops", "bytes", "queue_ms",
                   "sheds"]))
    parts_by_table = _heat_parts(doc.get("heat", {}))
    for table, parts in sorted(parts_by_table.items()):
        peak = max((max(p.get("counts") or [0.0]) for p in parts),
                   default=0.0)
        lines = [f"heat [{table}] "
                 f"({parts[0].get('space', '?')} space, shared peak "
                 f"{_num(peak)}):"]
        for p in parts:
            who = (f"m{p['member']}" if "member" in p else "local")
            lines.append(
                f"  {who:<6} [{p.get('lo', 0):>8}, {p.get('hi', 0):>8})"
                f"  {_spark(p.get('counts', []), peak)}"
                f"  total {_num(float(p.get('total', 0.0)))}")
        out.append("\n".join(lines))
    if not out:
        return "(empty top-k document)"
    return "\n\n".join(out)


def render_series(doc: dict) -> str:
    """Windowed-vars table of an ``mvtpu.series.v1`` document (one
    member's ``/vars`` or the :func:`timeseries.merge_vars` fleet
    view): per-counter rates over the window, gauge last-points, and
    windowed histogram quantiles."""
    w = doc.get("window", 0.0)
    members = doc.get("members")
    head = (f"windowed vars (last {_num(w)}s, {members} member(s))"
            if members else f"windowed vars (last {_num(w)}s)")
    out: List[str] = []
    rates = doc.get("rates", {})
    deltas = doc.get("deltas", {})
    if rates or deltas:
        keys = sorted(set(rates) | set(deltas))
        rows = [[k,
                 _num(rates[k]) if k in rates else "-",
                 _num(deltas[k]) if k in deltas else "-"]
                for k in keys]
        out.append(f"{head} — counters:\n"
                   + _table(rows, ["name", "per_s", "delta"]))
    gauges = doc.get("gauges", {})
    if gauges:
        rows = [[k, _num(v)] for k, v in sorted(gauges.items())]
        out.append("gauges (latest):\n" + _table(rows, ["name",
                                                        "value"]))
    hists = doc.get("histograms", {})
    if hists:
        rows = []
        for k, h in sorted(hists.items()):
            def ms(v):
                return "-" if v is None else f"{v * 1e3:.3f}"
            rows.append([k, _num(h.get("count", 0)),
                         ms(h.get("p50")), ms(h.get("p99")),
                         ms(h.get("p999"))])
        out.append("windowed histograms:\n" + _table(
            rows, ["name", "count", "p50_ms", "p99_ms", "p999_ms"]))
    if not out:
        return f"{head}: (no series yet — sampler warming up?)"
    return "\n\n".join(out)


def render_series_dump(doc: dict) -> str:
    """Sparkline view of an ``mvtpu.series.dump.v1`` flight-recorder
    document: one line per series, the trailing window rendered as
    blocks with the min/max/last values spelled out — the "what were
    the last 60 seconds like" a post-mortem opens with."""
    series = doc.get("series", {})
    if not series:
        return "(empty series dump)"
    rows = []
    for key, s in sorted(series.items()):
        vals = [float(p[1]) for p in s.get("points", [])]
        if not vals:
            continue
        rows.append([key, s.get("unit", ""), _spark(vals),
                     _num(min(vals)), _num(max(vals)), _num(vals[-1])])
    head = (f"series dump (last {_num(doc.get('window', 0.0))}s, "
            f"{len(rows)} series):")
    return head + "\n" + _table(
        rows, ["series", "unit", "trail", "min", "max", "last"])


def render_metric_events(records: List[dict]) -> str:
    last: Dict[str, dict] = {}
    for r in records:
        last[r["metric"]] = r
    rows = [[k, _num(r["value"]), r.get("unit", ""), f"{r['ts']:.3f}"]
            for k, r in sorted(last.items())]
    return ("metric events (last value of each):\n"
            + _table(rows, ["metric", "value", "unit", "ts"]))


# -- fleet scrape ----------------------------------------------------------

def _http_get(port: int, path: str, timeout: float = 10.0) -> bytes:
    import urllib.request
    url = f"http://127.0.0.1:{port}{path}"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def scrape_fleet(fleet_file: str, client_traces=(),
                 timeout: float = 10.0):
    """Scrape every fleet member's statusz (``/trace`` tail +
    ``/metrics?json=1`` registry snapshot; each rank's primary and its
    followers, ``partition.fleet_members``), merge with any local
    client trace JSONLs, and return ``(records, snapshot, errors)``:
    time-sorted trace records ready for :func:`to_chrome_trace` (whose
    clock records align the timelines), one fleet-total
    ``mvtpu.metrics.v1`` snapshot (None when nothing scraped), and
    human-readable per-member scrape failures — a partial fleet still
    yields a partial report."""
    from multiverso_tpu_torch.server import partition  # torch-free
    from multiverso_tpu_torch.telemetry import aggregate
    doc = partition.read_fleet_file(fleet_file)
    if doc is None:
        raise ValueError(f"not a fleet file: {fleet_file}")
    records: List[dict] = []
    snaps: List[dict] = []
    errors: List[str] = []
    for m in partition.fleet_members(doc):
        port, rank = m.get("statusz_port"), m.get("rank")
        if not port:
            errors.append(f"member rank={rank}: no statusz_port "
                          "(launch with MVTPU_STATUSZ_PORT)")
            continue
        try:
            tail = _http_get(port, "/trace", timeout)
            for line in tail.decode("utf-8", "replace").splitlines():
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue
            snap = json.loads(_http_get(port, "/metrics?json=1",
                                        timeout))
            if snap.get("kind") == _metrics.SNAPSHOT_KIND:
                snaps.append(snap)
        except (OSError, ValueError) as e:
            errors.append(f"member rank={rank} port={port}: {e!r}")
    for path in client_traces:
        records.extend(_trace.read_trace(path))
    snap = aggregate.merge_snapshots(snaps) if snaps else None
    records.sort(key=lambda r: float(r.get("ts", 0)))
    return records, snap, errors


def scrape_usage(fleet_file: str, window: float = 30.0,
                 timeout: float = 10.0):
    """Scrape every fleet member's usage plane (``/vars?window=`` +
    ``/topk``) and return ``(vars_merged, topk_merged, errors)`` —
    the merged windowed-series doc (:func:`timeseries.merge_vars`),
    the merged heavy-hitter doc (:func:`attribution.merge_topk`), or
    None for whichever nothing answered. Same partial-fleet tolerance
    as :func:`scrape_fleet`."""
    from multiverso_tpu_torch.server import partition  # torch-free
    doc = partition.read_fleet_file(fleet_file)
    if doc is None:
        raise ValueError(f"not a fleet file: {fleet_file}")
    vars_docs: List[dict] = []
    topk_docs: List[dict] = []
    errors: List[str] = []
    for m in partition.fleet_members(doc):
        port, rank = m.get("statusz_port"), m.get("rank")
        if not port:
            continue       # scrape_fleet already reports these
        try:
            v = json.loads(_http_get(port, f"/vars?window={window:g}",
                                     timeout))
            if v.get("kind") == _timeseries.SERIES_KIND:
                vars_docs.append(v)
            t = json.loads(_http_get(port, "/topk", timeout))
            if t.get("kind") == _attribution.TOPK_KIND \
                    and not t.get("disabled"):
                topk_docs.append(t)
        except (OSError, ValueError) as e:
            errors.append(f"member rank={rank} port={port} usage: "
                          f"{e!r}")
    vars_merged = (_timeseries.merge_vars(vars_docs)
                   if vars_docs else None)
    topk_merged = (_attribution.merge_topk(topk_docs)
                   if topk_docs else None)
    return vars_merged, topk_merged, errors


def _load(path: str):
    """Autodetect artifact type → ("snapshot"|"series"|"seriesdump"|
    "topk"|"trace"|"events", data)."""
    with open(path) as f:
        head = f.read(1 << 20)
    stripped = head.lstrip()
    if stripped.startswith("{"):
        try:
            doc = json.loads(head)
        except ValueError:
            doc = None
        if isinstance(doc, dict):
            kind = doc.get("kind")
            if kind == _metrics.SNAPSHOT_KIND:
                return "snapshot", doc
            if kind == _timeseries.SERIES_KIND:
                return "series", doc
            if kind == _timeseries.DUMP_KIND:
                return "seriesdump", doc
            if kind == _attribution.TOPK_KIND:
                return "topk", doc
    records = _trace.read_trace(path)
    if records and all("metric" in r for r in records):
        return "events", records
    return "trace", records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m multiverso_tpu_torch.telemetry.report",
        description="Render a telemetry snapshot or trace as a table.")
    p.add_argument("path", help="snapshot JSON, trace JSONL, or metric "
                                "event JSONL")
    p.add_argument("--prometheus", action="store_true",
                   help="emit a snapshot in Prometheus text format")
    p.add_argument("--chrome-trace", nargs="?", const="-", default=None,
                   metavar="OUT",
                   help="convert a trace/event JSONL to Chrome "
                        "trace-event JSON (Perfetto/chrome://tracing "
                        "loadable); OUT defaults to stdout")
    p.add_argument("--top", type=int, default=0, metavar="N",
                   help="print the N slowest spans (trace) or largest "
                        "counters/histograms (snapshot)")
    p.add_argument("--health", action="store_true",
                   help="summarize the training-health metrics of a "
                        "snapshot (health.* stats, violations, "
                        "rollbacks, chaos firings)")
    p.add_argument("--fleet", action="store_true",
                   help="treat PATH as a launcher fleet file: scrape "
                        "/trace + /metrics from every member's statusz "
                        "port, merge with --client-trace JSONLs, and "
                        "report the fleet as one system")
    p.add_argument("--client-trace", action="append", default=[],
                   metavar="JSONL",
                   help="local (client-side) trace JSONL to merge into "
                        "a --fleet report; repeatable")
    p.add_argument("--snapshot-out", default=None, metavar="OUT",
                   help="with --fleet: also write the merged "
                        "fleet-total metrics snapshot (mvtpu.metrics.v1"
                        " JSON) to OUT")
    p.add_argument("--window", type=float, default=30.0, metavar="S",
                   help="with --fleet: trailing window (seconds) for "
                        "the merged /vars scrape (default 30)")
    p.add_argument("--vars-out", default=None, metavar="OUT",
                   help="with --fleet: also write the merged windowed "
                        "series doc (mvtpu.series.v1 JSON) to OUT")
    args = p.parse_args(argv)

    def write_chrome(records: List[dict]) -> None:
        doc = to_chrome_trace(records)
        if args.chrome_trace == "-":
            json.dump(doc, sys.stdout)
            print()
        else:
            with open(args.chrome_trace, "w") as f:
                json.dump(doc, f)
            print(f"wrote {len(doc['traceEvents'])} events to "
                  f"{args.chrome_trace} (load at ui.perfetto.dev or "
                  "chrome://tracing)", file=sys.stderr)

    if args.fleet:
        records, snap, errors = scrape_fleet(args.path,
                                             args.client_trace)
        for err in errors:
            print(f"fleet scrape: {err}", file=sys.stderr)
        if args.snapshot_out:
            if snap is None:
                print("no member snapshot scraped; --snapshot-out "
                      "skipped", file=sys.stderr)
            else:
                with open(args.snapshot_out, "w") as f:
                    json.dump(snap, f)
                print(f"wrote fleet metrics snapshot to "
                      f"{args.snapshot_out}", file=sys.stderr)
        if args.chrome_trace is not None:
            write_chrome(records)
        elif args.top:
            print(render_top("trace", records, args.top))
        else:
            fleet_vars, fleet_topk, uerrors = scrape_usage(
                args.path, args.window)
            for err in uerrors:
                print(f"fleet scrape: {err}", file=sys.stderr)
            if args.vars_out and fleet_vars is not None:
                with open(args.vars_out, "w") as f:
                    json.dump(fleet_vars, f)
                print(f"wrote fleet windowed series doc to "
                      f"{args.vars_out}", file=sys.stderr)
            out = [render_trace(records)]
            decisions = render_decisions(records)
            if decisions:
                out.append(decisions)
            if snap is not None:
                out.append(render_snapshot(snap))
            if fleet_vars is not None:
                out.append(render_series(fleet_vars))
            if fleet_topk is not None:
                out.append(render_topk(fleet_topk))
            print("\n\n".join(out))
        return 0

    kind, data = _load(args.path)
    if args.chrome_trace is not None:
        if kind not in ("trace", "events"):
            # the reference refuses a snapshot only, and raises on the
            # other documents; the port refuses them all
            what = "a snapshot" if kind == "snapshot" \
                else f"a {kind} document"
            print("--chrome-trace requires a trace or metric-event "
                  f"JSONL, not {what}", file=sys.stderr)
            return 2
        write_chrome(data)
        return 0
    if args.health:
        if kind != "snapshot":
            print("--health requires a registry snapshot",
                  file=sys.stderr)
            return 2
        print(render_health(data))
        return 0
    if args.top:
        if kind == "topk":
            print(render_topk(data, args.top))
        elif kind in ("series", "seriesdump"):
            print(f"--top is not meaningful for a {kind} document",
                  file=sys.stderr)
            return 2
        else:
            print(render_top(kind, data, args.top))
        return 0
    if args.prometheus:
        if kind != "snapshot":
            print("--prometheus requires a registry snapshot",
                  file=sys.stderr)
            return 2
        print(_metrics.snapshot_to_prometheus(data), end="")
        return 0
    if kind == "snapshot":
        print(render_snapshot(data))
    elif kind == "series":
        print(render_series(data))
    elif kind == "seriesdump":
        print(render_series_dump(data))
    elif kind == "topk":
        print(render_topk(data))
    elif kind == "events":
        print(render_metric_events(data))
    else:
        print(render_trace(data))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BrokenPipeError:
        # piped into head/less and the reader left — normal CLI exit
        import os
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        rc = 0
    raise SystemExit(rc)
