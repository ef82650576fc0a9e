"""Offline trace / flight-dump summaries (port of ``dvf_tpu.obs.viewer``,
the reference's ``dvf_tpu trace-view``; the CLI subcommand is not ported).

Post-mortems should not require loading Perfetto: this module reads a
Chrome-trace JSON file (the ``.pftrace`` documents ``Tracer.export`` /
``merge_tracer_snapshots`` write) or a whole FlightRecorder dump
directory and renders the numbers a human reads first —

- **per-lane utilization**: for each pid lane, the fraction of its
  active span covered by 'X' events (busy ÷ wall), so "the dispatch
  lane was 97% busy while the device lane idled" is one glance;
- **slowest spans**: the top-K longest 'X' events with their lane and
  timestamps — where the wall time actually went;
- **slowest frame lineages** (dumps with ``lineage.json``): the
  exemplar frames' additive decompositions, worst first — the
  per-frame "where did my p99 go" answer, offline;
- **reconfiguration events** (the obs/ledger plane): a dump's
  ``ledger.json`` — every compile / resize / rebuild / quality rebind /
  scale action with its cause, wall cost, and MEASURED bucket stall —
  rendered inline beside the lane utilization; a bare trace file shows
  the same events from its ``reconfig:*`` lane spans.
- **audit verdicts** (the obs/audit plane): a dump's ``audit.json`` —
  shadow-replay / swap-guard / divergence counters plus the confirmed
  corruption events, rendered beside the ledger events so "what
  reconfigured" and "what corrupted" share one timeline.

Everything returns plain dicts (the ``--json`` form); ``render_text``
turns one summary into the human view.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

from dvf_tpu_torch.obs.lineage import component_order
from dvf_tpu_torch.obs.trace import RECONFIG_PREFIX


def load_trace(path: str) -> dict:
    """Read one Chrome-trace JSON document (.pftrace / merged trace)."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome-trace document "
                         f"(no traceEvents)")
    return doc


def _lane_names(doc: dict) -> Dict[int, str]:
    names: Dict[int, str] = {}
    for e in doc.get("traceEvents", []):
        if e.get("ph") == "M" and e.get("name") == "process_name":
            names[int(e.get("pid", 0))] = (e.get("args") or {}).get(
                "name", str(e.get("pid")))
    return names


def lane_utilization(doc: dict) -> List[dict]:
    """Per-pid-lane busy/wall statistics over the document's 'X' spans
    ('i' instants count events but no busy time)."""
    names = _lane_names(doc)
    lanes: Dict[int, dict] = {}
    for e in doc.get("traceEvents", []):
        ph = e.get("ph")
        if ph not in ("X", "i"):
            continue
        pid = int(e.get("pid", 0))
        row = lanes.setdefault(pid, {
            "pid": pid, "lane": names.get(pid, str(pid)),
            "events": 0, "busy_us": 0, "t0": None, "t1": None})
        row["events"] += 1
        ts = int(e.get("ts", 0))
        end = ts + int(e.get("dur", 0)) if ph == "X" else ts
        if ph == "X":
            row["busy_us"] += int(e.get("dur", 0))
        row["t0"] = ts if row["t0"] is None else min(row["t0"], ts)
        row["t1"] = end if row["t1"] is None else max(row["t1"], end)
    out = []
    for pid in sorted(lanes):
        row = lanes[pid]
        span_us = ((row["t1"] - row["t0"])
                   if row["t0"] is not None else 0)
        out.append({
            "lane": row["lane"],
            "pid": pid,
            "events": row["events"],
            "busy_ms": round(row["busy_us"] / 1e3, 3),
            "span_ms": round(span_us / 1e3, 3),
            # Busy fraction of the lane's own active window; overlapping
            # spans on one lane can push it past 1 — that too is signal
            # (concurrent work sharing a lane).
            "utilization": (round(row["busy_us"] / span_us, 4)
                            if span_us > 0 else None),
        })
    return out


def slowest_spans(doc: dict, k: int = 10) -> List[dict]:
    names = _lane_names(doc)
    spans = [e for e in doc.get("traceEvents", [])
             if e.get("ph") == "X" and e.get("dur")]
    spans.sort(key=lambda e: -int(e.get("dur", 0)))
    out = []
    for e in spans[:k]:
        pid = int(e.get("pid", 0))
        out.append({
            # A nameless 'X' event is legal Chrome-trace JSON (device
            # traces emit them); render as "?" rather than None so the
            # text formatter never sees a non-string.
            "name": e.get("name") or "?",
            "lane": names.get(pid, str(pid)),
            "dur_ms": round(int(e.get("dur", 0)) / 1e3, 3),
            "ts_ms": round(int(e.get("ts", 0)) / 1e3, 3),
            **({"args": e["args"]} if e.get("args") else {}),
        })
    return out


def trace_reconfigurations(doc: dict, k: int = 32) -> List[dict]:
    """Reconfiguration events from a trace's dedicated ledger lane
    (``reconfig:*`` spans, stamped at record time by obs.ledger) — the
    most recent ``k``, newest last. Lets a bare ``.pftrace`` show the
    ledger story even without a dump's ``ledger.json``."""
    out = []
    for e in doc.get("traceEvents", []):
        name = str(e.get("name", ""))
        if e.get("ph") != "X" or not name.startswith(RECONFIG_PREFIX):
            continue
        args = e.get("args") or {}
        out.append({
            "kind": name[len(RECONFIG_PREFIX):],
            "ts_ms": round(int(e.get("ts", 0)) / 1e3, 3),
            "dur_ms": round(int(e.get("dur", 0)) / 1e3, 3),
            **{kk: args[kk] for kk in sorted(args)},
        })
    out.sort(key=lambda r: r["ts_ms"])
    return out[-k:]


def ledger_events(ledger_doc: dict, k: int = 32) -> List[dict]:
    """The most recent ``k`` events of one ``ledger.json`` document,
    oldest first — what a dump summary renders inline with the lanes."""
    events = list(ledger_doc.get("events") or [])
    return events[-k:]


def summarize_trace(path: str, top: int = 10) -> dict:
    doc = load_trace(path)
    out = {
        "trace": path,
        "events": len([e for e in doc.get("traceEvents", [])
                       if e.get("ph") != "M"]),
        "lanes": lane_utilization(doc),
        "slowest_spans": slowest_spans(doc, top),
    }
    reconf = trace_reconfigurations(doc)
    if reconf:
        out["reconfigurations"] = reconf
    if doc.get("dvfTraceLanes"):
        out["sources"] = doc["dvfTraceLanes"]
    return out


def slowest_lineages(lineage_doc: dict, k: int = 10) -> List[dict]:
    """Top-K exemplar frames by end-to-end latency, each with its
    additive decomposition rendered in hop order."""
    exemplars = list(lineage_doc.get("exemplars") or [])
    exemplars.sort(key=lambda r: -(r.get("total_ms") or 0.0))
    out = []
    for rec in exemplars[:k]:
        comps = rec.get("components") or {}
        out.append({
            "session": rec.get("session"),
            "index": rec.get("index"),
            "total_ms": rec.get("total_ms"),
            "breach": rec.get("breach"),
            "slo_ms": rec.get("slo_ms"),
            "components": {kk: comps[kk] for kk in
                           sorted(comps, key=component_order)},
        })
    return out


def summarize_dump(dump_dir: str, top: int = 10) -> dict:
    """Summary of one FlightRecorder dump directory: trigger metadata,
    the merged trace's lanes/spans, and the slowest exemplar lineages.
    Every artifact is optional (dumps are best-effort)."""
    out: dict = {"dump": dump_dir}
    meta_path = os.path.join(dump_dir, "meta.json")
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                out["meta"] = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
    trace_path = os.path.join(dump_dir, "trace.pftrace")
    if os.path.exists(trace_path):
        try:
            out.update({k: v for k, v in
                        summarize_trace(trace_path, top).items()
                        if k != "trace"})
        except (OSError, ValueError, json.JSONDecodeError):
            pass
    lin_path = os.path.join(dump_dir, "lineage.json")
    if os.path.exists(lin_path):
        try:
            with open(lin_path) as f:
                lin = json.load(f)
        except (OSError, json.JSONDecodeError):
            lin = None
        if lin:
            out["lineages"] = slowest_lineages(lin, top)
            expl = (lin.get("explain") or {}).get("text")
            if expl:
                out["explain"] = expl
    led_path = os.path.join(dump_dir, "ledger.json")
    if os.path.exists(led_path):
        try:
            with open(led_path) as f:
                led = json.load(f)
        except (OSError, json.JSONDecodeError):
            led = None
        if led:
            # The dump's authoritative event list (carries stall_ms the
            # trace spans cannot) wins over the trace-lane extraction.
            out["reconfigurations"] = ledger_events(led)
            out["ledger"] = {k: led.get(k) for k in
                             ("events_total", "stall_events_total",
                              "stall_ms_total", "by_kind", "by_cause")}
    aud_path = os.path.join(dump_dir, "audit.json")
    if os.path.exists(aud_path):
        try:
            with open(aud_path) as f:
                aud = json.load(f)
        except (OSError, json.JSONDecodeError):
            aud = None
        if aud:
            out["audit"] = {k: aud.get(k) for k in (
                "replays_sampled_total", "replay_mismatches_total",
                "swap_guards_total", "swap_guard_mismatches_total",
                "confirmed_corruptions_total", "wire_mismatches_total",
                "checks_total", "divergences_total",
                "quarantined_total") if aud.get(k) is not None}
            out["audit_events"] = list(aud.get("events") or [])[-top:]
    return out


def summarize(path: str, top: int = 10) -> dict:
    """File → trace summary; directory → dump summary."""
    if os.path.isdir(path):
        return summarize_dump(path, top)
    return summarize_trace(path, top)


def render_text(summary: dict) -> str:
    """The human view of one summary."""
    lines: List[str] = []
    meta = summary.get("meta")
    if meta:
        lines.append(f"dump: {summary.get('dump')}")
        lines.append(f"  trigger: {meta.get('reason')}")
        lines.append(f"  at: {meta.get('utc')}  pid: {meta.get('pid')}")
    elif summary.get("trace"):
        lines.append(f"trace: {summary['trace']}")
    if summary.get("explain"):
        lines.append(f"attribution: {summary['explain']}")
    lanes = summary.get("lanes")
    if lanes:
        lines.append("")
        lines.append(f"{'lane':<32} {'events':>7} {'busy_ms':>10} "
                     f"{'span_ms':>10} {'util':>6}")
        for row in lanes:
            util = (f"{row['utilization']:.0%}"
                    if row.get("utilization") is not None else "-")
            lines.append(f"{row['lane']:<32} {row['events']:>7} "
                         f"{row['busy_ms']:>10.1f} {row['span_ms']:>10.1f} "
                         f"{util:>6}")
    spans = summary.get("slowest_spans")
    if spans:
        lines.append("")
        lines.append("slowest spans:")
        for s in spans:
            lines.append(f"  {s['dur_ms']:>9.2f} ms  {s['name']:<20} "
                         f"[{s['lane']}] @ {s['ts_ms']:.1f} ms")
    reconf = summary.get("reconfigurations")
    if reconf:
        lines.append("")
        led = summary.get("ledger") or {}
        head = "reconfiguration events"
        if led.get("events_total") is not None:
            head += (f" ({led['events_total']} total, "
                     f"{led.get('stall_events_total', 0)} with stalls, "
                     f"{led.get('stall_ms_total', 0):.0f} ms stalled)")
        lines.append(head + ":")
        for ev in reconf:
            kind = ev.get("kind", "?")
            cause = ev.get("cause")
            what = f"{kind}" + (f"/{cause}" if cause else "")
            where = ev.get("bucket") or ev.get("signature") \
                or ev.get("replica") or ""
            bits = []
            for key, unit in (("wall_ms", "ms"), ("compile_ms", "ms c"),
                              ("stall_ms", "ms stall")):
                v = ev.get(key)
                if v is not None:
                    bits.append(f"{v:.1f} {unit}")
            cache = ev.get("cache")
            if cache:
                bits.append(f"cache {cache}")
            lines.append(f"  {what:<28} {where:<32} {', '.join(bits)}")
    audit = summary.get("audit")
    if audit is not None:
        lines.append("")
        parts = [f"{k.replace('_total', '')}={v}"
                 for k, v in audit.items()]
        lines.append("audit verdicts: " + (", ".join(parts) or "(none)"))
        for ev in summary.get("audit_events") or []:
            kind = ev.get("kind", "?")
            verdict = ev.get("verdict", "")
            where = (ev.get("bucket") or ev.get("signature")
                     or ev.get("session") or "")
            bits = []
            if ev.get("swap_kind"):
                bits.append(ev["swap_kind"])
            if ev.get("session") is not None and ev.get("index") is not None:
                bits.append(f"{ev['session']}#{ev['index']}")
            if ev.get("max_abs_diff") is not None:
                bits.append(f"maxdiff {ev['max_abs_diff']:g}")
            if ev.get("divergent"):
                bits.append(f"divergent {','.join(ev['divergent'])}")
            lines.append(f"  {kind:<18} {verdict:<12} {where:<32} "
                         f"{', '.join(bits)}")
    lineages = summary.get("lineages")
    if lineages:
        lines.append("")
        lines.append("slowest frame lineages:")
        for r in lineages:
            badge = " SLO-BREACH" if r.get("breach") else ""
            comps = ", ".join(f"{k}={v:.1f}" for k, v in
                              (r.get("components") or {}).items())
            lines.append(f"  {r['total_ms']:>9.2f} ms  "
                         f"{r['session']}#{r['index']}{badge}  ({comps})")
    if len(lines) <= 1 and not lanes:
        lines.append("(no events)")
    return "\n".join(lines)
