"""Request-scoped distributed tracing for the serving plane (torch twin of
``gan_deeplearning4j_tpu/telemetry/tracing.py``, a copy: the stdlib only).

The serving mesh is multi-PROCESS (client → gateway → mesh hops →
replica → engine) but the flight recorder (telemetry/events.py) is
per-process: each replica writes its own ``events.jsonl`` and no
signal crosses the wire.  This module is the Dapper-style answer:

* **Trace context** — a ``TraceContext(trace, span)`` pair.  The
  FIRST hop mints it (``GatewayClient`` for programmatic callers,
  ``Gateway`` for untraced ones, ``MeshRouter`` for direct mesh
  callers) and every later hop derives a child.  Span ids are
  pid-prefixed so two processes can never collide.
* **Wire format** — one header, ``X-Gan4j-Trace``, carrying
  ``trace=<id>;parent=<span>``.  The receiver parses it with
  ``from_header`` and children itself under the sender's span.
  Responses echo the header back (including typed error responses —
  shed/timeout requests must not vanish from merged timelines).  The
  header, the ids and the event fields are the JAX package's, so a
  request may cross processes of either package.
* **Spans on the one substrate** — stages are recorded as ordinary
  ``trace.*`` events on the installed ``EventRecorder`` carrying
  ``trace``/``span``/``parent`` attributes; no second sink, no new
  file format.  The vocabulary: client-side ``trace.client``/
  ``trace.wire_send``/``trace.wire_recv``, gateway-side
  ``trace.request``/``trace.rate_limit``/``trace.wire_recv``/
  ``trace.decode``/``trace.dispatch_wait``/``trace.response_encode``/
  ``trace.reject``, mesh-side ``trace.route``/``trace.hop``,
  engine-side ``trace.queue_wait``/``trace.coalesce``/
  ``trace.bucket_pad``/``trace.dispatch``/``trace.readback``.
* **trace_merge** — ``merge_trace_files`` joins per-process
  ``events.jsonl`` files into ONE timeline keyed by trace id.  A
  ``recorder.start`` header anchors each process-local monotonic
  clock (``t``) to wall time (``wall``); the merge normalizes every
  span to ``wall0 + t`` so spans from different hosts order correctly
  without assuming a shared monotonic epoch.  Files are SEGMENTED at
  every header: an appended multi-incarnation trainer file (resume
  after preemption) gets one anchor per incarnation, not one per
  file.  ``include_events=`` prefixes additionally ingest non-trace
  events (trainer lifecycle, control-plane decisions, chaos firings)
  into a flat wall-ordered ``timeline``.  ``python -m
  gan_deeplearning4j_tpu_torch.telemetry.tracing FILE... [--events
  PREFIX]`` is the CLI.

A trace tree is COMPLETE when it has exactly one root (a span with
no parent) and every other span's parent id resolves to a span in
the same trace.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
from contextlib import contextmanager
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence

from gan_deeplearning4j_tpu_torch.telemetry import events

# the one wire header
TRACE_HEADER = "X-Gan4j-Trace"

# response breakdown header (Server-Timing, RFC 8941 shaped)
TIMING_HEADER = "Server-Timing"

_SEQ = itertools.count(1)

_MAX_ID_LEN = 64  # reject absurd header payloads, not just garbage


class TraceContext(NamedTuple):
    """An immutable (trace id, current span id) pair.  Passing one
    across a hop means "parent yourself under my span"."""

    trace: str
    span: str


def new_trace_id() -> str:
    """128 bits would be Dapper-faithful; 64 is plenty for one mesh."""
    return os.urandom(8).hex()


def new_span_id() -> str:
    """Pid-prefixed counter: unique within a process by the counter,
    across processes by the pid."""
    return f"{os.getpid():x}-{next(_SEQ):x}"


def mint() -> TraceContext:
    """Start a new trace at this hop (this span is the root)."""
    return TraceContext(new_trace_id(), new_span_id())


def child(ctx: TraceContext) -> TraceContext:
    """Same trace, fresh span id — the receiver side of a hop."""
    return TraceContext(ctx.trace, new_span_id())


def to_header(ctx: TraceContext) -> str:
    return f"trace={ctx.trace};parent={ctx.span}"


def from_header(value: Optional[str]) -> Optional[TraceContext]:
    """Tolerant parse of ``trace=<id>;parent=<span>``.  Anything
    malformed returns None — an untraceable request is served, not
    rejected, and the gateway mints a fresh root for it."""
    if not value:
        return None
    fields = {}
    for part in value.split(";"):
        key, _, val = part.strip().partition("=")
        fields[key.strip()] = val.strip()
    trace, parent = fields.get("trace"), fields.get("parent")
    if not trace or not parent:
        return None
    if len(trace) > _MAX_ID_LEN or len(parent) > _MAX_ID_LEN:
        return None
    return TraceContext(trace, parent)


@contextmanager
def stage(ctx: TraceContext, name: str, **attrs) -> Iterator[TraceContext]:
    """Record ``name`` as a child span of ``ctx`` around the body;
    yields the child context for deeper nesting.  Thin sugar over
    ``events.span`` for call sites that do not need manual timing."""
    sub = child(ctx)
    with events.span(name, trace=sub.trace, span=sub.span,
                     parent=ctx.span, **attrs):
        yield sub


# -- trace_merge: the cross-process join ---------------------------------------

# event keys that are structure, not user attributes
_STRUCTURAL = ("name", "ph", "t", "wall", "thread", "dur",
               "trace", "span", "parent", "error", "status")


def _file_anchor(evs: List[Dict]) -> tuple:
    """(wall0, host) from the segment's ``recorder.start`` header line
    — the anchor that turns process-local monotonic ``t`` into a
    cross-process wall timestamp."""
    for ev in evs:
        if ev.get("name") == "recorder.start":
            return ev.get("wall"), ev.get("host")
    return None, None


def _segments(evs: List[Dict]) -> List[List[Dict]]:
    """Split one events file at EVERY ``recorder.start`` header.

    A trainer that resumes after preemption/crash APPENDS to its own
    ``events.jsonl`` (train/shell.py): one file then holds several
    incarnations, each a distinct process (the header's host is
    ``node:pid``) with its OWN monotonic epoch.  Anchoring the whole
    file on the first header would misplace every later incarnation's
    spans by the restart gap; per-segment anchors keep each
    incarnation wall-correct, so the merged timeline genuinely spans
    trainer incarnations and replica processes alike."""
    segs: List[List[Dict]] = []
    cur: List[Dict] = []
    for ev in evs:
        if ev.get("name") == "recorder.start" and cur:
            segs.append(cur)
            cur = []
        cur.append(ev)
    if cur:
        segs.append(cur)
    return segs


def merge_trace_files(paths: Sequence[str],
                      include_events: Sequence[str] = ()) -> Dict:
    """Join per-process events files into one timeline keyed by trace
    id.  Returns ``{"traces": {tid: {...}}, "timeline": [...],
    "stats": {...}}`` where each trace carries its wall-ordered spans,
    the process set it touched, and a completeness verdict (exactly
    one root + every parent resolves).

    ``include_events``: name PREFIXES (e.g. ``("fleet.", "publish.",
    "chaos.")``) of non-trace events to ingest into the flat
    wall-ordered ``"timeline"`` list — how trainer-side lifecycle
    events (``preempt.exit``), control-plane decisions and chaos
    firings join the serving spans into ONE contiguous cross-process
    story.  Files
    are segmented at every ``recorder.start`` header so appended
    multi-incarnation trainer files normalize correctly (see
    :func:`_segments`)."""
    prefixes = tuple(str(p) for p in include_events)
    spans: List[Dict] = []
    timeline: List[Dict] = []
    files_read = 0
    n_segments = 0
    for path in paths:
        try:
            evs = events.read_events(path)
        except OSError:
            # a replica that died before its first flush (SIGKILL) has
            # no file; the merge still joins the survivors
            continue
        files_read += 1
        for seg in _segments(evs):
            n_segments += 1
            wall0, host = _file_anchor(seg)
            for ev in seg:
                name = ev.get("name", "")
                t = ev.get("t")
                if wall0 is not None and isinstance(t, (int, float)):
                    wall = wall0 + t
                else:
                    wall = ev.get("wall")  # torn header: per-event clock
                if not name.startswith("trace."):
                    if prefixes and name.startswith(prefixes):
                        item = {"name": name,
                                "host": host or ev.get("host") or path,
                                "wall": wall}
                        if ev.get("error") is not None:
                            item["error"] = ev["error"]
                        extra = {k: v for k, v in ev.items()
                                 if k not in _STRUCTURAL}
                        if extra:
                            item["attrs"] = extra
                        timeline.append(item)
                    continue
                if "trace" not in ev or "span" not in ev:
                    continue
                span = {"name": name,
                        "trace": ev["trace"],
                        "span": ev["span"],
                        "parent": ev.get("parent"),
                        "host": host or ev.get("host") or path,
                        "wall": wall,
                        "dur": float(ev.get("dur") or 0.0)}
                if ev.get("error") is not None:
                    span["error"] = ev["error"]
                if ev.get("status") is not None:
                    span["status"] = ev["status"]
                extra = {k: v for k, v in ev.items()
                         if k not in _STRUCTURAL}
                if extra:
                    span["attrs"] = extra
                spans.append(span)
    timeline.sort(key=lambda e: (e["wall"] is None, e["wall"]))

    by_trace: Dict[str, List[Dict]] = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)

    traces: Dict[str, Dict] = {}
    stage_ms: Dict[str, List[float]] = {}
    n_complete = 0
    for tid, ss in by_trace.items():
        ss.sort(key=lambda s: (s["wall"] is None, s["wall"]))
        ids = {s["span"] for s in ss}
        roots = [s for s in ss if not s.get("parent")]
        resolved = all(
            (not s.get("parent")) or s["parent"] in ids for s in ss)
        complete = len(roots) == 1 and resolved
        if complete:
            n_complete += 1
        traces[tid] = {
            "spans": ss,
            "complete": complete,
            "root": roots[0]["name"] if len(roots) == 1 else None,
            "processes": sorted({s["host"] for s in ss}),
            "errors": [s["name"] for s in ss if s.get("error")],
        }
        for s in ss:
            stage_ms.setdefault(s["name"], []).append(s["dur"] * 1e3)

    total = len(traces)
    stats = {
        "files": files_read,
        "segments": n_segments,
        "spans": len(spans),
        "timeline_events": len(timeline),
        "timeline_processes": sorted({e["host"] for e in timeline}),
        "traces": total,
        "complete": n_complete,
        "complete_frac": (n_complete / total) if total else 0.0,
        "cross_process": sum(1 for t in traces.values()
                             if len(t["processes"]) >= 2),
        "errors": sum(len(t["errors"]) for t in traces.values()),
        "stage_p50_ms": {k: round(statistics.median(v), 3)
                         for k, v in sorted(stage_ms.items())},
    }
    return {"traces": traces, "timeline": timeline, "stats": stats}


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="trace_merge",
        description="Join per-process events.jsonl files into one "
                    "cross-process timeline keyed by trace id.")
    p.add_argument("files", nargs="+",
                   help="events.jsonl files (one per process)")
    p.add_argument("--out", default=None,
                   help="write the full merged document (traces + "
                        "stats) as JSON to PATH")
    p.add_argument("--trace", default=None,
                   help="print one trace id's merged spans instead "
                        "of the stats line")
    p.add_argument("--events", action="append", default=[],
                   metavar="PREFIX",
                   help="also ingest non-trace events whose name "
                        "starts with PREFIX into the flat timeline "
                        "(repeatable; e.g. --events fleet. --events "
                        "chaos.)")
    args = p.parse_args(argv)
    merged = merge_trace_files(args.files,
                               include_events=tuple(args.events))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
    if args.trace is not None:
        doc = merged["traces"].get(args.trace)
        if doc is None:
            print(f"no such trace: {args.trace}", file=sys.stderr)
            return 2
        print(json.dumps(doc, indent=1))
        return 0
    print(json.dumps(merged["stats"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
