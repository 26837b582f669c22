"""Structured event tracing: the run's timeline (own copy of
``gan_deeplearning4j_tpu/telemetry/events.py``, stdlib only).

``ingraph.py`` says what the numerics did; this says WHAT HAPPENED WHEN.
Every notable host-side happening (an alarm, a rollback, a watchdog
timeout, a recovery restart, the run's start and end) is a structured
event with monotonic AND wall timestamps, thread and host labels, and
arbitrary attributes (usually ``step``).  The records carry the JAX
package's fields, so each package's ``read_events`` reads the other's
``events.jsonl``.

Three consumers, one recorder:

* ``events.jsonl``: the append-only per-run log (one JSON object per
  line) that tools tail, overlay (``marker_records``) or post-process.
* a bounded in-memory ring of recent events, the **flight recorder**.
  ``dump_flight_record`` writes it (in-flight spans marked) next to a
  crash artifact, so a NaN snapshot, a rollback, a watchdog timeout and a
  recovery restart each carry the timeline that led to them.  The ring
  costs a deque append per event, so it is ALWAYS on, even when no
  ``events.jsonl`` is configured.
* ``export_chrome_trace``: Chrome-trace JSON of the same events,
  optionally merged with a ``torch.profiler`` capture
  (``utils/profiling.maybe_trace``) so host events and the card's kernels
  line up in one Perfetto view.

Overhead: an event is two ``perf_counter`` reads, a dict, a deque append
and (file-backed only) a buffered line; no device contact, no background
thread.

Instrumented code calls the MODULE-LEVEL ``span``/``instant``, which
forward to the currently installed recorder (``install``/``recording``):
a trainer installs its run's file-backed recorder for the duration of
``train()`` (``train/shell.py``), and everything it calls lands in the
right file without any plumbing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Union

EVENTS_NAME = "events.jsonl"

# marker vocabulary shared by the plot/live-UI overlays: event name ->
# (legend label, color).  Only events that carry a ``step`` attribute
# can be placed on a step axis.
MARKER_EVENTS = {
    "checkpoint.save": ("checkpoint", "#1baf7a"),
    "checkpoint.emergency": ("emergency save", "#eda100"),
    "preempt.exit": ("preemption", "#4a3aa7"),
    "recovery.restart": ("restart", "#e87ba4"),
    "alarm.nan": ("nan alarm", "#e34948"),
    "alarm.divergence": ("divergence", "#c2571a"),
    "watchdog.timeout": ("watchdog timeout", "#7a1f1f"),
    "rollback.restore": ("rollback", "#8338ec"),
    # the JAX package's recompile sentinel and elastic reshard markers,
    # kept so that the vocabulary, and ``marker_records``, are the same
    # in both packages
    "compile.recompile": ("recompile", "#b5651d"),
    "reshard.restore": ("reshard", "#2b6cb0"),
}


def marker_records(event_dicts) -> List[Dict]:
    """Filter raw event dicts down to the step-anchored overlay markers
    (the JAX package's plot and live-UI mapping):
    ``[{"step", "name", "label", "color"}]``."""
    out = []
    for ev in event_dicts:
        meta = MARKER_EVENTS.get(ev.get("name"))
        if meta is None or not isinstance(ev.get("step"), (int, float)):
            continue
        out.append({"step": ev["step"], "name": ev["name"],
                    "label": meta[0], "color": meta[1]})
    return out


def _host_label() -> str:
    try:
        import platform

        return f"{platform.node()}:{os.getpid()}"
    except Exception:
        return str(os.getpid())


class EventRecorder:
    """Low-overhead span/instant recorder (see module docstring).

    ``path``: append events as JSONL there (None = ring only).
    ``ring_size``: flight-recorder depth.  ``append=True`` continues an
    existing file (a resumed run keeps its pre-crash timeline, the same
    discipline as the metrics JSONL); default truncates — one file per
    run.  ``enabled=False`` turns the instance into a near-no-op (the
    A/B baseline for the overhead budget).  Thread-safe: checkpoint and
    prefetch workers record concurrently with the training thread."""

    def __init__(self, path: Optional[str] = None, ring_size: int = 256,
                 run_id: Optional[str] = None, flush_every: int = 32,
                 enabled: bool = True, append: bool = False):
        self.path = path
        self.run_id = run_id
        self.enabled = enabled
        self.host = _host_label()
        self.flush_every = flush_every
        self._lock = threading.RLock()
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._ring: "deque" = deque(maxlen=ring_size)
        self._pending: List[str] = []
        self._file = None
        self._header_written = False
        if path and enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._file = open(path, "a" if append else "w")
            # a continued file gets a FRESH header too: each
            # incarnation has its own monotonic anchor, and a reader
            # segments the file at every header so each incarnation's
            # events anchor to its own wall clock

    # -- recording ------------------------------------------------------------

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _event(self, name: str, ph: str, attrs: Dict) -> Dict:
        ev = {"name": name, "ph": ph, "t": round(self._now(), 6),
              "wall": round(time.time(), 6),
              "thread": threading.current_thread().name}
        if attrs:
            ev.update(attrs)
        with self._lock:
            self._ring.append(ev)
        return ev

    @contextmanager
    def span(self, name: str, **attrs):
        """Timed region.  The event enters the ring at OPEN (so an
        in-flight span is visible to the flight recorder) and gains
        ``dur`` — plus ``error`` if the body raised — at close, when it
        is also written to the JSONL."""
        if not self.enabled:
            yield None
            return
        ev = self._event(name, "X", attrs)
        try:
            yield ev
        except BaseException as e:
            ev["error"] = repr(e)
            raise
        finally:
            ev["dur"] = round(self._now() - ev["t"], 6)
            self._write(ev)

    def instant(self, name: str, **attrs) -> Optional[Dict]:
        """Point-in-time event."""
        if not self.enabled:
            return None
        ev = self._event(name, "i", attrs)
        self._write(ev)
        return ev

    def complete(self, name: str, dur: float,
                 t_start: Optional[float] = None,
                 **attrs) -> Optional[Dict]:
        """Already-timed span: a ph="X" event whose duration the
        caller measured itself (``time.perf_counter`` seconds).  This
        is how pipelined stages record — the serving engine learns a
        batch's dispatch time one cycle AFTER the dispatch, so the
        span cannot be an open ``with`` block.  ``t_start`` (a raw
        ``perf_counter`` value) back-dates the event to when the work
        actually began; ``wall`` is derived from the recorder's own
        anchor so merged timelines stay on one clock."""
        if not self.enabled:
            return None
        t = ((t_start - self._t0) if t_start is not None
             else self._now() - dur)
        ev = {"name": name, "ph": "X", "t": round(t, 6),
              "wall": round(self._wall0 + t, 6),
              "thread": threading.current_thread().name,
              "dur": round(float(dur), 6)}
        if attrs:
            ev.update(attrs)
        with self._lock:
            self._ring.append(ev)
        self._write(ev)
        return ev

    def adopt(self, other: "EventRecorder") -> None:
        """Record ``other``'s ring here, its monotonic times moved onto this
        recorder's clock (events met before this recorder existed: a
        trainer's set-up, recorded in a ring of its own)."""
        shift = other._t0 - self._t0
        for ev in other.recent():
            ev["t"] = round(ev["t"] + shift, 6)
            with self._lock:
                self._ring.append(ev)
            self._write(ev)

    def _write(self, ev: Dict) -> None:
        if self._file is None:
            return
        with self._lock:
            self._pending.append(json.dumps(ev, default=str))
            if len(self._pending) >= self.flush_every:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if self._pending and self._file is not None:
            if not self._header_written:
                # header line, deferred to the first flush so it carries
                # a run_id set AFTER construction; the run metadata lives
                # here once, keeping per-event lines small
                self._header_written = True
                self._file.write(json.dumps(
                    {"name": "recorder.start", "ph": "i", "t": 0.0,
                     "wall": round(self._wall0, 6),
                     "run_id": self.run_id, "host": self.host}) + "\n")
            self._file.write("\n".join(self._pending) + "\n")
            self._file.flush()
            self._pending = []

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        """Flush and close the file sink; the ring (and the flight
        recorder) stay readable — a post-run failure handler can still
        dump the timeline."""
        with self._lock:
            self._flush_locked()
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "EventRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- flight recorder ------------------------------------------------------

    def recent(self) -> List[Dict]:
        """Snapshot of the ring, oldest first.  Spans still open carry
        no ``dur`` — they are the "what was in flight" signal."""
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def dump_flight_record(self, directory: str, reason: str,
                           extra: Optional[Dict] = None) -> str:
        """Write ``flight_record_{reason}.json`` under ``directory``:
        the recent-event ring plus run metadata, fsynced (a crash dump
        that does not survive the crash recorded nothing).  Returns the
        path; never raises (the dump must not mask the failure being
        dumped)."""
        events = self.recent()
        for ev in events:
            if ev.get("ph") == "X" and "dur" not in ev:
                ev["in_flight"] = True
        payload = {
            "reason": reason,
            "run_id": self.run_id,
            "host": self.host,
            "wall": round(time.time(), 6),
            "events": events,
        }
        if extra:
            payload.update(extra)
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in reason)
        path = os.path.join(directory, f"flight_record_{safe}.json")
        try:
            os.makedirs(directory, exist_ok=True)
            with open(path, "w") as f:
                json.dump(payload, f, indent=1, default=str)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            return path  # a read-only res dir must not mask the crash
        return path


# -- the installed recorder ---------------------------------------------------

# ring-only default: flight records work even before any run configures
# a file-backed recorder
_DEFAULT = EventRecorder()
_current: EventRecorder = _DEFAULT


def current() -> EventRecorder:
    return _current


def install(recorder: Optional[EventRecorder]) -> EventRecorder:
    """Make ``recorder`` the target of the module-level ``span``/
    ``instant``/``dump_flight_record``; returns the PREVIOUS recorder so
    callers can restore it (None restores the ring-only default)."""
    global _current
    prev = _current
    _current = recorder if recorder is not None else _DEFAULT
    return prev


@contextmanager
def recording(recorder: EventRecorder):
    """Install ``recorder`` for the duration of the block, then restore
    the previous one and close the file sink."""
    prev = install(recorder)
    try:
        yield recorder
    finally:
        install(prev)
        recorder.close()


def span(name: str, **attrs):
    return _current.span(name, **attrs)


def instant(name: str, **attrs):
    return _current.instant(name, **attrs)


def complete(name: str, dur: float, t_start: Optional[float] = None,
             **attrs):
    return _current.complete(name, dur, t_start=t_start, **attrs)


def dump_flight_record(directory: str, reason: str,
                       extra: Optional[Dict] = None) -> str:
    return _current.dump_flight_record(directory, reason, extra)


# -- chrome trace export ------------------------------------------------------


def read_events(path: str) -> List[Dict]:
    """Load an ``events.jsonl`` (malformed lines skipped — the file may
    be mid-append when read)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:  # the file may be mid-append
                continue
    return out


def export_chrome_trace(source: Union[str, List[Dict], EventRecorder],
                        out_path: str,
                        trace_dir: Optional[str] = None) -> str:
    """Write a Chrome-trace JSON of the recorded host events (wall-clock
    microseconds, one track per thread; spans as ``X``, instants as
    ``i``); with ``trace_dir``, MERGE the ``torch.profiler`` capture under
    it (``utils/profiling.maybe_trace``), so host spans and the card's
    kernels share one Perfetto view.

    Alignment, in the JAX module's order: a capture already on the epoch
    (a torch trace's ``ts`` plus its ``baseTimeNanoseconds``, which the
    reader adds) is left unshifted; otherwise the ``host_anchor.json``
    sidecar ``maybe_trace`` drops into the capture directory (the wall
    clock at the capture's start), then a ``profiler.trace`` span in the
    events, then the earliest host event anchor the capture's first
    timestamp."""
    if isinstance(source, EventRecorder):
        events = source.recent()
    elif isinstance(source, str):
        events = read_events(source)
    else:
        events = list(source)
    events = [e for e in events if "wall" in e]

    trace: List[Dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": "host events (gan4j)"}},
    ]
    tids: Dict[str, int] = {}
    for ev in events:
        thread = str(ev.get("thread", "main"))
        if thread not in tids:
            tids[thread] = len(tids) + 1
            trace.append({"ph": "M", "pid": 1, "tid": tids[thread],
                          "name": "thread_name",
                          "args": {"name": thread}})
        args = {k: v for k, v in ev.items()
                if k not in ("name", "ph", "t", "wall", "dur", "thread")}
        entry = {"name": ev["name"], "pid": 1, "tid": tids[thread],
                 "ts": ev["wall"] * 1e6, "args": args}
        if ev.get("ph") == "X":
            entry["ph"] = "X"
            entry["dur"] = float(ev.get("dur", 0.0)) * 1e6
        else:
            entry["ph"] = "i"
            entry["s"] = "t"
        trace.append(entry)

    if trace_dir:
        from gan_deeplearning4j_tpu_torch.utils.profiling import (
            ANCHOR_NAME,
            _trace_events,
        )

        dev_events = [e for e in _trace_events(trace_dir)
                      if "ts" in e or e.get("ph") == "M"]
        ts_values = [e["ts"] for e in dev_events if "ts" in e]
        if ts_values:
            if min(ts_values) > 1e14:
                # already epoch-scale microseconds: one origin, no shift
                shift = 0.0
            else:
                anchor = None
                try:
                    with open(os.path.join(trace_dir, ANCHOR_NAME)) as f:
                        anchor = float(json.load(f)["wall_start"]) * 1e6
                except (OSError, ValueError, KeyError, TypeError):
                    pass  # falls back to the anchor span below
                if anchor is None:
                    for ev in events:
                        if ev.get("name") == "profiler.trace":
                            anchor = ev["wall"] * 1e6
                            break
                if anchor is None and events:
                    anchor = min(e["wall"] for e in events) * 1e6
                shift = ((anchor - min(ts_values))
                         if anchor is not None else 0.0)
            for e in dev_events:
                e = dict(e)
                if "ts" in e:
                    e["ts"] = e["ts"] + shift
                trace.append(e)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, f)
    return out_path
