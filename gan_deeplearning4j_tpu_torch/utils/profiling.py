"""Tracing and profiling (torch twin of ``gan_deeplearning4j_tpu/utils/
profiling.py``): ``--profile DIR`` on the three mains.

``maybe_trace(dir)`` wraps a region in ``torch.profiler`` (CPU activity,
and CUDA activity when the card is there) and writes the capture into
``dir`` as a Chrome trace (``<host>.<pid>.pt.trace.json``, Perfetto- and
TensorBoard-loadable: host ops, kernel launches and the card's kernels,
copies and memsets, each kernel of a replayed CUDA graph on its own).
``summarize_trace(dir)`` lists the top time sinks of a capture, with their
counts, so a run can report where its step time went without leaving the
terminal; ``print_trace_summary`` also lists the port's own kernels
(``PORT_KERNELS``) with their counts, which are rarely among the top.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import re
import socket
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from gan_deeplearning4j_tpu_torch.telemetry import events

ANCHOR_NAME = "host_anchor.json"
# the device's work in a torch.profiler trace; a lane without categories
# (another profiler's capture) is a device lane by its name
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's own kernels (csrc/*.cu) by the device function a trace names
PORT_KERNELS = {"fused_update": "rmsprop_multi_kernel",
                "bn_act": "bn_act_kernel",
                "upsample_bwd": "upsample_bwd_kernel",
                "bn_moments": "bn_moments_kernel",
                "bn_apply": "bn_apply_kernel",
                "bn_act_4d": "bn_act_4d_kernel",
                # csrc/bn_act.cu tenant_stages<FwdPair<ACT>> / <BwdPair<ACT>>
                "bn_act_tenants": "FwdPair",
                "bn_act_tenants_bwd": "BwdPair"}
_DEVICE_CAT = re.compile(r'"cat"\s*:\s*"(?:%s)"' % "|".join(DEVICE_CATS))


class EmptyCaptureError(RuntimeError):
    """A capture of a run on the card recorded no device activity."""


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str], require_device: bool = False):
    """``torch.profiler`` over the block when a directory is given; a no-op
    (no cost) otherwise, so the flag can always be plumbed.

    Like the JAX module it drops a ``host_anchor.json`` sidecar (the wall
    clock at the capture's start) into ``trace_dir`` and records the region
    as a ``profiler.trace`` event span; ``events.export_chrome_trace(...,
    trace_dir=...)`` aligns the capture with the host events by them.  A
    torch trace carries its own epoch base (``baseTimeNanoseconds``), which
    the merge prefers.  ``require_device``: the run is on the card, so a
    capture with no device activity raises ``EmptyCaptureError`` when the
    block ends (a profile that silently holds only host lanes would be
    misread)."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    try:
        with open(os.path.join(trace_dir, ANCHOR_NAME), "w") as f:
            json.dump({"wall_start": time.time()}, f)
    except OSError:  # alignment falls back to the events; the capture runs
        pass
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(trace_dir,
                        f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")
    with events.span("profiler.trace", trace_dir=trace_dir):
        prof = profile(activities=activities)
        try:
            with prof:
                yield prof
        finally:
            # a run that raised (a preemption) still leaves its capture
            prof.export_chrome_trace(path)
    if require_device and not _has_device_work(path):
        raise EmptyCaptureError(
            f"the capture in {path} recorded no CUDA activity: "
            "torch.profiler saw none of the card's work")


def rank_trace_dir(root: Optional[str], group=None) -> Optional[str]:
    """Where a rank's capture goes: ``root`` at world 1, ``root/rank<r>``
    for rank r of a data group (None without ``--profile``)."""
    if not root or group is None:
        return root
    return os.path.join(root, f"rank{group.rank}")


def _has_device_work(path: str) -> bool:
    """Whether a torch capture holds a kernel, copy or memset: a scan of the
    file's text for their categories (a capture of a long run is hundreds
    of megabytes, which ``json`` takes seconds to parse)."""
    with open(path) as f:
        return _DEVICE_CAT.search(f.read()) is not None


def _load(path: str) -> List[dict]:
    """One capture's events; a torch trace's ``ts`` (microseconds from its
    ``baseTimeNanoseconds``) is moved to the epoch."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", [])
    base = doc.get("baseTimeNanoseconds")
    if base:
        shift = float(base) / 1e3
        evs = [dict(e, ts=e["ts"] + shift) if "ts" in e else e for e in evs]
    return evs


def _trace_events(trace_dir: str) -> List[dict]:
    """Every Chrome-trace event of the captures under ``trace_dir``."""
    paths = set()
    for pattern in ("*.trace.json", "*.trace.json.gz"):
        paths.update(glob.glob(os.path.join(trace_dir, "**", pattern),
                               recursive=True))
    out: List[dict] = []
    for path in sorted(paths):
        out.extend(_load(path))
    return out


def _is_device_lane(lane: str) -> bool:
    return any(k in lane.lower() for k in ("tpu", "/device", "gpu"))


def _is_device_event(ev: dict, lane: str) -> bool:
    if ev.get("ph") != "X":
        return False
    cat = ev.get("cat")
    if cat is not None:
        return cat in DEVICE_CATS
    return _is_device_lane(lane)


def _totals(evs: List[dict], device_only: bool) -> Dict[str, List]:
    """{event name: [total ms, count]} over a capture's duration events:
    the device's work when it has any and ``device_only``, else every
    lane."""
    pid_names: Dict = {}
    for ev in evs:
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pid_names[ev.get("pid")] = ev.get("args", {}).get("name", "")
    lanes = [(ev, str(pid_names.get(ev.get("pid"), ""))) for ev in evs
             if ev.get("ph") == "X" and "dur" in ev]
    have_device = any(_is_device_event(ev, lane) for ev, lane in lanes)
    totals: Dict[str, List] = defaultdict(lambda: [0.0, 0])
    for ev, lane in lanes:
        if (device_only and have_device
                and not _is_device_event(ev, lane)):
            continue
        row = totals[ev["name"]]
        row[0] += ev["dur"] / 1000.0  # us -> ms
        row[1] += 1
    return totals


def _top(totals: Dict[str, List], top: int) -> List[Tuple[str, float, int]]:
    return [(name, ms, n) for name, (ms, n) in
            sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]]


def summarize_trace(trace_dir: str, top: int = 10,
                    device_only: bool = True) -> List[Tuple[str, float, int]]:
    """Top-``top`` (event name, total milliseconds, count) sinks of a
    capture (the JAX function's rows, with the count).  ``device_only``
    keeps the device's work when the capture has any (drops the host
    lanes); a host-only capture falls back to every lane.  A replayed CUDA
    graph's kernels count one by one when the profiler traced them; a trace
    that shows only the graph launches counts those, and nothing it did not
    see."""
    return _top(_totals(_trace_events(trace_dir), device_only), top)


def port_kernel_rows(totals: Dict[str, List]) -> List[Tuple[str, float, int]]:
    """(port kernel, total ms, count) of each of ``PORT_KERNELS`` that a
    capture's totals hold."""
    rows = []
    for kernel, fn in PORT_KERNELS.items():
        hits = [row for name, row in totals.items() if fn in name]
        if hits:
            rows.append((kernel, sum(h[0] for h in hits),
                         sum(h[1] for h in hits)))
    return rows


def print_trace_summary(trace_dir: str, top: int = 10,
                        log=print) -> List[Tuple]:
    """The mains' ``--profile`` exit report: the capture's top time sinks
    with their counts, then the port's own kernels with theirs (they are
    rarely among the top), to ``log``.  Returns the top ``(name, ms,
    count)`` rows; never raises (a missing or empty capture must not fail
    the run that produced the real results)."""
    try:
        totals = _totals(_trace_events(trace_dir), True)
    except Exception as e:
        log(f"[profile] could not summarize {trace_dir}: {e!r}")
        return []
    rows = _top(totals, top)
    if not rows:
        log(f"[profile] no trace events captured under {trace_dir}")
        return rows
    log(f"[profile] top {len(rows)} time sinks ({trace_dir}):")
    for name, ms, n in rows:
        log(f"[profile]  {ms:12.3f} ms  {n:8d}x  {name}")
    port = port_kernel_rows(totals)
    if port:
        log("[profile] the port's kernels:")
        for kernel, ms, n in port:
            log(f"[profile]  {ms:12.3f} ms  {n:8d}x  {kernel}")
    return rows
