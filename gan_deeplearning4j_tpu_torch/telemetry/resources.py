"""Continuous resource telemetry and the soak-mode leak gate (torch twin
of ``gan_deeplearning4j_tpu/telemetry/resources.py``, stdlib only).

The failure that kills long-running processes is monotone resource growth:
host RSS from a hoarded reference, device bytes from a leaked buffer, file
descriptors from an unclosed socket, threads from an unjoined worker.

* ``ResourceMonitor``: a named daemon sampler thread
  (``gan4j-resource-sampler``) reading host RSS (``/proc``), device bytes
  (``torch.cuda.memory_allocated``, only once CUDA is initialized), open
  fds and the thread count on a fixed interval into a bounded ring.
  ``report()`` is the feed of ``MetricsRegistry.observe_resources`` (the
  ``gan4j_resource_*`` gauges); ``samples()`` is the raw ring.
* ``leak_verdict``: a robust linear-trend test over the ring.  The slope
  estimator is Theil-Sen (median of pairwise slopes), which one GC spike
  or allocator step cannot drag the way least squares can; a resource
  leaks only when BOTH the slope and the absolute growth (median of the
  last samples minus median of the first, after the warm-up) clear their
  thresholds, so a one-time arena expansion does not fail the gate.

Thresholds are deliberately loose: RSS must grow faster than 512 KiB/s AND
by more than 32 MiB over the window.
"""

from __future__ import annotations

import os
import statistics
import sys
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

# -- gate thresholds (module constants so tests and docs can cite them) -----

MIN_SAMPLES = 8          # below this, no trend claim is honest
WARMUP_FRAC = 0.25       # drop the head: imports/compiles/arena growth
RSS_SLOPE_BYTES_PER_S = 512 << 10
RSS_GROWTH_BYTES = 32 << 20
DEVICE_SLOPE_BYTES_PER_S = 1 << 20
DEVICE_GROWTH_BYTES = 64 << 20
FD_GROWTH = 64
THREAD_GROWTH = 16

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def _rss_bytes() -> int:
    """Current resident set from /proc/self/statm (field 1, pages).
    0 where /proc is absent — the gate treats a flat 0 as clean."""
    try:
        with open("/proc/self/statm", "r") as f:
            return int(f.read().split()[1]) * _PAGE_SIZE
    except (OSError, ValueError, IndexError):
        return 0


def _open_fds() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return 0


def _device_bytes() -> int:
    """Bytes the caching allocator holds for tensors on every card.  Never
    initializes CUDA: a sampler thread must not be the first to touch the
    device, so this reads 0 until the process has used the card."""
    torch = sys.modules.get("torch")
    if torch is None:
        return 0
    try:
        if not torch.cuda.is_initialized():
            return 0
        return sum(int(torch.cuda.memory_allocated(i))
                   for i in range(torch.cuda.device_count()))
    except Exception:  # a context mid-teardown must not kill the sampler
        return 0


def sample_resources(t: float = 0.0,
                     device_fn: Optional[Callable[[], int]] = None) -> Dict:
    """One sample of all four tracked resources."""
    return {"t": float(t),
            "rss_bytes": _rss_bytes(),
            "device_bytes": (device_fn or _device_bytes)(),
            "open_fds": _open_fds(),
            "threads": threading.active_count()}


class ResourceMonitor:
    """Named daemon sampler thread feeding a bounded in-memory ring.

    ``interval_s`` trades resolution for overhead (each sample is a
    couple of /proc reads — microseconds); ``ring_size`` bounds
    memory so a days-long soak cannot itself become the leak."""

    def __init__(self, interval_s: float = 0.5, *,
                 ring_size: int = 4096,
                 device_fn: Optional[Callable[[], int]] = None):
        self.interval_s = float(interval_s)
        self._device_fn = device_fn
        self._ring: deque = deque(maxlen=int(ring_size))
        self._lock = threading.Lock()
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()
        self._samples_total = 0

    def sample_once(self) -> Dict:
        s = sample_resources(time.monotonic() - self._t0,
                             device_fn=self._device_fn)
        with self._lock:
            self._ring.append(s)
            self._samples_total += 1
        return s

    def _run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            self.sample_once()

    def start(self) -> "ResourceMonitor":
        with self._lock:
            if self._thread is not None:
                return self
            self._stop_evt.clear()
            thread = threading.Thread(target=self._run, daemon=True,
                                      name="gan4j-resource-sampler")
            self._thread = thread
        self.sample_once()  # a sample exists the moment start returns
        thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)  # join OUTSIDE the lock

    def __enter__(self) -> "ResourceMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def samples(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    def report(self) -> Dict:
        """Scrape feed for ``MetricsRegistry.observe_resources``:
        the LATEST sample plus ring bookkeeping."""
        with self._lock:
            latest = self._ring[-1] if self._ring else None
            total = self._samples_total
        if latest is None:
            latest = {"t": 0.0, "rss_bytes": 0, "device_bytes": 0,
                      "open_fds": 0, "threads": 0}
        return {"rss_bytes": latest["rss_bytes"],
                "device_bytes": latest["device_bytes"],
                "open_fds": latest["open_fds"],
                "threads": latest["threads"],
                "samples_total": total,
                "window_s": latest["t"],
                "ok": True}


# -- the leak gate -----------------------------------------------------------

def theil_sen_slope(ts: Sequence[float], vs: Sequence[float],
                    max_points: int = 200) -> float:
    """Median of pairwise slopes — robust to outlier spikes that
    would drag a least-squares fit.  Decimates evenly to
    ``max_points`` so a 4096-sample ring costs ~20k pairs, not 8M."""
    n = len(ts)
    if n < 2:
        return 0.0
    if n > max_points:
        step = n / max_points
        idx = [int(i * step) for i in range(max_points)]
        ts = [ts[i] for i in idx]
        vs = [vs[i] for i in idx]
        n = len(ts)
    slopes = []
    for i in range(n):
        for j in range(i + 1, n):
            dt = ts[j] - ts[i]
            if dt > 0:
                slopes.append((vs[j] - vs[i]) / dt)
    return statistics.median(slopes) if slopes else 0.0


def _growth(vs: Sequence[float]) -> float:
    """Median of the last k samples minus median of the first k —
    endpoint medians, so a single spike at either edge cannot fake
    (or hide) growth."""
    k = max(1, min(5, len(vs) // 4))
    return statistics.median(vs[-k:]) - statistics.median(vs[:k])


def leak_verdict(samples: Sequence[Dict], *,
                 warmup_frac: float = WARMUP_FRAC,
                 min_samples: int = MIN_SAMPLES,
                 rss_slope_bytes_per_s: float = RSS_SLOPE_BYTES_PER_S,
                 rss_growth_bytes: float = RSS_GROWTH_BYTES,
                 device_slope_bytes_per_s: float = DEVICE_SLOPE_BYTES_PER_S,
                 device_growth_bytes: float = DEVICE_GROWTH_BYTES,
                 fd_growth: int = FD_GROWTH,
                 thread_growth: int = THREAD_GROWTH) -> Dict:
    """Typed verdict over a sample ring (docstring at module top:
    Theil–Sen slope AND endpoint growth must both clear thresholds).

    fds and threads are integer-valued and step-shaped, so they gate
    on growth alone — a slope over a staircase means little."""
    n = len(samples)
    if n < min_samples:
        return {"ok": True, "type": "resource_leak",
                "reason": f"{n} samples < {min_samples}: "
                          "no trend claim", "samples": n,
                "window_s": 0.0, "leaking": [], "resources": {}}
    body = list(samples[int(n * warmup_frac):])
    ts = [float(s["t"]) for s in body]
    window_s = (ts[-1] - ts[0]) if len(ts) >= 2 else 0.0
    resources: Dict[str, Dict] = {}
    leaking: List[str] = []

    for key, slope_th, growth_th in (
            ("rss_bytes", rss_slope_bytes_per_s, rss_growth_bytes),
            ("device_bytes", device_slope_bytes_per_s,
             device_growth_bytes)):
        vs = [float(s.get(key) or 0) for s in body]
        slope = theil_sen_slope(ts, vs)
        growth = _growth(vs)
        leak = slope > slope_th and growth > growth_th
        resources[key] = {"slope_per_s": round(slope, 1),
                          "growth": round(growth, 1),
                          "slope_threshold": slope_th,
                          "growth_threshold": growth_th,
                          "leak": leak}
        if leak:
            leaking.append(key)

    for key, growth_th in (("open_fds", fd_growth),
                           ("threads", thread_growth)):
        vs = [float(s.get(key) or 0) for s in body]
        growth = _growth(vs)
        leak = growth > growth_th
        resources[key] = {"slope_per_s": round(theil_sen_slope(ts, vs), 3),
                          "growth": round(growth, 1),
                          "growth_threshold": growth_th,
                          "leak": leak}
        if leak:
            leaking.append(key)

    return {"ok": not leaking, "type": "resource_leak",
            "samples": n, "window_s": round(window_s, 3),
            "warmup_dropped": n - len(body),
            "leaking": leaking, "resources": resources}
