"""Live training UI: a dashboard over the metrics JSONL (torch twin of
``gan_deeplearning4j_tpu/utils/live_ui.py``, stdlib only; the same page and
the same data for the same files).

A stdlib ``ThreadingHTTPServer`` on a background daemon thread tails the
run's metrics JSONL and serves an auto-refreshing loss dashboard: no
dependencies, no work on the training thread (the browser polls; the
server reads the file the trainer writes anyway).  ``/data`` is the
records, ``/events`` the step-anchored markers of the run's
``events.jsonl`` (checkpoints, preemption, restarts, alarms).

Use: ``--live-ui PORT`` on ``cv_main`` / ``insurance_main``, or::

    from gan_deeplearning4j_tpu_torch.utils.live_ui import serve_metrics
    stop = serve_metrics("outputs/run/mnist_metrics.jsonl", port=8080)
    ...
    stop()
"""

from __future__ import annotations

import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from gan_deeplearning4j_tpu_torch.telemetry.events import (
    EVENTS_NAME,
    marker_records,
)

_PAGE = """<!doctype html>
<html><head><title>gan4j live metrics</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 24px; }
 #meta { color: #555; margin-bottom: 12px; }
 #alarm { display: none; background: #c62828; color: #fff;
          padding: 8px 12px; margin-bottom: 12px; border-radius: 4px; }
 canvas { border: 1px solid #ccc; width: 100%; height: 300px; }
 h3 { margin: 18px 0 4px; }
 .key { display: inline-block; margin-right: 16px; }
 .swatch { display: inline-block; width: 12px; height: 12px;
           margin-right: 4px; vertical-align: middle; }
</style></head>
<body>
<h2>gan4j live metrics</h2>
<div id="alarm"></div>
<div id="meta">waiting for data&hellip;</div>
<h3>losses</h3>
<div id="legend-loss"></div>
<div id="legend-events"></div>
<canvas id="chart-loss" width="1200" height="300"></canvas>
<h3>numerics telemetry (grad/param norms, update ratios — log scale)</h3>
<div id="legend-tel"></div>
<canvas id="chart-tel" width="1200" height="300"></canvas>
<script>
const COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#8c564b",
                "#e377c2", "#7f7f7f", "#bcbd22", "#17becf", "#ff7f0e"];
async function tick() {
  try {
    const r = await fetch("/data");
    const recs = await r.json();
    let evs = [];
    try { evs = await (await fetch("/events")).json(); } catch (e) {}
    draw(recs, evs);
  } catch (e) { /* server gone: stop quietly */ }
  setTimeout(tick, 2000);
}
function drawMarkers(canvasId, legendId, recs, evs) {
  // run-event markers (checkpoints / preemption / restarts / NaN
  // alarms) from the run's events.jsonl, as dashed vertical lines
  const c = document.getElementById(canvasId);
  const ctx = c.getContext("2d");
  const x0 = recs[0].step, x1 = recs[recs.length - 1].step || 1;
  const px = s => (s - x0) / Math.max(x1 - x0, 1) * (c.width - 40) + 30;
  let legend = "", seen = {};
  ctx.save();
  ctx.setLineDash([4, 4]);
  for (const ev of evs) {
    if (typeof ev.step !== "number") continue;
    ctx.strokeStyle = ev.color || "#999";
    ctx.globalAlpha = 0.6;
    ctx.beginPath();
    const x = px(ev.step);
    ctx.moveTo(x, 10); ctx.lineTo(x, c.height - 20);
    ctx.stroke();
    if (!seen[ev.label]) {
      seen[ev.label] = true;
      legend += `<span class="key"><span class="swatch" style=` +
        `"background:${ev.color || "#999"}"></span>${ev.label}</span>`;
    }
  }
  ctx.restore();
  document.getElementById(legendId).innerHTML = legend;
}
function drawSeries(canvasId, legendId, recs, keys, logScale) {
  const c = document.getElementById(canvasId);
  const ctx = c.getContext("2d");
  ctx.clearRect(0, 0, c.width, c.height);
  if (!keys.length) {  // e.g. a run without --telemetry
    document.getElementById(legendId).innerHTML =
      "<span class=\\"key\\" style=\\"color:#999\\">no such columns in " +
      "this run</span>";
    return;
  }
  const tx = logScale ? (v => v > 0 ? Math.log10(v) : NaN) : (v => v);
  let lo = Infinity, hi = -Infinity;
  for (const r of recs) for (const k of keys) {
    const v = tx(r[k]);
    if (typeof r[k] === "number" && isFinite(v)) {
      lo = Math.min(lo, v); hi = Math.max(hi, v);
    }
  }
  if (!(hi > lo)) { hi = lo + 1; }
  const last = recs[recs.length - 1];
  const x0 = recs[0].step, x1 = last.step || 1;
  const px = s => (s - x0) / Math.max(x1 - x0, 1) * (c.width - 40) + 30;
  const py = v => c.height - 20 -
                  (v - lo) / (hi - lo) * (c.height - 40);
  let legend = "";
  keys.forEach((k, i) => {
    ctx.strokeStyle = COLORS[i % COLORS.length];
    ctx.beginPath();
    let started = false;
    for (const r of recs) {
      const v = tx(r[k]);
      if (typeof r[k] !== "number" || !isFinite(v)) continue;
      const x = px(r.step), y = py(v);
      if (started) ctx.lineTo(x, y); else { ctx.moveTo(x, y); started = true; }
    }
    ctx.stroke();
    legend += `<span class="key"><span class="swatch" style=` +
      `"background:${COLORS[i % COLORS.length]}"></span>${k}</span>`;
  });
  document.getElementById(legendId).innerHTML = legend;
  ctx.fillStyle = "#333";
  const fmt = v => logScale ? "1e" + v.toFixed(1) : v.toFixed(3);
  ctx.fillText(fmt(hi), 2, 14);
  ctx.fillText(fmt(lo), 2, c.height - 8);
}
function draw(recs, evs) {
  if (!recs.length) return;
  const last = recs[recs.length - 1];
  document.getElementById("meta").textContent =
    `step ${last.step}` +
    (last.examples_per_sec ?
      ` — ${Math.round(last.examples_per_sec)} img/s` : "") +
    ` — ${recs.length} records`;
  // NaN panel: the telemetry counter, or a loss the server nulled
  // because it was non-finite, paints the banner with the first bad step
  let bad = null;
  for (const r of recs) {
    if ((typeof r.nonfinite === "number" && r.nonfinite > 0) ||
        ["d_loss", "g_loss", "classifier_loss"].some(
          k => k in r && r[k] === null)) { bad = r; break; }
  }
  const alarm = document.getElementById("alarm");
  if (bad) {
    alarm.style.display = "block";
    alarm.textContent = `NaN/Inf detected — first bad step ${bad.step}` +
      (typeof bad.nonfinite === "number" ?
        ` (${bad.nonfinite} non-finite values)` : "");
  } else { alarm.style.display = "none"; }
  const numKeys = Object.keys(last).filter(
    k => typeof last[k] === "number");
  drawSeries("chart-loss", "legend-loss", recs,
             numKeys.filter(k => k.endsWith("loss")), false);
  if (evs && evs.length) {
    drawMarkers("chart-loss", "legend-events", recs, evs);
  }
  drawSeries("chart-tel", "legend-tel", recs,
             numKeys.filter(k => k.endsWith("_norm") ||
                                 k.endsWith("_ratio")), true);
}
tick();
</script></body></html>
"""

MAX_POINTS = 2000  # downsample long runs so the payload stays small


class _TailCache:
    """Incremental JSONL tail: each poll parses only appended bytes (a
    long run's file would otherwise be re-parsed in full every 2s per
    open tab); a shrunken/replaced file resets the cache."""

    def __init__(self, path: str):
        self.path = path
        self.offset = 0
        self.partial = ""      # torn tail line carried to the next poll
        self.records: list = []

    def read(self) -> list:
        try:
            size = os.stat(self.path).st_size
        except OSError:
            return []
        if size < self.offset:  # truncated/replaced: start over
            self.offset, self.partial, self.records = 0, "", []
        if size > self.offset:
            with open(self.path) as f:
                f.seek(self.offset)
                chunk = self.partial + f.read()
                self.offset = f.tell()
            lines = chunk.split("\n")
            self.partial = lines.pop()  # "" on a clean newline boundary
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if "step" not in rec:
                    # step-less run-level records (the goodput summary)
                    # have no x coordinate on a step chart
                    continue
                # a diverged run writes NaN/Infinity, which json.dumps
                # would emit as INVALID JSON and permanently blank the
                # browser's fetch().json() — null them at parse time
                for k, val in rec.items():
                    if isinstance(val, float) and not math.isfinite(val):
                        rec[k] = None
                self.records.append(rec)
            if len(self.records) > 2 * MAX_POINTS:
                # bound the in-process cache too (the trainer hosts this
                # thread): halve by stride, keeping the exact last point
                self.records = (self.records[:-1][::2]
                                + self.records[-1:])
        records = self.records
        if len(records) > MAX_POINTS:
            stride = len(records) // MAX_POINTS + 1
            # keep the exact last point; avoid double-adding it when the
            # stride grid already lands on it
            records = records[:-1][::stride] + records[-1:]
        return records


def serve_metrics(jsonl_path: str, port: int = 8080,
                  host: str = "127.0.0.1") -> Callable[[], None]:
    """Start the dashboard server (daemon thread); returns a stop().

    When an ``events.jsonl`` (telemetry/events.py) sits next to the
    metrics file, ``/events`` serves its step-anchored marker events
    (checkpoints, preemption, restarts, NaN alarms) and the loss chart
    overlays them live."""
    cache = _TailCache(jsonl_path)
    events_cache = _TailCache(os.path.join(
        os.path.dirname(os.path.abspath(jsonl_path)), EVENTS_NAME))
    lock = threading.Lock()

    def marker_events() -> list:
        return marker_records(events_cache.read())

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path == "/data":
                with lock:  # ThreadingHTTPServer: one tail per poll
                    body = json.dumps(cache.read()).encode()
                ctype = "application/json"
            elif self.path == "/events":
                with lock:
                    body = json.dumps(marker_events()).encode()
                ctype = "application/json"
            else:
                body = _PAGE.encode()
                ctype = "text/html; charset=utf-8"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet: no stderr per request
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="gan4j-live-ui", daemon=True)
    thread.start()

    def stop() -> None:
        server.shutdown()
        server.server_close()

    stop.port = server.server_address[1]  # resolved port (0 = ephemeral)
    return stop


def serve_for_config(config, port: int) -> Callable[[], None]:
    """The mains' shared lifecycle: serve the trainer's metrics JSONL
    (gan_trainer.py's ``{dataset_name}_metrics.jsonl`` path) and announce
    the URL.  Returns stop() for the caller's finally block."""
    stop = serve_metrics(
        os.path.join(config.res_path,
                     f"{config.dataset_name}_metrics.jsonl"), port=port)
    print(f"[live-ui] http://127.0.0.1:{stop.port}/", flush=True)
    return stop
