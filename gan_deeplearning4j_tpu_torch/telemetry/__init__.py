"""Numerics, goodput and event telemetry (torch twin of
``gan_deeplearning4j_tpu/telemetry``):

* ``telemetry.ingraph``: model numerics computed INSIDE the training
  step (gradient/param norms, update ratios, NaN/Inf counters), riding
  the step's graph and its one readback as a few extra scalar outputs;
  the NaN alarm over the records they feed;
* ``telemetry.goodput``: host-side phase accounting that attributes every
  wall-clock second of a run to data-wait / dispatch / readback /
  checkpoint / eval / other, and the per-run ``run_manifest.json``;
* ``telemetry.events``: the structured event timeline (``events.jsonl``),
  the always-on flight recorder dumped beside every crash artifact, and
  the Chrome-trace export that merges a ``torch.profiler`` capture;
* ``telemetry.exporter``: the ``/metrics`` + ``/healthz`` scrape endpoint
  behind ``--metrics-port``, fed by the above and by
  ``telemetry.resources`` (host RSS, device bytes, fds, threads);
* ``telemetry.tracing``: request-scoped tracing across the serving
  plane's processes (the ``X-Gan4j-Trace`` header, ``trace.*`` spans on
  the events timeline) and ``merge_trace_files``, which joins the
  per-process ``events.jsonl`` files into one timeline.
"""

from gan_deeplearning4j_tpu_torch.telemetry import events, tracing
from gan_deeplearning4j_tpu_torch.telemetry.events import (
    EventRecorder,
    export_chrome_trace,
)
from gan_deeplearning4j_tpu_torch.telemetry.exporter import (
    MetricsRegistry,
    serve_exporter,
)
from gan_deeplearning4j_tpu_torch.telemetry.goodput import (
    GoodputTimer,
    write_run_manifest,
)
from gan_deeplearning4j_tpu_torch.telemetry.ingraph import (
    NanAlarm,
    NanAlarmError,
    count_nonfinite,
    graph_telemetry,
    tree_norm,
)
from gan_deeplearning4j_tpu_torch.telemetry.tracing import (
    TraceContext,
    merge_trace_files,
)

__all__ = ["GoodputTimer", "write_run_manifest", "NanAlarm",
           "NanAlarmError", "count_nonfinite", "graph_telemetry",
           "tree_norm", "events", "EventRecorder", "export_chrome_trace",
           "MetricsRegistry", "serve_exporter", "tracing", "TraceContext",
           "merge_trace_files"]
