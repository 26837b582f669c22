"""Numerics and event telemetry (torch twin of
``gan_deeplearning4j_tpu/telemetry``, its first slice):

* ``telemetry.ingraph``: model numerics computed INSIDE the training
  step (gradient/param norms, update ratios, NaN/Inf counters), riding
  the step's graph and its one readback as a few extra scalar outputs;
  the NaN alarm over the records they feed;
* ``telemetry.events``: the structured event timeline (``events.jsonl``)
  and the always-on flight recorder dumped beside every crash artifact.

The JAX package's goodput accounting, run manifest, resource sampling,
tracing and ``/metrics`` exporter are not ported yet (ROADMAP Queue 1
item 6.5).
"""

from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.telemetry.events import (
    EventRecorder,
    export_chrome_trace,
)
from gan_deeplearning4j_tpu_torch.telemetry.ingraph import (
    NanAlarm,
    NanAlarmError,
    count_nonfinite,
    graph_telemetry,
    tree_norm,
)

__all__ = ["NanAlarm", "NanAlarmError", "count_nonfinite", "graph_telemetry",
           "tree_norm", "events", "EventRecorder", "export_chrome_trace"]
