"""Structured training metrics (torch twin of ``MetricsLogger`` in
``gan_deeplearning4j_tpu/utils/metrics.py``).

Every step records D-loss, G-loss, classifier loss (and examples/sec where
the step's wall time means something) to an in-memory ring and an optional
JSONL file.  The port's trainer reads each call's [K, 3] losses back once,
so the logger takes host floats and writes on the training thread at each
flush; the JAX logger's background materialization of device arrays has
nothing to do here.  A record's keys come in the JAX file's order:
``step``, ``wall_s``, ``step_s``, then the metrics sorted by name (the
JAX logger's records pass through a pytree, which sorts dict keys); a
per-step record has all its keys sorted.

``on_record`` (the JAX logger's hook) observes every record as it is
flushed: the NaN alarm, the divergence sentinel and the scrape registry
ride it (``telemetry/ingraph.py``, ``train/divergence.py``,
``telemetry/exporter.py``), so they see a step at the flush cadence and
force no flush of their own.  ``log_record`` appends a run-level record
(the trainer's final ``{"goodput", "run_id"}``).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, flush_every: int = 100,
                 ring_size: int = 10000, append: bool = False,
                 on_record: Optional[Callable[[Dict], None]] = None):
        """``append``: a resumed run adds to the file it finds (one
        timeline; a reader de-duplicates by step, the last record
        winning); otherwise the file starts empty.  ``on_record``: called
        with each record when it is flushed, after it is written."""
        self.path = path
        self.flush_every = flush_every
        self._pending: List[Dict] = []
        self._records: "deque" = deque(maxlen=ring_size)
        self._t0 = time.perf_counter()
        self._last_step_t = self._t0
        self._on_record = on_record
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if not append:
                open(path, "w").close()  # one file per run

    def log_step(self, step: int, examples: int = 0, **metrics) -> None:
        """Record one step (``metrics``: host floats)."""
        now = time.perf_counter()
        rec = {"step": step, "wall_s": now - self._t0,
               "step_s": now - self._last_step_t}
        if examples:
            rec["examples_per_sec"] = examples / max(rec["step_s"], 1e-9)
        rec.update(metrics)
        self._last_step_t = now
        self._pending.append(dict(sorted(rec.items())))
        if len(self._pending) >= self.flush_every:
            self.flush()

    def log_chunk(self, start_step: int, n: int, examples: int,
                  metrics: Dict[str, Sequence[float]]) -> None:
        """Record ``n`` consecutive steps from one call: each metric is a
        length-``n`` sequence; the call's wall time is spread evenly over
        its steps."""
        now = time.perf_counter()
        step_s = (now - self._last_step_t) / n
        for k in range(n):
            r = {"step": start_step + k,
                 "wall_s": (self._last_step_t - self._t0) + (k + 1) * step_s,
                 "step_s": step_s}
            if examples:
                r["examples_per_sec"] = examples / max(step_s, 1e-9)
            for key in sorted(metrics):
                r[key] = float(metrics[key][k])
            self._pending.append(r)
        self._last_step_t = now
        if len(self._pending) >= self.flush_every:
            self.flush()

    def log_record(self, rec: Dict) -> None:
        """Append one step-less, run-level record (the goodput breakdown
        and the run id), its nested dicts' keys sorted as the JAX logger's
        pytree writes them."""
        def _sorted(v):
            return ({k: _sorted(v[k]) for k in sorted(v)}
                    if isinstance(v, dict) else v)

        self._pending.append(_sorted(dict(rec)))

    def flush(self) -> None:
        """Write the pending records to the file and the ring, then hand
        each to ``on_record``."""
        batch, self._pending = self._pending, []
        if not batch:
            return
        if self.path:
            with open(self.path, "a") as f:
                for rec in batch:
                    f.write(json.dumps(rec) + "\n")
        self._records.extend(batch)
        if self._on_record is not None:
            for rec in batch:
                self._on_record(rec)

    def close(self) -> None:
        self.flush()

    def records(self) -> List[Dict]:
        self.flush()
        return list(self._records)
