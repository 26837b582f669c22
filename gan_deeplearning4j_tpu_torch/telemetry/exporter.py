"""Live ``/metrics`` + ``/healthz`` endpoint: the scrape surface (torch
twin of ``gan_deeplearning4j_tpu/telemetry/exporter.py``, stdlib only; the
same series, the same text and the same health document for the same
feeds).

A stdlib ``ThreadingHTTPServer`` on a daemon thread serves

* ``/metrics``: Prometheus text format (version 0.0.4) rendered from a
  thread-safe counter/gauge registry;
* ``/healthz``: a small JSON liveness document (last-record age, run id,
  the feeds' blocks), 503 while the watchdog reports a stall.

The registry is fed from what the trainer already computes:
``MetricsLogger.on_record`` (every flushed step record updates the step,
loss and NaN series), the ``GoodputTimer`` phase totals (read at scrape
time), the watchdog's report, the data plane's ``DataHealth``, the data
group's size and the ``ResourceMonitor``.  The three mains expose it as
``--metrics-port`` (0 = ephemeral, the port is printed).  The serving
feeds take the serving plane's reports, as in the JAX package:
``observe_serve(engine.report)``, ``observe_gateway(gateway.report)``,
``observe_client(client.report)``, ``observe_serving_mesh(mesh.report)``
and ``observe_controlplane(controlplane.report)``.  The fleet trainer feeds
``observe_fleet`` (``train/fleet.py`` ``FleetTrainer``, whose
``--metrics-port`` serves it) and the checkpoint publisher
``observe_publication`` (``serve/publisher.py``
``CheckpointPublisher.report``); the lifecycle fleet's per-tenant series
stay at 0 until ``train/lifecycle.py`` is ported.

Metric names (all ``gan4j_``-prefixed):

  gan4j_steps_total            counter  flushed step records
  gan4j_step                   gauge    last step seen
  gan4j_nonfinite_total        counter  in-graph NaN/Inf counter sum
  gan4j_d_loss / gan4j_g_loss / gan4j_classifier_loss   gauges
  gan4j_examples_per_sec       gauge    last per-step throughput sample
  gan4j_goodput_seconds{phase} gauge    GoodputTimer phase totals
  gan4j_goodput_compute_fraction  gauge the dispatch share of wall
  gan4j_watchdog_*             the heartbeat's age, deadline, stall flag
                               and timeout count
  gan4j_data_retries_total     counter  transient-I/O retries
  gan4j_data_quarantined_total counter  corrupt records quarantined
  gan4j_data_last_error_age_seconds  gauge  age of the last data incident
  gan4j_mesh_devices           gauge    ranks of the data group
  gan4j_resource_*             gauges   RSS, device bytes, fds, threads
  gan4j_serve_* / gan4j_gateway_* / gan4j_client_* / gan4j_mesh_* /
  gan4j_controlplane_*         the serving plane's feeds (above)
  gan4j_fleet_* / gan4j_publish_*  the fleet's and the publisher's
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

_LOSS_GAUGES = ("d_loss", "g_loss", "classifier_loss", "examples_per_sec")


def _fmt(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


class MetricsRegistry:
    """Thread-safe counter/gauge registry with Prometheus text render.

    ``add_callback(fn)`` registers a scrape-time hook: ``fn(registry)``
    is called (under the registry lock — it may only ``set``/``inc``)
    at every ``render()``, so values that live elsewhere (the goodput
    ledger) are read when asked for, not mirrored on every step."""

    def __init__(self):
        self._lock = threading.RLock()
        # the headline counters exist at 0 from the first scrape — a
        # monitoring rule on gan4j_nonfinite_total must see the series
        # before the first (hopefully never) increment
        self._counters: Dict[Tuple[str, tuple], float] = {
            ("gan4j_steps_total", ()): 0.0,
            ("gan4j_nonfinite_total", ()): 0.0,
            ("gan4j_watchdog_timeouts_total", ()): 0.0,
            ("gan4j_rollback_total", ()): 0.0,
            ("gan4j_data_retries_total", ()): 0.0,
            ("gan4j_data_quarantined_total", ()): 0.0,
            # recompile sentinel (analysis/sanitizers.py): an alert
            # rule on this series must see it at 0 from the first
            # scrape — a recompile storm is exactly when a scrape
            # might not come back
            ("gan4j_recompiles_total", ()): 0.0,
            # elastic mesh (parallel/elastic.py): a reshard-on-restore
            # is rare by design, so the alert rule needs the series at
            # 0 long before the first one happens
            ("gan4j_reshard_total", ()): 0.0,
            # lockdep sanitizer (analysis/sanitizers.py): the inversion
            # counter must exist at 0 from the first scrape — an
            # inversion is exactly the event after which the next
            # scrape may never come — and the wait-time series is the
            # lock-contention trend an alert watches long before one
            ("gan4j_lock_inversions_total", ()): 0.0,
            ("gan4j_lock_wait_seconds_total", ()): 0.0,
            # serving plane (serve/engine.py): the request/shed
            # counters exist at 0 from the first scrape — the shed
            # alert rule must see the series before the first overload
            ("gan4j_serve_requests_total", ()): 0.0,
            ("gan4j_serve_shed_total", ()): 0.0,
            # network front door (serve/gateway.py): the wire-level
            # request/reject counters exist at 0 from the first scrape
            # — a reject alert rule must see the series before the
            # first abusive caller shows up
            ("gan4j_gateway_requests_total", ()): 0.0,
            ("gan4j_gateway_rejected_total", ()): 0.0,
            # serving mesh (serve/mesh.py): ejections exist at 0 from
            # the first scrape — an ejection alert rule must see the
            # series before the first replica dies
            ("gan4j_mesh_ejected_total", ()): 0.0,
            # control plane (serve/controlplane.py): scale/replace/
            # rollback counters exist at 0 from the first scrape — a
            # rollback alert is exactly the one that must not wait for
            # its first firing to learn the series name
            ("gan4j_controlplane_scale_events_total", ()): 0.0,
            ("gan4j_controlplane_replaced_total", ()): 0.0,
            ("gan4j_controlplane_rollbacks_total", ()): 0.0,
            # client keep-alive pool (serve/client.py): pool reuse /
            # stale-socket reconnects / retry counters exist at 0 from
            # the first scrape — a reconnect storm is a server-restart
            # signal an alert rule must already know the name of
            ("gan4j_client_reused_total", ()): 0.0,
            ("gan4j_client_reconnects_total", ()): 0.0,
            ("gan4j_client_retried_total", ()): 0.0,
            # checkpoint publication (serve/publisher.py): a rejected
            # checkpoint is exactly the event an alert rule exists for
            # — the series must be scrapeable before the first
            # poisoned checkpoint ever shows up
            ("gan4j_publish_rejected_total", ()): 0.0,
            ("gan4j_publish_promoted_total", ()): 0.0,
            # tenant lifecycle (train/lifecycle.py): quarantine is the
            # per-tenant fault-domain event an alert rule exists for —
            # all four lifecycle counters exist at 0 from the first
            # scrape, before the first onboard ever happens
            ("gan4j_fleet_tenant_quarantined_total", ()): 0.0,
            ("gan4j_fleet_tenant_onboarded_total", ()): 0.0,
            ("gan4j_fleet_tenant_offboarded_total", ()): 0.0,
            ("gan4j_fleet_tenant_throttled_total", ()): 0.0,
        }
        self._gauges: Dict[Tuple[str, tuple], float] = {
            # age since the last data-plane incident; 0 until one
            # happens (pre-created so alert rules see the series from
            # the first scrape, like the counters above)
            ("gan4j_data_last_error_age_seconds", ()): 0.0,
            # elastic-mesh surface: mesh size 0 = "no mesh formed yet";
            # the feed (observe_mesh) raises it to the live count
            ("gan4j_mesh_devices", ()): 0.0,
            ("gan4j_reshard_seconds", ()): 0.0,
            # multi-tenant fleet surface (train/fleet.py): 0 tenants =
            # "no fleet running"; the feed (observe_fleet) raises them —
            # pre-created like everything above so dashboards and alert
            # rules see the series from the first scrape
            ("gan4j_fleet_tenants", ()): 0.0,
            ("gan4j_fleet_steps_per_sec", ()): 0.0,
            ("gan4j_fleet_dispatch_ms", ()): 0.0,
            # tenant-lifecycle gauges (train/lifecycle.py): cohort
            # count, live quarantine count (per-tenant named series
            # appear labeled, e.g. ...{tenant="3"}), and the onboard
            # latency headline that lands next to tenants·steps/sec
            ("gan4j_fleet_cohorts", ()): 0.0,
            ("gan4j_fleet_tenant_quarantined", ()): 0.0,
            ("gan4j_fleet_onboard_latency_ms", ()): 0.0,
            # serving-plane gauges (serve/engine.py): 0 = "no engine
            # running"; the feed (observe_serve) raises them
            ("gan4j_serve_queue_depth", ()): 0.0,
            ("gan4j_serve_batch_fill", ()): 0.0,
            ("gan4j_serve_p99_ms", ()): 0.0,
            # gateway gauges (serve/gateway.py): 0 connections and 0
            # healthy replicas = "no gateway running"; the feed
            # (observe_gateway) raises them
            ("gan4j_gateway_active_connections", ()): 0.0,
            ("gan4j_gateway_replica_healthy", ()): 0.0,
            # serving-mesh gauges (serve/mesh.py — replica PROCESSES,
            # distinct from gan4j_mesh_devices, the elastic-training
            # device mesh): 0 replicas = "no mesh running"; the feed
            # (observe_serving_mesh) raises them
            ("gan4j_mesh_replicas", ()): 0.0,
            ("gan4j_mesh_replicas_healthy", ()): 0.0,
            # control-plane gauge: the fleet size the controller is
            # currently holding (observe_controlplane raises it)
            ("gan4j_controlplane_replicas", ()): 0.0,
            # resource telemetry (telemetry/resources.py): the soak
            # gauges exist at 0 from the first scrape — a leak trend
            # rule needs the series long before the monitor starts
            ("gan4j_resource_rss_bytes", ()): 0.0,
            ("gan4j_resource_device_bytes", ()): 0.0,
            ("gan4j_resource_open_fds", ()): 0.0,
            ("gan4j_resource_threads", ()): 0.0,
            # publication gauges (serve/publisher.py): last promoted
            # step and its age; 0 = "nothing published yet" — the feed
            # (observe_publication) raises them
            ("gan4j_publish_last_step", ()): 0.0,
            ("gan4j_publish_age_seconds", ()): 0.0,
        }
        self._callbacks: List[Callable[["MetricsRegistry"], None]] = []
        self.run_id: Optional[str] = None
        self._last_record_wall: Optional[float] = None
        # training-health feed (train/watchdog.py): a callable returning
        # the watchdog's report dict; drives the /healthz "stalled"
        # contract (503 once the heartbeat goes quiet past the deadline)
        # and the gan4j_watchdog_* series
        self._watchdog_fn: Optional[Callable[[], Optional[Dict]]] = None
        # data-plane feed (data/resilient.py DataHealth.report): drives
        # the gan4j_data_* series and the /healthz "data" block
        self._data_fn: Optional[Callable[[], Optional[Dict]]] = None
        # elastic-mesh feed (GANTrainer._mesh_report): drives the
        # gan4j_mesh_devices / gan4j_reshard_* series and the /healthz
        # "mesh" block (ok:false while mesh formation is quorum-blocked)
        self._mesh_fn: Optional[Callable[[], Optional[Dict]]] = None
        # fleet feed (train/fleet.FleetTrainer._fleet_report): drives
        # the gan4j_fleet_* series and the /healthz "fleet" block
        self._fleet_fn: Optional[Callable[[], Optional[Dict]]] = None
        # serving feed (serve/engine.ServeEngine.report): drives the
        # gan4j_serve_* series and the /healthz "serve" block
        self._serve_fn: Optional[Callable[[], Optional[Dict]]] = None
        # gateway feed (serve/gateway.Gateway.report): drives the
        # gan4j_gateway_* series and the /healthz "gateway" block
        self._gateway_fn: Optional[Callable[[], Optional[Dict]]] = None
        # serving-mesh feed (serve/mesh.MeshRouter.report): drives the
        # gan4j_mesh_replicas/ejected series and the /healthz
        # "serving_mesh" block (named to keep it distinct from the
        # elastic-training "mesh" block above)
        self._serving_mesh_fn: Optional[
            Callable[[], Optional[Dict]]] = None
        # control-plane feed (serve/controlplane.ControlPlane.report):
        # drives the gan4j_controlplane_* series and the /healthz
        # "controlplane" block (ok:false once a deploy goes fatal)
        self._controlplane_fn: Optional[
            Callable[[], Optional[Dict]]] = None
        # client feed (serve/client.GatewayClient.report): drives the
        # gan4j_client_* series
        self._client_fn: Optional[Callable[[], Optional[Dict]]] = None
        # resource feed (telemetry/resources.ResourceMonitor.report):
        # drives the gan4j_resource_* gauges and the /healthz
        # "resources" block
        self._resources_fn: Optional[
            Callable[[], Optional[Dict]]] = None
        # publication feed (serve/publisher.CheckpointPublisher.report):
        # drives the gan4j_publish_* series, the /healthz
        # "publication" block, and the top-level "serving_stale" flag
        # (true while the serving plane runs on old weights because no
        # fresh checkpoint has arrived / survived verification)
        self._publication_fn: Optional[
            Callable[[], Optional[Dict]]] = None

    @staticmethod
    def _key(name: str, labels: Optional[Dict]) -> Tuple[str, tuple]:
        return (name, tuple(sorted((labels or {}).items())))

    def inc(self, name: str, value: float = 1.0,
            labels: Optional[Dict] = None) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def set(self, name: str, value: float,
            labels: Optional[Dict] = None) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = float(value)

    def set_counter(self, name: str, value: float,
                    labels: Optional[Dict] = None) -> None:
        """Monotonic set: raise the counter to ``value`` if it is
        higher (for counters whose source of truth lives elsewhere —
        e.g. the rollback manager's lifetime count, mirrored at scrape
        time; a counter must never go backwards)."""
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = max(self._counters.get(k, 0.0),
                                    float(value))

    def add_callback(self, fn: Callable[["MetricsRegistry"], None]) -> None:
        with self._lock:
            self._callbacks.append(fn)

    # -- feeds ----------------------------------------------------------------

    def observe_record(self, rec: Dict) -> None:
        """``MetricsLogger.on_record`` hook: one materialized record
        (step or run-level) updates the scrape series.  Runs on the
        logger's worker thread — locking only, no I/O."""
        step = rec.get("step")
        with self._lock:
            self._last_record_wall = time.time()
            if step is None:
                return  # run-level record (goodput summary): no step axis
            self.inc("gan4j_steps_total")
            self.set("gan4j_step", step)
            for k in _LOSS_GAUGES:
                v = rec.get(k)
                if isinstance(v, (int, float)):
                    self.set(f"gan4j_{k}", v)
            nf = rec.get("nonfinite")
            if isinstance(nf, (int, float)) and math.isfinite(nf) and nf > 0:
                self.inc("gan4j_nonfinite_total", nf)

    def observe_goodput(self, report_fn: Callable[[], Optional[Dict]]) -> None:
        """Register the goodput feed: ``report_fn`` returns a
        ``GoodputTimer.report()`` dict (or None before the run starts);
        its phase totals become labeled gauges at scrape time."""

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            for k, v in rep.items():
                if k == "compute_fraction":
                    reg.set("gan4j_goodput_compute_fraction", v)
                elif isinstance(v, (int, float)) and k != "wall_s":
                    reg.set("gan4j_goodput_seconds", v,
                            labels={"phase": k})
            if "wall_s" in rep:
                reg.set("gan4j_goodput_wall_seconds", rep["wall_s"])

        self.add_callback(cb)

    def observe_watchdog(self, report_fn: Callable[[], Optional[Dict]]
                         ) -> None:
        """Register the hang-watchdog feed: ``report_fn`` returns a
        ``HeartbeatWatchdog.report()`` dict (last beat age, effective
        deadline, timeout count, stalled flag).  Scrapes mirror it into
        the ``gan4j_watchdog_*`` series, and ``/healthz`` answers 503 +
        ``"stalled": true`` while the heartbeat is quiet past the
        deadline — the liveness probe sees a hang the moment the
        watchdog does, without waiting for the process to die."""
        with self._lock:
            self._watchdog_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            age = rep.get("last_beat_age_s")
            if isinstance(age, (int, float)):
                reg.set("gan4j_watchdog_last_beat_age_seconds", age)
            deadline = rep.get("deadline_s")
            if isinstance(deadline, (int, float)):
                reg.set("gan4j_watchdog_deadline_seconds", deadline)
            reg.set("gan4j_watchdog_stalled",
                    1.0 if rep.get("stalled") else 0.0)
            reg.set_counter("gan4j_watchdog_timeouts_total",
                            float(rep.get("timeouts_total", 0)))

        self.add_callback(cb)

    def observe_data(self, report_fn: Callable[[], Optional[Dict]]) -> None:
        """Register the data-plane feed: ``report_fn`` returns a
        ``DataHealth.report()`` dict (data/resilient.py — retry and
        quarantine totals, last-incident age, budget verdict).  Scrapes
        mirror it into the ``gan4j_data_*`` series and ``/healthz``
        carries it as the ``"data"`` block, so a run chewing through
        its quarantine budget is visible BEFORE the budget-exhaustion
        fatality."""
        with self._lock:
            self._data_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            reg.set_counter("gan4j_data_retries_total",
                            float(rep.get("retries_total", 0)))
            reg.set_counter("gan4j_data_quarantined_total",
                            float(rep.get("quarantined_total", 0)))
            age = rep.get("last_error_age_s")
            if isinstance(age, (int, float)):
                reg.set("gan4j_data_last_error_age_seconds", age)

        self.add_callback(cb)

    def observe_mesh(self, report_fn: Callable[[], Optional[Dict]]) -> None:
        """Register the elastic-mesh feed: ``report_fn`` returns a
        ``GANTrainer._mesh_report`` dict (live mesh device count,
        reshard accounting, formation state).  Scrapes mirror it into
        ``gan4j_mesh_devices`` / ``gan4j_reshard_*`` and ``/healthz``
        carries it as the ``"mesh"`` block — ``ok: false`` while mesh
        formation is quorum-blocked (the agree_world barrier), so a
        probe can tell "waiting for survivors" from "training"."""
        with self._lock:
            self._mesh_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            devices = rep.get("devices")
            if isinstance(devices, (int, float)):
                reg.set("gan4j_mesh_devices", float(devices))
            reg.set_counter("gan4j_reshard_total",
                            float(rep.get("reshard_total", 0)))
            secs = rep.get("reshard_seconds")
            if isinstance(secs, (int, float)):
                reg.set("gan4j_reshard_seconds", float(secs))

        self.add_callback(cb)

    def observe_fleet(self, report_fn: Callable[[], Optional[Dict]]) -> None:
        """Register the fleet feed: ``report_fn`` returns a
        ``FleetTrainer._fleet_report`` dict (tenant count, fused
        throughput, dispatch latency).  Scrapes mirror it into the
        ``gan4j_fleet_*`` series and ``/healthz`` carries it as the
        ``"fleet"`` block — the bench-of-record headline
        (tenants·steps/sec) is ``tenants * steps_per_sec`` of exactly
        these two gauges.

        A lifecycle fleet (``FleetManager.report``) additionally
        carries a ``"tenants_detail"`` sub-dict; scrapes mirror it
        into the ``gan4j_fleet_tenant_*`` / ``gan4j_fleet_cohorts`` /
        ``gan4j_fleet_onboard_latency_ms`` series — each quarantined
        tenant is NAMED via a labeled gauge
        (``gan4j_fleet_tenant_quarantined{tenant="3"} 1``) — and
        ``/healthz`` carries it as ``fleet.tenants_detail``."""
        with self._lock:
            self._fleet_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            for key, series in (("tenants", "gan4j_fleet_tenants"),
                                ("steps_per_sec",
                                 "gan4j_fleet_steps_per_sec"),
                                ("dispatch_ms", "gan4j_fleet_dispatch_ms")):
                v = rep.get(key)
                if isinstance(v, (int, float)):
                    reg.set(series, float(v))
            det = rep.get("tenants_detail")
            if not isinstance(det, dict):
                return
            for key, series in (("cohorts", "gan4j_fleet_cohorts"),
                                ("onboard_latency_ms",
                                 "gan4j_fleet_onboard_latency_ms")):
                v = det.get(key)
                if isinstance(v, (int, float)):
                    reg.set(series, float(v))
            quarantined = det.get("quarantined") or []
            reg.set("gan4j_fleet_tenant_quarantined",
                    float(len(quarantined)))
            for t in quarantined:
                reg.set("gan4j_fleet_tenant_quarantined", 1.0,
                        labels={"tenant": str(t)})

        self.add_callback(cb)

    def observe_serve(self, report_fn: Callable[[], Optional[Dict]]) -> None:
        """Register the serving-plane feed: ``report_fn`` returns a
        ``ServeEngine.report()`` dict (request/shed totals, queue
        depth, batch fill, latency percentiles).  Scrapes mirror it
        into the ``gan4j_serve_*`` series and ``/healthz`` carries it
        as the ``"serve"`` block — the bench-of-record headline
        (saturation req/s at a p99 SLO, RESULTS.md) is measured from
        exactly these series."""
        with self._lock:
            self._serve_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            reg.set_counter("gan4j_serve_requests_total",
                            float(rep.get("requests_total", 0)))
            reg.set_counter("gan4j_serve_shed_total",
                            float(rep.get("shed_total", 0)))
            for key, series in (("queue_depth", "gan4j_serve_queue_depth"),
                                ("batch_fill", "gan4j_serve_batch_fill"),
                                ("p99_ms", "gan4j_serve_p99_ms")):
                v = rep.get(key)
                if isinstance(v, (int, float)):
                    reg.set(series, float(v))

        self.add_callback(cb)

    def observe_gateway(self, report_fn: Callable[[], Optional[Dict]]
                        ) -> None:
        """Register the network-front-door feed: ``report_fn`` returns
        a ``Gateway.report()`` dict (wire request/reject totals, live
        connection count, replica health).  Scrapes mirror it into the
        ``gan4j_gateway_*`` series and ``/healthz`` carries it as the
        ``"gateway"`` block — ``ok: false`` the moment the router has
        zero healthy replicas (the front door is up but nothing behind
        it can serve)."""
        with self._lock:
            self._gateway_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            reg.set_counter("gan4j_gateway_requests_total",
                            float(rep.get("requests_total", 0)))
            reg.set_counter("gan4j_gateway_rejected_total",
                            float(rep.get("rejected_total", 0)))
            reg.set("gan4j_gateway_active_connections",
                    float(rep.get("active_connections", 0)))
            reg.set("gan4j_gateway_replica_healthy",
                    float(rep.get("replicas_healthy", 0)))

        self.add_callback(cb)

    def observe_serving_mesh(self, report_fn:
                             Callable[[], Optional[Dict]]) -> None:
        """Register the serving-mesh feed: ``report_fn`` returns a
        ``MeshRouter.report()`` dict (replica count, healthy count,
        lifetime ejections).  Scrapes mirror it into the
        ``gan4j_mesh_replicas``/``gan4j_mesh_ejected_total`` series
        and ``/healthz`` carries it as the ``"serving_mesh"`` block —
        ``ok: false`` the moment zero replicas are healthy.  (The
        ``"mesh"`` block is the elastic-training DEVICE mesh; this one
        counts replica PROCESSES.)"""
        with self._lock:
            self._serving_mesh_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            reg.set("gan4j_mesh_replicas",
                    float(rep.get("replicas", 0)))
            reg.set("gan4j_mesh_replicas_healthy",
                    float(rep.get("replicas_healthy", 0)))
            reg.set_counter("gan4j_mesh_ejected_total",
                            float(rep.get("ejected_total", 0)))

        self.add_callback(cb)

    def observe_controlplane(self, report_fn:
                             Callable[[], Optional[Dict]]) -> None:
        """Register the control-plane feed: ``report_fn`` returns a
        ``ControlPlane.report()`` dict (fleet size, scale/replace/
        rollback totals, deploy state).  Scrapes mirror it into the
        ``gan4j_controlplane_*`` series and ``/healthz`` carries it
        as the ``"controlplane"`` block — ``ok: false`` once a
        deployment has gone FATAL (budget exhausted) and a human must
        look."""
        with self._lock:
            self._controlplane_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            reg.set("gan4j_controlplane_replicas",
                    float(rep.get("replicas", 0)))
            reg.set_counter(
                "gan4j_controlplane_scale_events_total",
                float(rep.get("scale_up_total", 0))
                + float(rep.get("scale_down_total", 0)))
            reg.set_counter("gan4j_controlplane_replaced_total",
                            float(rep.get("replaced_total", 0)))
            reg.set_counter("gan4j_controlplane_rollbacks_total",
                            float(rep.get("rollbacks_total", 0)))

        self.add_callback(cb)

    def observe_publication(self, report_fn:
                            Callable[[], Optional[Dict]]) -> None:
        """Register the checkpoint-publication feed: ``report_fn``
        returns a ``CheckpointPublisher.report()`` dict (last promoted
        step, age, promote/reject totals).  Scrapes mirror it into the
        ``gan4j_publish_*`` series and ``/healthz`` carries it as the
        ``"publication"`` block plus a top-level ``serving_stale``
        flag — the graceful-degradation signal: replicas still answer
        (status stays "ok") but on weights older than the staleness
        budget, which is a trainer-down page, not a serving page."""
        with self._lock:
            self._publication_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            reg.set("gan4j_publish_last_step",
                    float(rep.get("last_step", 0)))
            reg.set("gan4j_publish_age_seconds",
                    float(rep.get("age_seconds", 0.0)))
            reg.set_counter("gan4j_publish_promoted_total",
                            float(rep.get("promoted_total", 0)))
            reg.set_counter("gan4j_publish_rejected_total",
                            float(rep.get("rejected_total", 0)))

        self.add_callback(cb)

    def observe_client(self, report_fn: Callable[[], Optional[Dict]]
                       ) -> None:
        """Register a ``GatewayClient.report()`` feed: connection-pool
        reuse, reconnects, and retried requests become the
        ``gan4j_client_*`` series — the caller-side view of the wire
        that pairs with the gateway's server-side counters (a
        reconnect spike with a flat gateway error rate means the
        NETWORK between them is flapping, not the service)."""
        with self._lock:
            self._client_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            reg.set_counter("gan4j_client_reused_total",
                            float(rep.get("reused_total", 0)))
            reg.set_counter("gan4j_client_reconnects_total",
                            float(rep.get("reconnects_total", 0)))
            reg.set_counter("gan4j_client_retried_total",
                            float(rep.get("retried_total", 0)))

        self.add_callback(cb)

    def observe_resources(self, report_fn:
                          Callable[[], Optional[Dict]]) -> None:
        """Register the process-resource feed: ``report_fn`` returns a
        ``ResourceMonitor.report()`` dict (latest RSS/device-bytes/
        fd/thread sample).  Scrapes mirror it into the
        ``gan4j_resource_*`` gauges and ``/healthz`` carries it as the
        ``"resources"`` block — the live counterpart of the soak
        gate's offline ``leak_verdict`` (telemetry/resources.py)."""
        with self._lock:
            self._resources_fn = report_fn

        def cb(reg: "MetricsRegistry") -> None:
            rep = report_fn()
            if not rep:
                return
            for key, series in (
                    ("rss_bytes", "gan4j_resource_rss_bytes"),
                    ("device_bytes", "gan4j_resource_device_bytes"),
                    ("open_fds", "gan4j_resource_open_fds"),
                    ("threads", "gan4j_resource_threads")):
                v = rep.get(key)
                if isinstance(v, (int, float)):
                    reg.set(series, float(v))

        self.add_callback(cb)

    # -- render ---------------------------------------------------------------

    def render(self) -> str:
        with self._lock:
            for fn in self._callbacks:
                try:
                    fn(self)
                except Exception:
                    pass
            lines: List[str] = []
            for kind, series in (("counter", self._counters),
                                 ("gauge", self._gauges)):
                seen = set()
                for (name, labels), value in sorted(series.items()):
                    if name not in seen:
                        lines.append(f"# TYPE {name} {kind}")
                        seen.add(name)
                    if labels:
                        lab = ",".join(f'{k}="{v}"' for k, v in labels)
                        lines.append(f"{name}{{{lab}}} {_fmt(value)}")
                    else:
                        lines.append(f"{name} {_fmt(value)}")
            return "\n".join(lines) + "\n"

    def health(self) -> Dict:
        """Liveness document.  ``stalled`` is the watchdog's verdict
        (False without a watchdog feed — no heartbeat means no hang
        CLAIM, not a hang); a stalled process answers
        ``status: "stalled"`` and the exporter serves it as 503, so a
        k8s liveness probe restarts a hung pod the same way
        ``train_with_recovery`` restarts a hung run."""
        stalled = False
        beat_age = None
        fn = self._watchdog_fn
        if fn is not None:
            try:
                rep = fn() or {}
                stalled = bool(rep.get("stalled"))
                beat_age = rep.get("last_beat_age_s")
            except Exception:
                pass
        # the data-plane block: from the live feed when one is
        # registered, else the registry's own (pre-created) counters —
        # the block is ALWAYS present, so probes can key on it
        data = None
        dfn = self._data_fn
        if dfn is not None:
            try:
                rep = dfn() or {}
                data = {"retries_total": int(rep.get("retries_total", 0)),
                        "quarantined_total": int(
                            rep.get("quarantined_total", 0)),
                        "last_error_age_s": rep.get("last_error_age_s"),
                        "ok": bool(rep.get("ok", True))}
            except Exception:
                pass
        # the elastic-mesh block: from the live feed when registered,
        # else the registry's own (pre-created) series — ALWAYS
        # present, like the data block, so probes can key on it.
        # ok:false only while mesh formation is quorum-blocked.
        mesh = None
        mfn = self._mesh_fn
        if mfn is not None:
            try:
                rep = mfn() or {}
                mesh = {"devices": int(rep.get("devices", 0)),
                        "reshard_total": int(rep.get("reshard_total", 0)),
                        "forming": bool(rep.get("forming", False)),
                        "ok": bool(rep.get("ok", True))}
            except Exception:
                pass
        # the fleet block: live feed when a fleet is running, else the
        # pre-created gauges — ALWAYS present, like data/mesh above
        fleet = None
        ffn = self._fleet_fn
        if ffn is not None:
            try:
                rep = ffn() or {}
                fleet = {"tenants": int(rep.get("tenants", 0)),
                         "steps_per_sec": float(
                             rep.get("steps_per_sec", 0.0)),
                         "dispatch_ms": float(rep.get("dispatch_ms", 0.0)),
                         "ok": bool(rep.get("ok", True))}
                det = rep.get("tenants_detail")
                if isinstance(det, dict):
                    # the tenant-lifecycle surface: quarantined tenants
                    # NAMED, onboard/offboard counts, cohort layout
                    fleet["tenants_detail"] = {
                        "active": int(det.get("active", 0)),
                        "cohorts": int(det.get("cohorts", 0)),
                        "quarantined": [int(t) for t in
                                        det.get("quarantined") or []],
                        "quarantine_reasons": {
                            str(k): str(v) for k, v in
                            (det.get("quarantine_reasons")
                             or {}).items()},
                        "onboarded_total": int(
                            det.get("onboarded_total", 0)),
                        "offboarded_total": int(
                            det.get("offboarded_total", 0)),
                        "throttled_total": int(
                            det.get("throttled_total", 0)),
                        "onboard_latency_ms": float(
                            det.get("onboard_latency_ms", 0.0)),
                    }
            except Exception:
                pass
        # the serving block: live feed when an engine is running, else
        # the pre-created series — ALWAYS present, like the rest.
        # ok:false when the dispatch loop is stalled past its watchdog
        # deadline (the serving-plane version of the 503 contract).
        serve = None
        sfn = self._serve_fn
        if sfn is not None:
            try:
                rep = sfn() or {}
                p99 = rep.get("p99_ms")
                serve = {"requests_total": int(
                             rep.get("requests_total", 0)),
                         "shed_total": int(rep.get("shed_total", 0)),
                         "queue_depth": int(rep.get("queue_depth", 0)),
                         "batch_fill": float(
                             rep.get("batch_fill", 0.0) or 0.0),
                         "p99_ms": (float(p99) if isinstance(
                             p99, (int, float)) else None),
                         "ok": bool(rep.get("ok", True))}
            except Exception:
                pass
        # the gateway block: live feed when a gateway is running, else
        # the pre-created series — ALWAYS present, like the rest.
        # ok:false when the router has zero healthy replicas.
        gateway = None
        gfn = self._gateway_fn
        if gfn is not None:
            try:
                rep = gfn() or {}
                gateway = {"requests_total": int(
                               rep.get("requests_total", 0)),
                           "rejected_total": int(
                               rep.get("rejected_total", 0)),
                           "active_connections": int(
                               rep.get("active_connections", 0)),
                           "replicas_healthy": int(
                               rep.get("replicas_healthy", 0)),
                           "replicas": int(rep.get("replicas", 0)),
                           "ok": bool(rep.get("ok", True))}
            except Exception:
                pass
        # the serving-mesh block (replica PROCESSES — the "mesh" block
        # above is the elastic-training device mesh): live feed when a
        # mesh is running, else the pre-created series — ALWAYS
        # present, like the rest.  ok:false with zero healthy replicas.
        serving_mesh = None
        smfn = self._serving_mesh_fn
        if smfn is not None:
            try:
                rep = smfn() or {}
                serving_mesh = {
                    "replicas": int(rep.get("replicas", 0)),
                    "replicas_healthy": int(
                        rep.get("replicas_healthy", 0)),
                    "ejected_total": int(rep.get("ejected_total", 0)),
                    "ok": bool(rep.get("ok", True))}
            except Exception:
                pass
        # the control-plane block: live feed when a controller is
        # running, else the pre-created series — ALWAYS present.
        # ok:false once a deployment has gone fatal (budget exhausted).
        controlplane = None
        cpfn = self._controlplane_fn
        if cpfn is not None:
            try:
                rep = cpfn() or {}
                controlplane = {
                    "replicas": int(rep.get("replicas", 0)),
                    "scale_up_total": int(rep.get("scale_up_total", 0)),
                    "scale_down_total": int(
                        rep.get("scale_down_total", 0)),
                    "replaced_total": int(rep.get("replaced_total", 0)),
                    "rollbacks_total": int(
                        rep.get("rollbacks_total", 0)),
                    "deploy_state": rep.get("deploy_state"),
                    "fatal": rep.get("fatal"),
                    "ok": bool(rep.get("ok", True))}
            except Exception:
                pass
        # the publication block: live feed when a CheckpointPublisher
        # is running, else the pre-created series — ALWAYS present.
        # stale:true means the serving plane is answering on old
        # weights (trainer down or checkpoints failing verification);
        # the top-level serving_stale flag mirrors it so probes need
        # not descend into the block.
        publication = None
        pubfn = self._publication_fn
        if pubfn is not None:
            try:
                rep = pubfn() or {}
                publication = {
                    "last_step": int(rep.get("last_step", 0)),
                    "age_seconds": round(
                        float(rep.get("age_seconds", 0.0)), 3),
                    "stale": bool(rep.get("stale", False)),
                    "ok": bool(rep.get("ok", True))}
            except Exception:
                pass
        # the resources block: live feed when a ResourceMonitor is
        # sampling, else the pre-created gauges — ALWAYS present.
        # Leak VERDICTS stay offline in the soak gate; the probe only
        # reports the latest sample.
        resources = None
        rfn = self._resources_fn
        if rfn is not None:
            try:
                rep = rfn() or {}
                resources = {
                    "rss_bytes": int(rep.get("rss_bytes", 0)),
                    "device_bytes": int(rep.get("device_bytes", 0)),
                    "open_fds": int(rep.get("open_fds", 0)),
                    "threads": int(rep.get("threads", 0)),
                    "ok": bool(rep.get("ok", True))}
            except Exception:
                pass
        with self._lock:
            if data is None:
                data = {"retries_total": int(self._counters.get(
                            ("gan4j_data_retries_total", ()), 0.0)),
                        "quarantined_total": int(self._counters.get(
                            ("gan4j_data_quarantined_total", ()), 0.0)),
                        "last_error_age_s": None, "ok": True}
            if mesh is None:
                mesh = {"devices": int(self._gauges.get(
                            ("gan4j_mesh_devices", ()), 0.0)),
                        "reshard_total": int(self._counters.get(
                            ("gan4j_reshard_total", ()), 0.0)),
                        "forming": False, "ok": True}
            if fleet is None:
                fleet = {"tenants": int(self._gauges.get(
                             ("gan4j_fleet_tenants", ()), 0.0)),
                         "steps_per_sec": float(self._gauges.get(
                             ("gan4j_fleet_steps_per_sec", ()), 0.0)),
                         "dispatch_ms": float(self._gauges.get(
                             ("gan4j_fleet_dispatch_ms", ()), 0.0)),
                         "ok": True}
            if serve is None:
                serve = {"requests_total": int(self._counters.get(
                             ("gan4j_serve_requests_total", ()), 0.0)),
                         "shed_total": int(self._counters.get(
                             ("gan4j_serve_shed_total", ()), 0.0)),
                         "queue_depth": int(self._gauges.get(
                             ("gan4j_serve_queue_depth", ()), 0.0)),
                         "batch_fill": float(self._gauges.get(
                             ("gan4j_serve_batch_fill", ()), 0.0)),
                         "p99_ms": None, "ok": True}
            if gateway is None:
                gateway = {"requests_total": int(self._counters.get(
                               ("gan4j_gateway_requests_total", ()),
                               0.0)),
                           "rejected_total": int(self._counters.get(
                               ("gan4j_gateway_rejected_total", ()),
                               0.0)),
                           "active_connections": int(self._gauges.get(
                               ("gan4j_gateway_active_connections",
                                ()), 0.0)),
                           "replicas_healthy": int(self._gauges.get(
                               ("gan4j_gateway_replica_healthy", ()),
                               0.0)),
                           "replicas": 0, "ok": True}
            if serving_mesh is None:
                serving_mesh = {
                    "replicas": int(self._gauges.get(
                        ("gan4j_mesh_replicas", ()), 0.0)),
                    "replicas_healthy": int(self._gauges.get(
                        ("gan4j_mesh_replicas_healthy", ()), 0.0)),
                    "ejected_total": int(self._counters.get(
                        ("gan4j_mesh_ejected_total", ()), 0.0)),
                    "ok": True}
            if controlplane is None:
                controlplane = {
                    "replicas": int(self._gauges.get(
                        ("gan4j_controlplane_replicas", ()), 0.0)),
                    "scale_up_total": 0, "scale_down_total": 0,
                    "replaced_total": int(self._counters.get(
                        ("gan4j_controlplane_replaced_total", ()),
                        0.0)),
                    "rollbacks_total": int(self._counters.get(
                        ("gan4j_controlplane_rollbacks_total", ()),
                        0.0)),
                    "deploy_state": None, "fatal": None, "ok": True}
            if publication is None:
                publication = {
                    "last_step": int(self._gauges.get(
                        ("gan4j_publish_last_step", ()), 0.0)),
                    "age_seconds": round(self._gauges.get(
                        ("gan4j_publish_age_seconds", ()), 0.0), 3),
                    "stale": False, "ok": True}
            if resources is None:
                resources = {
                    "rss_bytes": int(self._gauges.get(
                        ("gan4j_resource_rss_bytes", ()), 0.0)),
                    "device_bytes": int(self._gauges.get(
                        ("gan4j_resource_device_bytes", ()), 0.0)),
                    "open_fds": int(self._gauges.get(
                        ("gan4j_resource_open_fds", ()), 0.0)),
                    "threads": int(self._gauges.get(
                        ("gan4j_resource_threads", ()), 0.0)),
                    "ok": True}
            age = (None if self._last_record_wall is None
                   else round(time.time() - self._last_record_wall, 3))
            doc = {"status": "stalled" if stalled else "ok",
                   "stalled": stalled, "run_id": self.run_id,
                   "last_record_age_s": age, "data": data,
                   "mesh": mesh, "fleet": fleet, "serve": serve,
                   "gateway": gateway,
                   "serving_mesh": serving_mesh,
                   "controlplane": controlplane,
                   "publication": publication,
                   "serving_stale": bool(publication.get("stale")),
                   "resources": resources}
            if beat_age is not None:
                doc["last_beat_age_s"] = round(float(beat_age), 3)
            return doc


def serve_exporter(registry: MetricsRegistry, port: int,
                   host: str = "127.0.0.1") -> Callable[[], None]:
    """Start the scrape endpoint (daemon thread); returns ``stop()``
    with the resolved port on ``stop.port`` (0 = ephemeral, same
    contract as utils/live_ui.serve_metrics)."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path.startswith("/metrics"):
                body = registry.render().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
                status = 200
            elif self.path.startswith("/healthz"):
                doc = registry.health()
                body = json.dumps(doc).encode()
                ctype = "application/json"
                # the stalled contract: a hung
                # run answers 503 so liveness probes restart the pod —
                # the process being alive enough to serve HTTP is
                # exactly what makes a hang invisible otherwise
                status = 503 if doc.get("stalled") else 200
            else:
                body = b'{"error": "not found"}'
                ctype = "application/json"
                status = 404
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # quiet: no stderr per scrape
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True,
                              name="gan4j-metrics-exporter")
    thread.start()

    def stop() -> None:
        server.shutdown()
        server.server_close()

    stop.port = server.server_address[1]
    return stop
