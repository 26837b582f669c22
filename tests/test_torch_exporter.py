"""The port's ``/metrics`` + ``/healthz`` exporter (``telemetry/
exporter.py``) and resource telemetry (``telemetry/resources.py``) held
against the JAX package's on the CPU: for the same feeds (records, every
``observe_*`` report, counters and callbacks, made from a seed) the same
Prometheus text byte for byte and the same health document, over a real
loopback socket too; the same Theil-Sen slopes and leak verdicts on the
same samples; and the supervision shell's exporter stage around a payload
(served while it runs, the watchdog's feed, closed after)."""

import json
import math
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from gan_deeplearning4j_tpu.telemetry import exporter as XJ
from gan_deeplearning4j_tpu.telemetry import resources as RJ
from gan_deeplearning4j_tpu_torch.telemetry import exporter as XT
from gan_deeplearning4j_tpu_torch.telemetry import resources as RT
from gan_deeplearning4j_tpu_torch.train import shell as shell_lib

PKGS = {"jax": (XJ, RJ), "torch": (XT, RT)}
NOW = 1.8e9


def _feeds(seed: int):
    """Records and every feed's report, from a seed."""
    rng = np.random.RandomState(seed)

    def u(lo=0.0, hi=1.0):
        return float(rng.uniform(lo, hi))

    recs = [{"step": s, "wall_s": u(), "step_s": u(), "d_loss": u(),
             "g_loss": u(), "classifier_loss": u(),
             "examples_per_sec": u(100, 1e5),
             "nonfinite": float(rng.randint(0, 3))} for s in range(1, 6)]
    recs.append({"step": 6, "d_loss": float("nan"), "nonfinite": float("inf")})
    recs.append({"goodput": {"dispatch": u()}, "run_id": "abc"})
    reports = {
        "goodput": {"data_wait": u(), "dispatch": u(), "readback": u(),
                    "checkpoint": u(), "eval": u(), "other": u(),
                    "wall_s": u(1, 9), "compute_fraction": u(),
                    "phase_n": {"dispatch": 3}},
        "watchdog": {"last_beat_age_s": u(), "deadline_s": u(1, 5),
                     "stalled": False, "timeouts_total": 2},
        "data": {"retries_total": 3, "quarantined_total": 1,
                 "last_error_age_s": u(), "ok": True},
        "mesh": {"devices": 2, "reshard_total": 0, "reshard_seconds": 0.0,
                 "forming": False, "ok": True},
        "fleet": {"tenants": 4, "steps_per_sec": u(1, 9),
                  "dispatch_ms": u(), "ok": True,
                  "tenants_detail": {"active": 3, "cohorts": 2,
                                     "quarantined": [3],
                                     "quarantine_reasons": {"3": "nan"},
                                     "onboarded_total": 4,
                                     "offboarded_total": 1,
                                     "throttled_total": 0,
                                     "onboard_latency_ms": u(1, 9)}},
        "serve": {"requests_total": 17, "shed_total": 2, "queue_depth": 1,
                  "batch_fill": u(), "p99_ms": u(1, 9), "ok": True},
        "gateway": {"requests_total": 9, "rejected_total": 1,
                    "active_connections": 2, "replicas_healthy": 1,
                    "replicas": 2, "ok": True},
        "serving_mesh": {"replicas": 2, "replicas_healthy": 1,
                         "ejected_total": 1, "ok": False},
        "controlplane": {"replicas": 2, "scale_up_total": 1,
                         "scale_down_total": 0, "replaced_total": 1,
                         "rollbacks_total": 0, "deploy_state": "steady",
                         "fatal": None, "ok": True},
        "publication": {"last_step": 400, "age_seconds": u(1, 9),
                        "stale": True, "promoted_total": 3,
                        "rejected_total": 1, "ok": True},
        "client": {"reused_total": 5, "reconnects_total": 1,
                   "retried_total": 0},
        "resources": {"rss_bytes": 1 << 30, "device_bytes": 1 << 20,
                      "open_fds": 12, "threads": 7, "ok": True},
    }
    return recs, reports


def _registry(X, seed: int, stalled: bool = False):
    recs, reports = _feeds(seed)
    reg = X.MetricsRegistry()
    reg.run_id = "r16"
    for name, rep in reports.items():
        if name == "watchdog":
            rep = dict(rep, stalled=stalled)
        getattr(reg, f"observe_{name}")(lambda rep=rep: rep)
    reg.observe_record({"step": 0})  # before the broken feed
    reg.add_callback(lambda r: (_ for _ in ()).throw(RuntimeError("x")))
    for r in recs:
        reg.observe_record(r)
    reg.inc("gan4j_custom_total", 2.5, labels={"kind": "a"})
    reg.set("gan4j_custom", -math.inf)
    reg.set_counter("gan4j_rollback_total", 3.0)
    reg.set_counter("gan4j_rollback_total", 1.0)  # never backwards
    return reg


@pytest.fixture
def frozen(monkeypatch):
    for X, _ in PKGS.values():
        monkeypatch.setattr(X.time, "time", lambda: NOW)


@pytest.mark.parametrize("seed", [0, 16])
def test_render_and_health_are_the_jax_modules(frozen, seed):
    regs = {n: _registry(X, seed) for n, (X, _) in PKGS.items()}
    text = {n: r.render() for n, r in regs.items()}
    assert text["torch"] == text["jax"]
    assert "gan4j_steps_total 7.0" in text["torch"]
    assert 'gan4j_goodput_seconds{phase="dispatch"}' in text["torch"]
    assert "gan4j_custom -Inf" in text["torch"]
    health = {n: r.health() for n, r in regs.items()}
    assert health["torch"] == health["jax"]
    assert health["torch"]["serving_stale"] is True


def test_an_empty_registry_is_the_jax_modules(frozen):
    assert XT.MetricsRegistry().render() == XJ.MetricsRegistry().render()
    assert XT.MetricsRegistry().health() == XJ.MetricsRegistry().health()


def _get(port: int, path: str):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


@pytest.mark.parametrize("stalled", [False, True])
def test_serve_exporter_answers_as_the_jax_one(frozen, stalled):
    got = {}
    for n, (X, _) in PKGS.items():
        stop = X.serve_exporter(_registry(X, 3, stalled=stalled), 0)
        try:
            got[n] = [_get(stop.port, p)
                      for p in ("/metrics", "/healthz", "/nope")]
        finally:
            stop()
        with pytest.raises(OSError):
            urllib.request.urlopen(f"http://127.0.0.1:{stop.port}/metrics",
                                   timeout=2)
    assert got["torch"] == got["jax"]
    (m_status, m_type, _), (h_status, _, body), (n_status, _, _) = got["torch"]
    assert m_status == 200 and m_type.startswith("text/plain; version=0.0.4")
    assert h_status == (503 if stalled else 200) and n_status == 404
    assert json.loads(body)["stalled"] is stalled


def _samples(seed: int, n: int, leak: bool):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = 0.5 * i
        grow = (2 << 20) * t if leak else 0.0
        out.append({"t": t,
                    "rss_bytes": int((200 << 20) + grow
                                     + rng.randint(0, 1 << 20)),
                    "device_bytes": int((1 << 30) + rng.randint(0, 1 << 10)),
                    "open_fds": 10 + int(leak) * (i // 2),
                    "threads": 5 + rng.randint(0, 2)})
    if n > 10:
        out[n // 2]["rss_bytes"] += 1 << 30  # one spike the median ignores
    return out


@pytest.mark.parametrize("seed,n,leak", [(0, 4, False), (1, 80, False),
                                         (2, 300, True)])
def test_leak_verdict_and_slope_are_the_jax_modules(seed, n, leak):
    samples = _samples(seed, n, leak)
    ts = [s["t"] for s in samples]
    vs = [float(s["rss_bytes"]) for s in samples]
    assert RT.theil_sen_slope(ts, vs) == RJ.theil_sen_slope(ts, vs)
    verdict = RT.leak_verdict(samples)
    assert verdict == RJ.leak_verdict(samples)
    if n > 10:
        assert verdict["ok"] is (not leak)
        assert ("rss_bytes" in verdict["leaking"]) is leak


def test_resource_monitor_samples_on_its_thread():
    mon = RT.ResourceMonitor(interval_s=0.05, ring_size=4)
    with mon:
        names = [t.name for t in threading.enumerate()]
        assert "gan4j-resource-sampler" in names
        rep = mon.report()
    assert set(rep) == set(RJ.ResourceMonitor().report())
    assert rep["rss_bytes"] > 0 and rep["threads"] >= 1
    assert rep["device_bytes"] == 0  # no CUDA context in this process
    assert len(mon.samples()) <= 4
    assert set(RT.sample_resources()) == set(RJ.sample_resources())


def test_shell_serves_the_registry_while_the_payload_runs(tmp_path):
    """Stage 4 of the port's shell: the exporter over the trainer's
    registry, the watchdog's feed in ``/healthz``, the port printed, and
    nothing listening after the payload."""
    reg = XT.MetricsRegistry()
    reg.observe_record({"step": 1, "d_loss": 0.5})
    lines = []
    shell = shell_lib.SupervisionShell(
        reg, str(tmp_path), watchdog=True, watchdog_deadline_s=60.0,
        metrics_port=0, log=lines.append)

    def payload():
        status, _, text = _get(shell.metrics_port, "/metrics")
        _, _, health = _get(shell.metrics_port, "/healthz")
        return shell.metrics_port, status, text.decode(), json.loads(health)

    port, status, text, health = shell.run(payload)
    assert status == 200 and "gan4j_steps_total 1.0" in text
    assert "gan4j_watchdog_stalled 0.0" in text
    assert health["status"] == "ok" and "last_beat_age_s" in health
    assert lines == [f"[metrics] serving /metrics + /healthz on "
                     f"http://127.0.0.1:{port}"]
    assert shell.metrics_port is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)
