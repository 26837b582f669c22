"""The port's event timeline (``telemetry/events.py``) held against the JAX
package's on the CPU: the same record fields, each package's
``read_events`` reading the other's ``events.jsonl``, the same overlay
markers, flight records and Chrome-trace export; and the watchdog's
timeout instant and flight record.  Timestamps, host and thread labels
are the only fields allowed to differ."""

import json
import os
import threading
import time

import pytest

from gan_deeplearning4j_tpu.telemetry import events as EJ
from gan_deeplearning4j_tpu.train import watchdog as WJ
from gan_deeplearning4j_tpu_torch.telemetry import events as ET
from gan_deeplearning4j_tpu_torch.train import watchdog as WT

PKGS = {"jax": EJ, "torch": ET}
# fields a clock, a process or a thread decides
VOLATILE = {"t", "wall", "dur", "host", "thread"}


def _script(E, path):
    """The same events through one package's recorder -> the recorder."""
    rec = E.EventRecorder(path=path, run_id="r1", flush_every=1)
    rec.instant("train.start", step=0, workload="insurance")
    with rec.span("checkpoint.save", step=2, directory="checkpoints"):
        pass
    with pytest.raises(RuntimeError, match="boom"):
        with rec.span("eval.grid", step=2):
            raise RuntimeError("boom")
    rec.complete("dispatch", 0.25, step=3)
    rec.instant("alarm.nan", step=3, action="rollback")
    rec.instant("rollback.request", step=4, bad_step=3, rollbacks=1,
                lr_scale=0.5, reason="NaN")
    rec.close()
    return rec


def _stable(evs):
    return [{k: v for k, v in e.items() if k not in VOLATILE} for e in evs]


def test_records_carry_the_jax_fields(tmp_path):
    got = {n: ET.read_events(_script(E, str(tmp_path / f"{n}.jsonl")).path)
           for n, E in PKGS.items()}
    assert [sorted(e) for e in got["torch"]] == [sorted(e) for e in got["jax"]]
    assert _stable(got["torch"]) == _stable(got["jax"])
    head = got["torch"][0]
    assert head["name"] == "recorder.start" and head["run_id"] == "r1"
    span = next(e for e in got["torch"] if e["name"] == "checkpoint.save")
    assert span["ph"] == "X" and span["dur"] >= 0
    assert abs(span["wall"] - time.time()) < 60
    err = next(e for e in got["torch"] if e["name"] == "eval.grid")
    assert "boom" in err["error"]
    comp = next(e for e in got["torch"] if e["name"] == "dispatch")
    assert comp["dur"] == 0.25


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_each_package_reads_the_others_file(tmp_path, writer, reader):
    path = str(tmp_path / "events.jsonl")
    _script(PKGS[writer], path)
    with open(path, "a") as f:
        f.write('{"name": "torn')  # a file read mid-append
    evs = PKGS[reader].read_events(path)
    assert evs == PKGS[writer].read_events(path)
    assert [e["name"] for e in evs] == [
        "recorder.start", "train.start", "checkpoint.save", "eval.grid",
        "dispatch", "alarm.nan", "rollback.request"]


def test_marker_records_agree():
    assert ET.MARKER_EVENTS == EJ.MARKER_EVENTS
    evs = [{"name": n, "step": i} for i, n in enumerate(sorted(
        EJ.MARKER_EVENTS))]
    evs += [{"name": "watchdog.timeout"},          # no step: not placeable
            {"name": "unrelated", "step": 1},
            {"name": "rollback.restore", "step": 2.0}]
    got = ET.marker_records(evs)
    assert got == EJ.marker_records(evs)
    assert {m["label"] for m in got} >= {"nan alarm", "divergence",
                                          "watchdog timeout", "rollback",
                                          "restart"}


def test_ring_is_bounded_and_threads_labeled():
    rec = ET.EventRecorder(ring_size=8)
    for i in range(50):
        rec.instant("tick", i=i)
    assert [e["i"] for e in rec.recent()] == list(range(42, 50))
    seen = []

    def worker():
        with rec.span("from.worker"):
            pass
        seen.append(rec.recent()[-1]["thread"])

    t = threading.Thread(target=worker, name="evt-test-worker")
    t.start()
    t.join()
    assert seen == ["evt-test-worker"]


def test_disabled_recorder_is_a_noop(tmp_path):
    path = str(tmp_path / "none.jsonl")
    rec = ET.EventRecorder(path=path, enabled=False)
    with rec.span("x"):
        pass
    rec.instant("y")
    rec.close()
    assert not os.path.exists(path) and rec.recent() == []


def test_install_and_recording_restore():
    base = ET.current()
    rec = ET.EventRecorder()
    with ET.recording(rec):
        assert ET.current() is rec
        ET.instant("inside")
        ET.complete("done", 0.5)
    assert ET.current() is base
    assert [e["name"] for e in rec.recent()] == ["inside", "done"]


def test_flight_record_matches_jax(tmp_path):
    payloads = {}
    for n, E in PKGS.items():
        rec = E.EventRecorder(run_id="rfr")
        rec.instant("train.start")
        with rec.span("checkpoint.save", step=5):
            path = rec.dump_flight_record(str(tmp_path / n), "test/crash",
                                          extra={"step": 5})
        assert os.path.basename(path) == "flight_record_test_crash.json"
        payloads[n] = json.load(open(path))
    t, j = payloads["torch"], payloads["jax"]
    assert sorted(t) == sorted(j)
    assert (t["reason"], t["run_id"], t["step"]) == ("test/crash", "rfr", 5)
    assert _stable(t["events"]) == _stable(j["events"])
    assert t["events"][-1]["in_flight"] is True


def test_flight_record_never_raises(tmp_path):
    target = tmp_path / "ro"
    target.mkdir()
    os.chmod(target, 0o500)  # unwritable directory
    try:
        ET.EventRecorder().dump_flight_record(str(target), "denied")
    finally:
        os.chmod(target, 0o700)


def test_chrome_trace_is_the_jax_export(tmp_path):
    path = str(tmp_path / "events.jsonl")
    _script(ET, path)
    docs = {n: json.load(open(E.export_chrome_trace(
        path, str(tmp_path / f"{n}.json")))) for n, E in PKGS.items()}
    assert docs["torch"] == docs["jax"]
    chunk = next(e for e in docs["torch"]["traceEvents"]
                 if e["name"] == "checkpoint.save")
    assert chunk["ph"] == "X" and chunk["args"]["step"] == 2
    with pytest.raises(NotImplementedError, match="item 6.5"):
        ET.export_chrome_trace(path, str(tmp_path / "m.json"),
                               trace_dir=str(tmp_path))


def test_watchdog_timeout_leaves_the_jax_instant_and_record(tmp_path):
    """A stalled thread under each package's watchdog (its events going to
    a recorder of its own): the same ``watchdog.timeout`` fields and a
    flight record with the same keys, then the raise on the thread."""
    out = {}
    for n, (E, W) in {"jax": (EJ, WJ), "torch": (ET, WT)}.items():
        rec = E.EventRecorder()
        caught = threading.Event()

        def victim(W=W, caught=caught):
            try:
                while True:
                    time.sleep(0.02)
            except W.WatchdogTimeout:
                caught.set()

        with E.recording(rec):
            t = threading.Thread(target=victim)
            t.start()
            wd = W.HeartbeatWatchdog(deadline_s=0.3, poll_s=0.02,
                                     res_path=str(tmp_path / n))
            wd.start(thread=t)
            assert caught.wait(10)
            wd.stop()
            t.join(5)
        ev = next(e for e in rec.recent() if e["name"] == "watchdog.timeout")
        record = json.load(open(tmp_path / n /
                                "flight_record_watchdog_timeout.json"))
        out[n] = (ev, record)
    (et, rt), (ej, rj) = out["torch"], out["jax"]
    assert sorted(et) == sorted(ej) and et["deadline_s"] == ej["deadline_s"]
    assert sorted(rt) == sorted(rj) and rt["reason"] == "watchdog_timeout"
