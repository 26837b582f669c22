"""The port's event timeline (``telemetry/events.py``) held against the JAX
package's on the CPU: the same record fields, each package's
``read_events`` reading the other's ``events.jsonl``, the same overlay
markers, flight records and Chrome-trace export; and the watchdog's
timeout instant and flight record.  Timestamps, host and thread labels
are the only fields allowed to differ.  The checkpoint stages, the
preemption exit and the data plane's retries, quarantines and prefetch
stalls emit the JAX package's events; a profiler capture merges into the
Chrome trace as the JAX export merges it."""

import gzip
import json
import os
import threading
import time

import numpy as np
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
    """The host-events export, then the merge of a profiler capture (a
    gzipped trace on its own clock, with the ``host_anchor.json``
    sidecar): both packages' documents equal, the capture shifted onto the
    anchor."""
    path = str(tmp_path / "events.jsonl")
    _script(ET, path)
    docs = {n: json.load(open(E.export_chrome_trace(
        path, str(tmp_path / f"{n}.json")))) for n, E in PKGS.items()}
    assert docs["torch"] == docs["jax"]
    chunk = next(e for e in docs["torch"]["traceEvents"]
                 if e["name"] == "checkpoint.save")
    assert chunk["ph"] == "X" and chunk["args"]["step"] == 2
    cap = tmp_path / "capture"
    cap.mkdir()
    with gzip.open(cap / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": [
            {"ph": "M", "pid": 7, "name": "process_name",
             "args": {"name": "GPU 0"}},
            {"ph": "X", "pid": 7, "tid": 1, "name": "k", "ts": 1000.0,
             "dur": 5.0}]}, f)
    (cap / "host_anchor.json").write_text(json.dumps({"wall_start": 1.5e9}))
    merged = {n: json.load(open(E.export_chrome_trace(
        path, str(tmp_path / f"m_{n}.json"), str(cap))))
        for n, E in PKGS.items()}
    assert merged["torch"] == merged["jax"]
    k = next(e for e in merged["torch"]["traceEvents"] if e["name"] == "k")
    assert k["ts"] == 1.5e15 and k["dur"] == 5.0


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


# -- the checkpoint, preemption and data events -------------------------------


def _recorded(E, fn):
    """``fn()`` under a fresh ring recorder of package ``E`` -> its events,
    the volatile fields dropped."""
    rec = E.EventRecorder()
    prev = E.install(rec)
    try:
        fn()
    finally:
        E.install(prev)
    return _stable(rec.recent())


def test_checkpoint_stages_are_the_jax_events(tmp_path):
    """A synchronous and an asynchronous save of each package's insurance
    discriminator: ``checkpoint.serialize`` / ``checkpoint.commit`` (and
    ``checkpoint.snapshot`` / ``checkpoint.write`` around them when
    async), with the JAX attributes."""
    from gan_deeplearning4j_tpu.checkpoint import (
        AsyncCheckpointer as AJ,
        TrainCheckpointer as CJ,
    )
    from gan_deeplearning4j_tpu.models import mlpgan_insurance as MJ
    from gan_deeplearning4j_tpu_torch.checkpoint import (
        AsyncCheckpointer as AT,
        TrainCheckpointer as CT,
    )
    from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MT

    got = {}
    for n, E, C, A, graph in (
            ("jax", EJ, CJ, AJ, MJ.build_discriminator()),
            ("torch", ET, CT, AT, MT.build_discriminator(device="cpu"))):
        d = str(tmp_path / n)

        def saves():
            C(d).save(3, {"dis": graph})
            ck = A(C(d))
            ck.save(5, {"dis": graph})
            ck.close()

        got[n] = _recorded(E, saves)
    assert got["torch"] == got["jax"]
    assert [e["name"] for e in got["torch"]] == [
        "checkpoint.serialize", "checkpoint.commit", "checkpoint.snapshot",
        "checkpoint.write", "checkpoint.serialize", "checkpoint.commit"]
    assert [e["step"] for e in got["torch"]] == [3, 3, 5, 5, 5, 5]


class _Guard:
    received_at = 1.75e9

    @staticmethod
    def signal_name():
        return "SIGTERM"


def test_preempt_exit_leaves_the_jax_events_and_flight_record(tmp_path):
    from gan_deeplearning4j_tpu.train import preemption as PJ
    from gan_deeplearning4j_tpu_torch.train import preemption as PT

    got, records = {}, {}
    for n, E, P in (("jax", EJ, PJ), ("torch", ET, PT)):
        d = tmp_path / n
        d.mkdir()

        def exit_():
            with pytest.raises(P.PreemptionError) as e:
                P.preempt_exit(str(d), _Guard(), local_step=40,
                               fleet_min_step=40, checkpoint="ckpt_40",
                               run_id="r1")
            assert (e.value.step, e.value.checkpoint) == (40, "ckpt_40")

        got[n] = _recorded(E, exit_)
        records[n] = json.load(open(d / "flight_record_preemption.json"))
        assert json.load(open(d / "PREEMPTED.json"))["run_id"] == "r1"
    assert got["torch"] == got["jax"] == [
        {"name": "preempt.signal", "ph": "i", "signal": "SIGTERM",
         "received_at": 1.75e9},
        {"name": "preempt.exit", "ph": "i", "step": 40, "fleet_min_step": 40,
         "checkpoint": "ckpt_40"}]
    assert sorted(records["torch"]) == sorted(records["jax"])
    assert (records["torch"]["reason"], records["torch"]["step"]) == (
        "preemption", 40)
    assert _stable(records["torch"]["events"]) == got["torch"]


class _Slow:
    """A source of two 2-row batches, the second 0.1 s late."""

    def __init__(self, dataset):
        self.dataset, self.i = dataset, 0

    def has_next(self):
        return self.i < 2

    def next(self):
        self.i += 1
        if self.i == 2:
            time.sleep(0.1)
        return self.dataset(np.full((2, 3), self.i, np.float32),
                            np.zeros((2, 1), np.float32))

    def reset(self):
        self.i = 0


def test_data_events_are_the_jax_ones(tmp_path):
    """Two transient read failures then a read (``data.retry``), one
    quarantined record (``data.quarantine``) and a consumer that waits on
    a slow source (``data.prefetch_stall``), in both packages."""
    from gan_deeplearning4j_tpu.data import prefetch as FJ
    from gan_deeplearning4j_tpu.data import resilient as RJ
    from gan_deeplearning4j_tpu.data.csv import DataSet as DJ
    from gan_deeplearning4j_tpu_torch.data import prefetch as FT
    from gan_deeplearning4j_tpu_torch.data import resilient as RT
    from gan_deeplearning4j_tpu_torch.data.csv import DataSet as DT

    got = {}
    for n, E, R, F, D in (("jax", EJ, RJ, FJ, DJ), ("torch", ET, RT, FT, DT)):
        fails = iter([OSError("blip"), EOFError("torn")])

        def read():
            e = next(fails, None)
            if e is not None:
                raise e
            return "rows"

        def run():
            assert R.call_with_retries(read, "train.csv", retries=3,
                                       sleep=lambda s: None) == "rows"
            q = R.RecordQuarantine(str(tmp_path / f"{n}.jsonl"), budget=2)
            q.charge("train.csv", line=7, reason="3 fields, want 13",
                     raw="1,2,3")
            it = F.PrefetchIterator(_Slow(D), prefetch_depth=1)
            assert [float(b[0][0, 0]) for b in it] == [1.0, 2.0]
            it.close()

        got[n] = _recorded(E, run)
    stalls = {n: [e for e in evs if e["name"] == "data.prefetch_stall"]
              for n, evs in got.items()}
    assert len(stalls["torch"]) == len(stalls["jax"]) >= 1
    strip = {n: [e for e in evs if e["name"] != "data.prefetch_stall"]
             for n, evs in got.items()}
    assert strip["torch"] == strip["jax"]
    assert [e["name"] for e in strip["torch"]] == [
        "data.retry", "data.retry", "data.quarantine"]
    assert [e["attempt"] for e in strip["torch"][:2]] == [1, 2]
    assert strip["torch"][2]["line"] == 7 and strip["torch"][2]["n"] == 1


def test_program_drill_leaves_the_jax_events(tmp_path, monkeypatch):
    """Both insurance programs through the same drill on the CPU, from the
    same CSV pair with one corrupt training row (``--max-quarantine 1``),
    a checkpoint every 2 steps and a preemption signal that has already
    arrived (the first boundary preempts): each program's
    ``events.jsonl`` holds the same ``checkpoint.*``, ``preempt.*`` and
    ``data.*`` names, each with the JAX attributes, and each exits as
    preempted at step 2."""
    from gan_deeplearning4j_tpu.data import datasets as DJ
    from gan_deeplearning4j_tpu.train import insurance_main as IJ
    from gan_deeplearning4j_tpu.train import preemption as PJ
    from gan_deeplearning4j_tpu_torch.train import insurance_main as IT
    from gan_deeplearning4j_tpu_torch.train import preemption as PT

    src = tmp_path / "csv"
    DJ.ensure_insurance_csv(str(src))
    lines = (src / "insurance_train.csv").read_text().splitlines()
    lines[5] = "1,2,3"  # 3 fields, want 13: quarantined
    (src / "insurance_train.csv").write_text("\n".join(lines) + "\n")
    argv = ["--iterations", "4", "--batch-size", "10", "--print-every", "2",
            "--save-every", "2", "--checkpoint-every", "2",
            "--preempt-signal", "SIGUSR1", "--max-quarantine", "1"]
    got = {}
    for n, main, P, extra in (("jax", IJ.main, PJ, []),
                              ("torch", IT.main, PT, ["--device", "cpu"])):
        d = tmp_path / n
        d.mkdir()
        for f in ("insurance_train.csv", "insurance_test.csv"):
            (d / f).write_bytes((src / f).read_bytes())
        monkeypatch.setattr(P.PreemptionGuard, "triggered",
                            property(lambda self: True))
        out = main(argv + extra + ["--res-path", str(d)])
        assert out["preempted"] and out["step"] == 2, (n, out)
        got[n] = {}
        for ev in ET.read_events(str(d / "events.jsonl")):
            if ev["name"].startswith(("checkpoint.", "preempt.", "data.")):
                got[n].setdefault(ev["name"], sorted(set(ev) - VOLATILE))
    assert got["torch"] == got["jax"]
    assert {"checkpoint.serialize", "checkpoint.commit", "preempt.signal",
            "preempt.exit", "data.quarantine"} <= set(got["torch"])
