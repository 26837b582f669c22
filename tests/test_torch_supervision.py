"""Supervision's numerics and hang half in the port (``train/divergence.py``,
``train/rollback.py``, ``train/shell.py``, ``train/watchdog.py`` and their
wiring in ``train/gan_trainer.py`` and the two protocol mains) held against
the JAX package on the CPU: the sentinel and the rollback budget fed the
same inputs decide as JAX's do, ``scale_graph_lr`` scales every updater
kind as JAX's scales its twin, the health flags are the JAX mains', and
the two JAX end-to-end acceptance runs (a data source that hangs forever,
healed by the watchdog; a NaN batch, healed by rollback) finish on the
port's insurance program.

Every run here is small (batch 10-20, a few steps); a hang is bounded by
the watchdog under test, and each ``train_with_recovery`` call by its
budget.
"""

import argparse
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.optim import adagrad as AGJ
from gan_deeplearning4j_tpu.optim import adam as AJ
from gan_deeplearning4j_tpu.optim import rmsprop as RPJ
from gan_deeplearning4j_tpu.optim import schedules as SJ
from gan_deeplearning4j_tpu.optim import sgd as SGJ
from gan_deeplearning4j_tpu.train import divergence as DJ
from gan_deeplearning4j_tpu.train import gan_trainer as GTJ
from gan_deeplearning4j_tpu.train import rollback as RJ
from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MI
from gan_deeplearning4j_tpu_torch.optim import adagrad as AGT
from gan_deeplearning4j_tpu_torch.optim import adam as AT
from gan_deeplearning4j_tpu_torch.optim import rmsprop as RPT
from gan_deeplearning4j_tpu_torch.optim import schedules as ST
from gan_deeplearning4j_tpu_torch.optim import sgd as SGT
from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.telemetry.events import read_events
from gan_deeplearning4j_tpu_torch.telemetry.ingraph import NanAlarmError
from gan_deeplearning4j_tpu_torch.testing import (
    HangingSource,
    NanSource,
    ReadbackHang,
)
from gan_deeplearning4j_tpu_torch.train import cv_main, insurance_main
from gan_deeplearning4j_tpu_torch.train import divergence as DT
from gan_deeplearning4j_tpu_torch.train import gan_trainer as gt
from gan_deeplearning4j_tpu_torch.train import rollback as RT
from gan_deeplearning4j_tpu_torch.train import shell as shell_lib
from gan_deeplearning4j_tpu_torch.train.watchdog import (
    HeartbeatWatchdog,
    WatchdogTimeout,
)
from gan_deeplearning4j_tpu_torch.utils import device as device_lib

SEED = 666


# -- the divergence sentinel ---------------------------------------------------

def _ramp(n, key="g_loss", base=1.0):
    return [{"step": i, key: base + 0.01 * i} for i in range(n)]


STREAMS = {
    # the JAX suite's three cases
    "sustained": (dict(window=32, factor=10.0, patience=3, min_history=8),
                  _ramp(12) + [{"step": 100 + j, "g_loss": 50.0}
                               for j in range(3)]
                  + [{"step": 200, "d_loss": 1e9}]),
    "single_spikes": (dict(window=32, factor=10.0, patience=3, min_history=8),
                      [{"step": i, "d_grad_norm": 2.0} for i in range(12)]
                      + [{"step": 50, "d_grad_norm": 500.0}]
                      + [{"step": i, "d_grad_norm": 2.0} for i in range(13, 25)]
                      + [{"step": 60, "d_grad_norm": 500.0}]),
    "nonfinite_unwatched": (dict(window=16, factor=5.0, patience=1,
                                 min_history=4),
                            [{"step": i, "g_loss": 1.0,
                              "examples_per_sec": 1e12} for i in range(6)]
                            + [{"step": 9, "g_loss": float("nan")},
                               {"step": 10, "wall_s": 1e9}]),
    # two series at once, the grad norm first past its patience
    "two_series": (dict(window=8, factor=4.0, patience=2, min_history=4),
                   [{"step": i, "d_loss": 0.7, "g_grad_norm": 1.0 + 0.1 * i,
                     "clf_grad_norm": 3.0} for i in range(6)]
                   + [{"step": 6 + j, "d_loss": 0.7, "g_grad_norm": 40.0,
                       "clf_grad_norm": 3.0} for j in range(3)]),
    # near-zero losses: the floor keeps a small value from looking explosive
    "floor": (dict(window=8, factor=5.0, patience=1, min_history=4,
                   floor=1e-3),
              [{"step": i, "d_loss": 1e-6} for i in range(6)]
              + [{"step": 6, "d_loss": 4e-3}, {"step": 7, "d_loss": 6e-3}]),
    "window_slides": (dict(window=8, factor=3.0, patience=2, min_history=8),
                      [{"step": i, "classifier_loss": 1.0 + i}
                       for i in range(30)]),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_divergence_sentinel_trips_where_jax_does(name):
    kw, stream = STREAMS[name]
    trips = {"jax": [], "torch": []}
    got = {"jax": DJ.DivergenceSentinel(on_trip=trips["jax"].append, **kw),
           "torch": DT.DivergenceSentinel(on_trip=trips["torch"].append, **kw)}
    for rec in stream:
        for s in got.values():
            s.observe(dict(rec))
    j, t = got["jax"], got["torch"]
    fields = ("tripped", "step", "key", "value", "baseline", "record")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert trips["torch"] == trips["jax"]
    if t.tripped:
        assert t.describe() == j.describe()


@pytest.mark.parametrize("kw", [dict(window=4, min_history=8),
                                dict(factor=1.0), dict(patience=0)],
                         ids=["window", "factor", "patience"])
def test_divergence_sentinel_validation_is_the_jax_one(kw):
    with pytest.raises(ValueError) as ej:
        DJ.DivergenceSentinel(**kw)
    with pytest.raises(ValueError) as et:
        DT.DivergenceSentinel(**kw)
    assert str(et.value) == str(ej.value)


# -- the rollback manager ------------------------------------------------------

REQUESTS = {
    "same_step": (2, [(10, 10), (10, None), (10, None)]),
    "progress": (1, [(10, None), (20, 18), (30, None), (30, 29)]),
    "mixed": (3, [(5, 3), (5, 4), (8, 8), (8, 7), (8, 8), (8, 8), (9, 9)]),
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_rollback_budget_arithmetic_is_the_jax_one(name):
    budget, reqs = REQUESTS[name]
    mj = RJ.RollbackManager(max_rollbacks=budget, lr_factor=0.5)
    mt = RT.RollbackManager(max_rollbacks=budget, lr_factor=0.5)
    for step, bad in reqs:
        assert mt.request(step, "r", bad_step=bad) == mj.request(
            step, "r", bad_step=bad)
        assert (mt.total, mt.attempts, mt.last_step, mt.restore_before,
                mt.exhausted, mt.lr_scale) == (
            mj.total, mj.attempts, mj.last_step, mj.restore_before,
            mj.exhausted, mj.lr_scale)
        assert mt.resume_max_step == mt.restore_before - 1


@pytest.mark.parametrize("kw", [dict(lr_factor=1.5), dict(lr_factor=0.0),
                                dict(max_rollbacks=0)])
def test_rollback_manager_validation_is_the_jax_one(kw):
    with pytest.raises(ValueError) as ej:
        RJ.RollbackManager(**kw)
    with pytest.raises(ValueError) as et:
        RT.RollbackManager(**kw)
    assert str(et.value) == str(ej.value)


class _G:
    """A graph stand-in: ``updater.layer_updaters``."""

    def __init__(self, ups):
        self.updater = argparse.Namespace(layer_updaters=dict(ups))


def _updaters(O, S):
    """The same per-layer updaters in one package (``O``: its optimizer
    modules, ``S``: its schedules)."""
    rms, adam, sgd, ada = O
    return {
        "rms": rms.RmsProp(0.02), "frozen": rms.RmsProp(0.0),
        "adam": adam.Adam(2e-4, 0.5, 0.999),
        "sgd": sgd.Sgd(0.1), "nesterovs": sgd.Nesterovs(0.05, 0.9),
        "adagrad": ada.AdaGrad(0.3),
        "step": S.Scheduled(rms.RmsProp(0.01), S.StepSchedule(0.1, 0.5, 1000)),
        "exp": S.Scheduled(adam.Adam(1e-3), S.ExponentialSchedule(2e-3, 0.99)),
        "poly": S.Scheduled(sgd.Sgd(0.1), S.PolySchedule(0.4, 2.0, 500)),
        "sigmoid": S.Scheduled(ada.AdaGrad(0.1),
                               S.SigmoidSchedule(0.6, -0.1, 100)),
        "frozen_sched": S.Scheduled(rms.RmsProp(0.0),
                                    S.StepSchedule(0.0, 0.5, 10)),
    }


def test_scale_graph_lr_scales_every_updater_kind_as_jax_does():
    gj = _G(_updaters((RPJ, AJ, SGJ, AGJ), SJ))
    before = _updaters((RPT, AT, SGT, AGT), ST)
    gtorch = _G(before)
    nj, nt = RJ.scale_graph_lr(gj, 0.25), RT.scale_graph_lr(gtorch, 0.25)
    assert nt == nj == 9  # everything but the two frozen layers
    for name, up in gtorch.updater.layer_updaters.items():
        ref = gj.updater.layer_updaters[name]
        assert type(up).__name__ == type(ref).__name__
        assert float(up.learning_rate) == pytest.approx(
            float(ref.learning_rate), rel=1e-6), name
        if name.startswith("frozen"):
            assert up is before[name] and float(up.learning_rate) == 0.0
        else:
            assert up is not before[name]  # replaced, never mutated
            assert float(up.learning_rate) == pytest.approx(
                0.25 * float(before[name].learning_rate), rel=1e-6)
    # the whole schedule scales, not just its t = 0 value
    t = torch.tensor(1500.0)
    assert float(gtorch.updater.layer_updaters["step"].schedule(t)) == \
        pytest.approx(0.25 * float(before["step"].schedule(t)), rel=1e-6)


def test_scale_graph_lr_keeps_the_frozen_tail_frozen():
    """The insurance gan graph: its trainable layers at half their rate, the
    frozen discriminator tail at 0, and the rates the fused update chain
    reads follow."""
    gan = MI.build_gan(device="cpu")
    ups = gan.updater.layer_updaters
    before = {k: float(getattr(u, "learning_rate", 0.0) if u else 0.0)
              for k, u in ups.items()}
    assert any(v > 0 for v in before.values())
    assert any(v == 0 for v in before.values())
    assert RT.scale_graph_lr(gan, 0.5) == sum(v > 0 for v in before.values())
    for layer, lr in before.items():
        assert gan.updater.rates(layer, "W").lr == pytest.approx(0.5 * lr)


# -- the rollback in the trainer --------------------------------------------------

def _ins_config(res, **kw):
    base = dict(num_iterations=6, batch_size=20, res_path=res,
                print_every=10 ** 9, save_every=10 ** 9, metrics=False,
                checkpoint_every=2, steps_per_call=1, data_on_device=False)
    base.update(kw)
    return insurance_main.default_config(**base)


def _trainer(res, manager=None, **kw):
    return gt.GANTrainer(device="cpu", config=_ins_config(res, **kw),
                         workload=insurance_main.InsuranceWorkload(),
                         rollback_manager=manager)


def test_perturbed_latents_survive_the_restore(tmp_path):
    """A rollback incarnation restores the checkpoint before the bad step,
    prunes the ones above it, cuts the LR, and reseeds ``z_gen`` after the
    restore: a state unlike the checkpoint's, the same in two incarnations
    at one epoch, another at the next epoch.  A later plain restart keeps
    the checkpoint's (already perturbed) state."""
    res = str(tmp_path)
    _trainer(res, num_iterations=4).train(log=None)
    ck = TrainCheckpointer(os.path.join(res, "checkpoints"))
    assert ck.steps() == [2, 4]
    saved = ck.restore({g: getattr(_trainer(res, num_iterations=4), g)
                        for g in ("dis", "gen", "gan", "classifier")},
                       step=2)[1]["z_gen_state"]

    def incarnation(mgr):
        return _trainer(res, mgr, num_iterations=4, resume=True,
                        telemetry=True, nan_alarm="rollback")

    mgr = RT.RollbackManager(lr_factor=0.5)
    assert mgr.request(4, "nan at 3", bad_step=3)
    first = incarnation(mgr)
    assert first.steps == 2 and ck.steps() == [2]  # step 4 pruned
    assert mgr.restore_before is None
    # the marker, in the set-up's events that the run's timeline adopts
    assert [{k: e[k] for k in ("step", "bad_step", "rollbacks", "lr_scale")}
            for e in first._setup_events.recent()
            if e["name"] == "rollback.restore"] == [
        {"step": 2, "bad_step": 3, "rollbacks": 1, "lr_scale": 0.5}]
    state1 = first.z_gen.get_state()
    assert not torch.equal(state1, torch.from_numpy(np.asarray(saved)))
    ref = torch.Generator()
    RT.perturb_z_gen(ref, SEED, 1)
    assert torch.equal(state1, ref.get_state())
    assert first.dis.updater.rates("dis_dense_layer_2", "W").lr == \
        pytest.approx(0.5 * _trainer(res).dis.updater.rates(
            "dis_dense_layer_2", "W").lr)
    mgr.restore_before = 3  # a second incarnation at the same epoch
    assert torch.equal(incarnation(mgr).z_gen.get_state(), state1)
    mgr.request(4, "again", bad_step=3)
    assert not torch.equal(incarnation(mgr).z_gen.get_state(), state1)
    plain = incarnation(mgr)  # no pending bound: a plain restart
    assert not plain._rolled_back
    assert torch.equal(plain.z_gen.get_state(),
                       torch.from_numpy(np.asarray(saved)))


def test_request_rollback_keeps_the_earliest_bad_step(tmp_path):
    t = _trainer(str(tmp_path), num_iterations=2)
    t._request_rollback("nan at 100", 100)
    t._request_rollback("divergence at 103", 103)  # later: ignored
    assert t._rollback_pending == ("nan at 100", 100)
    t._request_rollback("nan at 90", 90)           # earlier: tightens
    assert t._rollback_pending == ("nan at 90", 90)


def test_rollback_needs_a_manager_and_one_process(tmp_path):
    """Rollback needs a manager shared by the incarnations, in one process
    and in each rank of a group alike; a group is no longer refused (its
    ranks heal in place, ``tests/test_torch_rollback_world.py``), and the
    mains' parsers take ``--nan-alarm rollback`` with ``--n-devices``."""
    with pytest.raises(ValueError, match="RollbackManager"):
        _trainer(str(tmp_path), telemetry=True, nan_alarm="rollback")
    group = argparse.Namespace(world=2)
    with pytest.raises(ValueError, match="RollbackManager"):
        gt.GANTrainer(device="cpu", group=group, config=_ins_config(
            str(tmp_path), telemetry=True, nan_alarm="rollback"),
            workload=insurance_main.InsuranceWorkload())
    assert not hasattr(gt, "refuse_rollback_under_group")
    for main in (insurance_main, cv_main):
        args = main.parse_args([
            "--device", "cpu", "--n-devices", "2", "--batch-size", "10",
            "--iterations", "2", "--telemetry", "--nan-alarm", "rollback",
            "--checkpoint-every", "2", "--res-path", str(tmp_path / "w2")])
        assert (args.n_devices, args.nan_alarm) == (2, "rollback")


# -- recovery classification ---------------------------------------------------

class _Stub:
    def __init__(self, exc, steps):
        self._exc, self.steps = exc, steps

    def train(self, log=None):
        if self._exc is None:
            return {"steps": self.steps}
        raise self._exc


def test_rollback_requested_burns_no_restart_budget():
    seq = iter([(RT.RollbackRequested("nan at 4", step=4, rollbacks=1), 4),
                (RT.RollbackRequested("nan at 4", step=4, rollbacks=2), 4),
                (None, 8)])
    calls = []

    def make(resume):
        calls.append(resume)
        return _Stub(*next(seq))

    res = gt.train_with_recovery(make, max_restarts=0, log=None,
                                 backoff_base_s=0)
    assert res == {"steps": 8} and calls == [False, True, True]


@pytest.mark.parametrize("exc", [
    RT.RollbackError("budget exhausted"), DT.DivergenceError("g_loss"),
    NanAlarmError("NaN at 3")], ids=lambda e: type(e).__name__)
def test_the_new_fatal_classes_are_not_retried(exc):
    calls = []

    def make(resume):
        calls.append(resume)
        return _Stub(exc, 0)

    with pytest.raises(type(exc)):
        gt.train_with_recovery(make, max_restarts=5, log=None,
                               backoff_base_s=0)
    assert calls == [False]
    # across a process boundary, by class name (a spawned world)
    names = (type(exc).__name__, "RuntimeError", "Exception",
             "BaseException", "object")

    def launch(resume):
        calls.append(resume)
        from gan_deeplearning4j_tpu_torch.parallel import mesh
        raise mesh.RankFailedError([(1, names, "tb")])

    calls.clear()
    with pytest.raises(Exception):
        gt.spawn_with_recovery(launch, "/nonexistent", max_restarts=3,
                               log=None, backoff_base_s=0)
    assert calls == [False]


def test_watchdog_timeout_is_retryable():
    seq = iter([(WatchdogTimeout(), 3), (None, 8)])
    res = gt.train_with_recovery(lambda resume: _Stub(*next(seq)),
                                 max_restarts=1, log=None, backoff_base_s=0)
    assert res == {"steps": 8}


# -- the health flags ------------------------------------------------------------

def test_health_flags_are_the_jax_mains():
    pj, pt = argparse.ArgumentParser(), argparse.ArgumentParser()
    GTJ.add_health_args(pj)
    gt.add_health_args(pt)
    aj = {a.dest: (a.default, a.help, a.type) for a in pj._actions}
    at = {a.dest: (a.default, a.help, a.type) for a in pt._actions}
    # the port's add_health_args also carries each JAX main's own
    # --telemetry and --nan-alarm
    own = {"telemetry", "nan_alarm"}
    assert set(aj) - set(at) == {"sanitize"} and set(at) - set(aj) == own
    for dest in set(at) - own - {"help", "watchdog"}:
        assert at[dest] == aj[dest], dest
    nan = next(a for a in pt._actions if a.dest == "nan_alarm")
    assert nan.choices == ["warn", "snapshot", "abort", "rollback"]
    assert nan.default is None
    for main in (cv_main, insurance_main):
        a = main.parse_args([])
        assert (a.telemetry, a.nan_alarm, a.divergence, a.max_rollbacks,
                a.rollback_lr_factor, a.watchdog, a.watchdog_deadline) == (
            False, None, False, 3, 0.5, False, None)
        a = main.parse_args([
            "--telemetry", "--nan-alarm", "rollback", "--divergence",
            "--max-rollbacks", "2", "--rollback-lr-factor", "0.25",
            "--watchdog", "--watchdog-deadline", "30",
            "--checkpoint-every", "10"])
        c = main._config(a, {})
        assert (c.telemetry, c.nan_alarm, c.divergence, c.max_rollbacks,
                c.rollback_lr_factor, c.watchdog, c.watchdog_deadline_s) == (
            True, "rollback", True, 2, 0.25, True, 30.0)
        with pytest.raises(SystemExit):
            main.parse_args(["--telemetry", "--nan-alarm", "rollback"])
        with pytest.raises(SystemExit):
            main.parse_args(["--nan-alarm", "explode"])


# -- the supervision shell ------------------------------------------------------

def test_shell_installs_in_order_and_tears_down_in_reverse(monkeypatch,
                                                           tmp_path):
    order = []
    for cls, name in ((shell_lib.PreemptionGuard, "install"),
                      (shell_lib.PreemptionGuard, "uninstall"),
                      (HeartbeatWatchdog, "start"),
                      (HeartbeatWatchdog, "stop"),
                      (events.EventRecorder, "close")):
        orig = getattr(cls, name)

        def wrapped(self, *a, orig=orig, tag=f"{cls.__name__}.{name}", **kw):
            order.append(tag)
            return orig(self, *a, **kw)

        monkeypatch.setattr(cls, name, wrapped)
    orig_install = events.install
    monkeypatch.setattr(events, "install", lambda r: (
        order.append("events.install"), orig_install(r))[1])
    base = events.current()
    prev_handler = signal.getsignal(signal.SIGUSR1)
    shell = shell_lib.SupervisionShell(
        res_path=str(tmp_path), watchdog=True, watchdog_deadline_s=60.0,
        preempt_signal_nums=[signal.SIGUSR1])
    seen = {}

    def payload():
        seen["current"] = events.current()
        seen["handler"] = signal.getsignal(signal.SIGUSR1)
        events.instant("inside", step=1)
        order.append("payload")
        return 7

    assert shell.run(payload, on_recorder=lambda r: order.append(
        "on_recorder")) == 7
    assert order == ["PreemptionGuard.install", "events.install",
                     "on_recorder", "HeartbeatWatchdog.start", "payload",
                     "HeartbeatWatchdog.stop", "events.install",
                     "EventRecorder.close", "PreemptionGuard.uninstall"]
    assert seen["current"] is shell.recorder
    assert seen["handler"] != prev_handler
    assert events.current() is base
    assert signal.getsignal(signal.SIGUSR1) == prev_handler
    assert shell.watchdog is None and shell.guard is None
    assert [e["name"] for e in read_events(str(tmp_path / "events.jsonl"))
            ] == ["recorder.start", "inside"]
    assert shell.recorder.recent()[-1]["name"] == "inside"  # ring readable


def test_shell_tears_down_after_a_failed_stage(monkeypatch, tmp_path):
    def boom(self, thread=None):
        raise OSError("no poll thread")

    monkeypatch.setattr(HeartbeatWatchdog, "start", boom)
    base = events.current()
    shell = shell_lib.SupervisionShell(res_path=str(tmp_path), watchdog=True)
    with pytest.raises(OSError):
        shell.run(lambda: None)
    assert events.current() is base and shell.recorder._file is None


@pytest.mark.parametrize("kw,match", [
    ({"sanitize": True}, "item 11.4"),
    ({"sanitize": True, "metrics_port": 0}, "item 11.4"),
    ({"metrics_port": 0}, "needs the registry")])
def test_shell_refuses_the_stages_not_ported(kw, match):
    """The recompile sentinel is not ported (the exporter is, since it
    has a registry to serve: ``tests/test_torch_exporter.py``)."""
    with pytest.raises((NotImplementedError, ValueError), match=match):
        shell_lib.SupervisionShell(res_path=None, **kw)


def test_shell_off_the_main_thread_runs_unguarded(tmp_path):
    out = {}

    def worker():
        shell = shell_lib.SupervisionShell(
            res_path=str(tmp_path), preempt_signal_nums=[signal.SIGUSR1])
        out["result"] = shell.run(lambda: shell.guard)

    t = threading.Thread(target=worker)
    t.start()
    t.join(30)
    assert "result" in out and out["result"] is None


# -- the watchdog against hangs --------------------------------------------------

def test_hang_at_readback_is_caught_by_the_watchdog():
    caught = {}
    with ReadbackHang(0) as hang:
        wd = HeartbeatWatchdog(deadline_s=0.5, poll_s=0.05)

        def victim():
            try:
                device_lib.readback(torch.ones(4))
            except WatchdogTimeout:
                caught["timeout"] = True

        t = threading.Thread(target=victim)
        t.start()
        wd.start(thread=t)
        assert hang.hung.wait(10)
        t.join(20)
        wd.stop()
    assert caught.get("timeout") and hang.fired
    assert 0.4 < hang.t_raised - hang.t_hung < 10
    with ReadbackHang(5):  # one-shot: the next readbacks proceed
        assert device_lib.readback(torch.ones(2)).tolist() == [1.0, 1.0]


class _WrapFirstTrainIter:
    """Stands in for ``gan_trainer.RecordReaderDataSetIterator``: wraps the
    FIRST iterator built (the first incarnation's training iterator) with
    a chaos source; every later one passes through."""

    def __init__(self, orig, wrap):
        self.orig, self.wrap = orig, wrap
        self.calls = 0
        self.wrapped = None

    def __call__(self, *a, **kw):
        it = self.orig(*a, **kw)
        self.calls += 1
        if self.calls == 1:
            self.wrapped = self.wrap(it)
            return self.wrapped
        return it


def test_e2e_hang_watchdog_restart_finishes(tmp_path, monkeypatch):
    """The JAX acceptance run: a data source that hangs FOREVER at its fifth
    batch; the watchdog raises on the training thread, the recovery
    wrapper restarts from the emergency checkpoint, and the run finishes
    its 6 steps.  The timeline holds ``watchdog.timeout`` and
    ``recovery.restart``, and both flight records are on disk."""
    res = str(tmp_path)
    wrapper = _WrapFirstTrainIter(gt.RecordReaderDataSetIterator,
                                  lambda it: HangingSource(it, hang_at=4))
    monkeypatch.setattr(gt, "RecordReaderDataSetIterator", wrapper)
    trainers = []

    def make_trainer(resume):
        t = _trainer(res, resume=resume, watchdog=True,
                     watchdog_warmup_s=120.0, watchdog_scale=20.0,
                     watchdog_min_deadline_s=1.5)
        trainers.append(t)
        return t

    t0 = time.perf_counter()
    out = gt.train_with_recovery(make_trainer, max_restarts=2, log=None,
                                 backoff_base_s=0)
    assert time.perf_counter() - t0 < 60
    assert out["steps"] == 6 and len(trainers) == 2
    assert wrapper.wrapped.hung.is_set()
    evs = read_events(os.path.join(res, "events.jsonl"))
    names = [e["name"] for e in evs]
    assert {"watchdog.timeout", "recovery.restart",
            "checkpoint.emergency"} <= set(names)
    timeout = next(e for e in evs if e["name"] == "watchdog.timeout")
    assert timeout["step"] == 4 and timeout["region"] == "data_wait"
    assert trainers[1]._resume_max_step is None and trainers[1].steps >= 4
    for name in ("watchdog_timeout", "training_failure"):
        assert os.path.exists(os.path.join(res, f"flight_record_{name}.json"))


def test_e2e_nan_rollback_with_perturbation_finishes(tmp_path, monkeypatch):
    """The JAX acceptance run: a source that injects a NaN into the third
    batch; the alarm trips at step 3, the run rolls back to the checkpoint
    at 2 (the poisoned suffix pruned), with the LR cut and the latents
    reseeded, and finishes its 8 steps with one rollback."""
    res = str(tmp_path)
    wrapper = _WrapFirstTrainIter(gt.RecordReaderDataSetIterator,
                                  lambda it: NanSource(it, nan_at=2))
    monkeypatch.setattr(gt, "RecordReaderDataSetIterator", wrapper)
    mgr = RT.RollbackManager(max_rollbacks=3, lr_factor=0.5)
    trainers = []

    def make_trainer(resume):
        t = _trainer(res, mgr, resume=resume, num_iterations=8,
                     telemetry=True, nan_alarm="rollback")
        # detection granularity is the metrics flush cadence: flush per
        # record so the alarm trips at the bad step's boundary
        t.metrics.flush_every = 1
        trainers.append(t)
        return t

    out = gt.train_with_recovery(make_trainer, max_restarts=0, log=None,
                                 backoff_base_s=0)
    assert out["steps"] == 8 and mgr.total == 1 and len(trainers) == 2
    assert all(np.isfinite([out["d_loss"], out["g_loss"], out["clf_loss"]]))
    evs = read_events(os.path.join(res, "events.jsonl"))
    names = [e["name"] for e in evs]
    assert names.index("alarm.nan") < names.index("rollback.request") \
        < names.index("rollback.restore")
    request = next(e for e in evs if e["name"] == "rollback.request")
    restore = next(e for e in evs if e["name"] == "rollback.restore")
    assert request["bad_step"] == 3 and restore["bad_step"] == 3
    assert restore["step"] == 2 < request["bad_step"]
    assert restore["lr_scale"] == 0.5
    assert os.path.exists(os.path.join(res, "flight_record_rollback.json"))
    assert TrainCheckpointer(os.path.join(res, "checkpoints")).steps() == [
        4, 6, 8]


def test_nan_snapshot_keeps_training(tmp_path, monkeypatch):
    """``nan_alarm="snapshot"``: a forensic checkpoint of the bad step in
    ``nan_snapshot`` with its flight record, and the run goes on."""
    res = str(tmp_path)
    monkeypatch.setattr(gt, "RecordReaderDataSetIterator", _WrapFirstTrainIter(
        gt.RecordReaderDataSetIterator, lambda it: NanSource(it, nan_at=1)))
    t = _trainer(res, num_iterations=4, checkpoint_every=0, telemetry=True,
                 nan_alarm="snapshot")
    t.metrics.flush_every = 1
    assert t.train(log=None)["steps"] == 4
    snap = os.path.join(res, "nan_snapshot")
    assert TrainCheckpointer(snap).steps() == [2]
    assert json.load(open(os.path.join(snap, "flight_record_nan_alarm.json"))
                     )["step"] == 2


class _Scaled:
    """Rows (features and label) scaled by ``factor`` from the ``at``-th
    batch on."""

    def __init__(self, source, at, factor):
        self.source, self.at, self.factor, self.n = source, at, factor, 0

    def has_next(self):
        return self.source.has_next()

    def reset(self):
        return self.source.reset()

    def next(self):
        ds = self.source.next()
        if self.n >= self.at:
            ds.features = np.asarray(ds.features) * self.factor
            ds.labels = np.asarray(ds.labels) * self.factor
        self.n += 1
        return ds

    def __getattr__(self, name):
        return getattr(self.source, name)


@pytest.mark.parametrize("action", ["abort", "warn"])
def test_divergence_trips_on_exploding_rows(tmp_path, monkeypatch, action):
    """Rows scaled by 1e4 from step 13: the train-mode BN at the
    discriminator's input normalizes the features back, but the
    classifier's scaled label blows its loss and gradient norm up, with no
    NaN.  The sentinel trips after its patience (3 records) on the first
    watched series in the record; abort is fatal (no restart), warn marks
    the timeline and trains on."""
    res = str(tmp_path)
    monkeypatch.setattr(gt, "RecordReaderDataSetIterator", _WrapFirstTrainIter(
        gt.RecordReaderDataSetIterator, lambda it: _Scaled(it, 12, 1e4)))

    def make_trainer(resume):
        t = _trainer(res, resume=resume, num_iterations=20,
                     checkpoint_every=0, telemetry=True, divergence=True,
                     divergence_window=8, nan_alarm=None
                     if action == "warn" else "abort")
        t.metrics.flush_every = 1
        return t

    if action == "abort":
        with pytest.raises(DT.DivergenceError, match="classifier_loss"):
            gt.train_with_recovery(make_trainer, max_restarts=3, log=None,
                                   backoff_base_s=0)
        assert os.path.exists(os.path.join(res,
                                           "flight_record_divergence.json"))
    else:
        assert make_trainer(False).train(log=None)["steps"] == 20
    ev = next(e for e in read_events(os.path.join(res, "events.jsonl"))
              if e["name"] == "alarm.divergence")
    assert (ev["key"], ev["step"]) == ("classifier_loss", 15)
    assert abs(ev["value"]) > 20 * ev["baseline"]
    assert ev["action"] == action


def test_insurance_main_takes_the_health_flags(tmp_path, capsys):
    res = str(tmp_path)
    out = insurance_main.main([
        "--device", "cpu", "--iterations", "4", "--batch-size", "10",
        "--print-every", "2", "--save-every", "2", "--telemetry",
        "--nan-alarm", "warn", "--divergence", "--watchdog",
        "--res-path", res])
    assert out["steps"] == 4
    recs = [json.loads(ln) for ln in open(f"{res}/insurance_metrics.jsonl")]
    assert all({"d_grad_norm", "g_update_ratio", "nonfinite"} <= set(r)
               for r in recs if "step" in r)
    names = [e["name"] for e in read_events(f"{res}/events.jsonl")]
    assert names[:2] == ["recorder.start", "train.start"]
    assert "train.end" in names and "alarm.nan" not in names
