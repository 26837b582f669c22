"""The port's fault injectors (``testing/chaos.py``) under the JAX tests'
contracts, on the CPU: ``tests/test_chaos.py`` (kill points, corruption,
the data-source wrappers), ``tests/test_elastic.py``'s
``test_shrink_world_injector_contract``, the ``hang_at_dispatch`` case of
``tests/test_serve.py``, and the JAX module's seeded determinism: the same
seed makes the same choices in both packages.
"""

import os
import random
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.checkpoint import TrainCheckpointer as CkJ
from gan_deeplearning4j_tpu.models import mlpgan_insurance as IJ
from gan_deeplearning4j_tpu.testing import chaos as CJ
from gan_deeplearning4j_tpu_torch.checkpoint import TrainCheckpointer
from gan_deeplearning4j_tpu_torch.data.csv import (
    DataSet,
    RecordReaderDataSetIterator,
    write_csv_matrix,
)
from gan_deeplearning4j_tpu_torch.data.prefetch import PrefetchIterator
from gan_deeplearning4j_tpu_torch.data.resilient import (
    DataHealth,
    RecordQuarantine,
    RetryingReader,
    RetryingSource,
    ValidatingSource,
    read_quarantine,
)
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as IT
from gan_deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from gan_deeplearning4j_tpu_torch.serve import AdmissionQueue, ServeEngine
from gan_deeplearning4j_tpu_torch.serve import engine as engine_mod
from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.testing import chaos as CT
from gan_deeplearning4j_tpu_torch.testing.chaos import (
    ChaosInjector,
    ChaosSchedule,
    CorruptRecordSource,
    DeviceLostError,
    FlakyReader,
    FlakySource,
    InjectedCrash,
    LeakyDispatchSource,
    SlowRequestSource,
    StallingSource,
)
from gan_deeplearning4j_tpu_torch.train import gan_trainer as gt
from gan_deeplearning4j_tpu_torch.train import insurance_main
from gan_deeplearning4j_tpu_torch.train.watchdog import WatchdogTimeout

SEED = 666


def _graph():
    return IT.build_discriminator(device="cpu")


def _extra():
    return {"note": "x", "arr": np.arange(8, dtype=np.float32)}


def _assert_restorable(directory, expect_steps):
    ck = TrainCheckpointer(directory)
    step, extra = ck.restore({"dis": _graph()})
    assert step in expect_steps
    assert extra["note"] == "x"
    np.testing.assert_array_equal(extra["arr"], np.arange(8, dtype=np.float32))
    assert not [n for n in os.listdir(directory)
                if n.startswith((".ckpt_tmp_", ".ckpt_del_"))]
    return step


class _ListSource:
    def __init__(self, n=8, width=3):
        rng = np.random.RandomState(0)
        self.x = rng.rand(n, 4, width).astype(np.float32)
        self.i = 0

    def has_next(self):
        return self.i < len(self.x)

    def next(self):
        self.i += 1
        return DataSet(self.x[self.i - 1], np.ones((4, 1), np.float32))

    def reset(self):
        self.i = 0


# -- kill-during-save --------------------------------------------------------------

@pytest.mark.parametrize("resave", [False, True])
def test_every_kill_point_is_restorable(tmp_path, resave):
    """The save's enumerated events are the JAX checkpointer's; a kill at
    every one of them (a first save of step 4 after step 2, or a re-save
    of step 2 through the swap) leaves a restorable directory: step 4
    once the swap committed, else step 2."""
    inj = ChaosInjector(SEED + resave)
    base = tmp_path / "base"
    ck0 = TrainCheckpointer(str(base), keep=10)
    g = _graph()
    ck0.save(2, {"dis": g}, extra=_extra())
    step = 2 if resave else 4
    evs = inj.count_save_events(lambda: ck0.save(step, {"dis": g},
                                                 extra=_extra()))
    gj = IJ.build_discriminator()
    ckj = CkJ(str(tmp_path / "jax"), keep=10)
    ckj.save(2, {"dis": gj}, extra=_extra())
    evs_j = CJ.ChaosInjector(SEED).count_save_events(
        lambda: ckj.save(step, {"dis": gj}, extra=_extra()))
    assert evs == evs_j and len(evs) >= 5
    assert ("mid_swap" in evs) == resave
    if not resave:
        shutil.rmtree(str(base / "ckpt_4"))
    for k in range(len(evs)):
        d = str(tmp_path / f"kill_{k}")
        shutil.copytree(str(base), d)
        with inj.kill_at_save_event(k) as kp:
            with pytest.raises(InjectedCrash):
                TrainCheckpointer(d, keep=10).save(step, {"dis": g},
                                                   extra=_extra())
        assert kp.fired
        got = _assert_restorable(d, {2, step})
        if evs[k] == "post_swap":
            assert got == step


def test_kill_point_after_times_spares_earlier_saves(tmp_path):
    """``after_times``: the first save completes, the second dies."""
    g = _graph()
    ck = TrainCheckpointer(str(tmp_path), keep=10)
    with ChaosInjector(SEED).kill_at_save_event(0, after_times=1):
        ck.save(2, {"dis": g}, extra=_extra())
        with pytest.raises(InjectedCrash):
            ck.save(4, {"dis": g}, extra=_extra())
    assert _assert_restorable(str(tmp_path), {2}) == 2


# -- corruption -----------------------------------------------------------------------

def _two_checkpoints(d):
    ck = TrainCheckpointer(d, keep=10)
    g = _graph()
    ck.save(2, {"dis": g}, extra=_extra())
    ck.save(4, {"dis": g}, extra=_extra())
    return os.path.join(d, "ckpt_4")


@pytest.mark.parametrize("how", ["corrupt", "corrupt_data", "truncate",
                                 "delete"])
def test_corruption_is_caught_and_falls_back(tmp_path, how):
    """A flipped byte, a torn tail or a lost file in the newest checkpoint:
    the manifest catches it and the restore falls back to step 2.  The
    same seed picks the same file (and offset) as the JAX injector over
    the same file names."""
    target = _two_checkpoints(str(tmp_path / "t"))
    inj, inj_j = ChaosInjector(SEED), CJ.ChaosInjector(SEED)
    if how.startswith("corrupt"):
        excl = how == "corrupt_data"
        path, off = inj.corrupt_one_file(target, exclude_manifest=excl)
        twin = str(tmp_path / "twin")
        shutil.copytree(target, twin)
        path_j, off_j = inj_j.corrupt_one_file(twin, exclude_manifest=excl)
        assert (os.path.basename(path), off) == (os.path.basename(path_j),
                                                  off_j)
    elif how == "truncate":
        path, size = inj.truncate_file(target)
        assert os.path.getsize(path) == size
    else:
        path = inj.delete_file(target, "state.npz")
        assert not os.path.exists(path)
    assert _assert_restorable(str(tmp_path / "t"), {2}) == 2


def test_corrupt_csv_rows_are_named_by_the_quarantine(tmp_path):
    """Seeded garbage lines (the JAX injector's lines and bytes for the
    same seed and file) are skipped and charged by the tolerant reader,
    by their 1-based line numbers."""
    table = np.random.RandomState(1).rand(20, 5).astype(np.float32)
    pt, pj = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    write_csv_matrix(pt, table)
    write_csv_matrix(pj, table)
    hit = ChaosInjector(SEED).corrupt_csv_rows(pt, n_rows=3)
    assert hit == CJ.ChaosInjector(SEED).corrupt_csv_rows(pj, n_rows=3)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    q = RecordQuarantine(str(tmp_path / "q.jsonl"), budget=5)
    it = RecordReaderDataSetIterator(pt, 4, 4, 1, quarantine=q)
    assert it.num_examples() == 17
    assert [r["line"] for r in read_quarantine(str(tmp_path / "q.jsonl"))] \
        == hit


# -- the data-source wrappers --------------------------------------------------------

def test_prefetch_close_during_a_stalled_worker_is_bounded():
    """``close()`` while the worker is wedged inside ``next()`` returns
    promptly; the released worker then exits."""
    src = StallingSource(_ListSource(), stall_at=1)
    it = PrefetchIterator(src, prefetch_depth=1)
    assert src.stalled.wait(timeout=10)
    t0 = time.perf_counter()
    it.close(timeout=0.5)
    assert time.perf_counter() - t0 < 5.0
    src.release()


def test_flaky_source_and_reader_recover_through_the_retry_layer(tmp_path):
    """Transient ``OSError``s before the delegate is touched: the retry
    layer replays the exact batch sequence and counts the retries; the
    reader's failures likewise."""
    health = DataHealth()
    src = RetryingSource(FlakySource(_ListSource(), failures=2, at=1,
                                     seed=SEED),
                         retries=3, backoff_s=0.0, health=health)
    got = []
    while src.has_next():
        got.append(src.next().features)
    want = _ListSource().x
    np.testing.assert_array_equal(np.stack(got), want)
    assert health.retries_total == 2
    flaky = FlakySource(_ListSource(), failures=1, at=0)
    with pytest.raises(OSError, match="1/1"):
        flaky.next()
    path = str(tmp_path / "x.csv")
    write_csv_matrix(path, np.ones((4, 3), np.float32))
    from gan_deeplearning4j_tpu_torch.data.csv import CSVRecordReader

    reader = RetryingReader(FlakyReader(CSVRecordReader(), failures=2,
                                        seed=SEED), retries=3,
                            backoff_s=0.0, health=health)
    assert reader.read(path).shape == (4, 3)
    assert health.retries_total == 4


@pytest.mark.parametrize("mode", ["nan", "shape"])
def test_corrupt_records_are_quarantined(tmp_path, mode):
    """``nan``: one seeded row of each hit batch, dropped and charged row
    by row (the JAX wrapper's row for the same seed); ``shape``: the batch
    charged once and replaced by an empty one."""
    q = RecordQuarantine(str(tmp_path / "q.jsonl"), budget=10)
    src = CorruptRecordSource(_ListSource(), corrupt_at=(1, 3), mode=mode,
                              rng=random.Random(SEED))
    src_j = CJ.CorruptRecordSource(_ListSource(), corrupt_at=(1, 3),
                                   mode=mode, rng=random.Random(SEED))
    val = ValidatingSource(src, q, num_features=3)
    rows = []
    while val.has_next():
        a, b = val.next(), src_j.next()
        rows.append(a.features.shape[0])
        if mode == "nan" and src_j.emitted - 1 in (1, 3):
            bad = ~np.isfinite(b.features).all(axis=1)
            np.testing.assert_array_equal(a.features, b.features[~bad])
    assert src.corrupted == 2
    assert rows == ([4, 3, 4, 3, 4, 4, 4, 4] if mode == "nan"
                    else [4, 0, 4, 0, 4, 4, 4, 4])
    assert q.count == 2
    with pytest.raises(ValueError, match="unknown corruption mode"):
        CorruptRecordSource(_ListSource(), mode="zeros")


# -- device loss at the trainer's step seam ---------------------------------------------

def test_shrink_world_injector_contract():
    """Seeded kill step, one-shot firing, an observable world size,
    validated shapes; the seam is restored on exit."""
    inj = ChaosInjector(SEED)
    with pytest.raises(ValueError):
        inj.shrink_world(kill_step=1, before=4, after=4)
    world = inj.lost_device(kill_step=2, before=8, lose=4)
    assert world.world_size() == 8
    with world:
        gt._chaos_step_hook(1)
        assert not world.fired
        with pytest.raises(DeviceLostError):
            gt._chaos_step_hook(5)
        assert world.fired and world.killed_at == 5
        assert world.world_size() == 4
        gt._chaos_step_hook(6)
    assert gt._chaos_step_hook is None


def test_a_lost_device_is_a_retryable_restart(tmp_path):
    """The trainer's boundary seam raises ``DeviceLostError`` at the
    first boundary at or past the kill step, before that boundary's
    checkpoint; the recovery wrapper restarts from the checkpoint before
    it, and the run finishes."""
    res = str(tmp_path)
    config = insurance_main.default_config(
        num_iterations=6, batch_size=20, res_path=res, print_every=10 ** 9,
        save_every=10 ** 9, metrics=False, checkpoint_every=2,
        steps_per_call=1)
    starts = []

    def make_trainer(resume):
        t = gt.GANTrainer(device="cpu", config=(
            config if not resume else insurance_main.default_config(
                **{**config.__dict__, "resume": True})),
            workload=insurance_main.InsuranceWorkload())
        starts.append(t.steps)
        return t

    with ChaosInjector(SEED).shrink_world(kill_step=3, before=2,
                                          after=1) as world:
        out = gt.train_with_recovery(make_trainer, max_restarts=1,
                                     log=None, backoff_base_s=0)
    assert world.killed_at == 3 and world.world_size() == 1
    assert out["steps"] == 6 and starts == [0, 2]


# -- the serving plane -------------------------------------------------------------------

@pytest.fixture(scope="module")
def infer():
    torch.manual_seed(0)
    return ParallelInference(MT.build_generator(device="cpu"),
                             buckets=(8, 32, 64))


def _mk(rows, seed=0):
    return (np.random.RandomState(seed).rand(rows, 2).astype(np.float32)
            * 2 - 1,)


def _engine(infer):
    """An unsupervised engine whose admission budget (60 s, as the serve
    tests' 10 s) does not shed a large request on a slow, shared CPU."""
    return ServeEngine(infer=infer, supervise=False,
                       admission=AdmissionQueue(deadline_ms=60_000.0))


def test_hang_at_dispatch_fails_typed_and_recovers(infer):
    """The JAX serving contract: the parked dispatch trips the engine's
    watchdog, the in-flight request fails with ``WatchdogTimeout``, and
    the one-shot injector lets the engine serve again inside the block."""
    eng = ServeEngine(infer=infer, watchdog_deadline_s=1.0)
    eng.warmup(np.zeros((1, 2), np.float32))
    with eng:
        eng.generate(*_mk(4), timeout=120.0)
        with ChaosInjector(seed=21).hang_at_dispatch(at=0) as hang:
            req = eng.submit(*_mk(8))
            assert hang.hung.wait(30.0)
            with pytest.raises(WatchdogTimeout):
                req.result(timeout=60.0)
            assert eng.report()["timeouts_total"] == 1
            assert eng.generate(*_mk(4), timeout=120.0)[0].shape[0] == 4
        assert eng.report()["ok"] is True
    assert engine_mod._chaos_dispatch_hook is None


def test_leaky_dispatch_source_hoards_per_dispatch(infer):
    """Every batch dispatch appends its bytes to the hoard; uninstall
    restores the seam and frees the hoard."""
    eng = _engine(infer)
    with eng, LeakyDispatchSource(bytes_per_dispatch=1 << 12) as leak:
        for n in (3, 5, 7):
            eng.generate(*_mk(n, seed=n), timeout=120.0)
        assert leak.dispatches == 3 and len(leak.hoard) == 3
        assert sum(len(b) for b in leak.hoard) == 3 << 12
    assert engine_mod._chaos_dispatch_hook is None and not leak.hoard
    with pytest.raises(ValueError):
        LeakyDispatchSource(0)


def test_slow_request_source_is_the_jax_stream(infer):
    """Oversized sizes at the seeded indices, as the JAX wrapper makes
    them; the engine serves them through the chunked path."""
    sizes = list(SlowRequestSource(iter([1, 4, 16, 4]), largest_bucket=64,
                                   slow_at=(1,), factor=1))
    assert sizes == list(CJ.SlowRequestSource(iter([1, 4, 16, 4]), 64,
                                              slow_at=(1,), factor=1))
    assert sizes == [1, 68, 16, 4]
    eng = _engine(infer)
    with eng:
        for n in sizes:
            assert eng.generate(*_mk(n, seed=n),
                                timeout=120.0)[0].shape[0] == n


def test_chaos_schedule_is_seeded_and_records_outcomes():
    """The resolved timeline is the JAX schedule's for the same seed and
    registrations; actions fire in time order, a raising action is an
    outcome (not a crash), and the timeline and firings land in the
    events."""
    fired = []

    def boom():
        raise RuntimeError("target already dead")

    rec = events.EventRecorder(ring_size=64)
    sched = ChaosSchedule(SEED, jitter_s=0.05)
    sched_j = CJ.ChaosSchedule(SEED, jitter_s=0.05)
    for s in (sched, sched_j):
        s.add(0.02, "b", lambda: fired.append("b"), plane="serve")
        s.add(0.0, "a", lambda: fired.append("a"), plane="train")
        s.add(0.04, "c", boom)
    assert sched.timeline() == sched_j.timeline()
    with events.recording(rec):
        with sched:
            deadline = time.monotonic() + 10.0
            while len(sched.report()["outcomes"]) < 3 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
    rep = sched.report()
    assert (rep["planned"], rep["fired"], rep["errors"]) == (3, 3, 1)
    assert [o["name"] for o in rep["outcomes"]] == [
        e["name"] for e in sched.timeline()]
    assert fired == [e["name"] for e in sched.timeline()
                     if e["name"] != "c"]
    names = [e["name"] for e in rec.recent()]
    assert names[0] == "chaos.schedule" and names.count("chaos.fire") == 3
    with pytest.raises(RuntimeError, match="already started"):
        sched.add(1.0, "late", lambda: None)


def test_the_hooks_are_restored_after_every_injector():
    """Each context-managed injector puts the previous hook back."""
    from gan_deeplearning4j_tpu_torch.checkpoint import checkpointer
    from gan_deeplearning4j_tpu_torch.utils import device

    inj = ChaosInjector(SEED)
    with inj.kill_at_save_event(0):
        assert checkpointer._chaos_hook is not None
    with inj.hang_at_readback(at=5):
        assert device._chaos_readback_hook is not None
    with inj.hang_at_dispatch(at=5):
        assert engine_mod._chaos_dispatch_hook is not None
    assert checkpointer._chaos_hook is None
    assert device._chaos_readback_hook is None
    assert engine_mod._chaos_dispatch_hook is None
    assert isinstance(inj.hang_at_readback(), CT.ReadbackHang)
    assert threading.active_count() >= 1
