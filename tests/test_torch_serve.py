"""The port's serving engine (``serve/engine.py``) and admission
(``serve/admission.py``), held against the JAX package on the CPU.

Continuous batching coalesces concurrent requests into one bucket-padded
dispatch; inference couples no rows, so a coalesced request's outputs are
the outputs of the same request served alone (held at float32 ulp scale,
as the JAX package's tests hold its own engine).  A checkpoint that the
JAX ``TrainCheckpointer`` wrote under ``"gen"`` hot-swaps into the port's
engine and gives the JAX engine's outputs after the same swap; a torn
newest checkpoint is skipped by both.  Hangs and raising dispatches end
in typed errors and the engine keeps serving.

Every wait is bounded; no test asserts a latency, a rate or a percentile
measured on the CPU.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.checkpoint.checkpointer import (
    TrainCheckpointer as TrainCheckpointerJ,
)
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.parallel import data_mesh
from gan_deeplearning4j_tpu.parallel.inference import (
    ParallelInference as ParallelInferenceJ,
)
from gan_deeplearning4j_tpu.serve import admission as admission_j
from gan_deeplearning4j_tpu.serve.engine import ServeEngine as ServeEngineJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    NoVerifiedCheckpointError,
)
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from gan_deeplearning4j_tpu_torch.serve import (
    AdmissionQueue,
    DispatchError,
    Request,
    ServeEngine,
    ShedError,
    run_load,
    z_inputs,
)
from gan_deeplearning4j_tpu_torch.serve import engine as engine_mod
from gan_deeplearning4j_tpu_torch.train.watchdog import WatchdogTimeout

BUCKETS = (8, 32, 64)
# port CPU against JAX CPU, both f32: rounding only
ATOL, RTOL = 1e-6, 1e-5


def _mk(rows, seed=0):
    return (np.random.RandomState(seed).rand(rows, 2).astype(np.float32)
            * 2 - 1,)


@pytest.fixture(scope="module")
def gens(cpu_devices):
    """(JAX generator, port generator) with the same weights."""
    gj = MJ.build_generator()
    gt = MT.build_generator(device="cpu")
    gt.params = interop.params_from_numpy(
        jax.tree.map(np.asarray, gj.params), "cpu", like=gt.params)
    return gj, gt


@pytest.fixture(scope="module")
def infer(gens):
    return ParallelInference(gens[1], buckets=BUCKETS)


@pytest.fixture(scope="module")
def warm_engine(infer):
    eng = ServeEngine(infer=infer, watchdog_deadline_s=30.0,
                      admission=AdmissionQueue(deadline_ms=10_000.0))
    eng.warmup(np.zeros((1, 2), np.float32))
    eng.start()
    yield eng
    eng.stop()


def _coalesced(infer, reqs):
    """Serve ``reqs`` as ONE coalesced batch: queue them all before the
    engine starts, so the first drain takes everything."""
    eng = ServeEngine(infer=infer, supervise=False)
    for r in reqs:
        eng.admission.submit(r)
    with eng:
        outs = [r.result(timeout=120.0) for r in reqs]
        batches = eng.report()["batches_total"]
    return outs, batches


@pytest.mark.parametrize("sizes", [(3, 5), (5, 6), (70,), (1, 4, 16, 32)],
                         ids=str)
def test_coalesced_equals_individual(gens, infer, sizes):
    """Exact-bucket coalescing (3+5 -> one 8-row dispatch), pad-up (5+6
    -> 32), chunked (70 -> 64+8) and four sizes at once (53 -> 64): each
    request's outputs are its outputs served alone, and the JAX engine's
    for the same coalesced batch."""
    reqs = [Request(_mk(n, seed=10 + n)) for n in sizes]
    outs, batches = _coalesced(infer, reqs)
    assert batches == 1  # genuinely ONE coalesced dispatch
    pj = ParallelInferenceJ(gens[0], mesh=data_mesh(1), buckets=BUCKETS)
    reqs_j = [admission_j.Request(_mk(n, seed=10 + n)) for n in sizes]
    eng_j = ServeEngineJ(infer=pj, supervise=False)
    for r in reqs_j:
        eng_j.admission.submit(r)
    with eng_j:
        outs_j = [r.result(timeout=120.0) for r in reqs_j]
    for n, out, out_j in zip(sizes, outs, outs_j):
        alone = infer.output(*_mk(n, seed=10 + n))
        assert len(out) == len(alone) == 1
        assert isinstance(out[0], np.ndarray) and out[0].shape == (
            n, 1, 28, 28)
        np.testing.assert_allclose(out[0], alone[0].numpy(),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out[0], np.asarray(out_j[0]),
                                   rtol=RTOL, atol=ATOL)


def test_no_capture_and_no_error_under_load(warm_engine):
    """Poisson traffic from the size mix and a chunked request: every
    request answered, nothing captured (the CPU runs eager), the report
    carries the JAX engine's keys."""
    mk = z_inputs(2, seed=7)
    stats = run_load(warm_engine, rate_rps=60.0, duration_s=1.0,
                     make_inputs=mk, seed=11)
    assert stats["errors"] == 0 and stats["undrained"] == 0
    assert stats["completed"] > 0
    out = warm_engine.generate(*mk(70), timeout=120.0)  # chunked path
    assert out[0].shape[0] == 70
    assert warm_engine.infer.captures == 0
    rep = warm_engine.report()
    eng_j = ServeEngineJ(infer=ParallelInferenceJ(
        MJ.build_generator(), mesh=data_mesh(1), buckets=BUCKETS))
    assert list(rep) == list(eng_j.report())
    assert rep["requests_total"] >= stats["completed"] + 1
    stages = warm_engine.stage_report()
    assert stages["batches"] == rep["batches_total"]
    assert all(stages[k] >= 0.0 for k in engine_mod.STAGES)


@pytest.fixture(scope="module")
def jax_ckpt(gens, tmp_path_factory):
    """A directory of JAX ``TrainCheckpointer`` saves of the generator
    under ``"gen"`` at steps 1-3, the weights scaled differently at each
    step, the newest torn (one byte of its zip flipped) ->
    (directory, {step: params})."""
    gj = gens[0]
    d = str(tmp_path_factory.mktemp("jax_gen_ckpt"))
    ck = TrainCheckpointerJ(d, keep=5)
    base = gj.params
    saved = {}
    try:
        for s in (1, 2, 3):
            gj.params = jax.tree.map(lambda a, f=s: a * (1.0 + 0.1 * f),
                                     base)
            ck.save(s, {"gen": gj})
            saved[s] = jax.tree.map(np.asarray, gj.params)
    finally:
        gj.params = base
    with open(os.path.join(d, "ckpt_3", "gen_model.zip"), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    return d, saved


def test_hotswap_from_a_jax_checkpoint_matches_the_jax_engine(jax_ckpt):
    """A JAX-written ``"gen"`` checkpoint (newest torn) hot-swaps into the
    port's engine: the torn step is skipped, the newest verified step is
    restored, and the outputs are the JAX engine's after the same swap,
    with zero captures."""
    d, _ = jax_ckpt
    z = _mk(20, seed=5)
    pt = ParallelInference(MT.build_generator(device="cpu"), buckets=BUCKETS)
    eng = ServeEngine(infer=pt, supervise=False)
    eng.warmup(np.zeros((1, 2), np.float32))
    pj = ParallelInferenceJ(MJ.build_generator(), mesh=data_mesh(1),
                            buckets=BUCKETS)
    eng_j = ServeEngineJ(infer=pj, supervise=False)
    eng_j.warmup(np.zeros((1, 2), np.float32))
    with eng, eng_j:
        before = eng.generate(*z, timeout=120.0)[0]
        assert eng.hotswap_from(d) == 2
        assert eng_j.hotswap_from(d) == 2
        # the refresh lands at the top of the next dispatch cycle
        deadline = time.monotonic() + 30.0
        got = before
        while np.array_equal(got, before) and time.monotonic() < deadline:
            got = eng.generate(*z, timeout=120.0)[0]
        want = eng_j.generate(*z, timeout=120.0)[0]
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    assert not np.allclose(got, before, atol=1e-3)
    assert pt.captures == 0


def test_hotswap_pins_and_bounds(jax_ckpt, tmp_path):
    """``step`` pins exactly (a torn pin raises, no substitution);
    ``max_step`` bounds the walk; nothing verifiable raises the typed
    ``NoVerifiedCheckpointError`` and keeps the old weights."""
    d, saved = jax_ckpt
    gt = MT.build_generator(device="cpu")
    eng = ServeEngine(infer=ParallelInference(gt, buckets=BUCKETS),
                      supervise=False)
    assert eng.hotswap_from(d, step=1) == 1
    np.testing.assert_array_equal(
        gt.params["gen_dense_layer_2"]["W"].numpy(),
        saved[1]["gen_dense_layer_2"]["W"])
    with pytest.raises(CheckpointCorruptError):
        eng.hotswap_from(d, step=3)
    assert eng.hotswap_from(d, max_step=1) == 1
    (tmp_path / "empty").mkdir()
    with pytest.raises(NoVerifiedCheckpointError):
        eng.hotswap_from(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):  # the replica's boot contract
        eng.hotswap_from(str(tmp_path / "empty"))


def test_hotswap_under_concurrent_load(infer):
    """Refreshes racing live traffic (a flipper thread swapping the same
    weights back in): every request completes without error, between
    batches, never mid-batch."""
    eng = ServeEngine(infer=infer, watchdog_deadline_s=30.0)
    eng.warmup(np.zeros((1, 2), np.float32))
    params = infer.graph.params
    stop = threading.Event()

    def flipper():
        while not stop.is_set():
            eng.hotswap_params(params)
            time.sleep(0.005)

    t = threading.Thread(target=flipper, name="test-refresh-flipper",
                         daemon=True)
    with eng:
        t.start()
        try:
            stats = run_load(eng, rate_rps=80.0, duration_s=1.0,
                             make_inputs=z_inputs(2, seed=5), seed=6)
        finally:
            stop.set()
            t.join(timeout=10.0)
    assert not t.is_alive()
    assert stats["errors"] == 0 and stats["undrained"] == 0
    assert stats["completed"] > 0


def test_admission_depth_and_deadline_shed():
    """The depth bound sheds immediately; once a service rate is measured
    the deadline budget sheds arrivals whose estimated wait exceeds it;
    drain never splits a request and always takes an oversized head —
    with the JAX queue's numbers on the same sequence."""
    for mod in (admission_j, None):
        Q = admission_j.AdmissionQueue if mod else AdmissionQueue
        R = admission_j.Request if mod else Request
        Shed = admission_j.ShedError if mod else ShedError
        q = Q(max_depth=2, deadline_ms=100.0)
        r1, r2 = R(_mk(4)), R(_mk(4))
        q.submit(r1)
        q.submit(r2)
        with pytest.raises(Shed) as ei:
            q.submit(R(_mk(1)))                 # depth bound
        assert ei.value.depth == 2
        assert q.report()["shed_total"] == 1
        assert q.drain(max_rows=8) == [r1, r2]
        assert q.depth() == 0
        # 100 rows/s measured: 4 queued rows + 8 more = 120 ms > 100 ms
        q.note_dispatch(rows=100, seconds=1.0)
        q.submit(R(_mk(4)))
        with pytest.raises(Shed) as ei:
            q.submit(R(_mk(8)))                 # deadline budget
        assert ei.value.est_wait_ms == pytest.approx(120.0)
        assert ei.value.budget_ms == 100.0
        big = R(_mk(100))
        q2 = Q()
        q2.submit(big)
        assert q2.drain(max_rows=64) == [big]
        rep = q.report()
        if mod:
            rep_j = rep
        else:
            assert rep == rep_j


def test_dispatch_hang_fails_typed_and_recovers(infer):
    """A wedged dispatch (the chaos seam parks in a polled sleep) trips
    the watchdog: the in-flight request fails with the typed
    ``WatchdogTimeout`` and the engine re-arms and serves again."""
    eng = ServeEngine(infer=infer, watchdog_deadline_s=1.0)
    eng.warmup(np.zeros((1, 2), np.float32))
    hung, release, fired = threading.Event(), threading.Event(), []

    def hook():
        if not fired:
            fired.append(1)
            hung.set()
            while not release.is_set():
                time.sleep(0.05)

    with eng:
        eng.generate(*_mk(4), timeout=120.0)          # healthy first
        engine_mod._chaos_dispatch_hook = hook
        try:
            req = eng.submit(*_mk(8))
            assert hung.wait(30.0)                    # dispatch parked
            with pytest.raises(WatchdogTimeout):
                req.result(timeout=60.0)              # typed, bounded
            assert eng.report()["timeouts_total"] == 1
            out = eng.generate(*_mk(4), timeout=120.0)
            assert out[0].shape[0] == 4
        finally:
            engine_mod._chaos_dispatch_hook = None
            release.set()
        assert eng.report()["ok"] is True


def test_dispatch_exception_fails_batch_typed_keeps_serving(infer):
    """A poison batch (a malformed request past submit validation)
    raises on the dispatch thread: that batch fails with
    ``DispatchError`` (the cause chained), the thread survives, the next
    request is served."""
    eng = ServeEngine(infer=infer, supervise=False)
    eng.warmup(np.zeros((1, 2), np.float32))
    good = Request(_mk(4, seed=31))
    bad = Request((np.zeros((4, 3), np.float32),))  # wrong trailing dim
    eng.admission.submit(good)
    eng.admission.submit(bad)
    with eng:
        with pytest.raises(DispatchError) as ei:
            bad.result(timeout=60.0)
        assert ei.value.__cause__ is not None
        with pytest.raises(DispatchError):
            good.result(timeout=60.0)  # same poisoned batch
        assert eng.running
        out = eng.generate(*_mk(4, seed=32), timeout=120.0)
        assert out[0].shape[0] == 4
        rep = eng.report()
        assert rep["errors_total"] == 1 and rep["timeouts_total"] == 0


def test_submit_rejects_malformed_before_admission(warm_engine):
    before = warm_engine.admission.report()["admitted_total"]
    with pytest.raises(ValueError):                    # trailing shape
        warm_engine.submit(np.zeros((4, 3), np.float32))
    with pytest.raises(ValueError):                    # extra dim
        warm_engine.submit(np.zeros((4, 2, 1), np.float32))
    with pytest.raises(ValueError):                    # dtype
        warm_engine.submit(np.zeros((4, 2), np.float64))
    with pytest.raises(ValueError):                    # input count
        warm_engine.submit(np.zeros((4, 2), np.float32),
                           np.zeros((4, 2), np.float32))
    with pytest.raises(TypeError, match="TraceContext"):  # not a trace
        warm_engine.submit(*_mk(4), trace=object())
    assert warm_engine.admission.report()["admitted_total"] == before
    out = warm_engine.generate(*_mk(4, seed=33), timeout=120.0)
    assert out[0].shape[0] == 4


def test_stop_closes_admission_and_restart_reopens(infer):
    q = AdmissionQueue()
    q.close()
    with pytest.raises(RuntimeError):
        q.submit(Request(_mk(1)))
    q.reopen()
    q.submit(Request(_mk(1)))
    eng = ServeEngine(infer=infer, supervise=False)
    with pytest.raises(RuntimeError):        # not started
        eng.submit(*_mk(4))
    req = Request(_mk(4))
    eng.admission.submit(req)
    eng.start()
    eng.stop()
    assert req.done.wait(30.0)               # answered, never stranded
    with pytest.raises(RuntimeError):        # closed, not stranded
        eng.admission.submit(Request(_mk(4)))
    eng.start()                              # restart serves again
    try:
        out = eng.generate(*_mk(4, seed=34), timeout=120.0)
        assert out[0].shape[0] == 4
    finally:
        eng.stop()


def test_watchdog_reraise_inside_recovery_survives(infer):
    """A second WatchdogTimeout landing INSIDE the recovery handler: the
    failed batch still gets a typed answer and the loop keeps serving."""
    eng = ServeEngine(infer=infer, supervise=False)
    eng.warmup(np.zeros((1, 2), np.float32))
    orig = eng._on_error
    calls = []

    def flaky(exc):
        if not calls:
            calls.append(exc)
            raise WatchdogTimeout("second delivery mid-recovery")
        orig(exc)

    eng._on_error = flaky
    bad = Request((np.zeros((4, 3), np.float32),))
    eng.admission.submit(bad)
    with eng:
        with pytest.raises((WatchdogTimeout, DispatchError)):
            bad.result(timeout=60.0)
        assert calls and eng.running
        out = eng.generate(*_mk(4, seed=35), timeout=120.0)
        assert out[0].shape[0] == 4


def test_engine_needs_a_bucketed_inference(gens):
    with pytest.raises(ValueError, match="bucketed"):
        ServeEngine(infer=ParallelInference(gens[1]))
    with pytest.raises(ValueError, match="graph or"):
        ServeEngine()
    assert torch.equal(ServeEngine(gens[1]).infer.params[
        "gen_dense_layer_2"]["W"], gens[1].params["gen_dense_layer_2"]["W"])
