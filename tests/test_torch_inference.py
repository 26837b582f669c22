"""The port's bucketed inference (``parallel/inference.py``), the device
helpers it waits with (``utils/device.py``) and the hang watchdog
(``train/watchdog.py``), held against the JAX package on the CPU.

One DCGAN-MNIST generator at full width: the JAX graph built by
``M.build_generator()``, its params carried into the port's graph by
``interop``; the JAX ``ParallelInference`` runs on a one-device CPU mesh.
The bucket plans are exact.  Outputs agree within ``ATOL`` / ``RTOL``:
both sides run f32 on the CPU, with other convolution code, so they
differ by rounding only (measured: 6e-8 at most).  On the CPU the port's
``ParallelInference`` runs the eager forward and captures no graph; the
CUDA graphs are checked on the card by ``chip_smoke.py``'s ``serve``
phase.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.parallel import data_mesh
from gan_deeplearning4j_tpu.parallel.inference import (
    ParallelInference as ParallelInferenceJ,
)
from gan_deeplearning4j_tpu.serve.engine import ServeEngine as ServeEngineJ
from gan_deeplearning4j_tpu.train import watchdog as watchdog_j
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.parallel.inference import (
    DEFAULT_SERVING_BUCKETS,
    ParallelInference,
)
from gan_deeplearning4j_tpu_torch.serve.engine import ServeEngine
from gan_deeplearning4j_tpu_torch.train import watchdog
from gan_deeplearning4j_tpu_torch.utils import device as device_lib

BUCKETS = (8, 32, 64)
ROWS = (1, 5, 8, 32, 64, 70, 130)
# port CPU against JAX CPU, both f32: rounding only
ATOL, RTOL = 1e-6, 1e-5


def _z(rows, seed=0):
    return (np.random.RandomState(seed).rand(rows, 2).astype(np.float32)
            * 2 - 1)


@pytest.fixture(scope="module")
def pair(cpu_devices):
    """(JAX inference, port inference) over the same generator weights."""
    gj = MJ.build_generator()
    gt = MT.build_generator(device="cpu")
    gt.params = interop.params_from_numpy(
        jax.tree.map(np.asarray, gj.params), "cpu", like=gt.params)
    return (ParallelInferenceJ(gj, mesh=data_mesh(1), buckets=BUCKETS),
            ParallelInference(gt, buckets=BUCKETS))


def test_default_buckets_are_the_jax_ones():
    from gan_deeplearning4j_tpu.parallel import inference as inference_j

    assert DEFAULT_SERVING_BUCKETS == inference_j.DEFAULT_SERVING_BUCKETS


@pytest.mark.parametrize("buckets", [BUCKETS, (4,), (1, 3, 10), (16, 48)],
                         ids=str)
def test_bucket_for_and_plan_match_jax(cpu_devices, buckets):
    """For every row count 1-200: the covering bucket and the engine's
    segment plan (one covering bucket, or largest-bucket chunks with the
    tail covered) are the JAX ones, exactly."""
    gj = MJ.build_generator()
    pj = ParallelInferenceJ(gj, mesh=data_mesh(1), buckets=buckets)
    pt = ParallelInference(MT.build_generator(device="cpu"), buckets=buckets)
    ej = ServeEngineJ(infer=pj, supervise=False)
    et = ServeEngine(infer=pt, supervise=False)
    for rows in range(1, 201):
        assert pt.bucket_for(rows) == pj.bucket_for(rows), rows
        assert et._plan(rows) == ej._plan(rows), rows


@pytest.mark.parametrize("rows", ROWS)
def test_output_matches_jax(pair, rows):
    """Pad-up, exact-bucket and chunked (70 = 64 + 8, 130 = 64 + 64 + 8)
    row counts: the port's output against the JAX ``ParallelInference``'s
    on the same latents and weights."""
    pj, pt = pair
    z = _z(rows, seed=100 + rows)
    want = [np.asarray(o) for o in pj.output(z)]
    got = pt.output(z)
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (rows, 1, 28, 28)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_output_matches_the_plain_graph_forward(pair):
    """Padding and chunking change nothing: the bucketed output is the
    graph's own forward of the same rows."""
    _, pt = pair
    z = _z(130, seed=7)
    ref = pt.graph.output(torch.from_numpy(z))[0]
    np.testing.assert_allclose(pt.output(z)[0].numpy(), ref.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert pt.captures == 0  # the CPU runs eager: no graphs


def test_unbucketed_max_batch_chunks_as_jax(pair):
    """Without buckets, ``max_batch`` splits an oversized input into
    sequential dispatches (the tail padded to the chunk), as in JAX."""
    pj, pt = pair
    ij = ParallelInferenceJ(pj.graph, mesh=data_mesh(1), max_batch=16)
    it = ParallelInference(pt.graph, max_batch=16)
    z = _z(40, seed=3)
    np.testing.assert_allclose(it.output(z)[0].numpy(),
                               np.asarray(ij.output(z)[0]),
                               rtol=RTOL, atol=ATOL)


def test_output_needs_an_input(pair):
    pj, pt = pair
    with pytest.raises(ValueError) as ej:
        pj.output()
    with pytest.raises(ValueError) as et:
        pt.output()
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("kwargs", [
    {"buckets": ()}, {"buckets": (0, 8)}, {"buckets": (-8, 32)},
    {"max_batch": 0}, {"max_batch": 16, "buckets": (8, 32)},
    {"axis": "model"}], ids=str)
def test_constructor_validation_is_the_jax_one(pair, kwargs):
    """The same bad arguments raise the same ValueError, word for word."""
    pj, pt = pair
    with pytest.raises(ValueError) as ej:
        ParallelInferenceJ(pj.graph, mesh=data_mesh(1), **kwargs)
    with pytest.raises(ValueError) as et:
        ParallelInference(pt.graph, **kwargs)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("mesh", [2, 4])
def test_a_multi_device_world_is_not_ported(pair, mesh):
    with pytest.raises(NotImplementedError, match="item 10"):
        ParallelInference(pair[1].graph, mesh=mesh, buckets=BUCKETS)


def test_refresh_copies_into_the_snapshot_in_place(pair):
    """``refresh_params`` writes the graph's new params INTO the tensors
    the dispatches read (a captured graph keeps their addresses); the BN
    running statistics are part of the snapshot."""
    _, pt = pair
    it = ParallelInference(pt.graph, buckets=BUCKETS)
    snap = {(l, n): t for l, lp in it.params.items() for n, t in lp.items()}
    assert ("gen_batch_4", "mean") in snap and ("gen_batch_4", "var") in snap
    old = pt.graph.params
    z = _z(8, seed=4)
    before = it.output(z)[0].clone()
    try:
        pt.graph.params = {l: {n: t * 1.5 for n, t in lp.items()}
                           for l, lp in old.items()}
        stale = it.output(z)[0]
        assert torch.equal(stale, before)  # not refreshed yet
        it.refresh_params()
        for (l, n), t in snap.items():
            assert it.params[l][n] is t
            assert torch.equal(t, pt.graph.params[l][n])
        ref = pt.graph.output(torch.from_numpy(z))[0]
        np.testing.assert_allclose(it.output(z)[0].numpy(), ref.numpy(),
                                   rtol=1e-6, atol=1e-7)
        assert not torch.equal(it.output(z)[0], before)
    finally:
        pt.graph.params = old


def test_refresh_refuses_another_structure(pair):
    _, pt = pair
    it = ParallelInference(pt.graph, buckets=BUCKETS)
    old = pt.graph.params
    try:
        pt.graph.params = {**old, "gen_dense_layer_2": {
            "W": old["gen_dense_layer_2"]["W"][:1],
            "b": old["gen_dense_layer_2"]["b"]}}
        with pytest.raises(ValueError, match="gen_dense_layer_2.W"):
            it.refresh_params()
        pt.graph.params = {k: v for k, v in old.items()
                           if k != "gen_batch_1"}
        with pytest.raises(ValueError, match="layers"):
            it.refresh_params()
    finally:
        pt.graph.params = old


# -- utils/device.py --------------------------------------------------------


def test_overlap_device_get_keeps_the_tree():
    tree = {"a": [torch.arange(3.0), (torch.ones(2, 2), 5)], "b": "x"}
    got = device_lib.overlap_device_get(tree)
    assert isinstance(got["a"][0], np.ndarray)
    np.testing.assert_array_equal(got["a"][0], [0.0, 1.0, 2.0])
    assert isinstance(got["a"][1], tuple) and got["a"][1][1] == 5
    np.testing.assert_array_equal(got["a"][1][0], np.ones((2, 2)))
    assert got["b"] == "x"


def test_device_fence_calls_the_chaos_hook():
    calls = []
    prev = device_lib._chaos_readback_hook
    device_lib._chaos_readback_hook = lambda: calls.append(1)
    try:
        device_lib.device_fence([torch.zeros(2)])
    finally:
        device_lib._chaos_readback_hook = prev
    assert calls == [1]


# -- train/watchdog.py --------------------------------------------------------


@pytest.mark.parametrize("intervals", [
    [], [0.01, 0.02], [0.01, 0.02, 0.03, 0.5], [0.2] * 10, [1.0, 0.001]],
    ids=str)
@pytest.mark.parametrize("region", [None, "dispatch", "readback"])
def test_watchdog_deadline_math_is_the_jax_one(intervals, region):
    """The auto-scaled deadline (warm-up, rolling median x scale, floor,
    region floors) on the same beat history, exactly."""
    out = []
    for mod in (watchdog_j, watchdog):
        wd = mod.HeartbeatWatchdog(min_deadline_s=0.05, scale=20.0,
                                   warmup_s=300.0)
        with wd._lock:
            wd._last_beat = time.perf_counter()
            wd._samples.extend(intervals)
            wd._intervals = len(intervals)
            wd._saw_step_beat = bool(intervals)
            wd._region = region
        out.append(wd.effective_deadline())
    assert out[0] == out[1]


def test_watchdog_raises_into_a_stalled_thread_and_spares_a_beating_one():
    """A monitored thread that stops beating gets ``WatchdogTimeout``
    raised into it (its wait is a polled sleep, as the port's waits are);
    one that keeps beating is left alone.  Every wait is bounded."""
    got = {}

    def victim(beating: bool, key: str):
        wd = watchdog.HeartbeatWatchdog(deadline_s=0.3, poll_s=0.02)
        wd.start()
        try:
            t_end = time.monotonic() + 3.0
            while time.monotonic() < t_end:
                if beating:
                    wd.beat(step=1)
                time.sleep(0.01)
            got[key] = "survived"
        except watchdog.WatchdogTimeout:
            got[key] = "timeout"
            got[key + "_stalled"] = wd.report()["timeouts_total"]
        finally:
            wd.stop()

    threads = [threading.Thread(target=victim, args=(b, k), daemon=True)
               for b, k in ((False, "stalled"), (True, "beating"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert got["stalled"] == "timeout" and got["stalled_stalled"] == 1
    assert got["beating"] == "survived"
