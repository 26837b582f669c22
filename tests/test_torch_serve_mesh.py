"""The port's mesh tier (``serve/mesh.py``), control plane
(``serve/controlplane.py``) and replica fault injectors
(``testing/chaos.py``) held against the JAX package on the CPU.

* **decisions** — the ``Autoscaler`` and the ``CanaryDeployment`` decide
  as the JAX classes do on the same metric traces: the JAX unit cases and
  traces drawn from a seed.
* **in-process socket contracts** — the ``MeshRouter``'s typed routing
  against in-process gateways (a 429 tries the next replica, a 503 or a
  dead socket ejects, a 400 propagates, nobody healthy raises), the
  keep-alive client pool, the hot swap past a corrupt newest checkpoint,
  the network-path injectors, and the five serving reports rendered
  through the port's ``MetricsRegistry`` as the JAX registry renders them.
* **cross-process acceptance** — port replica processes spawned with
  ``--device cpu`` by the real launcher: ejection and re-admission under a
  wedge and a SIGKILL, then the three-part chaos run (a load ramp scales
  up; a SIGKILLed replica is replaced; checkpoints written by the port and
  by the JAX package from the same params deploy and serve the JAX
  generator's outputs; a poisoned canary rolls back, charging the budget,
  until the budget is spent).

Six replica spawns in the file (one that must fail, two, then three);
each takes ~3 s here.
"""

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
from gan_deeplearning4j_tpu.serve import (
    Autoscaler as AutoscalerJ,
    CanaryDeployment as CanaryDeploymentJ,
    ControlPlane as ControlPlaneJ,
    Gateway as GatewayJ,
    GatewayClient as GatewayClientJ,
    MeshRouter as MeshRouterJ,
    ReplicaLauncher as ReplicaLauncherJ,
    Router as RouterJ,
    ServeEngine as ServeEngineJ,
)
from gan_deeplearning4j_tpu.telemetry import exporter as XJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
    CheckpointCorruptError,
    NoVerifiedCheckpointError,
    TrainCheckpointer,
)
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from gan_deeplearning4j_tpu_torch.serve import (
    Autoscaler,
    CanaryDeployment,
    ControlPlane,
    DeploymentRollbackError,
    Gateway,
    GatewayClient,
    GatewayHTTPError,
    MeshRouter,
    NoHealthyReplicaError,
    RemoteReplica,
    ReplicaLauncher,
    ReplicaSpawnError,
    Router,
    ServeEngine,
    run_socket_load,
    z_inputs,
)
from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.telemetry import exporter as XT
from gan_deeplearning4j_tpu_torch.testing import chaos

BUCKETS = (8, 32)
REPLICA_ENV = {"OMP_NUM_THREADS": "1"}
# port CPU against JAX CPU, both f32: rounding only
ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's CPU ops on one thread while this module runs (then the
    process's setting again), as in the port's other heavy modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rows, seed=0):
    return np.random.RandomState(seed).rand(rows, 2).astype(
        np.float32) * 2 - 1


def _wait(pred, timeout_s, what):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if pred():
            return
        time.sleep(0.1)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


# -- decisions: the autoscaler -------------------------------------------------

HOT = {"queue_depth": 9, "p99_ms": 900.0, "shed_total": 0}
IDLE = {"queue_depth": 0, "p99_ms": 1.0, "shed_total": 0}
SCALER = dict(min_replicas=1, max_replicas=3, up_queue_depth=4.0,
              up_p99_ms=500.0, up_after=2, down_after=3, cooldown_ticks=2)


def _seeded_trace(seed, n=60):
    """A metric trace from a seed: bursts of heat, idle spells, noise and
    a growing shed total."""
    rng = np.random.RandomState(seed)
    shed, out = 0, []
    for _ in range(n):
        kind = rng.choice(["hot", "idle", "noise"], p=[.35, .35, .3])
        shed += int(rng.randint(0, 3)) if kind == "hot" else 0
        out.append({"queue_depth": {"hot": 8, "idle": 0,
                                    "noise": int(rng.randint(0, 6))}[kind],
                    "p99_ms": float({"hot": 800.0, "idle": 2.0,
                                     "noise": rng.uniform(0, 700)}[kind]),
                    "shed_total": shed})
    return out


# (trace, fixed replica count or None to follow the decisions, kwargs,
# the JAX test's expected decisions or None)
SCALER_CASES = {
    "noisy": ([HOT, IDLE] * 10, 2, {}, [0] * 20),
    "hysteresis": ([HOT] * 5, 1, {}, [0, 1, 0, 0, 1]),
    "ceiling": ([HOT] * 8, 3, {}, [0] * 8),
    "floor": ([IDLE] * 8, 1, {}, [0] * 8),
    "scale_down": ([IDLE] * 4, 2, {}, [0, 0, -1, 0]),
    "shed_growth": ([{"queue_depth": 0, "p99_ms": 1.0, "shed_total": s}
                     for s in (0, 3, 6)], 1, {"up_shed_delta": 1},
                    [0, 0, 1]),
    **{f"seed{s}": (_seeded_trace(s), None,
                    {"up_shed_delta": 2, "cooldown_ticks": s % 3}, None)
       for s in (0, 1, 2, 3)},
}


@pytest.mark.parametrize("case", sorted(SCALER_CASES))
def test_autoscaler_decides_as_jax(case):
    trace, fixed, kw, expected = SCALER_CASES[case]
    decisions = {}
    for name, cls in (("port", Autoscaler), ("jax", AutoscalerJ)):
        s = cls(**{**SCALER, **kw})
        n, out = 2, []
        for m in trace:
            d = s.tick(m, fixed if fixed is not None else n)
            n = min(max(n + d, 1), 3)
            out.append(d)
        decisions[name] = out
    assert decisions["port"] == decisions["jax"]
    if expected is not None:
        assert decisions["port"] == expected
    with pytest.raises(ValueError):
        Autoscaler(min_replicas=2, max_replicas=1)


# -- decisions: the canary -----------------------------------------------------

CANARY = dict(baseline_ms=10.0, hold_ticks=2, p99_factor=3.0,
              p99_floor_ms=50.0)


def _seeded_observations(seed, n=6):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        r = rng.rand()
        out.append(
            dict(probe_ms=None, finite=True, failure="OSError('reset')")
            if r < .1 else
            dict(probe_ms=float(rng.uniform(1, 70)), finite=bool(r > .2),
                 errors_delta=int(rng.rand() < .15)))
    return out


CANARY_CASES = {
    "promote": ([dict(probe_ms=12.0, finite=True),
                 dict(probe_ms=14.0, finite=True),
                 dict(probe_ms=9999.0, finite=False)], {},
                ["hold", "promote", "promoted"]),
    "non_finite": ([dict(probe_ms=12.0, finite=True),
                    dict(probe_ms=5.0, finite=False)], {},
                   ["hold", "rollback"]),
    "error_growth": ([dict(probe_ms=12.0, finite=True),
                      dict(probe_ms=5.0, finite=True, errors_delta=2)], {},
                     ["hold", "rollback"]),
    "failure": ([dict(probe_ms=12.0, finite=True),
                 dict(probe_ms=None, finite=True,
                      failure="DispatchError('boom')")], {},
                ["hold", "rollback"]),
    "slo_bound": ([dict(probe_ms=12.0, finite=True),
                   dict(probe_ms=60.0, finite=True)], {},
                  ["hold", "rollback"]),
    "floor_forgives": ([dict(probe_ms=40.0, finite=True)],
                       {"baseline_ms": 1.0, "hold_ticks": 1,
                        "p99_floor_ms": 250.0}, ["promote"]),
    "no_baseline": ([dict(probe_ms=1e6, finite=True)] * 3,
                    {"baseline_ms": None, "hold_ticks": 3},
                    ["hold", "hold", "promote"]),
    **{f"seed{s}": (_seeded_observations(s), {"hold_ticks": 3}, None)
       for s in (0, 1, 2, 3, 4)},
}


@pytest.mark.parametrize("case", sorted(CANARY_CASES))
def test_canary_decides_as_jax(case):
    obs, kw, expected = CANARY_CASES[case]
    runs = {}
    for name, cls in (("port", CanaryDeployment),
                      ("jax", CanaryDeploymentJ)):
        c = cls("/ckpt", 7, **{**CANARY, **kw})
        runs[name] = ([c.observe(**o) for o in obs], c.state, c.reason,
                      c.clean)
    assert runs["port"] == runs["jax"]
    if expected is not None:
        assert runs["port"][0] == expected


# -- in-process socket contracts -----------------------------------------------


@pytest.fixture(scope="module")
def gens(cpu_devices):
    """The JAX generator and the port's on the same params (interop)."""
    gj = MJ.build_generator()
    gt = MT.build_generator(device="cpu")
    gt.params = interop.params_from_numpy(
        jax.tree.map(np.asarray, gj.params), "cpu", like=gt.params)
    return gj, gt


@pytest.fixture(scope="module")
def infer(gens):
    return ParallelInference(gens[1], buckets=BUCKETS)


def _engine(infer, **kw):
    eng = ServeEngine(infer=infer, watchdog_deadline_s=30.0, **kw)
    eng.warmup(np.zeros((1, 2), np.float32))
    eng.start()
    return eng


@pytest.fixture()
def stack(infer):
    eng = _engine(infer)
    router = Router(replicas=[eng], recheck_s=0.2)
    gw = Gateway(router, read_timeout_s=2.0).start()
    yield gw, router
    gw.stop()
    router.stop()


def test_mesh_typed_routing_against_gateways(infer):
    """429 = alive and shedding: the next replica serves; 503 = broken:
    ejected, the next serves; a dead socket is ejected the same way; a
    400 propagates without an ejection; nobody healthy raises."""
    eng = _engine(infer)
    ok = Gateway(Router([eng])).start()
    # a per-tenant limiter of one token that never refills: the first
    # request passes, every later one is a 429
    shed = Gateway(Router([eng]), rate_limit=(1.0, 1e-6)).start()
    empty = Gateway(Router([])).start()   # 503: nothing behind the door
    dead = Gateway(Router([eng])).start()
    dead_port = dead.port
    dead.stop()
    rec = events.EventRecorder(ring_size=1024)
    prev = events.install(rec)
    meshes = []

    def mesh(*gws, port=None):
        m = MeshRouter([RemoteReplica("127.0.0.1", port or g.port)
                        for g in gws], recheck_s=30.0)
        meshes.append(m)
        return m

    try:
        z = _mk(4)
        want = eng.generate(z, timeout=60.0)[0]
        GatewayClient("127.0.0.1", shed.port).generate([z])  # its token
        m = mesh(shed, ok)
        np.testing.assert_array_equal(m.generate([z])[0], want)
        assert m.retried_total == 1
        assert m.report()["ejected_total"] == 0  # a shed is not broken
        with pytest.raises(GatewayHTTPError) as ei:
            mesh(shed).generate([z])
        assert ei.value.status == 429

        m = mesh(empty, ok)
        np.testing.assert_array_equal(m.generate([z])[0], want)
        rep = m.report()
        assert rep["ejected_total"] == 1 and rep["replica_ok"] == [False,
                                                                   True]
        # an ejected replica is skipped until recheck_s: ok serves alone
        np.testing.assert_array_equal(m.generate([z])[0], want)
        assert m.poll()["healthy"] == 1

        m = MeshRouter([RemoteReplica("127.0.0.1", dead_port),
                        RemoteReplica("127.0.0.1", ok.port)])
        meshes.append(m)
        np.testing.assert_array_equal(m.generate([z])[0], want)
        assert m.report()["ejected_total"] == 1

        m = mesh(ok)
        with pytest.raises(GatewayHTTPError) as ei:
            m.generate([np.zeros((4, 3), np.float32)])   # wrong width
        assert ei.value.status == 400
        assert m.report()["ejected_total"] == 0

        m = mesh(empty)
        with pytest.raises(NoHealthyReplicaError):
            m.generate([z])
        with pytest.raises(NoHealthyReplicaError):
            m.generate([z])       # still ejected: no second request sent
        with pytest.raises(NoHealthyReplicaError):
            MeshRouter().generate([z])
        with pytest.raises(ValueError):
            m.add(RemoteReplica("127.0.0.1", empty.port))
        assert m.remove("nowhere:1") is None
        assert m.names() == [f"127.0.0.1:{empty.port}"]
    finally:
        events.install(prev)
        for m in meshes:
            m.close()
        for g in (ok, shed, empty):
            g.stop()
        eng.stop()
    names = [e["name"] for e in rec.recent()]
    assert names.count("mesh.replica_ejected") == 3
    assert "trace.hop" in names
    assert sum(e["name"] == "trace.route" and e.get("parent") is None
               for e in rec.recent()) >= 5  # the mesh mints for its callers


def test_client_pool_reuses_keepalive_sockets(stack):
    gw, _ = stack
    client = GatewayClient("127.0.0.1", gw.port, retries=0, pool_size=2)
    try:
        outs = [client.generate([_mk(4, seed=i)])[0] for i in range(3)]
        for out in outs:
            assert out.shape == (4, 1, 28, 28) and np.isfinite(out).all()
        assert client.reused_total >= 2     # calls 2 and 3 ride call 1's
        assert client.reconnects_total == 0
    finally:
        client.close()


def test_client_pool_bounded_and_closeable(stack):
    gw, _ = stack
    with pytest.raises(ValueError):
        GatewayClient("127.0.0.1", gw.port, pool_size=-1)
    client = GatewayClient("127.0.0.1", gw.port, retries=0, pool_size=0)
    client.generate([_mk(4)])
    assert client.reused_total == 0
    client.close()
    # a closed pool degrades to connection-per-call, not failure
    assert np.isfinite(client.generate([_mk(4, seed=1)])[0]).all()
    assert client.reused_total == 0


def test_client_pool_typed_reconnect_on_stale_socket(infer):
    # the gateway restarts on the SAME port, so the pooled socket goes
    # stale exactly once
    eng = _engine(infer)
    router = Router(replicas=[eng], recheck_s=0.2)
    gw = Gateway(router, read_timeout_s=0.5).start()
    client = GatewayClient("127.0.0.1", gw.port, retries=0, pool_size=2)
    try:
        client.generate([_mk(4)])          # checks a socket in
        port = gw.port
        gw.stop()
        # the old handler holds the keep-alive socket until its idle read
        # times out (0.5 s): only then is the pooled socket stale
        time.sleep(1.2)
        gw = Gateway(router, port=port, read_timeout_s=0.5).start()
        assert np.isfinite(client.generate([_mk(4, seed=2)])[0]).all()
        assert client.reconnects_total == 1
    finally:
        client.close()
        gw.stop()
        router.stop()


def _corrupt(path):
    with open(path, "r+b") as f:
        f.seek(0)
        f.write(b"\x00TORN\x00" * 8)


def test_hotswap_skips_corrupt_newest_and_falls_back(infer, tmp_path):
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(1, {"gen": MT.build_generator(device="cpu")})
    ck.save(2, {"gen": MT.build_generator(device="cpu")})
    _corrupt(str(tmp_path / "ckpt_2" / "gen_model.zip"))
    assert not ck.verify(2) and ck.verify(1)
    eng = ServeEngine(infer=ParallelInference(
        MT.build_generator(device="cpu"), buckets=BUCKETS), supervise=False)
    rec = events.EventRecorder()
    prev = events.install(rec)
    try:
        got = eng.hotswap_from(str(tmp_path))
    finally:
        events.install(prev)
    assert got == 1
    rejected = [e for e in rec.recent()
                if e["name"] == "serve.hotswap_rejected"]
    assert rejected and rejected[0]["step"] == 2
    assert [e["step"] for e in rec.recent()
            if e["name"] == "serve.hotswap"] == [1]


def test_hotswap_explicit_corrupt_step_raises_typed(tmp_path):
    ck = TrainCheckpointer(str(tmp_path))
    ck.save(3, {"gen": MT.build_generator(device="cpu")})
    _corrupt(str(tmp_path / "ckpt_3" / "gen_model.zip"))
    eng = ServeEngine(infer=ParallelInference(
        MT.build_generator(device="cpu"), buckets=BUCKETS), supervise=False)
    with pytest.raises(CheckpointCorruptError):
        eng.hotswap_from(str(tmp_path), step=3)
    with pytest.raises(NoVerifiedCheckpointError):
        eng.hotswap_from(str(tmp_path))  # nothing verifiable left


def test_network_injectors_against_the_gateway(stack):
    """The port's slow-loris gets the 408 at the total read deadline, and
    a mid-body hang-up is counted and absorbed."""
    gw, router = stack
    # 200 bytes at 20 a second: 10 s of body against a 2 s deadline
    loris = chaos.SlowLorisClient(
        "127.0.0.1", gw.port, body=b'{"inputs": [[[0.0, 0.0]]]}' + b" " * 174,
        drip_interval_s=0.05)
    status, elapsed, sent = loris.run(max_s=30.0)
    assert status == 408 and elapsed < 8.0 and sent < len(loris.body)
    assert gw.report()["rejected_by_type"]["slow_body"] == 1
    assert chaos.mid_body_disconnect("127.0.0.1", gw.port, frac=0.5) > 0
    _wait(lambda: gw.report()["rejected_by_type"].get("disconnect", 0) >= 1,
          10, "the disconnect count")
    client = GatewayClient("127.0.0.1", gw.port, retries=0)
    assert np.isfinite(client.generate([_mk(3)])[0]).all()
    client.close()
    assert chaos.kill_replica(router, 0) is router.replicas[0]
    assert router.report()["replicas_healthy"] == 0
    with pytest.raises(ValueError):
        chaos.mid_body_disconnect("127.0.0.1", gw.port, frac=1.0)


def test_poisoned_checkpoint_verifies_in_both_and_serves_nan(gens, tmp_path):
    """The forged newest checkpoint is not torn: both checkpointers verify
    it and restore NaN params from it, and its older step is intact."""
    gj, gt = gens
    d = str(tmp_path)
    TrainCheckpointer(d).save(4, {"gen": gt})
    bad = chaos.poison_checkpoint_dir(d)
    assert bad == 5
    assert TrainCheckpointer(d, sweep_debris=False).verify(5)
    assert TrainCheckpointerJ(d, sweep_debris=False).verify(5)
    g = MT.build_generator(device="cpu")
    TrainCheckpointer(d, sweep_debris=False).restore({"gen": g})
    assert all(bool(torch.isnan(t).all()) for lp in g.params.values()
               for t in lp.values())
    gjx = MJ.build_generator()
    got, _ = TrainCheckpointerJ(d, sweep_debris=False).restore({"gen": gjx})
    assert got == 5
    assert all(np.isnan(np.asarray(a)).all()
               for a in jax.tree.leaves(gjx.params))
    TrainCheckpointer(d, sweep_debris=False).restore({"gen": g}, step=4)
    for layer, lp in gt.params.items():
        for n, t in lp.items():
            assert torch.equal(g.params[layer][n], t)
    with pytest.raises(FileNotFoundError):
        chaos.poison_checkpoint_dir(str(tmp_path / "empty"))


def test_serving_reports_render_the_jax_series(gens, stack, monkeypatch):
    """Each serving report carries the JAX report's keys, and the five fed
    to the port's registry render the JAX registry's text for the same
    reports, with live request counts."""
    gw, _ = stack
    client = GatewayClient("127.0.0.1", gw.port, retries=0)
    mesh = MeshRouter([RemoteReplica("127.0.0.1", gw.port)])
    cp = ControlPlane(ReplicaLauncher(device="cpu"), mesh=mesh)
    try:
        for i in range(3):
            client.generate([_mk(4, seed=i)])
        mesh.generate([_mk(2)])
        eng = gw.router.replicas[0]
        reports = {"serve": eng.report(), "gateway": gw.report(),
                   "client": client.report(), "serving_mesh": mesh.report(),
                   "controlplane": cp.report()}
    finally:
        client.close()
        mesh.close()
    jax_objs = {
        "serve": ServeEngineJ(infer=ParallelInferenceJ(
            gens[0], mesh=data_mesh(1), buckets=BUCKETS)),
        "gateway": GatewayJ(RouterJ([])),
        "client": GatewayClientJ("127.0.0.1", 1),
        "serving_mesh": MeshRouterJ(),
        "controlplane": ControlPlaneJ(ReplicaLauncherJ()),
    }
    for name, obj in jax_objs.items():
        assert set(reports[name]) == set(obj.report()), name
    for X in (XT, XJ):
        monkeypatch.setattr(X.time, "time", lambda: 1.8e9)
    text = {}
    for pkg, X in (("port", XT), ("jax", XJ)):
        reg = X.MetricsRegistry()
        for name, rep in reports.items():
            getattr(reg, f"observe_{name}")(lambda rep=rep: rep)
        text[pkg] = (reg.render(), reg.health())
    assert text["port"] == text["jax"]
    rendered = text["port"][0]
    assert "gan4j_serve_requests_total 4.0" in rendered
    assert "gan4j_gateway_requests_total 4.0" in rendered
    assert "gan4j_mesh_replicas_healthy 1.0" in rendered
    assert "gan4j_client_reused_total 2.0" in rendered
    assert "gan4j_controlplane_replicas 0.0" in rendered


def test_a_replica_without_a_card_fails_the_spawn(tmp_path):
    """Told nothing, a replica wants the card: on a host without one the
    child exits non-zero before its ready line, and the spawn raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default device is valid")
    launcher = ReplicaLauncher(log_dir=str(tmp_path), env=REPLICA_ENV,
                               ready_timeout_s=120.0)
    with pytest.raises(ReplicaSpawnError, match="before its ready line") \
            as ei:
        launcher.spawn()
    assert "device='cpu'" in open(ei.value.log_path).read()


# -- cross-process: mesh ejection and re-admission over real sockets -----------


def test_mesh_wedge_eject_readmit_and_kill(tmp_path):
    launcher = ReplicaLauncher(buckets=(8, 16), log_dir=str(tmp_path),
                               env=REPLICA_ENV, device="cpu")
    rec = events.EventRecorder(ring_size=1024)
    prev = events.install(rec)
    procs, mesh = [], MeshRouter(recheck_s=0.3)
    try:
        for _ in range(2):
            p = launcher.spawn()
            procs.append(p)
            mesh.add(RemoteReplica(p.host, p.port))
        out = mesh.generate([_mk(4)])[0]
        assert out.shape == (4, 1, 28, 28) and np.isfinite(out).all()
        assert mesh.poll()["healthy"] == 2

        # wedge replica 0: it answers 503 while listening -> ejected,
        # traffic keeps flowing through replica 1
        ack = chaos.wedge_replica(procs[0].host, procs[0].port, seconds=1.2)
        assert ack == {"wedged_s": 1.2}
        _wait(lambda: mesh.poll()["healthy"] == 1, 10,
              "wedged replica ejection")
        for i in range(3):
            assert np.isfinite(mesh.generate([_mk(4, seed=i)])[0]).all()
        assert mesh.report()["ejected_total"] >= 1

        # the wedge expires -> the bounded re-probe re-admits it
        _wait(lambda: mesh.poll()["healthy"] == 2, 10,
              "wedge recovery re-admission")

        # SIGKILL replica 1: dead socket -> typed ejection, traffic keeps
        # flowing through replica 0
        assert chaos.kill_replica_process(procs[1]) == procs[1].pid
        assert not procs[1].alive()
        for i in range(3):
            assert np.isfinite(
                mesh.generate([_mk(4, seed=10 + i)])[0]).all()
        assert mesh.poll()["healthy"] == 1
        rep = mesh.report()
        assert rep["replicas_healthy"] == 1 and rep["ok"]

        # nobody left -> typed, not a hang
        mesh.remove(procs[0].name)
        procs[0].stop()
        assert procs[0].proc.returncode == 0   # SIGTERM drains
        with pytest.raises(NoHealthyReplicaError):
            mesh.generate([_mk(4)])
    finally:
        events.install(prev)
        mesh.close()
        for p in procs:
            p.kill()
    names = [e["name"] for e in rec.recent()]
    assert "mesh.replica_ejected" in names
    assert "mesh.replica_restored" in names
    assert "mesh.replica_removed" in names


# -- cross-process: the three-part chaos acceptance run ------------------------


def test_chaos_acceptance_end_to_end(gens, tmp_path):
    """A load ramp trips scale-up; a SIGKILLed replica is ejected and
    replaced; checkpoints written by the port and by the JAX package from
    the same params deploy and serve the JAX generator's outputs; a
    poisoned canary auto-rolls back charging the budget until it is spent.
    Zero non-typed failures, one contiguous events timeline."""
    gj, gt = gens
    ckdir, jdir = str(tmp_path / "ckpt"), str(tmp_path / "ckpt_jax")
    TrainCheckpointer(ckdir).save(1, {"gen": gt})
    TrainCheckpointerJ(jdir).save(1, {"gen": gj})

    events_path = str(tmp_path / "events.jsonl")
    recorder = events.EventRecorder(path=events_path, ring_size=4096)
    prev = events.install(recorder)

    launcher = ReplicaLauncher(buckets=(8, 16), log_dir=str(tmp_path),
                               env=REPLICA_ENV, device="cpu")
    scaler = Autoscaler(min_replicas=1, max_replicas=2, up_queue_depth=1.0,
                        up_p99_ms=5.0, up_after=1, down_after=10_000,
                        cooldown_ticks=2)
    # p99_floor_ms is wide open: part 3 tests the NaN gate, and a loaded
    # runner must not trip the latency gate on a CLEAN deploy
    cp = ControlPlane(launcher, autoscaler=scaler, tick_s=0.25,
                      hold_ticks=2, max_rollbacks=2, probe_timeout_s=30.0,
                      p99_floor_ms=10_000.0)

    def settled(what):
        _wait(lambda: cp.deployment_status()["state"]
              not in ("pending", "canary"), 60, what)
        return cp.deployment_status()

    try:
        cp.start()
        first = cp.replica_names()
        assert len(first) == 1
        assert cp.process(first[0]).ready_s > 0

        # -- part 1: load ramp -> scale-up, and the NEW replica serves
        host, port = first[0].rsplit(":", 1)
        client = GatewayClient(host, int(port), retries=0, timeout_s=30.0)
        res = run_socket_load(client, rate_rps=60.0, n_requests=50,
                              size_mix=((8, 1.0),), make_inputs=z_inputs(2),
                              encoding="npy", max_workers=8)
        client.close()
        assert res["errors"] == 0, res  # sheds are typed; errors are not
        _wait(lambda: len(cp.replica_names()) == 2, 45,
              "autoscaler scale-up to 2 replicas")
        assert cp.report()["scale_up_total"] >= 1
        new_name = (set(cp.replica_names()) - set(first)).pop()
        nhost, nport = new_name.rsplit(":", 1)
        fresh = RemoteReplica(nhost, int(nport))
        try:
            out = fresh.generate([_mk(4)])[0]
            assert out.shape == (4, 1, 28, 28) and np.isfinite(out).all()
        finally:
            fresh.close()

        # -- part 2: SIGKILL one replica -> ejected, replaced, healthy
        victim = cp.replica_names()[0]
        chaos.kill_replica_process(cp.process(victim))
        _wait(lambda: cp.report()["replaced_total"] >= 1, 45,
              "dead replica replacement")
        _wait(lambda: len(cp.replica_names()) == 2, 45,
              "fleet back to 2 replicas")
        assert victim not in cp.replica_names()

        # -- part 3: the port's checkpoint and the JAX package's, of the
        # same params, each promote and serve the JAX generator's outputs
        z = _mk(6, seed=3)
        want = np.asarray(gj.output(z)[0])
        for directory in (ckdir, jdir):
            cp.deploy(directory)
            status = settled(f"clean deploy of {directory}")
            assert status["state"] == "promoted", status
            for _ in cp.replica_names():   # one request per replica
                np.testing.assert_allclose(cp.mesh.generate([z])[0], want,
                                           rtol=RTOL, atol=ATOL)

        # a poisoned deploy rolls back and charges the budget
        bad_step = chaos.poison_checkpoint_dir(ckdir)
        assert TrainCheckpointer(ckdir, sweep_debris=False).verify(bad_step)
        cp.deploy(ckdir)
        status = settled("poisoned deploy")
        assert status["state"] == "rolled_back", status
        assert status["restored_step"] == 1
        assert "non-finite" in status["reason"]
        rep = cp.report()
        assert rep["rollbacks_total"] == 1   # the budget was charged
        assert rep["promoted_total"] == 2
        assert rep["fatal"] is None and rep["ok"]
        np.testing.assert_allclose(cp.mesh.generate([z])[0], want,
                                   rtol=RTOL, atol=ATOL)

        # the budget is finite: exhausting it is FATAL and typed
        cp.deploy(ckdir)
        settled("second poisoned deploy")
        cp.deploy(ckdir)
        assert settled("final poisoned deploy")["state"] == "failed_fatal"
        with pytest.raises(DeploymentRollbackError):
            cp.deploy(ckdir)
        assert not cp.report()["ok"]
    finally:
        cp.stop()
        events.install(prev)
        recorder.close()

    # -- one contiguous timeline covering all three parts.  trace.* spans
    # are written at span EXIT carrying their START time, so they are left
    # out of the monotonicity check
    evs = [e for e in events.read_events(events_path)
           if e["name"] != "recorder.start"
           and not e["name"].startswith("trace.")]
    ts = [e["t"] for e in evs]
    assert ts == sorted(ts)
    names = [e["name"] for e in evs]
    for must in ("controlplane.replica_spawned", "controlplane.scale_up",
                 "controlplane.replica_replaced",
                 "controlplane.canary_start", "controlplane.promoted",
                 "controlplane.rollback", "controlplane.deploy_fatal",
                 "controlplane.start", "controlplane.stop"):
        assert must in names, f"missing {must} in the timeline"
    order = [names.index(n) for n in (
        "controlplane.replica_spawned", "controlplane.scale_up",
        "controlplane.replica_replaced", "controlplane.canary_start",
        "controlplane.promoted")]
    assert order == sorted(order)
    assert (names.index("controlplane.promoted")
            < names.index("controlplane.rollback")
            < names.index("controlplane.deploy_fatal"))
    assert all(e["ready_s"] > 0 for e in evs
               if e["name"] == "controlplane.replica_spawned")
