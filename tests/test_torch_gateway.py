"""The port's network front door (``serve/gateway.py``, ``router.py``,
``client.py``) and the replica process (``serve/replica.py``), held
against the JAX package on the CPU.

The gateway is an ADAPTER: a request over the socket returns the SAME
BYTES as ``ServeEngine.submit`` called directly, in both wire formats
(npy/npz bit-exact by construction; JSON because float32 -> shortest-repr
JSON -> float32 is the identity).  The wire contract (statuses, error
types, ``Retry-After``) is the JAX gateway's, and the two packages'
clients and gateways interoperate in both directions: that pins the
format.  Every socket binds port 0, every wait is bounded, and no test
asserts a latency, a rate or a percentile measured on the CPU.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.client import HTTPConnection
from pathlib import Path

import jax
import numpy as np
import pytest

from gan_deeplearning4j_tpu.checkpoint.checkpointer import (
    TrainCheckpointer as TrainCheckpointerJ,
)
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.parallel import data_mesh
from gan_deeplearning4j_tpu.parallel.inference import (
    ParallelInference as ParallelInferenceJ,
)
from gan_deeplearning4j_tpu.serve import (
    Gateway as GatewayJ,
    GatewayClient as GatewayClientJ,
    Router as RouterJ,
    ServeEngine as ServeEngineJ,
    TokenBucket as TokenBucketJ,
)
from gan_deeplearning4j_tpu.testing.chaos import (
    SlowLorisClient,
    mid_body_disconnect,
)
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from gan_deeplearning4j_tpu_torch.serve import (
    AdmissionQueue,
    FleetTenantBank,
    Gateway,
    GatewayClient,
    GatewayHTTPError,
    Router,
    ServeEngine,
    TokenBucket,
    run_socket_load,
    z_inputs,
)
from gan_deeplearning4j_tpu_torch.serve import engine as engine_mod
from gan_deeplearning4j_tpu_torch.serve import replica

REPO = Path(__file__).resolve().parents[1]
BUCKETS = (8, 32, 64)
# port CPU against JAX CPU, both f32: rounding only
ATOL, RTOL = 1e-6, 1e-5


def _mk(rows, seed=0):
    return np.random.RandomState(seed).rand(rows, 2).astype(
        np.float32) * 2 - 1


def _engine(infer, admission=None):
    eng = ServeEngine(infer=infer, admission=admission,
                      watchdog_deadline_s=30.0)
    eng.warmup(np.zeros((1, 2), np.float32))
    eng.start()
    return eng


@pytest.fixture(scope="module")
def gens(cpu_devices):
    gj = MJ.build_generator()
    gt = MT.build_generator(device="cpu")
    gt.params = interop.params_from_numpy(
        jax.tree.map(np.asarray, gj.params), "cpu", like=gt.params)
    return gj, gt


@pytest.fixture(scope="module")
def infer(gens):
    return ParallelInference(gens[1], buckets=BUCKETS)


@pytest.fixture(scope="module")
def stack(infer):
    """A started 2-replica router behind a gateway, plus a client.  The
    admission budget is roomy: these tests pin the wire, not the shed
    policy, and a loaded CPU runner's small-batch service rate can make
    the default 1 s budget shed a 70-row request."""
    engines = [_engine(infer, admission=AdmissionQueue(deadline_ms=60_000.0))
               for _ in range(2)]
    router = Router(replicas=engines, recheck_s=0.2)
    gw = Gateway(router, read_timeout_s=1.0).start()
    client = GatewayClient("127.0.0.1", gw.port, retries=2,
                           backoff_s=0.02, seed=5)
    yield gw, router, client
    client.close()
    gw.stop()
    router.stop()


def _raw(port, method, path, body=None, headers=()):
    conn = HTTPConnection("127.0.0.1", port, timeout=30.0)
    try:
        conn.request(method, path, body=body, headers=dict(headers))
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("rows", [3, 8, 20, 70])
@pytest.mark.parametrize("encoding", ["json", "npy"])
def test_roundtrip_bitequal_both_encodings(stack, rows, encoding):
    """A socket request returns the SAME BYTES as a direct engine
    submit, for both wire formats; the reply carries Server-Timing."""
    gw, router, client = stack
    z = _mk(rows, seed=40 + rows)
    want = router.replicas[0].submit(z).result(timeout=120.0)
    got = client.generate([z], encoding=encoding)
    assert len(got) == len(want) == 1
    assert got[0].dtype == np.float32 and got[0].shape == (rows, 1, 28, 28)
    assert np.array_equal(got[0], want[0])
    ctype = ("application/json" if encoding == "json"
             else "application/x-npy")
    body = (json.dumps({"inputs": [z.tolist()]}).encode()
            if encoding == "json" else _npy(z))
    status, headers, _ = _raw(gw.port, "POST", "/v1/generate", body,
                              (("Content-Type", ctype),))
    assert status == 200
    assert {k.split(";")[0] for k in
            headers["Server-Timing"].split(", ")} == {
        "rate_limit", "wire_recv", "decode", "dispatch"}


def _npy(x):
    import io

    buf = io.BytesIO()
    np.save(buf, x, allow_pickle=False)
    return buf.getvalue()


def test_healthz_ok(stack):
    gw, router, client = stack
    doc = client.healthz()
    assert doc["_status"] == 200
    blk = doc["gateway"]
    assert blk["ok"] is True
    assert blk["replicas"] == 2 and blk["replicas_healthy"] == 2
    assert set(blk) == {"requests_total", "rejected_total",
                        "rejected_by_type", "active_connections",
                        "replicas", "replicas_healthy", "ejected_total",
                        "tenants_live", "ok"}


def test_wire_error_contract(stack):
    """400 validation, 404 route/tenant, 405 method, 413 oversized (from
    the header, the body never read); every reject carries a JSON
    ``type``; the replicas are unharmed."""
    gw, router, client = stack

    def err(status, *args, **kw):
        s, _, data = _raw(gw.port, *args, **kw)
        assert s == status, (args[1], s, data)
        return json.loads(data.decode())["type"]

    js = (("Content-Type", "application/json"),)
    assert err(405, "GET", "/v1/generate") == "method"
    assert err(405, "GET", "/admin/hotswap") == "method"
    assert err(404, "GET", "/nothing") == "route"
    assert err(404, "POST", "/v1/nothing", body=b"x", headers=js) == "route"
    assert err(404, "POST", "/admin/nothing", body=b"{}",
               headers=js) == "route"
    assert err(400, "POST", "/v1/generate") == "validation"  # no body
    assert err(400, "POST", "/v1/generate", body=b"{nope",
               headers=js) == "validation"
    assert err(400, "POST", "/v1/generate", body=b"\x00" * 64,
               headers=(("Content-Type", "application/x-npy"),)
               ) == "validation"
    bad = json.dumps({"inputs": [[[0.0, 0.0, 0.0]]]}).encode()
    assert err(400, "POST", "/v1/generate", body=bad,
               headers=js) == "validation"           # engine validation
    wrong_dtype = _npy(np.zeros((2, 2), np.float64))
    assert err(400, "POST", "/v1/generate", body=wrong_dtype,
               headers=(("Content-Type", "application/x-npy"),)
               ) == "validation"
    conn = HTTPConnection("127.0.0.1", gw.port, timeout=30.0)
    try:
        conn.putrequest("POST", "/v1/generate")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(1 << 30))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 413
        assert json.loads(resp.read().decode())["type"] == "validation"
    finally:
        conn.close()
    # a tenant route with no tenant bank: 404, as the JAX gateway answers
    with pytest.raises(GatewayHTTPError) as ei:
        client.generate([_mk(2)], tenant="7")
    assert ei.value.status == 404
    assert ei.value.error_type == "unknown_tenant"
    assert router.report()["replicas_healthy"] == 2


def test_shed_is_429_with_retry_after(infer):
    """Admission shedding on the wire: a dispatch parked in the chaos
    seam holds the queue at its depth bound, the next request is a 429
    ``shed`` with an integral ``Retry-After``; released, the parked
    requests complete."""
    eng = _engine(infer, admission=AdmissionQueue(max_depth=1))
    parked, release = threading.Event(), threading.Event()

    def hook():
        parked.set()
        while not release.is_set():
            time.sleep(0.02)

    results = []
    try:
        with Gateway(Router([eng])) as gw:
            client = GatewayClient("127.0.0.1", gw.port, retries=0)
            engine_mod._chaos_dispatch_hook = hook

            def call(rows):
                try:
                    results.append(client.generate([_mk(rows)])[0].shape)
                except GatewayHTTPError as e:
                    results.append(e)

            first = threading.Thread(target=call, args=(2,), daemon=True)
            first.start()
            assert parked.wait(30.0)          # in dispatch, queue empty
            engine_mod._chaos_dispatch_hook = None
            second = threading.Thread(target=call, args=(3,), daemon=True)
            second.start()
            deadline = time.monotonic() + 30.0
            while (eng.admission.depth() < 1
                   and time.monotonic() < deadline):
                time.sleep(0.01)
            assert eng.admission.depth() == 1  # at the bound
            status, headers, data = _raw(
                gw.port, "POST", "/v1/generate",
                json.dumps({"inputs": [_mk(1).tolist()]}).encode(),
                (("Content-Type", "application/json"),))
            assert status == 429
            assert json.loads(data.decode())["type"] == "shed"
            assert int(headers["Retry-After"]) >= 1
            release.set()
            for t in (first, second):
                t.join(timeout=60.0)
                assert not t.is_alive()
            assert sorted(r[0] for r in results) == [2, 3]
            assert gw.report()["rejected_by_type"]["shed"] == 1
    finally:
        engine_mod._chaos_dispatch_hook = None
        release.set()
        eng.stop()


def test_token_bucket_matches_jax():
    """The per-tenant token bucket, driven through ``take(now=...)`` on
    one timeline: the same verdicts and Retry-After hints as JAX's."""
    got = []
    for cls in (TokenBucketJ, TokenBucket):
        b = cls(capacity=2.0, refill_per_s=0.5)
        b.t_last = 0.0
        got.append([b.take(now=t) for t in
                    (0.0, 0.1, 0.2, 0.3, 1.5, 2.0, 2.1, 6.0, 6.0, 6.0)])
    assert got[0] == got[1]
    assert [ok for ok, _ in got[1]] == [True, True, False, False, False,
                                        True, False, True, True, False]
    with pytest.raises(ValueError):
        TokenBucket(0, 1.0)


def test_rate_limit_is_per_tenant(stack):
    """The token bucket sits in FRONT of admission, keyed by tenant:
    exhausting tenant a's bucket 429s tenant a (integral Retry-After)
    and costs tenant b nothing."""
    _, router, _ = stack
    with Gateway(router, rate_limit=(2.0, 0.25)) as gw:
        body = json.dumps({"inputs": [_mk(2, seed=9).tolist()]}).encode()

        def post(tenant):
            return _raw(gw.port, "POST", "/v1/generate", body,
                        (("Content-Type", "application/json"),
                         ("X-Tenant", tenant)))

        for _ in range(2):
            assert post("a")[0] == 200
        s, h, data = post("a")
        assert s == 429
        assert json.loads(data.decode())["type"] == "rate_limit"
        assert float(h["Retry-After"]) >= 1.0
        assert post("b")[0] == 200
        assert gw.report()["rejected_by_type"]["rate_limit"] == 1


def test_slow_loris_is_408_at_the_total_deadline(stack):
    """A body dripped a byte at a time is answered 408 at the TOTAL read
    deadline, long before the body would have arrived, and the service
    is unharmed."""
    gw, _, client = stack
    loris = SlowLorisClient("127.0.0.1", gw.port, drip_bytes=1,
                            drip_interval_s=0.1)
    status, _, sent = loris.run(max_s=15.0)
    assert status == 408
    assert sent < len(loris.body)
    assert gw.report()["rejected_by_type"]["slow_body"] >= 1
    assert client.generate([_mk(4, seed=1)])[0].shape[0] == 4


def test_mid_body_disconnect_absorbed(stack):
    gw, _, client = stack
    before = gw.report()["rejected_by_type"].get("disconnect", 0)
    assert mid_body_disconnect("127.0.0.1", gw.port) > 0
    deadline = time.monotonic() + 10.0             # the handler is async
    while (gw.report()["rejected_by_type"].get("disconnect", 0) <= before
           and time.monotonic() < deadline):
        time.sleep(0.05)
    assert gw.report()["rejected_by_type"].get("disconnect", 0) > before
    assert client.generate([_mk(4, seed=2)])[0].shape[0] == 4


def test_socket_load_all_answered(stack):
    """``run_socket_load`` through the real socket: every request of the
    size mix answered 200 (no shed, no error); counts only."""
    _, _, client = stack
    stats = run_socket_load(client, rate_rps=80.0, n_requests=25,
                            make_inputs=z_inputs(2, seed=3),
                            encoding="npy", seed=21)
    assert stats["completed"] == 25
    assert stats["shed"] == stats["unavailable"] == stats["errors"] == 0
    assert stats["undrained"] == 0


def test_clients_and_gateways_interoperate(gens, stack):
    """The JAX client against the port's gateway gives the port engine's
    arrays, and the port's client against the JAX gateway the JAX
    engine's, bit for bit, in both encodings; across the two packages
    the arrays agree within the CPU tolerance."""
    gw, router, _ = stack
    pj = ParallelInferenceJ(gens[0], mesh=data_mesh(1), buckets=BUCKETS)
    eng_j = ServeEngineJ(infer=pj, watchdog_deadline_s=30.0)
    eng_j.warmup(np.zeros((1, 2), np.float32))
    eng_j.start()
    router_j = RouterJ([eng_j])
    try:
        with GatewayJ(router_j) as gw_j:
            for encoding in ("json", "npy"):
                z = _mk(11, seed=77)
                want_t = router.replicas[0].submit(z).result(timeout=120.0)
                want_j = eng_j.submit(z).result(timeout=120.0)
                c_j = GatewayClientJ("127.0.0.1", gw.port, seed=1)
                got_t = c_j.generate([z], encoding=encoding)
                c_t = GatewayClient("127.0.0.1", gw_j.port, seed=1)
                got_j = c_t.generate([z], encoding=encoding)
                c_j.close()
                c_t.close()
                assert np.array_equal(got_t[0], want_t[0])
                assert np.array_equal(got_j[0], np.asarray(want_j[0]))
                np.testing.assert_allclose(got_t[0], got_j[0],
                                           rtol=RTOL, atol=ATOL)
            # the typed errors cross too
            with pytest.raises(GatewayHTTPError) as ei:
                GatewayClient("127.0.0.1", gw_j.port).generate(
                    [_mk(2)], tenant="3")
            assert ei.value.status == 404
            assert ei.value.error_type == "unknown_tenant"
    finally:
        router_j.stop()


@pytest.mark.parametrize("part", ["fleet", "tracing"])
def test_the_fleet_is_not_ported_and_tracing_is(stack, part):
    """The fleet's bank is ported (tests/test_torch_fleet_serve.py serves
    it, and ``replica --fleet``): here it refuses, typed, what it cannot
    serve from (neither or both of a checkpointer and a state, no live
    engine allowed), and a tenant request through a router without a bank
    is the gateway's 404; tracing works: a traced generate answers with
    its rows and records its client spans under the caller's context."""
    _, _, client = stack
    if part == "fleet":
        for kw in ({}, {"state": object(), "checkpointer": object()},
                   {"state": object(), "max_live": 0}):
            with pytest.raises(ValueError):
                FleetTenantBank(lambda: None, **kw)
        with pytest.raises(GatewayHTTPError) as ei:
            client.generate([_mk(2)], tenant="0")
        assert (ei.value.status, ei.value.error_type) == (404,
                                                          "unknown_tenant")
        return
    from gan_deeplearning4j_tpu_torch.telemetry import events, tracing

    def gateway_span():
        return any(e["name"] == "trace.request"
                   and e.get("trace") == ctx.trace for e in rec.recent())

    ctx = tracing.mint()
    rec = events.EventRecorder(ring_size=512)
    prev = events.install(rec)
    try:
        out = client.generate([_mk(2)], trace=ctx)[0]
        # the gateway records its span after the reply is written (as the
        # JAX gateway does): keep the recorder installed until it lands
        deadline = time.monotonic() + 10.0
        while not gateway_span() and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        events.install(prev)
    assert out.shape == (2, 1, 28, 28)
    mine = [e for e in rec.recent() if e.get("trace") == ctx.trace]
    # the client's wire spans (each carries its attempt; the gateway's own
    # trace.wire_recv stage does not)
    wire = [e for e in mine if "attempt" in e]
    assert {e["name"] for e in wire} == {"trace.wire_send", "trace.wire_recv"}
    assert all(e["parent"] == ctx.span for e in wire)
    # the gateway children itself under the caller's span
    assert any(e["name"] == "trace.request" and e["parent"] == ctx.span
               for e in mine)


def test_the_replica_needs_a_card_unless_told_cpu():
    """No device means the card: without one ``build_replica`` raises
    instead of serving on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is attached: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replica.build_replica()


# -- the replica as a child process -------------------------------------------


@pytest.fixture(scope="module")
def jax_gen_ckpt(gens, tmp_path_factory):
    """A JAX ``TrainCheckpointer`` directory holding the generator under
    ``"gen"`` at step 7, its weights scaled -> (directory, params)."""
    gj = gens[0]
    d = str(tmp_path_factory.mktemp("replica_ckpt"))
    base = gj.params
    try:
        gj.params = jax.tree.map(lambda a: a * 0.9, base)
        TrainCheckpointerJ(d).save(7, {"gen": gj})
        params = jax.tree.map(np.asarray, gj.params)
    finally:
        gj.params = base
    return d, params


def _read_ready(proc, timeout_s):
    """The child's ready line, read on a thread (bounded)."""
    box = []

    def read():
        box.append(proc.stdout.readline())

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout_s)
    return json.loads(box[0]) if box and box[0] else None


def _tail(path, n=4000):
    """The last ``n`` characters of a child's stderr file, for a failure
    message."""
    try:
        return "\n--- replica stderr (tail) ---\n" + path.read_text()[-n:]
    except OSError as exc:
        return f"\n--- replica stderr unreadable: {exc} ---"


def test_replica_process_serves_hotswaps_and_drains(jax_gen_ckpt, tmp_path):
    """``python -m ...serve.replica --port 0 --device cpu --checkpoint``:
    the ready line, ``/healthz`` 200, replies equal to an in-process
    engine serving the same checkpoint, ``/admin/hotswap`` returning the
    step, a wedge turning ``/healthz`` 503 while it still listens, and
    SIGTERM -> exit 0.  The child's stderr goes to a file (a pipe nobody
    reads can fill and block it) whose tail every failure message carries."""
    d, params = jax_gen_ckpt
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    err_path = tmp_path / "replica.stderr"
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "gan_deeplearning4j_tpu_torch.serve.replica", "--port", "0",
             "--device", "cpu", "--checkpoint", d],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err_file,
            text=True)
    try:
        ready = _read_ready(proc, 120.0)
        assert ready is not None and ready["event"] == "replica_ready", (
            proc.poll(), ready, _tail(err_path))
        assert ready["pid"] == proc.pid
        port = ready["port"]
        client = GatewayClient("127.0.0.1", port, seed=2)
        assert client.healthz()["_status"] == 200, _tail(err_path)
        gt = MT.build_generator(device="cpu")
        gt.params = interop.params_from_numpy(params, "cpu", like=gt.params)
        want_eng = ServeEngine(infer=ParallelInference(gt, buckets=BUCKETS),
                               supervise=False,
                               admission=AdmissionQueue(deadline_ms=60_000.0))
        with want_eng:
            # largest first: the replica's admission (the default 1 s
            # budget) would estimate a 48-row wait from one-row batches'
            # rows/s, which a loaded CPU runner makes small
            for rows, encoding in ((48, "json"), (16, "npy"), (4, "npy"),
                                   (1, "json")):
                z = _mk(rows, seed=rows)
                got = client.generate([z], encoding=encoding)[0]
                want = want_eng.generate(z, timeout=120.0)[0]
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                           err_msg=_tail(err_path))
        s, _, data = _raw(port, "POST", "/admin/hotswap",
                          json.dumps({"directory": d}).encode(),
                          (("Content-Type", "application/json"),))
        assert s == 200 and json.loads(data)["result"] == {"step": 7}, (
            s, data, _tail(err_path))
        s, _, data = _raw(port, "POST", "/admin/hotswap", b"{}",
                          (("Content-Type", "application/json"),))
        assert s == 400, (s, data, _tail(err_path))
        s, _, data = _raw(port, "POST", "/admin/hotswap",
                          json.dumps({"directory": str(tmp_path)}).encode(),
                          (("Content-Type", "application/json"),))
        assert s == 404 and json.loads(data)["type"] == "not_found", (
            s, data, _tail(err_path))
        s, _, _ = _raw(port, "POST", "/admin/chaos/wedge",
                       json.dumps({"seconds": 30}).encode(),
                       (("Content-Type", "application/json"),))
        assert s == 200, _tail(err_path)
        doc = client.healthz()
        assert doc["_status"] == 503 and doc["serve"]["wedged"] is True, (
            doc, _tail(err_path))
        assert client.generate([_mk(2)])[0].shape[0] == 2, _tail(err_path)
        client.close()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60.0)
        assert rc == 0, (rc, _tail(err_path))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
        proc.stdout.close()
