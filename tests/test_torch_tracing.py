"""The port's request tracing (``telemetry/tracing.py``) and the serving
plane's trace wiring held against the JAX package on the CPU.

* **context and header** — the JAX module's unit cases, each run through
  both packages with the same verdict, and the wire interop: a header
  minted by either package parses in the other.
* **the cross-file merge** — the port's ``merge_trace_files`` equals the
  JAX one (traces, completeness, processes, timeline, stats) on the same
  files, written by the port's recorder, by the JAX recorder, and by both
  in one merge, including an appended multi-segment file and an orphan
  parent; the CLI prints what the JAX CLI prints.
* **in-process socket contracts** — the same request sequence through the
  port's client, gateway and engine and through the JAX package's yields
  the same span names and parentage; a 200 carries ``Server-Timing``;
  untraced engine requests record nothing; error replies echo the trace
  and land a ``trace.reject``.
* **cross-process acceptance** — two port replica processes (``--device
  cpu``) behind a ``MeshRouter``; one is SIGKILLed and the next traced
  generate fails over: the merged timeline shows both hops, the failed one
  closing with ``error``, under one complete trace over two processes.

The heavy cases run under one torch thread (the module fixture), and the
replica children under ``OMP_NUM_THREADS=1``.
"""

import glob
import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

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
)
from gan_deeplearning4j_tpu.telemetry import events as EJ
from gan_deeplearning4j_tpu.telemetry import tracing as TJ
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.parallel.inference import ParallelInference
from gan_deeplearning4j_tpu_torch.serve import (
    Gateway,
    GatewayClient,
    MeshRouter,
    RemoteReplica,
    ReplicaLauncher,
    Router,
    ServeEngine,
)
from gan_deeplearning4j_tpu_torch.telemetry import events as ET
from gan_deeplearning4j_tpu_torch.telemetry import tracing as TT
from gan_deeplearning4j_tpu_torch.testing import chaos

REPO = Path(__file__).resolve().parents[1]
BUCKETS = (8, 32)
# the replica children: one intra-op thread each, as this module runs
REPLICA_ENV = {"OMP_NUM_THREADS": "1"}
PKGS = {"jax": (TJ, EJ), "port": (TT, ET)}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's CPU ops on one thread while this module runs (then the
    process's setting again): the tier-1 lane runs six test processes at
    once, and a pool as wide as the host in each spins against the
    others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rows, seed=0):
    return np.random.RandomState(seed).rand(rows, 2).astype(
        np.float32) * 2 - 1


# -- context + header ----------------------------------------------------------


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_header_roundtrip(pkg):
    T = PKGS[pkg][0]
    ctx = T.mint()
    hdr = T.to_header(ctx)
    assert hdr == f"trace={ctx.trace};parent={ctx.span}"
    assert T.from_header(hdr) == ctx
    assert T.TRACE_HEADER == "X-Gan4j-Trace"
    assert T.TIMING_HEADER == "Server-Timing"


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_child_keeps_trace_and_changes_span(pkg):
    T = PKGS[pkg][0]
    root = T.mint()
    kid = T.child(root)
    assert kid.trace == root.trace and kid.span != root.span
    assert T.child(root).span != kid.span  # fresh every time


@pytest.mark.parametrize("bad", [
    None, "", "garbage", "trace=;parent=x", "parent=only",
    "trace=" + "a" * 200 + ";parent=b",   # oversized id
    "trace=a;parent=" + "b" * 65,         # one past the id bound
])
def test_malformed_header_is_none_in_both(bad):
    assert TT.from_header(bad) is None
    assert TJ.from_header(bad) is None


@pytest.mark.parametrize("value", [
    "trace=a;parent=b;extra=junk",        # unknown fields are ignored
    "trace=a;trace=c;parent=b",           # a repeated key: the last wins
    " trace = a ; parent = b ",           # whitespace around the fields
    "trace=" + "a" * 64 + ";parent=b",    # at the id bound
])
def test_header_parse_matches_jax(value):
    got = TT.from_header(value)
    assert got is not None
    assert tuple(got) == tuple(TJ.from_header(value))


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_span_ids_are_pid_prefixed_and_unique(pkg):
    T = PKGS[pkg][0]
    ids = {T.new_span_id() for _ in range(100)}
    assert len(ids) == 100
    assert all(i.startswith(f"{os.getpid():x}-") for i in ids)
    assert len(T.new_trace_id()) == 16


@pytest.mark.parametrize("src,dst", [("port", "jax"), ("jax", "port")])
def test_headers_cross_packages(src, dst):
    """The wire interop: a header minted by one package parses in the
    other to the same context, and a child there keeps the trace."""
    S, D = PKGS[src][0], PKGS[dst][0]
    ctx = S.child(S.mint())
    got = D.from_header(S.to_header(ctx))
    assert (got.trace, got.span) == (ctx.trace, ctx.span)
    assert D.to_header(got) == S.to_header(ctx)
    assert D.child(got).trace == ctx.trace


# -- the cross-file merge ------------------------------------------------------


_NAMES = ("trace.request", "trace.decode", "trace.dispatch",
          "trace.queue_wait", "trace.readback", "trace.hop")


def _write(E, path, host, fn, append=False):
    """Run ``fn()`` under a file recorder of package ``E`` claiming to be
    ``host``."""
    rec = E.EventRecorder(path=str(path), append=append)
    rec.host = host
    prev = E.install(rec)
    try:
        fn(E)
    finally:
        E.install(prev)
        rec.close()


def _spans(seed, n_traces=3):
    """Trace trees from a seed: [(trace, [(name, span, parent, dur, proc,
    error)])] — each span on process 0 or 1, one tree per trace."""
    rng = np.random.RandomState(seed)
    out = []
    for t in range(n_traces):
        tid = f"{seed:04x}{t:012x}"
        spans = [("trace.route", f"r{t}", None, float(rng.uniform(.01, .02)),
                  0, None)]
        for i in range(int(rng.randint(3, 8))):
            parent = spans[int(rng.randint(len(spans)))][1]
            spans.append((_NAMES[int(rng.randint(len(_NAMES)))],
                          f"s{t}-{i}", parent, float(rng.uniform(0, .01)),
                          int(rng.randint(2)),
                          "RuntimeError('x')" if rng.rand() < .2 else None))
        out.append((tid, spans))
    return out


def _emit(traces, proc, orphan=False):
    """The recorder calls that write ``proc``'s share of ``traces`` (and,
    with ``orphan``, a span whose parent no file holds)."""
    def run(E):
        E.instant("controlplane.replica_spawned", pid=proc, port=1000 + proc)
        for tid, spans in traces:
            for name, span, parent, dur, p, error in spans:
                if p != proc:
                    continue
                attrs = {"trace": tid, "span": span, "replica": f"h:{p}"}
                if parent is not None:
                    attrs["parent"] = parent
                if error is not None:
                    attrs["error"] = error
                E.complete(name, dur, t_start=time.perf_counter() - dur,
                           **attrs)
        E.instant("trace.reject", trace=traces[0][0], span=f"x{proc}",
                  parent=traces[0][1][0][1], status=503, type="unavailable")
        E.instant("chaos.kill", pid=proc)
        if orphan:
            E.complete("trace.request", 0.001, trace="orphan", span="o1",
                       parent="never-recorded")
    return run


@pytest.mark.parametrize("case", ["port", "jax", "mixed", "appended",
                                  "orphan"])
@pytest.mark.parametrize("include", [(), ("controlplane.", "chaos.")])
def test_merge_equals_jax(tmp_path, case, include):
    """The same files merge to the same document in both packages."""
    seed = {"port": 1, "jax": 2, "mixed": 3, "appended": 4, "orphan": 5}[case]
    traces = _spans(seed)
    writers = {"port": (ET, ET), "jax": (EJ, EJ), "mixed": (ET, EJ),
               "appended": (ET, EJ), "orphan": (EJ, ET)}[case]
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _write(writers[0], a, "hostA:1", _emit(traces, 0, case == "orphan"))
    if case == "appended":
        # a second incarnation appends to the same file: two segments
        time.sleep(0.01)
        _write(writers[1], a, "hostA:2", _emit(traces, 1), append=True)
        paths = [str(a), str(tmp_path / "missing.jsonl")]
    else:
        _write(writers[1], b, "hostB:2", _emit(traces, 1))
        paths = [str(a), str(b)]
    got = TT.merge_trace_files(paths, include_events=include)
    want = TJ.merge_trace_files(paths, include_events=include)
    assert got == want
    stats = got["stats"]
    assert stats["segments"] == 2 and stats["files"] == (
        1 if case == "appended" else 2)
    assert stats["traces"] == len(traces) + (case == "orphan")
    assert stats["timeline_events"] == (4 if include else 0)
    # every span anchored on its own segment's wall clock: the merged
    # order is chronological, not file order
    for tr in got["traces"].values():
        walls = [s["wall"] for s in tr["spans"]]
        assert walls == sorted(walls)
        assert all(abs(w - time.time()) < 60 for w in walls)
    for tid, _ in traces:
        assert got["traces"][tid]["complete"]
        assert got["traces"][tid]["root"] == "trace.route"
    if case == "orphan":
        assert not got["traces"]["orphan"]["complete"]
        assert stats["complete"] == len(traces)
    # a trace crosses processes when its spans do, or (the first) when
    # both processes rejected a request of it
    assert stats["cross_process"] == sum(
        len({s[4] for s in spans} | ({0, 1} if i == 0 else set())) >= 2
        for i, (_, spans) in enumerate(traces))


def test_cli_matches_jax(tmp_path):
    traces = _spans(7)
    a, b = tmp_path / "a.jsonl", tmp_path / "b.jsonl"
    _write(ET, a, "hostA:1", _emit(traces, 0))
    _write(EJ, b, "hostB:2", _emit(traces, 1))
    tid = traces[1][0]
    for argv in ([str(a), str(b)],
                 [str(a), str(b), "--events", "chaos.", "--events",
                  "controlplane."],
                 [str(a), str(b), "--trace", tid]):
        outs = {}
        for name, (T, _) in PKGS.items():
            buf = io.StringIO()
            with redirect_stdout(buf):
                assert T.main(argv) == 0
            outs[name] = json.loads(buf.getvalue())
        assert outs["port"] == outs["jax"]
    assert TT.main([str(a), "--trace", "nope"]) == 2
    out = tmp_path / "merged.json"
    with redirect_stdout(io.StringIO()):
        TT.main([str(a), str(b), "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(
        TJ.merge_trace_files([str(a), str(b)]), sort_keys=True))
    # the module's own entry point, as a user runs it
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.telemetry.tracing",
         str(a), str(b)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == TJ.merge_trace_files(
        [str(a), str(b)])["stats"]


# -- in-process socket contracts -----------------------------------------------


@pytest.fixture(scope="module")
def engines(cpu_devices):
    """A started port engine and a started JAX engine on the generator at
    BUCKETS (their weights differ: the trees are the point here)."""
    eng_t = ServeEngine(infer=ParallelInference(
        MT.build_generator(device="cpu"), buckets=BUCKETS),
        watchdog_deadline_s=30.0)
    eng_j = ServeEngineJ(infer=ParallelInferenceJ(
        MJ.build_generator(), mesh=data_mesh(1), buckets=BUCKETS),
        watchdog_deadline_s=30.0)
    for eng in (eng_t, eng_j):
        eng.warmup(np.zeros((1, 2), np.float32))
        eng.start()
    yield {"port": eng_t, "jax": eng_j}
    eng_t.stop()
    eng_j.stop()


STACKS = {"port": (Gateway, GatewayClient, Router),
          "jax": (GatewayJ, GatewayClientJ, RouterJ)}


def _tree(merged, tid):
    """A trace's (name, parent's name) pairs, sorted: its shape."""
    spans = merged["traces"][tid]["spans"]
    by = {s["span"]: s["name"] for s in spans}
    return sorted((s["name"], by.get(s["parent"], s["parent"] and "?"))
                  for s in spans)


def _sequence(pkg, eng, path):
    """One request sequence through ``pkg``'s client and gateway: a
    traced request under a caller span, a plain generate (the client
    mints the root), a 400 -> (trace ids, the first reply's headers)."""
    T, E = PKGS[pkg]
    G, C, R = STACKS[pkg]
    rec = E.EventRecorder(path=str(path))
    prev = E.install(rec)
    try:
        with G(R([eng])) as gw:
            client = C("127.0.0.1", gw.port, retries=0)
            try:
                ctx = T.mint()
                body = json.dumps({"inputs": [_mk(4).tolist()]}).encode()
                with E.span("trace.client", trace=ctx.trace, span=ctx.span):
                    status, headers, _ = client._request(
                        "POST", "/v1/generate", body, "application/json",
                        trace=ctx)
                assert status == 200
                before = {e.get("trace") for e in rec.recent()}
                client.generate([_mk(5, seed=1)])
                minted = {e["trace"] for e in rec.recent()
                          if e["name"] == "trace.client"} - before
                bad = T.mint()
                with E.span("trace.client", trace=bad.trace, span=bad.span):
                    status, _, _ = client._request(
                        "POST", "/v1/generate", b"not json",
                        "application/json", trace=bad)
                assert status == 400
            finally:
                client.close()
        # the engine's spans of the last batch land after its requests
        # are answered: wait for them before the recorder closes
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and sum(
                e["name"] == "trace.readback" for e in rec.recent()) < 2:
            time.sleep(0.01)
    finally:
        E.install(prev)
        rec.close()
    (root,) = minted
    return (ctx.trace, root, bad.trace), headers


def test_gateway_trace_trees_match_jax(engines, tmp_path):
    """The same request sequence through both packages' client, gateway
    and engine yields the same span names and parentage; each traced
    request is one complete tree holding every layer's spans, and the
    200 carries the trace echo and ``Server-Timing``."""
    trees, heads = {}, {}
    for pkg in ("port", "jax"):
        path = tmp_path / f"{pkg}.jsonl"
        tids, heads[pkg] = _sequence(pkg, engines[pkg], path)
        merged = PKGS[pkg][0].merge_trace_files([str(path)])
        trees[pkg] = [_tree(merged, t) for t in tids]
        for t in tids:
            assert merged["traces"][t]["complete"], merged["traces"][t]
    assert trees["port"] == trees["jax"]
    names = {n for n, _ in trees["port"][0]}
    assert {"trace.client", "trace.wire_send", "trace.wire_recv",
            "trace.request", "trace.rate_limit", "trace.decode",
            "trace.dispatch_wait", "trace.response_encode",
            "trace.queue_wait", "trace.coalesce", "trace.bucket_pad",
            "trace.dispatch", "trace.readback"} <= names, names
    assert ("trace.reject", "trace.request") in trees["port"][2]
    assert ("trace.client", None) in trees["port"][1]  # the minted root
    for pkg, h in heads.items():
        T = PKGS[pkg][0]
        assert h[T.TRACE_HEADER].startswith("trace=")
        timing = h[T.TIMING_HEADER]
        assert "dispatch;dur=" in timing and "decode;dur=" in timing
    assert ([k.split(";")[0] for k in heads["port"]["Server-Timing"].split(
        ", ")] == [k.split(";")[0] for k in heads["jax"][
            "Server-Timing"].split(", ")])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_untraced_engine_requests_record_no_trace_events(engines, pkg):
    E = PKGS[pkg][1]
    rec = E.EventRecorder(ring_size=2048)
    prev = E.install(rec)
    try:
        eng = engines[pkg]
        before = eng.report()["batches_total"]
        assert np.asarray(eng.submit(_mk(4)).result(timeout=60)[0]
                          ).shape[0] == 4
        deadline = time.monotonic() + 30.0
        while (time.monotonic() < deadline
               and eng.report()["batches_total"] == before):
            time.sleep(0.01)
    finally:
        E.install(prev)
    names = [e["name"] for e in rec.recent()]
    assert not [n for n in names if n.startswith("trace.")]
    assert "serve.dispatch" in names


def test_engine_refuses_a_foreign_trace(engines):
    eng = engines["port"]
    with pytest.raises(TypeError, match="TraceContext"):
        eng.submit(_mk(4), trace=object())
    ctx = TT.mint()
    rec = ET.EventRecorder(ring_size=256)
    prev = ET.install(rec)
    try:
        out = eng.submit(_mk(4), trace=ctx).result(timeout=60)[0]
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not any(
                e["name"] == "trace.readback" for e in rec.recent()):
            time.sleep(0.01)
    finally:
        ET.install(prev)
    assert out.shape[0] == 4
    got = [e for e in rec.recent() if e.get("trace") == ctx.trace]
    assert sorted(e["name"] for e in got) == [
        "trace.bucket_pad", "trace.coalesce", "trace.dispatch",
        "trace.queue_wait", "trace.readback"]
    assert all(e["parent"] == ctx.span and e["rows"] == 4 for e in got)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_gateway_error_replies_echo_trace_and_reject(pkg):
    """Every error reply carries the trace header back and lands a
    terminal ``trace.reject`` event, in both packages alike."""
    T, E = PKGS[pkg]
    G, C, R = STACKS[pkg]
    rec = E.EventRecorder(ring_size=1024)
    prev = E.install(rec)
    try:
        with G(R([])) as gw:   # nobody behind the door
            client = C("127.0.0.1", gw.port, retries=0)
            try:
                ctx = T.mint()
                body = json.dumps({"inputs": [_mk(4).tolist()]}).encode()
                status, headers, _ = client._request(
                    "POST", "/v1/generate", body, "application/json",
                    trace=ctx)
                assert status == 503
                echo = T.from_header(headers[T.TRACE_HEADER])
                assert echo.trace == ctx.trace and echo.span != ctx.span
                ctx2 = T.mint()
                status2, headers2, _ = client._request(
                    "POST", "/v1/generate", b"not json",
                    "application/json", trace=ctx2)
                assert status2 == 400
                assert f"trace={ctx2.trace};" in headers2[T.TRACE_HEADER]
            finally:
                client.close()
    finally:
        E.install(prev)
    evs = rec.recent()
    by_trace = {e["trace"]: e for e in evs if e["name"] == "trace.reject"}
    assert by_trace[ctx.trace]["status"] == 503
    assert by_trace[ctx2.trace]["status"] == 400
    assert by_trace[ctx.trace]["parent"] == echo.span
    names = [e["name"] for e in evs]
    assert "gateway.start" in names
    assert [e["status"] for e in evs if e["name"] == "gateway.reject"] == [
        503, 400]


# -- cross-process acceptance: failover continuity -----------------------------


def test_failover_trace_spans_both_hops_and_processes(tmp_path):
    """A replica is SIGKILLed; the traced generate that fails over shows
    BOTH hops — the dead one closing with ``error``, the live one carrying
    the request into the other process — under one trace id, complete,
    over at least two processes."""
    launcher = ReplicaLauncher(buckets=BUCKETS, log_dir=str(tmp_path),
                               events_dir=str(tmp_path), env=REPLICA_ENV,
                               device="cpu")
    ev_path = str(tmp_path / "test.events.jsonl")
    recorder = ET.EventRecorder(path=ev_path)
    prev = ET.install(recorder)
    procs, mesh = [], MeshRouter(recheck_s=30.0)
    failover_ctx = None
    try:
        for _ in range(2):
            p = launcher.spawn()
            assert p.ready_s is not None and p.ready_s > 0
            procs.append(p)
            mesh.add(RemoteReplica(p.host, p.port))
        # round-robin starts at replica 0: burn one rotation so the NEXT
        # generate offers replica 1 first, then kill replica 1 — that
        # generate must fail over to replica 0
        assert np.isfinite(mesh.generate([_mk(4)])[0]).all()
        chaos.kill_replica_process(procs[1])
        failover_ctx = TT.mint()
        # the caller-side root span: the mesh parents trace.route under
        # the caller's span
        with ET.span("trace.client", trace=failover_ctx.trace,
                     span=failover_ctx.span):
            out = mesh.generate([_mk(4, seed=1)], trace=failover_ctx)[0]
        assert out.shape == (4, 1, 28, 28) and np.isfinite(out).all()
    finally:
        for p in procs:
            try:
                mesh.remove(p.name)
            finally:
                p.stop()  # SIGTERM: the live replica flushes its tail
        mesh.close()
        ET.install(prev)
        recorder.close()
    files = [ev_path] + sorted(glob.glob(
        os.path.join(str(tmp_path), "replica_*.events.jsonl")))
    merged = TT.merge_trace_files(files)
    assert merged == TJ.merge_trace_files(files)
    tr = merged["traces"][failover_ctx.trace]
    hops = [s for s in tr["spans"] if s["name"] == "trace.hop"]
    assert len(hops) == 2, [s["name"] for s in tr["spans"]]
    failed = [h for h in hops if "error" in h]
    lived = [h for h in hops if "error" not in h]
    assert len(failed) == 1 and len(lived) == 1
    assert failed[0]["attrs"]["replica"] == procs[1].name
    assert lived[0]["attrs"]["replica"] == procs[0].name
    assert tr["complete"], tr
    assert len(tr["processes"]) >= 2, tr["processes"]
    # the surviving replica's request span is parented on the LIVE hop:
    # the wire header did the parenting across the process gap
    reqs = [s for s in tr["spans"] if s["name"] == "trace.request"]
    assert any(s.get("parent") == lived[0]["span"] for s in reqs)
    names = {s["name"] for s in tr["spans"]}
    assert {"trace.queue_wait", "trace.dispatch", "trace.readback"} <= names
    # the live replica's own lifecycle: ready, then stopped with no port
    # kernel launched
    evs = ET.read_events(files[1])
    stopped = [e for e in evs if e["name"] == "replica.stopped"]
    assert any(e["name"] == "replica.ready" for e in evs)
    assert len(stopped) == 1 and not any(
        stopped[0]["port_launches"].values())
