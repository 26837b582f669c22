"""The port's ``--profile`` tooling (``utils/profiling.py``) on the CPU:
``summarize_trace`` through the cases of the JAX package's
tests/test_profiling.py (device-lane filtering, the host-only fallback,
top-N order, nested captures and non-duration events, the exit report) on
fixtures in the layout ``torch.profiler`` writes (``*.pt.trace.json``,
kernels as ``cat: "kernel"`` events on a GPU lane, an epoch base), each
summary held to the JAX function's on the same events where that one
reads them; and ``maybe_trace`` around real work."""

import gzip
import json
import os

import pytest
import torch

from gan_deeplearning4j_tpu.utils import profiling as PJ
from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.utils import profiling as PT

BASE_NS = 1_792_000_000_000_000_000


def _lane(pid, name):
    return {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": name}}


def _x(pid, name, dur_us, cat=None, ts=0.0):
    ev = {"ph": "X", "pid": pid, "tid": 0, "name": name, "ts": ts,
          "dur": dur_us}
    if cat is not None:
        ev["cat"] = cat
    return ev


def _torch_trace(path, evs):
    """A capture as ``torch.profiler``'s ``export_chrome_trace`` writes it."""
    with open(path, "w") as f:
        json.dump({"schemaVersion": 1, "baseTimeNanoseconds": BASE_NS,
                   "traceEvents": evs, "displayTimeUnit": "ms"}, f)


def _jax_trace(path, evs):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": evs}, f)


def _both(tmp_path, evs, **kw):
    """The port's summary of a torch-format capture, its rows less their
    counts, and the JAX function's of the same events in its own format."""
    t, j = tmp_path / "t", tmp_path / "j"
    t.mkdir()
    j.mkdir()
    _torch_trace(t / "host.123.pt.trace.json", evs)
    _jax_trace(j / "host.trace.json.gz", evs)
    rows = PT.summarize_trace(str(t), **kw)
    return rows, [r[:2] for r in rows], PJ.summarize_trace(str(j), **kw)


def test_device_lane_filtering(tmp_path):
    """A GPU lane present: host ops, launches and GPU annotations are
    dropped; copies and memsets stay with the kernels."""
    evs = [_lane(0, "GPU 0"), _lane(4242, "python"),
           _x(0, "bn_act_kernel", 2000.0, "kernel"),
           _x(0, "Memcpy DtoH", 500.0, "gpu_memcpy"),
           _x(0, "ProfilerStep#1", 9000.0, "gpu_user_annotation"),
           _x(4242, "aten::mm", 7000.0, "cpu_op"),
           _x(4242, "cudaLaunchKernel", 8000.0, "cuda_runtime")]
    rows, _, _ = _both(tmp_path, evs)
    assert rows == [("bn_act_kernel", 2.0, 1), ("Memcpy DtoH", 0.5, 1)]
    rows = PT.summarize_trace(str(tmp_path / "t"), device_only=False)
    assert {n: ms for n, ms, _ in rows} == {
        "ProfilerStep#1": 9.0, "cudaLaunchKernel": 8.0, "aten::mm": 7.0,
        "bn_act_kernel": 2.0, "Memcpy DtoH": 0.5}


def test_jax_lane_names_still_filter(tmp_path):
    """A capture without categories (the JAX profiler's) is filtered by
    its lane names, as the JAX function does."""
    evs = [_lane(1, "/device:TPU:0"), _lane(2, "python host"),
           _x(1, "fusion.7", 2000.0), _x(2, "host_overhead", 9000.0)]
    _, port, jax_rows = _both(tmp_path, evs)
    assert port == jax_rows == [("fusion.7", 2.0)]


def test_host_only_fallback(tmp_path):
    """A CPU run's capture (no device work at all) falls back to every
    lane, same-name events accumulating."""
    evs = [_lane(5, "python"), _x(5, "aten::mm", 1500.0, "cpu_op"),
           _x(5, "aten::mm", 500.0, "cpu_op")]
    rows, port, jax_rows = _both(tmp_path, evs)
    assert port == jax_rows == [("aten::mm", 2.0)]
    assert rows == [("aten::mm", 2.0, 2)]


def test_top_n_ordering_with_counts(tmp_path):
    evs = [_lane(0, "GPU 0")]
    for i in range(6):
        evs += [_x(0, f"k_{i}", 500.0 * (i + 1), "kernel")] * 2
    rows, port, jax_rows = _both(tmp_path, evs, top=3)
    assert port == jax_rows == [("k_5", 6.0), ("k_4", 5.0), ("k_3", 4.0)]
    assert [r[2] for r in rows] == [2, 2, 2]


def test_nested_captures_and_non_duration_events(tmp_path):
    """Each rank's capture in its own subdirectory; metadata, counters and
    instants (no ``dur``) are skipped, not crashed on."""
    for r in (0, 1):
        nested = tmp_path / f"rank{r}"
        nested.mkdir()
        _torch_trace(nested / f"h.{r}.pt.trace.json", [
            _lane(0, "GPU 0"), {"ph": "C", "pid": 0, "name": "mem", "ts": 0},
            {"ph": "i", "pid": 0, "name": "mark", "ts": 1.0},
            _x(0, "conv", 3000.0, "kernel")])
    assert PT.summarize_trace(str(tmp_path)) == [("conv", 6.0, 2)]
    assert PT.rank_trace_dir(str(tmp_path), None) == str(tmp_path)
    assert PT.rank_trace_dir(None, None) is None


def test_print_trace_summary_logs_and_degrades(tmp_path):
    """The top sinks with their counts, then the port's own kernels (their
    device functions summed, whatever the template arguments), below the
    top; an empty or broken capture reports and never raises."""
    _torch_trace(tmp_path / "e.pt.trace.json", [
        _lane(0, "GPU 0"), _x(0, "matmul", 4000.0, "kernel"),
        *[_x(0, f"void bn_act_kernel<{k}>(float const*)", 1.0, "kernel")
          for k in (1, 2, 2)]])
    lines = []
    rows = PT.print_trace_summary(str(tmp_path), top=1, log=lines.append)
    assert rows == [("matmul", 4.0, 1)]
    assert any("matmul" in ln and "1x" in ln for ln in lines)
    assert any("top" in ln for ln in lines)
    assert lines[-2:] == ["[profile] the port's kernels:",
                          "[profile]         0.003 ms         3x  bn_act"]
    empty = tmp_path / "empty"
    empty.mkdir()
    lines = []
    assert PT.print_trace_summary(str(empty), log=lines.append) == []
    assert any("no trace events" in ln for ln in lines)
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "x.pt.trace.json").write_text("{not json")
    lines = []
    assert PT.print_trace_summary(str(tmp_path / "bad"),
                                  log=lines.append) == []
    assert "could not summarize" in lines[0]


def test_maybe_trace_captures_the_block(tmp_path):
    """A CPU capture: the Chrome trace and the sidecar in the directory,
    the ``profiler.trace`` span, the block's ops in the summary with their
    counts, its timestamps on the epoch; no directory, no capture; a
    capture that must hold device work and holds none raises."""
    rec = events.EventRecorder()
    prev = events.install(rec)
    d = tmp_path / "prof"
    try:
        with PT.maybe_trace(str(d)) as prof:
            assert prof is not None
            x = torch.randn(64, 64)
            for _ in range(3):
                x = torch.tanh(x @ x)
    finally:
        events.install(prev)
    files = sorted(os.listdir(d))
    assert PT.ANCHOR_NAME in files
    assert [f for f in files if f.endswith(".pt.trace.json")]
    span = [e for e in rec.recent() if e["name"] == "profiler.trace"]
    assert span and span[0]["trace_dir"] == str(d) and "dur" in span[0]
    rows = {n: c for n, _, c in PT.summarize_trace(str(d), top=50)}
    assert rows["aten::tanh"] == 3 and rows["aten::mm"] == 3
    anchor = json.load(open(d / PT.ANCHOR_NAME))["wall_start"]
    ts = [e["ts"] for e in PT._trace_events(str(d)) if e.get("ph") == "X"]
    assert abs(min(ts) / 1e6 - anchor) < 60
    with PT.maybe_trace(None) as prof:
        assert prof is None
    with pytest.raises(PT.EmptyCaptureError):
        with PT.maybe_trace(str(tmp_path / "cpu"), require_device=True):
            torch.ones(3).sum()
