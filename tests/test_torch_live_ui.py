"""The port's live dashboard (``utils/live_ui.py``) held against the JAX
package's on the CPU, each over a real loopback socket: for the same
metrics JSONL and ``events.jsonl`` (made from a seed: step records, a
chunk's records, a NaN, a step-less goodput record, a torn last line,
then appended records) the same page, ``/data`` and ``/events`` bytes,
poll after poll; ``serve_for_config``'s path and announcement; a clean
stop."""

import json
import math
import urllib.request

import numpy as np
import pytest

from gan_deeplearning4j_tpu.utils import live_ui as UJ
from gan_deeplearning4j_tpu_torch.telemetry import events as ET
from gan_deeplearning4j_tpu_torch.train import insurance_main as IT
from gan_deeplearning4j_tpu_torch.utils import live_ui as UT


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def _records(seed: int, start: int, n: int):
    rng = np.random.RandomState(seed)
    return [{"step": s, "wall_s": float(rng.rand()),
             "d_loss": float(rng.rand()), "g_loss": float(rng.rand()),
             "d_grad_norm": float(rng.uniform(0.1, 10)),
             "nonfinite": 0.0} for s in range(start, start + n)]


@pytest.fixture
def run_dir(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    recs = _records(16, 1, 5)
    recs[3]["g_loss"] = math.nan
    lines = [json.dumps(r) for r in recs]
    lines.append(json.dumps({"goodput": {"dispatch": 1.0}, "run_id": "x"}))
    (d / "insurance_metrics.jsonl").write_text(
        "\n".join(lines) + "\n" + '{"step": 6, "d_lo')  # torn tail
    rec = ET.EventRecorder(path=str(d / ET.EVENTS_NAME), flush_every=1)
    rec.instant("train.start", step=0)
    with rec.span("checkpoint.save", step=2):
        pass
    rec.instant("preempt.exit", step=4, fleet_min_step=4, checkpoint="c")
    rec.instant("data.retry", what="read", attempt=1)
    rec.close()
    return d


def test_page_data_and_events_are_the_jax_modules(run_dir):
    path = str(run_dir / "insurance_metrics.jsonl")
    stops = {"jax": UJ.serve_metrics(path, port=0),
             "torch": UT.serve_metrics(path, port=0)}
    got = {n: [] for n in stops}
    try:
        for poll in range(3):
            if poll == 1:  # the torn line completes, more records land
                with open(path, "a") as f:
                    f.write('ss": 0.25}\n' + "".join(
                        json.dumps(r) + "\n" for r in _records(7, 7, 3)))
            for n, stop in stops.items():
                got[n].append([_get(stop.port, p)
                               for p in ("/", "/data", "/events")])
    finally:
        for stop in stops.values():
            stop()
    assert got["torch"] == got["jax"]
    page, data, evs = got["torch"][-1]
    assert page[1].startswith("text/html") and b"chart-tel" in page[2]
    recs = json.loads(data[2])
    assert [r["step"] for r in recs] == list(range(1, 10))
    assert recs[3]["g_loss"] is None and recs[5]["d_loss"] == 0.25
    assert [e["name"] for e in json.loads(evs[2])] == ["checkpoint.save",
                                                       "preempt.exit"]
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{stops['torch'].port}/",
                               timeout=2)


def test_serve_for_config_serves_the_programs_jsonl(run_dir, capsys):
    cfg = IT.default_config(res_path=str(run_dir))
    stop = UT.serve_for_config(cfg, 0)
    try:
        _, ctype, body = _get(stop.port, "/data")
    finally:
        stop()
    assert ctype == "application/json" and len(json.loads(body)) == 5
    assert capsys.readouterr().out == (
        f"[live-ui] http://127.0.0.1:{stop.port}/\n")
