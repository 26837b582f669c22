"""The port's goodput accounting and run manifest
(``telemetry/goodput.py``) held against the JAX package's on the CPU: the
same report under one patched clock (phases, nesting, entry counts, the
unknown-phase error), the manifest's key set (its ``versions`` name the
loaded torch stack instead of jax), and the trainer's run-level record:
the goodput breakdown and the run id in the last metrics record and the
result, the run id in the manifest and in ``events.jsonl``'s header."""

import json

import numpy as np
import pytest

from gan_deeplearning4j_tpu.telemetry import goodput as GJ
from gan_deeplearning4j_tpu_torch.parallel import mesh
from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.telemetry import goodput as GT
from gan_deeplearning4j_tpu_torch.train import insurance_main as IT

PHASES = ("data_wait", "dispatch", "readback", "checkpoint", "eval", "other")


class FakeClock:
    """``time.perf_counter`` replaced by seeded increments."""

    def __init__(self, seed: int):
        self.rng = np.random.RandomState(seed)
        self.t = 100.0

    def __call__(self) -> float:
        self.t += float(self.rng.uniform(0.001, 0.5))
        return self.t


def _script(G):
    """A run's phases through one package's timer: nested, repeated and
    never-entered phases -> the report."""
    gp = G.GoodputTimer()
    with gp.phase("data_wait"):
        pass
    for _ in range(3):
        with gp.phase("dispatch"):
            pass
        with gp.phase("readback"):
            pass
    with gp.phase("eval"):
        with gp.phase("checkpoint"):
            pass
    with gp.phase("checkpoint"):
        pass
    return gp.report()


def test_timer_reports_equal_under_one_clock(monkeypatch):
    reports = {}
    for name, G in (("jax", GJ), ("torch", GT)):
        monkeypatch.setattr(G.time, "perf_counter", FakeClock(16))
        reports[name] = _script(G)
    assert reports["torch"] == reports["jax"]
    rep = reports["torch"]
    assert list(rep) == list(reports["jax"])
    assert sum(rep[p] for p in PHASES) == pytest.approx(rep["wall_s"],
                                                         abs=1e-5)
    assert rep["phase_n"] == {"data_wait": 1, "dispatch": 3, "readback": 3,
                              "eval": 1, "checkpoint": 2}
    assert GT.PHASES == GJ.PHASES


def test_unknown_phase_is_the_jax_error():
    msgs = []
    for G in (GJ, GT):
        with pytest.raises(ValueError) as e:
            with G.GoodputTimer().phase("nonsense"):
                pass
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_manifest_has_the_jax_keys(tmp_path):
    cfg = IT.default_config(res_path=str(tmp_path), batch_size=10)
    got = {}
    for name, kw in (("jax", {}), ("torch", {"device": "cpu"})):
        G = GJ if name == "jax" else GT
        d = tmp_path / name
        man = G.write_run_manifest(str(d), config=cfg,
                                   extra={"workload": "insurance"}, **kw)
        on_disk = json.load(open(d / "run_manifest.json"))
        assert on_disk["run_id"] == man["run_id"] and len(man["run_id"]) == 12
        got[name] = on_disk
    assert set(got["torch"]) == set(got["jax"])
    assert got["torch"]["config"] == got["jax"]["config"]
    assert (got["torch"]["process_index"], got["torch"]["process_count"]) \
        == (got["jax"]["process_index"], got["jax"]["process_count"]) == (0, 1)
    assert set(got["torch"]["devices"]) == set(got["jax"]["devices"])
    assert got["torch"]["devices"]["platform"] == "cpu"
    assert set(got["torch"]["versions"]) == {"torch", "cuda", "cudnn",
                                             "driver"}
    assert got["torch"]["versions"]["torch"] == GT.versions()["torch"]
    # a manifest read without a card names none (no CUDA context exists)
    assert "devices" not in GT.write_run_manifest(str(tmp_path / "n"))


def test_aggregate_goodput_passes_a_report_through_without_a_group():
    from gan_deeplearning4j_tpu.parallel import multihost

    rep = {"dispatch": 1.0, "wall_s": 2.0, "phase_n": {"dispatch": 1}}
    assert mesh.aggregate_goodput(rep, None) == rep \
        == multihost.aggregate_goodput(rep)


def test_trainer_records_the_run_level_goodput(tmp_path):
    """The insurance program, 4 steps: the last metrics record is the JAX
    trainer's ``{"goodput", "run_id"}`` (keys sorted as its pytree writes
    them), equal to the result's; the phases sum to ``wall_s``; the
    manifest and the events header carry the run id; the set-up's spans
    follow ``train.start``."""
    res = IT.main(["--device", "cpu", "--iterations", "4", "--batch-size",
                   "10", "--print-every", "2", "--save-every", "2",
                   "--checkpoint-every", "2", "--res-path", str(tmp_path)])
    last = json.loads(open(tmp_path / "insurance_metrics.jsonl")
                      .read().splitlines()[-1])
    assert list(last) == ["goodput", "run_id"]
    assert list(last["goodput"]) == sorted(last["goodput"])
    assert (last["goodput"], last["run_id"]) == (res["goodput"],
                                                 res["run_id"])
    gp = res["goodput"]
    assert sum(gp[p] for p in PHASES) == pytest.approx(gp["wall_s"], abs=1e-5)
    # the constructor's set-up, the calls, the dumps, the cadence saves
    assert {"data_wait", "dispatch", "readback", "eval", "checkpoint"} \
        <= set(gp["phase_n"])
    assert gp["phase_n"]["readback"] >= 2
    manifest = json.load(open(tmp_path / "run_manifest.json"))
    assert manifest["run_id"] == res["run_id"]
    assert manifest["workload"] == "insurance"
    evs = events.read_events(str(tmp_path / "events.jsonl"))
    assert evs[0]["run_id"] == res["run_id"]
    names = [e["name"] for e in evs]
    assert names[1:4] == ["train.start", "data.prepare", "train.resume"]
    assert {"checkpoint.serialize", "checkpoint.commit"} <= set(names)
