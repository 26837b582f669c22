"""The port's resilient data plane (``gan_deeplearning4j_tpu_torch/data/
resilient.py`` and the quarantine path of its ``data/csv.py``) held to the
JAX package's on the CPU: the same ``quarantine.jsonl`` bytes and tables
for the same corrupt CSV, the same retry counts and backoff delays, the
same error classes; then the trainer's wiring (``--max-quarantine``,
``--data-retries``)."""

import os
import random
import time

import numpy as np
import pytest

from gan_deeplearning4j_tpu.data import csv as CJ
from gan_deeplearning4j_tpu.data import resilient as RJ
from gan_deeplearning4j_tpu_torch.data import csv as CT
from gan_deeplearning4j_tpu_torch.data import datasets
from gan_deeplearning4j_tpu_torch.data import resilient as RT
from gan_deeplearning4j_tpu_torch.train import insurance_main
from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

PKGS = {"jax": (CJ, RJ), "torch": (CT, RT)}

# 5 features + a label in [0, 3); lines 3-7 are corrupt in five ways
CORRUPT_CSV = "\n".join([
    "0.1,0.2,0.3,0.4,0.5,0",
    "0.5,0.4,0.3,0.2,0.1,1",
    "0.1,x,0.3,0.4,0.5,2",          # unparseable field
    "0.1,0.2,nan,0.4,0.5,1",        # non-finite value
    "0.1,0.2,0.3,0.4,1",            # wrong width
    "0.1,0.2,0.3,0.4,0.5,7",        # label outside [0, 3)
    "#0.1,0.2,0.3,0.4,0.5,1",       # a torn row, not a comment
    "0.9,0.8,0.7,0.6,0.5,2",
    "0.3,0.3,0.3,0.3,0.3,0",
]) + "\n"


@pytest.fixture
def frozen_clock(monkeypatch):
    """Both packages stamp a quarantine line with the wall clock."""
    monkeypatch.setattr(time, "time", lambda: 1792222000.125)


def _corrupt_csv(tmp_path):
    path = tmp_path / "data.csv"
    path.write_text(CORRUPT_CSV)
    return str(path)


def test_quarantine_jsonl_and_table_are_the_jax_packages(tmp_path,
                                                         frozen_clock):
    src = _corrupt_csv(tmp_path)
    out = {}
    for name, (C, R) in PKGS.items():
        jl = str(tmp_path / f"{name}.jsonl")
        q = R.RecordQuarantine(jl, budget=10)
        it = C.RecordReaderDataSetIterator(src, 2, label_index=5,
                                           num_classes=3, quarantine=q)
        out[name] = (open(jl, "rb").read(), it.features, it.labels, q.count)
    assert out["torch"][0] == out["jax"][0]
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    np.testing.assert_array_equal(out["torch"][2], out["jax"][2])
    assert out["torch"][3] == out["jax"][3] == 5
    recs = RT.read_quarantine(str(tmp_path / "torch.jsonl"))
    assert [(r["line"], r["row"]) for r in recs] == [
        (3, None), (4, None), (5, None), (7, None), (None, 2)]


def test_budget_exhaustion_raises_the_same_error(tmp_path, frozen_clock):
    src = _corrupt_csv(tmp_path)
    msgs = {}
    for name, (C, R) in PKGS.items():
        jl = str(tmp_path / f"{name}.jsonl")
        with pytest.raises(R.DataQuarantineError) as e:
            C.RecordReaderDataSetIterator(
                src, 2, label_index=5, num_classes=3,
                quarantine=R.RecordQuarantine(jl, budget=2))
        msgs[name] = str(e.value).replace(jl, "<jsonl>")
    assert msgs["torch"] == msgs["jax"]
    assert f"{src}:5" in msgs["torch"]


def test_strict_read_names_the_same_file_line(tmp_path):
    src = _corrupt_csv(tmp_path)
    errs = {}
    for name, (C, _) in PKGS.items():
        with pytest.raises(C.CSVRowError) as e:
            C.CSVRecordReader().read(src)
        errs[name] = (e.value.path, e.value.line, e.value.reason)
    assert errs["torch"] == errs["jax"] == (src, 3, "unparseable field")


def test_charges_are_idempotent_per_record(tmp_path, frozen_clock):
    for name, (_, R) in PKGS.items():
        q = R.RecordQuarantine(str(tmp_path / f"{name}.jsonl"), budget=3)
        for _ in range(3):
            q.charge("f.csv", line=4, reason="bad")
        q.charge("f.csv", row=9, reason="bad")
        assert q.count == 2, name
    assert (open(tmp_path / "torch.jsonl", "rb").read()
            == open(tmp_path / "jax.jsonl", "rb").read())


@pytest.mark.parametrize("fails", [0, 2, 3, 4])
def test_retry_counts_and_backoff_are_the_jax_packages(fails):
    """The same attempts, the same jittered delays from the same seed, the
    same health counts, and past ``retries`` the same DataSourceError."""
    out = {}
    for name, (_, R) in PKGS.items():
        calls, delays = {"n": 0}, []

        def fn():
            calls["n"] += 1
            if calls["n"] <= fails:
                raise (OSError if calls["n"] % 2 else EOFError)(
                    f"transient {calls['n']}")
            return "row"

        health = R.DataHealth()
        try:
            got = R.call_with_retries(fn, "read x", retries=3, backoff_s=0.1,
                                      health=health, rng=random.Random(7),
                                      sleep=delays.append)
        except R.DataSourceError as e:
            got = ("DataSourceError", str(e))
        out[name] = (got, calls["n"], delays, health.retries_total)
    assert out["torch"] == out["jax"]
    assert out["torch"][3] == fails


def test_retrying_reader_and_source_are_the_jax_packages(tmp_path):
    """The wrappers around a CSV reader and a record source that fail
    twice: the same table, batches, delays and retry counts."""
    src = str(tmp_path / "ok.csv")
    np.savetxt(src, np.arange(24, dtype=np.float32).reshape(4, 6),
               delimiter=",", fmt="%.2f")
    out = {}
    for name, (C, R) in PKGS.items():
        class Flaky:
            def __init__(self):
                self.n = 0

            def read(self, path, *a, **kw):
                self.n += 1
                if self.n <= 2:
                    raise OSError("nfs blip")
                return C.CSVRecordReader().read(path, *a, **kw)

        health, delays = R.DataHealth(), []
        reader = R.RetryingReader(Flaky(), retries=3, health=health, seed=5,
                                  sleep=delays.append)
        it = C.RecordReaderDataSetIterator(src, 2, label_index=5,
                                           num_classes=1, reader=reader)

        class FlakySource:
            def __init__(self, inner):
                self.inner, self.n = inner, 0

            def has_next(self):
                return self.inner.has_next()

            def next(self):
                self.n += 1
                if self.n == 2:
                    raise EOFError("torn read")
                return self.inner.next()

            def reset(self):
                self.inner.reset()

            def state(self):
                return self.inner.state()

        source = R.RetryingSource(FlakySource(it), retries=3, health=health,
                                  seed=5, sleep=delays.append)
        batches = []
        while source.has_next():
            batches.append(source.next().features)
        out[name] = (np.concatenate(batches), delays, health.retries_total,
                     source.state())
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    assert out["torch"][1:] == out["jax"][1:]
    assert out["torch"][2] == 3


def test_validating_source_is_the_jax_packages(tmp_path, frozen_clock):
    feats = np.arange(30, dtype=np.float32).reshape(6, 5)
    feats[1, 2] = np.nan
    feats[4, 0] = np.inf
    labels = np.ones((6, 1), np.float32)
    labels[3, 0] = np.nan
    out = {}
    for name, (C, R) in PKGS.items():
        jl = str(tmp_path / f"{name}.jsonl")
        it = C.RecordReaderDataSetIterator(
            np.concatenate([feats, labels], 1), 3, label_index=5,
            num_classes=1)
        v = R.ValidatingSource(it, R.RecordQuarantine(jl, budget=5),
                               num_features=5, name="s")
        got = []
        while v.has_next():
            ds = v.next()
            got.append((ds.features, ds.labels))
        bad = R.ValidatingSource(
            C.RecordReaderDataSetIterator(np.zeros((2, 4), np.float32), 2,
                                          label_index=3, num_classes=1),
            R.RecordQuarantine(jl, budget=5), num_features=5, name="w")
        empty = bad.next()
        out[name] = (got, open(jl, "rb").read(), empty.features.shape)
    for (fa, la), (fb, lb) in zip(out["torch"][0], out["jax"][0]):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)
    assert out["torch"][1:] == out["jax"][1:]


def test_error_classes_are_the_jax_packages():
    for cls in ("DataSourceError", "DataQuarantineError"):
        tj, tt = getattr(RJ, cls), getattr(RT, cls)
        assert [b.__name__ for b in tt.__mro__] == [
            b.__name__ for b in tj.__mro__]
    assert RT.TRANSIENT_ERRORS == RJ.TRANSIENT_ERRORS
    assert RT.QUARANTINE_NAME == RJ.QUARANTINE_NAME
    assert RT.DataHealth().report().keys() == RJ.DataHealth().report().keys()
    assert issubclass(CT.CSVRowError, ValueError)


def _insurance_csv(tmp_path):
    d = str(tmp_path)
    train, _ = datasets.ensure_insurance_csv(d)
    lines = open(train).read().split("\n")
    lines[4] = lines[4].replace(",", ",x", 1)      # line 5: unparseable
    lines[9] = lines[9].rsplit(",", 1)[0]          # line 10: wrong width
    open(train, "w").write("\n".join(lines))
    return d, train


def test_trainer_quarantines_corrupt_rows(tmp_path):
    """``--max-quarantine`` at the program level: the run finishes and
    ``quarantine.jsonl`` names both corrupt lines; strict (0) raises
    ``CSVRowError`` at the first, naming its file:line."""
    d, train = _insurance_csv(tmp_path)
    args = ["--device", "cpu", "--iterations", "2", "--batch-size", "10",
            "--print-every", "2", "--save-every", "2", "--res-path", d]
    _, res = insurance_main.run(insurance_main.parse_args(
        args + ["--max-quarantine", "2"]))
    assert res["steps"] == 2
    recs = RT.read_quarantine(os.path.join(d, RT.QUARANTINE_NAME))
    assert [(r["file"], r["line"]) for r in recs] == [(train, 5), (train, 10)]
    with pytest.raises(CT.CSVRowError, match=f"{train}:5"):
        insurance_main.run(insurance_main.parse_args(args))
    with pytest.raises(RT.DataQuarantineError):
        insurance_main.run(insurance_main.parse_args(
            args + ["--max-quarantine", "1"]))


def test_trainer_retries_a_transient_read(tmp_path, monkeypatch):
    """``data_retries``: a read that fails once is retried (one retry on
    the trainer's health counters); 0 lets the error through."""
    orig = CT.CSVRecordReader.read
    calls = {"n": 0}

    def flaky(self, path, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError(f"transient read error on {path}")
        return orig(self, path, *a, **kw)

    monkeypatch.setattr(CT.CSVRecordReader, "read", flaky)

    def trainer(retries):
        return GANTrainer(device="cpu",
                          workload=insurance_main.InsuranceWorkload(),
                          config=insurance_main.default_config(
                              res_path=str(tmp_path), num_iterations=1,
                              data_retries=retries,
                              data_retry_backoff_s=0.0, metrics=False))

    t = trainer(3)
    assert t.data_health.retries_total == 1 and calls["n"] == 3
    calls["n"] = 0
    with pytest.raises(OSError, match="transient"):
        trainer(0)
