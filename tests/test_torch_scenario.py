"""The combined train -> serve chaos scenario (``scenario/``) on the CPU,
held against the JAX package's ``scenario/runner.py``:

* ``_write_insurance_csv`` writes JAX's bytes for the same seed;
* ``trainer_child --device cpu --n-devices 2`` (a tenant mesh of 2
  shards) exits 0 with ``final.json``;
* the same child sent SIGUSR1 once ``READY.json`` names it exits 82 with
  no emergency checkpoint; respawned with ``--n-devices 1 --resume`` it
  restores the world-2 checkpoint through the reshard and exits 0, its
  final d/g loss within 5% of a world-2 control (equal, in fact: the
  latents are keyed on global tenant ids);
* ``run_scenario(device="cpu")`` with the asserts of JAX's
  ``test_combined_chaos_scenario_end_to_end``, in the ``slow`` lane as its
  twin is (``chip_smoke.py``'s ``scenario`` phase runs it on the card);
  its band's control reads the chaos run's feed, the JAX runner's
  clean-feed control reported beside it (ROADMAP Queue 3).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from gan_deeplearning4j_tpu.scenario import runner as RJ
from gan_deeplearning4j_tpu_torch.scenario import runner as RT
from gan_deeplearning4j_tpu_torch.scenario.trainer_child import (
    EXIT_DEVICE_LOST,
    FINAL_NAME,
)

ITERS = 24
TIMEOUT_S = 240
BAND = 0.05  # the JAX runner's band, against the world-2 control


@pytest.mark.parametrize("seed,rows", [(23, 64), (5, 8), (7, 33)])
def test_write_insurance_csv_is_byte_equal_to_jax(tmp_path, seed, rows):
    a, b = tmp_path / "j.csv", tmp_path / "t.csv"
    RJ._write_insurance_csv(str(a), rows=rows, width=13, seed=seed)
    RT._write_insurance_csv(str(b), rows=rows, width=13, seed=seed)
    assert a.read_bytes() == b.read_bytes()


def _child(res, data, *extra):
    env = dict(RT._child_env(None), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", RT.TRAINER_MODULE, "--res-path", str(res),
           "--data", str(data), "--tenants", "4", "--iterations", str(ITERS),
           "--batch-size", "4", "--checkpoint-every", "8", "--seed", "23",
           "--device", "cpu", *extra]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _steps(res):
    d = res / "checkpoints"
    return sorted(int(p.name[5:]) for p in d.glob("ckpt_*")) \
        if d.exists() else []


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT_S)
    return proc.returncode, out, err


def test_trainer_child_world_2_then_device_lost_then_world_1(tmp_path):
    data = tmp_path / "feed.csv"
    RT._write_insurance_csv(str(data), rows=4 * 16, width=13, seed=23)
    ctrl = _child(tmp_path / "control", data, "--n-devices", "2")
    lost_res = tmp_path / "lost"
    lost = _child(lost_res, data, "--n-devices", "2", "--step-delay-s",
                  "0.05")
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        if lost.poll() is not None:
            pytest.fail(f"child exited early: rc={lost.returncode} "
                        f"{lost.stderr.read()[-2000:]}")
        ready = lost_res / "READY.json"
        if ready.exists() and _steps(lost_res):
            assert json.loads(ready.read_text())["pid"] == lost.pid
            lost.send_signal(signal.SIGUSR1)
            break
        time.sleep(0.02)
    else:
        lost.kill()
        pytest.fail("child never became ready")

    rc, out, err = _finish(ctrl)
    assert rc == 0, err[-2000:]
    want = json.loads((tmp_path / "control" / FINAL_NAME).read_text())
    assert want["step"] == ITERS and want["tenants"] == 4
    assert np.isfinite(want["d_loss"]) and np.isfinite(want["g_loss"])

    rc, out, err = _finish(lost)
    assert rc == EXIT_DEVICE_LOST, err[-2000:]
    said = json.loads(out.strip().splitlines()[-1])
    assert said["device_lost"] and 0 < said["step"] < ITERS
    # lost hardware does not flush: nothing at or after the lost step
    saved = _steps(lost_res)
    assert saved and max(saved) < said["step"]
    assert not (lost_res / "PREEMPTED.json").exists()
    assert not (lost_res / FINAL_NAME).exists()

    again = _child(lost_res, data, "--n-devices", "1", "--resume")
    rc, out, err = _finish(again)
    assert rc == 0, err[-2000:]
    got = json.loads((lost_res / FINAL_NAME).read_text())
    assert got["step"] == ITERS
    for key in ("d_loss", "g_loss"):
        assert abs(got[key] - want[key]) <= BAND * abs(want[key]), key
    assert got == want  # the trajectory does not depend on the world
    evs = [json.loads(ln) for ln in
           (lost_res / "events.jsonl").read_text().splitlines()]
    starts = [e for e in evs if e.get("name") == "fleet.start"]
    assert [e["devices"] for e in starts] == [2, 1]
    moved = [e for e in evs if e.get("name") == "reshard.restore"]
    assert len(moved) == 1 and moved[0]["step"] == max(saved)
    assert (moved[0]["from_devices"], moved[0]["to_devices"]) == (2, 1)


@pytest.mark.slow
def test_combined_chaos_scenario_end_to_end(tmp_path):
    """The whole organism under seeded combined chaos on the CPU: every
    verified checkpoint published by canary, the poisoned one rejected,
    serving held on stale weights, the trajectory banded against the
    undisturbed control, one merged cross-process timeline."""
    verdict = RT.run_scenario(str(tmp_path / "scenario"), seed=23,
                              device="cpu", log=lambda s: None)
    assert verdict["ok"], verdict["failures"]
    assert verdict["trainer"]["exits"][:2] == [75, EXIT_DEVICE_LOST]
    assert verdict["publish"]["rejected_total"] >= 1
    assert not verdict["serving"]["non_typed"]
    assert verdict["trace"]["trainer_incarnations"] >= 2
    # the band's control read the chaos run's feed; the clean-feed control
    # (the JAX runner's) is reported beside it
    assert set(verdict["band"]) == set(verdict["band_clean_feed"]) == {
        "d_loss", "g_loss"}
    assert verdict["trace"]["reshards"][0]["to_devices"] == 1
    assert os.path.exists(tmp_path / "scenario" / "scenario.json")
    assert os.path.exists(tmp_path / "scenario" / "merged_trace.json")
