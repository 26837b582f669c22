"""The fleet's entry point as a process (``python -m
gan_deeplearning4j_tpu_torch.scenario.trainer_child --device cpu``): exit
0 with ``final.json``; SIGTERM drains to exit 75 with ``PREEMPTED.json``
and an emergency checkpoint, and ``--resume`` finishes where an
uninterrupted run finishes, bit for bit (same ``final.json`` losses: the
latents' generator state rides the checkpoint); SIGUSR1 is exit 82 with no
emergency checkpoint.  The feed carries ``#CORRUPT#`` rows, which the
per-tenant quarantine charges.  4 tenants, batch 4, on the CPU."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
ITERS = 40
TIMEOUT_S = 240


def _csv(path: Path) -> None:
    rng = np.random.RandomState(3)
    rows = [",".join(f"{v:.5f}" for v in rng.rand(12))
            + f",{int(rng.rand() < 0.5)}" for _ in range(4 * 24)]
    for r in (6, 17):
        rows[r] = "#CORRUPT#," + rows[r]
    path.write_text("\n".join(rows) + "\n")


def _child(res: Path, data: Path, *extra) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m",
           "gan_deeplearning4j_tpu_torch.scenario.trainer_child",
           "--res-path", str(res), "--data", str(data), "--tenants", "4",
           "--iterations", str(ITERS), "--batch-size", "4",
           "--checkpoint-every", "8", "--device", "cpu", *extra]
    return subprocess.Popen(cmd, cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _steps(res: Path):
    d = res / "checkpoints"
    return sorted(int(p.name[5:]) for p in d.glob("ckpt_*")) if d.exists() \
        else []


def _signal_after_first_save(proc, res: Path, sig) -> None:
    """Once READY.json names the child and one cadence checkpoint is
    committed, send ``sig``."""
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            pytest.fail(f"child exited early: rc={proc.returncode} "
                        f"{proc.stderr.read()[-2000:]}")
        if (res / "READY.json").exists() and _steps(res):
            assert json.loads((res / "READY.json").read_text())[
                "pid"] == proc.pid
            proc.send_signal(sig)
            return
        time.sleep(0.02)
    proc.kill()
    pytest.fail("child never became ready")


def _finish(proc) -> tuple:
    out, err = proc.communicate(timeout=TIMEOUT_S)
    return proc.returncode, out, err


def test_trainer_child_exit_codes_and_resume(tmp_path):
    data = tmp_path / "feed.csv"
    _csv(data)
    # the first three incarnations run side by side
    ref = _child(tmp_path / "ref", data)
    term = _child(tmp_path / "term", data, "--step-delay-s", "0.1")
    lost = _child(tmp_path / "lost", data, "--step-delay-s", "0.1")
    _signal_after_first_save(term, tmp_path / "term", signal.SIGTERM)
    _signal_after_first_save(lost, tmp_path / "lost", signal.SIGUSR1)

    rc, out, err = _finish(ref)
    assert rc == 0, err[-2000:]
    final = json.loads((tmp_path / "ref" / "final.json").read_text())
    assert final["step"] == ITERS and final["tenants"] == 4
    assert final["quarantined"] == 2  # the two #CORRUPT# rows
    assert json.loads(out.strip().splitlines()[-1]) == final

    rc, out, err = _finish(term)
    assert rc == 75, err[-2000:]
    marker = json.loads((tmp_path / "term" / "PREEMPTED.json").read_text())
    said = json.loads(out.strip().splitlines()[-1])
    assert said["preempted"] and 0 < said["step"] < ITERS
    assert said["step"] in _steps(tmp_path / "term")  # the emergency save
    assert marker["step"] == said["step"]
    assert not (tmp_path / "term" / "final.json").exists()
    resumed = _child(tmp_path / "term", data, "--resume")
    rc, out, err = _finish(resumed)
    assert rc == 0, err[-2000:]
    again = json.loads((tmp_path / "term" / "final.json").read_text())
    assert again == final  # step, quarantine and losses, bit for bit

    rc, out, err = _finish(lost)
    assert rc == 82, err[-2000:]
    said = json.loads(out.strip().splitlines()[-1])
    assert said["device_lost"] and 0 < said["step"] < ITERS
    # lost hardware does not flush: nothing at or after the lost step
    assert max(_steps(tmp_path / "lost")) < said["step"]
    assert not (tmp_path / "lost" / "PREEMPTED.json").exists()
