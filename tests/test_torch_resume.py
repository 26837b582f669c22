"""Resume, recovery and preemption of the port's trainer on the CPU: a run
checkpointed and resumed is bitwise the run that never stopped (insurance
and CV, resident and streamed, with a partial epoch tail, at world 1 and
over two gloo ranks); ``train_with_recovery`` finishes as a run that never
failed and does not retry the fatal classes; a SIGTERM'd program exits 75
with ``PREEMPTED.json`` and ``--resume`` finishes it; a JAX checkpoint
resumed in the port steps as the JAX package does."""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.train import gan_trainer as GJ
from gan_deeplearning4j_tpu.train import insurance_main as IJ
from gan_deeplearning4j_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    TrainCheckpointer,
)
from gan_deeplearning4j_tpu_torch.data.csv import DataSet
from gan_deeplearning4j_tpu_torch.data.prefetch import (
    ChunkPrefetchIterator,
    PrefetchIterator,
)
from gan_deeplearning4j_tpu_torch.data.resilient import (
    DataQuarantineError,
    DataSourceError,
)
from gan_deeplearning4j_tpu_torch.train import cv_main, fused_step
from gan_deeplearning4j_tpu_torch.train import insurance_main as IT
from gan_deeplearning4j_tpu_torch.train.gan_trainer import (
    GANTrainer,
    advance_latents,
    train_with_recovery,
)
from gan_deeplearning4j_tpu_torch.train.preemption import (
    EXIT_PREEMPTED,
    MARKER_NAME,
    PreemptionError,
)

REPO = Path(__file__).resolve().parents[1]
# one insurance step against the JAX package's from the same state: the
# band of tests/test_torch_insurance.py (params 2e-5 absolute, caches 2e-3
# of each leaf's largest value plus eps, losses 1e-5 relative)
PARAM_TOL = 2e-5


def _leaves_equal(a: fused_step.ProtocolState, b: fused_step.ProtocolState):
    la, lb = fused_step._leaves(a), fused_step._leaves(b)
    assert la.keys() == lb.keys()
    bad = [k for k in la if not torch.equal(la[k], lb[k])]
    assert not bad, f"{len(bad)} leaves differ, first {bad[0]}"
    assert int(a.it) == int(b.it)


def _insurance(res, n, **kw):
    base = dict(res_path=res, num_iterations=n, print_every=2, save_every=2,
                metrics=False)
    base.update(kw)
    return GANTrainer(device="cpu", workload=IT.InsuranceWorkload(),
                      config=IT.default_config(**base))


@pytest.mark.parametrize("tier", ["resident_ema", "streamed"])
def test_insurance_two_plus_two_is_four(tmp_path, tier):
    """2 steps, a checkpoint, a new trainer resuming to 4: bitwise the
    4-step run (state, EMA, latent generator, losses)."""
    kw = (dict(ema_decay=0.9) if tier == "resident_ema"
          else dict(data_on_device=False))
    full = _insurance(str(tmp_path / "full"), 4, **kw)
    r_full = full.train(log=None)
    _insurance(str(tmp_path / "r"), 2, checkpoint_every=2, **kw).train(
        log=None)
    b = _insurance(str(tmp_path / "r"), 4, checkpoint_every=2, resume=True,
                   **kw)
    assert b.steps == 2 and b.resident == (tier != "streamed")
    r_b = b.train(log=None)
    _leaves_equal(full.state, b.state)
    assert torch.equal(full.z_gen.get_state(), b.z_gen.get_state())
    assert (r_b["d_loss"], r_b["g_loss"]) == (r_full["d_loss"],
                                              r_full["g_loss"])


def test_cv_resume_with_a_partial_epoch_tail_is_bitwise(tmp_path):
    """The CV program (full width) on 40 rows at batch 16 (two batches and
    a tail of 8): preempted in the process at step 2 (the guard, the
    emergency checkpoint, PREEMPTED.json), resumed to 4: bitwise the
    4-step run."""
    base = ["--n-train", "40", "--n-test", "16", "--iterations", "4",
            "--batch-size", "16", "--print-every", "2", "--save-every", "2",
            "--fid-samples", "0", "--device", "cpu"]
    # the uninterrupted run: the bare loop on the same decoded table
    # (``datasets.mnist_table``, bitwise the CSV's), without files
    full = GANTrainer(batch_size=16, n_train=40, device="cpu")
    full.train(4, log=None)
    d = str(tmp_path / "r")
    args = cv_main.parse_args(base + ["--res-path", d, "--preempt-signal",
                                      "SIGTERM"])
    config = cv_main._config(args, {})
    cfg = cv_main.M.CVConfig(seed=args.seed)
    t = GANTrainer(cfg, device="cpu", config=config,
                   workload=cv_main.CVWorkload(cfg, n_train=40, n_test=16))

    def log(line):
        if line.startswith("step 2:"):
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    with pytest.raises(PreemptionError) as e:
        t.train(log=log)
    assert e.value.step == 2
    marker = json.load(open(os.path.join(d, MARKER_NAME)))
    assert marker["step"] == 2 and marker["signal"] == "SIGTERM"
    assert signal.getsignal(signal.SIGTERM) == prev  # the handler is back
    b, res = cv_main.run(cv_main.parse_args(base + ["--res-path", d,
                                                    "--resume"]))
    assert res["steps"] == 4 and not os.path.exists(
        os.path.join(d, MARKER_NAME))
    _leaves_equal(full.state, b.state)


def test_stream_chunked_resume_with_a_changed_cadence(tmp_path):
    """tests/test_train.py::test_stream_chunked_resume_with_changed_cadence:
    a streamed resume from a step the new chunk size does not divide keeps
    the chunks aligned (K is gcd'd with the resume step)."""
    d = str(tmp_path)
    t1 = _insurance(d, 3, checkpoint_every=3, print_every=0, save_every=0,
                    data_on_device=False)
    t1.train(log=None)
    assert t1.stream_k == 3
    t2 = _insurance(d, 8, checkpoint_every=4, print_every=0, save_every=0,
                    data_on_device=False, resume=True)
    res = t2.train(log=None)
    assert res["steps"] == 8 and t2.stream_k == 1  # gcd(gcd(8, 4), 3)
    assert np.isfinite(res["d_loss"]) and np.isfinite(res["g_loss"])


def test_recovery_after_a_crash_equals_a_run_that_never_failed(tmp_path):
    """A crash at step 5 (after the step-4 checkpoint) restarts from it and
    finishes bitwise the run that never failed."""
    def make(res, fail=None):
        def make_trainer(resume):
            t = _insurance(res, 8, batch_size=20, steps_per_call=1,
                           print_every=0, save_every=8, checkpoint_every=2,
                           resume=resume)
            if fail is not None:
                orig = t._bookkeeping

                def bookkeeping(rows):
                    if t.steps == 5 and fail["left"]:
                        fail["left"] -= 1
                        raise RuntimeError("injected crash at step 5")
                    orig(rows)

                t._bookkeeping = bookkeeping
            return t
        return make_trainer

    ref = make(str(tmp_path / "ref"))(False)
    ref.train(log=None)
    fail = {"left": 1}
    holder = {}

    def make_trainer(resume):
        holder["t"] = make(str(tmp_path / "flaky"), fail)(resume)
        return holder["t"]

    lines = []
    res = train_with_recovery(make_trainer, max_restarts=2,
                              log=lines.append, backoff_base_s=0)
    assert res["steps"] == 8 and fail["left"] == 0
    assert any("restart 1/2" in ln for ln in lines)
    _leaves_equal(ref.state, holder["t"].state)


@pytest.mark.parametrize("exc", [
    ValueError("config"), TypeError("type"),
    CheckpointCorruptError("torn"), DataQuarantineError("budget"),
    PreemptionError("evicted", step=3)], ids=lambda e: type(e).__name__)
def test_fatal_classes_are_not_retried(exc):
    calls = []

    class Stub:
        steps = 0

        def train(self, log=None):
            raise exc

    def make(resume):
        calls.append(resume)
        return Stub()

    with pytest.raises(type(exc)):
        train_with_recovery(make, max_restarts=3, log=None, backoff_base_s=0)
    assert calls == [False]


def test_retry_budget_is_progress_aware():
    """Retryable failures (a DataSourceError among them) restart with
    resume; the budget resets when a failure lands at a later step, and a
    crash loop at one step exhausts it."""
    steps = iter([1, 2, 3, 3, 3, 3])
    calls = []

    class Stub:
        def __init__(self):
            self.steps = next(steps)

        def train(self, log=None):
            raise (DataSourceError if self.steps == 2 else RuntimeError)(
                f"at {self.steps}")

    def make(resume):
        calls.append(resume)
        return Stub()

    with pytest.raises(RuntimeError, match="at 3"):
        train_with_recovery(make, max_restarts=2, log=None, backoff_base_s=0)
    assert calls == [False, True, True, True, True]


def test_sigterm_exits_75_and_resume_finishes_equal(tmp_path):
    """The program in a child process is sent SIGTERM after step 100: it
    exits 75 with PREEMPTED.json and a verified checkpoint at its step;
    ``--resume`` in this process finishes bitwise the uninterrupted run."""
    base = ["--device", "cpu", "--iterations", "300", "--batch-size", "10",
            "--checkpoint-every", "100", "--preempt-signal", "SIGTERM"]
    d = str(tmp_path / "pre")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.train."
         "insurance_main", *base, "--res-path", d],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        for line in proc.stdout:
            if line.startswith("Completed Batch 100!"):
                proc.send_signal(signal.SIGTERM)
                break
        out = proc.stdout.read()
        assert proc.wait(timeout=120) == EXIT_PREEMPTED
    finally:
        if proc.poll() is None:
            proc.kill()
    result = json.loads(out.strip().splitlines()[-1])
    marker = json.load(open(os.path.join(d, MARKER_NAME)))
    assert result["preempted"] and result["step"] == marker["step"]
    assert 100 <= marker["step"] < 300
    assert TrainCheckpointer(os.path.join(d, "checkpoints")).verify(
        marker["step"])
    b, res = IT.run(IT.parse_args(base + ["--res-path", d, "--resume"]))
    ref, _ = IT.run(IT.parse_args(base + ["--res-path",
                                          str(tmp_path / "ref")]))
    assert res["steps"] == 300 and not os.path.exists(
        os.path.join(d, MARKER_NAME))
    _leaves_equal(ref.state, b.state)


def test_two_gloo_ranks_preempt_and_resume_equal(tmp_path):
    """``--n-devices 2``: SIGTERM to the parent reaches both ranks, which
    agree on the step; rank 0's checkpoint resumes both ranks, and the
    resumed run ends as the uninterrupted one."""
    base = ["--device", "cpu", "--n-devices", "2", "--iterations", "100",
            "--batch-size", "10", "--checkpoint-every", "25",
            "--print-every", "25", "--save-every", "25",
            "--preempt-signal", "SIGTERM"]
    d = str(tmp_path / "pre")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.train."
         "insurance_main", *base, "--res-path", d],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        for line in proc.stdout:
            if line.startswith("step 25:"):
                proc.send_signal(signal.SIGTERM)
                break
        proc.stdout.read()
        assert proc.wait(timeout=300) == EXIT_PREEMPTED
    finally:
        if proc.poll() is None:
            proc.kill()
    stop = json.load(open(os.path.join(d, MARKER_NAME)))["step"]
    assert 25 <= stop < 100
    _, res = IT.run(IT.parse_args(base + ["--res-path", d, "--resume"]))
    _, ref = IT.run(IT.parse_args(base + ["--res-path",
                                          str(tmp_path / "ref")]))
    assert res["steps"] == ref["steps"] == 100 and res["world"] == 2
    for g in ("dis", "gan", "gen", "insurance"):
        assert (open(os.path.join(d, f"insurance_{g}_model.zip"), "rb").read()
                == open(os.path.join(str(tmp_path / "ref"),
                                     f"insurance_{g}_model.zip"), "rb").read())


def test_param_averaging_ranks_resume_equal(tmp_path):
    """Two gloo ranks of the unfused loop with param_averaging: rank 0's
    checkpoint at step 2 (the ranks hold equal params after every fit's
    average) resumes both ranks to the uninterrupted run's zips."""
    base = ["--device", "cpu", "--n-devices", "2", "--dp-mode",
            "param_averaging", "--batch-size", "10", "--print-every", "2",
            "--save-every", "2", "--checkpoint-every", "2"]
    d, ref = str(tmp_path / "r"), str(tmp_path / "ref")
    IT.run(IT.parse_args(base + ["--iterations", "2", "--res-path", d]))
    _, res = IT.run(IT.parse_args(base + ["--iterations", "4", "--resume",
                                          "--res-path", d]))
    IT.run(IT.parse_args(base + ["--iterations", "4", "--res-path", ref]))
    assert res["steps"] == 4 and not res["fused"]
    for g in ("dis", "gan", "gen", "insurance"):
        assert (open(os.path.join(d, f"insurance_{g}_model.zip"), "rb").read()
                == open(os.path.join(ref, f"insurance_{g}_model.zip"),
                        "rb").read())


def test_jax_checkpoint_resumed_in_the_port_steps_as_jax(tmp_path):
    """The JAX package's insurance trainer checkpoints steps 2 and 3; the
    port resumes its step-2 checkpoint and takes one step on the JAX
    trainer's own step-3 latents: within the one-step band of
    tests/test_torch_insurance.py (PARAM_TOL) of the JAX step 3."""
    d = str(tmp_path / "jax")
    tj = GJ.GANTrainer(IJ.InsuranceWorkload(), IJ.default_config(
        num_iterations=3, res_path=d, print_every=3, save_every=3,
        checkpoint_every=1, metrics=False, events=False, n_devices=1))
    tj.train(log=lambda s: None)
    z1, z2 = (np.asarray(tj._z(2, k)) for k in (0, 1))
    ck = os.path.join(d, "checkpoints")
    for s in (1, 3):
        os.rename(os.path.join(ck, f"ckpt_{s}"),
                  os.path.join(str(tmp_path), f"aside_{s}"))
    t = GANTrainer(device="cpu", workload=IT.InsuranceWorkload(),
                   config=IT.default_config(res_path=d, num_iterations=3,
                                            resume=True, metrics=False))
    assert t.steps == 2
    state, losses = t.step_fn(1)(
        t.state, t.features, t.labels, t.y_real, t.y_fake, t.ones,
        z1=torch.from_numpy(z1), z2=torch.from_numpy(z2))
    assert int(state.it) == 3
    worst = {"param": 0.0, "cache": 0.0}
    for name, (params, opt) in {
            "dis": (state.dis_params, state.dis_opt),
            "gan": (state.gan_params, state.gan_opt),
            "classifier": (state.clf_params, state.clf_opt),
            "gen": (state.gen_params, None)}.items():
        g = getattr(tj, name)
        for kind, ref, got in (("param", g.params, params),
                               ("cache", g.opt_state, opt)):
            if got is None:
                continue
            for ly, lp in got.items():
                for n, v in lp.items():
                    a = np.asarray(ref[ly][n])
                    dv = float(np.abs(v.numpy() - a).max()) if a.size else 0
                    if kind == "cache":
                        dv /= float(np.abs(a).max()) + 1e-8
                    worst[kind] = max(worst[kind], dv)
    assert worst["param"] <= PARAM_TOL and worst["cache"] <= 2e-3, worst
    np.testing.assert_allclose([float(v) for v in losses],
                               [float(tj.dis.score), float(tj.gan.score),
                                float(tj.classifier.score)], rtol=1e-5)


def test_a_checkpoint_without_the_generator_state_replays_it(tmp_path):
    """The two routes to the latent generator at step s: the saved
    ``z_gen_state`` and a replay of its 2s draws (a JAX checkpoint has no
    such key) give the same state, and the same resumed run."""
    d = str(tmp_path / "a")
    t = _insurance(d, 2, checkpoint_every=2)
    t.train(log=None)
    fresh = _insurance(str(tmp_path / "f"), 0)
    advance_latents(fresh.z_gen, 2, 50, 2, "cpu")
    assert torch.equal(fresh.z_gen.get_state(), t.z_gen.get_state())
    # the same checkpoint re-saved without the key
    src = TrainCheckpointer(os.path.join(d, "checkpoints"))
    graphs = {k: getattr(fresh, k) for k in ("dis", "gen", "gan",
                                             "classifier")}
    step, extra = src.restore(graphs)
    assert step == 2 and "z_gen_state" in extra
    del extra["z_gen_state"]
    e = str(tmp_path / "b")
    TrainCheckpointer(os.path.join(e, "checkpoints")).save(
        2, graphs, extra={k: v if isinstance(v, str) else np.asarray(v)
                          for k, v in extra.items()})
    ra = _insurance(d, 4, resume=True)
    rb = _insurance(e, 4, resume=True)
    assert torch.equal(ra.z_gen.get_state(), rb.z_gen.get_state())
    ra.train(log=None)
    rb.train(log=None)
    _leaves_equal(ra.state, rb.state)


class _Rows:
    """A has_next/next/reset source of 5 batches of 2 rows, with state."""

    def __init__(self):
        self.i, self.epoch = 0, 0
        self.features = np.zeros((10, 3), np.float32)
        self.labels = np.zeros((10, 1), np.float32)

    def has_next(self):
        return self.i < 5

    def next(self):
        self.i += 1
        v = 10 * self.epoch + self.i
        return DataSet(np.full((2, 3), v, np.float32),
                       np.full((2, 1), v, np.float32))

    def reset(self):
        self.i, self.epoch = 0, self.epoch + 1

    def state(self):
        return {"epoch": self.epoch, "i": self.i}

    def restore_state(self, st):
        self.epoch, self.i = st["epoch"], st["i"]


def test_prefetch_restore_state_repositions_the_pipeline():
    """``restore_state`` drops what was staged and restarts the worker at
    the given position: the next batches are those after it."""
    it = PrefetchIterator(_Rows(), prefetch_depth=2, loop=True)
    [next(it) for _ in range(3)]
    assert it.state() == {"epoch": 0, "i": 3}
    it.restore_state({"epoch": 1, "i": 4})
    feats, _ = next(it)
    assert feats[0, 0] == 15 and it.state() == {"epoch": 1, "i": 5}
    it.close()
    chunks = ChunkPrefetchIterator(_Rows(), 2, 2, prefetch_depth=1)
    f, lab = torch.zeros((4, 3)), torch.zeros((4, 1))
    chunks.next_into(f, lab)
    assert f[:, 0].tolist() == [1, 1, 2, 2]
    chunks.restore_state({"epoch": 2, "i": 1})
    for _ in range(3):  # every slot came back: no stall
        chunks.next_into(f, lab)
    assert f[:, 0].tolist() == [31, 31, 32, 32]  # 22..25, then the wrap
    chunks.close()


def test_recovery_flags_have_the_jax_defaults():
    for main in (cv_main, IT):
        a = main.parse_args([])
        assert (a.checkpoint_every, a.resume, a.max_restarts,
                a.async_checkpoint, a.preempt_signal, a.data_retries,
                a.max_quarantine) == (0, False, 0, False, None, 3, 0)
        a = main.parse_args(["--preempt-signal", "SIGTERM",
                             "--preempt-signal", "SIGUSR1"])
        assert main._config(a, {}).preempt_signals == "SIGTERM,SIGUSR1"
        with pytest.raises(SystemExit):
            main.parse_args(["--max-restarts", "1"])
    with pytest.raises(ValueError, match="uncatchable"):
        _insurance("unused", 1, preempt_signals="SIGKILL")
    with pytest.raises(ValueError, match="res_path"):
        GANTrainer(device="cpu", workload=IT.InsuranceWorkload(),
                   config=IT.default_config(res_path=None,
                                            checkpoint_every=2))
