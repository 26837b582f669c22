"""The port's checkpoint-publication pipeline
(``gan_deeplearning4j_tpu_torch/serve/publisher.py``), case for case the
JAX package's tests/test_publisher.py over the port's fleet checkpoints
(an insurance fleet of 3 tenants at its own widths).

Publisher edge cases are exercised through ``poll_once()`` with a
recording ``deploy_fn`` — deterministic, no control plane, no
subprocesses: a torn MANIFEST mid-write is WAITED OUT while newest
(and rejected once superseded), a checkpoint that vanishes between
discovery and verification is skipped (gone, not rejected), a
rolled-back step stays sticky until ``republish()`` clears it, and a
restarted publisher resumes from its persisted watermark with NO
re-deploy storm.  The fleet poison forge produces a checkpoint that
PASSES manifest verification and fails only the finite-params probe —
exactly the gap the publisher exists to close."""

import os

import pytest
import torch

from gan_deeplearning4j_tpu.serve.publisher import (
    finite_params_probe as finite_params_probe_jax,
)
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as M
from gan_deeplearning4j_tpu_torch.serve import publisher as publisher_mod
from gan_deeplearning4j_tpu_torch.serve.publisher import (
    CheckpointPublisher,
    finite_params_probe,
)
from gan_deeplearning4j_tpu_torch.telemetry.exporter import MetricsRegistry
from gan_deeplearning4j_tpu_torch.testing import chaos
from gan_deeplearning4j_tpu_torch.train import fused_step as fused_lib
from gan_deeplearning4j_tpu_torch.train.fleet import (
    FleetCheckpointer,
    replicate_state,
    slice_tenant,
)


@pytest.fixture(scope="module")
def fleet_state():
    cfg = M.InsuranceConfig()
    dis = M.build_discriminator(cfg, device="cpu")
    graphs = (dis, M.build_generator(cfg, device="cpu"),
              M.build_gan(cfg, device="cpu"), M.build_classifier(dis, cfg))
    return replicate_state(fused_lib.state_from_graphs(*graphs), 3)


class _RecordingDeploy:
    """deploy_fn stub: records (step, directory) and answers from a
    per-step script (default "promoted")."""

    def __init__(self, script=None):
        self.calls = []
        self.script = dict(script or {})

    def __call__(self, directory, step):
        self.calls.append(int(step))
        outcome = self.script.get(int(step), "promoted")
        if isinstance(outcome, list):
            return outcome.pop(0) if outcome else "promoted"
        return outcome


# -- probe + poison forge ------------------------------------------------------


def test_finite_params_probe_clean_and_poisoned(tmp_path, fleet_state):
    d = str(tmp_path)
    ck = FleetCheckpointer(d, keep=8)
    ck.save(1, fleet_state)
    assert finite_params_probe(os.path.join(d, "ckpt_1")) is None

    bad = chaos.poison_fleet_checkpoint_dir(d, tenant=1)
    assert bad == 2
    # the forge rides the REAL save path: manifest verification passes
    assert ck.verify(bad)
    reason = finite_params_probe(os.path.join(d, f"ckpt_{bad}"))
    assert reason is not None and "non-finite" in reason
    # the JAX package's probe reads the port's forgery the same way
    assert finite_params_probe_jax(os.path.join(d, f"ckpt_{bad}")) == reason
    assert finite_params_probe_jax(os.path.join(d, "ckpt_1")) is None

    # only the targeted tenant's generator slice is poisoned
    _, state, _ = ck.restore(step=bad)
    for t, finite in ((1, False), (0, True), (2, True)):
        gen = slice_tenant(state, t).gen_params
        assert all(bool(torch.isfinite(v).all()) == finite
                   for lp in gen.values() for v in lp.values()), t
        # nothing but the generator is touched
        assert all(bool(torch.isfinite(v).all())
                   for lp in slice_tenant(state, t).dis_params.values()
                   for v in lp.values())

    with pytest.raises(FileNotFoundError):
        finite_params_probe(os.path.join(d, "ckpt_404"))


def test_publisher_promotes_then_rejects_poison(tmp_path, fleet_state):
    d = str(tmp_path)
    ck = FleetCheckpointer(d, keep=8)
    ck.save(3, fleet_state)
    ck.save(7, fleet_state)
    deploy = _RecordingDeploy()
    pub = CheckpointPublisher(d, deploy_fn=deploy, stale_after_s=1e9)
    pub.poll_once()
    assert deploy.calls == [3, 7]  # every verified checkpoint, in order

    bad = chaos.poison_fleet_checkpoint_dir(d, tenant=0)
    pub.poll_once()
    rep = pub.report()
    assert deploy.calls == [3, 7]  # the poison NEVER reached deploy
    assert rep["rejected_total"] == 1 and rep["last_step"] == 7
    assert bad not in rep["promoted_steps"]
    assert rep["ok"] is True  # rejection is the pipeline WORKING


# -- torn manifest mid-write ---------------------------------------------------


def test_torn_manifest_waited_out_then_rejected(tmp_path, fleet_state):
    d = str(tmp_path)
    ck = FleetCheckpointer(d, keep=8)
    ck.save(1, fleet_state)
    ck.save(2, fleet_state)
    # tear the NEWEST checkpoint's manifest mid-write
    manifest = os.path.join(d, "ckpt_2", "MANIFEST.json")
    with open(manifest) as f:
        torn = f.read()[: len(f.read()) // 2 or 8]
    with open(manifest, "w") as f:
        f.write(torn[:20])

    deploy = _RecordingDeploy()
    pub = CheckpointPublisher(d, deploy_fn=deploy)
    pub.poll_once()  # must not crash, must not deploy the torn one
    rep = pub.report()
    assert deploy.calls == [1]
    # newest-and-unverified = "maybe still being written": waited, NOT
    # rejected — a publisher racing the trainer's rename must not burn
    # the step
    assert rep["rejected_total"] == 0 and rep["last_step"] == 1

    # a NEWER verified checkpoint lands: the torn one is now provably
    # dead (the trainer moved past it) -> rejected, newest promoted
    ck.save(5, fleet_state)
    pub.poll_once()
    rep = pub.report()
    assert deploy.calls == [1, 5]
    assert rep["rejected_total"] == 1 and rep["last_step"] == 5


def test_checkpoint_deleted_between_discovery_and_verify(
        tmp_path, fleet_state, monkeypatch):
    d = str(tmp_path)
    FleetCheckpointer(d, keep=8).save(1, fleet_state)

    from gan_deeplearning4j_tpu_torch.checkpoint import (
        checkpointer as ckpt_mod,
    )

    real_ck = ckpt_mod.TrainCheckpointer

    class PhantomSteps:
        """steps() advertises a checkpoint whose directory is already
        gone — the keep-rotation race, pinned deterministic."""

        def __init__(self, directory, **kw):
            self._inner = real_ck(directory, **kw)

        def steps(self):
            return self._inner.steps() + [9]

        def __getattr__(self, name):
            return getattr(self._inner, name)

    # the publisher resolves TrainCheckpointer lazily per poll
    monkeypatch.setattr(ckpt_mod, "TrainCheckpointer", PhantomSteps)
    deploy = _RecordingDeploy()
    pub = CheckpointPublisher(d, deploy_fn=deploy)
    pub.poll_once()
    rep = pub.report()
    assert deploy.calls == [1]
    # gone is gone: skipped, NOT counted as a rejection (pruning is
    # routine; rejection is an alarm)
    assert rep["rejected_total"] == 0
    assert rep["last_step"] == 1 and rep["ok"] is True
    # and the phantom is remembered: no rescan churn
    pub.poll_once()
    assert deploy.calls == [1]


# -- rollback stickiness + republish ------------------------------------------


def test_rollback_then_republish_same_step(tmp_path, fleet_state):
    d = str(tmp_path)
    FleetCheckpointer(d, keep=8).save(4, fleet_state)
    deploy = _RecordingDeploy(script={4: ["rolled_back", "promoted"]})
    pub = CheckpointPublisher(d, deploy_fn=deploy)
    pub.poll_once()
    rep = pub.report()
    assert deploy.calls == [4] and rep["rollback_total"] == 1
    assert rep["last_step"] == 0

    # sticky: the canary already proved this artifact dirty once —
    # re-polling must NOT redeploy it
    pub.poll_once()
    assert deploy.calls == [4]

    # the operator overrides (e.g. the rollback was an env flake)
    pub.republish(4)
    pub.poll_once()
    assert deploy.calls == [4, 4]
    assert pub.report()["last_step"] == 4


def test_environmental_rollback_retries_not_sticky(tmp_path,
                                                   fleet_state):
    """A canary that DIED mid-hold (chaos killed the replica) says
    nothing about the artifact: the publisher must retry the step once
    the mesh heals, not sticky it — only SLO-refuting rollbacks are
    verdicts about the weights."""
    d = str(tmp_path)
    FleetCheckpointer(d, keep=8).save(4, fleet_state)

    class FakeControlPlane:
        def __init__(self):
            self.deploys = 0
            # first attempt: canary murdered mid-hold; second: clean
            self.status_script = [
                {"state": "rolled_back", "environmental": True,
                 "reason": "canary replica process died mid-hold"},
                {"state": "promoted"},
            ]

        def deploy(self, directory, step=None):
            self.deploys += 1

        def deployment_status(self):
            return self.status_script[min(self.deploys - 1,
                                          len(self.status_script) - 1)]

    cp = FakeControlPlane()
    pub = CheckpointPublisher(d, controlplane=cp, deploy_timeout_s=5.0)
    pub.poll_once()  # environmental rollback -> transient, no verdict
    rep = pub.report()
    assert rep["last_step"] == 0 and rep["rollback_total"] == 0
    pub.poll_once()  # mesh healed: the SAME step deploys again
    rep = pub.report()
    assert cp.deploys == 2
    assert rep["last_step"] == 4 and rep["promoted_steps"] == [4]


# -- restart resume: no re-deploy storm ---------------------------------------


def test_restart_resumes_from_persisted_watermark(tmp_path,
                                                  fleet_state):
    d = str(tmp_path)
    ck = FleetCheckpointer(d, keep=8)
    ck.save(1, fleet_state)
    ck.save(2, fleet_state)
    deploy = _RecordingDeploy()
    pub = CheckpointPublisher(d, deploy_fn=deploy)
    pub.poll_once()
    assert deploy.calls == [1, 2]
    assert os.path.exists(os.path.join(d, publisher_mod.STATE_NAME))

    # a fresh publisher (restart) over the same directory: nothing new
    # -> ZERO deploys, watermark restored from PUBLISHED.json
    deploy2 = _RecordingDeploy()
    pub2 = CheckpointPublisher(d, deploy_fn=deploy2)
    pub2.poll_once()
    assert deploy2.calls == []
    assert pub2.report()["last_step"] == 2

    # new work after the restart publishes incrementally
    ck.save(6, fleet_state)
    pub2.poll_once()
    assert deploy2.calls == [6]


def test_publisher_thread_and_stale_flag(tmp_path, fleet_state):
    d = str(tmp_path)
    FleetCheckpointer(d, keep=8).save(1, fleet_state)
    deploy = _RecordingDeploy()
    import time as _time

    with CheckpointPublisher(d, deploy_fn=deploy, poll_s=0.05,
                             stale_after_s=0.2) as pub:
        deadline = _time.monotonic() + 10.0
        while not deploy.calls and _time.monotonic() < deadline:
            _time.sleep(0.02)
        assert deploy.calls == [1]
        assert pub.report()["stale"] is False
        deadline = _time.monotonic() + 10.0
        while (not pub.report()["stale"]
               and _time.monotonic() < deadline):
            _time.sleep(0.05)
        # trainer silent past the budget: stale, but still ok — the
        # graceful-degradation flag, not an alarm
        rep = pub.report()
        assert rep["stale"] is True and rep["ok"] is True


# -- exporter surface ----------------------------------------------------------


def test_exporter_publication_surface(tmp_path, fleet_state):
    reg = MetricsRegistry()
    body = reg.render()
    for series in ("gan4j_publish_rejected_total",
                   "gan4j_publish_promoted_total",
                   "gan4j_publish_last_step",
                   "gan4j_publish_age_seconds"):
        assert f"{series} 0" in body, series
    doc = reg.health()
    assert doc["publication"] == {"last_step": 0, "age_seconds": 0.0,
                                  "stale": False, "ok": True}
    assert doc["serving_stale"] is False

    d = str(tmp_path)
    FleetCheckpointer(d, keep=8).save(11, fleet_state)
    pub = CheckpointPublisher(d, deploy_fn=_RecordingDeploy(),
                              stale_after_s=0.0)
    pub.poll_once()
    reg.observe_publication(pub.report)
    body = reg.render()
    assert "gan4j_publish_last_step 11" in body
    assert "gan4j_publish_promoted_total 1" in body
    doc = reg.health()
    assert doc["publication"]["last_step"] == 11
    # stale_after_s=0: promoted but instantly stale -> the top-level
    # mirror flips while the process keeps serving
    assert doc["publication"]["stale"] is True
    assert doc["serving_stale"] is True
