"""The tenant lifecycle (``train/lifecycle.py``) and its poisoners
(``testing/chaos.py``) on the CPU, held against the JAX package's
``train/lifecycle.py``: ``bucket_for``, ``FleetHealthSentinel`` and the
tenant map byte for byte; a two-cohort ``FleetManager`` through an onboard,
a bucket hop and an offboard against JAX's ``step_window``, from JAX's init
with JAX's per-tenant draws injected, within ``FLEET_TOL`` (losses 1e-4
relative, params 4e-4 absolute, caches 5e-2 of the leaf's largest:
``chip_smoke.py``'s band for the fleet step); survivors bitwise a control
of the same membership events (and so of the same capacities) through a
quarantine and both poisonings; the per-tenant latents; the supervised
trainer.  Insurance MLP-GANs at their own widths, batch 16."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.train import fleet as FJ
from gan_deeplearning4j_tpu.train import lifecycle as LJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.testing import chaos
from gan_deeplearning4j_tpu_torch.train import fleet as FL
from gan_deeplearning4j_tpu_torch.train import fused_step as FT
from gan_deeplearning4j_tpu_torch.train import lifecycle as LT

B = 16  # the fleet phase's batch, where FLEET_TOL was set
STEPS = 2
SEGMENTS = 8
FLEET_TOL = {"loss": 1e-4, "param": 4e-4, "cache": 5e-2}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _feed(window: int):
    """One window's rows: every segment B clean rows."""
    rng = np.random.RandomState(100 + window)
    return (rng.rand(SEGMENTS * B, 12).astype(np.float32),
            (rng.rand(SEGMENTS * B) < 0.5).astype(np.float32))


# -- the pieces byte for byte ----------------------------------------------------

@pytest.mark.parametrize("buckets", [LT.DEFAULT_TENANT_BUCKETS, (2, 4, 32, 64),
                                     (8, 3, 5)])
def test_bucket_for_is_jaxs(buckets):
    assert LT.DEFAULT_TENANT_BUCKETS == LJ.DEFAULT_TENANT_BUCKETS
    for n in range(0, max(buckets) + 1):
        assert LT.bucket_for(n, buckets) == LJ.bucket_for(n, buckets)
    for mod in (LT, LJ):
        with pytest.raises(ValueError, match="extend LifecycleConfig"):
            mod.bucket_for(max(buckets) + 1, buckets)


def test_the_sentinel_is_jaxs():
    """The same window losses (steady, a blow-up for two windows, NaN)
    give the same trips, tenant by tenant."""
    rng = np.random.RandomState(3)
    got, want = LT.FleetHealthSentinel(), LJ.FleetHealthSentinel()
    trips_t, trips_j = [], []
    for w in range(30):
        for t in range(4):
            d = rng.rand(5) + 0.5
            g = rng.rand(5) + 0.5
            if t == 1 and w in (10, 11, 12):
                d = d * 1e4
            if t == 2 and w == 20:
                g[3] = np.nan
            if t == 3 and w == 15:
                got.forget(3)
                want.forget(3)
            trips_t.append(got.observe(t, d, g))
            trips_j.append(want.observe(t, d, g))
    assert trips_t == trips_j
    assert "divergence" in trips_t and "nan" in trips_t


def test_tenant_specs_and_configs_are_jaxs():
    assert LT.TenantSpec(5, 64, 2).cohort_key == LJ.TenantSpec(
        5, 64, 2).cohort_key == "h64_l2"
    t, j = LT.LifecycleConfig(), LJ.LifecycleConfig()
    for f in (f.name for f in LJ.dataclasses.fields(j)):
        assert getattr(t, f) == getattr(j, f), f


def test_tenant_latents_depend_on_tenant_and_step_only():
    """A lane's draws are a function of (key, tenant id, its step), not of
    its slot, its neighbours or the lane count; U[-1, 1) at 24 bits."""
    tids = torch.tensor([5, -1, 9, 5, 2])
    its = torch.tensor([3, 0, 3, 3, 7])
    z1, z2 = FL.tenant_latents(11, tids, its, B, 2)
    assert z1.shape == z2.shape == (5, B, 2) and z1.dtype == torch.float32
    assert torch.equal(z1[0], z1[3]) and torch.equal(z2[0], z2[3])
    a1, a2 = FL.tenant_latents(11, torch.tensor([5]), torch.tensor([3]), B, 2)
    assert torch.equal(a1[0], z1[0]) and torch.equal(a2[0], z2[0])
    assert not torch.equal(z1[0], z1[2]) and not torch.equal(z1[0], z2[0])
    b1, _ = FL.tenant_latents(11, torch.tensor([5]), torch.tensor([4]), B, 2)
    assert not torch.equal(b1[0], z1[0])
    c1, _ = FL.tenant_latents(12, torch.tensor([5]), torch.tensor([3]), B, 2)
    assert not torch.equal(c1[0], z1[0])
    big, _ = FL.tenant_latents(11, torch.arange(4096), torch.zeros(
        4096, dtype=torch.int64), B, 2)
    assert float(big.min()) >= -1.0 and float(big.max()) < 1.0
    assert abs(float(big.mean())) < 0.01
    assert torch.equal(((big + 1) * 2 ** 23), ((big + 1) * 2 ** 23).round())


# -- the manager against JAX's step_window ----------------------------------------

def _to_torch_state(state_j) -> FT.ProtocolState:
    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.from_numpy(np.array(t)))

    return FT.ProtocolState(
        *(tree(getattr(state_j, f)) for f in FT.TREES),
        torch.from_numpy(np.array(state_j.it).astype(np.int64)), None)


def _jax_latents(z_base):
    """``latent_fn`` for the port: JAX's per-tenant draws, z1 under
    fold_in(fold_in(base, tenant), 2*it), z2 under 2*it + 1; ghost lanes
    (masked) zeros."""
    def fn(cohort, tids, its):
        zs = ([], [])
        for t, it in zip(tids.tolist(), its.tolist()):
            for j in (0, 1):
                if t < 0:
                    zs[j].append(np.zeros((B, 2), np.float32))
                    continue
                zk = jax.random.fold_in(z_base, t)
                zs[j].append(np.array(jax.random.uniform(
                    jax.random.fold_in(zk, 2 * it + j), (B, 2),
                    minval=-1.0, maxval=1.0)))
        return tuple(torch.from_numpy(np.stack(z)) for z in zs)
    return fn


def _script(m, spec_cls, window):
    """The membership events before ``window``: two onboards (the second
    hops h100_l3 from bucket 4 to 8), then an offboard."""
    if window == 1:
        m.onboard(spec_cls(4))
        m.onboard(spec_cls(5))
    if window == 2:
        m.offboard(1)


@pytest.fixture(scope="module")
def both_managers(tmp_path_factory):
    specs = [(0, 100, 3), (1, 100, 3), (2, 100, 3), (3, 64, 2)]
    root = tmp_path_factory.mktemp("lifecycle_parity")
    kw = dict(batch_size=B, buckets=(2, 4, 8), num_segments=SEGMENTS)
    mj = LJ.FleetManager([LJ.TenantSpec(*s) for s in specs],
                         LJ.LifecycleConfig(res_path=str(root / "jax"), **kw))
    mt = LT.FleetManager([LT.TenantSpec(*s) for s in specs],
                         LT.LifecycleConfig(res_path=str(root / "torch"),
                                            device="cpu", **kw))
    # JAX's init, targets and draws in the port
    for key, cohort in mt.cohorts.items():
        cohort.template = _to_torch_state(mj.cohorts[key]._template)
        cohort.state = cohort.blank(cohort.capacity)
    mt.y_real = torch.from_numpy(np.array(mj._y_real))
    mt.y_fake = torch.from_numpy(np.array(mj._y_fake))
    mt.latent_fn = _jax_latents(mj._z_base)
    reports = []
    for w in range(3):
        _script(mj, LJ.TenantSpec, w)
        _script(mt, LT.TenantSpec, w)
        f, lab = _feed(w)
        reports.append((mj.step_window(f, lab, STEPS),
                        mt.step_window(f, lab, STEPS)))
    return mj, mt, reports


def test_step_window_matches_jax(both_managers):
    """Each window's per-tenant losses, and every lane's final state."""
    mj, mt, reports = both_managers
    for rj, rt in reports:
        assert sorted(rj["losses"]) == sorted(rt["losses"])
        for t, lj in rj["losses"].items():
            for k in ("d", "g", "clf"):
                np.testing.assert_allclose(rt["losses"][t][k], lj[k],
                                           rtol=FLEET_TOL["loss"])
    assert mt.cohorts["h100_l3"].capacity == mj.cohorts["h100_l3"].capacity \
        == 8
    for key, cj in mj.cohorts.items():
        ct = mt.cohorts[key]
        assert ct.slots == cj.slots and list(ct.mask) == list(cj.mask)
        host = LJ._np_state(cj.state)
        for slot, t in enumerate(cj.slots):
            if t is None:
                continue
            row_j = LJ._row(host, slot)
            row_t = LT._host_row(ct.state, slot)
            assert int(row_t.it) == int(row_j.it)
            for f in FT.TREES:
                ref = jax.tree.map(np.array, getattr(row_j, f))
                got = interop.opt_state_to_numpy(getattr(row_t, f))
                for (path, a), b in zip(
                        jax.tree_util.tree_leaves_with_path(ref),
                        jax.tree.leaves(got)):
                    if not np.size(a):
                        continue
                    d = float(np.abs(np.asarray(b) - a).max())
                    if f.endswith("_opt"):
                        assert d / (float(np.abs(a).max()) + 1e-8) <= \
                            FLEET_TOL["cache"], (t, f, path)
                    else:
                        assert d <= FLEET_TOL["param"], (t, f, path)


def test_the_tenant_map_and_checkpoints_cross_the_packages(both_managers,
                                                            tmp_path):
    """The cohorts' tenant maps are JAX's byte for byte; a cohort
    checkpoint the port writes restores in the JAX package by tenant id,
    bitwise the port's lane; the offboarded tenant's final checkpoint
    names it."""
    mj, mt, _ = both_managers
    for key, cj in mj.cohorts.items():
        assert json.dumps(mt.cohorts[key].tenant_map(), sort_keys=True) == \
            json.dumps(cj.tenant_map(), sort_keys=True)
    saved = mt.checkpoint_fleet()
    assert set(saved) == {"h100_l3", "h64_l2"}
    ck = FJ.FleetCheckpointer(os.path.dirname(saved["h100_l3"]),
                              sweep_debris=False)
    ct = mt.cohorts["h100_l3"]
    for t in ct.occupied_ids():
        _, row, _ = ck.restore(tenants=t)
        mine = LT._host_row(ct.state, ct.slot_of(t))
        for f in FT.TREES:
            for a, b in zip(jax.tree.leaves(jax.tree.map(np.array,
                                                         getattr(row, f))),
                            jax.tree.leaves(interop.opt_state_to_numpy(
                                getattr(mine, f)))):
                assert np.array_equal(np.asarray(a), np.asarray(b))
    off = FL.FleetCheckpointer(os.path.join(mt.c.res_path, "offboarded",
                                            "tenant1"), sweep_debris=False)
    _, state, extra = off.restore()
    assert extra[FL.FleetCheckpointer.MAP_KEY] == {
        "slots": [1], "cohorts": {"1": "h100_l3"}}
    assert FL.fleet_size(state) == 1


# -- survivors against a control; the poisoners -------------------------------------

def _lifecycle_run(root, poison: bool):
    """Two cohorts (h100_l3: tenants 0-5, h64_l2: 6-7), buckets (2, 4, 8,
    16), 7 windows of 3 steps: a ghost-slot cycle, an onboard hop 8 -> 16,
    an offboard and re-onboard from its checkpoint; with ``poison``, a
    param poison of tenant 1 before window 5 and tenant 3's feed poisoned
    from window 6."""
    specs = ([LT.TenantSpec(i) for i in range(6)]
             + [LT.TenantSpec(i, 64, 2) for i in (6, 7)])
    cfg = LT.LifecycleConfig(batch_size=B, buckets=(2, 4, 8, 16),
                             res_path=str(root), device="cpu",
                             num_segments=16, record_timelines=True)
    m = LT.FleetManager(specs, cfg)
    warmed = m.warmup()
    assert warmed == {"h100_l3": [2, 4, 8, 16], "h64_l2": [2, 4]}

    def feed(w):
        rng = np.random.RandomState(200 + w)
        return (rng.rand(16 * B, 12).astype(np.float32),
                (rng.rand(16 * B) < 0.5).astype(np.float32))

    poisoner = chaos.TenantFeedPoisoner(feed, 3, 16)
    for w in range(7):
        if w == 1:
            m.onboard(LT.TenantSpec(9))
        if w == 2:
            m.offboard(9)
        if w == 3:
            for t in (10, 11, 12):
                m.onboard(LT.TenantSpec(t))
        if w == 4:
            path = m.offboard(2)
            m.onboard(LT.TenantSpec(2),
                      from_checkpoint=os.path.dirname(path))
        if poison and w == 5:
            chaos.poison_tenant_params(m, 1)
        if poison and w == 6:
            poisoner.arm()
        f, lab = poisoner(w)
        m.step_window(f, lab, 3)
    return m


@pytest.fixture(scope="module")
def control_and_chaos(tmp_path_factory):
    return (_lifecycle_run(tmp_path_factory.mktemp("control"), False),
            _lifecycle_run(tmp_path_factory.mktemp("chaos"), True))


def test_survivors_are_bitwise_the_control(control_and_chaos):
    """Every tenant but the two poisoned ones: its per-step losses and its
    final lane bitwise the control's, through the ghost cycle, the hop,
    the re-onboard and the two quarantines; the poisoned tenants' losses
    bitwise the control's up to the window of their poisoning."""
    ctl, run = control_and_chaos
    assert run.cohorts["h100_l3"].capacity == ctl.cohorts[
        "h100_l3"].capacity == 16
    for t, hist in ctl.loss_history.items():
        got = run.loss_history[t]
        n = {1: 5 * 3, 3: 6 * 3}.get(t, len(hist["d"]))
        for k in ("d", "g", "clf"):
            assert got[k][:n] == hist[k][:n], (t, k)
    for key, cc in ctl.cohorts.items():
        cr = run.cohorts[key]
        for t in cc.occupied_ids():
            if t in (1, 3):
                continue
            a = FT._leaves(LT._host_row(cc.state, cc.slot_of(t)))
            b = FT._leaves(LT._host_row(cr.state, cr.slot_of(t)))
            assert all(torch.equal(a[k], b[k]) for k in a), t
    assert ctl.captures_after_warmup == run.captures_after_warmup == 0


def test_the_poisoners_quarantine_exactly_their_tenants(control_and_chaos):
    ctl, run = control_and_chaos
    assert ctl.quarantined == {}
    assert run.quarantined == {1: "nan", 3: "data-quarantine-budget"}
    lines = [json.loads(x) for x in open(os.path.join(
        run.c.res_path, "quarantine_fleet.jsonl"))]
    assert [(x["tenant"], x["reason"]) for x in lines] == [
        (1, "nan"), (3, "data-quarantine-budget")]
    # the quarantined lanes stay in their slots, frozen and masked off
    c = run.cohorts["h100_l3"]
    for t in (1, 3):
        assert t in c.slots and not c.mask[c.slot_of(t)]
    row = LT._host_row(c.state, c.slot_of(1))
    assert all(torch.isnan(t).all() for t in FT._tree_leaves(
        row.dis_params, ()).values())
    rep = run.report()["tenants_detail"]
    assert rep["quarantined"] == [1, 3] and rep["onboarded_total"] == 5
    assert rep["offboarded_total"] == 2 and rep["captures_after_warmup"] == 0


def test_launches_per_step_follow_the_graphs():
    """Four train-mode BNs in the three trained graphs (the classifier's
    frozen input BN runs in inference) at both widths: the fleet phase's
    4 + 4 + 3 a step."""
    for hidden, layers in ((100, 3), (64, 2)):
        cohort = LT.Cohort(f"h{hidden}_l{layers}", hidden, layers,
                           LT.LifecycleConfig(), torch.device("cpu"))
        assert cohort.launches_per_step() == {
            "bn_act_tenants": 4, "bn_act_tenants_bwd": 4, "fused_update": 3}


def test_the_trainer_runs_the_fleet_behind_the_shell(tmp_path):
    """``LifecycleFleetTrainer``: warm-up, the windows, a final cohort
    checkpoint each, the report, the events file."""
    cfg = LT.LifecycleConfig(batch_size=B, buckets=(2, 4),
                             res_path=str(tmp_path), device="cpu",
                             record_timelines=True)
    tr = LT.LifecycleFleetTrainer([LT.TenantSpec(0), LT.TenantSpec(1),
                                   LT.TenantSpec(2, 64, 2)], cfg)
    seen = []
    r = tr.train(lambda w: _feed(w)[:1] + (_feed(w)[1][:SEGMENTS * B],),
                 windows=2, steps_per_window=2,
                 on_warm=lambda m: seen.append(m.warmed),
                 on_window=lambda m, w, rep: seen.append(sorted(rep["losses"])),
                 log=None)
    assert seen == [True, [0, 1, 2], [0, 1, 2]]
    assert r["steps"] == 4 and r["windows"] == 2 and r["tenants"] == 3
    assert sorted(r["timelines"]) == [0, 1, 2]
    assert len(r["timelines"][0]["d"]) == 4
    assert os.path.exists(tmp_path / "events.jsonl")
    assert os.path.isdir(tmp_path / "checkpoints" / "h64_l2")
