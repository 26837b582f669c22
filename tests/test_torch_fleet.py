"""The port's fleet (``train/fleet.py``) on the CPU, held against the JAX
package's: the tenant-batched plain ``bn_act`` against ``jax.vmap`` of the
Pallas kernel in interpret mode; the fleet step against ``make_fleet_step``
from the same params (through ``interop``) with the JAX package's latent
draws injected; each lane against the port's single-tenant protocol step;
the step's plain kernel calls at two fleet sizes; the router byte for byte;
fleet checkpoints across the packages bit for bit; and the supervised
trainer.  Insurance model at its own widths, 4 tenants, batch 8."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.models import mlpgan_insurance as MJ
from gan_deeplearning4j_tpu.ops.pallas.bn_act import (
    fused_bn_act_train as bn_act_jax,
)
from gan_deeplearning4j_tpu.train import fleet as FJ
from gan_deeplearning4j_tpu.train import fused_step as SJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MT
from gan_deeplearning4j_tpu_torch.ops import cuda as kernels
from gan_deeplearning4j_tpu_torch.ops.cuda import bn_act as bn2d
from gan_deeplearning4j_tpu_torch.optim import updater as updater_mod
from gan_deeplearning4j_tpu_torch.train import fleet as FL
from gan_deeplearning4j_tpu_torch.train import fused_step as FT

N = 4
B = 8
ROWS = 24  # a tenant's table: three batches
# (loss relative, param absolute, cache relative to the leaf's max + eps):
# one step binds as tests/test_torch_insurance.py's one step; a K-step call
# or a later step as its later steps
FIRST = (1e-5, 2e-5, 2e-3)
LATER = (1e-3, 4e-4, 5e-2)
MAPS_J = (MJ.DIS_TO_GAN, MJ.GAN_TO_GEN, MJ.DIS_TO_CLASSIFIER)
MAPS_T = (MT.DIS_TO_GAN, MT.GAN_TO_GEN, MT.DIS_TO_CLASSIFIER)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's CPU ops on one thread while this module runs (the tier-1
    lane runs six test processes at once; see tests/test_torch_steps.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_graphs():
    dis = MJ.build_discriminator()
    return (dis, MJ.build_generator(), MJ.build_gan(),
            MJ.build_classifier(dis))


def _torch_graphs():
    dis = MT.build_discriminator(device="cpu")
    return (dis, MT.build_generator(device="cpu"), MT.build_gan(device="cpu"),
            MT.build_classifier(dis))


@pytest.fixture(scope="module")
def graphs():
    return _jax_graphs(), _torch_graphs()


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _state_to_torch(state_j) -> FT.ProtocolState:
    """A JAX (fleet) ProtocolState as the port's, leaf for leaf."""
    def tree(t):
        return ({k: tree(v) for k, v in t.items()} if isinstance(t, dict)
                else torch.from_numpy(np.array(t)))

    return FT.ProtocolState(
        *(tree(getattr(state_j, f)) for f in FT.TREES),
        torch.from_numpy(np.array(state_j.it).astype(np.int64)),
        None if state_j.ema_gen is None else tree(state_j.ema_gen))


def _trees_np(state):
    """{field: numpy tree} of a JAX or a port state (the EMA when on)."""
    conv = (interop.opt_state_to_numpy if isinstance(state.it, torch.Tensor)
            else _np)
    return {f: conv(getattr(state, f)) for f in FT.TREES + ("ema_gen",)
            if getattr(state, f) is not None}


def _worst(ref, got, kind: str) -> float:
    """Max over every leaf of every tree: "param" absolute, "cache" over
    the leaf's largest |ref| plus RmsProp's eps."""
    worst = 0.0
    for f in ref:
        if f.endswith("_opt") != (kind == "cache"):
            continue
        for a, b in zip(jax.tree.leaves(ref[f]), jax.tree.leaves(got[f])):
            if not np.size(a):
                continue
            d = float(np.abs(np.asarray(b) - np.asarray(a)).max())
            if kind == "cache":
                d /= float(np.abs(a).max()) + 1e-8
            worst = max(worst, d)
    return worst


def _data(seed: int, shared: bool):
    rng = np.random.RandomState(seed)
    shape = (ROWS,) if shared else (N, ROWS)
    feats = rng.rand(*shape, 12).astype(np.float32)
    labels = (rng.rand(*shape, 1) < 0.5).astype(np.float32)
    ones = np.ones((B, 1), np.float32)
    y_real = ones + (0.05 * rng.randn(B, 1)).astype(np.float32)
    y_fake = (0.05 * rng.randn(B, 1)).astype(np.float32)
    return feats, labels, y_real, y_fake, ones


def _jax_draws(zks, its, k: int):
    """The JAX fleet's latents for K steps from per-tenant counters ``its``:
    tenant i's z1 under fold_in(zks[i], 2*it), z2 under 2*it + 1 ->
    ([K, N, B, 2], [K, N, B, 2])."""
    def draw(i, s, j):
        return np.array(jax.random.uniform(
            jax.random.fold_in(zks[i], 2 * (int(its[i]) + s) + j), (B, 2),
            minval=-1.0, maxval=1.0))

    return tuple(np.stack([np.stack([draw(i, s, j) for i in range(N)])
                           for s in range(k)]) for j in (0, 1))


# -- the tenant-batched bn_act ------------------------------------------------

@pytest.mark.parametrize("shape,act", [((4, 16, 12), "identity"),
                                       ((4, 32, 12), "elu"),
                                       ((4, 16, 2), "tanh"),
                                       ((4, 16, 100), "identity")])
def test_tenant_bn_act_plain_matches_vmapped_pallas(shape, act):
    """y, mean, var and the gradients of x, gamma, beta against ``jax.vmap``
    of the Pallas kernel in interpret mode, at the fleet step's four BN
    shapes (batch 16).  Tolerances as tests/test_torch_kernels.py's 2-D
    bn_act: 1e-5 on values, 1e-4 on gradients."""
    n, b, f = shape
    rng = np.random.RandomState(b * 7 + f)
    x = (rng.randn(n, b, f) * 2 + 1).astype(np.float32)
    gamma = (rng.rand(n, f) + 0.5).astype(np.float32)
    beta = rng.randn(n, f).astype(np.float32)
    gy = rng.randn(n, b, f).astype(np.float32)
    gm = rng.randn(n, f).astype(np.float32)
    gv = rng.randn(n, f).astype(np.float32)

    def f_jax(a, g, bt):
        return jax.vmap(lambda a1, g1, b1: bn_act_jax(a1, g1, b1, 1e-5, act,
                                                      True))(a, g, bt)

    outs_j, vjp = jax.vjp(f_jax, *map(jnp.asarray, (x, gamma, beta)))
    grads_j = vjp(tuple(map(jnp.asarray, (gy, gm, gv))))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, gamma, beta)]
    outs_t = kernels.fused_bn_act_train_tenants(*leaves, 1e-5, act)
    grads_t = torch.autograd.grad(outs_t, leaves,
                                  tuple(map(torch.from_numpy, (gy, gm, gv))))
    for a, b_ in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b_),
                                   rtol=1e-5, atol=1e-5)
    for a, b_ in zip(grads_t, grads_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-4,
                                   atol=1e-4)
    # each tenant is the 2-D plain version on its own rows
    for i in range(n):
        for a, b_ in zip(outs_t, bn2d.bn_act_plain(*(torch.from_numpy(v[i])
                                                     for v in (x, gamma, beta)),
                                                   1e-5, act)):
            np.testing.assert_allclose(a[i].detach().numpy(), b_.numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_tenant_bn_act_checks_its_inputs_and_plans():
    x = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError, match=r"\[N, B, F\]"):
        kernels.fused_bn_act_train_tenants(torch.zeros(4, 3), torch.ones(2, 3),
                                           torch.zeros(2, 3))
    with pytest.raises(ValueError, match="gamma"):
        kernels.fused_bn_act_train_tenants(x, torch.ones(3), torch.zeros(2, 3))
    with pytest.raises(TypeError):
        kernels.fused_bn_act_train_tenants(x.double(), torch.ones(2, 3),
                                           torch.zeros(2, 3))
    # the plan: stages of whole tenants, about two stages an SM, each
    # (tenant, column) pair R threads in whole warps, a persistent grid of
    # the stages or of whole SMs; a tenant whose slab does not fit shared
    # memory is refused
    p = bn2d.tenant_plan(1024, 16, 12, sms=132)
    assert (p.per_stage, p.split, p.threads) == (4, 4, 192)
    assert (p.stages, p.grid) == (256, 256)
    assert p.smem_bytes == 4 * (4 * 16 * 12 + 4) and p.ring == 1
    p = bn2d.tenant_plan(4096, 16, 100, sms=132)
    assert (p.per_stage, p.split, p.threads, p.ring) == (5, 1, 512, 2)
    assert (p.stages, p.grid, p.blocks_per_sm) == (820, 396, 3)
    assert p.smem_bytes == 2 * 4 * (5 * 16 * 100 + 4) <= bn2d.MAX_DYNAMIC_SMEM
    p = bn2d.tenant_plan(1, 200, 200, sms=132)
    assert (p.per_stage, p.smem_bytes) == (1, 4 * (200 * 200 + 4))
    with pytest.raises(ValueError, match="shared memory"):
        bn2d.tenant_plan(1, 200, 6272, sms=132)
    with pytest.raises(ValueError, match="shared memory"):
        bn2d.tenant_plan(1, 2, 40_000)
    kernels.reset_launch_counts()
    kernels.fused_bn_act_train_tenants(x, torch.ones(2, 3), torch.zeros(2, 3))
    assert kernels.launch_counts()["bn_act_tenants"] == 0  # the CPU: plain


# -- the fleet step against make_fleet_step -----------------------------------

CASES = {
    # name: (K, per_tenant_data, masked, ema_decay)
    "k1_tables": (1, True, False, 0.0),
    "k3_shared": (3, False, False, 0.0),
    "masked": (1, True, True, 0.0),
    "k2_ema": (2, True, False, 0.9),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_step_matches_jax(graphs, case):
    """One call of the port's fleet step against the JAX ``make_fleet_step``
    from the same stacked start state, tables, targets and the JAX
    package's own latents (per tenant: its table, its latents).  Bands:
    FIRST for a one-step call, LATER for a K-step call
    (tests/test_torch_insurance.py's step one and later steps); a
    masked-off lane bit-identical to its input, ``it`` included."""
    k, ptd, masked, ema = CASES[case]
    gj, gt = graphs
    feats, labels, y_real, y_fake, ones = _data(len(case), not ptd)
    base = SJ.state_from_graphs(*gj, ema=bool(ema))
    state_j = FJ.replicate_state(base, N)
    zks = FJ.tenant_keys(jax.random.key(3), N)
    rks = FJ.tenant_keys(jax.random.key(4), N)
    j_args = tuple(map(jnp.asarray, (feats, labels)))
    t_args = tuple(map(torch.from_numpy, (feats, labels, y_real, y_fake,
                                          ones)))
    start = _state_to_torch(state_j)
    mask = np.array([True, False, True, True])
    stepj = FJ.make_fleet_step(*gj, *MAPS_J, z_size=2, num_features=12,
                               per_tenant_data=ptd, donate=False,
                               data_on_device=True, steps_per_call=k,
                               ema_decay=ema, masked=masked)
    extra_j = (jnp.asarray(mask),) if masked else ()
    new_j, losses_j = stepj(state_j, *j_args, zks, rks, *extra_j,
                            *map(jnp.asarray, (y_real, y_fake, ones)))
    z1, z2 = _jax_draws(zks, np.array(state_j.it), k)
    stept = FL.make_fleet_step(*gt, *MAPS_T, z_size=2, num_features=12,
                               per_tenant_data=ptd, steps_per_call=k,
                               ema_decay=ema, masked=masked)
    extra_t = (torch.from_numpy(mask),) if masked else ()
    if k == 1:
        z1, z2 = z1[0], z2[0]
    new_t, losses_t = stept(FT.clone_state(start), *t_args, *extra_t,
                            z1=torch.from_numpy(z1), z2=torch.from_numpy(z2))
    band = FIRST if k == 1 else LATER
    for lj, lt in zip(losses_j, losses_t):
        lj = np.asarray(lj)
        lt = lt.numpy() if k == 1 else lt.numpy().T  # [K, N] -> [N, K]
        np.testing.assert_allclose(lt, lj, rtol=band[0])
    ref, got = _trees_np(new_j), _trees_np(new_t)
    assert ref.keys() == got.keys()
    assert _worst(ref, got, "param") <= band[1]
    assert _worst(ref, got, "cache") <= band[2]
    np.testing.assert_array_equal(new_t.it.numpy(), np.array(new_j.it))
    if masked:
        off = FL.slice_tenant(new_t, 1)
        same = FL.slice_tenant(start, 1)
        for a, b_ in zip(FT._leaves(off).values(), FT._leaves(same).values()):
            assert torch.equal(a, b_)


def test_lanes_match_single_tenant_steps(graphs):
    """Each lane of a 2-step fleet call against the port's single-tenant
    protocol step on that tenant's slice, table and latents, within FIRST:
    1e-5 relative on the losses, 2e-5 absolute on the params (the batched products and the
    moments over dim 1 round in another order than the 2-D ops, and
    RmsProp at decay 1e-8 moves an element whose gradient sits near 0 by
    up to lr / sqrt(eps) times that rounding; tests/test_torch_insurance.py
    PARAM_TOL)."""
    _, gt = graphs
    feats, labels, y_real, y_fake, ones = _data(11, False)
    t = [torch.from_numpy(a) for a in (feats, labels, y_real, y_fake, ones)]
    rng = np.random.RandomState(12)
    z1, z2 = (torch.from_numpy(rng.uniform(-1, 1, (2, N, B, 2)).astype(
        np.float32)) for _ in range(2))
    start = FL.replicate_state(FT.state_from_graphs(*gt), N)
    fleet = FL.make_fleet_step(*gt, *MAPS_T, z_size=2, num_features=12,
                               per_tenant_data=True, steps_per_call=2)
    new, losses = fleet(FT.clone_state(start), *t, z1=z1, z2=z2)
    single = FT.make_protocol_step(*gt, *MAPS_T, z_size=2, num_features=12,
                                   steps_per_call=2)
    for i in range(N):
        s1, l1 = single(FT.clone_state(FL.slice_tenant(start, i)), t[0][i],
                        t[1][i], *t[2:], z1=z1[:, i], z2=z2[:, i])
        for a, b_ in zip(losses, l1):
            np.testing.assert_allclose(a[:, i].numpy(), b_.numpy(),
                                       rtol=FIRST[0])
        lane = FL.slice_tenant(new, i)
        assert int(lane.it) == int(s1.it) == 2
        for f in FT.TREES:
            for key, a in FT._tree_leaves(getattr(lane, f), ()).items():
                b_ = FT._tree_leaves(getattr(s1, f), ())[key]
                assert float((a - b_).abs().max()) <= FIRST[1], (f, key)


def test_plain_kernel_calls_do_not_depend_on_n(graphs, monkeypatch):
    """A fleet step calls the tenant-batched ``bn_act`` 4 times and the
    multi-leaf RmsProp chain 3 times (one per graph update), the same at
    N = 4 and N = 64: one call for every tenant, never a loop over them."""
    _, gt = graphs
    calls = {"bn": 0, "chain": 0}
    bn, chain = FL.fused_bn_act_train_tenants, updater_mod.fused_rmsprop_chains

    def count_bn(*a, **kw):
        calls["bn"] += 1
        return bn(*a, **kw)

    def count_chain(*a, **kw):
        calls["chain"] += 1
        return chain(*a, **kw)

    monkeypatch.setattr(FL, "fused_bn_act_train_tenants", count_bn)
    monkeypatch.setattr(updater_mod, "fused_rmsprop_chains", count_chain)
    step = FL.make_fleet_step(*gt, *MAPS_T, z_size=2, num_features=12)
    seen = []
    for n in (4, 64):
        feats, labels, y_real, y_fake, ones = _data(5, True)
        state = FL.replicate_state(FT.state_from_graphs(*gt), n)
        calls.update(bn=0, chain=0)
        step(state, *map(torch.from_numpy, (feats, labels, y_real, y_fake,
                                             ones)),
             z_gen=torch.Generator().manual_seed(n))
        seen.append(dict(calls))
    assert seen == [{"bn": 4, "chain": 3}] * 2


def test_graph_body_keys_the_fleet_ring_on_tenant_0(graphs):
    """``graph_body`` (what ``graphed_fleet_step``'s CUDA graph records) on
    the CPU with a fleet state: the ring counter, started as the graph
    starts it at the first of the [N] step counters, keys the ring row,
    which holds (d, g, clf) for each tenant in turn; every lane advances.
    Bitwise: both runs are the same CPU ops from one start."""
    _, gt = graphs
    feats, labels, y_real, y_fake, ones = _data(5, False)
    args = tuple(map(torch.from_numpy, (feats, labels, y_real, y_fake, ones)))
    start = FL.replicate_state(FT.state_from_graphs(*gt), N)
    start = start._replace(it=torch.full_like(start.it, 2))
    step = FL.make_fleet_step(*gt, *MAPS_T, z_size=2, num_features=12,
                              per_tenant_data=True)
    _, losses = step(FT.clone_state(start), *args,
                     z_gen=torch.Generator().manual_seed(3))
    state, ring = FT.clone_state(start), torch.zeros((4, 3 * N))
    counter = FT.step_counter(state).clone()
    FT.graph_body(step, args, torch.Generator().manual_seed(3), 4, state,
                  ring, counter)
    assert int(FT.step_counter(start)) == 2 and int(counter) == 3
    assert torch.equal(ring[2], torch.stack(losses, -1).reshape(-1))
    assert not ring[[0, 1, 3]].any()
    assert state.it.tolist() == [3] * N


def test_fleet_step_refuses_what_it_does_not_port(graphs):
    _, gt = graphs
    from gan_deeplearning4j_tpu_torch.runtime import backend

    with backend.configured(compute_bf16=True):
        with pytest.raises(NotImplementedError, match="item 9"):
            FL.make_fleet_step(*gt, *MAPS_T, z_size=2, num_features=12)
    masked = FL.make_fleet_step(*gt, *MAPS_T, z_size=2, num_features=12,
                                masked=True)
    feats, labels, y_real, y_fake, ones = _data(1, True)
    with pytest.raises(ValueError, match="mask"):
        masked(FL.replicate_state(FT.state_from_graphs(*gt), 2),
               *map(torch.from_numpy, (feats, labels, y_real, y_fake, ones)),
               z_gen=torch.Generator())
    state = FL.replicate_state(FT.state_from_graphs(*gt), 3)
    for bad in (-1, 3):
        with pytest.raises(IndexError):
            FL.slice_tenant(state, bad)
    with pytest.raises(IndexError):
        FL.subset_state(state, [0, -1])


# -- routing --------------------------------------------------------------------

def test_tenant_router_is_byte_equal_to_jax(tmp_path):
    """The port's router against the JAX router on the same rows: the
    tables, each tenant's quarantine file and count, the lifecycle form's
    starved / tripped / throttled / unrouted, and the per-tenant budget
    raising on the same row.  The rows include tolerant-parse ``#CORRUPT#``
    rows (NaN, scenario/trainer_child.py) and an Inf."""
    from gan_deeplearning4j_tpu.data.resilient import (
        DataQuarantineError as QJ,
    )
    from gan_deeplearning4j_tpu_torch.data.resilient import (
        DataQuarantineError as QT,
    )
    from gan_deeplearning4j_tpu_torch.scenario.trainer_child import (
        read_csv_tolerant,
    )

    rows, nt = 44, 4
    rng = np.random.RandomState(2)
    lines = [",".join(f"{v:.6f}" for v in rng.rand(13)) for _ in range(rows)]
    for r in (5, 9, 14):
        lines[r] = "#CORRUPT#," + lines[r]
    csv = tmp_path / "feed.csv"
    csv.write_text("\n".join(lines) + "\n")
    data = read_csv_tolerant(str(csv), 13)
    feats, labels = data[:, :-1].copy(), data[:, -1].copy()
    feats[21, 3] = np.inf  # tenant 1
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    rj = FJ.TenantRouter(str(tmp_path / "j"), nt, budget=3)
    rt = FL.TenantRouter(str(tmp_path / "t"), nt, budget=3)
    fj, lj = rj.route(feats, labels, source="feed.csv")
    ft, lt = rt.route(feats, labels, source="feed.csv")
    assert np.asarray(fj).tobytes() == ft.numpy().tobytes()
    assert np.asarray(lj).tobytes() == lt.numpy().tobytes()
    assert rj.quarantined_total() == rt.quarantined_total() == 4
    for t in range(nt):
        pj = tmp_path / "j" / f"quarantine_tenant{t}.jsonl"
        pt = tmp_path / "t" / f"quarantine_tenant{t}.jsonl"
        assert pj.exists() == pt.exists()
        if pj.exists():
            strip = [{k: v for k, v in json.loads(ln).items() if k != "wall"}
                     for ln in pj.read_text().splitlines()]
            assert strip == [{k: v for k, v in json.loads(ln).items()
                              if k != "wall"}
                             for ln in pt.read_text().splitlines()]
    # the lifecycle form: a sparse live set in a universe of 6 segments,
    # a row quota and no raise on a blown budget
    kw = dict(tenants=[0, 2, 5], num_segments=6, budget=0, quota_rows=6,
              quota_refill_per_s=1e-9, raise_on_budget=False)
    out_j = FJ.TenantRouter(str(tmp_path / "j"), **kw).route_tables(
        feats, labels, 7)
    out_t = FL.TenantRouter(str(tmp_path / "t"), **kw).route_tables(
        feats, labels, 7)
    assert out_j[0].tobytes() == out_t[0].tobytes()
    assert out_j[1].tobytes() == out_t[1].tobytes()
    assert vars(out_j[2]) == vars(out_t[2])
    assert out_t[2].tripped and out_t[2].throttled and out_t[2].unrouted
    # budgets are per tenant: tenant 2 past ITS budget raises in both
    bad = feats.copy()
    for r in (2, 6, 10, 18):
        bad[r, 0] = np.nan
    with pytest.raises(QJ):
        FJ.TenantRouter(str(tmp_path / "j"), nt, budget=3).route(bad, labels)
    with pytest.raises(QT):
        FL.TenantRouter(str(tmp_path / "t"), nt, budget=3).route(bad, labels)


# -- checkpoints ------------------------------------------------------------------

def _diverged_jax_fleet(gj, n: int):
    feats, labels, y_real, y_fake, ones = _data(9, False)
    step = FJ.make_fleet_step(*gj, *MAPS_J, z_size=2, num_features=12,
                              per_tenant_data=True, donate=False,
                              data_on_device=True)
    state = FJ.replicate_state(SJ.state_from_graphs(*gj), n)
    state, _ = step(state, jnp.asarray(feats[:n]), jnp.asarray(labels[:n]),
                    FJ.tenant_keys(jax.random.key(1), n),
                    FJ.tenant_keys(jax.random.key(2), n),
                    *map(jnp.asarray, (y_real, y_fake, ones)))
    return state


def _bitequal(a, b):
    la, lb = jax.tree.leaves(_trees_np(a)), jax.tree.leaves(_trees_np(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(np.asarray(a.it).astype(np.int64),
                          np.asarray(b.it).astype(np.int64))


def test_fleet_checkpoints_cross_the_packages_bitwise(graphs, tmp_path):
    """A fleet checkpoint the JAX package writes restores in the port, and
    the port's in the JAX package, bit for bit: the full fleet, one tenant
    and a subset in the given order; the tenant map resolves ids and a
    disagreeing expectation is refused in both."""
    from gan_deeplearning4j_tpu_torch.checkpoint.checkpointer import (
        CheckpointMeshMismatchError,
    )

    gj, _ = graphs
    state_j = _diverged_jax_fleet(gj, N)
    state_t = _state_to_torch(state_j)
    tmap = {"slots": [7, 3, None, 5], "cohorts": {"7": "a"}}
    FJ.FleetCheckpointer(str(tmp_path / "j")).save(4, state_j,
                                                   tenant_map=tmap)
    FL.FleetCheckpointer(str(tmp_path / "t")).save(4, state_t,
                                                   tenant_map=tmap)
    for writer in ("j", "t"):
        d = str(tmp_path / writer)
        ck_t, ck_j = FL.FleetCheckpointer(d), FJ.FleetCheckpointer(d)
        step, full_t, extra_t = ck_t.restore()
        _, full_j, extra_j = ck_j.restore()
        assert step == 4 and extra_t["fleet_tenants"] == N
        assert extra_t[FL.FleetCheckpointer.MAP_KEY] == json.loads(
            json.dumps(tmap, sort_keys=True))
        _bitequal(full_t, state_j)
        _bitequal(full_j, state_j)
        # ids through the map: 5 is slot 3; (3, 7) is slots (1, 0)
        _, one, _ = ck_t.restore(tenants=5)
        assert one.it.dim() == 0
        _bitequal(one, FJ.slice_tenant(state_j, 3))
        _, sub, _ = ck_t.restore(tenants=(3, 7))
        _bitequal(sub, FJ.subset_state(state_j, (1, 0)))
        with pytest.raises(FL.TenantMappingError):
            ck_t.restore(tenants=4)
        with pytest.raises(FL.TenantMappingError):
            ck_t.restore(expect_map={"slots": [0, 1, 2, 3]})
        with pytest.raises(FJ.TenantMappingError):
            ck_j.restore(expect_map={"slots": [0, 1, 2, 3]})
    # the manifests record the same one-device spec
    spec = [json.loads((tmp_path / w / "ckpt_4" / "MANIFEST.json").read_text())
            ["mesh_spec"] for w in ("j", "t")]
    assert spec[0] == spec[1] == FL.fleet_mesh_spec()
    # a fleet written on another world reshards onto the target mesh,
    # bitwise per tenant (the manifest edited: its check is the files', so
    # the checkpoint still verifies)
    from gan_deeplearning4j_tpu_torch.parallel import fleet as PF

    m = tmp_path / "t" / "ckpt_4" / "MANIFEST.json"
    doc = json.loads(m.read_text())
    doc["mesh_spec"].update(axes={"tenant": 4}, device_count=4)
    m.write_text(json.dumps(doc))
    ck = FL.FleetCheckpointer(str(tmp_path / "t"))
    _, shards, extra = ck.restore(step=4, target_mesh=PF.tenant_mesh(2, "cpu"))
    assert extra["__reshard__"]["from"]["device_count"] == 4
    assert extra["__reshard__"]["to"] == FL.fleet_mesh_spec(
        PF.tenant_mesh(2, "cpu"))
    assert [FL.fleet_size(s) for s in shards] == [2, 2]
    _bitequal(PF.gather_fleet_state(shards), state_j)
    # no target: the plain load (the CPU has no device limit)
    _bitequal(ck.restore(step=4)[1], state_j)
    assert issubclass(CheckpointMeshMismatchError, ValueError)


def test_state_tree_round_trip_keeps_empty_layers(graphs):
    _, gt = graphs
    state = FL.replicate_state(FT.state_from_graphs(*gt, ema=True), 3)
    tree = FL.state_to_tree(state)
    assert tree["dis_params"]["dis_dropout_layer_3"] == {
        "__fleet_empty__": np.zeros((), np.int32)}
    back = FL.state_from_tree(tree)
    assert back.dis_params["dis_dropout_layer_3"] == {}
    assert FT._leaves(back).keys() == FT._leaves(state).keys()
    for a, b_ in zip(FT._leaves(back).values(), FT._leaves(state).values()):
        assert torch.equal(a, b_)
    sub = FL.subset_state(state, [2, 0])
    assert torch.equal(sub.gen_params["gen_batch_1"]["gamma"][0],
                       state.gen_params["gen_batch_1"]["gamma"][2])
    stacked = FL.stack_states([FL.slice_tenant(state, i) for i in (1, 2)])
    assert FL.fleet_size(stacked) == 2


# -- the supervised trainer -----------------------------------------------------

def test_fleet_trainer_smoke(tmp_path):
    """The fleet payload behind the shared shell: runs, serves the fleet
    series on /metrics and the fleet block on /healthz while it runs,
    writes events and cadence checkpoints whose slices restore bit-equal to
    the live state; a resume from them finishes where an uninterrupted run
    ends, bit for bit (the latents' generator state rides the checkpoint).
    A tenant mesh (``n_devices``) trains the same fleet at any size;
    ``sanitize`` is refused, naming its item."""
    rows = 8 * 8
    feats = np.linspace(0.0, 1.0, rows * 12, dtype=np.float32).reshape(rows, 12)
    labels = (np.arange(rows) % 2).astype(np.float32)

    def cfg(path, **kw):
        base = dict(num_tenants=8, num_iterations=6, batch_size=4,
                    res_path=str(path), per_tenant_data=True, print_every=2,
                    checkpoint_every=2, quarantine_budget=4, device="cpu")
        base.update(kw)
        return FL.FleetConfig(**base)

    trainer = FL.FleetTrainer(cfg(tmp_path / "a", metrics_port=0))
    scrapes = {}

    def _log(msg):
        if trainer.metrics_port and "m" not in scrapes:
            base = f"http://127.0.0.1:{trainer.metrics_port}"
            with urllib.request.urlopen(base + "/metrics") as r:
                scrapes["m"] = r.read().decode()
            with urllib.request.urlopen(base + "/healthz") as r:
                scrapes["h"] = json.loads(r.read().decode())

    out = trainer.train(feats, labels, log=_log)
    assert out["steps"] == 6 and out["tenants"] == 8 and not out["graphed"]
    assert out["tenants_steps_per_sec"] > 0
    assert "gan4j_fleet_tenants 8" in scrapes["m"]
    assert scrapes["h"]["fleet"]["tenants"] == 8
    names = [json.loads(ln)["name"] for ln in
             (tmp_path / "a" / "events.jsonl").read_text().splitlines()]
    assert "fleet.start" in names and "fleet.done" in names
    _, one, _ = trainer.checkpointer.restore(tenants=3)
    for a, b_ in zip(FT._leaves(one).values(),
                     FT._leaves(FL.slice_tenant(trainer.state, 3)).values()):
        assert torch.equal(a, b_)
    assert trainer.checkpointer.steps() == [2, 4, 6]

    # a run cut at 4 and resumed to 6 ends bitwise where the whole run did
    cut = FL.FleetTrainer(cfg(tmp_path / "b", num_iterations=4))
    cut.train(feats, labels, log=None)
    resumed = FL.FleetTrainer(cfg(tmp_path / "b", resume=True))
    assert resumed.train(feats, labels, log=None)["steps"] == 6
    for a, b_ in zip(FT._leaves(resumed.state).values(),
                     FT._leaves(trainer.state).values()):
        assert torch.equal(a, b_)
    for a, b_ in zip(resumed.last_losses, trainer.last_losses):
        assert np.array_equal(a, b_)

    # a tenant mesh of 2 and of 4 shards (parallel/fleet.py): the latents
    # are keyed on global tenant ids, so both runs end bitwise equal; 8
    # tenants do not divide a mesh of 3
    meshed = []
    for nd in (2, 4):
        t = FL.FleetTrainer(cfg(tmp_path / f"mesh{nd}", n_devices=nd))
        assert t.train(feats, labels, log=None)["devices"] == nd
        assert [FL.fleet_size(s) for s in t.state] == [8 // nd] * nd
        meshed.append(t)
    for a, b_ in zip(meshed[0].last_losses, meshed[1].last_losses):
        assert np.array_equal(a, b_)
    with pytest.raises(ValueError, match="does not divide"):
        FL.FleetTrainer(cfg(tmp_path / "c", n_devices=3))
    with pytest.raises(NotImplementedError, match="11.4"):
        FL.FleetTrainer(cfg(tmp_path / "c", sanitize=True)).train(
            feats, labels, log=None)
