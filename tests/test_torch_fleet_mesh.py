"""The fleet on a tenant mesh (``parallel/fleet.py``) on the CPU, held
against itself at world 1 and against the JAX package's
``parallel/fleet.py`` on the 8 CPU devices ``tests/conftest.py`` forces:

* the sharded step at worlds 2 and 4, over 3 steps, bitwise the port's
  unsharded tenant-mesh step (world 1; JAX's
  ``test_sharded_fleet_matches_vmap`` claims bitwise);
* the same step within ``FLEET_TOL`` of JAX's ``make_sharded_fleet_step``
  at the same world, JAX's draws injected;
* the masked (lifecycle) form bitwise the port's unsharded masked step and
  within ``FLEET_TOL`` of JAX's unsharded masked ``vmap`` step (JAX's
  sharded masked step is a red test of its own package);
* ``check_divisible`` refuses a fleet that does not divide the mesh;
* a port checkpoint written at world 2 restores at 1 and at 4, bitwise per
  tenant, and the restored fleet goes on to equal the straight world-2 run;
  a JAX fleet checkpoint written on its 8-device mesh restores at world 4,
  bitwise per tenant.

Insurance model at its own widths, 8 tenants, batch 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fleet import (
    MAPS_J,
    MAPS_T,
    _state_to_torch,
    _trees_np,
    _worst,
)

from gan_deeplearning4j_tpu.models import mlpgan_insurance as MJ
from gan_deeplearning4j_tpu.parallel import fleet as PJ
from gan_deeplearning4j_tpu.train import fleet as FJ
from gan_deeplearning4j_tpu.train import fused_step as SJ
from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as MT
from gan_deeplearning4j_tpu_torch.parallel import fleet as PF
from gan_deeplearning4j_tpu_torch.runtime import prng
from gan_deeplearning4j_tpu_torch.train import fleet as FL
from gan_deeplearning4j_tpu_torch.train import fused_step as FT

N = 8
B = 8
K = 3
# chip_smoke.py's FLEET_TOL: loss relative, param absolute, cache relative
# to the leaf's largest |value| (the bands of a K-step fleet call)
FLEET_TOL = {"loss": 1e-4, "param": 4e-4, "cache": 5e-2}
KEY = prng.stream_seed(23, "fleet-z")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's CPU ops on one thread while this module runs (the tier-1
    lane runs six test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    dj = MJ.build_discriminator()
    dt = MT.build_discriminator(device="cpu")
    return ((dj, MJ.build_generator(), MJ.build_gan(),
             MJ.build_classifier(dj)),
            (dt, MT.build_generator(device="cpu"),
             MT.build_gan(device="cpu"), MT.build_classifier(dt)))


def _tables(seed: int, shared: bool = False):
    rng = np.random.RandomState(seed)
    shape = (24,) if shared else (N, 24)
    feats = rng.rand(*shape, 12).astype(np.float32)
    labels = (rng.rand(*shape, 1) < 0.5).astype(np.float32)
    ones = np.ones((B, 1), np.float32)
    y_real = ones + (0.05 * rng.randn(B, 1)).astype(np.float32)
    y_fake = (0.05 * rng.randn(B, 1)).astype(np.float32)
    return feats, labels, y_real, y_fake, ones


def _start(gt, seed: int = 5):
    """N distinct tenants: a replicated init, each leaf nudged per tenant."""
    state = FL.replicate_state(FT.state_from_graphs(*gt), N)
    g = torch.Generator().manual_seed(seed)

    def nudge(t):
        if t.is_floating_point():
            return t + 1e-2 * torch.randn(t.shape, generator=g)
        return t

    return FL._map_state(nudge, state)


def _sharded(gt, mesh, ptd=True, masked=False, k=K):
    return PF.make_sharded_fleet_step(
        *gt, *MAPS_T, z_size=2, num_features=12, mesh=mesh,
        per_tenant_data=ptd, steps_per_call=k, masked=masked)


def _assert_bitwise(a, b, label):
    la, lb = FT._leaves(a), FT._leaves(b)
    assert la.keys() == lb.keys(), label
    for key in la:
        assert torch.equal(la[key], lb[key]), f"{label}: {key}"
    assert torch.equal(a.it, b.it), label


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("ptd", [True, False], ids=["tables", "shared"])
def test_sharded_step_bitwise_the_unsharded_mesh_step(graphs, world, ptd):
    """3 steps a call on a mesh of ``world`` shards against the same call
    on a mesh of 1: states and losses bit for bit (the latents keyed on
    global tenant ids; no collectives)."""
    _, gt = graphs
    args = tuple(map(torch.from_numpy, _tables(world, shared=not ptd)))
    start = _start(gt)
    one = PF.tenant_mesh(1, "cpu")
    mesh = PF.tenant_mesh(world, "cpu")
    ref, lref = _sharded(gt, one, ptd)(PF.shard_fleet_state(start, one),
                                       *args, key=KEY)
    got, lgot = _sharded(gt, mesh, ptd)(PF.shard_fleet_state(start, mesh),
                                        *args, key=KEY)
    assert len(got) == world
    assert all(FL.fleet_size(s) == N // world for s in got)
    for a, b in zip(lref, lgot):
        assert a.shape == (K, N) and torch.equal(a, b)
    _assert_bitwise(PF.gather_fleet_state(ref), PF.gather_fleet_state(got),
                    f"world {world}")
    # and the plain fleet step over all N with the same draws
    plain = FL.make_fleet_step(*gt, *MAPS_T, z_size=2, num_features=12,
                               per_tenant_data=ptd)
    state = FT.clone_state(start)
    tids = torch.arange(N)
    for k in range(K):
        z1, z2 = FL.tenant_latents(KEY, tids, state.it, B, 2)
        state, losses = plain(state, *args, z1=z1, z2=z2)
        assert torch.equal(losses[0], lgot[0][k])
    _assert_bitwise(state, PF.gather_fleet_state(got), "plain step")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_jax_sharded_step(graphs, cpu_devices, world):
    """The port's sharded step against JAX's ``make_sharded_fleet_step`` on
    a tenant mesh of ``world`` of the 8 CPU devices, 3 steps a call from
    the same start, tables and targets, JAX's draws injected: FLEET_TOL."""
    gj, gt = graphs
    feats, labels, y_real, y_fake, ones = _tables(10 + world)
    state_j = FJ.replicate_state(SJ.state_from_graphs(*gj), N)
    start = _state_to_torch(state_j)
    zks = FJ.tenant_keys(jax.random.key(3), N)
    rks = FJ.tenant_keys(jax.random.key(4), N)
    mesh_j = PJ.tenant_mesh(world)
    step_j = PJ.make_sharded_fleet_step(
        *gj, *MAPS_J, z_size=2, num_features=12, mesh=mesh_j,
        per_tenant_data=True, donate=False, data_on_device=True,
        steps_per_call=K)
    sh = PJ.fleet_sharding(mesh_j)
    new_j, losses_j = step_j(PJ.shard_fleet_state(state_j, mesh_j),
                             jnp.asarray(feats), jnp.asarray(labels),
                             jax.device_put(zks, sh), jax.device_put(rks, sh),
                             *map(jnp.asarray, (y_real, y_fake, ones)))
    z1, z2 = _jax_draws_n(zks, np.array(state_j.it), K)
    mesh = PF.tenant_mesh(world, "cpu")
    got, losses_t = _sharded(gt, mesh)(
        PF.shard_fleet_state(start, mesh),
        *map(torch.from_numpy, (feats, labels, y_real, y_fake, ones)),
        z1=torch.from_numpy(z1), z2=torch.from_numpy(z2))
    for lj, lt in zip(losses_j, losses_t):
        np.testing.assert_allclose(lt.numpy().T, np.asarray(lj),
                                   rtol=FLEET_TOL["loss"])
    ref, out = _trees_np(new_j), _trees_np(PF.gather_fleet_state(got))
    assert _worst(ref, out, "param") <= FLEET_TOL["param"]
    assert _worst(ref, out, "cache") <= FLEET_TOL["cache"]
    np.testing.assert_array_equal(PF.gather_fleet_state(got).it.numpy(),
                                  np.array(new_j.it))


def _jax_draws_n(zks, its, k):
    """``test_torch_fleet._jax_draws`` for N tenants at batch B."""
    def draw(i, s, j):
        return np.array(jax.random.uniform(
            jax.random.fold_in(zks[i], 2 * (int(its[i]) + s) + j), (B, 2),
            minval=-1.0, maxval=1.0))

    return tuple(np.stack([np.stack([draw(i, s, j) for i in range(N)])
                           for s in range(k)]) for j in (0, 1))


def test_masked_sharded_step(graphs):
    """The lifecycle form at world 4: bitwise the port's unsharded masked
    step, the masked-off lanes bit-identical to their input, and within
    FLEET_TOL of JAX's unsharded masked ``vmap`` step."""
    gj, gt = graphs
    feats, labels, y_real, y_fake, ones = _tables(31)
    mask = np.array([True, False, True, True, False, True, True, True])
    state_j = FJ.replicate_state(SJ.state_from_graphs(*gj), N)
    start = _state_to_torch(state_j)
    zks = FJ.tenant_keys(jax.random.key(5), N)
    rks = FJ.tenant_keys(jax.random.key(6), N)
    step_j = FJ.make_fleet_step(*gj, *MAPS_J, z_size=2, num_features=12,
                                per_tenant_data=True, donate=False,
                                data_on_device=True, masked=True)
    new_j, losses_j = step_j(state_j, jnp.asarray(feats),
                             jnp.asarray(labels), zks, rks,
                             jnp.asarray(mask),
                             *map(jnp.asarray, (y_real, y_fake, ones)))
    z1, z2 = (torch.from_numpy(z[0]) for z in
              _jax_draws_n(zks, np.array(state_j.it), 1))
    args = tuple(map(torch.from_numpy, (feats, labels, y_real, y_fake, ones)))
    m = torch.from_numpy(mask)
    plain = FL.make_fleet_step(*gt, *MAPS_T, z_size=2, num_features=12,
                               per_tenant_data=True, masked=True)
    ref, lref = plain(FT.clone_state(start), *args, m, z1=z1, z2=z2)
    mesh = PF.tenant_mesh(4, "cpu")
    got, lgot = _sharded(gt, mesh, masked=True, k=1)(
        PF.shard_fleet_state(start, mesh), *args, m, z1=z1, z2=z2)
    full = PF.gather_fleet_state(got)
    _assert_bitwise(ref, full, "masked world 4")
    for a, b in zip(lref, lgot):
        assert torch.equal(a, b)
    for t in (1, 4):
        _assert_bitwise(FL.slice_tenant(full, t), FL.slice_tenant(start, t),
                        f"masked-off lane {t}")
    for lj, lt in zip(losses_j, lgot):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   rtol=FLEET_TOL["loss"])
    refj, out = _trees_np(new_j), _trees_np(full)
    assert _worst(refj, out, "param") <= FLEET_TOL["param"]
    assert _worst(refj, out, "cache") <= FLEET_TOL["cache"]
    with pytest.raises(ValueError, match="mask"):
        _sharded(gt, mesh, masked=True, k=1)(
            PF.shard_fleet_state(start, mesh), *args, z1=z1, z2=z2)


def test_check_divisible_and_the_mesh():
    with pytest.raises(ValueError, match="does not divide"):
        PF.check_divisible(6, PF.tenant_mesh(4, "cpu"))
    PF.check_divisible(8, PF.tenant_mesh(4, "cpu"))
    state = FL.replicate_state(FT.state_from_graphs(
        *(lambda d: (d, MT.build_generator(device="cpu"),
                     MT.build_gan(device="cpu"), MT.build_classifier(d)))(
            MT.build_discriminator(device="cpu"))), 6)
    with pytest.raises(ValueError, match="does not divide"):
        PF.shard_fleet_state(state, PF.tenant_mesh(4, "cpu"))
    mesh = PF.tenant_mesh(3, "cpu")
    assert mesh.size == 3 and mesh.shape == {"tenant": 3}
    assert set(mesh.devices) == {torch.device("cpu")}
    ids = PF.shard_tenant_ids(mesh, 6)
    assert [t.tolist() for t in ids] == [[0, 1], [2, 3], [4, 5]]


def test_checkpoint_reshards_2_to_1_and_4(graphs, tmp_path):
    """A world-2 fleet checkpoint restores at 1 and at 4: per tenant bit for
    bit, ``__reshard__`` from 2, and each restored fleet's next call equals
    the straight world-2 run's."""
    _, gt = graphs
    args = tuple(map(torch.from_numpy, _tables(41)))
    mesh2 = PF.tenant_mesh(2, "cpu")
    shards = PF.shard_fleet_state(_start(gt), mesh2)
    shards, _ = _sharded(gt, mesh2, k=2)(shards, *args, key=KEY)
    ck = FL.FleetCheckpointer(str(tmp_path))
    ck.save(2, shards, mesh=mesh2)
    assert ck._inner.mesh_spec(2) == FL.fleet_mesh_spec(mesh2)
    live = PF.gather_fleet_state(shards)
    straight, lstraight = _sharded(gt, mesh2, k=2)(shards, *args, key=KEY)
    for world in (1, 4):
        mesh = PF.tenant_mesh(world, "cpu")
        step, restored, extra = ck.restore(target_mesh=mesh)
        assert step == 2 and len(restored) == world
        info = extra["__reshard__"]
        assert info["from"]["device_count"] == 2
        assert info["to"]["device_count"] == world
        full = PF.gather_fleet_state(restored)
        for t in range(N):
            _assert_bitwise(FL.slice_tenant(full, t),
                            FL.slice_tenant(live, t), f"2->{world} tenant {t}")
        nxt, lnxt = _sharded(gt, mesh, k=2)(restored, *args, key=KEY)
        for a, b in zip(lstraight, lnxt):
            assert torch.equal(a, b)
        _assert_bitwise(PF.gather_fleet_state(straight),
                        PF.gather_fleet_state(nxt), f"2->{world} next call")
    # the same world: no reshard; a subset by slot keeps working
    _, same, extra = ck.restore(target_mesh=mesh2)
    assert "__reshard__" not in extra and len(same) == 2
    _, sub, _ = ck.restore(tenants=(5, 2), target_mesh=PF.tenant_mesh(4, "cpu"))
    _assert_bitwise(sub, FL.subset_state(live, (5, 2)), "subset")


def test_jax_checkpoint_on_8_devices_restores_at_world_4(graphs, cpu_devices,
                                                          tmp_path):
    """A fleet checkpoint the JAX package writes on its 8-device tenant mesh
    restores in the port on a mesh of 4, bitwise per tenant."""
    gj, _ = graphs
    feats, labels, y_real, y_fake, ones = _tables(51)
    mesh8 = PJ.tenant_mesh(8)
    step8 = PJ.make_sharded_fleet_step(
        *gj, *MAPS_J, z_size=2, num_features=12, mesh=mesh8,
        per_tenant_data=True, donate=False, data_on_device=True)
    sh8 = PJ.fleet_sharding(mesh8)
    state = PJ.shard_fleet_state(
        FJ.replicate_state(SJ.state_from_graphs(*gj), N), mesh8)
    state, _ = step8(state, jnp.asarray(feats), jnp.asarray(labels),
                     jax.device_put(FJ.tenant_keys(jax.random.key(1), N), sh8),
                     jax.device_put(FJ.tenant_keys(jax.random.key(2), N), sh8),
                     *map(jnp.asarray, (y_real, y_fake, ones)))
    FJ.FleetCheckpointer(str(tmp_path)).save(1, state, mesh=mesh8)
    ck = FL.FleetCheckpointer(str(tmp_path))
    assert ck._inner.mesh_spec(1)["axes"] == {"tenant": 8}
    _, shards, extra = ck.restore(target_mesh=PF.tenant_mesh(4, "cpu"))
    assert extra["__reshard__"]["from"]["device_count"] == 8
    assert [FL.fleet_size(s) for s in shards] == [2] * 4
    want = _state_to_torch(jax.device_get(state))
    full = PF.gather_fleet_state(shards)
    for t in range(N):
        _assert_bitwise(FL.slice_tenant(full, t), FL.slice_tenant(want, t),
                        f"tenant {t}")
