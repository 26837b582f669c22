"""Serving a fleet per tenant on the CPU: the port's ``FleetTenantBank``
(``serve/router.py``) and ``replica --fleet`` (``serve/replica.py``
``build_fleet_replica``).  Each tenant's answer is held to the plain
generator forward on that tenant's slice of the fleet (1e-6 absolute: the
engine pads a request up to its bucket, the plain forward does not);
unknown, out-of-range and negative ids are a typed ``KeyError`` (the
gateway's 404), never a wrapped index into another tenant's weights; one
tenant's quota throttles that tenant only; the live engines are an LRU; a
newer fleet checkpoint is hot-swapped into the live engines in place.
Insurance generators at their own widths, 3 tenants."""

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu_torch.models import mlpgan_insurance as M
from gan_deeplearning4j_tpu_torch.serve import (
    FleetTenantBank,
    GatewayClient,
    GatewayHTTPError,
    RemoteReplica,
    Router,
    TenantThrottledError,
)
from gan_deeplearning4j_tpu_torch.serve import replica
from gan_deeplearning4j_tpu_torch.train import fleet as FL
from gan_deeplearning4j_tpu_torch.train import fused_step as FT

N = 3
BUCKETS = (4, 8)
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen():
    return M.build_generator(device="cpu")


def _fleet(shift: float = 0.0) -> FT.ProtocolState:
    """A 3-tenant fleet whose generators differ: tenant i's weights moved
    by (i + 1) * 0.05 (+ ``shift``)."""
    dis = M.build_discriminator(device="cpu")
    graphs = (dis, _gen(), M.build_gan(device="cpu"),
              M.build_classifier(dis))
    state = FL.replicate_state(FT.state_from_graphs(*graphs), N)
    bump = (torch.arange(N, dtype=torch.float32) + 1) * 0.05 + shift
    gen = {layer: {k: v + bump.view((N,) + (1,) * (v.dim() - 1))
                   if k in ("W", "b") else v for k, v in lp.items()}
           for layer, lp in state.gen_params.items()}
    return state._replace(gen_params=gen)


def _plain(state, tenant: int, z: np.ndarray) -> np.ndarray:
    g = _gen()
    g.params = FL.slice_tenant(state, tenant).gen_params
    return g.output(torch.from_numpy(z))[0].numpy()


def _z(rows: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(
        -1, 1, (rows, 2)).astype(np.float32)


def test_each_tenant_answers_from_its_own_slice():
    state = _fleet()
    bank = FleetTenantBank(_gen, state=state, buckets=BUCKETS, max_live=4)
    router = Router(tenants=bank)
    try:
        outs = {}
        for t in range(N):
            z = _z(5, t)
            got = router.submit([z], tenant=str(t)).result(timeout=60)[0]
            np.testing.assert_allclose(got, _plain(state, t, z), atol=TOL)
            outs[t] = got
        # the tenants' generators differ, so their answers do
        assert not np.allclose(outs[0], outs[1])
        assert bank.num_tenants() == N and bank.live_count() == N
        for bad in (N, -1, -N, "x", "1.5"):
            with pytest.raises(KeyError):
                router.submit([_z(2, 0)], tenant=bad)
        with pytest.raises(KeyError):
            bank.engine(True)
        assert bank.live_count() == N
    finally:
        router.stop()


def test_quota_throttles_one_tenant_only_and_lru_evicts():
    state = _fleet()
    bank = FleetTenantBank(_gen, state=state, buckets=BUCKETS, max_live=2,
                           quota_capacity=2, quota_refill_per_s=1e-6)
    router = Router(tenants=bank)
    try:
        z = _z(3, 9)
        for _ in range(2):
            router.submit([z], tenant="0").result(timeout=60)
        with pytest.raises(TenantThrottledError) as ei:
            router.submit([z], tenant="0")
        assert ei.value.tenant == 0 and ei.value.retry_after_s > 0
        # tenant 1 keeps its full allowance; an unknown id allocates none
        router.submit([z], tenant="1").result(timeout=60)
        with pytest.raises(KeyError):
            bank.charge(7)
        # LRU: a third live tenant evicts the least recently used (0)
        e0, e1 = bank.engine(0), bank.engine(1)
        bank.engine(1)
        e2 = bank.engine(2)
        assert bank.live_count() == 2
        assert not e0.running and e1.running and e2.running
        assert bank.engine(1) is e1
    finally:
        router.stop()


def test_bank_over_a_checkpoint_hotswaps_in_place(tmp_path):
    d = str(tmp_path / "ckpt")
    ck = FL.FleetCheckpointer(d)
    old, new = _fleet(), _fleet(shift=0.1)
    ck.save(3, old)
    bank = FleetTenantBank(_gen, checkpointer=FL.FleetCheckpointer(
        d, sweep_debris=False), buckets=BUCKETS)
    try:
        z = _z(4, 1)
        eng = bank.engine(2)
        np.testing.assert_allclose(eng.submit(z).result(timeout=60)[0],
                                   _plain(old, 2, z), atol=TOL)
        ck.save(5, new)
        assert bank.hotswap_from(d) == 5
        assert bank.engine(2) is eng
        np.testing.assert_allclose(eng.submit(z).result(timeout=60)[0],
                                   _plain(new, 2, z), atol=TOL)
        # a smaller fleet evicts the tenants it no longer holds
        ck.save(6, FL.subset_state(new, [0, 1]))
        assert bank.hotswap_from(d) == 6 and bank.live_count() == 0
        with pytest.raises(KeyError):
            bank.engine(2)
    finally:
        bank.stop()


def test_fleet_replica_serves_tenants_and_probes(tmp_path):
    """``build_fleet_replica`` on the CPU over a fleet checkpoint: each
    tenant through the gateway equals its slice, the plain route is
    tenant 0 (the control plane's canary probe runs real fleet weights),
    an unknown or negative tenant is 404 ``unknown_tenant``, and
    ``/admin/hotswap`` moves every live tenant to the newer checkpoint."""
    d = str(tmp_path / "ckpt")
    ck = FL.FleetCheckpointer(d)
    old, new = _fleet(), _fleet(shift=0.2)
    ck.save(1, old)
    engine, gateway, _wedge, bank = replica.build_fleet_replica(
        checkpoint=d, tenants=9, buckets=BUCKETS, device="cpu")
    client = GatewayClient("127.0.0.1", gateway.port, retries=0)
    try:
        assert bank.num_tenants() == N  # the checkpoint's, not --fleet-tenants
        z = _z(6, 4)
        for t in range(N):
            got = client.generate([z], tenant=str(t))[0]
            np.testing.assert_allclose(got, _plain(old, t, z), atol=TOL)
        np.testing.assert_allclose(client.generate([z])[0],
                                   _plain(old, 0, z), atol=TOL)
        for bad in ("3", "-1"):
            with pytest.raises(GatewayHTTPError) as ei:
                client.generate([z], tenant=bad)
            assert (ei.value.status, ei.value.error_type) == (
                404, "unknown_tenant")
        ck.save(2, new)
        admin = RemoteReplica("127.0.0.1", gateway.port)
        assert admin.admin("hotswap", {"directory": d})["step"] == 2
        admin.close()
        np.testing.assert_allclose(client.generate([z], tenant="1")[0],
                                   _plain(new, 1, z), atol=TOL)
    finally:
        client.close()
        gateway.stop()
        bank.stop()
    # an empty directory boots a fresh --fleet-tenants wide fleet
    _, gateway, _, bank = replica.build_fleet_replica(
        checkpoint=str(tmp_path / "empty"), tenants=2, buckets=BUCKETS,
        device="cpu")
    try:
        assert bank.num_tenants() == 2
    finally:
        gateway.stop()
        bank.stop()
