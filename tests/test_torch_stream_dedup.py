"""The streamed tier's dedup mode (``data/prefetch.py`` ``dedup``,
``train/fused_step.py`` ``chunk_indexed``, ``GANTrainer`` ``stream_dedup``)
on the CPU, held against the JAX package's (tests/test_train.py's
``test_stream_dedup_tier_matches_resident`` and ``..._resume_and_opt_out``):
the chunks (distinct-row table and row schedule) byte-equal to the JAX
dedup iterator's; the ``chunk_indexed`` K-step call against JAX's from the
same params and draws (step one's losses 1e-5 relative or 1e-6 absolute,
later 1e-3 relative; params 4e-3; caches 1e-1 of the leaf's largest), and
bitwise the port's resident step on the table in schedule order; the
dedup run bitwise the resident and the plain chunk runs; the tier's
engagement rule; both refusals; ``restore_state``; a resume mid-pass."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data.csv import RecordReaderDataSetIterator as IterJ
from gan_deeplearning4j_tpu.data.prefetch import (
    ChunkPrefetchIterator as ChunksJ,
)
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu.train import fused_step as FJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.data import datasets
from gan_deeplearning4j_tpu_torch.data.csv import (
    RecordReaderDataSetIterator,
    write_csv_matrix,
)
from gan_deeplearning4j_tpu_torch.data.prefetch import ChunkPrefetchIterator
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.train import fused_step as FT
from gan_deeplearning4j_tpu_torch.train.gan_trainer import (
    GANTrainer,
    GANTrainerConfig,
)

B = 16
K = 3
FIRST = (1e-5, 2e-5, 2e-3)
LATER = (1e-3, 4e-3, 5e-2)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """torch's CPU ops on one thread while this module runs (the tier-1
    lane runs six test processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**kw) -> GANTrainerConfig:
    base = dict(dataset_name="mnist", num_features=784, label_index=784,
                num_classes=10, batch_size=B, batch_size_pred=500,
                num_iterations=8, num_gen_samples=10, z_size=2,
                print_every=0, save_every=0, res_path=None, metrics=False,
                data_on_device=False)
    base.update(kw)
    return GANTrainerConfig(**base)


def _trainer(n_train: int = 32, **kw) -> GANTrainer:
    return GANTrainer(n_train=n_train, device="cpu", config=_config(**kw))


def _losses(t: GANTrainer):
    return [[r[k] for k in ("d_loss", "g_loss", "classifier_loss")]
            for r in t.metrics.records() if "step" in r]


# -- the chunks against the JAX dedup iterator --------------------------------

@pytest.fixture(scope="module")
def csv_table(tmp_path_factory):
    """A 40-row MNIST table (two full batches of 16 and a tail of 8) as
    the CSV both packages' iterators read."""
    d = tmp_path_factory.mktemp("dedup_csv")
    path = str(d / "train.csv")
    write_csv_matrix(path, datasets.mnist_table(40))
    return path


def test_dedup_chunks_equal_the_jax_iterators(csv_table):
    """Three chunks of K = 3 batches over a 2-batch pass (the tail
    skipped): the table is the first pass's rows, and each schedule
    (rows of batches 0 1 0, 1 0 1, 0 1 0) byte-equal to the JAX dedup
    iterator's."""
    jx = ChunksJ(IterJ(csv_table, B, 784, 10), K, B, prefetch_depth=1,
                 dedup=True)
    pt = ChunkPrefetchIterator(
        RecordReaderDataSetIterator(csv_table, B, 784, 10), K, B,
        dedup=True)
    try:
        feats = torch.zeros((2 * B, 784))
        labs = torch.zeros((2 * B, 10))
        idx = torch.zeros(K * B, dtype=torch.int32)
        for _ in range(3):
            tf, tl, ij = (np.asarray(a) for a in next(jx))
            pt.next_into(feats, labs, idx)
            assert np.array_equal(feats.numpy().view(np.uint32),
                                  tf.view(np.uint32))
            assert np.array_equal(labs.numpy(), tl)
            assert idx.numpy().dtype == ij.dtype == np.int32
            assert idx.numpy().tobytes() == ij.tobytes()
        assert pt.table_bytes == 2 * B * (784 + 10) * 4
        assert pt.chunk_bytes == K * B * 4
    finally:
        jx.close()
        pt.close()


# -- the chunk_indexed step against JAX's ---------------------------------------

def test_chunk_indexed_step_tracks_jax():
    """One K = 3 call of the ``chunk_indexed`` step on a 2-batch table
    with the schedule of batches 1 0 1, against JAX ``make_protocol_step(
    data_on_device=True, steps_per_call=3, chunk_indexed=True)`` from the
    same params, with the JAX step's draws injected; and bitwise the
    port's resident K-step call on the table laid out in schedule order.
    The caches' band is twice ``tests/test_torch_steps.py``'s K-step one:
    on this batch order a frozen conv's classifier cache reads 6.6e-2."""
    feats, labels = datasets.synthetic_mnist(2 * B, seed=5)
    labels = np.eye(10, dtype=np.float32)[labels]
    rng = np.random.RandomState(1)
    ones = np.ones((B, 1), np.float32)
    y_real = ones + (0.05 * rng.randn(B, 1)).astype(np.float32)
    y_fake = (0.05 * rng.randn(B, 1)).astype(np.float32)
    row_idx = np.concatenate([np.arange(B, 2 * B), np.arange(B),
                              np.arange(B, 2 * B)]).astype(np.int32)
    dis = MJ.build_discriminator()
    graphs = (dis, MJ.build_generator(), MJ.build_gan(),
              MJ.build_classifier(dis))
    state0 = FJ.state_from_graphs(*graphs)
    start = {f: jax.tree.map(np.array, getattr(state0, f)) for f in FT.TREES}
    z_key, rng_key = jax.random.key(3), jax.random.key(4)
    step_j = FJ.make_protocol_step(
        *graphs, MJ.DIS_TO_GAN, MJ.GAN_TO_GEN, MJ.DIS_TO_CLASSIFIER,
        z_size=2, num_features=784, donate=False, data_on_device=True,
        steps_per_call=K, chunk_indexed=True)
    state_j, losses_j = step_j(
        state0, jnp.asarray(feats), jnp.asarray(labels),
        jnp.asarray(row_idx), z_key, rng_key, jnp.asarray(y_real),
        jnp.asarray(y_fake), jnp.asarray(ones))
    z1, z2 = (torch.from_numpy(np.stack([np.array(jax.random.uniform(
        jax.random.fold_in(z_key, 2 * it + k), (B, 2), minval=-1.0,
        maxval=1.0)) for it in range(K)])) for k in (0, 1))
    dis_t = MT.build_discriminator(device="cpu")
    step_t = FT.make_protocol_step(
        dis_t, MT.build_generator(device="cpu"), MT.build_gan(device="cpu"),
        MT.build_classifier(dis_t), MT.DIS_TO_GAN, MT.GAN_TO_GEN,
        MT.DIS_TO_CLASSIFIER, z_size=2, num_features=784, steps_per_call=K,
        chunk_indexed=True)
    carry = FT.ProtocolState(
        *(interop.params_from_numpy(start[f], "cpu") for f in FT.TREES),
        torch.tensor(0), None)
    state_t, losses_t = step_t(
        carry, torch.from_numpy(feats), torch.from_numpy(labels),
        torch.from_numpy(row_idx), torch.from_numpy(y_real),
        torch.from_numpy(y_fake), torch.from_numpy(ones), z1=z1, z2=z2)
    got = torch.stack(losses_t, -1).numpy()
    want = np.stack([np.asarray(v) for v in losses_j], -1)
    # a G loss of ~1.6e-3 at step one: f32 summation order alone moves it
    # by ~1e-7, hence the absolute floor
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST[0], atol=1e-6)
    np.testing.assert_allclose(got[1:], want[1:], rtol=LATER[0])
    assert int(state_t.it) == int(state_j.it) == K
    for f in FT.TREES:
        ref = jax.tree.map(np.array, getattr(state_j, f))
        mine = interop.params_to_numpy(getattr(state_t, f))
        cache = f.endswith("_opt")
        for layer, lp in ref.items():
            for n, a in lp.items():
                d = float(np.abs(np.asarray(mine[layer][n]) - a).max())
                if cache:
                    d /= float(np.abs(a).max()) + 1e-8
                assert d <= (2 * LATER[2] if cache else LATER[1]), (
                    f, layer, n)
    resident = FT.make_protocol_step(
        dis_t, MT.build_generator(device="cpu"), MT.build_gan(device="cpu"),
        MT.build_classifier(dis_t), MT.DIS_TO_GAN, MT.GAN_TO_GEN,
        MT.DIS_TO_CLASSIFIER, z_size=2, num_features=784, steps_per_call=K)
    carry = FT.ProtocolState(
        *(interop.params_from_numpy(start[f], "cpu") for f in FT.TREES),
        torch.tensor(0), None)
    state_r, losses_r = resident(
        carry, torch.from_numpy(feats[row_idx]),
        torch.from_numpy(labels[row_idx]), torch.from_numpy(y_real),
        torch.from_numpy(y_fake), torch.from_numpy(ones), z1=z1, z2=z2)
    assert all(torch.equal(a, b) for a, b in zip(losses_r, losses_t))
    a, b = FT._leaves(state_r), FT._leaves(state_t)
    assert all(torch.equal(a[k], b[k]) for k in a)


# -- the trainer ---------------------------------------------------------------

@pytest.fixture(scope="module")
def three_tiers():
    """8 steps on 32 rows (two batches a pass) with K = 8: resident, the
    dedup tier (auto) and the plain chunk tier (opted out)."""
    out = {}
    for mode, kw in (("resident", dict(data_on_device=True)),
                     ("dedup", {}),
                     ("plain", dict(stream_dedup=False))):
        t = _trainer(**kw)
        out[mode] = (t, t.train(log=None))
    return out


def test_dedup_run_is_bitwise_the_resident_and_plain_chunk_runs(three_tiers):
    """The tier engages (K = 8 covers the pass; the u8 table of 32 rows
    crosses once, 512 bytes of schedule a chunk), and its per-step losses
    and final state are bitwise the resident run's and the plain chunk
    run's."""
    t_d, r_d = three_tiers["dedup"]
    assert r_d["stream_dedup"] and r_d["steps_per_call"] == 8
    assert r_d["data_codec"] == "u8x100"
    assert r_d["link_bytes"] == {"table": 32 * (784 + 40), "per_chunk": 512}
    assert t_d.features.dtype == torch.float32  # decoded once, on arrival
    assert not three_tiers["plain"][1]["stream_dedup"]
    assert three_tiers["plain"][1]["link_bytes"] == {
        "table": 0, "per_chunk": 8 * B * (784 + 40)}
    assert three_tiers["resident"][1]["link_bytes"] is None
    want = _losses(three_tiers["resident"][0])
    assert len(want) == 8
    for mode in ("dedup", "plain"):
        t = three_tiers[mode][0]
        assert _losses(t) == want, mode
        a, b = FT._leaves(three_tiers["resident"][0].state), FT._leaves(t.state)
        assert all(torch.equal(a[k], b[k]) for k in a), mode


@pytest.mark.parametrize("n_train,kw,engaged", [
    (32, {}, True),                                  # K 8 covers 2 batches
    (32, dict(stream_dedup=False), False),           # the opt-out
    (32, dict(steps_per_call=1), False),             # K 1 covers nothing
    (96, dict(num_iterations=4), False),             # 6 batches > K 4
    (96, dict(num_iterations=6), True),              # 6 batches = K 6
    (32, dict(stream_chunk_bytes=32 * 824 - 1), False),  # table too big
    (32, dict(stream_chunk_bytes=32 * 824), True),       # table just fits
    (32, dict(use_data_codec=False,
              stream_chunk_bytes=32 * 824), False),  # f32 table too big
])
def test_tier_engages_where_the_jax_rule_says(n_train, kw, engaged):
    """The JAX trainer's rule (gan_trainer.py:1551-1583): not opted out,
    the uncapped K > 1 and at least the batches of a pass, and the
    distinct-row table (u8 under the codec) within stream_chunk_bytes."""
    t = _trainer(n_train=n_train, **kw)
    assert t.stream_dedup is engaged
    assert (t.row_idx is not None) is engaged


class _Source:
    """A deterministic in-memory batch source; ``shuffle`` changes its
    second pass, ``passes`` counts its resets."""

    def __init__(self, n_batches: int, shuffle: bool = False):
        rng = np.random.RandomState(0)
        self.features = rng.rand(n_batches * B, 4).astype(np.float32)
        self.labels = rng.rand(n_batches * B, 1).astype(np.float32)
        self.n, self.shuffle, self.cur, self.passes = n_batches, shuffle, 0, 0

    def has_next(self):
        return self.cur < self.n

    def next(self):
        from gan_deeplearning4j_tpu_torch.data.csv import DataSet

        lo = self.cur * B
        self.cur += 1
        f = self.features[lo:lo + B]
        return DataSet(f[::-1].copy() if self.shuffle and self.passes else f,
                       self.labels[lo:lo + B])

    def reset(self):
        self.cur, self.passes = 0, self.passes + 1


@pytest.mark.parametrize("source,chunk,match", [
    (lambda: _Source(3), 2, "chunk_batches >= batches per pass"),
    (lambda: _Source(2, shuffle=True), 2, "deterministic source"),
])
def test_the_worker_raises_and_never_falls_back(source, chunk, match):
    """A pass that outgrows the shipped table, and a later pass that
    differs from the first: the JAX worker's RuntimeErrors, delivered to
    the consumer."""
    it = ChunkPrefetchIterator(source(), chunk, B, dedup=True)
    feats = torch.zeros((2 * B, 4))  # the table the first chunk ships
    labs = torch.zeros((2 * B, 1))
    idx = torch.zeros(chunk * B, dtype=torch.int32)
    try:
        with pytest.raises(RuntimeError, match=match):
            for _ in range(4):
                it.next_into(feats, labs, idx)
    finally:
        it.close()


def test_restore_state_refuses_in_dedup_mode():
    it = ChunkPrefetchIterator(_Source(2), 2, B, dedup=True)
    try:
        with pytest.raises(RuntimeError, match="dedup chunk mode"):
            it.restore_state({"v": 1})
    finally:
        it.close()


def _insurance(res: str, n: int, **kw) -> GANTrainer:
    """The insurance program's trainer streamed at batch 100: its 700
    training rows are 7 batches a pass."""
    from gan_deeplearning4j_tpu_torch.train import insurance_main as IT

    base = dict(res_path=res, num_iterations=n, batch_size=100,
                print_every=0, save_every=0, metrics=False,
                data_on_device=False)
    base.update(kw)
    return GANTrainer(device="cpu", workload=IT.InsuranceWorkload(),
                      config=IT.default_config(**base))


def test_a_resume_mid_pass_keeps_the_schedule(tmp_path):
    """9 steps with a checkpoint at 9 (K = 9 over a 7-batch pass), then a
    resume to 18 (a checkpoint at 18): K = 9 again and the tier engaged
    from pass position 2 (the table's first batch is the pass's third);
    bitwise the 18-step run that never stopped."""
    full = _insurance(str(tmp_path / "full"), 18, steps_per_call=9)
    full.train(log=None)
    assert full.stream_dedup and full.stream_k == 9
    d = str(tmp_path / "r")
    first = _insurance(d, 9, checkpoint_every=9)
    first.train(log=None)
    resumed = _insurance(d, 18, checkpoint_every=18, resume=True)
    assert resumed.steps == 9 and resumed.stream_dedup
    assert resumed.stream_k == 9  # gcd(18, 18, the resume step 9)
    resumed.train(log=None)
    a, b = FT._leaves(full.state), FT._leaves(resumed.state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(full.z_gen.get_state(), resumed.z_gen.get_state())
