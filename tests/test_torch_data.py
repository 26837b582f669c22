"""The port's data pipeline held against the JAX package's, on the CPU:
the CSV contract files, the DataVec-style iterator, the CSV matrix files,
the u8x100 codec, the prefetchers, and the training table the port's
trainer builds.  Everything here is held bit for bit (byte for byte for
files): both packages run the same numpy code on the same inputs.
"""

import os

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data import codec as codec_j
from gan_deeplearning4j_tpu.data import csv as csv_j
from gan_deeplearning4j_tpu.data import datasets as datasets_j
from gan_deeplearning4j_tpu.data import native as native_j
from gan_deeplearning4j_tpu.data.prefetch import ChunkPrefetchIterator as ChunkJ
from gan_deeplearning4j_tpu_torch.data import codec as codec_t
from gan_deeplearning4j_tpu_torch.data import csv as csv_t
from gan_deeplearning4j_tpu_torch.data import datasets as datasets_t
from gan_deeplearning4j_tpu_torch.data.prefetch import (
    ChunkPrefetchIterator,
    PrefetchIterator,
)
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT
from gan_deeplearning4j_tpu_torch.train import fused_step as FT
from gan_deeplearning4j_tpu_torch.train.gan_trainer import GANTrainer

N_TRAIN, N_TEST = 64, 32


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def csv_pair(tmp_path_factory):
    """The JAX package's contract CSV pair (n_train 64, n_test 32)."""
    d = str(tmp_path_factory.mktemp("jax_csv"))
    return datasets_j.export_mnist_csv(d, N_TRAIN, N_TEST)


@pytest.mark.parametrize("jax_writer", ["as_installed", "numpy"])
def test_export_mnist_csv_is_byte_equal(tmp_path, monkeypatch, jax_writer):
    """Both files of ``export_mnist_csv(n_train=64, n_test=32)``, against
    the JAX package's writer as it runs here (its C++ formatter when the
    library is built) and against its numpy fallback."""
    if jax_writer == "numpy":
        monkeypatch.setattr(native_j, "format_csv", lambda *a, **k: None)
    pj = datasets_j.export_mnist_csv(str(tmp_path / "j"), N_TRAIN, N_TEST)
    pt = datasets_t.export_mnist_csv(str(tmp_path / "t"), N_TRAIN, N_TEST)
    for a, b in zip(pj, pt):
        assert os.path.basename(a) == os.path.basename(b)
        assert _bytes(a) == _bytes(b)


def test_ensure_mnist_csv_keeps_files_and_refuses_half_pairs(tmp_path):
    train, test = datasets_t.ensure_mnist_csv(str(tmp_path), 16, 8)
    before = _bytes(train)
    assert datasets_t.ensure_mnist_csv(str(tmp_path), 32, 8) == (train, test)
    assert _bytes(train) == before  # an existing pair wins
    os.remove(test)
    with pytest.raises(FileExistsError):
        datasets_t.ensure_mnist_csv(str(tmp_path), 16, 8)


def test_load_split_matches_jax(csv_pair):
    fj, lj = datasets_j.load_split(csv_pair[1], 784)
    ft, lt = datasets_t.load_split(csv_pair[1], 784)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_array_equal(lt, lj)
    assert ft.dtype == fj.dtype == np.float32


def _walk(it, ops):
    """Drive an iterator through ``ops`` -> what each op returned."""
    out = []
    for op in ops:
        if op == "next":
            ds = it.next()
            out.append((ds.features.copy(), ds.labels.copy()))
        elif op == "has_next":
            out.append(it.has_next())
        elif op == "reset":
            it.reset()
        elif op == "state":
            out.append(it.state())
    return out


def _assert_walks_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            for u, v in zip(x, y):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u.view(np.uint8), v.view(np.uint8))
        else:
            assert x == y


# batch 24 over 64 rows: 24, 24, then a partial 16; a wrap; shuffle epochs
_OPS = (["next", "has_next", "state"] * 3 + ["has_next", "state", "reset"]
        + ["next", "next", "state", "reset", "next", "state", "reset",
           "next", "next", "next", "has_next"])


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("source", ["csv", "array"])
def test_iterator_batches_bitwise(csv_pair, shuffle, source):
    """The same op sequence through both iterators: every batch, has_next
    and state equal (reset, wrap, the partial last batch, per-epoch
    shuffle over epochs 0-2)."""
    src = csv_pair[0]
    if source == "array":
        src = np.loadtxt(csv_pair[0], delimiter=",", dtype=np.float32)
    kw = dict(label_index=784, num_classes=10, shuffle=shuffle,
              shuffle_seed=7)
    itj = csv_j.RecordReaderDataSetIterator(src, 24, **kw)
    itt = csv_t.RecordReaderDataSetIterator(src, 24, **kw)
    np.testing.assert_array_equal(itt.features, itj.features)
    np.testing.assert_array_equal(itt.labels, itj.labels)
    _assert_walks_equal(_walk(itj, _OPS), _walk(itt, _OPS))


@pytest.mark.parametrize("step", [0, 1, 2, 5, 7])
def test_iterator_state_restore_and_state_for_step(csv_pair, step):
    """``state_for_step`` and a restore into a fresh iterator land both
    packages on the same next batches."""
    kw = dict(label_index=784, num_classes=10, shuffle=True, shuffle_seed=3)
    itj = csv_j.RecordReaderDataSetIterator(csv_pair[0], 16, **kw)
    itt = csv_t.RecordReaderDataSetIterator(csv_pair[0], 16, **kw)
    assert itt.state_for_step(step) == itj.state_for_step(step)
    for it in (itj, itt):
        it.restore_state(it.state_for_step(step))
    ops = ["next", "state", "has_next", "reset", "next"]
    _assert_walks_equal(_walk(itj, ops), _walk(itt, ops))
    with pytest.raises(ValueError, match="shuffle contract"):
        itt.restore_state({**itt.state(), "shuffle_seed": 4})


def test_iterator_strict_and_bad_labels_raise():
    table = np.zeros((10, 3), np.float32)
    for mod in (csv_j, csv_t):
        with pytest.raises(ValueError, match="not a multiple"):
            mod.RecordReaderDataSetIterator(table, 4, 2, 3, strict=True)
        table[0, 2] = 5
        with pytest.raises(ValueError, match="outside"):
            mod.RecordReaderDataSetIterator(table, 5, 2, 3)
        table[0, 2] = 0


def test_reader_names_the_bad_row(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("1,2,3\n4,5,6\n7,x,9\n1,2,3\n")
    for mod in (csv_j, csv_t):
        with pytest.raises(mod.CSVRowError) as e:
            mod.CSVRecordReader().read(str(path))
        assert (e.value.line, e.value.reason) == (3, "unparseable field")


@pytest.mark.parametrize("fmt", ["%.8g", "%.2f"])
def test_csv_matrix_files_are_byte_equal(tmp_path, fmt):
    """``write_csv_matrix`` (JAX: its C++ formatter when built) and
    ``read_csv_matrix`` on f32 values across many magnitudes."""
    rng = np.random.RandomState(0)
    m = (rng.randn(40, 23) * 10.0 ** rng.randint(-6, 6, (40, 23))).astype(
        np.float32)
    m[0, :3] = [0.0, -0.0, np.float32(1) / 3]
    a, b = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    csv_j.write_csv_matrix(a, m, fmt=fmt)
    csv_t.write_csv_matrix(b, m, fmt=fmt)
    assert _bytes(a) == _bytes(b)
    np.testing.assert_array_equal(csv_t.read_csv_matrix(b),
                                  csv_j.read_csv_matrix(a))


# -- the u8x100 codec ---------------------------------------------------------

def test_codec_table_and_functions_are_bitwise():
    np.testing.assert_array_equal(codec_t.U8X100_TABLE.view(np.uint32),
                                  codec_j.U8X100_TABLE.view(np.uint32))
    rng = np.random.RandomState(1)
    codes = rng.randint(0, 256, (37, 11)).astype(np.uint8)
    vals = codec_j.u8x100_decode_np(codes)
    np.testing.assert_array_equal(codec_t.u8x100_decode_np(codes), vals)
    np.testing.assert_array_equal(codec_t.u8x100_encode(vals),
                                  codec_j.u8x100_encode(vals))
    assert codec_t.u8x100_lossless(vals) and codec_j.u8x100_lossless(vals)
    for bad in (vals + np.float32(1e-3), vals.astype(np.float64),
                np.full((2, 2), np.nan, np.float32),
                np.full((2, 2), 2.6, np.float32)):
        assert codec_t.u8x100_lossless(bad) == codec_j.u8x100_lossless(bad)


def test_contract_pixels_is_the_text_round_trip():
    """``contract_pixels`` against formatting with %.2f and parsing back,
    on every f32 within 64 ulps of each rounding midpoint (n + 0.5)/100
    and of each n/100, n in 0..100."""
    pts = np.arange(0, 101, dtype=np.float64) / 100.0
    pts = np.concatenate([pts, pts + 0.005]).astype(np.float32)
    steps = np.arange(-64, 65, dtype=np.int32)
    bits = pts.view(np.int32)[:, None] + steps[None, :]
    x = bits.reshape(-1).view(np.float32)
    x = x[(x >= 0) & (x <= 1)]
    text = "\n".join("%.2f" % v for v in x.astype(np.float64))
    parsed = np.loadtxt(text.splitlines(), dtype=np.float32)
    np.testing.assert_array_equal(datasets_t.contract_pixels(x).view(np.uint32),
                                  parsed.view(np.uint32))


def test_trainer_table_is_the_jax_iterators_table(csv_pair):
    """The fault the port had: its trainer trained on the synthetic floats,
    the JAX trainer on the decoded %.2f CSV.  Both tables now bit for bit,
    features and one-hot labels."""
    itj = csv_j.RecordReaderDataSetIterator(csv_pair[0], 16, 784, 10)
    t = GANTrainer(batch_size=16, n_train=N_TRAIN, device="cpu")
    np.testing.assert_array_equal(t.features.numpy().view(np.uint32),
                                  itj.features.view(np.uint32))
    np.testing.assert_array_equal(t.labels.numpy(), itj.labels)
    np.testing.assert_array_equal(
        datasets_t.mnist_table(N_TRAIN),
        np.loadtxt(csv_pair[0], delimiter=",", dtype=np.float32))


def test_codec_step_is_bitwise_the_f32_step():
    """``data_codec="u8x100"`` on the codes of a lossless table gives the
    f32 table's losses and state bit for bit (K = 2 steps a call, three
    calls, the batch index wrapping)."""
    B = 8
    table = datasets_t.mnist_table(3 * B)
    feats = torch.from_numpy(table[:, :784].copy())
    labels = torch.nn.functional.one_hot(
        torch.from_numpy(table[:, 784].astype(np.int64)), 10).float()
    codes = torch.from_numpy(codec_t.u8x100_encode(table[:, :784]))
    rng = np.random.RandomState(2)
    ones = torch.ones((B, 1))
    y_real = ones + torch.from_numpy((0.05 * rng.randn(B, 1)).astype(np.float32))
    y_fake = torch.from_numpy((0.05 * rng.randn(B, 1)).astype(np.float32))
    runs = []
    for codec, real in ((None, feats), ("u8x100", codes)):
        dis = MT.build_discriminator(device="cpu")
        graphs = (dis, MT.build_generator(device="cpu"),
                  MT.build_gan(device="cpu"), MT.build_classifier(dis))
        step = FT.make_protocol_step(
            *graphs, MT.DIS_TO_GAN, MT.GAN_TO_GEN, MT.DIS_TO_CLASSIFIER,
            z_size=2, num_features=784, steps_per_call=2, data_codec=codec)
        state = FT.state_from_graphs(*graphs)
        z_gen = torch.Generator().manual_seed(5)
        losses = []
        for _ in range(3):
            state, out = step(state, real, labels, y_real, y_fake, ones,
                              z_gen=z_gen)
            losses.append(torch.stack(out))
        runs.append((torch.cat(losses, 1), state))
    (la, sa), (lb, sb) = runs
    assert torch.equal(la, lb)
    for (f, ta), (_, tb) in zip(FT.state_trees(sa), FT.state_trees(sb)):
        for layer, lp in ta.items():
            for n, v in lp.items():
                assert torch.equal(v, tb[layer][n]), (f, layer, n)
    with pytest.raises(ValueError, match="unknown data_codec"):
        FT.make_protocol_step(None, None, None, None, [], [], [], 2, 784,
                              data_codec="u4")


# -- the prefetchers ------------------------------------------------------------

@pytest.mark.parametrize("encode", [False, True])
def test_chunk_prefetch_matches_jax_chunks(csv_pair, encode):
    """Five chunks of 3 batches of 24 over 64 rows (two full batches a
    pass: the partial tail skipped, the passes wrapping), with and without
    the u8 encoder: the port's staged chunks are the JAX prefetcher's."""
    kw = dict(label_index=784, num_classes=10)
    enc = codec_t.u8x100_encode if encode else None
    pj = ChunkJ(csv_j.RecordReaderDataSetIterator(csv_pair[0], 24, **kw), 3,
                24, prefetch_depth=1,
                encode_features=codec_j.u8x100_encode if encode else None)
    pt = ChunkPrefetchIterator(
        csv_t.RecordReaderDataSetIterator(csv_pair[0], 24, **kw), 3, 24,
        encode_features=enc, feature_dtype=np.uint8 if encode else np.float32)
    f = torch.zeros((72, 784), dtype=torch.uint8 if encode else torch.float32)
    lab = torch.zeros((72, 10))
    try:
        for _ in range(5):
            fj, lj = (np.asarray(a) for a in next(pj))
            pt.next_into(f, lab)
            np.testing.assert_array_equal(f.numpy(), fj)
            np.testing.assert_array_equal(lab.numpy(), lj)
        assert pt.state() == pj.state()
    finally:
        pj.close()
        pt.close()


def test_prefetch_iterator_skips_tails_and_wraps(csv_pair):
    it = csv_t.RecordReaderDataSetIterator(csv_pair[0], 24, 784, 10)
    rows = it.features
    with PrefetchIterator(it, loop=True, min_rows=24) as p:
        got = [next(p)[0] for _ in range(5)]
    for k, g in enumerate(got):
        b = k % 2
        np.testing.assert_array_equal(g, rows[b * 24:(b + 1) * 24])
    with PrefetchIterator(csv_t.RecordReaderDataSetIterator(
            csv_pair[0], 24, 784, 10)) as p:
        assert [x[0].shape[0] for x in p] == [24, 24, 16]


def test_prefetch_surfaces_worker_errors():
    class Broken:
        features = np.zeros((4, 2), np.float32)
        labels = np.zeros((4, 1), np.float32)

        def has_next(self):
            return True

        def next(self):
            raise OSError("disk gone")

    with ChunkPrefetchIterator(Broken(), 2, 2) as p:
        with pytest.raises(OSError, match="disk gone"):
            p.next_into(torch.zeros(4, 2), torch.zeros(4, 1))

