"""The port's evaluation held against the JAX package's, on the CPU: the
DL4J-style ``Evaluation`` report, accuracy, the Fréchet distance, the
frozen extractor's and the transfer classifier's features, and the FID of
one generator's samples.

Tolerances: the report, the accuracy and the Fréchet distance run the same
numpy code in both packages and are held exactly.  Features come from f32
convolutions and matmuls that the two packages sum in different orders:
within atol 1e-5 (activations are O(1)).  The FID of the same generator
params within rtol 1e-3: both sample the same latents from the shared
``RandomState`` stream, so the pixels and features differ only by that
rounding, and the FID, a sum over 256 feature dims, moves far less than
1e-3 relative from it.
"""

import jax
import numpy as np
import pytest

from gan_deeplearning4j_tpu.data import datasets as datasets_j
from gan_deeplearning4j_tpu.eval import evaluation as evaluation_j
from gan_deeplearning4j_tpu.eval import fid as fid_j
from gan_deeplearning4j_tpu.eval import fid_extractor as fx_j
from gan_deeplearning4j_tpu.eval import metrics as metrics_j
from gan_deeplearning4j_tpu.models import dcgan_mnist as MJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.eval import evaluation as evaluation_t
from gan_deeplearning4j_tpu_torch.eval import fid as fid_t
from gan_deeplearning4j_tpu_torch.eval import fid_extractor as fx_t
from gan_deeplearning4j_tpu_torch.eval import metrics as metrics_t
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as MT

FEATURE_ATOL = 1e-5
FID_RTOL = 1e-3


@pytest.fixture(scope="module")
def pixels(tmp_path_factory):
    """96 test digits as the CSV contract decodes them."""
    d = str(tmp_path_factory.mktemp("csv"))
    _, test = datasets_j.export_mnist_csv(d, 8, 96)
    return datasets_j.load_split(test, 784)


def _cases():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 10, 200)
    scores = rng.rand(200, 10)
    scores[labels == 3, 7] += 2.0  # class 3 never predicted
    yield "ten", 10, labels, scores
    yield "onehot", 10, np.eye(10)[labels], scores
    yield "sigmoid", 2, rng.randint(0, 2, (50, 1)), rng.rand(50, 1)


@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_evaluation_report_is_equal(case):
    _, n, labels, preds = case
    ej, et = evaluation_j.Evaluation(n), evaluation_t.Evaluation(n)
    for lo in range(0, len(labels), 64):  # accumulated batch by batch
        ej.eval(labels[lo:lo + 64], preds[lo:lo + 64])
        et.eval(labels[lo:lo + 64], preds[lo:lo + 64])
    assert et.stats() == ej.stats()
    np.testing.assert_array_equal(et.confusion_matrix(), ej.confusion_matrix())
    for c in range(n):
        assert (et.precision(c), et.recall(c), et.f1(c)) == (
            ej.precision(c), ej.recall(c), ej.f1(c))


def test_accuracy_and_stats_file_are_equal(tmp_path):
    _, n, labels, preds = next(_cases())
    assert metrics_t.accuracy_from_predictions(preds, labels) == \
        metrics_j.accuracy_from_predictions(preds, labels)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    rj = metrics_j.write_evaluation_report(str(tmp_path / "j"), preds,
                                           labels, n)
    rt = metrics_t.write_evaluation_report(str(tmp_path / "t"), preds,
                                           labels, n)
    assert rt == rj
    assert ((tmp_path / "t" / "evaluation_stats.txt").read_bytes()
            == (tmp_path / "j" / "evaluation_stats.txt").read_bytes())


def test_frechet_distance_is_equal():
    rng = np.random.RandomState(1)
    fa, fb = rng.randn(300, 16), rng.randn(200, 16) * 1.3 + 0.2
    args = (fa.mean(0), np.cov(fa, rowvar=False), fb.mean(0),
            np.cov(fb, rowvar=False))
    assert fid_t.frechet_distance(*args) == fid_j.frechet_distance(*args)
    assert fid_t.fid_from_features(fa, fb) == fid_j.fid_from_features(fa, fb)
    assert fid_t.fid_from_features(fa, fa) == fid_j.fid_from_features(fa, fa)


def test_frozen_extractor_features_agree(pixels):
    """The committed extractor, loaded by each package, on the same pixels
    (batch 40: two full batches and a padded partial one)."""
    real, _ = pixels
    fj = fid_j.extract_features(fx_j.load_extractor(), real, fx_j.FEATURE_LAYER,
                                batch_size=40)
    ft = fid_t.extract_features(fx_t.load_extractor("cpu"), real,
                                fx_t.FEATURE_LAYER, batch_size=40)
    assert ft.shape == fj.shape == (96, 256)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=FEATURE_ATOL)


@pytest.fixture(scope="module")
def generators():
    """The JAX package's generator and classifier, and the port's carrying
    the same params."""
    gj, dj = MJ.build_generator(), MJ.build_discriminator()
    cj = MJ.build_classifier(dj)
    gt, dt = MT.build_generator(device="cpu"), MT.build_discriminator(device="cpu")
    ct = MT.build_classifier(dt)
    for a, b in ((gj, gt), (cj, ct)):
        b.params = interop.params_from_numpy(
            jax.tree.map(np.asarray, a.params), "cpu", like=b.params)
    return (gj, cj), (gt, ct)


def test_classifier_features_agree(pixels, generators):
    real, _ = pixels
    (_, cj), (_, ct) = generators
    fj = fid_j.extract_features(cj, real, batch_size=64)
    ft = fid_t.extract_features(ct, real, batch_size=64)
    assert ft.shape == fj.shape == (96, 1024)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=FEATURE_ATOL)


def test_fid_of_the_same_generator_agrees(pixels, generators):
    """Samples of the same generator params, scored in the frozen space and
    in the classifier's (the cv_main evaluation's two spaces)."""
    real, _ = pixels
    (gj, cj), (gt, ct) = generators
    pj = fid_j.synthesize_pixels(gj, 96, 784, batch_size=40)
    pt = fid_t.synthesize_pixels(gt, 96, 784, batch_size=40)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=FEATURE_ATOL)
    got = fx_t.frozen_fid(real, pt, device="cpu", batch_size=40)
    ref = fx_j.frozen_fid(real, pj, batch_size=40)
    assert got == pytest.approx(ref, rel=FID_RTOL)
    got = fid_t.compute_fid(ct, real, pt, batch_size=40)
    ref = fid_j.compute_fid(cj, real, pj, batch_size=40)
    assert got == pytest.approx(ref, rel=FID_RTOL)
    assert np.isfinite(got) and got > 0

