"""The DL4J migration surface of the port against the JAX package on the
CPU: the graph's listeners and ``score_on``, ``utils/listeners.py``,
``data/normalizers.py`` with the iterator's preprocessor hook,
``train/early_stopping.py`` and ``compat/nd4j.py``.  Every comparison
starts from the same numpy data and the same params (the JAX graph's
init, carried into the port).

Tolerances: one f32 step of a 4-16-1 MLP differs between the packages by
float rounding only, so scores are held to 1e-5 relative and params to
1e-5 absolute after a few epochs at lr 0.05 (Sgd: no RmsProp
amplification of near-zero gradients).
"""

import zipfile

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.compat import nd4j as NJ
from gan_deeplearning4j_tpu.data import csv as CSVJ
from gan_deeplearning4j_tpu.data import normalizers as NRJ
from gan_deeplearning4j_tpu.graph.graph import GraphBuilder as GBJ
from gan_deeplearning4j_tpu.graph.graph import InputSpec as ISJ
from gan_deeplearning4j_tpu.graph.layers import Dense as DJ
from gan_deeplearning4j_tpu.graph.layers import Output as OJ
from gan_deeplearning4j_tpu.optim import Sgd as SgdJ
from gan_deeplearning4j_tpu.train import early_stopping as ESJ
from gan_deeplearning4j_tpu.utils import listeners as LJ
from gan_deeplearning4j_tpu_torch import interop
from gan_deeplearning4j_tpu_torch.compat import nd4j as NT
from gan_deeplearning4j_tpu_torch.data import csv as CSVT
from gan_deeplearning4j_tpu_torch.data import normalizers as NRT
from gan_deeplearning4j_tpu_torch.graph.graph import GraphBuilder as GBT
from gan_deeplearning4j_tpu_torch.graph.graph import InputSpec as IST
from gan_deeplearning4j_tpu_torch.graph.layers import Dense as DT
from gan_deeplearning4j_tpu_torch.graph.layers import Output as OT
from gan_deeplearning4j_tpu_torch.graph import serialization
from gan_deeplearning4j_tpu_torch.optim.sgd import Sgd as SgdT
from gan_deeplearning4j_tpu_torch.train import early_stopping as EST
from gan_deeplearning4j_tpu_torch.utils import listeners as LT

SCORE_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _graphs(lr=0.05):
    """The JAX early-stopping test's toy graph in both packages, the port
    holding the JAX graph's params."""
    def build(GB, IS, D, O, S, **kw):
        return (GB(seed=666)
                .add_inputs("in")
                .set_input_types(IS.feed_forward(4))
                .add_layer("h", D(n_out=16, activation="tanh",
                                  updater=S(lr)), "in")
                .add_layer("out", O(n_out=1, activation="sigmoid",
                                    loss="xent", updater=S(lr)), "h")
                .set_outputs("out")
                .build(**kw)).init()

    gj = build(GBJ, ISJ, DJ, OJ, SgdJ)
    gt = build(GBT, IST, DT, OT, SgdT, device="cpu")
    gt.params = interop.params_from_numpy(
        {l: {k: np.asarray(v) for k, v in lp.items()}
         for l, lp in gj.params.items()}, "cpu", like=gt.params)
    return gj, gt


def _data(n=128, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 4).astype(np.float32)
    y = (x.sum(axis=1, keepdims=True) > 2.0).astype(np.float32)
    return x, y


def _table(n=128, seed=0):
    x, y = _data(n, seed)
    return np.concatenate([x * 7.0 - 2.0, y], axis=1)


def _assert_params_close(gj, gt):
    for layer, lp in gj.params.items():
        for k, v in lp.items():
            np.testing.assert_allclose(gt.params[layer][k].numpy(),
                                       np.asarray(v), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{layer}.{k}")


# -- the graph's listener surface and utils/listeners.py ----------------------

def test_listeners_fire_as_in_jax():
    """Collected scores equal the returned losses and the JAX graph's, at
    the same iterations; the score arrives as a 0-d tensor (a device
    scalar); ``set_listeners`` replaces, ``add_listeners`` appends; the
    score listener's lines and the performance listener's cadence are
    the JAX ones."""
    gj, gt = _graphs()
    x, y = _data(16)
    seen = []

    class Probe(LT.TrainingListener):
        def iteration_done(self, model, iteration, score):
            seen.append((model, iteration, score))

    cj, ct = LJ.CollectScoresListener(1), LT.CollectScoresListener(1)
    gj.set_listeners(cj)
    gt.set_listeners(ct, Probe())
    lt = [float(gt.fit(x, y)) for _ in range(5)]
    for _ in range(5):
        gj.fit(x, y)
    assert [i for i, _ in ct.scores] == [i for i, _ in cj.scores] \
        == [1, 2, 3, 4, 5]
    assert [s for _, s in ct.scores] == pytest.approx(lt)
    np.testing.assert_allclose([s for _, s in ct.scores],
                               [s for _, s in cj.scores], rtol=SCORE_RTOL)
    assert all(m is gt and isinstance(s, torch.Tensor) and s.dim() == 0
               for m, _, s in seen)
    lines_j, lines_t = [], []
    gj.set_listeners(LJ.ScoreIterationListener(2, log=lines_j.append))
    gt.set_listeners(LT.ScoreIterationListener(2, log=lines_t.append))
    perf = []
    gt.add_listeners(LT.PerformanceListener(frequency=1, batch_size=16,
                                            log=perf.append))
    for _ in range(4):
        gj.fit(x, y)
        gt.fit(x, y)
    assert [line.split(" is ")[0] for line in lines_t] \
        == [line.split(" is ")[0] for line in lines_j] \
        == ["Score at iteration 6", "Score at iteration 8"]
    np.testing.assert_allclose(
        [float(line.split(" is ")[1]) for line in lines_t],
        [float(line.split(" is ")[1]) for line in lines_j], rtol=SCORE_RTOL)
    # baseline at its first observed step (5), then one line a step
    assert len(perf) == 3 and all("examples/s" in p for p in perf)
    assert len(gt.listeners) == 2


def test_score_on_is_the_jax_inference_loss():
    """``score_on`` is the inference-mode loss, pure (no state moves),
    the JAX graph's value from the same params; it takes numpy."""
    gj, gt = _graphs()
    x, y = _data(64)
    s = gt.score_on(x, y)
    assert s == gt.score_on(x, y)
    assert s == pytest.approx(gj.score_on(x, y), rel=SCORE_RTOL)
    gt.fit(x, y)
    assert gt.score_on(x, y) != s


# -- data/normalizers.py and the preprocessor hook --------------------------------

@pytest.mark.parametrize("kind", ["NormalizerMinMaxScaler",
                                  "NormalizerStandardize"])
def test_normalizers_match_jax_and_files_cross(tmp_path, kind):
    """Fit on the train split through the iterator (raw features, even
    with the normalizer attached), transform and revert as JAX does, and
    the ``.npz`` members are the JAX file's bytes; either package loads
    the other's file."""
    table = _table()
    kw = {"min_range": -1.0, "max_range": 1.0} \
        if kind == "NormalizerMinMaxScaler" else {}
    it_j = CSVJ.RecordReaderDataSetIterator(table, 32, 4, 1)
    it_t = CSVT.RecordReaderDataSetIterator(table, 32, 4, 1)
    nj = getattr(NRJ, kind)(**kw)
    nt = getattr(NRT, kind)(**kw)
    it_t.set_preprocessor(nt)
    nj.fit(it_j)
    nt.fit(it_t)
    it_j.set_preprocessor(nj)
    assert it_t.preprocessor is nt
    while it_t.has_next():
        a, b = it_t.next(), it_j.next()
        np.testing.assert_array_equal(a.features, b.features)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(nt.revert(a.features),
                                      nj.revert(b.features))
    # the backing table was never mutated
    np.testing.assert_array_equal(it_t.features, table[:, :4])
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    nj.save(pj)
    nt.save(pt)
    with zipfile.ZipFile(pj) as zj, zipfile.ZipFile(pt) as zt:
        assert zj.namelist() == zt.namelist()
        for name in zj.namelist():
            assert zj.read(name) == zt.read(name), name
    back_t, back_j = NRT._FitNormalizer.load(pj), NRJ._FitNormalizer.load(pt)
    assert type(back_t).__name__ == type(back_j).__name__ == kind
    x = table[:8, :4]
    np.testing.assert_array_equal(back_t.transform(x), nj.transform(x))
    np.testing.assert_array_equal(back_j.transform(x), nt.transform(x))


def test_normalizer_needs_a_fit():
    with pytest.raises(ValueError, match="must be fit first"):
        NRT.NormalizerStandardize().transform(np.zeros((2, 3), np.float32))


# -- train/early_stopping.py ---------------------------------------------------------

class ListIterator:
    """A minimal DataSetIterator over in-memory batches."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def has_next(self):
        return self.i < len(self.batches)

    def next(self):
        self.i += 1
        return self.batches[self.i - 1]

    def reset(self):
        self.i = 0


def _iters(DataSet, x, y, xv, yv):
    return (ListIterator([DataSet(x[i:i + 32], y[i:i + 32])
                          for i in range(0, len(x), 32)]),
            ListIterator([DataSet(xv, yv)]))


@pytest.mark.parametrize("case", ["patience", "max_epochs", "max_score",
                                  "nan_score"])
def test_early_stopping_stops_where_jax_does(tmp_path, case):
    """The same data, params and config through both trainers: the same
    reason, best epoch and epoch count, the best score within
    ``SCORE_RTOL``, the restored params within ``PARAM_ATOL``, and the
    persisted best model (``save_path``) restores the best score."""
    x, y = _data(128)
    xv, yv = _data(64, seed=1)
    lr = 0.0 if case == "patience" else 0.05
    gj, gt = _graphs(lr)
    save = str(tmp_path / "best.zip")
    cfg = dict(patience=dict(max_epochs=50, patience=2),
               max_epochs=dict(max_epochs=6, patience=5, save_path=save),
               max_score=dict(max_epochs=10, max_score=1e-12),
               nan_score=dict(max_epochs=10, max_score=100.0))[case]
    score_fn = (lambda g: float("nan")) if case == "nan_score" else None
    out = []
    for ES, DataSet, g in ((ESJ, CSVJ.DataSet, gj), (EST, CSVT.DataSet, gt)):
        tr, va = _iters(DataSet, x, y, xv, yv)
        out.append(ES.EarlyStoppingGraphTrainer(
            g, tr, None if score_fn else va, ES.EarlyStoppingConfig(**cfg),
            score_fn=score_fn).fit())
    rj, rt = out
    assert rt.reason == rj.reason == case
    assert (rt.best_epoch, rt.total_epochs) == (rj.best_epoch,
                                                rj.total_epochs)
    if np.isfinite(rj.best_score):
        assert rt.best_score == pytest.approx(rj.best_score, rel=SCORE_RTOL)
    _assert_params_close(gj, gt)
    if case == "max_epochs":
        assert gt.score_on(xv, yv) == pytest.approx(rt.best_score, rel=1e-6)
        back = serialization.read_model(save, "cpu")
        assert back.score_on(xv, yv) == pytest.approx(rt.best_score,
                                                      rel=1e-6)


# -- compat/nd4j.py ---------------------------------------------------------------------

def test_nd4j_is_the_jax_shim_call_for_call():
    """Every covered call, in both shims from the same seeds: the same
    arrays, the same in-place / copy semantics."""
    out = []
    for N in (NJ.Nd4j, NT.Nd4j):
        N.setDataType("float")
        N.getRandom().setSeed(666)
        z = N.rand(200, 2).muli(2).subi(1)
        same = z.addi(0.0)
        assert same is z
        soft = N.ones(50, 1).add(N.randn(50, 1).muli(0.05))
        row = N.linspace(-1, 1, 10)
        grid = N.vstack([row, row.mul(2), row.div(4).sub(1)])
        c = N.create([[1, 2], [3, 4]]).dup().transpose().reshape(4, 1)
        c.putScalar((1, 0), 9.5)
        N.getMemoryManager().setAutoGcWindow(5000)
        out.append([a.data() for a in (z, soft, row, grid, c)]
                   + [grid.shape(), grid.rows(), grid.columns(),
                      grid.length(), c.getDouble(1, 0), z.getDouble(3, 1),
                      N.zeros(2, 3).data(), N.ones((2, 2)).data()])
    for a, b in zip(*out):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert NT.Nd4j.getBackend() == (
        "torch-cuda" if torch.cuda.is_available() else "torch-cpu")


def test_nd4j_wrappers_feed_the_port_graph():
    """An INDArray passes into ``fit`` / ``score_on`` through
    ``__array__``."""
    _, gt = _graphs()
    NT.Nd4j.getRandom().setSeed(666)
    x = NT.Nd4j.rand(8, 4)
    y = NT.Nd4j.ones(8, 1)
    loss = float(gt.fit(np.asarray(x), np.asarray(y)))
    assert np.isfinite(loss) and np.isfinite(gt.score_on(x.data(),
                                                         y.data()))
    assert torch.as_tensor(np.asarray(x)).shape == (8, 4)
