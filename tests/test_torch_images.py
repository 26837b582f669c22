"""The port's image reader (``data/images.py``) against the JAX package's,
and ``roadmap_main --data-dir`` on the CPU.

The images are PNGs written here with the port's stdlib PNG writer
(``eval/plots.png_bytes``) at sizes other than the families', so both
readers decode and resize them with PIL.

Covered: flat folders and class subdirectories (a stray file and a
subdirectory without images ignored, the classes interleaved under
``limit``), grayscale and RGB, [0, 1] and the tanh range, flattened and
NCHW: the arrays byte-equal, the same labels and class names; no images
raise alike; a missing PIL names ``--data-dir``; ``roadmap_main
--data-dir`` (refused before it was ported) for 2 iterations of celeba
(flat) and cgan-cifar10 (3 class subdirectories: a 3-wide label input).
"""

import json
import os
import sys

import numpy as np
import pytest

from gan_deeplearning4j_tpu.data.images import ImageRecordReader as ReaderJ
from gan_deeplearning4j_tpu_torch.data.images import (
    ImageRecordReader as ReaderT,
)
from gan_deeplearning4j_tpu_torch.eval.plots import png_bytes
from gan_deeplearning4j_tpu_torch.train import roadmap_main as RM


def _write(path, rng, h, w, gray):
    img = rng.randint(0, 256, (h, w) if gray else (h, w, 3)).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def _flat(root, n, rng, gray=False):
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        _write(os.path.join(root, f"img_{i:02d}.png"), rng, 20 + i % 3,
               17 + i % 5, gray and i % 2 == 0)
    # neither an image nor a class: both readers skip them
    open(os.path.join(root, "notes.txt"), "w").close()
    os.makedirs(os.path.join(root, ".thumbnails"), exist_ok=True)
    return str(root)


def _classes(root, per_class, rng):
    for c, n in zip(("cat", "dog", "emu"), per_class):
        _flat(os.path.join(root, c), n, rng)
    return str(root)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    rng = np.random.RandomState(3)
    base = tmp_path_factory.mktemp("images")
    return {"flat": _flat(base / "flat", 7, rng, gray=True),
            "classes": _classes(base / "classes", (4, 2, 3), rng)}


@pytest.mark.parametrize("layout", ["flat", "classes"])
@pytest.mark.parametrize("channels,tanh", [(1, False), (3, True)])
@pytest.mark.parametrize("limit,flatten", [(None, True), (5, False)])
def test_reader_matches_jax(folders, layout, channels, tanh, limit, flatten):
    root = folders[layout]
    xj, lj, cj = ReaderJ(12, 10, channels, tanh).read_folder(
        root, flatten=flatten, limit=limit)
    xt, lt, ct = ReaderT(12, 10, channels, tanh).read_folder(
        root, flatten=flatten, limit=limit)
    assert xt.dtype == xj.dtype == np.float32 and xt.shape == xj.shape
    assert xt.tobytes() == xj.tobytes()
    assert ct == cj
    if layout == "flat":
        assert lj is None and lt is None and ct == []
    else:
        assert ct == ["cat", "dog", "emu"]
        assert lt.dtype == lj.dtype and np.array_equal(lt, lj)
    n = 7 if layout == "flat" else 9
    assert xt.shape[0] == (limit or n)
    lo = -1.0 if tanh else 0.0
    assert xt.min() >= lo and xt.max() <= 1.0


def test_reader_refuses_an_empty_folder_as_jax_does(tmp_path):
    for reader in (ReaderJ, ReaderT):
        with pytest.raises(FileNotFoundError, match="no images under"):
            reader(8, 8).read_folder(str(tmp_path))


def test_a_missing_pil_names_data_dir(folders, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="--data-dir"):
        ReaderT(8, 8).read_folder(folders["flat"])


@pytest.mark.parametrize("family,layout", [("celeba", "flat"),
                                           ("cgan-cifar10", "classes")])
def test_roadmap_main_reads_data_dir(tmp_path, folders, family, layout):
    """Two iterations at full width on the images of ``--data-dir``: the
    table is the reader's (``_data``), the conditional family's label
    width the class count, and the run writes its files."""
    x, y = RM._data(family, 100, 0, folders[layout])
    c, h, w = RM.SAMPLE_SHAPES[family]
    assert x.shape == ((9 if layout == "classes" else 7), c * h * w)
    if family == "cgan-cifar10":
        assert y.shape == (9, 3) and (y.sum(1) == 1).all()
    else:
        assert y is None
    result = RM.main(["--family", family, "--device", "cpu",
                      "--data-dir", folders[layout], "--iterations", "2",
                      "--batch-size", "4", "--print-every", "2",
                      "--fidelity-steps", "2", "--res-path", str(tmp_path)])
    assert result["steps"] == 2
    assert np.isfinite([result["d_loss"], result["g_loss"]]).all()
    assert (tmp_path / f"{family}_samples_2.png").exists()
    recs = [json.loads(l) for l in open(tmp_path / f"{family}_metrics.jsonl")]
    assert [r.get("step") for r in recs] == [1, 2, None]  # + goodput
    if family == "cgan-cifar10":
        assert len(result["fidelity_per_class"]) == 3
