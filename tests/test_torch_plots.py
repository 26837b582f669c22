"""The grid and lattice PNGs (``eval/plots.py``) held against the JAX
package's renderers' arrays on the CPU: the mosaics equal to the JAX
``tile_grid`` output (exactly), each PNG decoded with ``zlib``
(``read_png``) equal to the uint8 image its function says it writes
(exactly), the single-lattice pair's layout, non-finite values drawn
white, and both programs writing the reference's four files at a few
iterations."""

import os

import numpy as np
import pytest

from gan_deeplearning4j_tpu.eval import plots as PJ
from gan_deeplearning4j_tpu_torch.eval import plots as PT
from gan_deeplearning4j_tpu_torch.train import cv_main, insurance_main


@pytest.mark.parametrize("n,shape", [(100, (28, 28)), (2500, (4, 3)),
                                     (9, (4, 3))])
def test_the_mosaic_is_the_jax_tile_grid(n, shape):
    rows = np.random.RandomState(n).rand(n, shape[0] * shape[1]).astype(
        np.float32)
    edge = int(round(np.sqrt(n)))
    want = PJ.tile_grid(rows.reshape(n, *shape), edge, edge)
    got = PT.grid_mosaic(rows, shape)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n,shape", [(100, (28, 28)), (2500, (4, 3))])
def test_the_grid_png_decodes_to_the_blown_up_mosaic(tmp_path, n, shape):
    """The PNG is the mosaic over its own range, blown up by the integer
    factor ``grid_scale`` (4 at both of the programs' grids); a pixel of
    each block is the block's value."""
    rows = np.random.RandomState(1).rand(n, shape[0] * shape[1])
    path = PT.save_grid_png(str(tmp_path / "g.png"), rows, shape)
    img = PT.read_png(path)
    assert np.array_equal(img, PT.grid_image(rows, shape))
    mosaic = PT.grid_mosaic(rows, shape)
    k = PT.grid_scale(mosaic)
    assert k == 4 and img.shape == (mosaic.shape[0] * k, mosaic.shape[1] * k)
    assert np.array_equal(img[::k, ::k], PT.to_u8(PT.normalize(mosaic)))


def test_the_lattice_pair_shows_the_lattice(tmp_path):
    """The raw PNG is the lattice's gray blow-up; the plotted PNG's heat
    cells are viridis of the lattice over its range (read between the
    digits, at each cell's corner), its colour bar runs from the top of
    the map down, and white digits sit in every cell."""
    grid = np.random.RandomState(2).randn(2500, 12) * 0.3
    raw_p, plot_p = PT.save_lattice_example_pngs(
        str(tmp_path / "raw.png"), str(tmp_path / "plot.png"), grid, (4, 3))
    raw, plotted = PT.read_png(raw_p), PT.read_png(plot_p)
    want_raw, want_plot = PT.lattice_images(grid, (4, 3))
    assert np.array_equal(raw, want_raw) and np.array_equal(plotted, want_plot)
    lattice = grid[0].reshape(4, 3)
    c = PT.LATTICE_CELL
    assert raw.shape == (4 * c, 3 * c)
    assert np.array_equal(raw[::c, ::c], PT.to_u8(PT.normalize(lattice)))
    heat = PT.VIRIDIS[PT.to_u8(PT.normalize(lattice))]
    assert np.array_equal(plotted[:4 * c:c, :3 * c:c], heat)
    bar = plotted[:, 3 * c + c // 4]
    assert np.array_equal(bar[0], PT.VIRIDIS[255])
    assert np.array_equal(bar[-1], PT.VIRIDIS[0])
    for i in range(4):
        for j in range(3):
            block = plotted[i * c:(i + 1) * c, j * c:(j + 1) * c]
            assert (block == 255).all(axis=-1).any(), (i, j)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_non_finite_values_are_drawn_white(tmp_path, bad):
    """A diverged run's dump: the non-finite cells are white in both
    lattice PNGs and in the grid, with their label ("nan", "inf", "-inf")
    in black; the finite cells keep the scale of the finite values."""
    grid = np.random.RandomState(3).randn(25, 12) * 0.3
    grid[0, [1, 7]] = bad
    raw_p, plot_p = PT.save_lattice_example_pngs(
        str(tmp_path / "raw.png"), str(tmp_path / "plot.png"), grid, (4, 3))
    raw, plotted = PT.read_png(raw_p), PT.read_png(plot_p)
    lattice = grid[0].reshape(4, 3)
    ok = np.isfinite(lattice)
    c = PT.LATTICE_CELL
    unit = PT.normalize(lattice)
    assert np.isnan(unit[~ok]).all()
    lo, hi = lattice[ok].min(), lattice[ok].max()
    np.testing.assert_array_equal(unit[ok], (lattice[ok] - lo) / (hi - lo))
    assert (raw[::c, ::c][~ok] == 255).all()
    assert np.array_equal(raw[::c, ::c][ok], PT.to_u8(unit[ok]))
    corners = plotted[:4 * c:c, :3 * c:c]
    assert (corners[~ok] == 255).all()
    assert np.array_equal(corners[ok], PT.VIRIDIS[PT.to_u8(unit[ok])])
    for i, j in zip(*np.nonzero(~ok)):
        block = plotted[i * c:(i + 1) * c, j * c:(j + 1) * c]
        assert (block == 0).all(axis=-1).any(), (i, j)
    img = PT.read_png(PT.save_grid_png(str(tmp_path / "g.png"), grid, (4, 3)))
    assert np.array_equal(img, PT.grid_image(grid, (4, 3)))
    mosaic = PT.grid_mosaic(grid, (4, 3))
    k = PT.grid_scale(mosaic)
    assert (img[::k, ::k][~np.isfinite(mosaic)] == 255).all()


def test_read_png_refuses_a_damaged_file(tmp_path):
    """``read_png`` checks each chunk's CRC and the 8-bit filter-0 rows
    ``png_bytes`` writes."""
    good = PT.png_bytes(np.arange(12, dtype=np.uint8).reshape(3, 4))
    path = tmp_path / "a.png"
    path.write_bytes(good)
    assert np.array_equal(PT.read_png(str(path)),
                          np.arange(12, dtype=np.uint8).reshape(3, 4))
    bad = bytearray(good)
    bad[20] ^= 1  # a bit of IHDR's width: its CRC no longer holds
    path.write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        PT.read_png(str(path))
    path.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        PT.read_png(str(path))


def test_viridis_is_matplotlibs():
    matplotlib = pytest.importorskip("matplotlib")
    want = np.floor(np.asarray(matplotlib.colormaps["viridis"](
        np.arange(256))[:, :3]) * 255 + 0.5).astype(np.uint8)
    assert np.array_equal(PT.VIRIDIS, want)


def test_the_programs_write_the_four_pngs(tmp_path):
    """``cv_main`` and ``insurance_main`` at a few iterations on the CPU:
    ``DCGAN_Generated_Images.png`` shows the last grid dump's mosaic, the
    three insurance PNGs the last lattice dump's."""
    d = str(tmp_path / "cv")
    cv_main.run(cv_main.parse_args([
        "--device", "cpu", "--iterations", "2", "--batch-size", "8",
        "--n-train", "32", "--n-test", "16", "--print-every", "2",
        "--save-every", "2", "--fid-samples", "0", "--res-path", d]))
    img = PT.read_png(os.path.join(d, "DCGAN_Generated_Images.png"))
    assert np.array_equal(img, PT.grid_image(
        os.path.join(d, "mnist_out_2.csv"), (28, 28)))
    d = str(tmp_path / "ins")
    insurance_main.run(insurance_main.parse_args([
        "--device", "cpu", "--iterations", "2", "--batch-size", "10",
        "--print-every", "2", "--save-every", "2", "--res-path", d]))
    dump = os.path.join(d, "insurance_out_2.csv")
    assert np.array_equal(
        PT.read_png(os.path.join(d, "DCGAN_Generated_Lattices.png")),
        PT.grid_image(dump, (4, 3)))
    raw, plotted = PT.lattice_images(dump, (4, 3))
    assert np.array_equal(PT.read_png(os.path.join(
        d, "DCGAN_Generated_Lattice_Example.png")), raw)
    assert np.array_equal(PT.read_png(os.path.join(
        d, "DCGAN_Generated_Lattice_Example_Plotted.png")), plotted)
