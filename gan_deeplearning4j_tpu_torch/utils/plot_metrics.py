"""Loss-curve rendering from a run's metrics JSONL (torch twin of
``gan_deeplearning4j_tpu/utils/plot_metrics.py``).

``read_metrics`` and ``load_event_markers`` are the JAX functions' own
(the markers come from the sibling ``events.jsonl``, the port's
``telemetry/events.py``).  ``plot_losses`` and ``plot_telemetry`` draw with
matplotlib where it imports, as the JAX package does; where it does not
(the card's host has none) they draw the same series and markers with the
port's stdlib PNG writer (``eval/plots.py`` ``png_bytes``): a raster plot
without text, each series a polyline in its colour, each marker a dashed
vertical line.  The two renderers differ in pixels, not in data.

Run: ``python -m gan_deeplearning4j_tpu_torch.utils.plot_metrics
outputs/computer_vision/mnist_metrics.jsonl``
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from gan_deeplearning4j_tpu_torch.eval.plots import png_bytes
from gan_deeplearning4j_tpu_torch.telemetry.events import (
    EVENTS_NAME,
    marker_records,
    read_events,
)

# fixed categorical assignment (identity never depends on position in the
# file): the JAX module's colours
_SERIES_COLORS = {
    "d_loss": "#2a78d6",
    "g_loss": "#eb6834",
    "classifier_loss": "#1baf7a",
}
_FALLBACK_COLORS = ["#eda100", "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_NAN_COLOR = "#e34948"
RENDERERS = ("matplotlib", "png")


def read_metrics(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def load_event_markers(metrics_jsonl: str) -> List[Dict]:
    """Step-anchored run events for overlay: when an ``events.jsonl`` sits
    next to the metrics file, its marker-vocabulary events (checkpoint
    saves, emergency saves, preemption, recovery restarts, NaN alarms) as
    ``[{"step", "name", "label", "color"}]``; [] when absent or empty."""
    path = os.path.join(os.path.dirname(os.path.abspath(metrics_jsonl)),
                        EVENTS_NAME)
    if not os.path.exists(path):
        return []
    return marker_records(read_events(path))


def _smoothed(vals: np.ndarray, smooth: int) -> np.ndarray:
    """Centered moving average over ``smooth`` steps, normalized at the
    edges by the window actually present (the JAX module's)."""
    w = max(1, min(smooth, len(vals)))
    if w == 1:
        return vals
    kernel = np.ones(w)
    return (np.convolve(vals, kernel, mode="same")
            / np.convolve(np.ones_like(vals), kernel, mode="same"))


def _step_records(metrics_jsonl: str) -> List[Dict]:
    # step records only: the feed also carries step-less run-level records
    # (the goodput breakdown)
    return [r for r in read_metrics(metrics_jsonl) if "step" in r]


def _renderer(renderer: Optional[str]) -> str:
    if renderer is not None:
        if renderer not in RENDERERS:
            raise ValueError(f"renderer must be one of {RENDERERS}, got "
                             f"{renderer!r}")
        return renderer
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return "png"
    return "matplotlib"


# -- the stdlib raster -----------------------------------------------------------

_W, _H, _PAD = 960, 540, 24


def _rgb(color: str) -> np.ndarray:
    return np.array([int(color[i:i + 2], 16) for i in (1, 3, 5)], np.uint8)


def _line(img, x0, y0, x1, y1, color) -> None:
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.rint(np.linspace(x0, x1, n)).astype(int)
    ys = np.rint(np.linspace(y0, y1, n)).astype(int)
    ok = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[ok], xs[ok]] = color


def _raster_panel(img, top: int, height: int, steps: np.ndarray,
                  series, log: bool, markers, bad) -> None:
    """One panel of ``img`` rows [top, top + height): a frame, the
    series as polylines (NaN gaps broken), the markers and the NaN steps as
    vertical lines."""
    x0, x1 = _PAD, img.shape[1] - _PAD
    y0, y1 = top + _PAD, top + height - _PAD
    frame = _rgb("#888888")
    for yy in (y0, y1):
        _line(img, x0, yy, x1, yy, frame)
    for xx in (x0, x1):
        _line(img, xx, y0, xx, y1, frame)
    ys = [np.log10(v) if log else v for _, v, _ in series]
    finite = np.concatenate([y[np.isfinite(y)] for y in ys] or [np.zeros(0)])
    lo, hi = (finite.min(), finite.max()) if finite.size else (0.0, 1.0)
    if hi <= lo:
        lo, hi = lo - 0.5, hi + 0.5
    s_lo, s_hi = float(steps.min()), float(steps.max())
    if s_hi <= s_lo:
        s_hi = s_lo + 1.0

    def px(step):
        return x0 + (step - s_lo) / (s_hi - s_lo) * (x1 - x0)

    def py(v):
        return y1 - (v - lo) / (hi - lo) * (y1 - y0)

    def vline(step, color, dash) -> None:
        x = int(round(px(step)))
        for yy in range(y0, y1, dash * 2):
            _line(img, x, yy, x, min(yy + dash, y1), color)

    for step in bad[:50]:
        vline(step, _rgb(_NAN_COLOR), 2)
    for m in markers:
        vline(m["step"], _rgb(m["color"]), 4)
    for (_, _, color), y in zip(series, ys):
        c = _rgb(color)
        for i in range(1, len(y)):
            if np.isfinite(y[i - 1]) and np.isfinite(y[i]):
                _line(img, px(steps[i - 1]), py(y[i - 1]), px(steps[i]),
                      py(y[i]), c)


def _write_raster(out_png: str, steps: np.ndarray, panels, markers,
                  bad=()) -> str:
    img = np.full((_H, _W, 3), 255, np.uint8)
    height = _H // len(panels)
    for i, (series, log) in enumerate(panels):
        _raster_panel(img, i * height, height, steps, series, log, markers,
                      list(bad))
    with open(out_png, "wb") as f:
        f.write(png_bytes(img))
    return out_png


# -- matplotlib (the JAX module's drawing) ------------------------------------------

def _overlay_markers(axes, markers) -> None:
    """Vertical marker lines on every axis, one legend entry per marker
    KIND."""
    seen = set()
    for m in markers:
        for i, ax in enumerate(axes):
            ax.axvline(m["step"], color=m["color"], alpha=0.55,
                       linewidth=1.0, linestyle="--",
                       label=(m["label"]
                              if i == 0 and m["label"] not in seen
                              else None))
        seen.add(m["label"])


def _style(ax) -> None:
    ax.grid(True, color="#dddddd", linewidth=0.6, alpha=0.6)
    for side in ("top", "right"):
        ax.spines[side].set_visible(False)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# -- the public functions --------------------------------------------------------------

def loss_series(metrics_jsonl: str, keys: Optional[Sequence[str]] = None,
                smooth: int = 1):
    """(steps, [(key, values, colour)]) that ``plot_losses`` draws:
    ``keys`` default to every ``*_loss`` key of the first step record."""
    records = _step_records(metrics_jsonl)
    if not records:
        raise ValueError(f"no step records in {metrics_jsonl}")
    if keys is None:
        keys = [k for k in records[0] if k.endswith("_loss")]
    steps = np.array([r["step"] for r in records])
    fallback = itertools.cycle(_FALLBACK_COLORS)
    series = []
    for key in keys:
        vals = np.array([r.get(key, np.nan) for r in records], dtype=float)
        color = _SERIES_COLORS.get(key) or next(fallback)
        series.append((key, _smoothed(vals, smooth), color))
    return steps, series


def plot_losses(metrics_jsonl: str, out_png: Optional[str] = None,
                keys: Optional[Sequence[str]] = None, smooth: int = 1,
                renderer: Optional[str] = None) -> str:
    """Render the loss curves of one run to ``out_png`` (default: next to
    the JSONL, ``*_losses.png``).  ``keys``: which scalar series (default:
    every ``*_loss`` key present); ``smooth``: centered moving-average
    window in steps (1 = raw); ``renderer``: ``"matplotlib"`` or
    ``"png"`` (default: matplotlib when it imports)."""
    steps, series = loss_series(metrics_jsonl, keys, smooth)
    markers = load_event_markers(metrics_jsonl)
    out_png = out_png or (os.path.splitext(metrics_jsonl)[0] + "_losses.png")
    if _renderer(renderer) == "png":
        return _write_raster(out_png, steps, [(series, False)], markers)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=120)
    for key, vals, color in series:
        ax.plot(steps, vals, color=color, linewidth=1.6, label=key)
    _overlay_markers([ax], markers)
    ax.set_xlabel("step")
    ax.set_ylabel("loss")
    ax.set_title(os.path.basename(metrics_jsonl))
    _style(ax)
    if len(series) > 1 or markers:
        ax.legend(frameon=False)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def telemetry_series(metrics_jsonl: str, smooth: int = 1):
    """(steps, norm series, ratio series, NaN steps) that
    ``plot_telemetry`` draws."""
    records = _step_records(metrics_jsonl)
    norm_keys = sorted({k for r in records for k in r
                        if k.endswith("_norm")})
    ratio_keys = sorted({k for r in records for k in r
                         if k.endswith("_ratio")})
    if not records or not (norm_keys or ratio_keys):
        raise ValueError(
            f"no telemetry columns in {metrics_jsonl} — was the run "
            "trained with --telemetry?")
    steps = np.array([r["step"] for r in records])
    colors = itertools.cycle(_FALLBACK_COLORS + list(_SERIES_COLORS.values()))

    def series(keys):
        return [(k, _smoothed(np.array([r.get(k, np.nan) for r in records],
                                       dtype=float), smooth), next(colors))
                for k in keys]

    norms, ratios = series(norm_keys), series(ratio_keys)
    # steps whose NaN/Inf counter fired or whose norms went non-finite
    bad = [r["step"] for r in records
           if r.get("nonfinite") or any(
               r.get(k) is not None and not np.isfinite(r.get(k, 0.0))
               for k in norm_keys if isinstance(r.get(k), float))]
    return steps, norms, ratios, bad


def plot_telemetry(metrics_jsonl: str, out_png: Optional[str] = None,
                   smooth: int = 1, renderer: Optional[str] = None) -> str:
    """Render the in-graph numerics telemetry of one run (grad / param
    norms on a log axis, update ratios below, NaN steps marked) to
    ``out_png`` (default: ``*_telemetry.png`` next to the JSONL)."""
    steps, norms, ratios, bad = telemetry_series(metrics_jsonl, smooth)
    markers = load_event_markers(metrics_jsonl)
    out_png = out_png or (
        os.path.splitext(metrics_jsonl)[0] + "_telemetry.png")
    if _renderer(renderer) == "png":
        return _write_raster(out_png, steps, [(norms, True), (ratios, True)],
                             markers, bad)
    plt = _pyplot()
    fig, (ax_n, ax_r) = plt.subplots(2, 1, figsize=(8, 7), dpi=120,
                                     sharex=True)
    for ax, series, label in ((ax_n, norms, "global L2 norm"),
                              (ax_r, ratios, "update ratio")):
        for key, vals, color in series:
            ax.plot(steps, vals, color=color, linewidth=1.4, label=key)
        ax.set_yscale("log")
        _style(ax)
        ax.legend(frameon=False, fontsize=8)
        ax.set_ylabel(label)
    ax_r.set_xlabel("step")
    _overlay_markers([ax_n, ax_r], markers)
    if markers:
        ax_n.legend(frameon=False, fontsize=8)
    for ax in (ax_n, ax_r):
        for s in bad[:50]:  # a fully diverged run would mark every step
            ax.axvline(s, color=_NAN_COLOR, alpha=0.35, linewidth=0.8)
    ax_n.set_title(os.path.basename(metrics_jsonl)
                   + (f" — first NaN at step {bad[0]}" if bad else ""))
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("metrics_jsonl")
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--keys", nargs="*", default=None,
                   help="series to draw (default: every *_loss)")
    p.add_argument("--smooth", type=int, default=1,
                   help="moving-average window in steps")
    p.add_argument("--telemetry", action="store_true",
                   help="render the numerics-telemetry panel (grad/param "
                        "norms, update ratios, NaN markers) instead of "
                        "the loss curves")
    args = p.parse_args(argv)
    if args.telemetry:
        out = plot_telemetry(args.metrics_jsonl, args.out, args.smooth)
    else:
        out = plot_losses(args.metrics_jsonl, args.out, args.keys,
                          args.smooth)
    print(out)
    return out


if __name__ == "__main__":
    main()
