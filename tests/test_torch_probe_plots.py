"""The port's device probe (``utils/probe.py``) and loss-curve plots
(``utils/plot_metrics.py``) on the CPU.  The plots' series and markers are
held to the JAX module's ``read_metrics`` / ``load_event_markers`` on the
same files; both renderers write a PNG that decodes.
"""

import io
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gan_deeplearning4j_tpu.utils import plot_metrics as PJ
from gan_deeplearning4j_tpu_torch.telemetry import events
from gan_deeplearning4j_tpu_torch.utils import plot_metrics as PT
from gan_deeplearning4j_tpu_torch.utils import probe


# -- the probe --------------------------------------------------------------------------

def test_probe_on_the_cpu_when_asked():
    """A caller that asks for the CPU gets a record from a child of its
    own: platform, device, a positive round trip, the child's wall."""
    rec = probe.probe(120.0, device="cpu")
    assert (rec["platform"], rec["device"], rec["count"]) == ("cpu", "cpu", 0)
    assert rec["rt_ms"] > 0 and rec["wall_s"] >= rec["rt_ms"] / 1e3


def test_probe_never_falls_back_to_the_cpu():
    """The default is the card: without one the probe fails, naming the
    missing card (through ``probe_with_retry`` -> ``probe_device`` ->
    ``probe``, one child); with one it reports the card."""
    if torch.cuda.is_available():
        assert probe.probe_with_retry(120.0, attempts=1)[0] == "gpu"
        return
    with pytest.raises(RuntimeError,
                       match="attempt 1: device probe failed: .*no CUDA "
                             "device"):
        probe.probe_with_retry(120.0, attempts=1, backoff_s=0.0)
    with pytest.raises(ValueError):
        probe.probe(1.0, device="tpu")


def test_a_hung_probe_is_killed_not_the_caller():
    """A child that cannot answer within the timeout is killed and the
    caller gets a one-line reason, in bounded time."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="unresponsive"):
        probe.probe(0.05, device="cpu")
    assert time.monotonic() - t0 < 30


# -- the plots ---------------------------------------------------------------------------

@pytest.fixture
def run_dir(tmp_path):
    """A run's metrics JSONL (step records with losses and telemetry
    columns, one NaN step, a trailing goodput record) and its events.jsonl
    (checkpoint saves, a NaN alarm, a rollback restore, a non-marker
    event)."""
    metrics = tmp_path / "mnist_metrics.jsonl"
    rng = np.random.RandomState(0)
    with open(metrics, "w") as f:
        for step in range(1, 41):
            rec = {"step": step, "wall_s": step * 0.1, "step_s": 0.1,
                   "classifier_loss": float(1.0 / step),
                   "d_loss": float(0.7 + 0.1 * rng.rand()),
                   "g_loss": float(0.7 + 0.1 * rng.rand()),
                   "d_grad_norm": float(1 + rng.rand()),
                   "g_param_norm": float(10 + rng.rand()),
                   "d_update_ratio": float(1e-3 * (1 + rng.rand())),
                   "nonfinite": 1.0 if step == 17 else 0.0}
            if step == 17:
                rec["d_grad_norm"] = float("nan")
            f.write(json.dumps(rec) + "\n")
        f.write(json.dumps({"goodput": {"wall_s": 4.0}, "run_id": "r"})
                + "\n")
    with events.EventRecorder(path=str(tmp_path / events.EVENTS_NAME)) as rec:
        for step in (10, 20, 30):
            rec.instant("checkpoint.save", step=step)
        rec.instant("alarm.nan", step=17)
        rec.instant("rollback.restore", step=10)
        rec.instant("data.prepare", step=0)
    return str(metrics)


def test_series_and_markers_are_the_jax_ones(run_dir):
    """``read_metrics`` and ``load_event_markers`` return the JAX
    functions' records for the same files; the loss series are every
    ``*_loss`` key of the step records, in their colours."""
    assert PT.read_metrics(run_dir) == PJ.read_metrics(run_dir)
    markers = PT.load_event_markers(run_dir)
    assert markers == PJ.load_event_markers(run_dir)
    assert [(m["step"], m["label"]) for m in markers] == [
        (10, "checkpoint"), (20, "checkpoint"), (30, "checkpoint"),
        (17, "nan alarm"), (10, "rollback")]
    steps, series = PT.loss_series(run_dir)
    assert steps.tolist() == list(range(1, 41))
    assert [(k, c) for k, _, c in series] == [
        ("classifier_loss", "#1baf7a"), ("d_loss", "#2a78d6"),
        ("g_loss", "#eb6834")]
    recs = [r for r in PJ.read_metrics(run_dir) if "step" in r]
    np.testing.assert_array_equal(series[1][1], [r["d_loss"] for r in recs])
    _, norms, ratios, bad = PT.telemetry_series(run_dir)
    assert [k for k, _, _ in norms] == ["d_grad_norm", "g_param_norm"]
    assert [k for k, _, _ in ratios] == ["d_update_ratio"]
    assert bad == [17]


def _decode(path):
    with open(path, "rb") as f:
        img = Image.open(io.BytesIO(f.read()))
        img.load()
    return img


@pytest.mark.parametrize("renderer", ["matplotlib", "png"])
def test_both_renderers_write_a_png_that_decodes(run_dir, tmp_path,
                                                 renderer):
    """The default path is ``*_losses.png`` beside the JSONL; the stdlib
    raster carries each series' colour and each marker's; the telemetry
    panel renders too."""
    out = PT.plot_losses(run_dir, smooth=5, renderer=renderer)
    assert out == run_dir[:-len(".jsonl")] + "_losses.png"
    img = _decode(out).convert("RGB")
    assert img.size[0] > 100 and img.size[1] > 100
    if renderer == "png":
        colours = {c for _, c in img.getcolors(1 << 16)}
        for hexc in ("#1baf7a", "#2a78d6", "#eb6834", "#e34948", "#8338ec"):
            rgb = tuple(int(hexc[i:i + 2], 16) for i in (1, 3, 5))
            assert rgb in colours, hexc
    tel = PT.plot_telemetry(run_dir, str(tmp_path / f"tel_{renderer}.png"),
                            renderer=renderer)
    assert _decode(tel).size[0] > 100


def test_the_cli_and_the_errors(run_dir, tmp_path, capsys):
    out = PT.main([run_dir, "--out", str(tmp_path / "cli.png"),
                   "--keys", "d_loss"])
    assert capsys.readouterr().out.strip() == out
    assert _decode(out).size[0] > 100
    empty = tmp_path / "empty_metrics.jsonl"
    empty.write_text(json.dumps({"goodput": {}}) + "\n")
    with pytest.raises(ValueError, match="no step records"):
        PT.plot_losses(str(empty), renderer="png")
    plain = tmp_path / "plain_metrics.jsonl"
    plain.write_text(json.dumps({"step": 1, "d_loss": 1.0}) + "\n")
    with pytest.raises(ValueError, match="--telemetry"):
        PT.plot_telemetry(str(plain), renderer="png")
    with pytest.raises(ValueError, match="renderer"):
        PT.plot_losses(run_dir, renderer="svg")
    assert os.path.exists(run_dir)
