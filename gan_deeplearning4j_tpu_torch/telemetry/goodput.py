"""Goodput accounting: where every wall-clock second of a run went (torch
twin of ``gan_deeplearning4j_tpu/telemetry/goodput.py``, stdlib only).

A ``GoodputTimer`` attributes the training thread's wall time to named
phases:

  data_wait   blocking on the data pipeline (the CSV files, their decode
              and upload, a streamed chunk's staging)
  dispatch    launching the step: a CUDA graph's replay, or the eager
              step's kernel launches (the first call pays the warm-up)
  readback    the one synchronization a call makes (its losses to the
              host), and the metrics logger's last flush
  checkpoint  checkpoint save/restore and the model zips
  eval        artifact dumps (latent grids, prediction CSVs)
  other       everything unattributed (host bookkeeping, logging, the
              Python loop itself)

``other`` is the complement of the attributed phases within total wall
time, so the breakdown always sums to the measured wall.  The device runs
asynchronously: ``dispatch`` is the host's time to launch work, and the
device time it launched shows up in the next synchronization, ``readback``
(or in whichever phase synchronizes first).  Host-side attribution is
therefore a LOWER bound on the device's idle time, not a measure of it;
the profiler (``utils/profiling.py``) sees the device.

Alongside the per-phase seconds, ``report()`` carries ``phase_n``: how many
times each phase was entered, so ``checkpoint / phase_n["checkpoint"]`` is
the blocking seconds per save.  Phases never entered are omitted there.

``write_run_manifest`` writes ``run_manifest.json``: run id, config, the
loaded torch / CUDA / cuDNN / driver versions, the data group's rank and
world, and the card, so metrics JSONLs can name the software and topology
a number was measured under.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import uuid
from contextlib import contextmanager
from typing import Dict, Optional

# the phase vocabulary; every phase also gets an entry count in the
# report's ``phase_n`` map (entered-at-least-once phases only)
PHASES = ("data_wait", "dispatch", "readback", "checkpoint", "eval")


class GoodputTimer:
    """Accumulating phase timer for one run, on one thread (the training
    thread; the async workers' time is by design not goodput-relevant).

    Host arithmetic only: ``phase()`` costs two ``perf_counter`` reads and
    never touches the device.  Phases may nest (a checkpoint inside an
    ``eval`` block): the inner phase claims its own time and the outer one
    the remainder, so no second is counted twice."""

    def __init__(self):
        self._t0 = time.perf_counter()
        self._acc: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._n: Dict[str, int] = {p: 0 for p in PHASES}
        self._stack = []  # [phase_name, start, inner_time] frames

    @contextmanager
    def phase(self, name: str):
        if name not in self._acc:
            raise ValueError(f"unknown goodput phase {name!r}; "
                             f"one of {PHASES}")
        start = time.perf_counter()
        self._stack.append([name, start, 0.0])
        try:
            yield
        finally:
            _, _, inner = self._stack.pop()
            elapsed = time.perf_counter() - start
            self._acc[name] += elapsed - inner
            self._n[name] += 1
            if self._stack:  # the outer frame's inner-time ledger
                self._stack[-1][2] += elapsed

    def report(self) -> Dict[str, float]:
        """Breakdown so far: per-phase seconds, ``other``, ``wall_s``
        (their sum), ``compute_fraction`` (dispatch's share of wall) and
        the ``phase_n`` entry counts."""
        wall = time.perf_counter() - self._t0
        phases = {p: round(t, 6) for p, t in self._acc.items()}
        attributed = sum(phases.values())
        phases["other"] = round(max(0.0, wall - attributed), 6)
        return {
            **phases,
            "wall_s": round(wall, 6),
            "compute_fraction": round(
                phases["dispatch"] / wall if wall > 0 else 0.0, 4),
            "phase_n": {p: n for p, n in self._n.items() if n},
        }


def _driver_version() -> str:
    """The NVIDIA driver's release, as NVML reports it ("unknown" where
    the library is absent or answers with an error)."""
    import ctypes

    try:
        nvml = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return "unknown"
    if nvml.nvmlInit_v2() != 0:
        return "unknown"
    try:
        buf = ctypes.create_string_buffer(96)
        if nvml.nvmlSystemGetDriverVersion(buf, len(buf)) != 0:
            return "unknown"
        return buf.value.decode() or "unknown"
    finally:
        nvml.nvmlShutdown()


def versions() -> Dict[str, str]:
    """torch, its CUDA and cuDNN versions, and the driver's, as loaded
    (lookup failures give "unknown", never raise)."""
    out = {}
    try:
        import torch

        out["torch"] = torch.__version__
        out["cuda"] = torch.version.cuda or "unknown"
        cudnn = torch.backends.cudnn.version()
        out["cudnn"] = str(cudnn) if cudnn else "unknown"
    except Exception:
        out.setdefault("torch", "unknown")
        out.setdefault("cuda", "unknown")
        out.setdefault("cudnn", "unknown")
    out["driver"] = _driver_version()
    return out


def _devices(device=None) -> Optional[Dict]:
    """The run's device: the CPU when ``device`` is one, else the card,
    read from an ALREADY initialized CUDA context only: this must never be
    the call that first touches the device."""
    if device is not None and getattr(device, "type", device) == "cpu":
        return {"count": 1, "platform": "cpu", "kind": "cpu"}
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_initialized():
            return None
        return {"count": torch.cuda.device_count(), "platform": "gpu",
                "kind": torch.cuda.get_device_name()}
    except Exception:
        return None


def write_run_manifest(res_path: str, config=None,
                       mesh: Optional[Dict[str, int]] = None, group=None,
                       device=None, extra: Optional[Dict] = None) -> Dict:
    """Write ``res_path/run_manifest.json`` and return its payload
    (callers key their metrics records on ``run_id``).

    ``config``: a dataclass (``asdict``-ed) or a plain dict, of which the
    scalar fields are kept; ``mesh``: the data-parallel axes and their
    sizes (``{"data": world}``), None on one device; ``group``: the data
    group (``parallel/mesh.DataGroup``), whose rank and world are
    ``process_index`` / ``process_count`` (0 and 1 without one);
    ``device``: the run's torch device (``devices`` names the card, or the
    CPU for a CPU run)."""
    manifest: Dict = {
        "run_id": uuid.uuid4().hex[:12],
        "unix_time": int(time.time()),
        "versions": versions(),
    }
    if config is not None:
        cfg = (dataclasses.asdict(config)
               if dataclasses.is_dataclass(config) else dict(config))
        manifest["config"] = {
            k: v for k, v in cfg.items()
            if isinstance(v, (int, float, str, bool, type(None)))}
    if mesh is not None:
        manifest["mesh"] = {str(k): int(v) for k, v in dict(mesh).items()}
    manifest["process_index"] = group.rank if group is not None else 0
    manifest["process_count"] = group.world if group is not None else 1
    devices = _devices(device)
    if devices is not None:
        manifest["devices"] = devices
    if extra:
        manifest.update(extra)
    path = os.path.join(res_path, "run_manifest.json")
    try:
        os.makedirs(res_path, exist_ok=True)
        with open(path, "w") as f:
            json.dump(manifest, f, indent=1)
        manifest["path"] = path
    except OSError:  # a read-only res dir: the payload still flows
        pass
    return manifest
