"""Bounded device probe (torch twin of ``gan_deeplearning4j_tpu/utils/
probe.py``) for the entry points that must not hang.

A wedged card can block the first CUDA call of a process for
good, so a caller that must not hang probes from a FRESH child interpreter
under a timeout: the child initializes CUDA, runs one small dispatch and
its readback, and prints one JSON line with the device and the round trip.
On timeout the child is killed, never the caller.  The probe never falls
back to the CPU: without a card it fails with an error that says so.  A
caller that wants the CPU asks for it (``device="cpu"``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Dict, Optional

# One 64x64 matmul and its readback, then five timed round trips; prints
# one JSON line.  The child imports torch only.
_PROBE_CODE = """
import json, sys, time
import torch
kind = sys.argv[1]
if kind == "cuda" and not torch.cuda.is_available():
    sys.exit("no CUDA device: torch.cuda.is_available() is false "
             "(the probe does not fall back to the CPU)")
dev = torch.device(kind)
x = torch.ones((64, 64), device=dev)
(x @ x).cpu()
t0 = time.perf_counter()
for _ in range(5):
    (x @ x).cpu()
rt_ms = (time.perf_counter() - t0) * 200
print(json.dumps({
    "platform": "gpu" if kind == "cuda" else "cpu",
    "device": torch.cuda.get_device_name(0) if kind == "cuda" else "cpu",
    "count": torch.cuda.device_count() if kind == "cuda" else 0,
    "rt_ms": rt_ms}))
"""


def probe(timeout_s: float, cwd: Optional[str] = None,
          device: str = "cuda") -> Dict:
    """The child's record (``platform``, ``device``, ``count``, ``rt_ms``,
    plus ``wall_s``: the child's whole life, interpreter start-up and CUDA
    initialization included), or RuntimeError with a one-line reason."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-c", _PROBE_CODE, device],
                             cwd=cwd, capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        raise RuntimeError(
            f"device unresponsive (>{timeout_s:.0f}s for a 64x64 "
            "dispatch and readback); the probe child was killed") from None
    if out.returncode != 0:
        tail = " | ".join(out.stderr.strip().splitlines()[-2:])
        raise RuntimeError(f"device probe failed: {tail[-400:]}")
    try:
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        rec["rt_ms"] = float(rec["rt_ms"])
    except (ValueError, KeyError, IndexError):
        raise RuntimeError(
            f"unparseable probe output: {out.stdout[-200:]!r}") from None
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def probe_device(timeout_s: float, cwd: Optional[str] = None,
                 device: str = "cuda"):
    """(platform, round_trip_ms) via the bounded child, or RuntimeError
    with a one-line reason (the JAX function's return)."""
    rec = probe(timeout_s, cwd=cwd, device=device)
    return rec["platform"], rec["rt_ms"]


def probe_with_retry(timeout_s: float, cwd: Optional[str] = None,
                     attempts: int = 3, backoff_s: float = 45.0,
                     log=None, device: str = "cuda"):
    """``probe_device`` with bounded retry and backoff.  Returns
    (platform, rt_ms) or raises RuntimeError carrying every attempt's
    reason."""
    reasons = []
    for attempt in range(1, attempts + 1):
        try:
            platform, rt_ms = probe_device(timeout_s, cwd=cwd, device=device)
            if log:
                log(f"probe ok (attempt {attempt}): platform={platform} "
                    f"round-trip {rt_ms:.1f}ms")
            return platform, rt_ms
        except RuntimeError as e:
            reasons.append(f"attempt {attempt}: {e}")
            if log:
                log(reasons[-1])
            if attempt < attempts:
                if log:
                    log(f"backing off {backoff_s:.0f}s before re-probe")
                time.sleep(backoff_s)
    raise RuntimeError("; ".join(reasons))
