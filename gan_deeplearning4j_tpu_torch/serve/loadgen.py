"""Synthetic open-loop load — the SLO measurement harness (torch twin of
``gan_deeplearning4j_tpu/serve/loadgen.py``, a copy: numpy and the stdlib
only).

Closed-loop load (submit, wait, submit) measures the SERVER's pace, not
the users': under overload a closed loop politely slows down with the
service and the latency numbers look fine right up to the cliff.  Real
traffic is open-loop — arrivals keep coming at their own rate whether
or not the service keeps up — so this harness schedules Poisson
arrivals on an ABSOLUTE timeline (seeded exponential gaps summed from
t0; a slow submit doesn't stretch the schedule, the loop just finds
itself behind and fires the backlog immediately, exactly like a real
arrival process) with a configurable request-size mix.

Memory is O(outstanding), not O(requests): completed requests are
reaped from the left of the outstanding deque every iteration and only
their latency (one float) is kept, so "millions of requests" is a
duration, not an allocation.

``run_load`` measures one rate; ``measure_saturation`` ramps the rate
geometrically until the service provably can't keep up (shed fraction
breaks, or the post-stage drain of in-flight work stops being bounded
— a growing backlog) and returns the last sustained rate — the
saturation headline, with p50/p95/p99 read at a chosen fraction of it.
"""

from __future__ import annotations

import random
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.serve.admission import ShedError

# the default request-size mix: mostly single-row lookups, a tail of
# batchy callers — enough shape diversity to exercise pad-up on every
# declared bucket without any size being oversized
DEFAULT_SIZE_MIX: Tuple[Tuple[int, float], ...] = (
    (1, 0.55), (4, 0.25), (16, 0.15), (48, 0.05))


def percentiles(samples: Sequence[float],
                qs: Sequence[float]) -> List[Optional[float]]:
    """Nearest-rank percentiles of ``samples`` (None per q when
    empty) — the one definition every latency number in the serving
    plane uses (engine report, load harness, bench)."""
    if not samples:
        return [None] * len(qs)
    s = sorted(samples)
    out: List[Optional[float]] = []
    for q in qs:
        rank = max(0, min(len(s) - 1, int(round(q / 100.0 * len(s))) - 1))
        out.append(float(s[rank]))
    return out


def z_inputs(dim: int, seed: int = 0,
             low: float = -1.0, high: float = 1.0
             ) -> Callable[[int], Tuple[np.ndarray]]:
    """Input factory for a generator taking one ``(rows, dim)`` latent:
    returns ``make_inputs(rows)`` serving seeded uniform noise from a
    per-size cache — O(1) memory and O(1) time per request no matter
    how many millions of requests the harness fires."""
    rng = np.random.RandomState(seed)
    cache: Dict[int, np.ndarray] = {}

    def make_inputs(rows: int) -> Tuple[np.ndarray]:
        z = cache.get(rows)
        if z is None:
            z = (rng.rand(rows, dim).astype(np.float32)
                 * (high - low) + low)
            cache[rows] = z
        return (z,)

    return make_inputs


def _reap(outstanding: deque, latencies: List[float]) -> int:
    """Pop completed requests off the FRONT of the FIFO (completion is
    FIFO too — the engine dispatches in admission order), keeping only
    their latency.  Returns the number of request-level errors seen."""
    errors = 0
    while outstanding and outstanding[0].done.is_set():
        r = outstanding.popleft()
        if r.error is not None:
            errors += 1
        elif r.latency_ms is not None:
            latencies.append(r.latency_ms)
    return errors


def run_load(engine, rate_rps: float,
             duration_s: Optional[float] = None,
             n_requests: Optional[int] = None,
             size_mix: Sequence[Tuple[int, float]] = DEFAULT_SIZE_MIX,
             make_inputs: Optional[Callable] = None,
             seed: int = 0,
             drain_timeout_s: float = 60.0) -> Dict:
    """Fire open-loop Poisson arrivals at ``rate_rps`` for
    ``duration_s`` seconds (or ``n_requests`` arrivals — at least one
    bound is required), reap latencies, and return the verdict:
    offered/achieved request and row rates, shed/error counts, and
    p50/p95/p99 of ADMITTED request latency (shed requests failed fast
    by design — they are counted, not averaged in)."""
    if duration_s is None and n_requests is None:
        raise ValueError("run_load needs duration_s or n_requests")
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    if make_inputs is None:
        raise ValueError("run_load needs a make_inputs factory "
                         "(e.g. serve.loadgen.z_inputs(dim))")
    rng = random.Random(seed)
    sizes = [s for s, _ in size_mix]
    weights = [w for _, w in size_mix]
    outstanding: deque = deque()
    latencies: List[float] = []
    submitted = shed = errors = rows_admitted = 0
    t0 = time.perf_counter()
    t_next = t0
    while True:
        if n_requests is not None and submitted + shed >= n_requests:
            break
        now = time.perf_counter()
        if duration_s is not None and now - t0 >= duration_s:
            break
        if t_next > now:
            # sleep in bounded ticks so a stop/interrupt lands promptly
            time.sleep(min(t_next - now, 0.05))
            continue
        rows = rng.choices(sizes, weights=weights)[0]
        try:
            req = engine.submit(*make_inputs(rows))
            outstanding.append(req)
            submitted += 1
            rows_admitted += rows
        except ShedError:
            shed += 1
        # the ABSOLUTE schedule: a slow submit doesn't slow arrivals
        t_next += rng.expovariate(rate_rps)
        errors += _reap(outstanding, latencies)
    gen_end = time.perf_counter()
    deadline = gen_end + drain_timeout_s
    while outstanding and time.perf_counter() < deadline:
        outstanding[0].done.wait(0.1)
        errors += _reap(outstanding, latencies)
    undrained = len(outstanding)
    wall_s = time.perf_counter() - t0
    gen_s = gen_end - t0
    drain_s = wall_s - gen_s
    p50, p95, p99 = percentiles(latencies, (50.0, 95.0, 99.0))
    completed = len(latencies)
    return {
        "offered_rps": rate_rps,
        # completed over the FULL wall including the drain tail — an
        # honest throughput, but biased low for short stages (the tail
        # is in-flight queue, not lost work), which is why saturation
        # detection uses shed/drain bounds rather than this ratio
        "achieved_rps": completed / wall_s if wall_s > 0 else 0.0,
        "gen_s": gen_s,
        "drain_s": drain_s,
        "rows_per_sec": rows_admitted / wall_s if wall_s > 0 else 0.0,
        "submitted": submitted,
        "completed": completed,
        "shed": shed,
        "errors": errors,
        "undrained": undrained,
        "wall_s": wall_s,
        "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
    }


def run_socket_load(client, rate_rps: float,
                    duration_s: Optional[float] = None,
                    n_requests: Optional[int] = None,
                    size_mix: Sequence[Tuple[int, float]]
                    = DEFAULT_SIZE_MIX,
                    make_inputs: Optional[Callable] = None,
                    seed: int = 0,
                    tenant: Optional[str] = None,
                    encoding: str = "npy",
                    max_workers: int = 32,
                    drain_timeout_s: float = 60.0) -> Dict:
    """``run_load`` over a real socket: the same open-loop Poisson
    arrival process, driven through a ``GatewayClient`` against the
    HTTP gateway so the measurement covers the FULL network path —
    parse, validate, rate limit, route, admit, dispatch, encode.

    Each arrival fires a blocking ``client.generate`` on a worker pool
    (HTTP has no submit/result split, so concurrency comes from
    threads; size ``max_workers`` above the expected outstanding count
    or pool queueing bleeds into the latency numbers).  Outcomes are
    classified by the gateway's typed wire contract:

    * 200 → completed (latency measured from the scheduled arrival);
    * 429 after the client's retries → ``shed``;
    * 503/504 after retries → ``unavailable`` (typed: a replica died
      or the backend timed out — distinct from shed so a chaos test
      can assert "zero NON-typed failures" exactly);
    * anything else (400s, transport errors) → ``errors``.

    Returns the ``run_load`` dict shape plus ``unavailable`` and the
    client's ``retried_total`` delta."""
    from gan_deeplearning4j_tpu_torch.serve.client import GatewayHTTPError

    if duration_s is None and n_requests is None:
        raise ValueError("run_socket_load needs duration_s or "
                         "n_requests")
    if rate_rps <= 0:
        raise ValueError("rate_rps must be > 0")
    if make_inputs is None:
        raise ValueError("run_socket_load needs a make_inputs factory "
                         "(e.g. serve.loadgen.z_inputs(dim))")
    rng = random.Random(seed)
    sizes = [s for s, _ in size_mix]
    weights = [w for _, w in size_mix]
    retried_before = client.retried_total

    def _one(rows: int, t_sched: float):
        try:
            client.generate(make_inputs(rows), tenant=tenant,
                            encoding=encoding)
            return ("ok", (time.perf_counter() - t_sched) * 1000.0,
                    rows)
        except GatewayHTTPError as e:
            if e.status == 429:
                return ("shed", None, rows)
            if e.status in (503, 504):
                return ("unavailable", None, rows)
            return ("error", None, rows)
        except Exception:
            return ("error", None, rows)

    outstanding: deque = deque()
    latencies: List[float] = []
    submitted = shed = unavailable = errors = rows_ok = 0

    def _reap_done() -> None:
        nonlocal shed, unavailable, errors, rows_ok
        while outstanding and outstanding[0].done():
            kind, lat_ms, rows = outstanding.popleft().result()
            if kind == "ok":
                latencies.append(lat_ms)
                rows_ok += rows
            elif kind == "shed":
                shed += 1
            elif kind == "unavailable":
                unavailable += 1
            else:
                errors += 1

    with ThreadPoolExecutor(
            max_workers=max_workers,
            thread_name_prefix="gan4j-gateway-load") as pool:
        t0 = time.perf_counter()
        t_next = t0
        while True:
            if n_requests is not None and submitted >= n_requests:
                break
            now = time.perf_counter()
            if duration_s is not None and now - t0 >= duration_s:
                break
            if t_next > now:
                time.sleep(min(t_next - now, 0.05))
                continue
            rows = rng.choices(sizes, weights=weights)[0]
            outstanding.append(pool.submit(_one, rows,
                                           time.perf_counter()))
            submitted += 1
            # the ABSOLUTE schedule: a slow request doesn't slow arrivals
            t_next += rng.expovariate(rate_rps)
            _reap_done()
        gen_end = time.perf_counter()
        deadline = gen_end + drain_timeout_s
        while outstanding and time.perf_counter() < deadline:
            if not outstanding[0].done():
                time.sleep(0.05)
            _reap_done()
        undrained = len(outstanding)
        for f in outstanding:
            f.cancel()
    wall_s = time.perf_counter() - t0
    gen_s = gen_end - t0
    p50, p95, p99 = percentiles(latencies, (50.0, 95.0, 99.0))
    completed = len(latencies)
    return {
        "offered_rps": rate_rps,
        "achieved_rps": completed / wall_s if wall_s > 0 else 0.0,
        "gen_s": gen_s,
        "drain_s": wall_s - gen_s,
        "rows_per_sec": rows_ok / wall_s if wall_s > 0 else 0.0,
        "submitted": submitted,
        "completed": completed,
        "shed": shed,
        "unavailable": unavailable,
        "errors": errors,
        "undrained": undrained,
        "retried": client.retried_total - retried_before,
        "wall_s": wall_s,
        "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
    }


def measure_saturation(engine, make_inputs: Callable,
                       start_rps: float = 50.0,
                       growth: float = 1.6,
                       stage_s: float = 2.0,
                       max_stages: int = 12,
                       shed_frac_limit: float = 0.02,
                       drain_s_limit: Optional[float] = None,
                       size_mix: Sequence[Tuple[int, float]]
                       = DEFAULT_SIZE_MIX,
                       seed: int = 0) -> Dict:
    """Geometric rate ramp: run ``stage_s`` at each rate until the
    service stops keeping up.  A stage is SUSTAINED when the shed
    fraction stays under ``shed_frac_limit``, nothing errored or was
    left undrained, and the post-stage drain of in-flight work stays
    under ``drain_s_limit`` (default ``max(1.0, 0.75 * stage_s)``) —
    a bounded drain means the queue was in steady state, an unbounded
    one means the backlog was growing all stage (the open-loop
    overload signature even before admission starts shedding).
    Returns the last SUSTAINED rate (the saturation headline) with its
    stage stats, plus the first failing stage for the record."""
    if drain_s_limit is None:
        drain_s_limit = max(1.0, 0.75 * stage_s)
    sustained: Optional[Dict] = None
    failed: Optional[Dict] = None
    rate = float(start_rps)
    stage = -1
    for stage in range(max_stages):
        stats = run_load(engine, rate, duration_s=stage_s,
                         size_mix=size_mix, make_inputs=make_inputs,
                         seed=seed + stage)
        total = stats["submitted"] + stats["shed"]
        shed_frac = stats["shed"] / total if total else 0.0
        ok = (shed_frac <= shed_frac_limit
              and stats["drain_s"] <= drain_s_limit
              and stats["errors"] == 0
              and stats["undrained"] == 0)
        stats["shed_frac"] = shed_frac
        stats["sustained"] = ok
        if ok:
            sustained = stats
            rate *= growth
        else:
            failed = stats
            break
    return {
        # the headline is the OFFERED rate the service provably
        # sustained — achieved_rps is biased low by the drain tail
        "saturation_rps": sustained["offered_rps"] if sustained
        else 0.0,
        "sustained_stage": sustained,
        "failed_stage": failed,
        "stages_run": stage + 1,
    }
