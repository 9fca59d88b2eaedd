"""Bursty diurnal arrival traces (DESIGN.md §SLO serving).

Serving workloads are neither the paper's closed batch nor a flat Poisson
stream: request rate swings sinusoidally over the day and flash crowds spike
it several-fold for minutes at a time.  :func:`diurnal_trace` generates a
seeded trace of exactly ``n`` arrival times from that non-homogeneous
Poisson process — sinusoidal base rate, Gaussian flash-crowd bumps — by
thinning (Lewis & Shedler): candidates stream from a homogeneous process at
the rate envelope's maximum and are accepted with probability
``rate(t)/rate_max``.  Everything is vectorised numpy; no per-request
Python objects are ever built, which is what lets the simulator replay
10^6+ requests (the arrays feed ``SimConfig.arrival_trace``/``slo_trace``
directly and the event loop streams them lazily).

Each request also gets an SLO class — latency (1) with probability
``latency_frac``, else batch (0) — matching ``core.deque``'s SLO_LATENCY /
SLO_BATCH encoding.

The on-disk trace format is a compressed ``.npz`` with two aligned arrays,
``arrival`` (float64 seconds, non-decreasing) and ``slo`` (int8 ∈ {0, 1});
``scripts/make_trace.py`` is the CLI front-end and ``benchmarks/slo_trace``
generates its workload through the same function.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["diurnal_trace", "load_trace", "save_trace"]


def _rate(
    t: np.ndarray,
    mean_rate: float,
    period: float,
    depth: float,
    spike_t: np.ndarray,
    spike_amp: float,
    spike_width: float,
) -> np.ndarray:
    """Instantaneous arrival rate: sinusoidal diurnal base + Gaussian
    flash-crowd bumps (additive, so overlapping crowds stack)."""
    r = mean_rate * (1.0 + depth * np.sin(2.0 * math.pi * t / period))
    for ts in spike_t:
        z = (t - ts) / spike_width
        r = r + mean_rate * spike_amp * np.exp(-0.5 * z * z)
    return r


def diurnal_trace(
    n: int,
    *,
    mean_rate: float = 100.0,
    period: float = 600.0,
    depth: float = 0.8,
    spikes: int = 3,
    spike_amp: float = 4.0,
    spike_width: float | None = None,
    latency_frac: float = 0.25,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate exactly ``n`` seeded arrivals of a bursty diurnal process.

    ``mean_rate`` requests/s around which the diurnal sinusoid of period
    ``period`` seconds swings by ``±depth``; ``spikes`` flash crowds of
    amplitude ``spike_amp × mean_rate`` and width ``spike_width`` (default
    period/40) land at seeded uniform times inside the trace's nominal
    span.  Returns ``(arrival, slo)``: float64 non-decreasing times and
    int8 SLO classes (latency with probability ``latency_frac``).
    """
    if n <= 0:
        raise ValueError("n must be > 0")
    if mean_rate <= 0.0 or period <= 0.0:
        raise ValueError("mean_rate and period must be > 0")
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0, 1) — the rate must stay > 0")
    if spikes < 0 or spike_amp < 0.0:
        raise ValueError("spikes and spike_amp must be >= 0")
    if not 0.0 <= latency_frac <= 1.0:
        raise ValueError("latency_frac must be in [0, 1]")
    w = period / 40.0 if spike_width is None else float(spike_width)
    if w <= 0.0:
        raise ValueError("spike_width must be > 0")

    rng = np.random.default_rng(seed)
    # Nominal span: solve ∫rate ≈ n (each Gaussian bump integrates to
    # amp·mean_rate·w·√(2π); the sinusoid integrates to ~mean_rate·T).
    bump_mass = spikes * spike_amp * mean_rate * w * math.sqrt(2.0 * math.pi)
    # Floor at half the no-spike span: flash crowds may steepen the trace
    # but must not collapse it into one long spike when n is small relative
    # to the bump mass.
    horizon = max((n - bump_mass) / mean_rate, 0.5 * n / mean_rate)
    spike_t = np.sort(rng.uniform(0.0, horizon, size=spikes))

    # Thinning envelope: exact maximum of the rate on a dense grid (bumps
    # can overlap, so no closed form), padded 0.1% — thinning only needs an
    # UPPER bound, a slack one just wastes candidates.
    grid = np.arange(0.0, horizon + period, w / 4.0)
    rate_max = float(
        _rate(grid, mean_rate, period, depth, spike_t, spike_amp, w).max()
    ) * 1.001

    out: list[np.ndarray] = []
    got = 0
    t = 0.0
    accept_est = max(mean_rate / rate_max, 0.05)
    while got < n:
        m = int((n - got) / accept_est * 1.2) + 64
        cand = t + np.cumsum(rng.exponential(1.0 / rate_max, size=m))
        t = float(cand[-1])
        keep = rng.random(m) * rate_max < _rate(
            cand, mean_rate, period, depth, spike_t, spike_amp, w
        )
        acc = cand[keep]
        out.append(acc)
        got += acc.size
    arrival = np.concatenate(out)[:n]
    slo = (rng.random(n) < latency_frac).astype(np.int8)
    return arrival, slo


def save_trace(path: str, arrival: np.ndarray, slo: np.ndarray) -> None:
    """Write a trace as compressed ``.npz`` (arrays ``arrival``, ``slo``)."""
    arrival = np.asarray(arrival, np.float64)
    slo = np.asarray(slo, np.int8)
    if arrival.shape != slo.shape or arrival.ndim != 1:
        raise ValueError("arrival and slo must be aligned 1-D arrays")
    np.savez_compressed(path, arrival=arrival, slo=slo)


def load_trace(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load a trace written by :func:`save_trace`; returns (arrival, slo)."""
    with np.load(path) as z:
        return (
            np.asarray(z["arrival"], np.float64),
            np.asarray(z["slo"], np.int8),
        )
