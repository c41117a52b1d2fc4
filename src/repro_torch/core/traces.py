"""Statistical twins of the paper's four request-arrival traces.

The originals (UC-Berkeley Home-IP, Wikipedia, WITS, Twitter — paper
[18]-[21]) are not redistributable, so we generate seeded surrogates whose
*shape statistics* match what the paper exploits: Fig 7's peak-to-median
ratios (Wiki low ~1.3, the others >2) and the burst structure each scheme
reacts to.  Observation-4 behaviour (mixed procurement helps iff
peak/median is large) must EMERGE from these, it is not hard-coded.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

DEFAULT_DURATION_S = 3600
DEFAULT_MEAN_RPS = 100.0


def _normalize(rate: np.ndarray, mean_rps: float) -> np.ndarray:
    rate = np.maximum(rate, 0.0)
    return rate * (mean_rps / max(rate.mean(), 1e-9))


def berkeley(duration_s: int = DEFAULT_DURATION_S, mean_rps: float = DEFAULT_MEAN_RPS,
             seed: int = 0) -> np.ndarray:
    """Home-IP dialup: strong diurnal swell + evening flash crowds."""
    rng = np.random.default_rng(seed + 101)
    t = np.arange(duration_s)
    base = 1.0 + 0.55 * np.sin(2 * np.pi * t / duration_s - 0.7)
    # two flash crowds, sharp rise / exponential drain
    for start, scale, tau in ((duration_s * 0.35, 1.7, 180.0), (duration_s * 0.7, 1.3, 140.0)):
        base += scale * np.exp(-np.maximum(t - start, 0) / tau) * (t >= start)
    noise = rng.gamma(shape=24.0, scale=1 / 24.0, size=duration_s)
    return _normalize(base * noise, mean_rps)


def wiki(duration_s: int = DEFAULT_DURATION_S, mean_rps: float = DEFAULT_MEAN_RPS,
         seed: int = 0) -> np.ndarray:
    """Wikipedia: smooth, low-variance diurnal — peak/median ~1.3 (Fig 7)."""
    rng = np.random.default_rng(seed + 202)
    t = np.arange(duration_s)
    base = 1.0 + 0.18 * np.sin(2 * np.pi * t / duration_s) + 0.06 * np.sin(
        6 * np.pi * t / duration_s + 1.1
    )
    noise = rng.gamma(shape=120.0, scale=1 / 120.0, size=duration_s)
    return _normalize(base * noise, mean_rps)


def wits(duration_s: int = DEFAULT_DURATION_S, mean_rps: float = DEFAULT_MEAN_RPS,
         seed: int = 0) -> np.ndarray:
    """WITS ISP backbone: heavy-tailed bursts on a shallow diurnal."""
    rng = np.random.default_rng(seed + 303)
    t = np.arange(duration_s)
    base = 1.0 + 0.25 * np.sin(2 * np.pi * t / duration_s + 2.0)
    # Pareto-amplitude bursts arriving as a Poisson process, AR(1)-smeared
    bursts = np.zeros(duration_s)
    n_bursts = rng.poisson(duration_s / 400)
    starts = rng.integers(0, duration_s, n_bursts)
    amps = np.minimum(rng.pareto(2.2, n_bursts) * 0.7, 3.0)
    for s0, a in zip(starts, amps):
        dur = int(rng.integers(20, 120))
        bursts[s0 : s0 + dur] += a
    noise = rng.gamma(shape=30.0, scale=1 / 30.0, size=duration_s)
    return _normalize((base + bursts) * noise, mean_rps)


def twitter(duration_s: int = DEFAULT_DURATION_S, mean_rps: float = DEFAULT_MEAN_RPS,
            seed: int = 0) -> np.ndarray:
    """Twitter firehose: spiky retweet cascades, highest peak/median."""
    rng = np.random.default_rng(seed + 404)
    t = np.arange(duration_s)
    base = np.full(duration_s, 0.8) + 0.15 * np.sin(2 * np.pi * t / duration_s)
    spikes = np.zeros(duration_s)
    n_spikes = rng.poisson(duration_s / 450)
    starts = rng.integers(0, duration_s, max(n_spikes, 4))
    for s0 in starts:
        amp = 1.4 + min(rng.pareto(2.0) * 1.2, 5.0)
        tau = rng.uniform(30.0, 90.0)
        spikes += amp * np.exp(-np.maximum(t - s0, 0) / tau) * (t >= s0)
    noise = rng.gamma(shape=18.0, scale=1 / 18.0, size=duration_s)
    return _normalize((base + spikes) * noise, mean_rps)


TRACES = {
    "berkeley": berkeley,
    "wiki": wiki,
    "wits": wits,
    "twitter": twitter,
}


def get_trace(name: str, duration_s: int = DEFAULT_DURATION_S,
              mean_rps: float = DEFAULT_MEAN_RPS, seed: int = 0) -> np.ndarray:
    """Per-second request rate (req/s), length ``duration_s``."""
    return TRACES[name](duration_s, mean_rps, seed)


def peak_to_median(rate: np.ndarray, peak_q: float = 0.99, axis=None):
    """Fig-7 statistic (p99 peak guards against one-sample outliers).

    1-D input returns a float; an ``[A, T]`` arrival matrix with
    ``axis=1`` returns the per-arch statistic ``[A]`` — the spread of
    these over a heterogeneous scenario is exactly what share-scaling a
    single pool trace flattens away.
    """
    peak = np.quantile(rate, peak_q, axis=axis)
    med = np.maximum(np.median(rate, axis=axis), 1e-9)
    out = peak / med
    return float(out) if out.ndim == 0 else out


def trace_stats(duration_s: int = DEFAULT_DURATION_S, seed: int = 0) -> Dict[str, dict]:
    out = {}
    for name in TRACES:
        r = get_trace(name, duration_s, seed=seed)
        out[name] = {
            "mean": float(r.mean()),
            "median": float(np.median(r)),
            "peak_p99": float(np.quantile(r, 0.99)),
            "peak_to_median": peak_to_median(r),
        }
    return out
