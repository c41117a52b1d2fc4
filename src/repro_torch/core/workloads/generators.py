"""Per-arch arrival-matrix generators.

Every generator returns an ``[A, T]`` float64 matrix: row ``a`` is the
per-second request rate arch ``a`` sees over ``duration_s`` ticks.  The
pool-trace engine path (one shared trace scaled by a static ``share``)
can only express perfectly correlated load; these generators produce the
heterogeneous shapes the paper's self-managed system must react to
(Fig 7 trace diversity, Observation 4's peak-to-median dependence):

``from_pool_trace``
    Adapter reproducing today's behavior exactly — ``share[a] * trace[t]``,
    bit-identical to the engine's internal share scaling.
``diurnal``
    Per-arch diurnal cycles with independent phase and amplitude jitter
    (regions in different time zones: pool load flattens, arch load
    does not).
``flash_crowd``
    Flash crowds on a flat-ish base, in three correlation modes:
    ``correlated`` (an event hits a random subset of archs at once),
    ``anti`` (attention shifts — one arch spikes while the rest dip),
    and ``solo`` (one arch spikes, the others idle on).
``mmpp``
    Per-arch Markov-modulated bursts: each arch alternates quiet/burst
    sojourns (geometric durations) with Pareto-amplitude burst rates —
    the heavy-tailed structure of the WITS/Twitter twins, decorrelated
    across archs.
``hotswap``
    "Trending model" popularity shifts: pool demand rides a smooth
    diurnal, but its split over archs drifts — at each shift event one
    arch's weight logistic-ramps toward dominance while the rest
    renormalize (INFaaS-style variant churn).

Normalization: each row is scaled so arch ``a``'s mean rate is
``weights[a] * mean_rps`` (uniform weights by default), i.e. ``mean_rps``
is always the *pool* mean — scenarios are cost-comparable.  All
generators are seeded and deterministic.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core.traces import get_trace


def _weights(n_archs: int, weights: Optional[Sequence[float]]) -> np.ndarray:
    if weights is None:
        return np.full(n_archs, 1.0 / n_archs)
    w = np.asarray(weights, dtype=np.float64)
    assert w.shape == (n_archs,) and (w >= 0).all()
    return w / max(w.sum(), 1e-12)


def _normalize_pool(mat: np.ndarray, mean_rps: float,
                    weights: np.ndarray) -> np.ndarray:
    """Scale each row to its share of the pool mean, clipping negatives."""
    mat = np.maximum(mat, 0.0)
    row_mean = np.maximum(mat.mean(axis=1), 1e-9)
    return mat * (mean_rps * weights / row_mean)[:, None]


# ---------------------------------------------------------------------------
# The adapter: today's shared-trace behavior as an arrival matrix.
# ---------------------------------------------------------------------------
def from_pool_trace(trace: np.ndarray, share: Sequence[float]) -> np.ndarray:
    """``arrivals[a, t] = share[a] * trace[t]`` — the exact fan-out the
    engine applies internally to a 1-D pool trace, exposed as a matrix so
    the per-arch path can reproduce shared-trace runs."""
    trace = np.asarray(trace, dtype=np.float64)
    share = np.asarray(share, dtype=np.float64)
    assert trace.ndim == 1 and share.ndim == 1
    return share[:, None] * trace[None, :]


# ---------------------------------------------------------------------------
# Heterogeneous generators.
# ---------------------------------------------------------------------------
def diurnal(n_archs: int, duration_s: int, mean_rps: float, seed: int, *,
            amplitude: float = 0.45, amp_jitter: float = 0.4,
            phase_jitter: float = 1.0, cycles: float = 1.0,
            noise_shape: float = 40.0,
            weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Per-arch diurnal with phase/amplitude jitter.

    ``phase_jitter`` in [0, 1] scales a uniform [-pi, pi] per-arch phase
    offset: 0 means every arch peaks together (the pool-trace limit), 1
    spreads the peaks around the full cycle.
    """
    rng = np.random.default_rng(seed)
    w = _weights(n_archs, weights)
    t = np.arange(duration_s)
    phase = phase_jitter * rng.uniform(-np.pi, np.pi, n_archs)
    amp = amplitude * (1.0 + amp_jitter * rng.uniform(-1.0, 1.0, n_archs))
    base = 1.0 + amp[:, None] * np.sin(
        2 * np.pi * cycles * t[None, :] / duration_s + phase[:, None]
    )
    noise = rng.gamma(noise_shape, 1.0 / noise_shape, (n_archs, duration_s))
    return _normalize_pool(base * noise, mean_rps, w)


def flash_crowd(n_archs: int, duration_s: int, mean_rps: float, seed: int, *,
                mode: str = "correlated", n_events: int = 2,
                amplitude: float = 3.0, tau_s: float = 150.0,
                dip: float = 0.6, noise_shape: float = 30.0,
                weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Flash crowds with controllable cross-arch correlation.

    ``correlated``  — each event hits a random half of the pool at once;
    ``anti``        — one arch spikes while every other arch dips by
                      ``dip`` x the (normalized) spike profile: attention
                      shifts rather than arrives;
    ``solo``        — one arch spikes, the rest never see the event.
    """
    assert mode in ("correlated", "anti", "solo"), mode
    rng = np.random.default_rng(seed)
    w = _weights(n_archs, weights)
    t = np.arange(duration_s, dtype=np.float64)
    mat = np.ones((n_archs, duration_s))
    for _ in range(n_events):
        start = float(rng.uniform(0.1, 0.8) * duration_s)
        amp = amplitude * (0.5 + rng.pareto(2.5))
        profile = np.exp(-np.maximum(t - start, 0.0) / tau_s) * (t >= start)
        if mode == "correlated":
            hit = rng.random(n_archs) < 0.5
            if not hit.any():
                hit[rng.integers(n_archs)] = True
            jitter = rng.uniform(0.6, 1.4, n_archs)
            mat += hit[:, None] * (amp * jitter)[:, None] * profile[None, :]
        else:
            a = int(rng.integers(n_archs))
            mat[a] += amp * profile
            if mode == "anti":
                others = np.arange(n_archs) != a
                mat[others] *= 1.0 - dip * profile[None, :]
    noise = rng.gamma(noise_shape, 1.0 / noise_shape, (n_archs, duration_s))
    return _normalize_pool(mat * noise, mean_rps, w)


def mmpp(n_archs: int, duration_s: int, mean_rps: float, seed: int, *,
         burst_mult: float = 4.0, pareto_alpha: float = 2.0,
         mean_quiet_s: float = 400.0, mean_burst_s: float = 60.0,
         noise_shape: float = 25.0,
         weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """Markov-modulated bursts with Pareto amplitudes, per arch.

    Each arch alternates quiet (rate 1) and burst sojourns; burst rate is
    ``1 + burst_mult * Pareto(pareto_alpha)``, capped at ``6 * burst_mult``
    so one draw cannot dominate the normalized row.  Sojourn lengths are
    geometric, so the modulating chain is a true 2-state MMPP.
    """
    rng = np.random.default_rng(seed)
    w = _weights(n_archs, weights)
    mat = np.ones((n_archs, duration_s))
    for a in range(n_archs):
        pos, bursting = 0, bool(rng.random() < 0.2)
        while pos < duration_s:
            mean_len = mean_burst_s if bursting else mean_quiet_s
            length = 1 + int(rng.geometric(1.0 / mean_len))
            if bursting:
                amp = 1.0 + min(burst_mult * rng.pareto(pareto_alpha),
                                6.0 * burst_mult)
                mat[a, pos: pos + length] = amp
            pos += length
            bursting = not bursting
    noise = rng.gamma(noise_shape, 1.0 / noise_shape, (n_archs, duration_s))
    return _normalize_pool(mat * noise, mean_rps, w)


def hotswap(n_archs: int, duration_s: int, mean_rps: float, seed: int, *,
            n_shifts: int = 2, ramp_s: float = 300.0,
            boost: float = 4.0, pool_trace: str = "wiki",
            weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """"Trending model" popularity shifts over a smooth pool trace.

    Pool demand follows a :mod:`repro_torch.core.traces` twin; its split over
    archs starts at ``weights`` and, at each of ``n_shifts`` events, one
    arch's weight logistic-ramps up by ``boost`` x while the rest
    renormalize — the variant-churn case INFaaS-style pools must absorb,
    which no static ``share`` can express.
    """
    rng = np.random.default_rng(seed)
    w0 = _weights(n_archs, weights)
    t = np.arange(duration_s, dtype=np.float64)
    logw = np.broadcast_to(np.log(np.maximum(w0, 1e-12))[:, None],
                           (n_archs, duration_s)).copy()
    for k in range(n_shifts):
        a = int(rng.integers(n_archs))
        t_k = (k + 1) / (n_shifts + 1) * duration_s * rng.uniform(0.8, 1.2)
        ramp = 1.0 / (1.0 + np.exp(-(t - t_k) / ramp_s))
        logw[a] += np.log(boost) * ramp
    wt = np.exp(logw)
    wt /= wt.sum(axis=0, keepdims=True)
    pool = get_trace(pool_trace, duration_s, mean_rps=mean_rps, seed=seed)
    return wt * pool[None, :]


def pool_trace(n_archs: int, duration_s: int, mean_rps: float, seed: int, *,
               trace: str = "berkeley",
               weights: Optional[Sequence[float]] = None) -> np.ndarray:
    """One shared :mod:`repro_torch.core.traces` twin fanned out by static
    share — the scenario form of today's engine behavior, via
    :func:`from_pool_trace` (bit-identical arrivals)."""
    share = _weights(n_archs, weights)
    tr = get_trace(trace, duration_s, mean_rps=mean_rps, seed=seed)
    return from_pool_trace(tr, share)


# ---------------------------------------------------------------------------
# Trace replay: a captured [A, T] matrix as a first-class scenario.
# ---------------------------------------------------------------------------
REPLAY_KEY = "arrivals"


def save_replay(path: str, arrivals: np.ndarray, *,
                key: str = REPLAY_KEY) -> str:
    """Capture an ``[A, T]`` arrival matrix for later replay.

    Writes a compressed ``.npz`` the ``replay`` generator (and therefore
    ``Scenario(kind="replay", params={"path": ...})``) loads back —
    the spec stays a small JSON-serializable record while the matrix
    itself lives on disk.  Returns the path actually written
    (``np.savez`` appends ``.npz`` when missing, so the returned path —
    not necessarily the argument — is what a replay spec must carry)."""
    arrivals = np.asarray(arrivals, dtype=np.float64)
    assert arrivals.ndim == 2, "replay captures [A, T] matrices"
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(path, **{key: arrivals})
    return path


def replay(n_archs: int, duration_s: int, mean_rps: float, seed: int, *,
           path: str, key: str = REPLAY_KEY,
           renormalize: bool = False) -> np.ndarray:
    """Replay a captured ``[A, T]`` arrival matrix from an ``.npz`` file.

    The matrix must have exactly ``n_archs`` rows and at least
    ``duration_s`` columns (longer captures are truncated — replay never
    invents data).  ``seed`` is ignored: a replay is literal, and
    re-rolling an episode (the RL env does per reset) replays the same
    capture.  With ``renormalize=True`` the matrix is rescaled so the
    pool mean is ``mean_rps`` (cost-comparable against generated
    scenarios); by default the captured rates are served verbatim.
    """
    with np.load(path) as z:
        assert key in z, f"{path!r} has no array {key!r} (has {sorted(z)})"
        mat = np.asarray(z[key], dtype=np.float64)
    assert mat.ndim == 2, f"replay needs an [A, T] matrix, got {mat.shape}"
    assert mat.shape[0] == n_archs, (
        f"capture has {mat.shape[0]} rows for a {n_archs}-arch pool"
    )
    assert mat.shape[1] >= duration_s, (
        f"capture holds {mat.shape[1]} ticks < duration_s={duration_s}"
    )
    out = mat[:, :duration_s].copy()
    if renormalize:
        pool_mean = max(float(out.sum(axis=0).mean()), 1e-12)
        out *= mean_rps / pool_mean
    return out


GENERATORS: Dict[str, object] = {
    "pool_trace": pool_trace,
    "diurnal": diurnal,
    "flash_crowd": flash_crowd,
    "mmpp": mmpp,
    "hotswap": hotswap,
    "replay": replay,
}
