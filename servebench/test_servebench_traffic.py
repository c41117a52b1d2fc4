"""The seeded schedule and length draws, and the percentile arithmetic."""
import numpy as np
import pytest

from servebench import readers, stats
from servebench.harness import Records
from servebench.traffic import Traffic, poisson_gaps, quantile_lengths

RAG = {"loop": "open", "rate_per_s": 8.0, "block": 32,
       "prompt": {"median": 2048, "sigma": 0.5, "min": 512, "max": 3840},
       "output": {"median": 48, "sigma": 0.6, "min": 16, "max": 192}}
BIG_SEED = 2**31 + 12345


def test_same_seed_same_requests():
    a, b = Traffic(RAG, BIG_SEED, 32064), Traffic(RAG, BIG_SEED, 32064)
    sa, sb = a.open_schedule(8.0, (8.0, 30.0)), b.open_schedule(8.0, (8.0, 30.0))
    for i in (0, 5, 31, 32, 100):
        ra, rb = sa[i], sb[i]
        assert np.array_equal(ra.prompt, rb.prompt) and ra.output_len == rb.output_len
        assert ra.due_s == rb.due_s


@pytest.mark.parametrize("seed", [0, 7, BIG_SEED, 2**62 + 3])
def test_every_seed_gets_the_same_sizes_and_arrivals_in_another_order(seed):
    t = Traffic(RAG, seed, 32064)
    reqs = t.open_schedule(8.0, (8.0, 45.0, 12.0))
    for b in range(2):
        block = reqs[32 * b:32 * (b + 1)]
        assert sorted(len(r.prompt) for r in block) == sorted(quantile_lengths(RAG["prompt"], 32))
        assert sorted(r.output_len for r in block) == sorted(quantile_lengths(RAG["output"], 32))
    # each span holds round(rate x its length) arrivals: the lead-in, the
    # window and the room after it offer the same count under every seed
    due = np.array([r.due_s for r in reqs])
    assert [int(((due >= a) & (due < b)).sum()) for a, b in ((0, 8), (8, 53), (53, 65))] \
        == [64, 360, 96]
    # ... at the same set of gaps: the window's 361 (its edges' included)
    # are the exponential quantiles of every seed, in another order
    inside = np.concatenate(([8.0], due[(due >= 8) & (due < 53)], [53.0]))
    assert np.sort(np.diff(inside)) == pytest.approx(poisson_gaps(360, 45.0), abs=1e-9)
    assert all(0 <= int(r.prompt.min()) and int(r.prompt.max()) < 32064 for r in reqs)


def test_seeds_differ_in_order_and_tokens():
    a, b = Traffic(RAG, 1, 32064), Traffic(RAG, 2, 32064)
    assert [a.request(i).output_len for i in range(32)] != [b.request(i).output_len for i in range(32)]
    assert not np.array_equal(a.request(0).prompt[:16], b.request(0).prompt[:16])
    assert not np.array_equal(a.arrival_times(8.0, (30.0,)), b.arrival_times(8.0, (30.0,)))


def test_open_schedule_is_due_in_the_window():
    t = Traffic(RAG, 3, 32064)
    sched = t.open_schedule(8.0, (30.0,))
    due = [r.due_s for r in sched]
    assert len(sched) == 240 and all(0 <= d < 30.0 for d in due) and due == sorted(due)
    assert [r.index for r in sched] == list(range(len(sched)))


def test_arrivals_are_as_bursty_as_poisson():
    """Over many seeds, the count in a 1 s bin has the Poisson's variance
    (its mean, less the binomial's 1/30) and the gaps the exponential's
    coefficient of variation, 1: no smoothing of the bursts."""
    counts, gaps = [], []
    for seed in range(200):
        due = Traffic(RAG, seed, 32064).arrival_times(8.0, (30.0,))
        counts.extend(np.histogram(due, bins=30, range=(0.0, 30.0))[0])
        gaps.extend(np.diff(due))
    counts, gaps = np.array(counts), np.array(gaps)
    assert counts.mean() == pytest.approx(8.0)
    assert counts.var() == pytest.approx(8.0 * (1 - 1 / 30), rel=0.08)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, abs=0.03)


def test_quantiles_are_clipped_lognormal():
    lens = quantile_lengths(RAG["prompt"], 32)
    assert lens.min() >= 512 and lens.max() == 3840 and np.median(lens) == pytest.approx(2048, rel=0.05)


@pytest.mark.parametrize("q", [0, 50, 90, 95, 99, 100])
def test_percentile_is_numpy_linear(q):
    xs = np.random.default_rng(0).exponential(size=137)
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == 4
    assert stats.gaps_between(iv, 0, 8) == [(3, 5), (6, 8)]


class _View:
    def __init__(self, rec, t_start=0.0):
        self.rec, self.t_start = rec, t_start


def _steady(stall_at=None, stall=0.0):
    """Ten requests decoding together at 10 ms a step for 2 s; a stall
    (an admitted prefill) of ``stall`` s before step ``stall_at``."""
    rec = Records(window=(0.0, 2.0))
    t, times = 0.0, []
    for k in range(200):
        t += 0.010 + (stall if k == stall_at else 0.0)
        times.append(t)
    for rid in range(10):
        rec.tokens[rid] = list(times)
        rec.due[rid] = 0.0
    return rec


def test_a_stall_shows_in_itl_p95():
    calm = readers.itl_p95_ms(_View(_steady()))
    assert calm == pytest.approx(10.0)
    # one 200 ms stall every 10 steps: over 5% of the gaps, so the p95 sees it
    rec = _steady()
    for rid in range(10):
        rec.tokens[rid] = [t + 0.2 * (k // 10) for k, t in enumerate(rec.tokens[rid])]
    assert readers.itl_p95_ms(_View(rec)) == pytest.approx(210.0)


def test_rates_and_ttft_count_the_window_only():
    rec = _steady()
    rec.window = (0.0, 1.005)
    view = _View(rec)
    assert readers.output_tokens_per_s(view) == pytest.approx(10 * 100 / 1.005)
    assert readers.ttft_p95_ms(view) == pytest.approx(10.0)
