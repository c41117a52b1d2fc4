"""The arithmetic of the per-layer metrics, shared by the readers in
``metrics/`` (one file a metric, each a line that picks its function).

A reader takes the run (``run.py:RunView``) and returns a number, or None
where the run holds nothing to read, and the harness then leaves the
metric out.  Host-clock readers take the window's records; device-trace
readers take the traced stretch, which follows the window.
"""
from __future__ import annotations

from typing import Optional

from servebench import counts
from servebench.stats import percentile


def _inserts(run):
    w0, w1 = run.rec.window
    return [r for r in run.rec.inserts if w0 <= r[1] <= w1]


def _steps(run):
    w0, w1 = run.rec.window
    return [s for s in run.rec.steps if w0 <= s[0] <= w1]


def queue_wait_p95_ms(run) -> Optional[float]:
    """Due time to the start of the request's insert, 95th percentile over
    the requests due in the window."""
    start = {rid: t0 for rid, t0, _, _ in run.rec.inserts}
    w0, w1 = run.rec.window
    waits = [start[rid] - due for rid, due in run.rec.due.items()
             if w0 <= due < w1 and rid in start]
    return 1e3 * percentile(waits, 95) if waits else None


def prefill_ms_per_ktok(run) -> Optional[float]:
    ins = _inserts(run)
    tokens = sum(r[3] for r in ins)
    return 1e3 * sum(r[2] - r[1] for r in ins) / (tokens / 1e3) if tokens else None


def decode_step_ms(run) -> Optional[float]:
    st = _steps(run)
    return 1e3 * sum(s[1] - s[0] for s in st) / len(st) if st else None


def prefill_mfu(run) -> Optional[float]:
    """Model FLOPs the window's prompts need over its insert time, as a
    share of the bf16 peak."""
    ins = _inserts(run)
    if not ins:
        return None
    flops = sum(counts.prefill_flops(run.cfg, r[3]) for r in ins)
    return 100.0 * flops / sum(r[2] - r[1] for r in ins) / counts.PEAK_BF16_FLOPS


def decode_mfu(run) -> Optional[float]:
    """The steps' least time (the larger of FLOPs over the bf16 peak and
    least bytes over the HBM bandwidth, for the live slots) over their
    time."""
    st = _steps(run)
    if not st:
        return None
    least = sum(counts.least_seconds(counts.decode_flops(run.cfg, s[2], s[3]),
                                     counts.decode_bytes(run.cfg, s[2], s[3])) for s in st)
    return 100.0 * least / sum(s[1] - s[0] for s in st)


def _stretch(run):
    st = run.stretch
    return (run.rec.inserts[st.n_inserts:st.end_inserts], run.rec.steps[st.n_steps:st.end_steps])


def moe_ms_per_ktok(run) -> Optional[float]:
    """Device ms of the kernels launched inside ``moe_sort_local`` per 1000
    tokens of requests through the MoE layers (prompts, and the live slots
    of each step), in the traced stretch."""
    if run.trace is None or not run.cfg.get("num_experts"):
        return None
    ins, st = _stretch(run)
    tokens = run.cfg["num_layers"] * (sum(r[3] for r in ins) + sum(s[2] for s in st))
    ms = 1e3 * run.trace["moe_s"]["moe.layer"]
    return ms / (tokens / 1e3) if tokens and ms else None


def flash_roofline(run) -> Optional[float]:
    """Sum of the flash calls' bounds over the flash kernel's device time."""
    if run.trace is None or not run.trace["flash_s"]:
        return None
    ins, _ = _stretch(run)
    bound = run.cfg["num_layers"] * sum(counts.least_seconds(*counts.flash_call(run.cfg, r[3]))
                                        for r in ins)
    return 100.0 * bound / run.trace["flash_s"]


def decode_attn_roofline(run) -> Optional[float]:
    """The same over the decode kernel, counting the live slots' valid
    cache positions only."""
    if run.trace is None or not run.trace["decode_s"]:
        return None
    _, st = _stretch(run)
    bound = run.cfg["num_layers"] * sum(
        counts.least_seconds(*counts.decode_attention_call(run.cfg, s[2], s[3]))
        for s in st)
    return 100.0 * bound / run.trace["decode_s"]


def device_idle_share(run) -> Optional[float]:
    """The share of the traced stretch in which no operation ran on the card."""
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


# ---------------------------------------------------------------------------
# End-to-end metrics: host clock, every request and token of the window.
# ---------------------------------------------------------------------------
def ttft_samples(run):
    """First token on the host (the end of the insert that made it) less
    the due time, for every request due in the window (seconds)."""
    w0, w1 = run.rec.window
    return [run.rec.tokens[rid][0] - due for rid, due in run.rec.due.items()
            if w0 <= due < w1 and rid in run.rec.tokens]


def itl_samples(run):
    """Every gap between consecutive output tokens of every request that
    ends in the window (seconds); a prefill that stalls the step shows."""
    w0, w1 = run.rec.window
    out = []
    for times in run.rec.tokens.values():
        out.extend(b - a for a, b in zip(times, times[1:]) if w0 <= b <= w1)
    return out


def ttft_p95_ms(run) -> Optional[float]:
    xs = ttft_samples(run)
    return 1e3 * percentile(xs, 95) if xs else None


def itl_p95_ms(run) -> Optional[float]:
    xs = itl_samples(run)
    return 1e3 * percentile(xs, 95) if xs else None


def output_tokens_per_s(run) -> Optional[float]:
    """Every output token delivered in the window, over the window."""
    w0, w1 = run.rec.window
    n = sum(1 for times in run.rec.tokens.values() for t in times if w0 <= t <= w1)
    return n / (w1 - w0) if w1 > w0 else None


def setup_s(run) -> Optional[float]:
    """Process start to the window's opening."""
    return run.rec.window[0] - run.t_start
