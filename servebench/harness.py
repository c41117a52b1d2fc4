"""The served program under the benchmark's clock.

``Program`` builds the port as a configuration file states it (its
registry entry cut to the file's depth, every other number checked equal
to the file's), gives it the benchmark's weights, and drives
``repro_torch.serving.batching.ContinuousBatcher.run_step``, which admits
waiting requests (``Engine.insert``: a batch-1 prefill and the slot
scatter) and decodes every slot (``Engine.step``).  The harness times
``insert`` and ``step`` from outside: both are instance attributes, and
each ends in the program's own host sync (``int(argmax)``, ``.cpu()``).
The program is not edited.

Records are host ``time.perf_counter`` seconds: each insert (start, end,
prompt tokens), each step (start, end, live slots, and the valid cache
slots of the live slots, from a host mirror of each slot's position; the
engine also decodes its free slots, which no request needs), each
request's due time and output token times (the insert's end, then each
step's end while it is live), and the longest pause of the scheduler's
loop.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from servebench import profiling
from servebench.traffic import Traffic
from servebench.weights import DTYPES, make_params

# the harness's clock and sleep (the CPU tests put a step clock in their place)
clock = time.perf_counter
sleep = time.sleep

# the configuration file's numbers that the port's ModelConfig must equal
CHECKED_FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "expert_d_ff",
                  "vocab_size", "num_experts", "num_experts_per_tok", "moe_capacity_factor",
                  "qkv_bias", "rope_theta", "norm", "mlp", "tie_embeddings")
# the harness gives up on requests still unanswered this long after the window
DRAIN_LIMIT_S = 60.0
# the traced stretch: at least TRACE_MIN_STEPS scheduler steps holding
# TRACE_MIN_PREFILLS prefills, or TRACE_MAX_S seconds; up to TRACE_TRIES
# stretches, until one misses no record
TRACE_MIN_STEPS, TRACE_MIN_PREFILLS, TRACE_MAX_S, TRACE_TRIES = 30, 4, 4.0, 3


def program_config(cfg: Dict):
    """The port's ModelConfig of ``cfg``: its registry entry at the file's
    depth; raises where any other number differs from the file."""
    from repro_torch.configs import get_config
    pc = dataclasses.replace(get_config(cfg["arch"]), num_layers=cfg["num_layers"])
    wrong = {f: (getattr(pc, f), cfg[f]) for f in CHECKED_FIELDS if getattr(pc, f) != cfg[f]}
    if pc.resolved_head_dim != cfg["head_dim"]:
        wrong["head_dim"] = (pc.resolved_head_dim, cfg["head_dim"])
    if tuple(pc.block_pattern) != ("attn",) or pc.tail_blocks:
        wrong["block_pattern"] = (pc.block_pattern, pc.tail_blocks)
    if wrong:
        raise ValueError(f"the port's {cfg['arch']} differs from the configuration file "
                         f"(port, file): {wrong}")
    return pc


@dataclass
class Records:
    inserts: List[tuple] = field(default_factory=list)   # (rid, start, end, prompt tokens)
    steps: List[tuple] = field(default_factory=list)     # (start, end, live, valid)
    tokens: Dict[int, List[float]] = field(default_factory=dict)
    due: Dict[int, float] = field(default_factory=dict)
    window: tuple = (0.0, 0.0)
    late_s: float = 0.0                                   # how late the generator ran
    pause: tuple = (0.0, 0.0)     # the loop's longest busy iteration up to the window's
                                  # close (s), and its start less the window's opening


class Program:
    """The port serving one cell: weights, engine, batcher and the timers."""

    def __init__(self, cell, seed: int, device: str = "cuda", trace: bool = False):
        from repro_torch.serving import ContinuousBatcher, Engine, EngineConfig
        self.cell, self.cfg, self.device, self.trace = cell, cell.config, device, trace
        self.pcfg = program_config(self.cfg)
        self.slots, self.cache_len = cell.setup["slots"], cell.setup["cache_len"]
        self.params = make_params(self.cfg, seed, device)
        self.ecfg = EngineConfig(slots=self.slots, cache_len=self.cache_len,
                                 dtype=DTYPES[self.cfg["dtype"]], device=device)
        self.engine = Engine(self.pcfg, self.params, self.ecfg)
        self.batcher = ContinuousBatcher(self.engine, clock=clock)
        self.rec = Records()
        self.mirror_t = np.zeros(self.slots, np.int64)
        self.requests: Dict[int, object] = {}
        self.finished: List[object] = []
        self._wrap()

    # -- timers -----------------------------------------------------------
    def _wrap(self):
        engine, batcher = self.engine, self.batcher
        insert, step, run_step = engine.insert, engine.step, batcher.run_step
        label = (lambda name, fn: profiling.in_range(name, fn)) if self.trace else (lambda n, f: f)
        insert, step = label("servebench.insert", insert), label("servebench.step", step)
        run_step = label("servebench.run_step", run_step)

        def timed_insert(req, slot=None):
            t0 = clock()
            s = insert(req, slot)
            t1 = clock()
            self.rec.inserts.append((req.rid, t0, t1, len(req.prompt)))
            self.rec.tokens[req.rid] = [t1]
            self.mirror_t[s] = len(req.prompt)
            return s

        def timed_step():
            slots = [i for i, r in enumerate(engine.slot_req) if r is not None]
            if not slots:
                return step()
            live = [engine.slot_req[i].rid for i in slots]
            valid = int(np.minimum(self.mirror_t[slots] + 1, self.cache_len).sum())
            t0 = clock()
            done = step()
            t1 = clock()
            self.mirror_t[slots] += 1
            self.rec.steps.append((t0, t1, len(live), valid))
            for rid in live:
                self.rec.tokens[rid].append(t1)
            return done

        def timed_run_step():
            done = run_step()
            self.finished.extend(done)
            return done

        engine.insert, engine.step, batcher.run_step = timed_insert, timed_step, timed_run_step

    def submit(self, arrival, due: float) -> None:
        from repro_torch.serving import Request
        # the engine's first token comes from the prefill: max_new_tokens
        # more come from the steps
        req = Request(rid=arrival.index, prompt=arrival.prompt,
                      max_new_tokens=arrival.output_len - 1)
        self.requests[req.rid] = req
        self.rec.due[req.rid] = due
        self.batcher.submit(req)

    # -- set-up -----------------------------------------------------------
    def warm_up(self, prompt_lengths) -> None:
        """Every shape the cell's traffic uses, once: a prefill at each
        given prompt length (the longest first, so the allocator's pool
        grows to it) and one decode step over every slot; then a fresh
        cache, so that the window starts from the engine's own start."""
        gen = np.random.default_rng(0)
        with torch.profiler.record_function("servebench.warm_up"):   # the ranges' first use
            self._warm_up(gen, prompt_lengths)
        self.reset()

    def _warm_up(self, gen, prompt_lengths) -> None:
        from repro_torch.models import model as model_lib
        for n in sorted(set(int(x) for x in prompt_lengths), reverse=True):
            toks = torch.as_tensor(gen.integers(0, self.cfg["vocab_size"], n), device=self.device)
            logits = model_lib.prefill(self.pcfg, self.params, toks[None, :],
                                       self.engine._init_cache(1))[0]
            int(torch.argmax(logits[0]))
        toks = torch.zeros(self.slots, dtype=torch.long, device=self.device)
        model_lib.decode_step(self.pcfg, self.params, toks, self.engine.cache)[0].cpu()

    def reset(self) -> None:
        """A fresh engine cache and empty records (the weights stay)."""
        self.engine.cache = None
        gc.collect()
        self.engine.cache = self.engine._init_cache(self.slots)
        self.engine.slot_req = [None] * self.slots
        self.engine.steps = 0
        self.batcher.queue.clear()
        self.mirror_t[:] = 0
        self.rec, self.requests, self.finished = Records(), {}, []

    def free(self) -> None:
        """Drop the engine's cache and queue (the program's state)."""
        self.engine.cache = None
        self.batcher.queue.clear()
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    # -- the traced stretch -------------------------------------------------
    def launches(self):
        from repro_torch.kernels import decode_attention, flash_attention
        return flash_attention.launches, decode_attention.launches


@dataclass
class Stretch:
    prof: object
    t0: float
    n_inserts: int
    n_steps: int
    launches: tuple
    record: object
    t1: float = 0.0
    end_inserts: int = 0
    end_steps: int = 0
    end_launches: tuple = (0, 0)


class Tracer:
    """Takes the traced stretch right after the window closes, while the
    traffic goes on as in the window (``TRACE_*`` above).  The profiler's
    stall (seconds of processing at its exit) so falls outside the window,
    whose records the host-clock metrics read."""

    def __init__(self, prog: Program):
        self.prog = prog
        self.active: Optional[Stretch] = None
        self.used: Optional[Stretch] = None
        self.reduced: Optional[Dict] = None
        self.tries = 0

    @property
    def settled(self) -> bool:
        return self.used is not None or self.tries >= TRACE_TRIES

    def step(self) -> None:
        """Called between scheduler steps after the window: begins, ends
        and reduces stretches."""
        if self.active is None:
            self._begin()
        elif self._done():
            self._end()

    def _begin(self):
        prof = profiling.start()
        rec = self.prog.rec
        record = torch.profiler.record_function(profiling.STRETCH)
        record.__enter__()
        self.active = Stretch(prof, clock(), len(rec.inserts), len(rec.steps),
                              self.prog.launches(), record)

    def _done(self) -> bool:
        st, rec = self.active, self.prog.rec
        steps = len(rec.steps) - st.n_steps
        prefills = len(rec.inserts) - st.n_inserts
        return (steps >= TRACE_MIN_STEPS and prefills >= TRACE_MIN_PREFILLS) or \
            clock() - st.t0 >= TRACE_MAX_S

    def _end(self):
        st, rec = self.active, self.prog.rec
        st.record.__exit__(None, None, None)
        torch.cuda.synchronize()
        st.t1 = clock()
        st.end_inserts, st.end_steps, st.end_launches = len(rec.inserts), len(rec.steps), \
            self.prog.launches()
        st.prof.__exit__(None, None, None)
        self.active = None
        self.tries += 1
        red = profiling.reduce(st.prof, st.end_launches[0] - st.launches[0],
                               st.end_launches[1] - st.launches[1])
        if red["missed"]:
            print(f"[trace] stretch {self.tries} missed records: {red['missed']}", file=sys.stderr)
        else:
            self.used, self.reduced = st, red


# ---------------------------------------------------------------------------
def serve(prog: Program, traffic: Traffic, seconds: float, rate: Optional[float] = None,
          tracer: Optional[Tracer] = None) -> Records:
    """One window of ``seconds`` under the mix's loop; returns the records.

    Open loop: requests are submitted as they fall due (at ``rate`` or the
    mix's own; ``Traffic.arrival_times`` over the lead-in, the window and
    the traced stretches' room), timed from their due time, from
    ``lead_in_s`` before the window opens (so that the window starts in a
    steady state; requests due then are served and not counted).  After the window the traced
    stretch, if any, is taken while arrivals go on; then arrivals stop and
    the run serves until every request due in the window has its first
    token.  Backlog: the queue is topped up to the slot count before every
    scheduler step; the window opens once every slot is live."""
    rec = prog.rec
    extra = TRACE_TRIES * TRACE_MAX_S if tracer is not None else 0.0
    if traffic.mix["loop"] == "open":
        rate = rate or traffic.mix["rate_per_s"]
        lead = float(traffic.mix.get("lead_in_s", 0.0))
        sched = traffic.open_schedule(rate, (lead, seconds, extra))
        nxt = 0
        t0 = clock()
        w0 = t0 + lead
        w1 = w0 + seconds
        rec.window = (w0, w1)
        last = t0
        while True:
            now = clock()
            if now <= w1 and now - last > rec.pause[0]:
                rec.pause = (now - last, last - w0)
            last = now
            tracing = tracer is not None and not tracer.settled
            while nxt < len(sched) and t0 + sched[nxt].due_s <= now and \
                    (sched[nxt].due_s < lead + seconds or tracing):
                if sched[nxt].due_s < lead + seconds:
                    rec.late_s = max(rec.late_s, now - (t0 + sched[nxt].due_s))
                prog.submit(sched[nxt], t0 + sched[nxt].due_s)
                nxt += 1
            if now >= w1:
                if tracing:
                    tracer.step()
                elif not prog.batcher.queue or now >= w1 + DRAIN_LIMIT_S:
                    break
            if prog.batcher.queue or prog.engine.live:
                prog.batcher.run_step()
            elif nxt < len(sched):
                sleep(max(0.0, t0 + sched[nxt].due_s - clock()))
                last = clock()          # an idle wait is no pause
    else:
        nxt = 0

        def top_up():
            nonlocal nxt
            while len(prog.batcher.queue) < prog.slots:
                prog.submit(traffic.request(nxt), clock())
                nxt += 1

        top_up()
        prog.batcher.run_step()             # fills every slot: the window opens after it
        w0 = last = clock()
        rec.window = (w0, w0 + seconds)
        while clock() < w0 + seconds or (tracer is not None and not tracer.settled):
            now = clock()
            if now <= w0 + seconds and now - last > rec.pause[0]:
                rec.pause = (now - last, last - w0)
            last = now
            if tracer is not None and now >= w0 + seconds:
                tracer.step()
            top_up()
            prog.batcher.run_step()
    if tracer is not None and tracer.active is not None:
        tracer._end()
    return rec


def peak_bytes(device: str) -> int:
    return int(torch.cuda.max_memory_allocated()) if device != "cpu" else 0


def device_info(device: str, chips: int) -> Dict:
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": chips}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
