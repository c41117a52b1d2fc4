"""Model profiles — the paper's "offline profiling" table, derived.

The paper profiles every (model x resource) pair on AWS and stores
latency/accuracy/memory in an offline cache that the scheduler consults.
We derive the same table analytically from the TPU v5e machine model
(:mod:`repro_torch.core.hardware`) and each architecture's config: FLOPs and
bytes per prefill/decode step -> roofline latency; published model quality
-> the accuracy axis.  The dry-run artifacts (compiled HLO statistics) can
recalibrate these numbers when present, exactly like the paper's
"results from previous executions".
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs.registry import (
    ATTN,
    LOCAL_ATTN,
    RGLRU,
    RWKV,
    ModelConfig,
    get_config,
    list_architectures,
)
from repro_torch.core.hardware import PRICING, V5E, ChipSpec, FleetPricing

BYTES_PER_PARAM = 2  # bf16 serving weights


@dataclass(frozen=True)
class RequestClass:
    """A unit of work: one inference query (paper's "request")."""

    name: str = "standard"
    prompt_tokens: int = 512
    decode_tokens: int = 64
    slo_s: float = 1.0            # response-latency SLO (paper: sub-second)
    strict: bool = True           # strict vs relaxed latency class (§IV.B)


STANDARD = RequestClass()
RELAXED = RequestClass("relaxed", 512, 64, slo_s=4.0, strict=False)


@dataclass(frozen=True)
class ModelProfile:
    """Latency/cost/accuracy characterization of one arch on one slice."""

    cfg: ModelConfig
    chips: int
    chip: ChipSpec = V5E
    pricing: FleetPricing = PRICING

    # ------------------------------------------------------------------ sizes
    @property
    def weight_bytes(self) -> float:
        return BYTES_PER_PARAM * self.cfg.params_total

    @property
    def active_bytes(self) -> float:
        return BYTES_PER_PARAM * self.cfg.params_active

    def kv_bytes_per_token(self) -> float:
        """Decode-state bytes per cached token (0 for pure-SSM archs)."""
        cfg = self.cfg
        per_tok = 0.0
        for kind in cfg.layer_kinds():
            if kind in (ATTN, LOCAL_ATTN):
                per_tok += 2 * cfg.num_kv_heads * cfg.resolved_head_dim * BYTES_PER_PARAM
        return per_tok

    def state_bytes(self, context: int) -> float:
        """Total decode state for one sequence with ``context`` live tokens."""
        cfg = self.cfg
        fixed = 0.0
        per_tok = 0.0
        for kind in cfg.layer_kinds():
            if kind == ATTN:
                per_tok += 2 * cfg.num_kv_heads * cfg.resolved_head_dim * BYTES_PER_PARAM
            elif kind == LOCAL_ATTN:
                w = min(cfg.local_window or context, context)
                fixed += 2 * cfg.num_kv_heads * cfg.resolved_head_dim * BYTES_PER_PARAM * w
            elif kind == RGLRU:
                fixed += 4 * (cfg.rglru_width or cfg.d_model) * 4  # conv + h fp32
            elif kind == RWKV:
                hd = cfg.rwkv_head_dim
                fixed += (cfg.d_model // hd) * hd * hd * 4 + 2 * cfg.d_model * 2
        return fixed + per_tok * context

    @property
    def min_chips(self) -> int:
        """Smallest slice whose HBM holds weights + ~30% headroom."""
        need = self.weight_bytes * 1.3
        return max(1, math.ceil(need / self.chip.hbm_bytes))

    # --------------------------------------------------------------- latency
    def _collective_step_s(self, batch: int) -> float:
        """Per-decode-step tensor-parallel all-reduce cost on this slice."""
        if self.chips == 1:
            return 0.0
        cfg = self.cfg
        # 2 all-reduces per layer (attn out + ffn out) of (B, 1, d) activations
        bytes_per = 2 * cfg.num_layers * batch * cfg.d_model * BYTES_PER_PARAM
        ring = 2.0 * (self.chips - 1) / self.chips
        links = self.chip.ici_bandwidth * self.chip.ici_links / 2
        return bytes_per * ring / links + 2 * cfg.num_layers * 1e-6  # + launch

    def prefill_latency(self, prompt: int, batch: int = 1) -> float:
        flops = 2.0 * self.cfg.params_active * prompt * batch
        compute = flops / (self.chips * self.chip.peak_flops_bf16 * self.chip.mfu_serving)
        memory = self.active_bytes / (self.chips * self.chip.hbm_bandwidth * self.chip.mbu_serving)
        coll = self._collective_step_s(batch) * max(1, prompt // 512)
        return max(compute, memory) + coll

    def decode_step_latency(self, batch: int, context: int = 576) -> float:
        """One token for every sequence in a batch of ``batch``."""
        flops = 2.0 * self.cfg.params_active * batch
        compute = flops / (self.chips * self.chip.peak_flops_bf16 * self.chip.mfu_serving)
        state = self.state_bytes(context) * batch
        memory = (self.active_bytes + state) / (
            self.chips * self.chip.hbm_bandwidth * self.chip.mbu_serving
        )
        return max(compute, memory) + self._collective_step_s(batch)

    def request_latency(self, req: RequestClass = STANDARD, batch: int = 1) -> float:
        """End-to-end latency of one request in a continuous batch of ``batch``.

        The request runs its own prefill once (prefills are staggered, so
        batch=1 for that term) and then decodes in lockstep with the other
        ``batch-1`` residents — the decode-step batch is what congestion
        costs (paper §II-B: 'number of concurrent requests a VM can execute
        without violating response latency')."""
        ctx = req.prompt_tokens + req.decode_tokens
        return self.prefill_latency(req.prompt_tokens, 1) + req.decode_tokens * (
            self.decode_step_latency(batch, ctx)
        )

    # ------------------------------------------------------------- capacity
    def max_concurrency(self, req: RequestClass = STANDARD) -> int:
        """Paper §II-B: requests a slice executes in parallel within SLO."""
        ctx = req.prompt_tokens + req.decode_tokens
        hbm_free = self.chips * self.chip.hbm_bytes - self.weight_bytes * 1.1
        if hbm_free <= 0:
            return 0
        state = max(self.state_bytes(ctx), 1.0)
        mem_cap = int(hbm_free / state)
        b = 1
        while b <= 4096:
            if self.request_latency(req, b * 2) > req.slo_s or b * 2 > mem_cap:
                break
            b *= 2
        while b < mem_cap and self.request_latency(req, b + max(1, b // 8)) <= req.slo_s:
            b += max(1, b // 8)
        return 0 if self.request_latency(req, 1) > req.slo_s else min(b, mem_cap)

    def throughput(self, req: RequestClass = STANDARD) -> float:
        """Steady-state requests/s of one slice at max concurrency."""
        b = self.max_concurrency(req)
        if b == 0:
            return 0.0
        return b / self.request_latency(req, b)

    # ----------------------------------------------------------------- cost
    def reserved_cost_per_hour(self) -> float:
        return self.chips * self.pricing.reserved_chip_hour

    def burst_cost_per_request(self, req: RequestClass = STANDARD) -> float:
        """$/invocation on the burst pool.

        Hardware-adaptation note (DESIGN.md A6): Lambda bills memory x
        duration of a function that is busy for the whole CNN inference.
        A TPU burst pool is internally batched by the provider (that is
        what makes a multiplexed warm pool viable at all), so the billable
        chip-seconds per invocation are the *amortized* slice time at the
        pool's serving batch, marked up by the burst premium.  The premium
        (5x) is the Lambda-vs-EC2 compute-cost ratio; the invocation still
        *observes* batch-1 latency + spin-up."""
        thr = self.throughput(req)
        if thr <= 0:
            return float("inf")
        busy_chip_s = self.chips / thr
        return busy_chip_s * self.pricing.burst_chip_s + self.pricing.burst_invocation_fee

    def cold_start_s(self) -> float:
        """Burst cold start: weight fetch from the object store + dispatch."""
        return (
            self.pricing.burst_spinup_s
            + self.weight_bytes / self.pricing.object_store_bandwidth
        )


# ---------------------------------------------------------------------------
# The offline model cache (paper §IV-A).
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def get_profile(
    arch: str, chips: Optional[int] = None, req: RequestClass = STANDARD
) -> ModelProfile:
    """Profile of ``arch`` on a slice.  With ``chips=None`` the slice is
    right-sized (paper Observation 2): the smallest multiple of the
    HBM-minimum that meets the request class's SLO at batch 1."""
    cfg = get_config(arch)
    if chips is not None:
        return ModelProfile(cfg, chips)
    base = ModelProfile(cfg, 1).min_chips
    for mult in (1, 2, 4, 8):
        prof = ModelProfile(cfg, base * mult)
        if prof.request_latency(req, 1) <= req.slo_s:
            return prof
    return ModelProfile(cfg, base * 8)


@functools.lru_cache(maxsize=None)
def model_pool(req: RequestClass = STANDARD) -> Dict[str, dict]:
    """Fig-2 style pool: accuracy / latency / cost per architecture.

    Latency is the batch-1 request latency on the model's minimal slice;
    cost is $/1k requests when served on fully-utilized reserved slices.
    """
    pool: Dict[str, dict] = {}
    for arch in list_architectures():
        prof = get_profile(arch)
        thr = prof.throughput(req)
        cost_1k = (
            prof.reserved_cost_per_hour() / max(thr * 3600.0, 1e-9) * 1000.0
            if thr > 0
            else float("inf")
        )
        pool[arch] = {
            "arch": arch,
            "family": prof.cfg.family,
            "chips": prof.chips,
            "accuracy": prof.cfg.quality,
            "latency_s": prof.request_latency(req, 1),
            "throughput_rps": thr,
            "concurrency": prof.max_concurrency(req),
            "cost_per_1k": cost_1k,
            "burst_cost_per_req": prof.burst_cost_per_request(req),
            "cold_start_s": prof.cold_start_s(),
            "params_total": prof.cfg.params_total,
            "params_active": prof.cfg.params_active,
        }
    return pool


def iso_latency_set(max_latency_s: float, req: RequestClass = STANDARD):
    return {
        a: e for a, e in model_pool(req).items() if e["latency_s"] <= max_latency_s
    }


def iso_accuracy_set(min_accuracy: float, req: RequestClass = STANDARD):
    return {
        a: e for a, e in model_pool(req).items() if e["accuracy"] >= min_accuracy
    }
