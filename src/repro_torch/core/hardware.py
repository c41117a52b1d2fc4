"""TPU v5e machine model — the single source of hardware truth.

Every latency/cost number in the serving layer and every roofline term in
the benchmarks is derived from these constants; nothing is wall-clocked on
this CPU-only container.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12        # FLOP/s per chip
    hbm_bandwidth: float = 819e9           # B/s per chip
    hbm_bytes: float = 16e9                # HBM capacity per chip
    ici_bandwidth: float = 50e9            # B/s per ICI link
    ici_links: int = 4                     # links per chip (2D torus)
    # achievable fractions (serving-engine planning numbers, not marketing)
    mfu_serving: float = 0.45              # matmul-heavy prefill
    mbu_serving: float = 0.70              # HBM-bound decode


V5E = ChipSpec()


@dataclass(frozen=True)
class FleetPricing:
    """Public-cloud pricing for the two procurement kinds (paper §II).

    ``reserved``  — long-lived slice, billed per chip-hour while held
                    (the paper's VM).
    ``burst``     — per-invocation multiplexed warm pool, billed per
                    chip-second of use at a premium + a per-request fee
                    (the paper's serverless function).  The premium is the
                    Lambda-vs-EC2 compute-cost ratio (~4-8x); we use 5x.
    """

    reserved_chip_hour: float = 1.20       # $/chip-hour (v5e on-demand)
    burst_premium: float = 5.0             # burst $/chip-s = reserved rate x this
    burst_invocation_fee: float = 2e-6     # $/request (API gateway analog)
    object_store_bandwidth: float = 2.5e9  # B/s weight fetch (cold start)
    reserved_provision_s: float = 120.0    # slice acquisition latency
    burst_spinup_s: float = 1.0            # warm-pool dispatch latency
    burst_idle_timeout_s: float = 600.0    # pool recycles idle model images
    # --- spot tier (paper §VI future work, implemented beyond-paper) ----
    spot_discount: float = 0.3             # spot $/chip-hour = reserved x this
    spot_preempt_rate: float = 1.0 / 1800  # Poisson reclaim: ~1 per 30 min
    spot_provision_s: float = 120.0        # same slice acquisition latency
    # --- harvest-VM tier (spare capacity carved from running hosts) -----
    harvest_discount: float = 0.15         # deepest discount of the portfolio
    harvest_provision_s: float = 60.0      # no slice boot: host already runs
    harvest_cap_per_arch: int = 16         # provider ceiling at full harvest
                                           # availability (level 1.0)
    # --- multi-region reserved tier (second region, cheaper, farther) ---
    remote_discount: float = 0.85          # remote $/chip-hour = reserved x this
    remote_provision_s: float = 300.0      # cross-region slice acquisition
    remote_egress_s: float = 0.25          # per-request network egress adder
                                           # (why strict traffic prefers local)
    # --- model-variant swaps (INFaaS-style model-less serving) ----------
    variant_swap_s: float = 60.0           # weight reload onto held slices;
                                           # faster than acquiring a slice,
                                           # not free (serves at the OLD
                                           # variant's rate meanwhile)

    @property
    def reserved_chip_s(self) -> float:
        return self.reserved_chip_hour / 3600.0

    @property
    def burst_chip_s(self) -> float:
        return self.reserved_chip_s * self.burst_premium


PRICING = FleetPricing()
