"""LR schedules — WSD (warmup-stable-decay, MiniCPM arXiv:2404.06395),
cosine, and linear.

``make_schedule(cfg)(step)`` takes the step as an int tensor on the device
(or a Python int) and returns the learning rate as a 0-d float32 tensor on
the same device, computed in float32 with the JAX package's operations in
its order, so a training step never waits on the host for it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "wsd"            # wsd | cosine | linear | constant
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    # WSD: decay starts at ``decay_start`` fraction of total (MiniCPM: ~0.9)
    decay_start_frac: float = 0.9
    min_lr_frac: float = 0.1


def make_schedule(cfg: ScheduleConfig):
    if cfg.kind not in ("wsd", "cosine", "linear", "constant"):
        raise ValueError(cfg.kind)

    def sched(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
        if cfg.kind == "constant":
            frac = 1.0
        elif cfg.kind == "linear":
            frac = 1.0 - torch.clamp(
                (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0,
            ) * (1.0 - cfg.min_lr_frac)
        elif cfg.kind == "cosine":
            prog = torch.clamp(
                (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0,
            )
            frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        else:   # wsd
            decay_start = cfg.decay_start_frac * cfg.total_steps
            # stable at 1.0 until decay_start, then exponential-ish decay to min
            prog = torch.clamp(
                (s - decay_start) / max(cfg.total_steps - decay_start, 1), 0.0, 1.0)
            frac = torch.where(s < decay_start, torch.ones_like(prog),
                               torch.pow(torch.tensor(cfg.min_lr_frac, device=s.device), prog))
        return cfg.peak_lr * warm * frac

    return sched
