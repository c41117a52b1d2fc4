"""Training step + loop.

``make_train_step`` differentiates ``model.loss_fn`` with autograd: on the
card every attention and WKV call runs its hand-written kernel forward and
the plain version's VJP backward (``kernels/ops.py``).  The step reads
nothing back to the host; ``train`` reads the metrics only at logged steps,
as the JAX package's loop does.  On DTensor parameters (``launch/specs.py:
build_step`` on a ``DeviceMesh``) the step runs under ``partitioned``, its
backward included, and the optimizer keeps each moment on its parameter's
placements.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ModelConfig
from repro_torch.distributed.sharding import partitioned
from repro_torch.models import model as model_lib
from repro_torch.training.optimizer import (
    OptimizerConfig, adamw_init, adamw_update, tree_leaves, tree_unflatten)
from repro_torch.training.schedule import ScheduleConfig, make_schedule


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    window: int = 0                  # sliding-window attention (0 = full)
    moe_path: str = "local"          # local | ep_a2a | dense
    remat: object = True      # False | True | 'dots'
    aux_weight: float = 0.01


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    ``batch`` holds tensors on the parameters' device; the returned
    parameters and state are new tensors (the inputs are left as they
    were), and the metrics (``loss``, ``ce``, ``aux``, ``grad_norm``,
    ``lr``) are 0-d tensors on the device."""
    sched = make_schedule(tcfg.schedule)

    @partitioned()
    def train_step(params, opt_state, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, parts = model_lib.loss_fn(
            cfg, tree_unflatten(params, leaves), batch,
            window=tcfg.window, moe_path=tcfg.moe_path,
            remat=tcfg.remat, aux_weight=tcfg.aux_weight,
        )
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        lr = sched(opt_state["step"])
        params, opt_state, om = adamw_update(
            params, tree_unflatten(params, grads), opt_state, tcfg.optimizer, lr=lr
        )
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}, **om}
        return params, opt_state, metrics

    return train_step


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A NumPy batch of ``SyntheticLM`` on ``device``: tokens and labels as
    int64, embeddings and encoder frames as they are (float32)."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.asarray(a))
        out[k] = t.long() if t.dtype == torch.int32 else t
    return {k: t.to(device) for k, t in out.items()}


def train(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    data_iter,
    num_steps: int,
    *,
    seed: int = 0,
    param_dtype=torch.float32,
    log_every: int = 10,
    callback: Optional[Callable[[int, Dict[str, Any]], None]] = None,
    device="cuda",
):
    """Single-host training loop; on the card by default (``device="cpu"``
    runs the plain versions)."""
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(seed), dtype=param_dtype,
                                   device=device)
    opt_state = adamw_init(params, tcfg.optimizer)
    step_fn = make_train_step(cfg, tcfg)

    history = []
    t0 = time.perf_counter()
    for step in range(num_steps):
        batch = batch_to(next(data_iter), device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % log_every == 0 or step == num_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            if callback:
                callback(step, m)
    return params, opt_state, history
