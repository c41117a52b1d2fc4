"""Inference engine: slot-based continuous batching over the model zoo.

The engine owns a fixed batch of ``slots`` decode lanes sharing one cache
tree (the per-sequence ``t`` vector makes ragged lockstep decode safe).
A new request is prefilled at batch 1 and scattered into a free slot; every
``step()`` decodes one token for all live slots.  This is the execution
layer underneath the paper's serving system: a reserved slice runs exactly
this engine, and ``max_concurrency`` from the profile is its slot count.

While a profiler collects, ``insert`` and ``step`` record spans
(``repro_torch.tracing``): ``engine.insert`` (the request's ``rid``; the
prompt upload, which waits for the card's queue, is its own time) over
``.cache``, ``.prefill`` (the enqueue), ``.first_token`` (the host waits on
the card) and ``.scatter``; ``engine.step`` over ``.launch`` (the token
upload and the enqueue of ``decode_step``), ``.wait`` (the ``.cpu()`` of
the argmax) and ``.retire``, with the counts ``slots``, ``live`` and
``valid_kv`` and the live slots' mask as its ``live_rows``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.registry import ModelConfig
from repro_torch.models import model as model_lib


@dataclass(frozen=True)
class EngineConfig:
    slots: int = 8                  # concurrent decode lanes
    cache_len: int = 512            # per-slot KV capacity
    window: int = 0                 # sliding-window mode (long-context)
    max_new_tokens: int = 64
    temperature: float = 0.0        # 0 = greedy
    dtype: Any = torch.float32
    device: str = "cuda"


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int32 tokens
    max_new_tokens: int = 64
    # filled by the engine:
    output: List[int] = field(default_factory=list)
    prefill_done: bool = False
    finished: bool = False
    enqueued_at: float = 0.0


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _scatter(full, one, slot: int, batch_axis: int) -> None:
    if isinstance(full, dict):
        for key in full:
            _scatter(full[key], one[key], slot, batch_axis)
    else:
        full.select(batch_axis, slot).copy_(one.select(batch_axis, 0))


def _scatter_slot(cache_tree, sub_tree, slot: int):
    """Write a batch-1 cache into batch slot ``slot`` of the shared cache,
    in place.

    Cache layout (see model.init_cache): leaves under ``blocks`` and
    whisper's ``cross`` are layer-stacked -> batch axis 1; ``tail`` entries
    and the per-seq ``t`` counter are unstacked -> batch axis 0."""
    for key, full in cache_tree.items():
        _scatter(full, sub_tree[key], slot, 1 if key in ("blocks", "cross") else 0)
    return cache_tree


class Engine:
    """Continuous-batching engine for one model."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig = EngineConfig()):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = torch.device(ecfg.device)
        self.cache = self._init_cache(ecfg.slots)
        self.slot_req: List[Optional[Request]] = [None] * ecfg.slots
        self.slot_remaining = np.zeros(ecfg.slots, np.int32)
        self.next_token = np.zeros(ecfg.slots, np.int32)
        self.steps = 0

    def _init_cache(self, batch: int):
        return model_lib.init_cache(
            self.cfg, batch, self.ecfg.cache_len, window=self.ecfg.window,
            dtype=self.ecfg.dtype, device=self.device,
        )

    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    @property
    def live(self) -> int:
        return sum(r is not None for r in self.slot_req)

    # ------------------------------------------------------------------
    def insert(self, req: Request, slot: Optional[int] = None) -> int:
        """Prefill ``req`` and install it in a free slot."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot")
        slot = free[0] if slot is None else slot
        with tracing.span("engine.insert", rid=req.rid):
            tracing.count("prompt_tokens", len(req.prompt))
            tokens = torch.as_tensor(np.asarray(req.prompt), dtype=torch.long, device=self.device)
            with tracing.span("engine.insert.cache"):
                cache1 = self._init_cache(1)
                if tracing.enabled():
                    tracing.count("cache_bytes", _tree_bytes(cache1))
            with tracing.span("engine.insert.prefill"):
                logits, cache1 = model_lib.prefill(
                    self.cfg, self.params, tokens[None, :], cache1, window=self.ecfg.window,
                )
            with tracing.span("engine.insert.first_token"):
                first = int(torch.argmax(logits[0]))   # first index on ties, as jnp.argmax
            with tracing.span("engine.insert.scatter"):
                _scatter_slot(self.cache, cache1, slot)
        self.slot_req[slot] = req
        self.slot_remaining[slot] = req.max_new_tokens
        self.next_token[slot] = first
        req.prefill_done = True
        req.output.append(first)
        return slot

    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """Decode one token for every live slot; return finished requests."""
        if self.live == 0:
            return []
        with tracing.span("engine.step") as sp:
            if sp is not None:
                self._count_slots()
            with tracing.span("engine.step.launch"):
                tokens = self._upload_tokens(sp)
                logits, self.cache = model_lib.decode_step(
                    self.cfg, self.params, tokens, self.cache, window=self.ecfg.window
                )
            with tracing.span("engine.step.wait"):
                nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
            self.steps += 1

            finished = []
            with tracing.span("engine.step.retire"):
                for i, req in enumerate(self.slot_req):
                    if req is None:
                        continue
                    self.next_token[i] = nxt[i]
                    req.output.append(int(nxt[i]))
                    self.slot_remaining[i] -= 1
                    if self.slot_remaining[i] <= 0:
                        req.finished = True
                        finished.append(req)
                        self.slot_req[i] = None
                tracing.count("finished", len(finished))
        return finished

    def _count_slots(self) -> None:
        """The open step's counts: the decoded ``slots``, the ``live`` ones
        and their valid cache positions ``valid_kv`` (the prompt and the
        outputs so far, at most the cache or the window)."""
        cap = min(self.ecfg.cache_len, self.ecfg.window or self.ecfg.cache_len)
        live = [r for r in self.slot_req if r is not None]
        tracing.count("slots", len(self.slot_req))
        tracing.count("live", len(live))
        tracing.count("valid_kv", sum(min(len(r.prompt) + len(r.output), cap) for r in live))

    def _upload_tokens(self, sp) -> torch.Tensor:
        """The step's tokens on the device.  Traced (``sp`` the open step),
        they go up in one copy with the live slots' mask, which becomes
        ``sp.live_rows``: a second copy would wait on the card again."""
        if sp is None:
            return torch.as_tensor(self.next_token, dtype=torch.long, device=self.device)
        live = [r is not None for r in self.slot_req]
        up = torch.as_tensor(np.stack([self.next_token, live]), dtype=torch.long,
                             device=self.device)
        sp.live_rows = up[1] > 0
        return up[0]
