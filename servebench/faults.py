"""Faults planted under the timed path, for the test that sees ``correct``
come out false and for ``calibrate.py --fault`` on the card.  Each wraps
``repro_torch.models.model.decode_step``, which ``Engine.step`` looks up at
each call.  A one-card cell has no exchange between chips to leave out."""
from __future__ import annotations

import contextlib

import torch


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def state_unchanged(step):
    """The step computes its logits and returns the cache as it found it."""
    def broken(cfg, params, tokens, cache, **kw):
        logits, _ = step(cfg, params, tokens, _clone(cache), **kw)
        return logits, cache
    return broken


def half_the_batch(step):
    """Every second slot is left out and gets the mean of the others'
    logits.  The engine fills the lowest free slot first, so the live slots
    are the low ones, and every second one of them is hit."""
    def broken(cfg, params, tokens, cache, **kw):
        logits, cache = step(cfg, params, tokens, cache, **kw)
        out = logits.clone()
        out[1::2] = logits[0::2].mean(0, keepdim=True)
        return out, cache
    return broken


def token_altered(step):
    """Every third step each slot's chosen token becomes the next id."""
    calls = [0]

    def broken(cfg, params, tokens, cache, **kw):
        logits, cache = step(cfg, params, tokens, cache, **kw)
        calls[0] += 1
        return (logits.roll(1, dims=-1) if calls[0] % 3 == 0 else logits), cache
    return broken


FAULTS = {"state_unchanged": state_unchanged, "half_the_batch": half_the_batch,
          "token_altered": token_altered}


@contextlib.contextmanager
def planted(name: str):
    from repro_torch.models import model as model_lib
    original = model_lib.decode_step
    model_lib.decode_step = FAULTS[name](original)
    try:
        yield
    finally:
        model_lib.decode_step = original
