"""How ``correct`` is decided.

Once the window has closed and the program's state is freed, a sample of
the requests it finished, drawn from the seed with the longest of them in
it, goes through the plain reference (``reference/<name>.py``, f32) over
each prompt and the tokens the program served, and each served token is
judged by the gap by which its reference logit lies below the reference's
best at that position (0 where the program chose the reference's best).
A cell compares the widest gap or the mean gap over the sample's tokens,
each against its limit (``cells/<cell>.json`` ``limits``): the one that
separates sound runs from the control on the card (PERF.md).  Besides: every
request due in the window has its first token (one that never comes is
not correct), and every request in the sample ran exactly its drawn
number of output tokens.

``control=True`` also reads the control: the reference in float8
(``precision="fp8"``) at the same positions, its first choice judged by
the same gap.  The benchmark's own runs do not compute it.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import numpy as np
import torch

from servebench.traffic import _seed_words


def sample(finished: List, n: int, seed: int) -> List:
    """``n`` finished requests drawn from the seed, the longest first."""
    if not finished:
        return []
    by_len = sorted(finished, key=lambda r: (-len(r.output), r.rid))
    rest = sorted(by_len[1:], key=lambda r: r.rid)
    rng = np.random.default_rng(np.random.SeedSequence(_seed_words(seed) + [3]))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [by_len[0]] + [rest[i] for i in sorted(pick)]


def gaps(cfg: Dict, params: Dict, req, device, control: bool = False) -> Dict:
    """Reference gaps of one served request's tokens (and the control's)."""
    ref = importlib.import_module(f"servebench.reference.{cfg['reference']}")
    prompt = np.asarray(req.prompt, dtype=np.int64)
    out = np.asarray(req.output, dtype=np.int64)
    p = len(prompt)
    tokens = torch.as_tensor(np.concatenate([prompt, out[:-1]]), device=device)
    positions = range(p - 1, p - 1 + len(out))
    logits = ref.logits_at(cfg, params, tokens, p, positions)
    best = logits.max(dim=-1).values
    served = torch.as_tensor(out, device=device)
    rows = torch.arange(len(out), device=device)
    res = {"gaps": (best - logits[rows, served]).tolist()}
    if control:
        low = ref.logits_at(cfg, params, tokens, p, positions, precision="fp8")
        res["control_gaps"] = (best - logits[rows, low.argmax(dim=-1)]).tolist()
    return res


def readings(per: List[Dict], key: str = "gaps") -> Dict:
    """The numbers a cell may compare, over every token of the sample: the
    widest gap and the mean gap."""
    xs = [g for r in per for g in r[key]]
    if not xs:
        return {"max_gap": float("inf"), "mean_gap": float("inf")}
    return {"max_gap": max(xs), "mean_gap": sum(xs) / len(xs)}


def judge(cell, prog, seed: int, control: bool = False) -> Dict:
    """The numbers compared, each with its limit (``cells/<cell>.json``
    ``limits``), and ``correct``; the other readings beside them."""
    rec = prog.rec
    w0, w1 = rec.window
    due_in_window = [rid for rid, due in rec.due.items() if w0 <= due < w1] \
        if cell.traffic["loop"] == "open" else []
    unanswered = sum(1 for rid in due_in_window if rid not in rec.tokens)
    want = cell.setup["sample_requests"]
    picked = sample(prog.finished, want, seed)
    wrong_len = sum(1 for r in picked if len(r.output) != r.max_new_tokens + 1)
    per = [gaps(cell.config, prog.params, r, prog.device, control) for r in picked]
    got = readings(per)
    checks = {"unanswered": {"value": unanswered, "limit": 0},
              "wrong_length": {"value": wrong_len, "limit": 0},
              "sampled": {"value": len(picked), "limit": want}}
    for name, limit in cell.setup["limits"].items():
        checks[name] = {"value": got[name], "limit": limit}
    correct = (unanswered == 0 and wrong_len == 0 and len(picked) >= want
               and all(got[name] <= limit for name, limit in cell.setup["limits"].items()))
    out = {"correct": bool(correct), "checks": checks, "readings": got,
           "tokens_compared": sum(len(r["gaps"]) for r in per),
           "per_request_max_gap": [max(r["gaps"], default=0.0) for r in per]}
    if control:
        out["control"] = readings(per, "control_gaps")
    return out
