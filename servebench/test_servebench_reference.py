"""The plain reference against the port on the CPU at ``reduced()``: the
prefill's last logits and each decode step's, teacher-forced on the tokens
the port chose, f32 on both sides; phi3.5-moe on prompts whose repeated
tokens overflow the experts' capacity, so that the prefill drops."""
import numpy as np
import pytest
import torch

from servebench import tiny
from servebench.harness import program_config
from servebench.reference import decoder
from servebench.weights import make_params

TOL = 1e-4      # f32 both sides, summed in other orders through two layers


def _port(cfg, params, prompt, steps):
    from repro_torch.models import model as model_lib
    pc = program_config(cfg)
    cache = model_lib.init_cache(pc, 1, 128, device="cpu")
    logits, cache = model_lib.prefill(pc, params, torch.as_tensor(prompt)[None, :], cache)
    out, toks = [logits[0]], []
    for _ in range(steps):
        toks.append(int(out[-1].argmax()))
        logits, cache = model_lib.decode_step(pc, params, torch.tensor([toks[-1]]), cache)
        out.append(logits[0])
    return torch.stack(out), toks


def _prompt(cfg, kind, n=40):
    rng = np.random.default_rng(1)
    if kind == "repeated":      # one id over 3/4 of the prompt: the experts overflow
        p = np.full(n, 17)
        p[::4] = rng.integers(0, cfg["vocab_size"], len(p[::4]))
        return p
    return rng.integers(0, cfg["vocab_size"], n)


@pytest.mark.parametrize("arch,kind", [(tiny.PHI, "random"), (tiny.PHI, "repeated"),
                                       (tiny.QWEN, "random")])
def test_reference_matches_the_port(arch, kind):
    cfg = tiny.config_dict(arch)
    params = make_params(cfg, 2**33 + 1, "cpu")
    prompt = _prompt(cfg, kind)
    port, toks = _port(cfg, params, prompt, 6)
    seq = torch.as_tensor(np.concatenate([prompt, toks]))
    p = len(prompt)
    ref = decoder.logits_at(cfg, params, seq, p, range(p - 1, p + len(toks)))
    assert (port - ref).abs().max() < TOL * ref.abs().max()
    if kind == "repeated":
        # the prompt's drops are reproduced: routing it without a capacity differs
        dropless = decoder.logits_at(cfg, params, seq, 0, range(p - 1, p + len(toks)))
        assert (dropless - ref).abs().max() > 100 * TOL * ref.abs().max()


def test_reference_moe_drops_past_capacity_in_token_order():
    cfg = tiny.config_dict(tiny.PHI)
    e, k = cfg["num_experts"], cfg["num_experts_per_tok"]
    h = torch.zeros(40, cfg["d_model"])
    h[:, 0] = 1.0
    router = torch.zeros(cfg["d_model"], e)
    router[0, :k] = torch.arange(k, 0, -1).float()      # every token picks experts 0 and 1
    p = {"router": router,
         "wi_gate": torch.ones(e, cfg["d_model"], 8), "wi_up": torch.ones(e, cfg["d_model"], 8),
         "wo": torch.ones(e, 8, cfg["d_model"])}
    y = decoder._moe(cfg, p, h, 40, "f32")
    c = max(8, -(-(int(40 * k * cfg["moe_capacity_factor"] / e) + 1) // 8) * 8)
    kept = (y.abs().sum(-1) > 0).sum()
    assert int(kept) == c and bool((y[:c].abs().sum(-1) > 0).all())


def test_control_is_float8():
    x = torch.randn(64, 64)
    q = decoder._fp8(x)
    assert not torch.equal(q, x)
    assert (q - x).abs().max() <= x.abs().max() / 8


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tuple(tree.shape), tree.dtype


@pytest.mark.parametrize("arch", [tiny.PHI, tiny.QWEN])
def test_the_weight_tree_has_the_ports_layout(arch):
    from repro_torch.models import model as model_lib
    from servebench.weights import param_count
    cfg = tiny.config_dict(arch, dtype="bfloat16")
    pc = program_config(cfg)
    mine = sorted(_leaves(make_params(cfg, 3, "cpu")))
    assert mine == sorted(_leaves(model_lib.abstract_params(pc, dtype=torch.bfloat16)))
    assert param_count(cfg) == model_lib.param_count(pc)
