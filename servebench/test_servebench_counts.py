"""The benchmark's FLOP counts against ``FlopCounterMode`` on the port's
own calls at ``reduced()`` (CPU, plain versions: full attention and every
capacity row, which the counts' options reproduce)."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from servebench import counts, tiny
from servebench.harness import program_config
from servebench.weights import make_params

ARCHS = [tiny.PHI, tiny.QWEN]


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s", [7, 40])
def test_prefill_flops(arch, s):
    from repro_torch.models import model as model_lib
    cfg = tiny.config_dict(arch)
    pc, params = program_config(cfg), make_params(cfg, 5, "cpu")
    tokens = torch.arange(s)[None, :] % cfg["vocab_size"]
    got = _counted(lambda: model_lib.prefill(pc, params, tokens,
                                             model_lib.init_cache(pc, 1, 64, device="cpu")))
    assert got == counts.prefill_flops(cfg, s, attention="full", experts="capacity")
    assert counts.prefill_flops(cfg, s) < got


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_flops(arch):
    from repro_torch.models import model as model_lib
    cfg = tiny.config_dict(arch)
    pc, params = program_config(cfg), make_params(cfg, 5, "cpu")
    slots, cache_len = 4, 32
    cache = model_lib.init_cache(pc, slots, cache_len, device="cpu")
    got = _counted(lambda: model_lib.decode_step(pc, params, torch.zeros(slots, dtype=torch.long),
                                                 cache))
    # the plain decode attention reads every cache slot, valid or not
    assert got == counts.decode_flops(cfg, slots, slots * cache_len, experts="capacity")


def test_experts_reached_and_bounds():
    cfg = tiny.config_dict(tiny.PHI)
    e = cfg["num_experts"]
    assert counts.experts_reached(cfg, 1) == pytest.approx(cfg["num_experts_per_tok"])
    assert counts.experts_reached(cfg, 10_000) == pytest.approx(e)
    assert counts.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_capacity_is_the_ports():
    from repro_torch.models import moe
    pc = program_config(tiny.config_dict(tiny.PHI))
    cfg = tiny.config_dict(tiny.PHI)
    for t in (1, 7, 64, 300, 2048, 3840):
        assert counts.capacity(cfg, t) == moe._capacity(pc, t)
