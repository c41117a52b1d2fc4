"""``chip_smoke.py``'s launch accounting for the VLM and the sliding-window
mode, counted on the CPU.

On the card each call of ``ops.flash_attention``, ``ops.decode_attention``
and ``ops.rwkv6`` launches its kernel once and the kernel's wrapper counts
it; on the CPU the same calls reach the plain versions, so here a counter
wraps each ``ops`` entry (the model looks them up at every call) and the
counts are held to ``chip_smoke.expected_launches``, as phases 3h and 3k
hold the card's counters: a reduced llava-next-mistral-7b served in
batches at the model's entry points on patch and text embeddings
(``chip_smoke.generate``, ``chip_smoke.vlm_inputs``), a reduced llama3-8b
served by the engine in sliding-window mode on prompts longer than its
ring, and the f32 checks' teacher-forced runs of both.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import frontends, model  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Engine, EngineConfig, Request  # noqa: E402

# kernel (chip_smoke.KERNELS) -> the ops entry that launches it on the card
ENTRIES = {"flash_attention": "flash_attention", "decode_attention": "decode_attention",
           "rwkv6_scan": "rwkv6"}


@pytest.fixture
def counts(monkeypatch):
    """Calls of each kernel's ops entry, by kernel; ``torch.cuda.synchronize``
    a no-op (``chip_smoke.generate`` syncs around its timed calls)."""
    seen = {name: 0 for name in chip_smoke.KERNELS}
    for name, entry in ENTRIES.items():
        def counted(*args, _fn=getattr(ops, entry), _name=name, **kwargs):
            seen[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(ops, entry, counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    return seen


def _params(cfg, seed=0):
    return model.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")


def test_vlm_batches_at_the_entry_points_launch_as_expected(counts):
    cfg = get_config(chip_smoke.VLM_ARCH).reduced()
    params = _params(cfg)
    rng = np.random.default_rng(0)
    batches, steps = 2, 3
    spent = {"prefill": [], "step": []}
    tokens = []
    for i in range(batches):
        text = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 4)), dtype=torch.long)
        inputs = chip_smoke.vlm_inputs(cfg, params, text, seed=i)
        assert inputs.shape == (2, chip_smoke.VLM_TILES * frontends.VLM_BASE_PATCHES + 4,
                                cfg.d_model)
        tokens.append(chip_smoke.generate(cfg, params, inputs, steps, spent, inputs.shape[1] + steps))
    assert all(t.shape == (2, 1 + steps) for t in tokens)
    assert counts == chip_smoke.expected_launches(cfg, batches, batches * steps)
    assert counts["flash_attention"] == cfg.num_layers * batches
    assert counts["decode_attention"] == cfg.num_layers * batches * steps


def test_windowed_engine_launches_as_expected(counts):
    cfg = get_config(chip_smoke.LLAMA_ARCH).reduced()
    window = 8
    engine = Engine(cfg, _params(cfg), EngineConfig(slots=2, cache_len=window, window=window,
                                                    max_new_tokens=5, device="cpu"))
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=5) for i, n in enumerate((12, 17, 9))]
    batcher = ContinuousBatcher(engine)
    for r in reqs:
        batcher.submit(r)
    batcher.run_until_idle()
    assert all(r.finished and len(r.output) == 6 for r in reqs)
    assert engine.steps >= 10
    assert counts == chip_smoke.expected_launches(cfg, len(reqs), engine.steps)


@pytest.mark.parametrize("mode", ["window", "image"])
def test_f32_check_runs_launch_as_expected(counts, mode):
    """The f32 checks' teacher-forced run: one prefill and F32_DECODE_STEPS
    steps, llama3-8b's over a ring shorter than its prompt, llava's on
    patches ahead of its prompt."""
    arch = chip_smoke.LLAMA_ARCH if mode == "window" else chip_smoke.VLM_ARCH
    cfg = get_config(arch).reduced()
    prompt = torch.arange(3, 3 + (cfg.long_context_window + 9 if mode == "window" else 5))
    kw = ({"window": cfg.long_context_window} if mode == "window" else
          {"image": torch.from_numpy(frontends.vision_embeddings(cfg, 1, tiles=0, seed=0)[0])})
    logits, fed = chip_smoke._teacher_forced(cfg, _params(cfg), prompt, None,
                                             torch.device("cpu"), **kw)
    assert len(logits) == 1 + chip_smoke.F32_DECODE_STEPS == 1 + len(fed)
    assert counts == chip_smoke.expected_launches(cfg, 1, chip_smoke.F32_DECODE_STEPS)


def test_the_new_slices_traffic():
    """Phase 3h's prompts are each longer than llama3-8b's window and ring;
    phase 3k's text prompts are VLM_BATCHES batches of SLOTS x VLM_TEXT
    tokens in llava's vocabulary; the dense slices' prompts have the main
    path's lengths in their own vocabularies."""
    traffic = chip_smoke.served_prompts(0)
    window = get_config(chip_smoke.LLAMA_ARCH).long_context_window
    long = traffic[chip_smoke.LONG_SLICE]
    assert len(long) == chip_smoke.LONG_REQUESTS == chip_smoke.SLOTS
    assert all(window < chip_smoke.LONG_MIN <= len(p) <= chip_smoke.LONG_MAX for p in long)
    assert chip_smoke.LONG_CACHE == window < chip_smoke.LONG_F32_PROMPT
    vocab = get_config(chip_smoke.VLM_ARCH).vocab_size
    texts = traffic[chip_smoke.VLM_ARCH]
    assert [t.shape for t in texts] == [(chip_smoke.SLOTS, chip_smoke.VLM_TEXT)] * 2
    assert all(0 <= t.min() and t.max() < vocab for t in texts)
    for arch in (chip_smoke.LLAMA_ARCH, chip_smoke.MINICPM_ARCH, chip_smoke.QWEN2_ARCH):
        assert [len(p) for p in traffic[arch]] == [len(p) for p in traffic[chip_smoke.ARCH]]
        assert max(int(p.max()) for p in traffic[arch]) < get_config(arch).vocab_size


def test_the_qwen2_depth_cut_is_its_arithmetic():
    """QWEN2_DEPTH_CUT's figures are the parameter counts' (bf16 bytes)."""
    cfg = get_config(chip_smoke.QWEN2_ARCH)
    at = lambda n: 2 * model.param_count(dataclasses.replace(cfg, num_layers=n)) / 1e9
    layer, ends = at(2) - at(1), at(1) - (at(2) - at(1))
    for figure in (f"{layer:.3f} GB", f"{ends:.2f} GB", f"{at(80):.1f} GB",
                   f"{at(chip_smoke.QWEN2_LAYERS):.1f} GB", f"{at(chip_smoke.QWEN2_LAYERS + 1):.1f} GB"):
        assert figure in chip_smoke.QWEN2_DEPTH_CUT, figure
    assert chip_smoke.DEPTH_CUTS[chip_smoke.QWEN2_ARCH] == chip_smoke.QWEN2_DEPTH_CUT
