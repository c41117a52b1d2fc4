"""Port's serving engine and batcher against the JAX package's, token for token.

The four engine/batcher cases of ``tests/test_serving.py``, run on the CPU
in f32 by both packages on the same weights (``params_from_jax``); greedy
tokens must agree exactly.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as jmodel
from repro.serving import ContinuousBatcher as JaxBatcher
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model
from repro_torch.models.params import params_from_jax
from repro_torch.serving import ContinuousBatcher, Engine, EngineConfig, Request


@pytest.fixture(scope="module")
def small_lm():
    jcfg, tcfg = jax_config("qwen1.5-0.5b").reduced(), get_config("qwen1.5-0.5b").reduced()
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    return jcfg, jp, tcfg, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _engines(small_lm, **ecfg):
    jcfg, jp, tcfg, tp = small_lm
    return (JaxEngine(jcfg, jp, JaxEngineConfig(**ecfg)),
            Engine(tcfg, tp, EngineConfig(device="cpu", **ecfg)))


def _run(engine, reqs):
    for r in reqs:
        engine.insert(r)
    while not all(r.finished for r in reqs):
        engine.step()
    return [r.output for r in reqs]


def test_engine_matches_jax_and_forward_rollout(small_lm):
    jcfg, jp, tcfg, tp = small_lm
    prompt = np.random.default_rng(1).integers(0, tcfg.vocab_size, size=8).astype(np.int32)
    jeng, teng = _engines(small_lm, slots=2, cache_len=64, max_new_tokens=5)
    [jout] = _run(jeng, [JaxRequest(rid=0, prompt=prompt, max_new_tokens=5)])
    [tout] = _run(teng, [Request(rid=0, prompt=prompt, max_new_tokens=5)])
    assert tout == jout and len(tout) == 6

    toks = list(prompt)
    for _ in range(6):
        logits, _ = model.forward(tcfg, tp, torch.tensor(toks)[None])
        toks.append(int(torch.argmax(logits[0, -1])))
    assert tout == toks[len(prompt):]


def test_ragged_batch_isolation(small_lm):
    """Two requests of different lengths decode independently."""
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, 1024, size=5).astype(np.int32)
    p2 = rng.integers(0, 1024, size=11).astype(np.int32)
    jeng, teng = _engines(small_lm, slots=2, cache_len=64, max_new_tokens=4)
    reqs = lambda cls: [cls(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate([p1, p2])]
    jout, tout = _run(jeng, reqs(JaxRequest)), _run(teng, reqs(Request))
    assert tout == jout
    for prompt, out in zip((p1, p2), tout):
        _, solo = _engines(small_lm, slots=1, cache_len=64, max_new_tokens=4)
        assert _run(solo, [Request(rid=0, prompt=prompt, max_new_tokens=4)]) == [out]


def _batch(engine, batcher_cls, request_cls, n, plen, new, seed):
    rng = np.random.default_rng(seed)
    bat = batcher_cls(engine)
    reqs = [request_cls(rid=i, prompt=rng.integers(0, 1024, size=plen).astype(np.int32),
                        max_new_tokens=new) for i in range(n)]
    for r in reqs:
        bat.submit(r)
    stats = bat.run_until_idle().summary()
    return [r.output for r in reqs], stats


def test_slot_reuse_after_finish(small_lm):
    jeng, teng = _engines(small_lm, slots=2, cache_len=64, max_new_tokens=3)
    jout, jstats = _batch(jeng, JaxBatcher, JaxRequest, 6, 6, 3, seed=3)
    tout, tstats = _batch(teng, ContinuousBatcher, Request, 6, 6, 3, seed=3)
    assert tout == jout
    assert tstats["admitted"] == 6 and tstats["finished"] == 6
    assert tstats["decode_steps"] == jstats["decode_steps"] >= 8


def test_batcher_conservation(small_lm):
    jeng, teng = _engines(small_lm, slots=3, cache_len=64, max_new_tokens=2)
    jout, _ = _batch(jeng, JaxBatcher, JaxRequest, 7, 4, 2, seed=4)
    tout, _ = _batch(teng, ContinuousBatcher, Request, 7, 4, 2, seed=4)
    assert tout == jout
    assert all(len(o) == 1 + 2 for o in tout)   # prefill token + 2 decoded


def test_windowed_engine_matches_jax_on_prompts_longer_than_the_ring(small_lm):
    """The sliding-window mode (``EngineConfig.window``): every layer's cache
    a ring of 8 slots, prompts of 9-17 tokens, 10 new tokens each (the ring
    wraps again in decode), three requests over two slots (one slot reused);
    the greedy tokens equal the JAX engine's."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 1024, size=n).astype(np.int32) for n in (12, 17, 9)]
    jeng, teng = _engines(small_lm, slots=2, cache_len=8, window=8, max_new_tokens=10)
    assert teng.cache["blocks"]["p0_attn"]["attn"]["k"].shape[2] == 8
    outs = []
    for eng, bat_cls, req_cls in ((jeng, JaxBatcher, JaxRequest),
                                  (teng, ContinuousBatcher, Request)):
        bat = bat_cls(eng)
        reqs = [req_cls(rid=i, prompt=p, max_new_tokens=10) for i, p in enumerate(prompts)]
        for r in reqs:
            bat.submit(r)
        bat.run_until_idle()
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0] and all(len(o) == 11 for o in outs[1])


def test_scatter_slot_writes_one_lane(small_lm):
    """A batch-1 prefill lands in its slot of the layer-stacked cache
    (batch axis 1) and of ``t`` (batch axis 0), leaving other slots alone."""
    jeng, teng = _engines(small_lm, slots=3, cache_len=16, max_new_tokens=1)
    prompt = np.arange(5, dtype=np.int32)
    teng.insert(Request(rid=0, prompt=prompt, max_new_tokens=1), slot=1)
    jeng.insert(JaxRequest(rid=0, prompt=prompt, max_new_tokens=1), slot=1)
    tc, jc = teng.cache, jeng.cache
    assert tc["t"].tolist() == np.asarray(jc["t"]).tolist() == [0, 5, 0]
    sp = tc["blocks"]["p0_attn"]["attn"]["slot_pos"]
    assert np.array_equal(sp.numpy(), np.asarray(jc["blocks"]["p0_attn"]["attn"]["slot_pos"]))
    assert (sp[:, 1, :5] >= 0).all() and (sp[:, [0, 2]] == -1).all()
    k, jk = tc["blocks"]["p0_attn"]["attn"]["k"], jc["blocks"]["p0_attn"]["attn"]["k"]
    assert float(np.max(np.abs(k.numpy() - np.asarray(jk)))) < 1e-5


def test_scatter_slot_writes_the_tail_in_one_lane():
    """A model with a tail (recurrentgemma-9b, reduced, with its (RG-LRU,
    RG-LRU) tail): the tail's unstacked leaves take the prefill at batch axis
    0, as the JAX engine's do, and other slots stay zero."""
    arch = "recurrentgemma-9b"
    jcfg, tcfg = (dataclasses.replace(get(arch).reduced(), num_layers=5,
                                      tail_blocks=("rglru", "rglru"))
                  for get in (jax_config, get_config))
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    teng = Engine(tcfg, tp, EngineConfig(slots=3, cache_len=16, max_new_tokens=1, device="cpu"))
    jeng = JaxEngine(jcfg, jp, JaxEngineConfig(slots=3, cache_len=16, max_new_tokens=1))
    prompt = np.arange(5, dtype=np.int32)
    teng.insert(Request(rid=0, prompt=prompt, max_new_tokens=1), slot=1)
    jeng.insert(JaxRequest(rid=0, prompt=prompt, max_new_tokens=1), slot=1)
    assert sorted(teng.cache["tail"]) == ["t0_rglru", "t1_rglru"]
    for key, sub in teng.cache["tail"].items():
        for name, leaf in sub["rglru"].items():
            jleaf = np.asarray(jeng.cache["tail"][key]["rglru"][name], np.float32)
            assert leaf.shape[0] == 3 and bool(leaf[1].any()) and not bool(leaf[[0, 2]].any())
            assert float(np.max(np.abs(leaf.float().numpy() - jleaf))) < 1e-4, (key, name)


def test_engine_runs_bf16_on_cpu(small_lm):
    _, _, tcfg, tp = small_lm
    bf16 = jax.tree.map(lambda t: t.to(torch.bfloat16), tp)
    eng = Engine(tcfg, bf16, EngineConfig(slots=2, cache_len=32, max_new_tokens=3,
                                          dtype=torch.bfloat16, device="cpu"))
    [out] = _run(eng, [Request(rid=0, prompt=np.arange(6, dtype=np.int32), max_new_tokens=3)])
    assert len(out) == 4 and all(0 <= t < tcfg.vocab_size for t in out)
    assert eng.cache["blocks"]["p0_attn"]["attn"]["k"].dtype == torch.bfloat16


def test_serve_cli_reduced_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
        "--requests", "3", "--slots", "2", "--max-new", "2", "--prompt-len", "6"])
    serve.main()
    out = capsys.readouterr().out
    assert "'finished': 3" in out and "device=cpu" in out

