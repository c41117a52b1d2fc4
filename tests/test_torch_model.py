"""Port's model against the JAX package's, and its own decode contracts.

Logits of ``forward``, ``prefill`` and ``decode_step`` are compared with
JAX's on the same weights (``params_from_jax``) in f32.  Tolerance 1e-4:
the same f32 arithmetic summed in another order through two layers and an
unembedding gives differences near 1e-5 on logits of size ~10.  The
decode-vs-forward contracts of ``tests/test_decode_consistency.py`` are
then run on the port alone, with its own ``init_params``, at their 5e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.models import frontends, model
from repro_torch.models.params import params_from_jax

TOL = 1e-4
ATTENTION_ONLY = ["qwen1.5-0.5b", "llama3-8b", "qwen2-72b", "minicpm-2b", "llava-next-mistral-7b"]
# RWKV-6's own tests: tests/test_torch_rwkv.py; MoE's: tests/test_torch_moe.py;
# the Griffin hybrid's: tests/test_torch_griffin.py; whisper's: tests/test_torch_whisper.py
PORTED = ATTENTION_ONLY + ["rwkv6-1.6b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
                           "recurrentgemma-9b", "whisper-small"]


def _pair(arch, seed=0):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _tokens(cfg, b=2, s=20, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _err(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j) - t.numpy())))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3-8b", "minicpm-2b", "qwen2-72b"])
def test_logits_match_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg)
    jl, _ = jmodel.forward(jcfg, jp, jnp.asarray(toks))
    tl, aux = model.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert aux == 0.0 and tl.shape == (2, 20, tcfg.vocab_size)
    assert _err(jl, tl) < TOL

    jcache = jmodel.init_cache(jcfg, 2, 32)
    tcache = model.init_cache(tcfg, 2, 32, device="cpu")
    jlast, jcache = jmodel.prefill(jcfg, jp, jnp.asarray(toks), jcache)
    tlast, tcache = model.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    assert _err(jlast, tlast) < TOL
    assert np.array_equal(np.asarray(jcache["t"]), tcache["t"].numpy())
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(3):
        jd, jcache = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jcache)
        td, tcache = model.decode_step(tcfg, tp, torch.from_numpy(nxt).long(), tcache)
        assert _err(jd, td) < TOL
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    for key in ("k", "v"):
        assert _err(jcache["blocks"]["p0_attn"]["attn"][key],
                    tcache["blocks"]["p0_attn"]["attn"][key]) < TOL


def test_windowed_forward_and_prefill_match_jax():
    jcfg, tcfg, jp, tp = _pair("llama3-8b")
    toks = _tokens(jcfg)
    jl, _ = jmodel.forward(jcfg, jp, jnp.asarray(toks), window=8)
    tl, _ = model.forward(tcfg, tp, torch.from_numpy(toks).long(), window=8)
    assert _err(jl, tl) < TOL
    jlast, _ = jmodel.prefill(jcfg, jp, jnp.asarray(toks), jmodel.init_cache(jcfg, 2, 8, window=8),
                              window=8)
    tlast, _ = model.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                             model.init_cache(tcfg, 2, 8, window=8, device="cpu"), window=8)
    assert _err(jlast, tlast) < TOL


def test_windowed_decode_past_the_ring_matches_jax():
    """The sliding-window mode over a ring shorter than the prompt: the
    prefill keeps the prompt's tail, then each decode step overwrites the
    ring's oldest slot; logits and every cache leaf against the JAX package."""
    jcfg, tcfg, jp, tp = _pair("llama3-8b")
    W = 8
    toks = _tokens(jcfg)                                   # 20 tokens, a ring of 8
    jcache = jmodel.init_cache(jcfg, 2, W, window=W)
    tcache = model.init_cache(tcfg, 2, W, window=W, device="cpu")
    jlast, jcache = jmodel.prefill(jcfg, jp, jnp.asarray(toks), jcache, window=W)
    tlast, tcache = model.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache, window=W)
    assert _err(jlast, tlast) < TOL
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(W + 2):                                 # around the ring and past it
        jd, jcache = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jcache, window=W)
        td, tcache = model.decode_step(tcfg, tp, torch.from_numpy(nxt).long(), tcache, window=W)
        assert _err(jd, td) < TOL
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    jattn, tattn = jcache["blocks"]["p0_attn"]["attn"], tcache["blocks"]["p0_attn"]["attn"]
    assert np.array_equal(np.asarray(jattn["slot_pos"]), tattn["slot_pos"].numpy())
    assert np.array_equal(np.asarray(jcache["t"]), tcache["t"].numpy())
    for key in ("k", "v"):
        assert _err(jattn[key], tattn[key]) < TOL


def test_vlm_embedding_prefill_and_decode_match_jax():
    """The VLM at its entry points: ``prefill`` on patch and text embeddings
    (``frontends.multimodal_inputs``, one anyres tile), then 3 greedy
    ``decode_step``s on tokens."""
    jcfg, tcfg, jp, tp = _pair("llava-next-mistral-7b", seed=5)
    text = _tokens(jcfg, b=2, s=6, seed=5)
    inputs = frontends.multimodal_inputs(tcfg, text, np.asarray(jp["embed"]), tiles=1, seed=1)
    jcache = jmodel.init_cache(jcfg, 2, inputs.shape[1] + 4)
    tcache = model.init_cache(tcfg, 2, inputs.shape[1] + 4, device="cpu")
    jlast, jcache = jmodel.prefill(jcfg, jp, jnp.asarray(inputs), jcache)
    tlast, tcache = model.prefill(tcfg, tp, torch.from_numpy(inputs), tcache)
    assert tlast.shape == (2, tcfg.vocab_size) and _err(jlast, tlast) < TOL
    assert np.array_equal(np.asarray(jcache["t"]), tcache["t"].numpy())
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(3):
        jd, jcache = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jcache)
        td, tcache = model.decode_step(tcfg, tp, torch.from_numpy(nxt).long(), tcache)
        assert _err(jd, td) < TOL
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    for key in ("k", "v"):
        assert _err(jcache["blocks"]["p0_attn"]["attn"][key],
                    tcache["blocks"]["p0_attn"]["attn"][key]) < TOL


def test_vlm_embedding_inputs_match_jax():
    jcfg, tcfg, jp, tp = _pair("llava-next-mistral-7b", seed=5)
    text = _tokens(jcfg, b=2, s=6, seed=5)
    inputs = frontends.multimodal_inputs(tcfg, text, np.asarray(jp["embed"]), tiles=0, seed=1)
    jl, _ = jmodel.forward(jcfg, jp, jnp.asarray(inputs))
    tl, _ = model.forward(tcfg, tp, torch.from_numpy(inputs))
    assert tl.shape == (2, inputs.shape[1], tcfg.vocab_size)
    assert _err(jl, tl) < TOL


# ---------------------------------------------------------------------------
# The port's own decode-vs-forward contracts (tests/test_decode_consistency.py)
# ---------------------------------------------------------------------------
def _own(arch, b=2, s=20, seed=0):
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
    return cfg, params, toks


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-0.5b", "qwen2-72b", "minicpm-2b"])
def test_decode_matches_forward(arch):
    cfg, params, toks = _own(arch)
    cache = model.init_cache(cfg, 2, 32, device="cpu")
    last, cache = model.prefill(cfg, params, toks, cache)
    nxt = torch.argmax(last, -1)
    dl, cache = model.decode_step(cfg, params, nxt, cache)
    full, _ = model.forward(cfg, params, torch.cat([toks, nxt[:, None]], 1))
    assert float((dl - full[:, -1]).abs().max()) < 5e-3


def test_multi_token_decode_chain():
    cfg, params, toks = _own("qwen1.5-0.5b")
    cache = model.init_cache(cfg, 2, 40, device="cpu")
    last, cache = model.prefill(cfg, params, toks, cache)
    seq = [torch.argmax(last, -1)]
    for _ in range(4):
        dl, cache = model.decode_step(cfg, params, seq[-1], cache)
        seq.append(torch.argmax(dl, -1))
    cur = toks
    for i in range(5):
        full, _ = model.forward(cfg, params, cur)
        nxt = torch.argmax(full[:, -1], -1)
        assert torch.equal(nxt, seq[i]), f"divergence at step {i}"
        cur = torch.cat([cur, nxt[:, None]], 1)


def test_sliding_window_ring_cache():
    cfg, params, toks = _own("llama3-8b")
    W = 8
    ref, _ = model.forward(cfg, params, toks, window=W)
    cache = model.init_cache(cfg, 2, W, window=W, device="cpu")   # ring == window < prompt
    last, cache = model.prefill(cfg, params, toks, cache, window=W)
    assert float((last - ref[:, -1]).abs().max()) < 5e-3
    nxt = torch.argmax(last, -1)
    dl, cache = model.decode_step(cfg, params, nxt, cache, window=W)
    ref2, _ = model.forward(cfg, params, torch.cat([toks, nxt[:, None]], 1), window=W)
    assert float((dl - ref2[:, -1]).abs().max()) < 5e-3


# ---------------------------------------------------------------------------
# Parameters: counts and shapes.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", PORTED)
def test_param_count_matches_jax_at_full_size(arch):
    cfg = get_config(arch)
    assert model.param_count(cfg) == jmodel.param_count(jax_config(arch))
    assert cfg.params_total == jax_config(arch).params_total


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3-8b"])
def test_init_params_shapes_match_jax(arch):
    _, tcfg, _, converted = _pair(arch)
    own = model.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(own) == shapes(converted)
    assert sum(x.numel() for x in jax.tree.leaves(own)) == model.param_count(tcfg)
    # the JAX package's scales: unit embeddings, d^-0.5 projections, zero biases
    assert abs(float(own["embed"].std()) - 1.0) < 0.05
    wq = own["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert all(not b.any() for k, b in own["layers"][0]["attn"].items() if k.startswith("b"))


def test_init_params_is_seeded_by_the_generator():
    cfg = get_config("qwen1.5-0.5b").reduced()
    a = model.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = model.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    c = model.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a["embed"], b["embed"]) and not torch.equal(a["embed"], c["embed"])
