"""Port's Griffin slice (recurrentgemma-9b) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
RG-LRU's sequential oracle is held to JAX's at 1e-5 in f32, and the port's
log-depth scan (``ops.rglru``) to its own oracle at 1e-5: the same f32
recurrence with the products taken in another order, on states of size ~1.
The conv, the block-diagonal gates and the whole recurrent block run on the
same weights (``params_from_jax``) at 1e-5 relative to the largest output.
The model is held at ``reduced()`` (local window 8, so the 20-token prompts
wrap the ring) and at a 5-layer variant with the (RG-LRU, RG-LRU) tail,
which ``reduced()`` drops: logits and every cache leaf at 1e-4 (as
``tests/test_torch_model.py``), the JAX engine's greedy tokens exactly, and
the port's own decode against its forward at 5e-3
(``tests/test_decode_consistency.py``).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import griffin as jgriffin
from repro.models import model as jmodel
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.configs.registry import LOCAL_ATTN, RGLRU
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import griffin, model
from repro_torch.models.params import params_from_jax
from repro_torch.serving import Engine, EngineConfig, Request

ARCH = "recurrentgemma-9b"
SCAN_TOL = 1e-5
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
# reduced(): (RG-LRU, RG-LRU, local attention); "tail": one such pattern
# and the full model's (RG-LRU, RG-LRU) tail, 5 layers
VARIANTS = ["reduced", "tail"]


def _cfg(get, variant):
    cfg = get(ARCH).reduced()
    if variant == "tail":
        cfg = dataclasses.replace(cfg, num_layers=5, tail_blocks=(RGLRU, RGLRU))
    return cfg


def _pair(variant="reduced", seed=0):
    jcfg, tcfg = _cfg(jax_config, variant), _cfg(get_config, variant)
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _np(shape, seed, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    if lo is None:
        return rng.standard_normal(shape).astype(np.float32)
    return rng.uniform(lo, hi, size=shape).astype(np.float32)


def _err(j, t) -> float:
    return float(np.max(np.abs(np.asarray(jnp.asarray(j, jnp.float32)) - t.float().numpy())))


def _close(j, t, tol=BLOCK_TOL) -> bool:
    """Within ``tol`` relative to the largest magnitude of the JAX output."""
    return _err(j, t) <= tol * max(1.0, float(np.max(np.abs(np.asarray(j, np.float32)))))


# ---------------------------------------------------------------------------
# The recurrence.
# ---------------------------------------------------------------------------
def _scan_inputs(b, t, d, with_state, seed):
    """Gated inputs ~ N(0, 1), decays in (0.5, 0.999), h0 ~ N(0, 1)."""
    x, a = _np((b, t, d), seed), _np((b, t, d), seed + 1, 0.5, 0.999)
    h0 = _np((b, d), seed + 2) if with_state else None
    return x, a, h0


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_reference_matches_jax(with_state):
    x, a, h0 = _scan_inputs(2, 37, 48, with_state, seed=0)
    jh, jlast = jref.rglru_reference(jnp.asarray(x), jnp.asarray(a),
                                     None if h0 is None else jnp.asarray(h0))
    th, tlast = ref.rglru_reference(torch.from_numpy(x), torch.from_numpy(a),
                                    None if h0 is None else torch.from_numpy(h0))
    assert th.shape == (2, 37, 48) and tlast.dtype == torch.float32
    assert _err(jh, th) < SCAN_TOL and _err(jlast, tlast) < SCAN_TOL


@pytest.mark.parametrize("t", [1, 2, 7, 64, 513])
@pytest.mark.parametrize("with_state", [False, True])
def test_log_depth_scan_matches_the_sequential_oracle(t, with_state):
    x, a, h0 = (None if v is None else torch.from_numpy(v)
                for v in _scan_inputs(2, t, 32, with_state, seed=t))
    h, last = ops.rglru(x, a, h0)
    eh, elast = ref.rglru_reference(x, a, h0)
    assert h.shape == (2, t, 32) and h.dtype == x.dtype and last.dtype == torch.float32
    assert float((h - eh).abs().max()) < SCAN_TOL
    assert float((last - elast).abs().max()) < SCAN_TOL
    # and JAX's own associative scan, on the same inputs
    jh, jlast = jops.rglru(jnp.asarray(x.numpy()), jnp.asarray(a.numpy()),
                           None if h0 is None else jnp.asarray(h0.numpy()))
    assert _err(jh, h) < SCAN_TOL and _err(jlast, last) < SCAN_TOL


def test_bf16_decay_rounds_to_one_and_freezes_the_state():
    """The reference's rounding, kept on purpose: a decay of 0.999 is 1.0 in
    bf16, so sqrt(1 - a^2) = 0 and h carries on unchanged."""
    a = torch.full((1, 5, 4), 0.999).to(torch.bfloat16)
    assert bool((a == 1.0).all())
    x = torch.randn((1, 5, 4), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    h0 = torch.tensor([[0.5, -1.0, 2.0, 0.0]])
    h, last = ops.rglru(x, a, h0)
    assert torch.equal(last, h0) and torch.equal(h.float(), h0[:, None].expand(1, 5, 4))
    jh, jlast = jops.rglru(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                           jnp.asarray(a.float().numpy(), jnp.bfloat16), jnp.asarray(h0.numpy()))
    assert _err(jh, h) == 0.0 and _err(jlast, last) == 0.0


# ---------------------------------------------------------------------------
# The recurrent block.
# ---------------------------------------------------------------------------
def _layer(jp, tp):
    """The first RG-LRU layer's parameters on both sides."""
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["p0_rglru"])["rglru"],
            tp["layers"][0]["rglru"])


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_jax(with_prev):
    _, _, jp, tp = _pair()
    jl, tl = _layer(jp, tp)
    w = jl["conv_w"].shape[1]
    x = _np((2, 9, w), seed=1)
    prev = _np((2, griffin.CONV_K - 1, w), seed=2) if with_prev else None
    jy, jtail = jgriffin._causal_conv(jnp.asarray(x), jl["conv_w"], jl["conv_b"] + 0.1,
                                      None if prev is None else jnp.asarray(prev))
    ty, ttail = griffin._causal_conv(torch.from_numpy(x), tl["conv_w"], tl["conv_b"] + 0.1,
                                     None if prev is None else torch.from_numpy(prev))
    assert ty.shape == (2, 9, w) and ttail.shape == (2, griffin.CONV_K - 1, w)
    assert _close(jy, ty) and _err(jtail, ttail) == 0.0


def test_block_diag_matches_jax():
    _, _, jp, tp = _pair()
    jl, tl = _layer(jp, tp)
    x = _np((2, 5, jl["gate_a"].shape[0] * jl["gate_a"].shape[1]), seed=3)
    assert _close(jgriffin._block_diag(jnp.asarray(x), jl["gate_a"]),
                  griffin._block_diag(torch.from_numpy(x), tl["gate_a"]))


@pytest.mark.parametrize("carried", [False, True])
def test_rglru_block_matches_jax(carried):
    jcfg, tcfg, jp, tp = _pair()
    jl, tl = _layer(jp, tp)
    w = griffin._width(tcfg)
    x = _np((2, 23, tcfg.d_model), seed=4)
    state = ({"conv": _np((2, griffin.CONV_K - 1, w), seed=5), "h": _np((2, w), seed=6)}
             if carried else None)
    jy, jst = jgriffin.rglru_block(jcfg, jl, jnp.asarray(x),
                                   jax.tree.map(jnp.asarray, state) if carried else None)
    tstate = {k: torch.from_numpy(v) for k, v in state.items()} if carried else None
    before = {k: v.clone() for k, v in tstate.items()} if carried else None
    ty, tst = griffin.rglru_block(tcfg, tl, torch.from_numpy(x), tstate)
    assert _close(jy, ty)
    assert _close(jst["conv"], tst["conv"]) and _close(jst["h"], tst["h"])
    assert tst["h"].dtype == torch.float32
    if carried:     # the block itself leaves the state it was given alone
        assert all(torch.equal(before[k], tstate[k]) for k in before)


def test_init_rglru_state_matches_jax():
    jcfg, tcfg = _cfg(jax_config, "reduced"), _cfg(get_config, "reduced")
    jst = jgriffin.init_rglru_state(jcfg, 3, jnp.bfloat16)
    tst = griffin.init_rglru_state(tcfg, 3, torch.bfloat16, "cpu")
    assert {k: tuple(v.shape) for k, v in tst.items()} == {k: v.shape for k, v in jst.items()}
    assert tst["conv"].dtype == torch.bfloat16 and tst["h"].dtype == torch.float32


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------
def _tokens(cfg, b=2, s=20, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _cache_leaves(cache, prefix=""):
    """{path: leaf} of a cache tree, ``t`` included."""
    if not isinstance(cache, dict):
        return {prefix: cache}
    out = {}
    for k, v in cache.items():
        out.update(_cache_leaves(v, f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_prefill_decode_match_jax(variant):
    jcfg, tcfg, jp, tp = _pair(variant)
    assert tcfg.local_window == 8
    toks = _tokens(jcfg)
    jl, _ = jmodel.forward(jcfg, jp, jnp.asarray(toks))
    tl, aux = model.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert aux == 0.0 and tl.shape == (2, 20, tcfg.vocab_size)
    assert _err(jl, tl) < LOGIT_TOL

    jcache = jmodel.init_cache(jcfg, 2, 32)
    tcache = model.init_cache(tcfg, 2, 32, device="cpu")
    jlast, jcache = jmodel.prefill(jcfg, jp, jnp.asarray(toks), jcache)
    tlast, tcache = model.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    assert _err(jlast, tlast) < LOGIT_TOL
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(3):
        jd, jcache = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jcache)
        td, tcache = model.decode_step(tcfg, tp, torch.from_numpy(nxt).long(), tcache)
        assert _err(jd, td) < LOGIT_TOL
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    jleaves, tleaves = _cache_leaves(jcache), _cache_leaves(tcache)
    assert sorted(jleaves) == sorted(tleaves)
    expect = {"/blocks/p0_rglru/rglru/conv", "/blocks/p0_rglru/rglru/h",
              "/blocks/p2_local/attn/k", "/blocks/p2_local/attn/slot_pos"}
    if variant == "tail":
        expect |= {"/tail/t0_rglru/rglru/h", "/tail/t1_rglru/rglru/conv"}
    assert expect <= set(tleaves)
    for path, leaf in tleaves.items():
        assert tuple(leaf.shape) == jleaves[path].shape, path
        assert _err(jleaves[path], leaf) < LOGIT_TOL, path
    # the local-attention ring holds the last 8 of 23 positions
    sp = tcache["blocks"]["p2_local"]["attn"]["slot_pos"]
    assert sp.shape[-1] == 8 and sorted(sp[0, 0].tolist()) == list(range(15, 23))


@pytest.mark.parametrize("variant", VARIANTS)
def test_decode_matches_forward(variant):
    """The port's own contract of tests/test_decode_consistency.py."""
    _, tcfg, _, tp = _pair(variant)
    toks = torch.from_numpy(_tokens(tcfg, seed=2)).long()
    cache = model.init_cache(tcfg, 2, 32, device="cpu")
    last, cache = model.prefill(tcfg, tp, toks, cache)
    seq = [torch.argmax(last, -1)]
    for _ in range(3):
        dl, cache = model.decode_step(tcfg, tp, seq[-1], cache)
        full, _ = model.forward(tcfg, tp, torch.cat([toks, torch.stack(seq, 1)], 1))
        assert float((dl - full[:, -1]).abs().max()) < 5e-3
        seq.append(torch.argmax(dl, -1))


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_params_shapes_and_count_match_jax(variant):
    jcfg, tcfg, jp, tp = _pair(variant)
    own = model.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(own) == shapes(tp)
    assert sum(x.numel() for x in jax.tree.leaves(own)) == model.param_count(tcfg)
    assert model.param_count(tcfg) == jmodel.param_count(jcfg)
    assert model._layer_kinds(tcfg) == list(jcfg.layer_kinds())
    # the JAX package's scales: Lambda gives decays a^c in [0.9, 0.999]
    lam = own["layers"][0]["rglru"]["lam"]
    a_c = torch.exp(-griffin.C_RGLRU * torch.nn.functional.softplus(lam))
    assert lam.dtype == torch.float32 and 0.9 <= float(a_c.min()) <= float(a_c.max()) <= 0.999


def test_params_from_jax_keeps_lambda_f32():
    _, tcfg, jp, _ = _pair("tail")
    bf16 = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), dtype=torch.bfloat16)
    for layer in (bf16["layers"][0], bf16["layers"][-1]):       # the pattern's and the tail's
        leaves = layer["rglru"]
        assert all(leaves[n].dtype == torch.float32 for n in griffin.F32_LEAVES)
        assert leaves["wx"].dtype == torch.bfloat16
    own = model.init_params(tcfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                            device="cpu")
    assert {n: t.dtype for n, t in own["layers"][-1]["rglru"].items()} == {
        n: t.dtype for n, t in bf16["layers"][-1]["rglru"].items()}
    assert model._layer_kinds(tcfg)[2] == LOCAL_ATTN and "attn" in bf16["layers"][2]


def test_full_size_cache_and_ring():
    """recurrentgemma-9b at full size: 12 local-attention rings of
    min(2048, cache_len) slots and 26 RG-LRU states (from shapes on the
    meta device, nothing allocated)."""
    cfg = get_config(ARCH)
    cache = model.init_cache(cfg, 8, 4096, dtype=torch.bfloat16, device="meta")
    kinds = model._layer_kinds(cfg)
    assert kinds.count(LOCAL_ATTN) == 12 and kinds.count(RGLRU) == 26
    ring = cache["blocks"]["p2_local"]["attn"]["k"]
    assert tuple(ring.shape) == (12, 8, 2048, 1, 256)
    assert tuple(cache["tail"]["t1_rglru"]["rglru"]["h"].shape) == (8, 4096)
    assert len(model._layer_caches(cfg, cache)) == 38


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------
def _run(engine, reqs):
    for r in reqs:
        engine.insert(r)
    while not all(r.finished for r in reqs):
        engine.step()
    return [r.output for r in reqs]


@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_matches_jax_on_ragged_requests(variant):
    jcfg, tcfg, jp, tp = _pair(variant)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32) for n in (5, 11, 30)]
    ecfg = dict(slots=3, cache_len=64, max_new_tokens=4)
    jout = _run(JaxEngine(jcfg, jp, JaxEngineConfig(**ecfg)),
                [JaxRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    teng = Engine(tcfg, tp, EngineConfig(device="cpu", **ecfg))
    tout = _run(teng, [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    assert tout == jout and all(len(o) == 5 for o in tout)


def test_serve_cli_reduced_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--requests", "3", "--slots", "2", "--max-new", "2", "--prompt-len", "12"])
    serve.main()
    out = capsys.readouterr().out
    assert "'finished': 3" in out and "device=cpu" in out and ARCH in out
