"""Port's MoE slice against the JAX package's, on the CPU.

The layer runs on the same weights in both packages (the JAX package's
``init_moe``, converted leaf by leaf; the model's through
``params_from_jax``) and on the same numpy inputs, at the cases of
``tests/test_moe.py``.  Tolerances: 1e-5 on the layer's output in f32 and
1e-6 on its aux loss (the same f32 arithmetic in another order, on outputs
of size ~1), 2e-2 in bf16 (the tolerance of ``tests/test_kernels.py``);
logits and caches at 1e-4 as in ``tests/test_torch_model.py``, and the
port's own decode-vs-forward at the 5e-3 of
``tests/test_decode_consistency.py``.

The inputs are continuous, so no two f32 router logits of a token tie:
``torch.topk`` promises no order among equal values, where ``jax.lax.top_k``
takes the lower index first.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.registry import ModelConfig as JaxModelConfig
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.configs.registry import ModelConfig
from repro_torch.launch import serve
from repro_torch.models import model, moe
from repro_torch.models.params import params_from_jax
from repro_torch.serving import Engine, EngineConfig, Request

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
LOGIT_TOL = 1e-4
ROUTES = [(4, 1), (4, 2), (8, 2), (3, 2)]       # (experts, top-k): tests/test_moe.py


def _cfgs(e=4, k=2, d=32, ff=64, cf=8.0):
    """The config of tests/test_moe.py in both packages; the large capacity
    factor drops nothing."""
    kw = dict(name="moe-test", family="moe", num_layers=1, d_model=d, num_heads=4,
              num_kv_heads=4, d_ff=ff, vocab_size=64, num_experts=e,
              num_experts_per_tok=k, moe_capacity_factor=cf)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _layer(jcfg, dtype="float32", seed=0):
    """The JAX package's MoE weights and their torch copies (router f32)."""
    boxed = jmoe.init_moe(jax.random.key(seed), jcfg, DTYPES[dtype][0])
    jp = jax.tree.map(lambda b: b.value, boxed, is_leaf=lambda x: hasattr(x, "axes"))
    tp = {name: torch.from_numpy(np.array(a, np.float32)).to(
        torch.float32 if name == "router" else DTYPES[dtype][1]) for name, a in jp.items()}
    return jp, tp


def _x(shape, dtype="float32", seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, DTYPES[dtype][0]), torch.from_numpy(x).to(DTYPES[dtype][1])


def _err(j, t) -> float:
    return float(np.max(np.abs(np.asarray(jnp.asarray(j, jnp.float32)) - t.float().numpy())))


# ---------------------------------------------------------------------------
# The layer.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("e,k", ROUTES)
def test_route_matches_jax(e, k):
    jcfg, tcfg = _cfgs(e=e, k=k)
    jp, tp = _layer(jcfg)
    jx, tx = _x((32, jcfg.d_model))
    jg, ji, jaux = jmoe._route(jcfg, jp["router"], jx)
    tg, ti, taux = moe._route(tcfg, tp["router"], tx)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert tg.dtype == torch.float32 and _err(jg, tg) < TOL["float32"]
    assert abs(float(jaux) - float(taux)) < AUX_TOL


@pytest.mark.parametrize("e,k", ROUTES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sort_local_and_dense_oracle_match_jax(e, k, dtype):
    jcfg, tcfg = _cfgs(e=e, k=k)
    jp, tp = _layer(jcfg, dtype)
    jx, tx = _x((2, 16, jcfg.d_model), dtype)
    for jfn, tfn in ((jmoe.moe_sort_local, moe.moe_sort_local),
                     (jmoe.moe_dense_oracle, moe.moe_dense_oracle)):
        jy, jaux = jfn(jcfg, jp, jx)
        ty, taux = tfn(tcfg, tp, tx)
        assert ty.shape == tx.shape and ty.dtype == tx.dtype
        assert _err(jy, ty) < TOL[dtype], tfn.__name__
        assert abs(float(jaux) - float(taux)) < AUX_TOL


@pytest.mark.parametrize("e,k", ROUTES)
def test_sort_local_matches_its_own_dense_oracle(e, k):
    """Nothing drops at capacity factor 8: the sort path is the oracle."""
    jcfg, tcfg = _cfgs(e=e, k=k)
    _, tp = _layer(jcfg)
    _, tx = _x((2, 16, tcfg.d_model), seed=2)
    ys, aux_s = moe.moe_sort_local(tcfg, tp, tx)
    yd, aux_d = moe.moe_dense_oracle(tcfg, tp, tx)
    assert float((ys - yd).abs().max()) < TOL["float32"]
    assert abs(float(aux_s) - float(aux_d)) < AUX_TOL


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_capacity_drops_the_tokens_jax_drops(dtype):
    """Capacity 8 for 32 tokens x top-2 over 4 experts: the stable sort
    drops each expert's latest assignments past 8, and the output equals
    JAX's, not only in norm."""
    jcfg, tcfg = _cfgs(cf=1e-9)
    jp, tp = _layer(jcfg, dtype)
    jx, tx = _x((1, 32, jcfg.d_model), dtype, seed=3)
    jy, _ = jmoe.moe_sort_local(jcfg, jp, jx, capacity=8)
    ty, _ = moe.moe_sort_local(tcfg, tp, tx, capacity=8)
    assert _err(jy, ty) < TOL[dtype]
    _, topi, _ = moe._route(tcfg, tp["router"], tx.reshape(32, -1))
    assert int(torch.bincount(topi.flatten(), minlength=4).max()) > 8     # drops happened
    full, _ = moe.moe_sort_local(tcfg, tp, tx, capacity=64)
    assert float((full.float() - ty.float()).abs().max()) > 0.1
    # a token whose every assignment dropped gets 0, on both sides
    j_zero = np.asarray(jnp.abs(jnp.asarray(jy, jnp.float32)).sum(-1) == 0)
    assert np.array_equal(j_zero, (ty.float().abs().sum(-1) == 0).numpy())


@pytest.mark.parametrize("tokens", [1, 8, 16, 40, 64, 512, 4096])
def test_capacity_matches_jax(tokens):
    for arch in MOE_ARCHS + [None]:
        jcfg, tcfg = ((jax_config(arch), get_config(arch)) if arch else _cfgs(e=3, k=2, cf=1.25))
        assert moe._capacity(tcfg, tokens) == jmoe._capacity(jcfg, tokens)


def test_phi_capacity_at_the_served_shapes():
    """phi3.5-moe: 8 rows per expert at an 8-slot decode step (never fewer
    than the 8 assignments one expert can get), 88 at a 512-token prefill."""
    cfg = get_config("phi3.5-moe-42b-a6.6b")
    assert moe._capacity(cfg, 8) == 8 and moe._capacity(cfg, 512) == 88


@pytest.mark.parametrize("path", ["dense", "local", "ep_a2a"])
def test_moe_apply_paths_match_jax(path):
    jcfg, tcfg = _cfgs()
    jp, tp = _layer(jcfg)
    jx, tx = _x((2, 8, jcfg.d_model), seed=4)
    jy, jaux = jmoe.moe_apply(jcfg, jp, jx, path=path)    # no mesh rules: ep_a2a is the sort path
    ty, taux = moe.moe_apply(tcfg, tp, tx, path=path)
    assert _err(jy, ty) < TOL["float32"] and abs(float(jaux) - float(taux)) < AUX_TOL
    with pytest.raises(ValueError, match="unknown MoE path"):
        moe.moe_apply(tcfg, tp, tx, path="sharded")


# ---------------------------------------------------------------------------
# The model, at reduced() size.
# ---------------------------------------------------------------------------
def _pair(arch, seed=0, **changes):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _tokens(cfg, b=2, s=20, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    toks = _tokens(jcfg)
    jl, jaux = jmodel.forward(jcfg, jp, jnp.asarray(toks))
    tl, taux = model.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert tl.shape == (2, 20, tcfg.vocab_size) and _err(jl, tl) < LOGIT_TOL
    assert float(taux) > 0 and abs(float(jaux) - float(taux)) < LOGIT_TOL

    jcache = jmodel.init_cache(jcfg, 2, 32)
    tcache = model.init_cache(tcfg, 2, 32, device="cpu")
    jlast, jcache = jmodel.prefill(jcfg, jp, jnp.asarray(toks), jcache)
    tlast, tcache = model.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    assert _err(jlast, tlast) < LOGIT_TOL
    for key in ("k", "v"):
        assert _err(jcache["blocks"]["p0_attn"]["attn"][key],
                    tcache["blocks"]["p0_attn"]["attn"][key]) < LOGIT_TOL
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(2):
        jd, jcache = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jcache)
        td, tcache = model.decode_step(tcfg, tp, torch.from_numpy(nxt).long(), tcache)
        assert _err(jd, td) < LOGIT_TOL
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    assert np.array_equal(np.asarray(jcache["t"]), tcache["t"].numpy())


def test_kimi_k2_at_head_dim_112_matches_jax():
    """kimi-k2 at ``reduced()`` with its full-size head size 112 (reduced()
    takes 64), the one the card's attention kernels were widened to:
    logits, every attention cache leaf after prefill and two decode steps,
    and the JAX engine's greedy tokens on ragged requests."""
    jcfg, tcfg, jp, tp = _pair("kimi-k2-1t-a32b", head_dim=112)
    assert tcfg.resolved_head_dim == 112
    toks = _tokens(jcfg, seed=3)
    jl, _ = jmodel.forward(jcfg, jp, jnp.asarray(toks))
    tl, _ = model.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert _err(jl, tl) < LOGIT_TOL
    jcache, tcache = jmodel.init_cache(jcfg, 2, 32), model.init_cache(tcfg, 2, 32, device="cpu")
    jlast, jcache = jmodel.prefill(jcfg, jp, jnp.asarray(toks), jcache)
    tlast, tcache = model.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache)
    assert _err(jlast, tlast) < LOGIT_TOL
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(2):
        jd, jcache = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jcache)
        td, tcache = model.decode_step(tcfg, tp, torch.from_numpy(nxt).long(), tcache)
        assert _err(jd, td) < LOGIT_TOL
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    jattn, tattn = jcache["blocks"]["p0_attn"]["attn"], tcache["blocks"]["p0_attn"]["attn"]
    assert tattn["k"].shape[-1] == 112
    for key in ("k", "v"):
        assert _err(jattn[key], tattn[key]) < LOGIT_TOL
    assert np.array_equal(np.asarray(jattn["slot_pos"]), tattn["slot_pos"].numpy())
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32) for n in (7, 30)]
    ecfg = dict(slots=2, cache_len=48, max_new_tokens=4)
    jout = _run(JaxEngine(jcfg, jp, JaxEngineConfig(**ecfg)),
                [JaxRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    tout = _run(Engine(tcfg, tp, EngineConfig(device="cpu", **ecfg)),
                [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    assert tout == jout and all(len(o) == 5 for o in tout)


def test_prefill_at_a_capacity_that_drops_matches_jax():
    """At capacity factor 0.5 the batch-1 prefill drops assignments in every
    layer; the port drops the same ones."""
    jcfg, tcfg, jp, tp = _pair("phi3.5-moe-42b-a6.6b", moe_capacity_factor=0.5)
    toks = _tokens(jcfg, b=1, s=40, seed=6)
    jl, _ = jmodel.forward(jcfg, jp, jnp.asarray(toks))
    tl, _ = model.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert _err(jl, tl) < LOGIT_TOL
    jlast, _ = jmodel.prefill(jcfg, jp, jnp.asarray(toks), jmodel.init_cache(jcfg, 1, 48))
    tlast, _ = model.prefill(tcfg, tp, torch.from_numpy(toks).long(),
                             model.init_cache(tcfg, 1, 48, device="cpu"))
    assert _err(jlast, tlast) < LOGIT_TOL
    roomy = dataclasses.replace(tcfg, moe_capacity_factor=8.0)
    full, _ = model.forward(roomy, tp, torch.from_numpy(toks).long())
    assert float((full - tl).abs().max()) > 1e-2          # assignments were dropped


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_forward(arch):
    """The port's own contract of tests/test_decode_consistency.py, with its
    own weights."""
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(cfg, 2, 32, device="cpu")
    last, cache = model.prefill(cfg, params, toks, cache)
    seq = [torch.argmax(last, -1)]
    for _ in range(3):
        dl, cache = model.decode_step(cfg, params, seq[-1], cache)
        full, _ = model.forward(cfg, params, torch.cat([toks, torch.stack(seq, 1)], 1))
        assert float((dl - full[:, -1]).abs().max()) < 5e-3
        seq.append(torch.argmax(dl, -1))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_jax_keeps_the_router_f32(arch):
    _, tcfg, jp, _ = _pair(arch)
    bf16 = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), dtype=torch.bfloat16)
    leaves = bf16["layers"][0]["moe"]
    assert leaves["router"].dtype == torch.float32
    assert all(leaves[n].dtype == torch.bfloat16 for n in ("wi_gate", "wi_up", "wo"))
    # not rounded: equal to JAX's f32 router
    assert np.array_equal(leaves["router"].numpy(), np.asarray(jp["blocks"]["p0_attn"]["moe"]
                                                               ["router"][0]))
    own = model.init_params(tcfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                            device="cpu")
    assert {n: t.dtype for n, t in own["layers"][0]["moe"].items()} == {
        n: t.dtype for n, t in leaves.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_shapes_and_count_match_jax(arch):
    _, tcfg, _, tp = _pair(arch)
    own = model.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(own) == shapes(tp) and "mlp" not in own["layers"][0]
    assert sum(x.numel() for x in jax.tree.leaves(own)) == model.param_count(tcfg)
    # the JAX package's scales: d^-0.5 into the experts, e_ff^-0.5 out
    p = own["layers"][0]["moe"]
    assert abs(float(p["wi_gate"].std()) * tcfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(p["wo"].std()) * tcfg.expert_d_ff ** 0.5 - 1.0) < 0.05


def test_served_slice_is_half_of_phi():
    """The card's slice: phi3.5-moe at full width and 16 of 32 layers,
    21.07 B parameters (42.1 GB in bf16); the whole model would not fit."""
    full = get_config("phi3.5-moe-42b-a6.6b")
    half = dataclasses.replace(full, num_layers=16)
    per_layer = (full.params_total - half.params_total) // 16
    assert per_layer == 1_300_307_968
    assert half.params_total == 21_067_599_872 and 2 * full.params_total > 80e9


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------
def _run(engine, reqs):
    for r in reqs:
        engine.insert(r)
    while not all(r.finished for r in reqs):
        engine.step()
    return [r.output for r in reqs]


def test_engine_matches_jax_on_ragged_requests():
    """Greedy tokens equal to the JAX engine's: batch-1 prefills, then every
    slot routed together at each decode step."""
    jcfg, tcfg, jp, tp = _pair("phi3.5-moe-42b-a6.6b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32) for n in (5, 11, 40)]
    ecfg = dict(slots=3, cache_len=64, max_new_tokens=4)
    jout = _run(JaxEngine(jcfg, jp, JaxEngineConfig(**ecfg)),
                [JaxRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    tout = _run(Engine(tcfg, tp, EngineConfig(device="cpu", **ecfg)),
                [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    assert tout == jout and all(len(o) == 5 for o in tout)


def test_serve_cli_reduced_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "phi3.5-moe-42b-a6.6b", "--reduced", "--device", "cpu",
        "--requests", "3", "--slots", "2", "--max-new", "2", "--prompt-len", "6"])
    serve.main()
    out = capsys.readouterr().out
    assert "'finished': 3" in out and "device=cpu" in out and "phi3.5-moe" in out
