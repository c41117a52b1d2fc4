"""Port's RWKV-6 slice against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; bf16
inputs are rounded from the same f32 values on both sides.  The scan's
plain version is held to the JAX oracle and to the Pallas kernel in
interpret mode at the tolerances of ``tests/test_kernels.py`` (1e-4 f32,
5e-2 bf16).  The blocks and the model run on the same weights
(``params_from_jax``), whose zero-initialised leaves ``mu``, ``cm_mu``,
``w0`` and ``u`` are first filled with the same seeded noise in both trees:
at zero, neither the token shift nor the bonus would be exercised.
``time_mix``/``channel_mix`` are held at 1e-5 relative to the largest
output (the same f32 arithmetic in another order: rounding is relative, and
the scan sums a few tens of tokens into outputs of size ~10), logits at 1e-4
as in ``tests/test_torch_model.py``.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import rwkv6_chunked
from repro.models import model as jmodel
from repro.models import rwkv as jrwkv
from repro.serving import Engine as JaxEngine
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as rk
from repro_torch.launch import serve
from repro_torch.models import model, rwkv
from repro_torch.models.params import params_from_jax
from repro_torch.serving import Engine, EngineConfig, Request

ARCH = "rwkv6-1.6b"
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4
RWKV_CASES = [
    # b, t, h, hd, chunk, with_state  (tests/test_kernels.py)
    (2, 64, 2, 32, 16, False),
    (1, 50, 4, 64, 32, True),     # ragged tail (t % chunk != 0)
    (2, 33, 1, 16, 8, True),
    (1, 128, 2, 64, 32, True),
]


def _err(j, t) -> float:
    return float(np.max(np.abs(np.asarray(jnp.asarray(j, jnp.float32)) - t.float().numpy())))


def _scan_inputs(b, t, h, hd, with_state, seed, strong=False):
    """numpy inputs with the distribution of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    x = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    sh = (b, t, h, hd)
    if strong:   # w down to exp(-exp(4)) ~ 1e-24
        w = np.exp(-np.exp(rng.uniform(-2.0, 4.0, sh))).astype(np.float32)
    else:
        w = (1 / (1 + np.exp(-(x(*sh) * 2 - 1))) * 0.5 + 0.45).astype(np.float32)
    s0 = x(b, h, hd, hd) * 0.2 if with_state else None
    return x(*sh) * 0.5, x(*sh) * 0.5, x(*sh), w, x(h, hd) * 0.3, s0


def _both(arrays, dtype):
    """JAX and torch copies; r, k, v, w in ``dtype``, u and the state f32."""
    jd, td = DTYPES[dtype]
    r, k, v, w, u, s0 = arrays
    jx = [jnp.asarray(a, jd) for a in (r, k, v, w)] + [jnp.asarray(u)]
    tx = [torch.from_numpy(a).to(td) for a in (r, k, v, w)] + [torch.from_numpy(u)]
    jx.append(None if s0 is None else jnp.asarray(s0))
    tx.append(None if s0 is None else torch.from_numpy(s0))
    return jx, tx


# ---------------------------------------------------------------------------
# The scan's plain version.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", RWKV_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rwkv6_reference_matches_jax_oracle_and_pallas(case, dtype):
    b, t, h, hd, chunk, with_state = case
    jx, tx = _both(_scan_inputs(b, t, h, hd, with_state, seed=sum(case)), dtype)
    out, s_t = ref.rwkv6_reference(*tx)
    assert out.dtype == DTYPES[dtype][1] and s_t.dtype == torch.float32
    exp_o, exp_s = jref.rwkv6_reference(*jx)
    assert _err(exp_o, out) < SCAN_TOL[dtype] and _err(exp_s, s_t) < SCAN_TOL[dtype]
    pal_o, pal_s = rwkv6_chunked(*jx, chunk=chunk, interpret=True)
    assert _err(pal_o, out) < SCAN_TOL[dtype] and _err(pal_s, s_t) < SCAN_TOL[dtype]


def test_rwkv6_reference_strong_decay_matches_pallas():
    jx, tx = _both(_scan_inputs(1, 64, 1, 16, False, seed=3, strong=True), "float32")
    out, s_t = ref.rwkv6_reference(*tx)
    pal_o, pal_s = rwkv6_chunked(*jx, chunk=16, interpret=True)
    assert bool(torch.isfinite(out).all())
    assert _err(pal_o, out) < 1e-4 and _err(pal_s, s_t) < 1e-4


def test_ops_rwkv6_on_the_cpu_takes_the_plain_version():
    _, (r, k, v, w, u, s0) = _both(_scan_inputs(2, 9, 2, 16, True, seed=4), "float32")
    launches = rk.launches
    exp_o, exp_s = ref.rwkv6_reference(r, k, v, w, u, s0)
    out, s_t = ops.rwkv6(r, k, v, w, u, s0)
    assert torch.equal(out, exp_o) and torch.equal(s_t, exp_s)
    state = s0.clone()                      # the decode cache: updated in place
    out, s_t = ops.rwkv6(r, k, v, w, u, state, final_state=state)
    assert s_t is state and torch.equal(state, exp_s) and torch.equal(out, exp_o)
    assert rk.launches == launches          # a CPU tensor never launches
    with pytest.raises(ValueError, match="CUDA"):
        rk.rwkv6_scan(r, k, v, w, u, s0)


# ---------------------------------------------------------------------------
# Blocks and model on the same weights.
# ---------------------------------------------------------------------------
def _pair(arch=ARCH, seed=0, noise_seed=7):
    """(JAX cfg, port cfg, JAX params, port params), reduced, with the
    zero-initialised RWKV leaves filled with the same noise in both."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(noise_seed)
    leaves = tree["blocks"]["p0_rwkv"]["rwkv"]
    for name in rwkv.F32_LEAVES:
        assert not leaves[name].any()
        leaves[name] = (rng.standard_normal(leaves[name].shape) * 0.3).astype(np.float32)
    return jcfg, tcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(tcfg, tree)


def _close(j, t) -> bool:
    """Within BLOCK_TOL of the JAX value, relative to the largest one."""
    return _err(j, t) < BLOCK_TOL * max(1.0, float(jnp.max(jnp.abs(j))))


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_and_channel_mix_match_jax(carried):
    jcfg, tcfg, jp, tp = _pair()
    jl = jax.tree.map(lambda a: a[1], jp["blocks"]["p0_rwkv"])["rwkv"]
    tl = tp["layers"][1]["rwkv"]
    b, t, d = 2, 37, jcfg.d_model
    h, hd = d // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    jx, tx = _x((b, t, d), seed=1)
    js, ts = _x((b, d), seed=2) if carried else (None, None)
    jw, tw = _x((b, h, hd, hd), seed=3) if carried else (None, None)
    jy, jshift, jwkv = jrwkv.time_mix(jcfg, jl, jx, js, jw)
    ty, tshift, twkv = rwkv.time_mix(tcfg, tl, tx, ts, tw)
    assert _close(jy, ty) and _close(jshift, tshift) and _close(jwkv, twkv)
    jy, jshift = jrwkv.channel_mix(jcfg, jl, jx, js)
    ty, tshift = rwkv.channel_mix(tcfg, tl, tx, ts)
    assert _close(jy, ty) and _close(jshift, tshift)


def _tokens(cfg, b=2, s=20, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_forward_prefill_decode_match_jax():
    jcfg, tcfg, jp, tp = _pair()
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
    assert np.array_equal(np.asarray(jcache["t"]), tcache["t"].numpy())
    jst, tst = jcache["blocks"]["p0_rwkv"]["rwkv"], tcache["blocks"]["p0_rwkv"]["rwkv"]
    for leaf in ("shift_tm", "shift_cm", "wkv"):
        assert tst[leaf].shape == jst[leaf].shape
        assert _err(jst[leaf], tst[leaf]) < LOGIT_TOL, leaf
    assert tst["wkv"].dtype == torch.float32


def test_decode_matches_forward():
    """The port's own contract of tests/test_decode_consistency.py."""
    _, tcfg, _, tp = _pair()
    toks = torch.from_numpy(_tokens(tcfg, seed=2)).long()
    cache = model.init_cache(tcfg, 2, 32, device="cpu")
    last, cache = model.prefill(tcfg, tp, toks, cache)
    seq = [torch.argmax(last, -1)]
    for _ in range(3):
        dl, cache = model.decode_step(tcfg, tp, seq[-1], cache)
        full, _ = model.forward(tcfg, tp, torch.cat([toks, torch.stack(seq, 1)], 1))
        assert float((dl - full[:, -1]).abs().max()) < 5e-3
        seq.append(torch.argmax(dl, -1))


def test_params_from_jax_keeps_the_f32_leaves():
    _, tcfg, jp, _ = _pair()
    tree = jax.tree.map(np.asarray, jp)
    bf16 = params_from_jax(tcfg, tree, dtype=torch.bfloat16)
    leaves = bf16["layers"][0]["rwkv"]
    assert all(leaves[n].dtype == torch.float32 for n in rwkv.F32_LEAVES)
    assert leaves["wr"].dtype == torch.bfloat16 and bf16["embed"].dtype == torch.bfloat16
    own = model.init_params(tcfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                            device="cpu")
    assert {n: t.dtype for n, t in own["layers"][0]["rwkv"].items()} == {
        n: t.dtype for n, t in leaves.items()}


def test_init_params_shapes_and_count_match_jax():
    _, tcfg, jp, tp = _pair()
    own = model.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(own) == shapes(tp)
    assert sum(x.numel() for x in jax.tree.leaves(own)) == model.param_count(tcfg)
    assert not any(own["layers"][0]["rwkv"][n].any() for n in rwkv.F32_LEAVES)
    assert "mlp" not in own["layers"][0]


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
    jcfg, tcfg, jp, tp = _pair()
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, size=n).astype(np.int32) for n in (5, 11, 40)]
    ecfg = dict(slots=3, cache_len=64, max_new_tokens=4)
    jout = _run(JaxEngine(jcfg, jp, JaxEngineConfig(**ecfg)),
                [JaxRequest(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    teng = Engine(tcfg, tp, EngineConfig(device="cpu", **ecfg))
    tout = _run(teng, [Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)])
    assert tout == jout and all(len(o) == 5 for o in tout)
    # each request's state landed in its own slot of the layer-stacked cache
    wkv = teng.cache["blocks"]["p0_rwkv"]["rwkv"]["wkv"]
    assert wkv.shape == (tcfg.num_layers, 3, 4, 64, 64) and bool(wkv.abs().sum((0, 2, 3, 4)).all())


def test_serve_cli_reduced_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--reduced", "--device", "cpu",
        "--requests", "3", "--slots", "2", "--max-new", "2", "--prompt-len", "6"])
    serve.main()
    out = capsys.readouterr().out
    assert "'finished': 3" in out and "device=cpu" in out and ARCH in out
