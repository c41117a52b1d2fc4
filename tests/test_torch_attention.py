"""Port's attention blocks against the JAX package's, in f32.

``attention_full`` with and without its prefill cache write (full cache,
ring cache shorter than the prompt, ring longer than it) and
``attention_decode`` with ragged per-sequence positions and a window.
Parameters come from the JAX init through ``params_from_jax``, with the
zero QKV biases replaced by random values.  Tolerance 1e-5: the same f32
arithmetic in another order, on values of size ~1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.models import attention
from repro_torch.models.params import params_from_jax

TOL = 1e-5


def _setup(arch="qwen1.5-0.5b", seed=0):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    attn = tree["blocks"]["p0_attn"]["attn"]
    for b in ("bq", "bk", "bv"):
        if b in attn:
            attn[b] = rng.standard_normal(attn[b].shape).astype(np.float32)
    tparams = params_from_jax(tcfg, tree)
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["blocks"]["p0_attn"]["attn"])
    return jcfg, tcfg, jp, tparams["layers"][0]["attn"]


def _x(shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _err(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.float().numpy())))


def _same_cache(jc, tc):
    assert np.array_equal(np.asarray(jc["slot_pos"]), tc["slot_pos"].numpy())
    assert _err(jc["k"], tc["k"]) < TOL and _err(jc["v"], tc["v"]) < TOL


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3-8b"])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_full_matches_jax(arch, window):
    jcfg, tcfg, jp, tp = _setup(arch)
    jx, tx = _x((2, 20, jcfg.d_model))
    pos = np.arange(20)
    jy, _ = jattn.attention_full(jcfg, jp, jx, jnp.asarray(pos), window=window)
    ty, cache = attention.attention_full(tcfg, tp, tx, torch.from_numpy(pos), window=window)
    assert cache is None
    assert _err(jy, ty) < TOL


@pytest.mark.parametrize("window,cache_len,s", [
    (0, 32, 20),    # full cache
    (8, 8, 20),     # ring shorter than the prompt: only the tail survives
    (8, 8, 5),      # ring longer than the prompt
])
def test_prefill_cache_write_matches_jax(window, cache_len, s):
    jcfg, tcfg, jp, tp = _setup("llama3-8b")
    jx, tx = _x((2, s, jcfg.d_model))
    pos = np.arange(s)
    jcache = jattn.init_layer_cache(jcfg, 2, cache_len, jnp.float32)
    tcache = attention.init_layer_cache(tcfg, 2, cache_len, torch.float32, "cpu")
    jy, jcache = jattn.attention_full(jcfg, jp, jx, jnp.asarray(pos), window=window, cache=jcache)
    ty, tcache = attention.attention_full(tcfg, tp, tx, torch.from_numpy(pos), window=window,
                                          cache=tcache)
    assert _err(jy, ty) < TOL
    _same_cache(jcache, tcache)


@pytest.mark.parametrize("window,cache_len", [(0, 32), (8, 8)])
def test_attention_decode_matches_jax(window, cache_len):
    """Two sequences at different positions, both prefilled, then three
    decode steps; the ring case wraps around its 8 slots."""
    jcfg, tcfg, jp, tp = _setup("llama3-8b")
    jx, tx = _x((2, 12, jcfg.d_model))
    pos = np.arange(12)
    jcache = jattn.init_layer_cache(jcfg, 2, cache_len, jnp.float32)
    tcache = attention.init_layer_cache(tcfg, 2, cache_len, torch.float32, "cpu")
    _, jcache = jattn.attention_full(jcfg, jp, jx, jnp.asarray(pos), window=window, cache=jcache)
    _, tcache = attention.attention_full(tcfg, tp, tx, torch.from_numpy(pos), window=window,
                                         cache=tcache)
    t = np.array([12, 7], np.int32)      # sequence 1 rewinds: ragged positions
    for step in range(3):
        jd, td = _x((2, 1, jcfg.d_model), seed=10 + step)
        jy, jcache = jattn.attention_decode(jcfg, jp, jd, jnp.asarray(t), jcache, window=window)
        ty, tcache = attention.attention_decode(tcfg, tp, td, torch.from_numpy(t), tcache,
                                                window=window)
        assert ty.shape == (2, 1, tcfg.d_model)
        assert _err(jy, ty) < TOL, step
        _same_cache(jcache, tcache)
        t = t + 1


def test_attention_decode_scalar_position_broadcasts():
    jcfg, tcfg, jp, tp = _setup()
    jcache = jattn.init_layer_cache(jcfg, 2, 16, jnp.float32)
    tcache = attention.init_layer_cache(tcfg, 2, 16, torch.float32, "cpu")
    jd, td = _x((2, 1, jcfg.d_model))
    jy, jcache = jattn.attention_decode(jcfg, jp, jd, jnp.asarray(0, jnp.int32), jcache)
    ty, tcache = attention.attention_decode(tcfg, tp, td, torch.tensor(0), tcache)
    assert _err(jy, ty) < TOL
    _same_cache(jcache, tcache)
