"""Port's norms, MLPs and RoPE against the JAX package's, in f32.

Parameters come from the JAX init, go through ``params_from_jax``, and every
all-ones or all-zeros leaf (norm scales, biases) is first replaced by random
values so that each term is exercised.  Tolerance 1e-5: the same f32
arithmetic in another order, on values of size ~1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models.params import params_from_jax

TOL = 1e-5


def _configs(arch, **changes):
    return (dataclasses.replace(jax_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def _params(jcfg, tcfg, seed=0):
    """(JAX tree, port params) on the same random weights."""
    tree = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: rng.normal(1.0, 0.5, a.shape).astype(a.dtype) if np.all(a == a.flat[0]) else a,
        tree,
    )
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tcfg, tree)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree["blocks"]["p0_attn"])


def _x(shape, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _err(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j) - t.numpy())))


@pytest.mark.parametrize("norm,mlp", [("rmsnorm", "swiglu"), ("layernorm", "gelu")])
def test_norm_and_mlp_match_jax(norm, mlp):
    jcfg, tcfg = _configs("qwen1.5-0.5b", norm=norm, mlp=mlp)
    jtree, tparams = _params(jcfg, tcfg)
    jp, tp = _layer0(jtree), tparams["layers"][0]
    jx, tx = _x((2, 5, jcfg.d_model))
    for name in ("norm1", "norm2"):
        assert _err(jlayers.apply_norm(jcfg, jp[name], jx),
                    layers.apply_norm(tcfg, tp[name], tx)) < TOL
    assert _err(jlayers.apply_mlp(jcfg, jp["mlp"], jx), layers.apply_mlp(tcfg, tp["mlp"], tx)) < TOL
    assert _err(jlayers.apply_norm(jcfg, jtree["final_norm"], jx),
                layers.apply_norm(tcfg, tparams["final_norm"], tx)) < TOL


def test_norm_keeps_dtype_and_runs_in_f32():
    _, tcfg = _configs("qwen1.5-0.5b")
    x = torch.full((1, 2, tcfg.d_model), 3.0, dtype=torch.bfloat16)
    y = layers.apply_norm(tcfg, {"scale": torch.ones(tcfg.d_model, dtype=torch.bfloat16)}, x)
    assert y.dtype == torch.bfloat16
    assert torch.allclose(y.float(), torch.ones_like(y, dtype=torch.float32), atol=1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0, 0.0])
def test_rope_matches_jax(theta):
    jx, tx = _x((2, 7, 4, 16))
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [100, 101, 102, 103, 104, 105, 106]], np.int32)
    exp = jlayers.apply_rope(jx, jnp.asarray(pos), theta)
    out = layers.apply_rope(tx, torch.from_numpy(pos), theta)
    assert _err(exp, out) < TOL
    if theta == 0.0:
        assert out is tx


def test_rope_freqs_match_jax():
    exp = jlayers.rope_freqs(128, 500_000.0)
    assert _err(exp, layers.rope_freqs(128, 500_000.0, "cpu")) < 1e-9


def test_embed_matches_jax():
    jcfg, tcfg = _configs("qwen1.5-0.5b")
    jtree, tparams = _params(jcfg, tcfg)
    toks = np.array([[0, 5, 1023], [7, 7, 2]], np.int32)
    exp = jlayers.embed_tokens(jtree["embed"], jnp.asarray(toks))
    assert _err(exp, layers.embed_tokens(tparams["embed"], torch.from_numpy(toks).long())) == 0.0


def test_params_from_jax_unstacks_layers():
    jcfg, tcfg = _configs("llama3-8b")          # GQA, untied head
    jtree, tparams = _params(jcfg, tcfg)
    assert len(tparams["layers"]) == tcfg.num_layers
    for i, layer in enumerate(tparams["layers"]):
        wq = np.asarray(jtree["blocks"]["p0_attn"]["attn"]["wq"][i])
        assert np.array_equal(layer["attn"]["wq"].numpy(), wq)
    assert np.array_equal(tparams["lm_head"].numpy(), np.asarray(jtree["lm_head"]))
    _, tied = _params(*_configs("qwen1.5-0.5b"))
    assert "lm_head" not in tied


def test_params_from_jax_keeps_bf16_and_casts_on_request():
    jcfg, tcfg = _configs("qwen1.5-0.5b")
    tree = jax.tree.map(np.asarray, jmodel.init_params(jcfg, jax.random.key(0), jnp.bfloat16))
    kept = params_from_jax(tcfg, tree)
    assert kept["embed"].dtype == torch.bfloat16
    cast = params_from_jax(tcfg, tree, dtype=torch.float32)
    assert cast["layers"][1]["attn"]["bq"].dtype == torch.float32
    assert np.array_equal(cast["embed"].numpy(), np.asarray(tree["embed"], np.float32))
