"""The port's whisper (encoder, decoder, cross-attention) against the JAX
package's, at ``reduced()`` (2 encoder + 2 decoder layers, d 256, 16
frames), on the same weights (``params_from_jax``) in f32.

Tolerance 1e-4, as ``tests/test_torch_model.py``: the same f32 arithmetic
summed in another order through four layers and an unembedding gives
differences near 1e-6 on logits of size ~1.  The decode-vs-forward
contracts of ``tests/test_decode_consistency.py`` are then run on the port
alone, with its own ``init_params``, at their 5e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import attention as jattn
from repro.models import frontends as jfrontends
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.serving.engine import _scatter_slot as jax_scatter_slot
from repro_torch.configs import get_config
from repro_torch.models import attention, frontends, layers, model
from repro_torch.models.params import params_from_jax
from repro_torch.serving.engine import _scatter_slot

ARCH = "whisper-small"
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _inputs(cfg, b=2, s=6, seed=1):
    """Decoder tokens and the port's seeded audio frames (B, 16, d)."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return toks, frontends.audio_frames(cfg, b, seed=seed)


def _err(j, t) -> float:
    return float(np.max(np.abs(np.asarray(j, np.float32) - t.detach().float().numpy())))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# Frontends and positions.
# ---------------------------------------------------------------------------
FRONTENDS = {
    "audio_frames": lambda fe, cfgs: fe.audio_frames(cfgs["whisper-small"], 3, seed=2),
    "audio_frames_long": lambda fe, cfgs: fe.audio_frames(cfgs["whisper-small"], 1, frames=40),
    "vision_embeddings": lambda fe, cfgs: fe.vision_embeddings(
        cfgs["llava-next-mistral-7b"], 2, tiles=2, seed=5),
    "multimodal_inputs": lambda fe, cfgs: fe.multimodal_inputs(
        cfgs["llava-next-mistral-7b"], np.arange(12, dtype=np.int32).reshape(2, 6),
        np.linspace(-1, 1, 64 * 256, dtype=np.float32).reshape(64, 256), tiles=0, seed=1),
}


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_frontends_equal_the_reference_arrays(name):
    archs = ("whisper-small", "llava-next-mistral-7b")
    mine = FRONTENDS[name](frontends, {a: get_config(a).reduced() for a in archs})
    theirs = FRONTENDS[name](jfrontends, {a: jax_config(a).reduced() for a in archs})
    assert mine.dtype == theirs.dtype and np.array_equal(mine, theirs)
    assert frontends.WHISPER_FRAMES == jfrontends.WHISPER_FRAMES == 1500
    assert frontends.VLM_BASE_PATCHES == jfrontends.VLM_BASE_PATCHES


def test_frontends_refuse_the_wrong_family():
    lm = get_config("llama3-8b").reduced()
    with pytest.raises(ValueError, match="vision"):
        frontends.vision_embeddings(lm, 1)
    with pytest.raises(ValueError, match="audio"):
        frontends.audio_frames(lm, 1)


@pytest.mark.parametrize("shape", [(24,), (3, 1)])
def test_abs_pos_matches_jax(shape):
    pos = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape) * 37
    exp = np.asarray(jmodel._abs_pos(jnp.asarray(pos), 256))
    got = model._abs_pos(torch.from_numpy(pos), 256)
    assert got.shape == exp.shape == shape + (256,)
    assert _err(exp, got) < TOL


def test_sinusoidal_positions_match_jax_and_interleave():
    exp = np.asarray(jlayers.sinusoidal_positions(50, 64))
    got = layers.sinusoidal_positions(50, 64, device="cpu")
    assert got.dtype == torch.float32 and _err(exp, got) < TOL
    # the same angles as _abs_pos, interleaved instead of concatenated
    halves = model._abs_pos(torch.arange(50), 64)
    assert torch.allclose(got[:, 0::2], halves[:, :32]) and torch.allclose(got[:, 1::2], halves[:, 32:])


# ---------------------------------------------------------------------------
# Cross-attention, encoder, model.
# ---------------------------------------------------------------------------
def test_cross_attention_matches_jax(pair):
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, tcfg.encoder_seq, tcfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, tcfg.d_model)).astype(np.float32)
    jx = jax.tree.map(lambda a: a[0], jp["blocks"]["dec"]["xattn"])
    tx = tp["layers"][0]["xattn"]
    jk, jv = jattn.cross_attention_kv(jcfg, jx, jnp.asarray(enc))
    tk, tv = attention.cross_attention_kv(tcfg, tx, torch.from_numpy(enc))
    assert tk.shape == (2, tcfg.encoder_seq, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    assert _err(jk, tk) < TOL and _err(jv, tv) < TOL
    for rows in (x, x[:, :1]):          # prefill rows, and one decode step's
        exp = jattn.cross_attention(jcfg, jx, jnp.asarray(rows), jk, jv)
        got = attention.cross_attention(tcfg, tx, torch.from_numpy(rows), tk, tv)
        assert got.shape == rows.shape and _err(exp, got) < TOL


def test_each_decoder_layer_sees_its_own_cross_kv():
    cfg = get_config(ARCH).reduced()
    cache = model.init_cache(cfg, 2, 8, device="cpu")
    shape = (cfg.num_layers, 2, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    cache["cross"] = {"k": torch.randn(shape), "v": torch.randn(shape)}
    views = model._layer_caches(cfg, cache)
    assert len(views) == cfg.num_layers
    for i, view in enumerate(views):
        for name in ("k", "v"):     # views of the stacked tensor, not copies
            assert view["cross"][name].data_ptr() == cache["cross"][name][i].data_ptr()
            assert torch.equal(view["cross"][name], cache["cross"][name][i])


def test_encoder_matches_jax(pair):
    jcfg, tcfg, jp, tp = pair
    _, enc = _inputs(tcfg)
    exp = jmodel._encode(jcfg, jp, jnp.asarray(enc))
    got = model._encode(tcfg, tp, torch.from_numpy(enc))
    assert got.shape == (2, tcfg.encoder_seq, tcfg.d_model)
    assert _err(exp, got) < TOL


def test_forward_matches_jax(pair):
    jcfg, tcfg, jp, tp = pair
    toks, enc = _inputs(tcfg, s=9)
    jl, jaux = jmodel.forward(jcfg, jp, jnp.asarray(toks), enc_inputs=jnp.asarray(enc))
    tl, aux = model.forward(tcfg, tp, torch.from_numpy(toks).long(),
                            enc_inputs=torch.from_numpy(enc))
    assert aux == jaux == 0.0 and tl.shape == (2, 9, tcfg.vocab_size)
    assert _err(jl, tl) < TOL


def test_prefill_cache_and_chained_decode_match_jax(pair):
    jcfg, tcfg, jp, tp = pair
    toks, enc = _inputs(tcfg, s=4)
    jcache = jmodel.init_cache(jcfg, 2, 24)
    tcache = model.init_cache(tcfg, 2, 24, device="cpu")
    assert "cross" not in tcache and sorted(tcache["blocks"]) == ["dec"]
    jlast, jcache = jmodel.prefill(jcfg, jp, jnp.asarray(toks), jcache,
                                   enc_inputs=jnp.asarray(enc))
    tlast, tcache = model.prefill(tcfg, tp, torch.from_numpy(toks).long(), tcache,
                                  enc_inputs=torch.from_numpy(enc))
    assert _err(jlast, tlast) < TOL
    jleaves, tleaves = dict(_leaves(jcache)), dict(_leaves(tcache))
    assert sorted(jleaves) == sorted(tleaves)
    assert ("cross", "k") in tleaves and tleaves[("cross", "k")].shape == (
        tcfg.num_layers, 2, tcfg.encoder_seq, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    for path, leaf in jleaves.items():
        assert tuple(leaf.shape) == tuple(tleaves[path].shape), path
        assert _err(leaf, tleaves[path]) < TOL, path
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(4):
        jd, jcache = jmodel.decode_step(jcfg, jp, jnp.asarray(nxt), jcache)
        td, tcache = model.decode_step(tcfg, tp, torch.from_numpy(nxt).long(), tcache)
        assert _err(jd, td) < TOL
        nxt = np.asarray(jnp.argmax(jd, -1)).astype(np.int32)
    for path, leaf in dict(_leaves(jcache)).items():
        assert _err(leaf, dict(_leaves(tcache))[path]) < TOL, path


def test_prefill_needs_the_audio():
    cfg = get_config(ARCH).reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="enc_inputs"):
        model.prefill(cfg, params, torch.zeros((1, 4), dtype=torch.long),
                      model.init_cache(cfg, 1, 8, device="cpu"))


def test_own_init_matches_the_jax_shapes_and_count(pair):
    _, tcfg, _, converted = pair
    own = model.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    shapes = lambda t: jax.tree.map(lambda x: tuple(x.shape), t)
    assert shapes(own) == shapes(converted)
    assert len(own["layers"]) == tcfg.num_layers and len(own["encoder"]["blocks"]) == 2
    assert sum(x.numel() for x in jax.tree.leaves(own)) == model.param_count(tcfg)


# ---------------------------------------------------------------------------
# The port's own decode-vs-forward contracts (tests/test_decode_consistency.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [20, 12])
def test_decode_matches_forward(s):
    cfg = get_config(ARCH).reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, s), generator=gen)
    enc = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)
    cache = model.init_cache(cfg, 2, 2 * s, device="cpu")
    last, cache = model.prefill(cfg, params, toks, cache, enc_inputs=enc)
    assert "cross" in cache
    nxt = torch.argmax(last, -1)
    dl, cache = model.decode_step(cfg, params, nxt, cache)
    full, _ = model.forward(cfg, params, torch.cat([toks, nxt[:, None]], 1), enc_inputs=enc)
    assert float((dl - full[:, -1]).abs().max()) < 5e-3


# ---------------------------------------------------------------------------
# The engine's slot scatter on whisper's cache tree.
# ---------------------------------------------------------------------------
def test_scatter_slot_matches_jax_on_blocks_cross_tail_and_t():
    rng = np.random.default_rng(0)
    shapes = {("blocks", "dec", "attn", "k"): (2, 3, 8, 2, 4),
              ("blocks", "dec", "attn", "slot_pos"): (2, 3, 8),
              ("cross", "k"): (2, 3, 5, 2, 4), ("cross", "v"): (2, 3, 5, 2, 4),
              ("tail", "t0_rglru", "rglru", "h"): (3, 6), ("t",): (3,)}
    batch_axis = lambda path: 1 if path[0] in ("blocks", "cross") else 0

    def tree(one):
        out = {}
        for path, shape in shapes.items():
            shape = list(shape)
            if one:
                shape[batch_axis(path)] = 1
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = rng.standard_normal(shape).astype(np.float32)
        return out

    full, one = tree(False), tree(True)
    exp = jax_scatter_slot(jax.tree.map(jnp.asarray, full), jax.tree.map(jnp.asarray, one), 2)
    to_t = lambda a: torch.from_numpy(a.copy())
    got = _scatter_slot(jax.tree.map(to_t, full), jax.tree.map(to_t, one), 2)
    for path, leaf in _leaves(exp):
        assert np.array_equal(np.asarray(leaf), dict(_leaves(got))[path].numpy()), path
    # slot 2 took the batch-1 tree; slots 0 and 1 kept theirs
    assert np.array_equal(dict(_leaves(got))[("cross", "v")][:, :2].numpy(),
                          full["cross"]["v"][:, :2])
