"""The port's bf16 model path against the JAX package's bf16 path, one
config per served family at ``reduced()``: qwen1.5-0.5b (attention),
rwkv6-1.6b (the WKV scan), recurrentgemma-9b (RG-LRU + local attention),
phi3.5-moe-42b-a6.6b (MoE) and whisper-small (encoder-decoder).

The same bf16 weights go into both: the JAX package's f32 parameters are
cast in JAX to the dtypes of its own bf16 ``init_params`` (the leaves it
keeps in f32 stay f32), and the port takes that tree through
``params_from_jax(..., dtype=torch.bfloat16)``.  Both run ``forward`` on
the same numpy tokens (and whisper's frames).

Bound: 2 × the larger of JAX's own and the port's own bf16-vs-f32 gap on
the logits (each measured here, on the same inputs), plus one bf16 step at
the logits' magnitude.  Two correct bf16 paths differ only in where they
round, so they stay within twice what rounding moves either one.  While
the f32 paths agree (``tests/test_torch_model.py`` and the family files
hold them to 1e-4) that bound follows from the triangle inequality, so a
second check is added: the port's own gap is at most 2 × JAX's own plus
the same step, which fails where the port's bf16 path moves the logits
more than twice as far from f32 as JAX's does.  At 16 tokens neither
check resolves where a path rounds (a bf16 softmax input, a bf16 norm or
a bf16 WKV state each stay within both).  For the
MoE config only tokens whose top-k experts agree in every MoE layer
between the two bf16 runs are compared (a flip picks other experts), and
at least 90% of the tokens must agree; the gaps are taken over the same
tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import frontends, model, moe
from repro_torch.models.params import params_from_jax

FAMILIES = ["qwen1.5-0.5b", "rwkv6-1.6b", "recurrentgemma-9b",
            "phi3.5-moe-42b-a6.6b", "whisper-small"]
B, S = 2, 16
MIN_AGREE = 0.9


def _jax_bf16(jcfg, jp):
    """JAX's f32 parameters cast to the dtypes of its own bf16 init."""
    dtypes = jax.eval_shape(
        lambda k: jmodel.init_params(jcfg, k, dtype=jnp.bfloat16), jax.random.key(0))
    return jax.tree.map(lambda a, s: a.astype(s.dtype), jp, dtypes)


def _bf16_step(x: float) -> float:
    """The spacing of bf16 numbers (8 significant bits) at magnitude ``x``."""
    return float(2.0 ** (np.floor(np.log2(x)) - 7))


class _Routes:
    """The top-k experts each ``_route`` call picks, per MoE layer, sorted
    within a token (JAX's layer scan runs unrolled so they are concrete)."""

    def __init__(self, monkeypatch, module, to_numpy):
        self.layers = []
        route = module._route

        def recording(cfg, router_w, xf):
            out = route(cfg, router_w, xf)
            self.layers.append(np.sort(to_numpy(out[1]), axis=-1))
            return out

        monkeypatch.setattr(module, "_route", recording)


def _run(arch, monkeypatch):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    jp16 = _jax_bf16(jcfg, jp)
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    tp16 = params_from_jax(tcfg, jax.tree.map(np.asarray, jp16), dtype=torch.bfloat16)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    enc = frontends.audio_frames(tcfg, B, seed=1) if tcfg.is_encoder_decoder else None

    def jax_logits(params):
        kw = {} if enc is None else {"enc_inputs": jnp.asarray(enc)}
        return np.asarray(jmodel.forward(jcfg, params, jnp.asarray(toks), **kw)[0], np.float32)

    def port_logits(params):
        kw = {} if enc is None else {"enc_inputs": torch.from_numpy(enc)}
        with torch.no_grad():
            out = model.forward(tcfg, params, torch.from_numpy(toks).long(), **kw)[0]
        return out.float().numpy()

    monkeypatch.setenv("REPRO_UNROLL_SCANS", "1")
    jroutes = _Routes(monkeypatch, jmoe, np.asarray)
    troutes = _Routes(monkeypatch, moe, lambda t: t.numpy())
    j16, p16 = jax_logits(jp16), port_logits(tp16)
    agree = np.ones(B * S, bool)
    assert len(jroutes.layers) == len(troutes.layers)
    for jl, tl in zip(jroutes.layers, troutes.layers):
        agree &= np.all(jl == tl, axis=-1)
    return j16, p16, jax_logits(jp), port_logits(tp), agree.reshape(B, S), len(jroutes.layers)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bf16_logits_match_jax_bf16(arch, monkeypatch):
    j16, p16, j32, p32, agree, moe_layers = _run(arch, monkeypatch)
    assert (moe_layers > 0) == (arch == "phi3.5-moe-42b-a6.6b")
    assert agree.mean() >= MIN_AGREE, agree.mean()
    assert np.all(np.isfinite(p16)) and p16.shape == j16.shape
    gap = lambda a, b: float(np.max(np.abs(a - b)[agree]))
    jax_gap, port_gap = gap(j16, j32), gap(p16, p32)
    step = _bf16_step(float(np.max(np.abs(j32[agree]))))
    bound = 2 * max(jax_gap, port_gap) + step
    err = gap(p16, j16)
    print(f"{arch}: |port bf16 - jax bf16| {err:.4g} <= bound {bound:.4g} "
          f"(jax gap {jax_gap:.4g}, port gap {port_gap:.4g}, "
          f"tokens compared {int(agree.sum())}/{agree.size})")
    assert err <= bound
    assert port_gap <= 2 * jax_gap + step
