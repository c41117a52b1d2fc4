"""Port's parameter axes and meta-tensor specs (``models/params.py``'s
boxed helpers, ``models/model.py:param_axes``/``abstract_params``,
``launch/specs.py``) against the JAX package's, at full size.

The reference computes its trees with ``jax.eval_shape`` and allocates
nothing; the port builds its own on the ``meta`` device.  The reference
stacks each block kind over the pattern's repetitions with a leading
``"layers"`` axis; its trees are brought to the port's per-layer layout by
``params.from_jax_layout``, the unstacking ``params_from_jax`` does, which
drops that axis.  Shapes, dtypes and axes are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import get_config as jax_config
from repro.configs import list_architectures
from repro.launch import specs as jspecs
from repro.models import model as jmodel
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model
from repro_torch.models.params import (Boxed, axes_of, boxed_normal, boxed_value, from_jax_layout,
                                       is_boxed, unbox, values_of)
from repro_torch.training.optimizer import tree_leaves

ARCHS = list_architectures()
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _unstacked_axes(cfg, tree):
    """The reference's axes tree in the port's layout: a stacked leaf's
    leading "layers" axis dropped."""
    def stacked(axes, name, r):
        assert axes[0] == "layers", (name, axes)
        return axes[1:]
    return from_jax_layout(cfg, tree, lambda axes, name: axes, stacked)


def _shape_dtype(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


def _flat(tree, prefix=""):
    """{path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() for p, v in _flat(t, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree) for p, v in _flat(t, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_equal_the_reference(arch):
    cfg = get_config(arch)
    exp = _unstacked_axes(cfg, jmodel.param_axes(jax_config(arch)))
    assert model.param_axes(cfg) == exp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_shapes_and_dtypes_equal_the_reference(arch, dtype):
    cfg = get_config(arch)
    ref = jmodel.abstract_params(jax_config(arch), DTYPES[dtype][0])
    exp = from_jax_layout(cfg, ref, lambda x, name: (tuple(x.shape), str(x.dtype)),
                          lambda x, name, r: (tuple(x.shape[1:]), str(x.dtype)))
    got = model.abstract_params(cfg, DTYPES[dtype][1])
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert jax.tree.map(_shape_dtype, got) == exp
    assert sum(t.numel() for t in tree_leaves(got)) == cfg.params_total


def test_boxed_helpers():
    """``init_params`` is ``values_of(init_params_boxed)``, drawn the same
    way; ``unbox`` splits a tree into values and axes of one structure."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    gen = lambda: torch.Generator().manual_seed(3)
    boxed = model.init_params_boxed(cfg, gen(), device="cpu")
    values, axes = unbox(boxed)
    plain = model.init_params(cfg, gen(), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(values), tree_leaves(plain)))
    assert axes == axes_of(boxed) == model.param_axes(cfg)
    b = boxed_normal(gen(), (3, 4), ("embed", "ff"), 0.5, torch.float32, "cpu")
    assert is_boxed(b) and b.axes == ("embed", "ff") and b.value.shape == (3, 4)
    assert values_of({"w": [boxed_value(torch.ones(2), ("ff",))]})["w"][0].shape == (2,)
    with pytest.raises(AssertionError):
        boxed_normal(gen(), (3, 4), ("embed",), 1.0, torch.float32, "cpu")
    # meta: nothing drawn, so the generator is left as it was
    g = gen()
    state = g.get_state()
    m = boxed_normal(g, (1 << 20, 1 << 20), (None, None), 1.0, torch.bfloat16, "meta")
    assert m.value.device.type == "meta" and torch.equal(g.get_state(), state)
    assert isinstance(Boxed(1, ()), Boxed)


def _cache_pairs(arch, shape_name, dtype):
    cfg, jcfg = get_config(arch), jax_config(arch)
    got = specs.cache_spec(cfg, INPUT_SHAPES[shape_name], DTYPES[dtype][1])
    exp = jspecs.cache_spec(jcfg, JAX_INPUT_SHAPES[shape_name], DTYPES[dtype][0])
    return got, exp


@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_the_reference(arch, shape_name):
    """Every cache leaf's shape, dtype and logical axes (whisper's ``cross``
    included), the batch's shapes, dtypes and axes, and the decode window,
    for every arch x input shape."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    shape, jshape = INPUT_SHAPES[shape_name], JAX_INPUT_SHAPES[shape_name]
    assert specs.decode_window(cfg, shape) == jspecs.decode_window(jcfg, jshape)
    got, exp = _cache_pairs(arch, shape_name, "bfloat16")
    flat_got, flat_exp = _flat(got), _flat(jax.tree.map(lambda x: x, exp))
    assert {p: _shape_dtype(t) for p, t in flat_got.items()} == {
        p: (tuple(x.shape), str(x.dtype)) for p, x in flat_exp.items()}
    assert all(t.device.type == "meta" for t in flat_got.values())
    assert _flat(specs.cache_axes(got)) == _flat(jspecs.cache_axes(exp))
    if cfg.is_encoder_decoder:
        assert got["cross"]["k"].shape == (cfg.num_layers, shape.global_batch, cfg.encoder_seq,
                                           cfg.num_kv_heads, cfg.resolved_head_dim)
    batch, jbatch = specs.batch_spec(cfg, shape), jspecs.batch_spec(jcfg, jshape)
    assert {k: _shape_dtype(t) for k, t in batch.items()} == {
        k: (tuple(x.shape), str(x.dtype)) for k, x in jbatch.items()}
    assert specs.batch_axes(cfg, batch) == jspecs.batch_axes(jcfg, jbatch)


def test_whisper_cross_cache_at_prefill_32k():
    """The reference's ``cross`` leaves at prefill_32k: (12, 32, 1500, 12, 64)."""
    got, _ = _cache_pairs("whisper-small", "prefill_32k", "bfloat16")
    assert tuple(got["cross"]["v"].shape) == (12, 32, 1500, 12, 64)
    assert specs.cache_axes(got)["cross"]["k"] == ("layers", "batch", None, "kv_heads", None)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "recurrentgemma-9b", "whisper-small",
                                  "rwkv6-1.6b"])
def test_build_step_specs_follow_the_reference_rules(arch, kind):
    """build_step's partition specs are ``logical_to_spec`` of the leaves'
    axes under the reference's rules: the params' equal the reference's
    own specs of its axes tree, unstacked; the arguments are meta tensors;
    ``donate`` is the reference's."""
    from repro.distributed.sharding import logical_to_spec as jspec
    from repro.launch.mesh import make_rules as jrules

    shape_name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    step, args, parts, rules, donate = specs.build_step(cfg, shape, make_production_mesh())
    assert callable(step) and donate == ((0, 1) if kind == "train" else (2,))
    assert all(t.device.type == "meta" for t in tree_leaves(list(args)))
    jr = jrules(jax_config(arch), jax.sharding.AbstractMesh((16, 16), ("data", "model")), kind,
                batch_size=shape.global_batch,
                cache_len=shape.seq_len if kind == "decode" else 0)
    assert rules.rules == jr.rules
    exp = _unstacked_axes(cfg, jmodel.param_axes(jax_config(arch), jnp.bfloat16))
    exp = jax.tree.map(lambda axes: tuple(jspec(axes, jr)), exp,
                       is_leaf=lambda x: isinstance(x, tuple))
    assert parts[0] == exp
    if kind == "train":
        assert parts[1]["m"] == parts[0] and parts[1]["step"] == ()
        assert np.all([t.dtype == (torch.bfloat16 if cfg.params_total > 2e11 else torch.float32)
                       for t in tree_leaves(args[1]["m"])])
