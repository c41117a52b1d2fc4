"""Port's logical-axis sharding layer (``distributed/sharding.py``,
``launch/mesh.py``) against the JAX package's.

The seven no-compile cases of ``tests/test_sharding.py`` run on the port's
mesh records, with the reference's expected partition specs written as the
tuples the port returns.  ``make_rules`` is integer arithmetic over the
config and the mesh's sizes, so it is held equal, dict for dict, to the
reference's ``make_rules`` on ``jax.sharding.AbstractMesh(shape, names)``
(no devices) for every arch x {train, prefill, decode} x {the 16 x 16 pod,
the 2 x 16 x 16 two-pod mesh}, at the batch and cache sizes of the
registry's input shapes.
"""
import jax
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_INPUT_SHAPES
from repro.configs import get_config as jax_config
from repro.configs import list_architectures
from repro.distributed import sharding as jshard
from repro.launch import mesh as jmesh
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.distributed import (AxisRules, MeshShape, axis_rules, current_rules,
                                     device_mesh, logical_to_spec, shard, spec_for_axes)
from repro_torch.launch.mesh import make_production_mesh, make_rules, make_test_mesh

PROD_MESH = MeshShape(("data", "model"), (16, 16))
POD_MESH = MeshShape(("pod", "data", "model"), (2, 16, 16))
MESHES = {"pod1": ((16, 16), ("data", "model")), "pod2": ((2, 16, 16), ("pod", "data", "model"))}
# each mode's (batch, cache length) at the registry's input shapes
MODES = {"train": (INPUT_SHAPES["train_4k"].global_batch, 0),
         "prefill": (INPUT_SHAPES["prefill_32k"].global_batch, 0),
         "decode": (INPUT_SHAPES["decode_32k"].global_batch, INPUT_SHAPES["decode_32k"].seq_len)}


def test_logical_to_spec_basic():
    rules = AxisRules(mesh=PROD_MESH, rules={"batch": ("data",), "ff": "model"})
    assert logical_to_spec(("batch", None, "ff"), rules) == ("data", None, "model")


def test_logical_to_spec_consumes_axis_once():
    rules = AxisRules(mesh=PROD_MESH, rules={"a": "model", "b": "model"})
    # the second dimension must NOT reuse the already-consumed mesh axis
    assert logical_to_spec(("a", "b"), rules) == ("model",)


def test_rules_divisibility_minicpm():
    """minicpm: 36 heads don't divide 16 -> heads replicated; ff 5760 does."""
    rules = make_rules(get_config("minicpm-2b"), PROD_MESH, "train", batch_size=256).rules
    assert rules["heads"] is None
    assert rules["kv_heads"] is None
    assert rules["ff"] == "model"          # 5760 % 16 == 0
    assert rules["vocab"] is None          # 122753 is odd


def test_rules_divisibility_llama():
    rules = make_rules(get_config("llama3-8b"), PROD_MESH, "train", batch_size=256).rules
    assert rules["heads"] == "model"       # 32 % 16
    assert rules["kv_heads"] is None       # 8 < 16
    assert rules["vocab"] == "model"       # 128256 % 16
    assert rules["batch"] == ("data",)


def test_rules_multipod_batch():
    rules = make_rules(get_config("llama3-8b"), POD_MESH, "train", batch_size=256).rules
    assert rules["batch"] == ("pod", "data")


def test_rules_decode_kv_split():
    cfg = get_config("llama3-8b")
    rules = make_rules(cfg, PROD_MESH, "decode", batch_size=128, cache_len=32768).rules
    assert rules["kv_seq"] == "model"      # flash-decode split-K
    rules2 = make_rules(cfg, PROD_MESH, "prefill", batch_size=32).rules
    assert rules2["kv_seq"] is None


def test_batch_not_divisible_stays_replicated():
    rules = make_rules(get_config("llama3-8b"), PROD_MESH, "decode", batch_size=1,
                       cache_len=4096).rules
    assert rules["batch"] is None          # long_500k batch=1


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", list_architectures())
def test_make_rules_equals_the_reference(arch, mode, mesh):
    shape, names = MESHES[mesh]
    batch, cache_len = MODES[mode]
    exp = jmesh.make_rules(jax_config(arch), jax.sharding.AbstractMesh(shape, names), mode,
                           batch_size=batch, cache_len=cache_len)
    got = make_rules(get_config(arch), MeshShape(names, shape), mode, batch_size=batch,
                     cache_len=cache_len)
    assert got.rules == exp.rules
    assert got.mesh.shape == dict(exp.mesh.shape) and got.mesh.axis_names == exp.mesh.axis_names


def test_kimi_k2_decode_cache_spec_equals_the_reference():
    """kimi-k2's decode at B = 128, cache 32768 on both meshes: the KV
    cache's spec under the rules, the reference's PartitionSpec entries as
    a tuple."""
    axes = ("batch", "kv_seq", "kv_heads", None)
    for shape, names in MESHES.values():
        jr = jmesh.make_rules(jax_config("kimi-k2-1t-a32b"), jax.sharding.AbstractMesh(shape, names),
                              "decode", batch_size=128, cache_len=32768)
        tr = make_rules(get_config("kimi-k2-1t-a32b"), MeshShape(names, shape), "decode",
                        batch_size=128, cache_len=32768)
        assert logical_to_spec(axes, tr) == tuple(jshard.logical_to_spec(axes, jr))
    assert logical_to_spec(axes, tr) == (("pod", "data"), "model")


def test_meshes_are_records_of_the_reference_shapes():
    assert make_production_mesh() == PROD_MESH and make_production_mesh(multi_pod=True) == POD_MESH
    assert POD_MESH.shape == {"pod": 2, "data": 16, "model": 16}
    assert make_test_mesh() == MeshShape(("data", "model"), (1, 1))
    assert set(JAX_INPUT_SHAPES) == set(INPUT_SHAPES)
    with pytest.raises(ValueError):
        MeshShape(("data",), (2, 2))


def test_axis_rules_scope_shard_and_device_mesh():
    """Rules hold inside ``axis_rules`` only; ``shard`` returns its tensor and,
    under rules, asserts one logical axis a dimension; ``spec_for_axes`` is
    (mesh, spec) under rules and None without; one card (or none) makes no
    mesh, as the reference makes none on one device."""
    x = torch.zeros(2, 3)
    rules = make_rules(get_config("llama3-8b"), PROD_MESH, "train", batch_size=256)
    assert current_rules() is None and spec_for_axes(("batch", None)) is None
    assert shard(x, "batch") is x                 # no rules: nothing checked
    with axis_rules(rules):
        assert current_rules() is rules
        assert shard(x, "batch", None) is x
        assert spec_for_axes(("batch", "ff")) == (PROD_MESH, ("data", "model"))
        with pytest.raises(AssertionError):
            shard(x, "batch")
    assert current_rules() is None
    assert logical_to_spec(("batch",)) == ()
    assert device_mesh(devices=["cuda:0"]) is None and device_mesh(devices=[]) is None
    assert device_mesh("grid", devices=["cuda:0", "cuda:1"]) == MeshShape(("grid",), (2,))
