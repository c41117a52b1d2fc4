"""The port's checkpointing (``repro_torch.checkpoint``) against the JAX
package's: the same npz layout (keys ``k:``/``i:`` joined by ``__/__``,
bf16 as raw ``uint16`` bits, a ``.json`` sidecar with the step), written
atomically, restoring bit for bit in either package; a checkpoint of the
JAX package's parameters restores into the port's layout through
``params_from_jax`` with no ``ml_dtypes``, and gives the reference's
logits at 1e-5 (f32: the same weights, the same arithmetic summed in
another order through two layers).
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.models import model as jmodel
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.models import model
from repro_torch.models.params import params_from_jax
from repro_torch.training import OptimizerConfig, ScheduleConfig, adamw_init
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import tree_leaves
from repro_torch.training.train_loop import TrainConfig, batch_to, make_train_step


def _tree(wide=True):
    """f32, bf16, an int32 scalar and nested lists; ``wide`` adds int64 and
    float64 leaves, which JAX holds only under x64."""
    g = torch.Generator().manual_seed(0)
    tree = {
        "a": torch.randn(2, 3, generator=g),
        "half": (torch.randn(4, 5, generator=g) * 1e3).to(torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int32),
        "layers": [{"w": torch.randn(3, generator=g), "ids": torch.arange(4, dtype=torch.int32)},
                   [torch.ones(2, dtype=torch.bfloat16), torch.zeros(())]],
    }
    if wide:
        tree["layers"][0]["ids"] = torch.arange(4)
        tree["layers"][1][1] = torch.zeros((), dtype=torch.float64)
    return tree


def _assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)


def test_round_trip_into_a_template_is_bit_for_bit(tmp_path):
    tree = _tree()
    path = save_checkpoint(str(tmp_path), 12, tree)
    assert path == str(tmp_path / "state_00000012.npz")
    _assert_same(restore_checkpoint(str(tmp_path), 12, tree), tree)
    # bf16 is stored as its bits
    with np.load(path) as data:
        assert data["k:half"].dtype == np.uint16
        assert np.array_equal(data["k:half"],
                              tree["half"].view(torch.int16).numpy().view(np.uint16))
        assert data["k:layers__/__i:1__/__i:0"].dtype == np.uint16


def test_round_trip_without_a_template_rebuilds_dicts_and_lists(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 1, tree)
    got = restore_checkpoint(str(tmp_path), 1)
    assert isinstance(got["layers"], list) and isinstance(got["layers"][1], list)
    assert list(got["layers"][0]) == ["w", "ids"]
    _assert_same(got, tree)


def test_restore_casts_to_the_template_and_checks_shapes(tmp_path):
    tree = {"w": torch.randn(3, 4, generator=torch.Generator().manual_seed(1))}
    save_checkpoint(str(tmp_path), 0, tree)
    got = restore_checkpoint(str(tmp_path), 0, {"w": torch.empty(3, 4, dtype=torch.float64)})
    assert got["w"].dtype == torch.float64 and torch.equal(got["w"].float(), tree["w"])
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), 0, {"w": torch.empty(4, 3)})


def test_save_is_atomic_and_leaves_no_temp_file(tmp_path):
    save_checkpoint(str(tmp_path), 5, _tree(), name="opt")
    assert sorted(os.listdir(tmp_path)) == ["opt_00000005.json", "opt_00000005.npz"]
    meta = json.loads((tmp_path / "opt_00000005.json").read_text())
    assert meta["step"] == 5 and "layers" in meta["treedef"]


def test_latest_step(tmp_path):
    assert latest_step(str(tmp_path / "missing")) is None
    assert latest_step(str(tmp_path)) is None
    for step in (3, 10, 7):
        save_checkpoint(str(tmp_path), step, {"x": torch.zeros(1)})
    save_checkpoint(str(tmp_path), 99, {"x": torch.zeros(1)}, name="other")
    assert latest_step(str(tmp_path)) == 10
    assert latest_step(str(tmp_path), name="other") == 99


def _jax_twin(tree):
    """The same tree as JAX arrays (bf16 through float32, exactly)."""
    def conv(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    return jax.tree.map(conv, tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


def test_both_packages_write_the_same_arrays(tmp_path):
    tree = _tree(wide=False)
    mine = save_checkpoint(str(tmp_path / "port"), 4, tree)
    theirs = jckpt.save_checkpoint(str(tmp_path / "jax"), 4, _jax_twin(tree))
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_each_package_restores_what_the_other_wrote(tmp_path):
    tree = _tree(wide=False)
    jax_tree = _jax_twin(tree)
    jckpt.save_checkpoint(str(tmp_path / "jax"), 2, jax_tree)
    _assert_same(restore_checkpoint(str(tmp_path / "jax"), 2, tree), tree)
    save_checkpoint(str(tmp_path / "port"), 2, tree)
    back = jckpt.restore_checkpoint(str(tmp_path / "port"), 2, jax_tree)
    for a, b in zip(jax.tree.leaves(jax_tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_reference_parameter_checkpoint_gives_the_reference_logits(tmp_path):
    jcfg, tcfg = jax_config("qwen1.5-0.5b").reduced(), get_config("qwen1.5-0.5b").reduced()
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    jckpt.save_checkpoint(str(tmp_path), 100, jp, name="params")
    restored = restore_checkpoint(str(tmp_path), latest_step(str(tmp_path), name="params"),
                                  name="params")
    tp = params_from_jax(tcfg, restored)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want, _ = jmodel.forward(jcfg, jp, jnp.asarray(toks))
    got, _ = model.forward(tcfg, tp, torch.from_numpy(toks).long())
    assert float(np.abs(np.asarray(want) - got.numpy()).max()) < 1e-5


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b", "whisper-small"])
def test_reference_bf16_checkpoint_restores_bit_for_bit(tmp_path, arch):
    """bf16 weights saved by the JAX package come back in the port's layout
    with the same bits as ``params_from_jax`` of the arrays themselves; the
    leaves the JAX package keeps in f32 stay f32."""
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = jmodel.init_params(jcfg, jax.random.key(0), dtype=jnp.bfloat16)
    jckpt.save_checkpoint(str(tmp_path), 0, jp)
    got = params_from_jax(tcfg, restore_checkpoint(str(tmp_path), 0))
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    _assert_same(got, want)
    assert {t.dtype for t in tree_leaves(got)} == {t.dtype for t in tree_leaves(want)}
    assert torch.bfloat16 in {t.dtype for t in tree_leaves(got)}


def test_training_resumes_from_a_checkpoint_bit_for_bit(tmp_path):
    """Two steps, save {params, opt_state}, restore into the live state as
    template: the next step from the restored state equals the next step
    from the state in memory."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3),
                       schedule=ScheduleConfig(kind="constant", peak_lr=1e-3, warmup_steps=1))
    step = make_train_step(cfg, tcfg)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params, tcfg.optimizer)
    data = SyntheticLM(cfg.vocab_size, 16, 2, seed=0)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch_to(next(data), "cpu"))
    state = {"params": params, "opt_state": opt}
    save_checkpoint(str(tmp_path), int(opt["step"]), state)
    back = restore_checkpoint(str(tmp_path), latest_step(str(tmp_path)), state)
    _assert_same(back, state)
    batch = batch_to(next(data), "cpu")
    a = step(params, opt, batch)
    b = step(back["params"], back["opt_state"], batch)
    _assert_same(a, b)
