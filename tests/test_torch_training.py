"""The port's training (``repro_torch.training``, ``model.loss_fn``,
``launch/train.py``) against the JAX package's, and the autograd Functions
of ``kernels/ops.py`` on the CPU.

Tolerances: the data bit for bit (a NumPy copy); schedules 1e-7 relative
or 1e-7 of the peak rate (the same float32 operations; XLA's cos and
torch's differ by an ulp); ``adamw_update`` on the same gradients 1e-6
(the same float32 operations in the same order; the global norm sums its
leaves' sums in another order); ``loss_fn`` 1e-5 on loss, ``ce`` and
``aux`` and 1e-5 of each gradient leaf's largest value (the same f32
arithmetic summed in another order, measured <= 3.7e-6).  ``make_train_step``
is held to the reference's jitted step at 1e-5 of each leaf's largest value
on m, v and the metrics.  Parameters are held at 1e-5 of the tree's largest
parameter: Adam divides m̂ by √v̂ + ε, so where a gradient is near ε (a key
bias, whose gradient nearly cancels under the softmax) the step amplifies
the gradient's ~1e-6 relative rounding by up to |g|/ε; measured 5.4e-7
absolute on qwen's ``bk`` after two steps at lr 1e-3, against a leaf that
is itself ~lr.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model as jmodel
from repro.training import optimizer as jopt
from repro.training import schedule as jsched
from repro.training import train_loop as jloop
from repro.training.data import SyntheticLM as JaxSyntheticLM
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, list_architectures
from repro_torch.kernels import _build, ops, ref
from repro_torch.launch import train as train_cli
from repro_torch.models import model
from repro_torch.models.params import params_from_jax
from repro_torch.training import (
    OptimizerConfig,
    ScheduleConfig,
    adamw_init,
    adamw_update,
    make_schedule,
)
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import global_norm, tree_leaves, tree_unflatten
from repro_torch.training.train_loop import TrainConfig, batch_to, make_train_step, train

ARCHS = list_architectures()
TRAIN_STEP_ARCHS = ["qwen1.5-0.5b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "recurrentgemma-9b",
                    "whisper-small"]
TOL = 1e-5


def _pair(arch, seed=0):
    jcfg, tcfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jp = jmodel.init_params(jcfg, jax.random.key(seed))
    return jcfg, tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp))


def _batch(cfg, seed=1, b=2, s=16):
    """Tokens (embeddings for a vision model), labels with three masked,
    and whisper's frames, made with numpy."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision":
        inputs = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    labels[0, :2] = -1
    labels[1, -1] = -1
    batch = {"inputs": inputs, "labels": labels}
    if cfg.is_encoder_decoder:
        batch["enc_inputs"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_tree(tcfg, jax_tree):
    """A JAX parameter-shaped tree (params, grads, m or v) in the port's layout."""
    return params_from_jax(tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jax_tree))


def _leaf_errors(want, got):
    """Each leaf's largest |got - want| over the leaf's largest |want|; a
    None leaf of ``got`` counts as zeros."""
    out = []
    for w, g in zip(tree_leaves(want), tree_leaves(got)):
        g = torch.zeros_like(w) if g is None else g.float()
        out.append(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    return out


def _grads(tcfg, params, batch, **kw):
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, parts = model.loss_fn(tcfg, tree_unflatten(params, leaves), batch, **kw)
    return loss, parts, tree_unflatten(params, torch.autograd.grad(loss, leaves,
                                                                   allow_unused=True))


# ---------------------------------------------------------------------------
# Data, schedules, optimizer.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["tokens", "enc_seq", "embed_dim"])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_lm_batches_equal_the_reference(seed, kind):
    kw = {"enc_seq": {"enc_seq": 12, "d_model": 8}, "embed_dim": {"embed_dim": 8}}.get(kind, {})
    port, want = SyntheticLM(500, 24, 3, seed=seed, **kw), JaxSyntheticLM(500, 24, 3, seed=seed, **kw)
    for _ in range(3):
        a, b = next(port), next(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


SCHEDULES = [dict(peak_lr=3e-4, warmup_steps=10, total_steps=100),
             dict(peak_lr=1.0, warmup_steps=0, total_steps=37, decay_start_frac=0.8,
                  min_lr_frac=0.05)]


@pytest.mark.parametrize("which", range(len(SCHEDULES)))
@pytest.mark.parametrize("kind", ["wsd", "cosine", "linear", "constant"])
def test_schedule_matches_reference(kind, which):
    cfg = SCHEDULES[which]
    port = make_schedule(ScheduleConfig(kind=kind, **cfg))
    want = jsched.make_schedule(jsched.ScheduleConfig(kind=kind, **cfg))
    for step in range(cfg["total_steps"] + 6):
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        w = float(want(jnp.int32(step)))
        # abs: near the cosine's end 1 + cos(pi p) cancels, and one f32 ulp
        # between XLA's cos and torch's grows to ~2e-7 of the rate there
        assert float(got) == pytest.approx(w, rel=1e-7, abs=1e-7 * cfg["peak_lr"]), step
        assert float(port(step)) == float(got)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        make_schedule(ScheduleConfig(kind="step"))


def _opt_tree(rng):
    """A nested dict/list tree with an f32 matrix, a list of vectors, a
    bf16 leaf and a leaf whose gradient is zero (JAX) / absent (the port)."""
    return {"w": rng.standard_normal((16, 24)).astype(np.float32),
            "blocks": [rng.standard_normal((24,)).astype(np.float32) for _ in range(3)],
            "half": rng.standard_normal((8, 8)).astype(np.float32),
            "unused": rng.standard_normal((5,)).astype(np.float32)}


def _to_jax(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["half"] = out["half"].astype(jnp.bfloat16)
    return out


def _to_port(tree):
    out = jax.tree.map(torch.from_numpy, tree)
    out["half"] = out["half"].to(torch.bfloat16)
    return out


def _as_np(tree):
    return [np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()
            for x in tree_leaves(tree)]


def _within_a_bf16_step(got, want):
    """bf16 moments: equal but for a few elements one bf16 step apart.  The
    global norm sums its leaves in another order than the reference's, so
    under clipping the clip factor may differ in its last f32 bit, and a
    value that lies that close to a bf16 rounding boundary rounds the other
    way; without clipping the f32 arithmetic and so the bits are the same."""
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    off = np.abs(got - want)
    assert np.all(off <= step), float((off / step).max())
    assert np.mean(off > 0) <= 0.01, np.mean(off > 0)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("clipping", [False, True])
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(state, clipping, steps):
    rng = np.random.default_rng(11)
    params = _opt_tree(rng)
    jcfg = jopt.OptimizerConfig(lr=1e-2, state_dtype=getattr(jnp, state))
    tcfg = OptimizerConfig(lr=1e-2, state_dtype=getattr(torch, state))
    jp, tp = _to_jax(params), _to_port(params)
    jo, to = jopt.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    assert to["step"].dtype == torch.int32 and to["m"]["half"].dtype == tcfg.state_dtype
    for i in range(steps):
        scale = 30.0 if clipping else 0.01
        g = jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32),
                         params)
        g["unused"] = np.zeros_like(g["unused"])
        jg, tg = _to_jax(g), _to_port(g)
        tg["unused"] = None                        # not reached by the loss
        lr = jnp.float32(1e-2 * (i + 1) / steps)
        jp, jo, jm = jopt.adamw_update(jp, jg, jo, jcfg, lr=lr)
        tp, to, tm = adamw_update(tp, tg, to, tcfg, lr=torch.tensor(float(lr)))
        assert (float(jm["grad_norm"]) > 1.0) == clipping
    bf16 = state == "bfloat16"
    for w, g in zip(_as_np(jo["m"]) + _as_np(jo["v"]), _as_np(to["m"]) + _as_np(to["v"])):
        if bf16:
            _within_a_bf16_step(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    # a bf16 moment one step off moves a later update by 2^-8 of itself
    p_atol = 1e-6 + (1e-2 * 2.0 ** -8 * (steps - 1) if bf16 else 0.0)
    for w, g in zip(_as_np(jp), _as_np(tp)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=p_atol)
    assert int(to["step"]) == int(jo["step"]) == steps
    for k in ("grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
    assert tp["half"].dtype == torch.bfloat16 and to["v"]["w"].dtype == tcfg.state_dtype


def test_adamw_update_leaves_its_inputs_and_counts_absent_gradients_as_zero():
    rng = np.random.default_rng(3)
    params = _to_port(_opt_tree(rng))
    before = [t.clone() for t in tree_leaves(params)]
    grads = jax.tree.map(lambda t: torch.ones_like(t), params)
    zeros = dict(grads, unused=torch.zeros_like(params["unused"]))
    absent = dict(grads, unused=None)
    opt = adamw_init(params, OptimizerConfig())
    a = adamw_update(params, zeros, opt, OptimizerConfig())
    b = adamw_update(params, absent, opt, OptimizerConfig())
    for x, y in zip(tree_leaves(a[:2]), tree_leaves(b[:2])):
        assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(params)))
    # weight decay moves the leaf that got no gradient
    assert not torch.equal(b[0]["unused"], params["unused"])
    assert float(global_norm(absent)) == pytest.approx(float(global_norm(zeros)))


# ---------------------------------------------------------------------------
# loss_fn and the train step against the reference.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_reference(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    batch = _batch(jcfg)
    (jl, jparts), jg = jax.value_and_grad(
        lambda p: jmodel.loss_fn(jcfg, p, _jax_batch(batch)), has_aux=True)(jp)
    loss, parts, grads = _grads(tcfg, tp, batch_to(batch, "cpu"))
    assert loss.shape == () and loss.dtype == torch.float32
    for got, want in ((loss, jl), (parts["ce"], jparts["ce"]), (parts["aux"], jparts["aux"])):
        assert float(got.detach()) == pytest.approx(float(want), rel=TOL, abs=TOL)
    errs = _leaf_errors(_port_tree(tcfg, jg), grads)
    assert max(errs) < TOL, max(errs)


def test_loss_masks_negative_labels():
    _, tcfg, _, tp = _pair("qwen1.5-0.5b")
    batch = batch_to(_batch(tcfg), "cpu")
    logits, _ = model.forward(tcfg, tp, batch["inputs"])
    logp = torch.log_softmax(logits.float(), -1)
    keep = batch["labels"] >= 0
    want = -logp[keep].gather(-1, batch["labels"][keep][:, None]).mean()
    loss, parts = model.loss_fn(tcfg, tp, batch)
    assert float(parts["ce"]) == pytest.approx(float(want), rel=1e-6)
    none = dict(batch, labels=torch.full_like(batch["labels"], -1))
    assert float(model.loss_fn(tcfg, tp, none)[1]["ce"]) == 0.0


def _max_abs(tree) -> float:
    return max(float(t.abs().max()) for t in tree_leaves(tree))


@pytest.mark.parametrize("arch", TRAIN_STEP_ARCHS)
def test_train_step_matches_reference_over_three_steps(arch):
    jcfg, tcfg, jp, tp = _pair(arch)
    sched = dict(kind="wsd", peak_lr=1e-3, warmup_steps=1, total_steps=3)
    jt = jloop.TrainConfig(optimizer=jopt.OptimizerConfig(lr=1e-3),
                           schedule=jsched.ScheduleConfig(**sched))
    tt = TrainConfig(optimizer=OptimizerConfig(lr=1e-3), schedule=ScheduleConfig(**sched))
    jstep, tstep = jax.jit(jloop.make_train_step(jcfg, jt)), make_train_step(tcfg, tt)
    jo, to = jopt.adamw_init(jp, jt.optimizer), adamw_init(tp, tt.optimizer)
    for i in range(3):
        batch = _batch(jcfg, seed=10 + i)
        jp, jo, jm = jstep(jp, jo, _jax_batch(batch))
        tp, to, tm = tstep(tp, to, batch_to(batch, "cpu"))
        assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm", "loss", "lr"]
        for k in jm:
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=TOL, abs=TOL), (i, k)
        for name in ("m", "v"):
            errs = _leaf_errors(_port_tree(tcfg, jo[name]), to[name])
            assert max(errs) < TOL, (i, name, max(errs))
        want = _port_tree(tcfg, jp)
        scale = _max_abs(want)
        for w, g in zip(tree_leaves(want), tree_leaves(tp)):
            assert float((g - w).abs().max()) < TOL * scale, i
        assert int(to["step"]) == i + 1


@pytest.mark.parametrize("remat", [True, "dots"])
@pytest.mark.parametrize("arch", TRAIN_STEP_ARCHS)
def test_remat_gives_the_gradients_of_no_remat(arch, remat):
    """Checkpointing each layer (everything, or everything but the mm
    outputs) recomputes the same operations: the same loss and gradients."""
    _, tcfg, _, tp = _pair(arch)
    batch = batch_to(_batch(tcfg), "cpu")
    base = _grads(tcfg, tp, batch, remat=False)
    got = _grads(tcfg, tp, batch, remat=remat)
    assert float(got[0]) == float(base[0])
    errs = _leaf_errors(base[2], got[2])
    assert max(errs) <= 1e-6, max(errs)


def test_maybe_checkpoint_wraps_only_when_remat_is_set():
    assert model._maybe_checkpoint(len, False) is len
    assert model._maybe_checkpoint(len, 0) is len
    for remat in (True, "full", "dots"):
        assert model._maybe_checkpoint(len, remat) is not len


# ---------------------------------------------------------------------------
# Twins of the reference's tests/test_training.py and the train step of
# tests/test_arch_smoke.py.
# ---------------------------------------------------------------------------
def test_loss_decreases_quickly():
    cfg = get_config("qwen1.5-0.5b").reduced()
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3),
                       schedule=ScheduleConfig(kind="constant", peak_lr=1e-3,
                                               warmup_steps=2, total_steps=25))
    data = SyntheticLM(cfg.vocab_size, 32, 4, seed=0)
    _, _, hist = train(cfg, tcfg, iter(data), 25, log_every=5, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.5, hist


def test_moe_training_with_aux_loss():
    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    tcfg = TrainConfig(optimizer=OptimizerConfig(lr=1e-3),
                       schedule=ScheduleConfig(kind="constant", peak_lr=1e-3,
                                               warmup_steps=2, total_steps=10))
    data = SyntheticLM(cfg.vocab_size, 16, 2, seed=1)
    _, _, hist = train(cfg, tcfg, iter(data), 10, log_every=3, device="cpu")
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["ce"] < hist[0]["ce"]
    assert all(h["aux"] > 0 for h in hist)


def test_wsd_schedule_shape():
    s = make_schedule(ScheduleConfig(kind="wsd", peak_lr=1.0, warmup_steps=10,
                                     total_steps=100, decay_start_frac=0.8,
                                     min_lr_frac=0.1))
    assert float(s(0)) == 0.0
    assert float(s(10)) == pytest.approx(1.0)
    assert float(s(50)) == pytest.approx(1.0)          # stable phase
    assert float(s(79)) == pytest.approx(1.0)
    assert float(s(100)) == pytest.approx(0.1, rel=1e-2)  # decayed
    mid = float(s(90))
    assert 0.1 < mid < 1.0


def test_cosine_linear_schedules():
    for kind in ("cosine", "linear"):
        s = make_schedule(ScheduleConfig(kind=kind, peak_lr=2.0, warmup_steps=5,
                                         total_steps=50, min_lr_frac=0.1))
        assert float(s(5)) == pytest.approx(2.0)
        assert float(s(50)) == pytest.approx(0.2, rel=1e-2)


def test_adamw_bf16_states():
    params = {"w": torch.ones((4, 4))}
    ocfg = OptimizerConfig(state_dtype=torch.bfloat16)
    opt = adamw_init(params, ocfg)
    assert opt["m"]["w"].dtype == torch.bfloat16
    grads = {"w": torch.full((4, 4), 0.1)}
    new_p, new_opt, _ = adamw_update(params, grads, opt, ocfg)
    assert new_opt["v"]["w"].dtype == torch.bfloat16
    assert bool(torch.all(new_p["w"] < params["w"]))


def test_grad_clip():
    params = {"w": torch.ones((2,))}
    ocfg = OptimizerConfig(grad_clip=1.0, lr=1.0, weight_decay=0.0)
    opt = adamw_init(params, ocfg)
    big = {"w": torch.full((2,), 1e6)}
    _, _, m = adamw_update(params, big, opt, ocfg)
    assert float(m["grad_norm"]) > 1e5  # reported pre-clip


def test_synthetic_data_learnable_structure():
    data = SyntheticLM(1000, 64, 4, seed=0)
    batch = next(iter(data))
    assert batch["inputs"].shape == (4, 64)
    assert batch["labels"].shape == (4, 64)
    # bigram structure: successor (t*7+3)%support appears often
    x, y = batch["inputs"].ravel(), batch["labels"].ravel()
    hits = np.mean(y == (x * 7 + 3) % 1000)
    assert hits > 0.4


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "nested": {"b": torch.ones((4,), dtype=torch.bfloat16),
                   "step": torch.tensor(7, dtype=torch.int32)},
    }
    path = save_checkpoint(str(tmp_path), 3, tree)
    assert (tmp_path / path.split("/")[-1]).exists()
    assert latest_step(str(tmp_path)) == 3
    restored = restore_checkpoint(str(tmp_path), 3, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_no_nan(arch):
    cfg = get_config(arch).reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    batch = batch_to(_batch(cfg, seed=1), "cpu")
    ocfg = OptimizerConfig(lr=1e-3)
    opt = adamw_init(params, ocfg)
    loss, _, grads = _grads(cfg, params, batch)
    assert bool(torch.isfinite(loss)), arch
    new_params, opt, metrics = adamw_update(params, grads, opt, ocfg)
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    # params actually moved
    assert any(not torch.equal(a, b)
               for a, b in zip(tree_leaves(params), tree_leaves(new_params)))


def test_train_cli_runs_in_process(capsys):
    train_cli.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "3", "--batch", "2",
                    "--seq", "16", "--log-every", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    name = get_config("qwen1.5-0.5b").reduced().name
    assert lines[0].startswith(f"[train] {name}: params=")
    assert len(lines) == 5 and all(ln.startswith("[train] step=") for ln in lines[1:4])
    out = json.loads(lines[-1])
    assert out["arch"] == name and out["steps"] == 3
    assert set(out) == {"arch", "steps", "loss_first", "loss_last", "improved"}
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])


def test_train_defaults_to_the_card(monkeypatch):
    seen = {}

    def fake_train(cfg, tcfg, data, steps, **kw):
        seen.update(kw)
        return None, None, [{"loss": 1.0}]

    monkeypatch.setattr(train_cli, "train", fake_train)
    train_cli.main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "1"])
    assert seen["device"] == "cuda"
    import inspect
    assert inspect.signature(train).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# The autograd Functions of kernels/ops.py, on the CPU with the kernels'
# wrappers replaced by their plain versions (what each kernel computes:
# the flash kernel gives 0 for a row that sees no key).
# ---------------------------------------------------------------------------
@pytest.fixture
def plain_kernels(monkeypatch):
    calls = {"flash": 0, "rwkv": 0}

    def flash(q, k, v, *, causal, window, q_offset):
        assert not torch.is_grad_enabled()      # what lets the wrapper's guard pass
        _build.refuse_grad("flash_attention", q, k, v)
        calls["flash"] += 1
        out = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
        seen = ops.rows_seeing_a_key(q.shape[1], k.shape[1], causal, window, q_offset, q.device)
        return out * seen[None, :, None, None]

    def scan(r, k, v, w, u, state=None):
        assert not torch.is_grad_enabled()
        _build.refuse_grad("rwkv6_scan", r, k, v, w, u, state)
        calls["rwkv"] += 1
        return ref.rwkv6_reference(r, k, v, w, u, state)

    monkeypatch.setattr(ops._fa, "flash_attention", flash)
    monkeypatch.setattr(ops._rwkv, "rwkv6_scan", scan)
    return calls


FLASH_GRAD_CASES = [
    # b, sq, sk, nq, nkv, hd, causal, window, q_offset
    (2, 24, 24, 4, 4, 16, True, 0, 0),       # causal
    (1, 40, 40, 4, 2, 32, True, 8, 0),       # windowed, GQA
    (2, 12, 30, 6, 3, 16, False, 0, 0),      # non-causal (cross-attention)
    (1, 20, 16, 4, 1, 16, True, 4, 10),      # rows past Sk + window see no key
]


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_function_gives_the_plain_gradients(plain_kernels, case):
    b, sq, sk, nq, nkv, hd, causal, window, q_offset = case
    rng = np.random.default_rng(4)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd), (b, sq, nq, hd)))
    opts = dict(causal=causal, window=window, q_offset=q_offset)
    seen = ops.rows_seeing_a_key(sq, sk, causal, window, q_offset, "cpu")
    assert bool(seen.all()) == (case != FLASH_GRAD_CASES[-1])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops._FlashAttention.apply(*leaves, causal, window, q_offset)
    got = torch.autograd.grad(out, leaves, g)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want_out = ref.mha_reference(*plain, **opts) * seen[None, :, None, None]
    want = torch.autograd.grad(want_out, plain, g)
    assert plain_kernels["flash"] == 1 and torch.equal(out, want_out.detach())
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_function_gives_the_plain_gradients(plain_kernels, with_state):
    rng = np.random.default_rng(5)
    sh = (2, 11, 2, 8)
    r, k, v = (torch.from_numpy(0.5 * rng.standard_normal(sh).astype(np.float32))
               for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 0.95, sh).astype(np.float32))
    u = torch.from_numpy(0.3 * rng.standard_normal((2, 8)).astype(np.float32))
    s0 = torch.from_numpy(0.2 * rng.standard_normal((2, 2, 8, 8)).astype(np.float32))
    g_out = torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    g_s = torch.from_numpy(rng.standard_normal((2, 2, 8, 8)).astype(np.float32))
    inputs = [r, k, v, w, u] + ([s0] if with_state else [])
    leaves = [x.clone().requires_grad_() for x in inputs]
    out, s = ops._Rwkv6.apply(*leaves, *([] if with_state else [None]))
    got = torch.autograd.grad((out, s), leaves, (g_out, g_s))
    plain = [x.clone().requires_grad_() for x in inputs]
    want = torch.autograd.grad(ref.rwkv6_reference(*plain), plain, (g_out, g_s))
    assert plain_kernels["rwkv"] == 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_function_computes_only_the_gradients_asked_for(plain_kernels):
    q, k, v = (torch.randn(1, 8, 2, 16, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    k.requires_grad_()
    out = ops._FlashAttention.apply(q, k, v, True, 0, 0)
    (gk,) = torch.autograd.grad(out.sum(), [k])
    assert gk.shape == k.shape and q.grad is None and v.grad is None


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _build.refuse_grad("decode_attention", torch.ones(2), x, None)
    with torch.no_grad():
        _build.refuse_grad("decode_attention", x)
    _build.refuse_grad("decode_attention", torch.ones(2), None)


@pytest.mark.parametrize("causal", [True, False])
def test_rows_seeing_a_key_is_the_mask_of_the_plain_version(causal):
    for sq, sk, window, q_offset in [(8, 8, 0, 0), (8, 8, 3, 0), (20, 16, 4, 10), (5, 9, 2, 4),
                                     (1, 64, 8, 70), (7, 3, 1, 0), (4, 4, 100, 300)]:
        qpos = q_offset + torch.arange(sq)[:, None]
        kpos = torch.arange(sk)[None, :]
        mask = torch.ones(sq, sk, dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        got = ops.rows_seeing_a_key(sq, sk, causal, window, q_offset, "cpu")
        assert torch.equal(got, mask.any(dim=1)), (sq, sk, window, q_offset)
