"""Port's dry-run (``launch/dryrun.py``): each step's product FLOPs,
counted by ``FlopCounterMode`` on meta tensors, against the analytic count
from the config and shapes, and its bytes against the parameter count.

``dryrun.analytic_flops`` counts what the plain path multiplies (every
weight product a token passes through, the MoE experts over their
capacity's rows, attention's Sq x Sk grid or its blocked local form, the
chunk-parallel WKV's four products a chunk, the unembedded tokens; x 3 and
remat's recompute in a train step).  Both sides count only products, 2 per
multiply-add, as integers, so they are held equal (``ANALYTIC_RTOL``, 1e-9,
covers only float rounding of the sums).  Every arch x input shape runs at
full width and full shapes with its depth cut to one repetition of its
block pattern and its tail (and one encoder layer), which the analytic
count takes as it takes any depth; qwen1.5-0.5b runs at full depth at all
four shapes and kimi-k2 at full depth at decode_32k.  At ``reduced()`` the
count is also held to the dot FLOPs of the JAX package's lowered step.
"""
import dataclasses
import json
import math
import re

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config as jax_config
from repro.configs.registry import InputShape as JaxInputShape
from repro.distributed.sharding import axis_rules as jax_axis_rules
from repro.launch.specs import build_step as jax_build_step

from repro_torch.configs import INPUT_SHAPES, get_config, list_architectures
from repro_torch.configs.registry import ATTN, LOCAL_ATTN, RGLRU, RWKV, InputShape
from repro_torch.launch import dryrun, specs
from repro_torch.models.griffin import CONV_K

ARCHS = list_architectures()
# a stablehlo.dot_general's contracting dims, lhs type and result type
_DOT = re.compile(r"stablehlo\.dot_general\s+%\S+,\s*%\S+,.*?contracting_dims = \[([\d, ]*)\] x "
                  r"\[[\d, ]*\].*?:\s*\(tensor<([^>]*)>,\s*tensor<[^>]*>\)\s*->\s*tensor<([^>]*)>")


def _cut(cfg):
    """One repetition of the block pattern and the tail, one encoder layer."""
    kw = {"num_layers": len(cfg.block_pattern) + len(cfg.tail_blocks)}
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 1
    return dataclasses.replace(cfg, **kw)


def _f32_elements(cfg):
    """Parameters the models keep in f32 whatever their dtype: the MoE
    router, RWKV's mu, w0, u and cm_mu, the RG-LRU's Lambda."""
    n = 0
    for kind in cfg.layer_kinds():
        if kind in (ATTN, LOCAL_ATTN) and cfg.num_experts:
            n += cfg.d_model * cfg.num_experts
        elif kind == RWKV:
            n += 8 * cfg.d_model               # mu (5, d), w0 (d), u (h, hd), cm_mu (d)
        elif kind == RGLRU:
            n += cfg.rglru_width or cfg.d_model
    return n


def _cache_bytes(cfg, shape, es=2):
    """The cache's bytes from the config: K and V (bf16) and slot positions
    (int32) of each attention layer's slots, RWKV's shifts (bf16) and WKV
    state (f32), the RG-LRU's conv context (bf16) and state (f32), whisper's
    cross-attention K/V, and the positions ``t`` (int32)."""
    b, s = shape.global_batch, shape.seq_len
    window = specs.decode_window(cfg, shape)
    d, hd, nkv = cfg.d_model, cfg.resolved_head_dim, cfg.num_kv_heads
    n = 4 * b
    for kind in cfg.layer_kinds():
        if kind in (ATTN, LOCAL_ATTN):
            w = cfg.local_window if kind == LOCAL_ATTN else window
            slots = min(w, s) if w else s
            n += 2 * b * slots * nkv * hd * es + 4 * b * slots
        elif kind == RWKV:
            h = d // cfg.rwkv_head_dim
            n += 2 * b * d * es + 4 * b * h * cfg.rwkv_head_dim ** 2
        elif kind == RGLRU:
            w = cfg.rglru_width or d
            n += b * (CONV_K - 1) * w * es + 4 * b * w
    if cfg.is_encoder_decoder:
        n += 2 * cfg.num_layers * b * cfg.encoder_seq * nkv * hd * es
    return n


def _check_bytes(cfg, shape, rec):
    params = 2 * cfg.params_total + 2 * _f32_elements(cfg)       # bf16, f32 leaves 4 bytes
    assert rec["bytes"]["params"] == params
    if shape.kind == "train":
        state = 2 if cfg.params_total > 200_000_000_000 else 4
        assert rec["bytes"]["opt_state"] == 2 * state * cfg.params_total + 4
    else:
        assert rec["bytes"]["cache"] == _cache_bytes(cfg, shape)


@pytest.mark.parametrize("shape_name", sorted(INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_the_analytic_count_and_bytes_the_parameters(arch, shape_name):
    cfg, shape = _cut(get_config(arch)), INPUT_SHAPES[shape_name]
    rec = dryrun.record(cfg, shape)        # raises if flops leave the analytic count
    assert rec["flops"] > 0 and abs(rec["flops_vs_analytic"] - 1) <= dryrun.ANALYTIC_RTOL
    assert rec["flops"] == sum(rec["flops_by_op"].values())
    _check_bytes(cfg, shape, rec)


@pytest.mark.parametrize("arch,shape_name", [("qwen1.5-0.5b", s) for s in sorted(INPUT_SHAPES)]
                         + [("kimi-k2-1t-a32b", "decode_32k")])
def test_full_depth(arch, shape_name):
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    rec = dryrun.record(cfg, shape)
    _check_bytes(cfg, shape, rec)
    assert rec["params_total"] == cfg.params_total and rec["params_active"] == cfg.params_active
    assert rec["mesh_rules"]["mesh"] == {"data": 16, "model": 16}


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3-8b", "qwen2-72b", "minicpm-2b",
                                  "llava-next-mistral-7b"])
def test_ideal_at_decode_is_the_counted_work_plus_the_parameters_without_a_product(arch):
    """A dense decode step multiplies every cache slot, none masked, so the
    ideal count (2 x active parameters x tokens + 4 hd nq a pair) exceeds
    the counted one only by the parameters no product reads: norms, biases
    and an untied embedding table (a gather)."""
    cfg, shape = _cut(get_config(arch)), INPUT_SHAPES["decode_32k"]
    rec = dryrun.record(cfg, shape)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    norms = d * (2 if cfg.norm == "layernorm" else 1) * (2 * cfg.num_layers + 1)
    biases = cfg.num_layers * hd * (cfg.num_heads + 2 * cfg.num_kv_heads) if cfg.qkv_bias else 0
    embed = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    assert rec["flops_ideal"] - rec["flops"] == 2 * shape.global_batch * (norms + biases + embed)


@pytest.mark.parametrize("seq", [1, 32, 33])
def test_rwkv_train_step_of_one_chunk_and_more(seq):
    """A train step whose sequences fit one 32-token WKV chunk differentiates
    fewer products (the zero carry-in, the unread final state) than one of
    two chunks: the analytic count follows both."""
    rec = dryrun.record(_cut(get_config("rwkv6-1.6b")), InputShape(f"train_{seq}", seq, 2, "train"))
    assert rec["flops"] == rec["flops_analytic"]


def _dot_flops(stablehlo: str) -> int:
    """2 x result elements x contracted size of every ``dot_general`` of a
    lowered (not compiled) step: its products alone, as FlopCounterMode
    counts them."""
    dims = lambda t: [int(x) for x in t.split("x")[:-1]]
    n = 0
    for m in _DOT.finditer(stablehlo):
        lhs, out = dims(m.group(2)), dims(m.group(3))
        n += 2 * math.prod(out) * math.prod(lhs[int(i)] for i in m.group(1).split(","))
    return n


def _reference_dot_flops(arch, shape, monkeypatch):
    """The reference's step at ``reduced()`` lowered on a one-device mesh
    (axes Auto, as its sharding constraints need), its layer scans unrolled
    (``REPRO_UNROLL_SCANS``, as its dry-run's probes do), then its dot
    FLOPs."""
    monkeypatch.setenv("REPRO_UNROLL_SCANS", "1")
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    step, args, shardings, rules, _ = jax_build_step(
        jax_config(arch).reduced(), JaxInputShape(shape.name, shape.seq_len, shape.global_batch,
                                                  shape.kind), mesh, param_dtype=jnp.float32)
    with mesh, jax_axis_rules(rules):
        return _dot_flops(jax.jit(step, in_shardings=shardings).lower(*args).as_text())


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "rwkv6-1.6b"])
def test_flops_equal_the_reference_lowered_dot_flops_at_reduced(arch, kind, monkeypatch):
    """At ``reduced()`` (B = 4, 2, 4; 64 tokens or cache slots) the port's
    counted products equal the dot FLOPs of the reference's lowered step,
    but for two differences of construction, counted exactly: whisper's
    prefill projects each decoder layer's cross-attention K/V once (the
    cache's, which its layers read), where the reference projects them for
    the cache (``repro/models/model.py:627``) and again in each layer
    (``:493-495``); and a train step's remat, which the reference applies to
    each repetition of the block pattern and the port to each layer, so
    that recomputing skips the last MLP product of the repetition there and
    of every layer here.  rwkv6-1.6b is not compared: the reference's WKV is
    a per-token ``lax.scan`` (its body lowered once), the port's on meta
    tensors the chunk-parallel form."""
    b = {"train": 4, "prefill": 2, "decode": 4}[kind]
    shape = InputShape(f"{kind}_reduced", 64, b, kind)
    cfg = get_config(arch).reduced()
    ours = dryrun.record(cfg, shape)["flops"]
    theirs = _reference_dot_flops(arch, shape, monkeypatch)
    d, ff = cfg.d_model, cfg.d_ff
    delta = 0
    if cfg.is_encoder_decoder and kind == "prefill":
        delta = 2 * cfg.num_layers * 2 * b * cfg.encoder_seq * d * cfg.num_kv_heads * cfg.resolved_head_dim
    if kind == "train":
        n_rep = (cfg.num_layers - len(cfg.tail_blocks)) // len(cfg.block_pattern)
        delta = n_rep * (len(cfg.block_pattern) - 1) * 2 * b * 64 * d * ff
    assert ours == theirs - delta


def test_cli_writes_one_record(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "whisper-small", "--shape",
                                     "decode_32k", "--out", str(tmp_path)])
    with pytest.raises(SystemExit) as done:
        dryrun.main()
    assert done.value.code == 0
    rec = json.loads((tmp_path / "whisper-small__decode_32k.json").read_text())
    assert rec["ok"] and rec["flops"] == rec["flops_analytic"] and rec["device"] == "meta"
    assert rec["collectives"]["count"] > 0 and rec["per_device"]["total"] > 0
    assert "[dryrun] OK" in capsys.readouterr().out


def test_a_failed_step_is_recorded_not_raised(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no step")
    monkeypatch.setattr(dryrun, "build_step", broken)
    rec = dryrun.run_one("qwen1.5-0.5b", "train_4k", out_dir=str(tmp_path))
    assert not rec["ok"] and "no step" in rec["error"]
    assert json.loads((tmp_path / "qwen1.5-0.5b__train_4k.json").read_text())["ok"] is False


def test_meta_steps_launch_no_kernel():
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rk
    before = (fa.launches, da.launches, rk.launches)
    dryrun.record(_cut(get_config("rwkv6-1.6b")), INPUT_SHAPES["decode_32k"])
    dryrun.record(_cut(get_config("qwen1.5-0.5b")), INPUT_SHAPES["prefill_32k"])
    assert (fa.launches, da.launches, rk.launches) == before
