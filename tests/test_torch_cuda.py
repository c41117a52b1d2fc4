"""The port on the card: CUDA kernels against their plain versions, and the
engine on the card against the engine on the CPU.

These tests need an NVIDIA GPU and nvcc, carry the ``cuda`` marker and skip
without a card.  The file imports no JAX, so it also runs where only
PyTorch is installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are those of ``tests/test_kernels.py``: 2e-5 in f32 (the same
f32 arithmetic summed in another order) and 2e-2 in bf16.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import model
from repro_torch.serving import ContinuousBatcher, Engine, EngineConfig, Request

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FA_CASES = [
    # b, sq, sk, nq, nkv, hd, causal, window, q_offset
    (2, 64, 64, 4, 2, 32, True, 0, 0),
    (1, 128, 128, 8, 8, 64, True, 16, 0),
    (2, 48, 48, 4, 1, 32, True, 0, 0),        # ragged + MQA
    (1, 64, 64, 2, 2, 16, False, 0, 0),        # encoder (non-causal)
    (1, 96, 96, 6, 3, 64, True, 32, 0),        # window + GQA
    (1, 32, 64, 4, 4, 32, True, 0, 32),        # chunked prefill: q at an offset
    (1, 200, 200, 4, 2, 128, True, 0, 0),      # hd 128, ragged tiles
]
DA_CASES = [
    # b, s, nq, nkv, hd
    (2, 64, 4, 2, 32),
    (1, 100, 8, 1, 64),
    (3, 48, 2, 2, 16),
    (1, 256, 16, 4, 64),
    (2, 300, 32, 8, 128),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(seed, *shapes, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in shapes]


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("case", FA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, sk, nq, nkv, hd, causal, window, q_offset = case
    q, k, v = _randn(sum(case), (b, sq, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd),
                     dtype=DTYPES[dtype], device=cuda)
    launches = fa.launches
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    assert fa.launches == launches + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    assert _err(out, exp) < TOL[dtype]


@pytest.mark.parametrize("case", DA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_decode_kernel_matches_plain(cuda, case, dtype):
    b, s, nq, nkv, hd = case
    q, k, v = _randn(sum(case), (b, nq, hd), (b, s, nkv, hd), (b, s, nkv, hd),
                     dtype=DTYPES[dtype], device=cuda)
    valid = torch.from_numpy(np.random.default_rng(sum(case)).uniform(size=(b, s)) < 0.7)
    valid[:, 0] = True
    valid = valid.to(cuda)
    launches = da.launches
    out = da.decode_attention(q, k, v, valid)
    assert da.launches == launches + 1
    assert _err(out, ref.decode_attention_reference(q, k, v, valid)) < TOL[dtype]


def test_decode_kernel_empty_and_single_slot(cuda):
    q, k, v = _randn(0, (2, 4, 64), (2, 80, 2, 64), (2, 80, 2, 64),
                     dtype=torch.float32, device=cuda)
    valid = torch.zeros((2, 80), dtype=torch.bool, device=cuda)
    valid[1, 37] = True
    out = da.decode_attention(q, k, v, valid)
    assert not out[0].any()                     # no valid slot: 0, as the Pallas kernel
    assert _err(out[1], v[1, 37].repeat_interleave(2, dim=0)) < 1e-6


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q, k, v = _randn(0, (1, 8, 2, 48), (1, 8, 2, 48), (1, 8, 2, 48),
                     dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, k, v)
    q, k, v = _randn(0, (1, 8, 2, 64), (1, 8, 2, 64), (1, 8, 2, 64),
                     dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k, v)
    q, k, v = _randn(0, (1, 8, 2, 64), (1, 2, 8, 64), (1, 8, 2, 64),
                     dtype=torch.float32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k.transpose(1, 2), v)


def test_engine_on_the_card_matches_cpu(cuda):
    """In f32 the engine's greedy tokens on the card (CUDA kernels) equal
    those on the CPU (plain versions) for the same weights."""
    cfg = get_config("qwen1.5-0.5b").reduced()
    params = model.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = {"embed": params["embed"].to(cuda),
               "final_norm": {k: t.to(cuda) for k, t in params["final_norm"].items()},
               "layers": [{name: {k: t.to(cuda) for k, t in sub.items()}
                           for name, sub in layer.items()} for layer in params["layers"]]}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 9, 17)]
    outs = []
    for device, p in (("cpu", params), ("cuda", on_card)):
        eng = Engine(cfg, p, EngineConfig(slots=2, cache_len=64, max_new_tokens=4, device=device))
        bat = ContinuousBatcher(eng)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=4) for i, pr in enumerate(prompts)]
        for r in reqs:
            bat.submit(r)
        bat.run_until_idle()
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
