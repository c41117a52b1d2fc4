"""Serving entry point.

Runs the continuous-batching engine for a registered architecture the
port builds (attention-only decoders, dense or MoE, RWKV-6 and the Griffin
hybrid; whisper serves at the model's entry points, see ``chip_smoke.py``
phase 3e), on the card by default.  ``--reduced`` selects the smoke variant of the same
family, which also runs with ``--device cpu``.  The full MoE models do not
fit one 80 GB card (phi3.5-moe-42b-a6.6b is 83.7 GB of bf16 weights): they
fail with the card's out-of-memory error.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --reduced \
      --device cpu --requests 16 --slots 4 --max-new 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe-42b-a6.6b --reduced \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b --reduced \
      --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.serving import ContinuousBatcher, Engine, EngineConfig, Request

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=False)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend == "vision":
        raise SystemExit("vision archs serve via embeddings, not token prompts")
    if cfg.is_encoder_decoder:
        # the engine's requests carry no audio, in the JAX package as here
        raise SystemExit("encoder-decoder archs serve at the model's entry points "
                         "(init_cache, prefill(enc_inputs=), decode_step), not through the engine")

    device = torch.device(args.device)
    dtype = DTYPES[args.dtype]
    print(f"[serve] {cfg.name}: L={cfg.num_layers} d={cfg.d_model} "
          f"params={cfg.params_total/1e6:.1f}M device={device} dtype={args.dtype}", flush=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model_lib.init_params(cfg, gen, dtype=dtype, device=device)
    engine = Engine(cfg, params, EngineConfig(
        slots=args.slots, cache_len=args.cache_len, max_new_tokens=args.max_new,
        dtype=dtype, device=str(device),
    ))
    batcher = ContinuousBatcher(engine)

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(max(2, args.prompt_len // 2), args.prompt_len + 1))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        batcher.submit(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.perf_counter()
    stats = batcher.run_until_idle()
    wall = time.perf_counter() - t0
    s = stats.summary()
    toks = s["finished"] * args.max_new
    print(f"[serve] {s}")
    print(f"[serve] {toks} tokens in {wall:.2f}s = {toks / wall:.1f} tok/s "
          f"({s['decode_steps']} decode steps)")


if __name__ == "__main__":
    main()
