"""Training driver.

Trains any registered architecture on the synthetic LM pipeline, on the
card by default (every attention and WKV call through the hand-written
kernels, their gradients the plain versions' VJPs).  ``--reduced`` selects
the smoke variant of the same family, which also runs with
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b --reduced \
      --steps 200 --batch 8 --seq 128 --device cpu
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import get_config
from repro_torch.training.data import SyntheticLM
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.schedule import ScheduleConfig
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="wsd",
                    choices=("wsd", "cosine", "linear", "constant"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    print(f"[train] {cfg.name}: params={cfg.params_total / 1e6:.1f}M "
          f"schedule={args.schedule}", flush=True)

    tcfg = TrainConfig(
        optimizer=OptimizerConfig(lr=args.lr),
        schedule=ScheduleConfig(
            kind=args.schedule, peak_lr=args.lr,
            warmup_steps=max(10, args.steps // 10), total_steps=args.steps,
        ),
    )
    data = SyntheticLM(
        cfg.vocab_size, args.seq, args.batch, seed=args.seed,
        enc_seq=cfg.encoder_seq if cfg.is_encoder_decoder else None,
        d_model=cfg.d_model if cfg.is_encoder_decoder else None,
    )

    def log(step, m):
        print(f"[train] step={step:4d} loss={m['loss']:.4f} "
              f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.3f} "
              f"wall={m['wall_s']:.1f}s", flush=True)

    params, opt_state, history = train(
        cfg, tcfg, iter(data), args.steps,
        seed=args.seed, log_every=args.log_every, callback=log, device=args.device,
    )
    first, last = history[0]["loss"], history[-1]["loss"]
    print(json.dumps({
        "arch": cfg.name, "steps": args.steps,
        "loss_first": round(first, 4), "loss_last": round(last, 4),
        "improved": bool(last < first),
    }))


if __name__ == "__main__":
    main()
