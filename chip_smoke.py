#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py [--seed N]

Phases, each raising on a failed check (the script then exits non-zero and
never prints its last line):

0. the port's static analysis, on the host: ``repro_torch.analysis`` over
   ``src/repro_torch`` of this checkout against ``analysis_baseline_torch.txt``
   (its five passes; a finding fails the run), printed on an ``analysis:``
   line;
1. build the three hand-written CUDA kernel libraries from
   ``src/repro_torch/kernels/csrc``, one ``nvcc`` each, in parallel; print
   each kernel instantiation's registers and spill bytes (``ptxas -v``),
   the attention libraries' hd-256 ones among them, and count the
   tensor-core instructions in each library's SASS (``cuobjdump -sass``):
   ``HMMA`` (mma.sync), ``HGMMA`` (wgmma), ``LDSM`` (ldmatrix) and the
   TMA loads (``UTMALDG``); the bf16 flash kernel and the RWKV-6 scan must
   have tensor-core instructions, the flash library wgmma and TMA loads, the flash kernel's
   wgmma instantiations (``fa_wgmma_kernel``, bf16 at every hd, 256
   included, and ``fa_tf32_kernel``, f32 at every hd, 256 over a cluster of
   two CTAs, whose wgmma take tf32 operands: ``HGMMA`` with ``TF32`` in the
   SASS, the hd-256 instantiation's own included) no spill, and ptxas must neither
   ignore their ``setmaxnreg`` nor serialise their wgmma; the f32 kernel's
   one-tile probe must show the tensor cores reading an f32 operand as its
   top 19 bits, from shared memory and from registers (the design takes
   Q and K as they land for their tf32 parts); the decode library wgmma and TMA loads, its bf16 instantiations
   (``da_cluster_kernel``) no spill and no serialised wgmma, and the card
   must hold a cluster of each size the plan gives the served shapes
   (``cudaOccupancyMaxActiveClusters``, printed); the scan's T > 1 kernel
   (``scan_kernel``, over a cluster per sequence) wgmma, tf32 wgmma in
   its f32 instantiations, and TMA loads in its SASS, no ``HMMA`` or
   ``LDSM``, its 16 instantiations no spill and no serialised wgmma; the
   card's clusters at once for 1 to 16 ranks are printed, and each plan of
   the served and training shapes with its ranks and waves: the served
   bf16 prefill must take one wave;
2. hold each kernel against its plain PyTorch version on the card, in f32
   and bf16: the attention kernels at the shapes of ``tests/test_kernels.py``,
   at the main path's shapes, at phi3.5-moe's and llama3-8b's GQA shapes
   (32 q heads over 8 kv heads, hd 128), at recurrentgemma-9b's (16 q
   heads over 1 kv head, hd 256: flash at S = 512, at S = 2048 (bf16, also
   timed) and at S = 2112 under its 2048-token window, decode over the 8-slot, 2048-slot ring with the main
   path's prefix masks and with a wrapped ring whose window excludes the
   oldest slots) and at whisper-small's (12 heads of 64, non-causal flash
   at B = 8 over 1500 keys with Sq = 1500, 4 and 1, decode over a 448-slot
   cache); the RWKV-6 scan at ``RWKV_CASES``
   (with and without a state, ragged T), under strong
   decay (also in bf16 at T = 100 and in f32 at rwkv6-1.6b's T = 500, H = 32,
   the plan of the kernel training runs, timed there), at T = 1 with a
   state, at T = 2048, with
   the state updated in place at T = 45 and T = 1, and at rwkv6-1.6b's
   prefill and decode shapes; the attention kernels' edge cases (rows that
   see no key, S = 1000 in bf16, a window with a q_offset, decode masks that
   leave whole tiles and whole cluster ranks empty in the middle of the
   cache;
   flash at the edges of its 128-row blocks and 64-key tiles, Sq and Sk
   in {1, 127, 128, 129} causal and not, windows with a q_offset across a
   tile edge, GQA at 64:8 and 16:1, and hd 256 at 16:1 across its 64-row
   blocks and 64-key tiles, Sq and Sk in {127, 129} causal and not; in
   f32 hd 256 across the 64-row blocks and 32-key tiles of each CTA of its
   cluster, Sq in {63, 65} and Sk in {31, 33, 63, 65}, and under a window
   with a q_offset),
   and the bf16 flash kernel within one bf16 step of the f32 attention of
   its inputs, as the TPU kernel rounds, at outputs of |o| up to ~27 and at
   whisper-small's three flash shapes, the f32 flash kernel within 1.5
   times the plain version's distance from a float64 attention at outputs
   of |o| up to ~27 (hd 64, 112, 128, 256), and the bf16 decode kernel
   within one bf16 step at outputs of |o| up to ~24 (hd 64 and 112 at 16:4 heads, hd 256 at
   16:1); both attention kernels at kimi-k2's hd 112 (64 q heads over 8 kv
   heads): flash causal at S = 512 and 2048, with a q_offset and
   non-causal at Sq = 4, decode over the 8-slot, 2048-slot cache with the
   main path's prefix masks and with masks that leave whole tiles empty;
   both attention kernels at the shapes of phases 3g-3k: minicpm-2b's 36 q
   over 36 kv heads of 64 and qwen2-72b's 64 q over 8 kv heads of 128 with
   the main path's traffic, and llama3-8b's sliding-window mode at 32 q over
   8 kv heads of 128: flash causal under the 4096-token window at Sq = Sk =
   8192 and at a ragged 4161, decode over the 4096-slot ring of the window
   traffic after its last step (wrapped, every slot in the window) and over
   a wrapped ring under a 3000-token window.
   Time kernel, plain version, one PyTorch call for the same function where
   there is one (SDPA, a yardstick the port never calls; under a window
   SDPA takes it as a mask) and the card's bound, at the main path's
   shapes (and the attention kernels also at phi3.5-moe's, llama3-8b's,
   recurrentgemma-9b's, whisper-small's (its encoder and its
   cross-attention of a decode step in the flash row), minicpm-2b's,
   qwen2-72b's and llama3-8b's window mode's (``"llama3_8b_window"``),
   under those names in each attention row; kimi-k2's, 64 q heads over 8 kv
   heads of 112, under ``"kimi_k2"``), and print them on one ``{"kernels": ...}``
   line; for flash also the wrapper's host microseconds a call and the
   kernels SDPA ran (``library_kernels``); for the scan also the device
   time of each of its kernels, and a copy of the decode state as the
   floor of its decode step;
3. serve qwen1.5-0.5b at full width and depth in bf16 through
   ``ContinuousBatcher`` (16 requests, 8 slots, cache 2048, 32 new tokens
   each), with the kernels' launch counters proving every prefill and
   decode attention call went through them; profile 8 decode steps (device
   time against the step's host time) and one 512-token prefill (device
   time, flash attention's share; every flash kernel in it must be
   ``fa_wgmma_kernel``, as in every served prefill profile; the profiled
   prefill must launch its kernels as the counter counts them and give the
   warm-up's logits bit for bit; the profile opens with device sleeps on
   which the profiler's lost first records fall, and a profile that lacks
   a launch's record is printed as a miss and taken again,
   ``profile_prefill``);
   then hold f32 logits of one prompt
   (prefill + 8 decode steps) on the card against the same port code on
   the CPU;
3b. the same for rwkv6-1.6b at full width and depth in bf16 (same traffic),
   every WKV recurrence of every layer through the scan kernels; profile 8
   decode steps and one 512-token prefill (the scan's device time and
   share); then its f32 check at full width and 4 layers;
3c. the same for phi3.5-moe-42b-a6.6b at full width and 16 of its 32
   layers in bf16 (same traffic; 42.1 GB of weights: all 32 layers, 83.7
   GB, do not fit one 80 GB card), every attention call through the two
   attention kernels and every MoE layer through the port's sort-based
   capacity dispatch (PyTorch ops and cuBLAS batched products); check that
   the MoE layer never waits on the host (sync debug mode "error"); profile
   8 decode steps and one 512-token prefill (the expert products', the
   routing's and the dispatch and combine's device time, from profiler
   ranges, and the attention kernels' share); then its f32 check at full
   width and 2 layers, which also holds the experts chosen on the card to
   those chosen on the CPU;
3d. the same for recurrentgemma-9b at full width and all 38 layers in bf16
   (same traffic; 26 RG-LRU blocks, whose log-depth scan is PyTorch ops, and
   12 local-attention blocks, every one of whose calls goes through the two
   attention kernels at hd 256, 16 q heads over 1 kv head); profile 8 decode
   steps and one 512-token prefill (the attention kernels' share); then its
   f32 check at full width and 5 layers, one (RG-LRU, RG-LRU, local
   attention) pattern and the (RG-LRU, RG-LRU) tail, on a 2112-token prompt
   that wraps the 2048-slot ring in prefill and under the window;
3e. whisper-small at full width and depth in bf16 (12 encoder and 12
   decoder layers), served at the model's entry points as the JAX package
   serves it (its engine takes no audio): 2 batches of 8 requests, each
   1500 frames of the seeded audio stub and a 4-token prompt, prefilled
   together (``prefill(enc_inputs=)``, which stores the cross-attention K/V)
   and decoded 32 greedy steps in a 448-slot cache; the launch counters
   prove that every encoder, self- and cross-attention call went through
   the flash kernel (cross-attention at Sq = 1 in each step) and every
   decode self-attention call through the decode kernel; profile one batch
   prefill and 8 decode steps (the flash kernel's time split into encoder,
   self and cross by the profiler range each call runs in, its kernel
   matched by correlation id: ``flash_split``), print the floors of both from the
   shapes, then the f32 check at full depth on one request;
3f. kimi-k2-1t-a32b at full width (d 7168, 64 q heads over 8 kv heads of
   112, all 384 experts, top-8, the full 163,840 vocabulary) and 1 of its
   61 layers in bf16 (38.8 GB; two layers, 72.8 GB, leave no room on an 80
   GB card), with phase 3's traffic: launch counters, the MoE layer under
   sync debug mode "error" at 384 experts, profiles as phase 3c's, then
   the f32 check at full attention width and 1 layer with 16 experts and a
   32,768-token vocabulary (experts chosen equal card vs CPU, logits);
3g. llama3-8b at full width and all 32 layers in bf16 (16.1 GB; 32 q heads
   over 8 kv heads of 128, rope theta 500,000, the 128,256-token
   vocabulary), phase 3's traffic and checks, its f32 check at full width
   and 4 layers;
3h. llama3-8b in the reference's sliding-window long-context mode
   (``EngineConfig(window=cfg.long_context_window)``, 4096): every layer's
   cache a 4096-slot ring, 8 requests (one a slot) of 4160 to 8192 tokens
   from the seed, each longer than the window, so the prefill's flash
   attention masks keys past the window and only the prompt's tail stays
   in the ring, 32 new tokens each; the prefill profile at 8192 tokens;
   its f32 check at full width and 2 layers on a 4160-token prompt, whose
   8 decode steps write over the ring's oldest slots;
3i. minicpm-2b at full width and all 40 layers (5.4 GB; 36 q over 36 kv
   heads of 64, tied embeddings), phase 3's traffic and checks, its f32
   check at 8 layers;
3j. qwen2-72b at full width and 32 of its 80 layers (61.2 GB of bf16: all
   80 are 145.4 GB; 64 q heads over 8 kv heads of 128, qkv bias, the
   152,064-token vocabulary), phase 3's traffic and checks, its f32 check
   at full width and 1 layer with the full vocabulary (13.5 GB in f32);
3k. llava-next-mistral-7b's language backbone at full width and all 32
   layers (14.5 GB) at the model's entry points (the engine and
   ``launch/serve.py`` take no image, and the vision tower is a stub in
   both packages): 2 batches of 8 requests, each 2880 seeded patch
   embeddings (``frontends.vision_embeddings``, 5 tiles: the 2 x 2 anyres
   grid and the base image) followed by a 64-token prompt's rows of the
   card's embedding table, prefilled together and decoded 32 greedy steps
   in a 4096-slot cache; launch counters (flash 32 a batch prefill, decode
   32 a step), a profile of 8 decode steps and of one request's 2944-token
   prefill (``profile_prefill`` on embeddings), then the f32 check at 2
   layers on the first request's patches and prompt;
4. the control plane: the batched float64 tick engine
   (``core/sim/torch_engine.py``) at the JAX package's benchmark shapes
   (``benchmarks/sim_throughput.py``) cut in time (``CONTROL_CUT``,
   printed): ``run_scenario`` over a fleet of 1024 archs and 600 ticks
   under ``portfolio`` and ``rl_pool``, and ``run_grid`` over 64 cells (4
   scenarios x 16 seeds) of 16 archs under ``portfolio``; every fleet run
   and 8 sampled grid cells held to the port's NumPy engine (raw ledger
   and per-arch flows at 1e-6, equal summary keys), and each sampled cell
   of the grid run again over its first 150 ticks equal to
   ``run_scenario`` of that cell over them;
   the tick loop runs under ``torch.cuda.set_sync_debug_mode("error")``
   (a sync raises; the phase first shows the guard catching one); prints
   ticks/s, arch- and cell-ticks/s beside the NumPy engine's on the same
   runs, the device's busy share and kernels a tick over 50 profiled
   ticks, peak memory and the largest relative ledger error;
5. the PPO controller (``core/rl/ppo.py``), trained on the card in the JAX
   package's training env (``benchmarks/rl_vs_schemes.py``: its 8-model
   pool at 400 requests/s, 900-tick episodes, the variant catalog, every
   zoo scenario as a cell of one tick loop of the engine a rollout),
   cut to 3 iterations; prints per iteration the rollout's seconds, ticks/s
   and cell-ticks/s, the update phase's seconds, the five loss means and
   the rollout reward; replays one cell of the first rollout through the
   NumPy env (the actions its NumPy forward draws from the same uniforms
   equal, features and rewards within 1e-6), holds the first minibatch
   update on the card to the CPU at 1e-5, and the trained checkpoint's
   ``rl_pool`` run on the card to the CPU; times the benchmark's rollout
   metric (64 archs, 600 ticks: the step-wise env loop against the
   collector) and profiles a 100-tick rollout and an update phase;
6. training (``training/train_loop.py``, ``model.loss_fn``), every
   attention and WKV call through ``kernels/ops.py``'s autograd Functions
   (the hand-written kernel forward, the plain version's VJP backward):
   6a trains qwen1.5-0.5b at full width and depth in f32 with
   ``launch/train.py``'s configuration (AdamW lr 3e-4, wsd, remat on) on
   ``SyntheticLM`` batches of 8 x 512 for 20 steps: the loss falls, every
   parameter leaf gets a finite, non-zero gradient in the first step, the
   flash launches equal 24 layers x 2 (forward, remat recompute) a step;
   prints the median step of 5 after warm-up, tokens/s, peak memory, a
   profiled step (device time, busy share, the flash forward's, every one
   ``fa_tf32_kernel``, the plain backward's and the optimizer's device
   time) and the step's floor and
   ``train_step_mfu``; 6c saves {params, opt_state} (5.6 GB) and restores it
   onto the card bit-equal, steps from both, and serves a prompt and 8
   decode steps from both (logits equal); 6b holds one step at B=1, S=128
   on the card to the CPU; 6d trains rwkv6-1.6b at full width and depth in
   f32 for 3 steps of 4 x 128 (scan launches 24 x 2 a step), profiles one
   and holds a step at 4 layers, T=64 to the CPU; then both kernels are
   timed at the training shapes (forward, plain backward, SDPA forward +
   backward; flash's forward also beside SDPA's forward alone, held to the
   bound of its three tf32 products with the SIMT one beside it, and at the main path's, phi3.5-moe's, kimi-k2's
   and recurrentgemma-9b's prefill shapes in f32) into the ``{"kernels": ...}`` rows, whose
   launches add the training runs';
7. the single-card mesh/sharding/specs layer: ``launch/specs.py``'s
   ``build_step`` for qwen1.5-0.5b at full width and depth at a train
   (8 x 512), a prefill (1 x 512) and a decode (8 slots, cache 2048) shape
   and for kimi-k2's decode at one layer, run on tensors made on the card
   from its meta specs: every attention call through the kernels, the
   output bit-equal to a direct call of the model's entry point, and the
   dry-run's parameter, optimizer and cache bytes equal to the tensors' (the
   allocator's growth beside them); then the dry-run's FLOP and byte table
   for all ten archs, each at one of the four input shapes
   (``DRYRUN_CUT``, printed; meta tensors, on the host,
   ``launch/dryrun.py``), printed on a ``[dryrun]`` line and timed in the
   phase's seconds; then the dry-run's partition (``dryrun.run_one``) of
   qwen1.5-0.5b ``train_4k``, kimi-k2 ``decode_32k`` and whisper-small
   ``prefill_32k`` over the (16, 16) mesh of a fake process group of 256
   ranks, meta DTensors on the host: each one's collectives (the
   reference's keys and ring factors) and per-device bytes, their totals
   on a ``[dryrun-partition]`` line (``{"specs": ...}``);
8. the multi-device paths at one rank: an NCCL process group of one rank
   (a ``FileStore`` in a temporary directory) and ``make_test_mesh((1,
   1))``, a ``DeviceMesh`` on the card, under rules mapping ``experts`` to
   ``model``: phi3.5-moe at full width and 2 layers in f32 through
   ``moe_path="ep_a2a"`` (``models/moe.py:moe_ep_a2a``, two
   ``all_to_all_single`` calls a layer) against the sort path, ``forward``
   and one ``loss_fn`` gradient, logits, aux, loss and every gradient leaf
   within 1e-5 relative; then phase 3c's bf16 slice (16 layers) through EP
   on a 512-token prompt, with the launch counters from 0 (flash attention
   once a layer), the forward's and the MoE layers' device time (the
   all-to-alls in a profiler range of their own) beside the sort path's and
   the largest logit difference; 8b, under the same group, the
   partitioned step on ``make_test_mesh((1, 1))`` with ``make_rules``'
   rules: qwen1.5-0.5b at full width and depth in bf16 through
   ``build_step``'s prefill (1 x 512) and decode (8 slots, cache 2048) on
   DTensor arguments placed by its specs, every flash and decode call
   through ``local_map`` (counted) with the launch counters from 0 equal
   to the expected ones, the logits held to the same steps on plain
   tensors; an f32 check at full width and 2 layers (prefill and decode
   logits, ``loss_fn``'s loss and every gradient leaf, one
   ``make_train_step`` step's loss) within 1e-5 relative, errors and
   bit-equality printed; the decode step's host ms and ``torch.profiler``
   device ms on DTensors and on plain tensors, on a ``[sharded-step]``
   line with the card's name and power limit; the group is destroyed, and
   ``torch_engine.run_grid`` without one runs the grid as one dispatch
   (``sharded=None`` equal to ``False``) and refuses ``sharded=True``
   (``{"multi_device": ...}``);
9. print the device line ``{"ok": true, "device": {...}}`` last.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402
from repro_torch.configs import INPUT_SHAPES, get_config, list_architectures  # noqa: E402
from repro_torch.configs.registry import InputShape  # noqa: E402
from repro_torch.core import sim as core_sim  # noqa: E402
from repro_torch.core.rl import EnvConfig, PoolServingEnv, ppo, save_policy_params  # noqa: E402
from repro_torch.core.rl.policy import RLPoolPolicy, policy_logits  # noqa: E402
from repro_torch.core.schedulers import VECTOR_SCHEDULERS  # noqa: E402
from repro_torch.core.sim import torch_engine  # noqa: E402
from repro_torch.core.workloads import SCENARIO_ZOO  # noqa: E402
from repro_torch.configs.registry import ATTN, LOCAL_ATTN, RWKV  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rk  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.distributed import AxisRules, axis_rules, device_mesh, partitioned  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import frontends  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.rwkv import F32_LEAVES  # noqa: E402
from repro_torch.serving import ContinuousBatcher, Engine, EngineConfig, Request  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.training import OptimizerConfig, ScheduleConfig, adamw_init  # noqa: E402
from repro_torch.training import train_loop  # noqa: E402
from repro_torch.training.data import SyntheticLM  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_unflatten  # noqa: E402

# tolerances of tests/test_kernels.py
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# f32 logits, card (kernels, cuBLAS without TF32) vs CPU (plain versions):
# the same f32 arithmetic summed in another order; relative rounding of
# ~1e-6 per product through 24 residual layers stays near 1e-5 on logits
# of size ~1-10, so 1e-3 leaves two orders of margin and still catches a
# kernel that drops or misweights a single key (errors of order 1e-1).
LOGIT_TOL = 1e-3
# H100 SXM datasheet peaks: dense bf16 tensor cores, f32 outside the
# tensor cores (training runs f32 with TF32 off), HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# the f32 flash kernel's rate of f32-accurate products: three tf32 products
# each on the tensor cores' 495 TFLOP/s dense tf32
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12

# b, sq, sk, nq, nkv, hd, causal, window  (tests/test_kernels.py FA_CASES)
FA_CASES = [
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 128, 128, 8, 8, 64, True, 16),
    (2, 48, 48, 4, 1, 32, True, 0),
    (1, 64, 64, 2, 2, 16, False, 0),
    (1, 96, 96, 6, 3, 64, True, 32),
]
# b, s, nq, nkv, hd  (tests/test_kernels.py DA_CASES)
DA_CASES = [
    (2, 64, 4, 2, 32),
    (1, 100, 8, 1, 64),
    (3, 48, 2, 2, 16),
    (1, 256, 16, 4, 64),
]

# b, t, h, hd, with_state  (tests/test_kernels.py RWKV_CASES, then one decode step)
RWKV_CASES = [
    (2, 64, 2, 32, False),
    (1, 50, 4, 64, True),
    (2, 33, 1, 16, True),
    (1, 128, 2, 64, True),
    (8, 1, 4, 64, True),
]
# tolerances of tests/test_kernels.py for the scan: its chunked form sums
# decays as log-space prefixes where the plain version multiplies them
RWKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}

ARCH = "qwen1.5-0.5b"
RWKV_ARCH = "rwkv6-1.6b"
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
# phi3.5-moe on one card: 1,300,307,968 parameters a layer (attention
# 41.9 M, 16 experts 1258.3 M, router, norms) and two 131.3 M embedding
# tables; 32 layers are 83.7 GB in bf16, more than the card's 80 GB, so
# the slice runs 16 (42.1 GB), and its f32 check 2 (11.5 GB, on the card
# and again on the host)
MOE_LAYERS, MOE_F32_LAYERS, MOE_F32_PROMPT = 16, 2, 64
MOE_DEPTH_CUT = ("16 of 32 layers at full width: 32 layers are 83.7 GB of bf16 weights, "
                 "more than one 80 GB card holds")
KIMI_ARCH = "kimi-k2-1t-a32b"
# kimi-k2 on one card: one of its 61 layers is 17.03 G parameters (384
# experts 16.91 G, attention 0.116 G, router 2.8 M) and its untied embedding
# and head 2.35 G, so one layer is 38.8 GB of bf16 (two would be 72.8 GB,
# with no room left on an 80 GB card); its f32 check keeps the attention's
# full width (d 7168, 64 q heads over 8 kv heads of 112) at one layer with
# 16 experts (top-8) and a 32,768-token vocabulary, ~1.3 G parameters,
# ~5.2 GB in f32 on the card and again on the host
KIMI_LAYERS, KIMI_F32_EXPERTS, KIMI_F32_VOCAB, KIMI_F32_PROMPT = 1, 16, 32_768, 64
KIMI_DEPTH_CUT = ("1 of 61 layers at full width, all 384 experts, top-8, the full 163,840 "
                  "vocabulary: one layer is 38.8 GB of bf16 weights, two 72.8 GB, more than "
                  "one 80 GB card holds with the cache and activations")
RG_ARCH = "recurrentgemma-9b"
# its f32 check: one (RG-LRU, RG-LRU, local attention) pattern and the tail,
# on a prompt longer than the 2048-token window and ring
RG_F32_LAYERS, RG_F32_PROMPT = 5, 2112
# a decode mask over a ring that has wrapped, under a window shorter than
# the ring (positions written per sequence, ring slots, window)
RING_POSITIONS, RING_WINDOW = [2100, 4095, 3000, 2047, 100, 5000, 2048, 10], 1536
WHISPER_ARCH = "whisper-small"
WHISPER_FRAMES = frontends.WHISPER_FRAMES
# whisper-small's traffic: WHISPER_BATCHES batches of SLOTS requests, each
# with 1500 frames of the seeded audio stub and a 4-token decoder prompt
# (the start-of-transcript prefix: start, language, task, no timestamps),
# NEW_TOKENS greedy tokens after the prefill's, in a cache of 448 slots (the
# decoder's context)
WHISPER_BATCHES, WHISPER_PROMPT, WHISPER_CACHE = 2, 4, 448
LLAMA_ARCH = "llama3-8b"
# llama3-8b's f32 check: full width (32 q heads over 8 kv heads of 128, the
# 128,256-token vocabulary), 4 of its 32 layers, ~7.7 GB in f32 on the card
# and again on the host
LLAMA_F32_LAYERS = 4
# llama3-8b in the reference's sliding-window long-context mode
# (EngineConfig.window = cfg.long_context_window): every layer's cache a
# ring of LONG_CACHE slots, LONG_REQUESTS requests (one a slot) of
# LONG_MIN to LONG_MAX tokens, each longer than the window; its f32 check
# at LONG_F32_LAYERS layers on a LONG_F32_PROMPT-token prompt
LONG_REQUESTS, LONG_CACHE, LONG_MIN, LONG_MAX = 8, 4096, 4160, 8192
LONG_F32_LAYERS, LONG_F32_PROMPT = 2, 4160
LONG_SLICE = "llama3-8b window"
MINICPM_ARCH = "minicpm-2b"
MINICPM_F32_LAYERS = 8
QWEN2_ARCH = "qwen2-72b"
# qwen2-72b on one card: a layer is 877,684,736 parameters (1.755 GB of
# bf16), embedding and untied head 2,491,424,768 (4.98 GB); 80 layers are
# 145.4 GB, so the slice runs 32 (61.2 GB) and its f32 check 1 (13.5 GB in
# f32, on the card and again on the host; the full 152,064 vocabulary)
QWEN2_LAYERS, QWEN2_F32_LAYERS = 32, 1
QWEN2_DEPTH_CUT = ("32 of 80 layers at full width: a layer is 1.755 GB of bf16 weights and "
                   "embedding plus head 4.98 GB, so 80 layers are 145.4 GB, more than one 80 GB "
                   "card holds; 32 layers are 61.2 GB, which leaves ~19 GB of the card for the "
                   "2.1 GB cache, the activations and the allocator (33 layers 62.9 GB)")
VLM_ARCH = "llava-next-mistral-7b"
# llava-next-mistral-7b's language backbone at the model's entry points (the
# engine and launch/serve.py take no image): VLM_BATCHES batches of SLOTS
# requests, each VLM_TILES x 576 patch embeddings (LLaVA-NeXT's 2 x 2 anyres
# grid and the base image) then a VLM_TEXT-token prompt, NEW_TOKENS greedy
# tokens after the prefill's into a cache of VLM_CACHE slots; its f32 check
# at VLM_F32_LAYERS layers on one request
VLM_BATCHES, VLM_TILES, VLM_TEXT, VLM_CACHE, VLM_F32_LAYERS = 2, 5, 64, 4096, 2
DEPTH_CUTS = {MOE_ARCH: MOE_DEPTH_CUT, KIMI_ARCH: KIMI_DEPTH_CUT, QWEN2_ARCH: QWEN2_DEPTH_CUT}
KERNELS = {"flash_attention": fa, "decode_attention": da, "rwkv6_scan": rk}
N_REQUESTS, SLOTS, CACHE_LEN, NEW_TOKENS = 16, 8, 2048, 32
PROMPT_MIN, PROMPT_MAX = 64, 512
F32_DECODE_STEPS = 8
# the f32 check of the RWKV path: full width, 4 of its 24 layers (the CPU
# runs the same model with the plain versions), and a prompt of two whole
# 32-token chunks and a ragged tail
RWKV_F32_LAYERS, RWKV_F32_PROMPT = 4, 77
# rwkv6-1.6b's main-path scan shapes: prefill (B=1, a ragged T) and decode (8 slots)
RWKV_PREFILL, RWKV_DECODE = (1, 500, 32, 64, True), (SLOTS, 1, 32, 64, True)
# 64 chunks (16 ranks of 4 on the card); the state updated in place over two chunks
# and a ragged tail, and in one decode step
RWKV_LONG, RWKV_IN_PLACE = (1, 2048, 4, 64, True), ((2, 45, 4, 64, True), (8, 1, 4, 64, True))
# the decode library's one kernel: a call launches it once, never another
DECODE_KERNELS = ("da_cluster_kernel",)
# each slice's own kernels in a profile, by name: flash attention's (the
# bf16 wgmma kernel, which every head size runs) and decode attention's,
# and every kernel of the rwkv6_scan library, all of which live in its
# namespace rwkv6
PROFILED = {
    ARCH: {"prefill": ("flash_attention", ("fa_wgmma_kernel",)),
           "decode": ("decode_attention", DECODE_KERNELS)},
    RWKV_ARCH: {"prefill": ("rwkv6_scan", ("rwkv6::",)), "decode": ("rwkv6_scan", ("rwkv6::",))},
    MOE_ARCH: {"prefill": ("flash_attention", ("fa_wgmma_kernel",)),
               "decode": ("decode_attention", DECODE_KERNELS)},
    KIMI_ARCH: {"prefill": ("flash_attention", ("fa_wgmma_kernel",)),
                "decode": ("decode_attention", DECODE_KERNELS)},
    RG_ARCH: {"prefill": ("flash_attention", ("fa_wgmma_kernel",)),
              "decode": ("decode_attention", DECODE_KERNELS)},
    LLAMA_ARCH: {"prefill": ("flash_attention", ("fa_wgmma_kernel",)),
                 "decode": ("decode_attention", DECODE_KERNELS)},
    MINICPM_ARCH: {"prefill": ("flash_attention", ("fa_wgmma_kernel",)),
                   "decode": ("decode_attention", DECODE_KERNELS)},
    QWEN2_ARCH: {"prefill": ("flash_attention", ("fa_wgmma_kernel",)),
                 "decode": ("decode_attention", DECODE_KERNELS)},
    VLM_ARCH: {"prefill": ("flash_attention", ("fa_wgmma_kernel",)),
               "decode": ("decode_attention", DECODE_KERNELS)},
}
# the MoE layer's parts, each run inside a profiler range of this name:
# the whole layer, its routing (router product, top-k, softmax, aux) and
# the expert products (three batched cuBLAS products and the SwiGLU);
# dispatch and combine are the layer's time less the other two
MOE_RANGES = {"layer": "moe_sort_local", "route": "_route", "experts": "_expert_ffn"}


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name, err, tol):
    if not err < tol:
        raise AssertionError(f"{name}: max abs err {err} >= {tol}")


class L2Flush:
    """Writes a buffer larger than the 50 MB L2 so each timed call starts
    cold, as a layer's call does on the main path."""

    def __init__(self, device):
        self.buf = torch.empty(64 * 2**20, dtype=torch.int32, device=device)

    def __call__(self):
        self.buf.zero_()


# ~1 ms of device work queued after each flush, so that the host has
# enqueued the start event, the call and the end event before the device
# reaches them: the events then time the device, not the host's dispatch.
# A kernel's call needs ~0.1 ms of it; a plain version's dozen operators
# (~0.2-0.4 ms of host dispatch at B=1, S=512) need more, or their times
# swing with the host's load
HOST_AHEAD_CYCLES = 2_000_000


def time_ms(fn, flush, iters=20, warmup=3) -> float:
    """Median device time of ``fn`` from CUDA events, L2 flushed before each."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush()
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def bound(flops: float, nbytes: float, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# Phase 1: build.
# ---------------------------------------------------------------------------
# SASS opcodes counted in each library: mma.sync, wgmma, ldmatrix, wgmma
# with tf32 operands and TMA tensor loads
SASS_OPCODES = {"HMMA": r"\bHMMA\b", "HGMMA": r"\bHGMMA\b", "LDSM": r"\bLDSM\b",
                "HGMMA.TF32": r"\bHGMMA\.\S*\.TF32\b", "UTMALDG": r"\bUTMALDG\b"}
# what ptxas says when a kernel's design is not in effect: setmaxnreg
# ignored (C7508), wgmma serialised (C7510)
PTXAS_DESIGN_WARNINGS = ("C7508", "C7510")


def sass_counts(path, function=None) -> dict:
    """Instructions of each SASS_OPCODES opcode in a built library's SASS,
    read with the ``cuobjdump`` of the toolkit that built it; with
    ``function``, only in the kernels whose mangled names hold it."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    if function is not None:
        sass = "".join(part for part in re.split(r"(?=\bFunction : )", sass)
                       if part.startswith("Function : ") and function in part.split("\n", 1)[0])
    return {op: len(re.findall(pattern, sass)) for op, pattern in SASS_OPCODES.items()}


def ptxas_report(log: str):
    """{mangled kernel: (registers, spill store bytes, spill load bytes)}
    from ``ptxas -v``'s lines: "Compiling entry function '<k>'", then
    "Function properties for <k>" with its spill bytes, then "Used N
    registers"."""
    out, name, spill = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def kernel_names(mangled):
    """{mangled: "name<template args>"} by ``c++filt`` (the mangled name where
    it is missing), without the return type, namespaces and parameters."""
    filt = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True, text=True,
                          timeout=60)
    lines = filt.stdout.splitlines() if filt.returncode == 0 else []
    if len(lines) != len(mangled):
        return {n: n for n in mangled}
    short = lambda d: d.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0]
    return {n: short(d) for n, d in zip(mangled, lines)}


# the f32 kernel's hd-256 instantiation (a cluster of two CTAs), by its
# mangled name
TF32_HD256 = "fa_tf32_kernelILi256E"


def check_flash_design(counts, log, hd256_counts) -> None:
    """The flash library's tensor-core kernels are the Hopper design they
    claim: wgmma (with tf32 operands among them) and TMA loads in its SASS,
    each ``fa_wgmma_kernel`` (bf16) and ``fa_tf32_kernel`` (f32) instantiation,
    hd 16, 32, 64, 112, 128 and 256, compiled without spill, tf32 wgmma in
    the SASS of the f32 one at hd 256 (``hd256_counts``: every f32 flash
    call on the tensor cores), and no ptxas warning that setmaxnreg was
    ignored or wgmma serialised.  Prints the instantiations' registers (at
    launch; setmaxnreg moves them later) and spill bytes."""
    if not (counts["HGMMA"] and counts["HGMMA.TF32"] and counts["UTMALDG"]):
        raise AssertionError(f"the flash_attention library lacks wgmma, tf32 wgmma or TMA "
                             f"loads: {counts}")
    print(f"[build] flash_attention {TF32_HD256}: " + ", ".join(
        f"{c} {op}" for op, c in hd256_counts.items()) + " instructions in its SASS")
    if not (hd256_counts["HGMMA.TF32"] and hd256_counts["UTMALDG"]):
        raise AssertionError(f"the f32 flash kernel at hd 256 lacks tf32 wgmma or TMA loads: "
                             f"{hd256_counts}")
    report = ptxas_report(log)
    readable = kernel_names(list(report))
    for kernel, instances in (("fa_wgmma_kernel", 6), ("fa_tf32_kernel", 6)):
        wg = {readable[k]: v for k, v in report.items() if kernel in k}
        print(f"[build] flash_attention {kernel}: " + json.dumps(
            {k: {"registers": r, "spill_store_bytes": st, "spill_load_bytes": ld}
             for k, (r, st, ld) in wg.items()}))
        if len(wg) != instances or any(st or ld for _, st, ld in wg.values()):
            raise AssertionError(f"{kernel} instantiations missing or spilling: {wg}")
    warned = [line for line in log.splitlines() if any(w in line for w in PTXAS_DESIGN_WARNINGS)]
    if warned:
        raise AssertionError("ptxas: " + " | ".join(warned))


def check_tf32_probe() -> None:
    """The f32 kernel's one-tile probe (``flash_attention.tf32_probe``): a
    64 x 8 f32 A, random from seed 0 so that its low 13 bits are set, times
    the identity by wgmma .tf32, A from shared memory and from registers.
    Both must read A truncated to its top 19 bits (``ref.tf32``), which the
    kernel takes Q and K as they land for; the register read agreeing with
    the shared-memory one also confirms the A fragment's layout."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32))
    d_ss, d_rs = (x.cpu() for x in fa.tf32_probe(a.cuda()))
    read = {name: "truncated" if torch.equal(d, ref.tf32(a))
            else "as f32" if torch.equal(d, a) else "not truncated"
            for name, d in (("shared_memory", d_ss), ("registers", d_rs))}
    print("[build] flash_attention tf32 probe, how the tensor cores read an f32 operand: "
          + json.dumps(read))
    if set(read.values()) != {"truncated"}:
        raise AssertionError(f"the tensor cores do not read f32 operands truncated: {read}")


# the served decode shapes (B, S, nq, nkv, hd): qwen1.5-0.5b (the main
# path), phi3.5-moe, kimi-k2, recurrentgemma-9b, whisper-small, and
# llama3-8b's phase-2 shape
DECODE_SHAPES = {"main": (SLOTS, CACHE_LEN, 16, 16, 64), MOE_ARCH: (SLOTS, CACHE_LEN, 32, 8, 128),
                 KIMI_ARCH: (SLOTS, CACHE_LEN, 64, 8, 112), RG_ARCH: (SLOTS, CACHE_LEN, 16, 1, 256),
                 WHISPER_ARCH: (SLOTS, WHISPER_CACHE, 12, 12, 64),
                 "llama3_8b": (8, 4096, 32, 8, 128)}


def check_decode_design(counts, log) -> None:
    """The decode library is the Hopper design it claims: wgmma and TMA
    loads in its SASS, each bf16 ``da_cluster_kernel`` instantiation (the
    tensor-core ones, 8 or 16 heads a product, and the SIMT one for larger
    groups) compiled without spill, no ptxas warning that wgmma was
    serialised, and the card able to hold a cluster of each size
    ``cluster_plan`` gives the served shapes, in bf16 and f32
    (``cudaOccupancyMaxActiveClusters``, printed)."""
    if not (counts["HGMMA"] and counts["UTMALDG"]):
        raise AssertionError(f"the decode_attention library lacks wgmma or TMA loads: {counts}")
    report = ptxas_report(log)
    readable = kernel_names(list(report))
    bf = {readable[k]: v for k, v in report.items()
          if "da_cluster_kernel" in k and "nv_bfloat16" in readable[k]}
    print("[build] decode_attention bf16 da_cluster_kernel: " + json.dumps(
        {k: {"registers": r, "spill_store_bytes": st, "spill_load_bytes": ld}
         for k, (r, st, ld) in bf.items()}))
    if len(bf) != 3 * len(da.SUPPORTED_HEAD_DIMS) or any(st or ld for _, st, ld in bf.values()):
        raise AssertionError(f"da_cluster_kernel bf16 instantiations missing or spilling: {bf}")
    warned = [line for line in log.splitlines() if any(w in line for w in PTXAS_DESIGN_WARNINGS)]
    if warned:
        raise AssertionError("ptxas: " + " | ".join(warned))
    dev = torch.device("cuda")
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    fits = {}
    for name, (b, s, nq, nkv, hd) in DECODE_SHAPES.items():
        shaped = da.cluster_plan(b, nkv, s, sm)
        for dtype in (torch.bfloat16, torch.float32):
            c = da.clusters_for(b, s, nq, nkv, hd, dtype, dev)
            at_once = {n: da.max_active_clusters(dtype, hd, nq // nkv, n, dev)
                       for n in sorted({1, c, shaped})}
            chunks = nq // nkv // da.heads_per_cta(dtype, nq // nkv, hd)
            fits[f"{name} {str(dtype)[6:]}"] = {"shape_plan": shaped, "clusters": c,
                                                "ctas": b * nkv * chunks * c,
                                                "max_active_clusters": at_once}
            if min(at_once.values()) < 1:
                raise AssertionError(f"decode_attention {name} {dtype}: the card holds no "
                                     f"cluster of some size in {at_once}")
    print("[build] decode_attention cluster sizes: " + json.dumps(fits))


# the scan's T > 1 kernel, by its mangled name: every instantiation, its f32
# ones, and the plans of the served and training shapes (b, t, h, hd, dtype)
SCAN_KERNEL, SCAN_KERNEL_F32 = "scan_kernelI", "scan_kernelIf"
SCAN_PLANS = {"served prefill bf16": (1, 500, 32, 64, torch.bfloat16),
              "served prefill f32": (1, 500, 32, 64, torch.float32),
              "training forward f32": (4, 128, 32, 64, torch.float32)}


def check_scan_design(path, log) -> None:
    """The scan library's T > 1 kernel is the Hopper design it claims:
    wgmma, with tf32 operands (f32 and bf16 alike take three tf32 products),
    tf32 wgmma in the f32 instantiations' own SASS, TMA loads, and neither
    mma.sync (``HMMA``) nor ldmatrix (``LDSM``); its 16 instantiations (f32
    and bf16, hd 16 to 128, one chunk a rank or several) compiled without
    spill, and no ptxas warning that wgmma was serialised.  Prints the
    card's count of clusters it holds at once (``cudaOccupancyMaxActiveClusters``)
    for every rank count 1 to 16 of both instantiations at hd 64, in bf16
    and f32 (what ``rwkv6_scan.cluster_plan`` chooses by), and, for each
    plan of the served and training shapes, its ranks, that count and the
    waves its grid takes; fails where the served bf16 prefill's plan takes
    more than one wave."""
    counts, f32 = sass_counts(path, SCAN_KERNEL), sass_counts(path, SCAN_KERNEL_F32)
    print("[build] rwkv6_scan scan_kernel: " + ", ".join(f"{c} {op}" for op, c in counts.items())
          + " instructions in its SASS (f32 instantiations: "
          + ", ".join(f"{c} {op}" for op, c in f32.items()) + ")")
    if not (counts["HGMMA"] and counts["HGMMA.TF32"] and f32["HGMMA.TF32"]
            and counts["UTMALDG"]):
        raise AssertionError(f"the scan kernel lacks wgmma, tf32 wgmma or TMA loads: {counts}")
    if counts["HMMA"] or counts["LDSM"]:
        raise AssertionError(f"the scan kernel still has mma.sync or ldmatrix: {counts}")
    report = ptxas_report(log)
    readable = kernel_names(list(report))
    inst = {readable[k]: v for k, v in report.items() if SCAN_KERNEL in k}
    print("[build] rwkv6_scan scan_kernel: " + json.dumps(
        {k: {"registers": r, "spill_store_bytes": st, "spill_load_bytes": ld}
         for k, (r, st, ld) in inst.items()}))
    if len(inst) != 4 * len(rk.SUPPORTED_HEAD_DIMS) or any(st or ld for _, st, ld in inst.values()):
        raise AssertionError(f"scan_kernel instantiations missing or spilling: {inst}")
    warned = [line for line in log.splitlines() if any(w in line for w in PTXAS_DESIGN_WARNINGS)]
    if warned:
        raise AssertionError("ptxas: " + " | ".join(warned))
    dev = torch.device("cuda")
    at_once = {f"{str(dt)[6:]} hd 64 {kind}": [rk.max_active_clusters(dt, 64, r, dev, one)
                                              for r in range(1, rk.R_MAX + 1)]
               for dt in (torch.bfloat16, torch.float32)
               for kind, one in (("one chunk a rank", True), ("several", False))}
    print("[build] rwkv6_scan clusters at once, ranks 1-16: " + json.dumps(at_once))
    plans = {}
    for name, (b, t, h, hd, dtype) in SCAN_PLANS.items():
        plan = rk.plan_on(b, t, h, hd, dtype, dev)
        clusters = b * h
        plans[name] = {"ranks": plan.ranks, "chunks_a_rank": plan.runs[0][1],
                       "one_chunk_a_rank": plan.ranks == plan.chunks, "clusters": clusters,
                       "ctas": clusters * plan.ranks, "max_active_clusters": plan.at_once,
                       "waves": plan.waves}
    print("[build] rwkv6_scan cluster plans: " + json.dumps(plans))
    if plans["served prefill bf16"]["waves"] != 1:
        raise AssertionError(f"rwkv6_scan served bf16 prefill in more than one wave: "
                             f"{plans['served prefill bf16']}")


# ---------------------------------------------------------------------------
# Phase 0: the port's static analysis.
# ---------------------------------------------------------------------------
def phase_analysis() -> None:
    """``python -m repro_torch.analysis src/repro_torch`` on this checkout;
    its findings and stale-baseline warnings pass through, its summary line
    is read back."""
    root = os.path.dirname(os.path.abspath(__file__))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = analysis_main([os.path.join(root, "src", "repro_torch"), "--repo-root", root])
    lines = err.getvalue().splitlines()
    for line in lines[:-1]:
        print(line, file=sys.stderr)
    m = re.fullmatch(r"(\d+) modules, (\d+) passes: (\d+) finding\(s\)(?:, (\d+) baselined)?.*",
                     lines[-1] if lines else "")
    if m is None:
        raise AssertionError(f"repro_torch.analysis printed no summary: {err.getvalue()!r}")
    modules, passes, findings, baselined = (int(g or 0) for g in m.groups())
    print(f"analysis: {modules} modules, {passes} passes, {findings} finding(s), "
          f"{baselined} baselined")
    if rc != 0 or findings:
        raise AssertionError(f"repro_torch.analysis: exit {rc}, {findings} finding(s)")


def phase_build() -> str:
    t0 = time.perf_counter()
    paths = _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {secs:.1f} s: " + ", ".join(f"{n} -> {p.name}" for n, p in paths.items()))
    for name in paths:
        report = ptxas_report(_build.build_log(name))
        readable = kernel_names(list(report))
        for k, (regs, st, ld) in report.items():
            print(f"[build] {name}: {readable[k]}: {regs} registers, "
                  f"{st} bytes spill stores, {ld} bytes spill loads")
        wide = {readable[k]: v for k, v in report.items() if "Li256E" in k}
        if name in ("flash_attention", "decode_attention"):
            if not wide:
                raise AssertionError(f"the {name} library has no hd-256 instantiation")
            print(f"[build] {name} hd 256: " + json.dumps(
                {k: {"registers": r, "spill_store_bytes": st, "spill_load_bytes": ld}
                 for k, (r, st, ld) in wide.items()}))
    for name in paths:
        n = sass_counts(paths[name])
        print(f"[build] {name}: " + ", ".join(f"{c} {op}" for op, c in n.items())
              + " instructions in its SASS")
        if name in ("flash_attention", "rwkv6_scan") and not (n["HMMA"] or n["HGMMA"]):
            raise AssertionError(f"the {name} library has no tensor-core instruction")
    check_flash_design(sass_counts(paths["flash_attention"]), _build.build_log("flash_attention"),
                       sass_counts(paths["flash_attention"], TF32_HD256))
    check_tf32_probe()
    check_decode_design(sass_counts(paths["decode_attention"]),
                        _build.build_log("decode_attention"))
    check_scan_design(paths["rwkv6_scan"], _build.build_log("rwkv6_scan"))
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(gpu)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    return gpu


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------
def check_flash(gen, b, sq, sk, nq, nkv, hd, causal, window, dtype, q_offset=0):
    q = randn(gen, (b, sq, nq, hd), dtype)
    k = randn(gen, (b, sk, nkv, hd), dtype)
    v = randn(gen, (b, sk, nkv, hd), dtype)
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    exp = ref.mha_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if out.shape != exp.shape or out.dtype != dtype:
        raise AssertionError(f"flash_attention: {out.shape} {out.dtype} vs {exp.shape} {dtype}")
    err = max_err(out, exp)
    check(f"flash_attention {(b, sq, sk, nq, nkv, hd, causal, window, q_offset)} {dtype}",
          err, TOL[dtype])
    return err, (q, k, v)


def prefix_valid(lengths, s, device):
    lengths = torch.as_tensor(lengths, device=device)
    return torch.arange(s, device=device)[None, :] < lengths[:, None]


def check_decode(gen, b, s, nq, nkv, hd, dtype, valid=None):
    q = randn(gen, (b, nq, hd), dtype)
    k = randn(gen, (b, s, nkv, hd), dtype)
    v = randn(gen, (b, s, nkv, hd), dtype)
    if valid is None:
        valid = torch.rand((b, s), generator=gen, device=gen.device) < 0.7
        valid[:, 0] = True                       # at least one visible slot
    out = da.decode_attention(q, k, v, valid)
    exp = ref.decode_attention_reference(q, k, v, valid)
    # a sequence with no valid slot gives 0 (the plain version, like the
    # JAX oracle, spreads the softmax uniformly over masked slots instead)
    empty = ~valid.any(dim=1)
    exp = torch.where(empty[:, None, None], torch.zeros_like(exp), exp)
    err = max_err(out, exp)
    check(f"decode_attention {(b, s, nq, nkv, hd)} {dtype}", err, TOL[dtype])
    return err, (q, k, v, valid)


def check_attention_edges(gen, dtype) -> int:
    """The attention kernels' edge cases; returns the number of checks."""
    dev = gen.device
    # flash: a ragged 1000-token prompt (GQA, hd 128 and 64), a window with a
    # q_offset, and rows whose window lies past Sk, which give 0
    check_flash(gen, 1, 1000, 1000, 8, 2, 128, True, 0, dtype)
    check_flash(gen, 2, 1000, 1000, 4, 4, 64, False, 0, dtype)
    check_flash(gen, 1, 300, 337, 4, 4, 64, True, 48, dtype, q_offset=37)
    # the same over a grid of 1024 CTAs (several waves on the card)
    check_flash(gen, 4, 1000, 1037, 16, 4, 64, True, 48, dtype, q_offset=37)
    q, k, v = (randn(gen, (1, n, 4, 64), dtype) for n in (100, 64, 64))
    out = fa.flash_attention(q, k, v, causal=True, window=8, q_offset=50)
    seen = 64 + 8 - 1 - 50                       # rows [0, seen) see a key
    if bool(out[:, seen:].any()):
        raise AssertionError(f"flash_attention {dtype}: a row that sees no key is not 0")
    exp = ref.mha_reference(q, k, v, causal=True, window=8, q_offset=50)
    check(f"flash_attention window past Sk {dtype}", max_err(out[:, :seen], exp[:, :seen]),
          TOL[dtype])
    # recurrentgemma-9b's local attention (hd 256, 16 q heads over 1 kv
    # head): a prompt longer than its 2048-token window, so the window bites
    check_flash(gen, 1, RG_F32_PROMPT, RG_F32_PROMPT, 16, 1, 256, True, 2048, dtype)
    # and its decode over a 2048-slot ring that has wrapped, under a window
    # that excludes the oldest slots
    check_decode(gen, SLOTS, CACHE_LEN, 16, 1, 256, dtype,
                 ring_valid(RING_POSITIONS, CACHE_LEN, RING_WINDOW, dev))
    n_edges = check_flash_tile_edges(gen, dtype)
    # decode: whole 64-slot tiles empty in the middle of a 2048-slot cache
    # (cluster ranks that see none of the valid slots), a sequence valid
    # only at its last slot, one with none
    valid = torch.zeros((4, 2048), dtype=torch.bool, device=dev)
    valid[0, :70] = True
    valid[0, -100:] = True
    valid[1, ::97] = True
    valid[2, -1] = True
    _, (q, k, v, valid) = check_decode(gen, 4, 2048, 8, 2, 64, dtype, valid)
    if da.cluster_plan(4, 2, 2048, torch.cuda.get_device_properties(dev).multi_processor_count) < 3:
        raise AssertionError("decode_attention edge case: expected clusters of 3 or more CTAs")
    out = da.decode_attention(q, k, v, valid)
    if bool(out[3].any()):
        raise AssertionError("decode_attention: a sequence with no valid slot is not 0")
    check("decode_attention single valid slot in the last tile",
          max_err(out[2], v[2, -1].repeat_interleave(4, dim=0)), TOL[dtype])
    return 8 + n_edges + check_kimi_attention(gen, dtype)


# the edges of the bf16 flash kernel's 128-row blocks and 64-key tiles, and
# at hd 256 of its 64-row blocks and 64-key tiles; in f32 at hd 256, of the
# 64-row blocks and 32-key tiles of each CTA of its cluster (rows, keys)
TILE_EDGES = (1, 127, 128, 129)
TILE_EDGES_HD256 = (127, 129)
TILE_EDGES_TF32_HD256 = ((63, 65), (31, 33, 63, 65))


def check_flash_tile_edges(gen, dtype) -> int:
    """Flash at the edges of its row blocks and KV tiles: Sq and Sk each in
    TILE_EDGES, causal and not (8 q heads over 2 kv heads of 64), and each
    in TILE_EDGES_HD256 at hd 256 (16 q heads over 1 kv head); windows
    whose edge and q_offset cross tile edges (hd 64 and 128); GQA at 64:8
    (hd 112 and 128) and 16:1 (hd 64) across a tile edge; in f32, hd 256
    at 16:1 across its 64-row blocks and 32-key tiles (Sq in {63, 65}, Sk in
    {31, 33, 63, 65}, causal and not) and under a window with a q_offset.
    Returns the number of checks."""
    n = 0
    if dtype == torch.float32:
        rows, keys = TILE_EDGES_TF32_HD256
        for sq in rows:
            for sk in keys:
                for causal in (True, False):
                    check_flash(gen, 1, sq, sk, 16, 1, 256, causal, 0, dtype)
                    n += 1
        check_flash(gen, 2, 100, 164, 16, 1, 256, True, 48, dtype, q_offset=64)
        # rows 21 and on see no key, so the clusters of rows 64-99 walk no
        # tile and exchange nothing: those rows give 0
        q, k, v = (randn(gen, (1, s, h, 256), dtype) for s, h in ((100, 16), (64, 1), (64, 1)))
        out = fa.flash_attention(q, k, v, causal=True, window=8, q_offset=50)
        exp = ref.mha_reference(q, k, v, causal=True, window=8, q_offset=50)
        seen = 64 + 8 - 1 - 50
        if bool(out[:, seen:].any()):
            raise AssertionError("flash_attention f32 hd 256: a row that sees no key is not 0")
        check("flash_attention f32 hd 256 window past Sk",
              max_err(out[:, :seen], exp[:, :seen]), TOL[dtype])
        n += 2
    for sq in TILE_EDGES:
        for sk in TILE_EDGES:
            for causal in (True, False):
                check_flash(gen, 2, sq, sk, 8, 2, 64, causal, 0, dtype)
                n += 1
    for sq in TILE_EDGES_HD256:
        for sk in TILE_EDGES_HD256:
            for causal in (True, False):
                check_flash(gen, 1, sq, sk, 16, 1, 256, causal, 0, dtype)
                n += 1
    check_flash(gen, 1, 200, 300, 8, 2, 64, True, 100, dtype, q_offset=70)
    check_flash(gen, 1, 129, 300, 4, 4, 128, True, 64, dtype, q_offset=37)
    check_flash(gen, 1, 129, 129, 64, 8, 112, True, 0, dtype)
    check_flash(gen, 1, 129, 129, 64, 8, 128, True, 0, dtype)
    check_flash(gen, 2, 129, 300, 16, 1, 64, False, 0, dtype)
    return n + 5


def check_kimi_attention(gen, dtype) -> int:
    """kimi-k2's attention (64 q heads over 8 kv heads of 112): flash causal
    at S = 2048 (S = 512 is among the main-path shapes), with a q_offset
    (a prompt's second half against the whole), non-causal at Sq = 4; decode
    over an 8-slot, 2048-slot cache with masks that leave whole tiles
    empty, one slot alone in the last tile and a sequence with none.
    Returns the number of checks."""
    dev = gen.device
    check_flash(gen, 1, 2048, 2048, 64, 8, 112, True, 0, dtype)
    q, k, v = (randn(gen, (1, 300, n, 112), dtype) for n in (64, 8, 8))
    out = fa.flash_attention(q[:, 150:].contiguous(), k, v, causal=True, q_offset=150)
    check(f"flash_attention hd 112 q_offset {dtype}",
          max_err(out, ref.mha_reference(q, k, v, causal=True)[:, 150:]), TOL[dtype])
    check_flash(gen, SLOTS, 4, 300, 64, 8, 112, False, 0, dtype)
    valid = torch.zeros((SLOTS, CACHE_LEN), dtype=torch.bool, device=dev)
    valid[0, :70] = True
    valid[0, -100:] = True
    valid[1, ::97] = True
    valid[2, -1] = True
    valid[4:] = prefix_valid([1, 700, 1500, CACHE_LEN], CACHE_LEN, dev)
    _, (q, k, v, valid) = check_decode(gen, SLOTS, CACHE_LEN, 64, 8, 112, dtype, valid)
    out = da.decode_attention(q, k, v, valid)
    if bool(out[3].any()):
        raise AssertionError("decode_attention hd 112: a sequence with no valid slot is not 0")
    check("decode_attention hd 112 single valid slot in the last tile",
          max_err(out[2], v[2, -1].repeat_interleave(8, dim=0)), TOL[dtype])
    return 4


def check_one_step(name, qkv, causal) -> float:
    """The bf16 flash kernel on ``qkv`` held to the f32 attention o32 of the
    same bf16 inputs within one bf16 step of o32 (at least 2e-2,
    ``ref.bf16_step``), what the TPU kernel meets by rounding its f32 result
    once; returns the largest error in steps."""
    q, k, v = qkv
    steps = float(ref.bf16_steps_from_f32(fa.flash_attention(q, k, v, causal=causal),
                                          q, k, v, causal=causal).max())
    if not steps <= 1.0:
        raise AssertionError(f"flash_attention bf16 {name}: {steps} bf16 steps from the f32 "
                             "attention of its inputs")
    return steps


def check_flash_rounding(dev):
    """bf16 outputs of |o| up to ~27 made from a few keys, hd 64, 112 (kimi-k2),
    128 and 256 (the inputs of
    tests/test_torch_cuda.py::test_flash_bf16_rounding_margin_at_large_outputs,
    ``ref.large_output_inputs``) within one bf16 step of the f32 attention;
    returns the largest error in steps per hd."""
    return {f"hd {hd}": check_one_step(f"hd {hd}", ref.large_output_inputs(hd, dev), True)
            for hd in (64, 112, 128, 256)}


def check_flash_f32_large_outputs(dev):
    """f32 outputs of |o| up to ~27 (``ref.large_output_inputs``, the inputs
    of tests/test_torch_cuda.py::test_flash_f32_as_close_to_float64_as_plain_at_large_outputs),
    where no f32 kernel meets 2e-5 against the plain version: the kernel's
    three tf32 products must stay within 1.5 times the plain f32 version's
    distance from a float64 attention; returns both distances per hd."""
    out = {}
    for hd in (64, 112, 128, 256):
        q, k, v = ref.large_output_inputs(hd, dev, torch.float32)
        o64 = ref.attention_f64(q, k, v, causal=True)
        kernel = float((fa.flash_attention(q, k, v, causal=True).double() - o64).abs().max())
        plain = float((ref.mha_reference(q, k, v, causal=True).double() - o64).abs().max())
        out[f"hd {hd}"] = {"kernel": kernel, "plain": plain}
        if not kernel <= 1.5 * plain:
            raise AssertionError(f"flash_attention f32 hd {hd}: {kernel} from float64, more "
                                 f"than 1.5 times the plain version's {plain}")
    return out


def check_decode_rounding(dev):
    """bf16 decode outputs of |o| up to ~24 made from a few slots, 16 q heads
    over 4 kv heads at hd 64 and 112 and over 1 at hd 256 (the inputs of
    tests/test_torch_cuda.py::test_decode_bf16_rounding_margin_at_large_outputs,
    ``ref.large_output_decode_inputs`` at its default seed and the 64 of
    ``ref.DECODE_ROUNDING_SEEDS``), within one bf16 step of the f32
    attention of the same inputs, as the TPU kernel rounds; returns
    ``ref.decode_rounding_sweep`` per hd."""
    out = {}
    for hd in (64, 112, 256):
        out[f"hd {hd}"] = sweep = ref.decode_rounding_sweep(da.decode_attention, hd, dev)
        if not sweep["max_err_in_steps"] <= 1.0:
            raise AssertionError(f"decode_attention bf16 hd {hd}: {sweep} (bf16 steps from "
                                 "the f32 attention of its inputs)")
    return out


# llama3-8b's window mode at its edges: flash at a ragged prompt of 4161
# tokens (65 past the window, one past a multiple of the 64-key tile), at
# 32 q over 8 kv heads of 128, and decode over the 4096-slot ring with a window shorter than the
# ring (positions written per sequence: past the ring, at its edge, short
# of it, and one slot), so that whole 64-slot tiles and cluster ranks are
# masked in the ring's middle
LONG_EDGE_PROMPT = LONG_MIN + 1
LONG_RING_POSITIONS, LONG_RING_WINDOW = [4200, 8223, 6000, 4095, 100, 10000, 4096, 10], 3000


def check_window_edges(gen, dtype) -> dict:
    """Flash under the window at LONG_EDGE_PROMPT and decode over a wrapped
    ring under LONG_RING_WINDOW, llama3-8b's heads; the max abs errors."""
    dev = gen.device
    return {
        f"flash S={LONG_EDGE_PROMPT} window={LONG_CACHE}": check_flash(
            gen, 1, LONG_EDGE_PROMPT, LONG_EDGE_PROMPT, 32, 8, 128, True, LONG_CACHE, dtype)[0],
        f"decode ring={LONG_CACHE} window={LONG_RING_WINDOW}": check_decode(
            gen, SLOTS, LONG_CACHE, 32, 8, 128, dtype,
            ring_valid(LONG_RING_POSITIONS, LONG_CACHE, LONG_RING_WINDOW, dev))[0]}


def ring_valid(positions, ring, window, device):
    """The decode mask of a ring of ``ring`` slots after each sequence wrote
    positions 0..t (slot = pos % ring, the latest write wins) under a window
    of ``window`` positions, as ``attention.attention_decode`` builds it."""
    t = torch.tensor(positions, device=device)[:, None]
    slot = torch.arange(ring, device=device)[None, :]
    sp = slot + ring * torch.div(t - slot, ring, rounding_mode="floor")
    sp = torch.where(sp >= 0, sp, torch.full_like(sp, -1))
    return (sp >= 0) & (sp <= t) & (sp > t - window)


def timings(kernel, plain, library, flops, nbytes, flush):
    b_ms, b_by = bound(flops, nbytes)
    t = {"ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    if library is not None:
        t["library_ms"] = time_ms(library, flush)
        t["vs_library"] = t["ms"] / t["library_ms"]
    return t


def host_us_per_call(fn, calls=100) -> float:
    """Host time of one call of ``fn`` (a wrapper's checks, its tensor maps
    and its launch) in microseconds, the card left to run behind."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def kernels_of(fn) -> list:
    """Names of the kernels one call of ``fn`` runs on the card: which
    backend a library call took."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted(device_times(prof))


def window_pairs(s, window) -> int:
    """Visible (q, k) pairs of a causal Sq = Sk = ``s`` attention under a
    window of ``window`` positions (row i sees min(i + 1, window) keys)."""
    w = min(s, window)
    return w * (w + 1) // 2 + (s - w) * w


def time_flash(err, qkv, flush, causal=True, window=0):
    q, k, v = qkv
    b, sq, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    gqa = {"enable_gqa": True} if nq != nkv else {}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    # visible (q, k) pairs: causal from position 0 (Sq = Sk), under the
    # window if any, or all of them
    pairs = b * nq * (window_pairs(sq, window or sq) if causal else sq * sk)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()   # q, k, v in; o out
    if window:       # SDPA takes a window only as a mask: row i sees keys (i - window, i]
        i = torch.arange(sq, device=q.device)
        lib = {"attn_mask": (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)}
    else:
        lib = {"is_causal": causal}
    t = timings(
        lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
        lambda: ref.mha_reference(q, k, v, causal=causal, window=window),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib, **gqa),
        4 * hd * pairs, nbytes, flush,
    )
    t["host_us_per_call"] = host_us_per_call(
        lambda: fa.flash_attention(q, k, v, causal=causal, window=window))
    t["library_kernels"] = kernels_of(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, **lib, **gqa))
    kind = ("causal" if causal else "non-causal") + (f" window={window}" if window else "")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:91",
            "shape": f"prefill B={b} Sq={sq} Sk={sk} nq={nq} nkv={nkv} hd={hd} {kind} {q.dtype}",
            "max_abs_err": err, **t}


def time_decode(err, qkvm, flush):
    q, k, v, valid = qkvm
    b, nq, hd = q.shape
    s, nkv = k.shape[1], k.shape[2]
    n_valid = int(valid.sum())
    es = q.element_size()
    gqa = {"enable_gqa": True} if nq != nkv else {}
    qt, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    mask = valid[:, None, None, :]
    # only valid slots' K/V rows need to move: the kernel reads the byte mask
    nbytes = 2 * q.numel() * es + valid.numel() + 2 * n_valid * nkv * hd * es
    t = timings(
        lambda: da.decode_attention(q, k, v, valid),
        lambda: ref.decode_attention_reference(q, k, v, valid),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, **gqa),
        4 * hd * nq * n_valid, nbytes, flush,
    )
    t["host_us_per_call"] = host_us_per_call(lambda: da.decode_attention(q, k, v, valid))
    t["clusters"] = da.clusters_for(b, s, nq, nkv, hd, q.dtype, q.device)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:71",
            "shape": f"decode B={b} S={s} valid={n_valid} nq={nq} nkv={nkv} hd={hd} {q.dtype}",
            "max_abs_err": err, **t}


def phase_kernels(seed, prompt_lengths, long_lengths):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for case in FA_CASES:
            check_flash(gen, *case, dtype)
            n += 1
        # chunked prefill: q at an absolute offset against the full causal result
        q = randn(gen, (1, 64, 4, 32), dtype)
        k = randn(gen, (1, 64, 4, 32), dtype)
        v = randn(gen, (1, 64, 4, 32), dtype)
        out = fa.flash_attention(q[:, 32:].contiguous(), k, v, causal=True, q_offset=32)
        check(f"flash_attention q_offset {dtype}",
              max_err(out, ref.mha_reference(q, k, v, causal=True)[:, 32:]), TOL[dtype])
        for case in DA_CASES:
            check_decode(gen, *case, dtype)
        # one sequence with no valid slot, one with a single one
        valid = torch.rand((3, 100), generator=gen, device=dev) < 0.7
        valid[1] = False
        valid[2] = False
        valid[2, 5] = True
        _, (q, k, v, valid) = check_decode(gen, 3, 100, 8, 2, 64, dtype, valid)
        out = da.decode_attention(q, k, v, valid)
        if bool(out[1].any()):
            raise AssertionError("decode_attention: a sequence with no valid slot is not 0")
        check("decode_attention single valid slot",
              max_err(out[2], v[2, 5].repeat_interleave(4, dim=0)), TOL[dtype])
        n += 2 + len(DA_CASES) + 1 + check_attention_edges(gen, dtype)
    print("[kernels] flash_attention bf16 at |o| up to ~27, largest error in bf16 steps of the "
          "f32 attention: " + json.dumps(check_flash_rounding(dev)))
    print("[kernels] decode_attention bf16 at |o| up to ~24, largest error in bf16 steps of "
          "the f32 attention: " + json.dumps(check_decode_rounding(dev)))
    print("[kernels] flash_attention f32 at |o| up to ~27, largest distance from a float64 "
          "attention (kernel, plain version): " + json.dumps(check_flash_f32_large_outputs(dev)))
    torch.cuda.synchronize()
    print(f"[kernels] {n + 2} test-shape checks passed in f32 and bf16")

    flush = L2Flush(dev)
    # decode at the main path's shapes: each slot valid up to prompt + new tokens
    lengths = [min(CACHE_LEN, p + NEW_TOKENS) for p in prompt_lengths[:SLOTS]]
    valid = prefix_valid(lengths, CACHE_LEN, dev)
    # flash (b, s, nq, nkv, hd) and decode (b, s, nq, nkv, hd, valid) at the
    # main path's shapes (qwen1.5-0.5b), phi3.5-moe's (GQA 32 q heads over 8
    # kv heads, hd 128, the same traffic), kimi-k2's (64 q heads over 8 kv
    # heads, hd 112, the same traffic), llama3-8b's (a random mask) and
    # recurrentgemma-9b's (MQA 16 q heads over 1 kv head, hd 256, the same
    # traffic: its 2048-token window does not bite at S = 512, and its ring
    # of 2048 slots is the main path's cache), minicpm-2b's (36 q over 36 kv
    # heads of 64) and qwen2-72b's (64 q over 8 kv heads of 128), the same
    # traffic, and llama3-8b's sliding-window mode (flash over its longest
    # prompt under the 4096-token window, decode over the wrapped 4096-slot
    # ring of the window traffic after its last step); flash (b, s, nq, nkv,
    # hd, window), causal
    long_valid = ring_valid([n + NEW_TOKENS - 1 for n in long_lengths[:SLOTS]], LONG_CACHE,
                            LONG_CACHE, dev)
    shapes = {"main": ((1, PROMPT_MAX, 16, 16, 64, 0), (SLOTS, CACHE_LEN, 16, 16, 64, valid)),
              MOE_ARCH: ((1, PROMPT_MAX, 32, 8, 128, 0), (SLOTS, CACHE_LEN, 32, 8, 128, valid)),
              "kimi_k2": ((1, PROMPT_MAX, 64, 8, 112, 0), (SLOTS, CACHE_LEN, 64, 8, 112, valid)),
              "llama3_8b": ((1, 2048, 32, 8, 128, 0), (8, 4096, 32, 8, 128, None)),
              "recurrentgemma_9b": ((1, PROMPT_MAX, 16, 1, 256, 0),
                                    (SLOTS, CACHE_LEN, 16, 1, 256, valid)),
              "minicpm_2b": ((1, PROMPT_MAX, 36, 36, 64, 0), (SLOTS, CACHE_LEN, 36, 36, 64, valid)),
              "qwen2_72b": ((1, PROMPT_MAX, 64, 8, 128, 0), (SLOTS, CACHE_LEN, 64, 8, 128, valid)),
              "llama3_8b_window": ((1, LONG_MAX, 32, 8, 128, LONG_CACHE),
                                   (SLOTS, LONG_CACHE, 32, 8, 128, long_valid))}
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        main[dtype] = {}
        for name, (f, d) in shapes.items():
            err_f, qkv = check_flash(gen, f[0], f[1], f[1], *f[2:5], True, f[5], dtype)
            err_d, qkvm = check_decode(gen, *d[:5], dtype, d[5])
            main[dtype][name] = (err_f, qkv, err_d, qkvm)
        print(f"[kernels] main-path, {MOE_ARCH}, {KIMI_ARCH}, llama3-8b, {RG_ARCH}, minicpm-2b, "
              f"qwen2-72b and llama3-8b window shapes {dtype}: max abs err "
              + json.dumps({name: {"flash": r[0], "decode": r[2]}
                            for name, r in main[dtype].items()}))
        print(f"[kernels] llama3-8b window edges {dtype}: max abs err "
              + json.dumps(check_window_edges(gen, dtype)))
    # whisper-small (12 q over 12 kv heads of 64, non-causal flash): the
    # encoder over 1500 frames, the cross-attention of a batch prefill's
    # 4-token prompts and of one decode step (Sq = 1) over those frames, and
    # decode self-attention over its 448-token context, valid up to the
    # prompt and the new tokens
    whisper = {}
    wvalid = prefix_valid([WHISPER_PROMPT + NEW_TOKENS] * SLOTS, WHISPER_CACHE, dev)
    for dtype in (torch.float32, torch.bfloat16):
        whisper[dtype] = {name: check_flash(gen, SLOTS, sq, WHISPER_FRAMES, 12, 12, 64, False, 0,
                                            dtype)
                          for name, sq in (("encoder", WHISPER_FRAMES),
                                           ("cross_prefill", WHISPER_PROMPT), ("cross_decode", 1))}
        whisper[dtype]["decode"] = check_decode(gen, SLOTS, WHISPER_CACHE, 12, 12, 64, dtype, wvalid)
        print(f"[kernels] {WHISPER_ARCH} shapes {dtype}: max abs err "
              + json.dumps({name: r[0] for name, r in whisper[dtype].items()}))
    # the plain version's 2e-2 is ~0.6 of a typical |o| over 1500 keys, so
    # the bf16 outputs are also held within one bf16 step of the f32 attention
    print(f"[kernels] {WHISPER_ARCH} flash bf16, largest error in bf16 steps of the f32 "
          "attention: " + json.dumps(
              {name: check_one_step(name, whisper[torch.bfloat16][name][1], False)
               for name in ("encoder", "cross_prefill", "cross_decode")}))
    rows = []
    for name, (err_f, qkv, err_d, qkvm) in main[torch.bfloat16].items():   # the paths run bf16
        pair = [time_flash(err_f, qkv, flush, window=shapes[name][0][5]),
                time_decode(err_d, qkvm, flush)]
        if name == "main":
            rows = pair
        else:
            rows[0][name], rows[1][name] = pair
    bf = whisper[torch.bfloat16]
    rows[0]["whisper_small"] = time_flash(*bf["encoder"], flush, causal=False)
    rows[0]["whisper_small"]["cross_decode"] = time_flash(*bf["cross_decode"], flush, causal=False)
    rows[1]["whisper_small"] = time_decode(*bf["decode"], flush)
    # recurrentgemma-9b's flash also at a prompt of its window's length
    rows[0]["recurrentgemma_9b"]["s2048"] = time_flash(
        *check_flash(gen, 1, 2048, 2048, 16, 1, 256, True, 0, torch.bfloat16), flush)
    del main, whisper, bf, flush
    torch.cuda.empty_cache()
    return rows


def rwkv_inputs(gen, b, t, h, hd, with_state, dtype, scale=1.0, strong=False):
    """The distribution of tests/test_kernels.py: r, k ~ 0.5 N, v ~ N, w in
    (0.45, 0.95) (strong: exp(-exp(U(-2, 4))), down to 1e-24), u ~ 0.3 N and
    the state ~ 0.2 N in f32; ``scale`` multiplies r, k and v."""
    dev = gen.device
    sh = (b, t, h, hd)
    r, k = (0.5 * scale * randn(gen, sh, torch.float32) for _ in range(2))
    v = scale * randn(gen, sh, torch.float32)
    if strong:
        w = torch.exp(-torch.exp(torch.rand(sh, generator=gen, device=dev) * 6 - 2))
    else:
        w = torch.sigmoid(randn(gen, sh, torch.float32) * 2 - 1) * 0.5 + 0.45
    u = 0.3 * randn(gen, (h, hd), torch.float32)
    s0 = 0.2 * randn(gen, (b, h, hd, hd), torch.float32) if with_state else None
    return [x.to(dtype) for x in (r, k, v, w)] + [u, s0]


def check_rwkv(gen, case, dtype, **kw):
    """Kernel against the plain version: out and final state within
    RWKV_TOL, and finite."""
    args = rwkv_inputs(gen, *case, dtype, **kw)
    out, s_t = rk.rwkv6_scan(*args)
    exp_o, exp_s = ref.rwkv6_reference(*args)
    if out.shape != exp_o.shape or out.dtype != dtype or s_t.dtype != torch.float32:
        raise AssertionError(f"rwkv6_scan {case}: {out.shape} {out.dtype} {s_t.dtype}")
    if not (bool(torch.isfinite(out.float()).all()) and bool(torch.isfinite(s_t).all())):
        raise AssertionError(f"rwkv6_scan {case} {dtype} {kw}: non-finite output")
    err = max(max_err(out, exp_o), max_err(s_t, exp_s))
    check(f"rwkv6_scan {case} {dtype} {kw}", err, RWKV_TOL[dtype])
    return err, args, float(exp_o.float().abs().max())


def check_rwkv_in_place(gen, case, dtype):
    """``final_state=state``: the kernels overwrite the state they read; out
    and state equal those of a separate final state and are within RWKV_TOL
    of the plain version."""
    r, k, v, w, u, s0 = args = rwkv_inputs(gen, *case, dtype)
    out_sep, s_sep = rk.rwkv6_scan(*args)
    state = s0.clone()
    out, s_t = rk.rwkv6_scan(r, k, v, w, u, state, final_state=state)
    if s_t is not state or not (torch.equal(out, out_sep) and torch.equal(state, s_sep)):
        raise AssertionError(f"rwkv6_scan {case} {dtype}: in place differs from a separate state")
    exp_o, exp_s = ref.rwkv6_reference(*args)
    err = max(max_err(out, exp_o), max_err(state, exp_s))
    check(f"rwkv6_scan in place {case} {dtype}", err, RWKV_TOL[dtype])
    return err


def kernel_breakdown(fn, flush, iters=20):
    """Device time per call of each kernel ``fn`` launches, in microseconds,
    from ``torch.profiler`` over ``iters`` calls timed as ``time_ms`` times
    them.  Kernels that overlap (programmatic dependent launch) each count
    their whole span, waits included."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush()
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
            fn()
        torch.cuda.synchronize()
    return {k.split("(")[0].replace("void ", ""): us / iters for k, us in device_times(prof).items()
            if "rwkv6::" in k}


def time_rwkv(err, args, flush):
    r, k, v, w, u, s0 = args
    b, t, h, hd = r.shape
    es = r.element_size()
    # r, k, v, w in and o out once; the state read once and written once
    nbytes = 5 * r.numel() * es + 2 * b * h * hd * hd * 4
    t_ = timings(lambda: rk.rwkv6_scan(*args), lambda: ref.rwkv6_reference(*args), None,
                 4 * hd * hd * b * t * h, nbytes, flush)
    return {"shape": f"B={b} T={t} H={h} hd={hd} state in and out {r.dtype}",
            "max_abs_err": err, **t_,
            "kernels_us": kernel_breakdown(lambda: rk.rwkv6_scan(*args), flush)}


def phase_rwkv_kernel(seed):
    """The scan kernel against its plain version, then its times at
    rwkv6-1.6b's prefill and decode shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, main, edges = 0, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in RWKV_CASES:
            check_rwkv(gen, case, dtype)
            n += 1
        check_rwkv(gen, (1, 64, 1, 16, False), dtype, strong=True)
        # main-path shapes and T = 2048; r, k, v halved so |o| stays below 8,
        # where bf16's step (0.0625 from 8 on) would exceed the tolerance by
        # rounding alone
        main[dtype] = {name: check_rwkv(gen, case, dtype, scale=0.5)
                       for name, case in (("prefill", RWKV_PREFILL), ("decode", RWKV_DECODE))}
        edges[f"T=2048 {dtype}"] = check_rwkv(gen, RWKV_LONG, dtype, scale=0.5)[0]
        for case in RWKV_IN_PLACE:
            edges[f"in place T={case[1]} {dtype}"] = check_rwkv_in_place(gen, case, dtype)
        n += 4 + len(RWKV_IN_PLACE)
        print(f"[kernels] rwkv6_scan main-path shapes {dtype}: " + json.dumps(
            {name: {"max_abs_err": e, "max_abs_out": m} for name, (e, _, m) in main[dtype].items()}))
    edges["strong decay T=100 bf16"] = check_rwkv(
        gen, (1, 100, 4, 64, True), torch.bfloat16, strong=True)[0]
    # the f32 cluster kernel (which training runs) at the served shape
    edges["strong decay T=500 H=32 f32"] = check_rwkv(
        gen, RWKV_PREFILL, torch.float32, strong=True)[0]
    n += 2
    print("[kernels] rwkv6_scan long T, strong decay, in place: max abs err " + json.dumps(edges))
    torch.cuda.synchronize()
    print(f"[kernels] rwkv6_scan: {n} checks passed in f32 and bf16")
    flush = L2Flush(dev)
    bf = main[torch.bfloat16]         # the main path runs bf16
    row = {"name": "rwkv6_scan", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
           "replaces": "src/repro/kernels/rwkv6_scan.py:93",
           **time_rwkv(*bf["prefill"][:2], flush),
           "library_why": "no single PyTorch call computes the WKV recurrence"}
    row["decode"] = time_rwkv(*bf["decode"][:2], flush)
    # the f32 kernel (which training runs) at the served prefill's shape
    row["f32_prefill"] = time_rwkv(*main[torch.float32]["prefill"][:2], flush)
    # the floor of a decode step under this timing: a copy of its state (the
    # flush leaves the L2 dirty, so every line brought in is also written back)
    s0 = bf["decode"][1][5]
    copy = torch.empty_like(s0)
    row["decode"]["state_copy_ms"] = time_ms(lambda: copy.copy_(s0), flush)
    row["checks_max_abs_err"] = edges
    del main, bf, flush
    torch.cuda.empty_cache()
    return row


# ---------------------------------------------------------------------------
# Phase 3: the slices.
# ---------------------------------------------------------------------------
def launch_counts():
    return {name: mod.launches for name, mod in KERNELS.items()}


def expected_launches(cfg, prefills, decode_steps):
    """What each kernel must have launched for ``prefills`` prefills and
    ``decode_steps`` decode steps: every attention layer (global or local)
    runs flash attention in prefill and flash decode per step, every RWKV-6
    layer the scan in both; RG-LRU layers launch none of them.  Whisper's
    encoder layers run flash attention in each prefill, and its decoder
    layers' cross-attention runs it in each prefill and each step."""
    kinds = cfg.layer_kinds()
    n_attn = sum(k in (ATTN, LOCAL_ATTN) for k in kinds)
    n_rwkv = kinds.count(RWKV)
    flash = n_attn * prefills
    if cfg.is_encoder_decoder:
        flash += (cfg.encoder_layers + cfg.num_layers) * prefills + cfg.num_layers * decode_steps
    return {"flash_attention": flash, "decode_attention": n_attn * decode_steps,
            "rwkv6_scan": n_rwkv * (prefills + decode_steps)}


def phase_slice(cfg, seed, prompts, gpu, f32, *, cache_len=CACHE_LEN, window=0,
                prefill_length=PROMPT_MAX, label=None):
    """Serve ``prompts`` with ``cfg`` at full width in bf16 (an engine of
    SLOTS slots and ``cache_len`` cache slots, in sliding-window mode when
    ``window``), profile its decode and a ``prefill_length``-token prefill
    (``profile_prefill``), then run its f32 check ``f32(seed, prompt)``,
    which holds its f32 logits on the card to the CPU's.  ``label`` names
    the slice (the arch by default)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    arch = cfg.name
    label = label or arch
    n_requests = len(prompts)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    engine = Engine(cfg, params, EngineConfig(
        slots=SLOTS, cache_len=cache_len, window=window, max_new_tokens=NEW_TOKENS,
        dtype=torch.bfloat16, device="cuda"))
    batcher = ContinuousBatcher(engine)
    spent = {"insert": [], "step": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name].append(time.perf_counter() - t0)
            return out
        return run

    engine.insert = timed("insert", engine.insert)
    engine.step = timed("step", engine.step)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]
    for r in reqs:
        batcher.submit(r)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    stats = batcher.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    bad = [r.rid for r in reqs if not r.finished or len(r.output) != 1 + NEW_TOKENS]
    if bad:
        raise AssertionError(f"{arch}: requests not finished with 1 + {NEW_TOKENS} tokens: {bad}")
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.output):
        raise AssertionError(f"{arch}: a token outside the vocabulary")
    expected = expected_launches(cfg, n_requests, engine.steps)
    if launches != expected or not any(launches.values()):
        raise AssertionError(f"{label}: kernel launches {launches} != {expected} "
                             f"({cfg.num_layers} layers, {n_requests} prefills, "
                             f"{engine.steps} decode steps)")
    n_tokens = sum(len(r.output) for r in reqs)
    result = {
        "model": arch, "slice": label, "dtype": "bfloat16", "layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
        "requests": n_requests, "slots": SLOTS, "cache_len": cache_len, "window": window,
        "new_tokens": NEW_TOKENS,
        "prompt_tokens": int(sum(len(p) for p in prompts)),
        "decode_steps": engine.steps, "batch_stats": stats.summary(),
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "prefill_ms_mean": 1e3 * float(np.mean(spent["insert"])),
        "prefill_ms_per_prompt_token": 1e3 * sum(spent["insert"]) / sum(len(p) for p in prompts),
        "decode_ms_per_step_median": 1e3 * float(np.median(spent["step"])),
        "peak_mem_gib": peak / 2**30,
        "launches": launches,
        "gpu": gpu,
    }
    moe = bool(cfg.num_experts)
    if cfg.num_layers < get_config(arch).num_layers:
        result["layers_full"] = get_config(arch).num_layers
        result["depth_cut"] = DEPTH_CUTS[arch]
        print(f"[cut] {label}: {DEPTH_CUTS[arch]}")
    if moe:
        result["moe_sync_free"] = check_moe_sync_free(cfg, params["layers"][0]["moe"])
    print(f"[slice] {label}: served {n_requests} requests of {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} prompt tokens with {1 + NEW_TOKENS} tokens each "
          f"over {engine.steps} decode steps (cache {cache_len}, window {window}); kernel "
          f"launches {json.dumps(launches)} = {json.dumps(expected_launches(cfg, 1, 1))} per "
          f"(prefill, decode step) x ({n_requests} prefills, {engine.steps} decode steps)")
    t_profiles = time.perf_counter()
    with moe_ranges() if moe else contextlib.nullcontext():
        prof = profile_decode(engine, prompts, PROFILED[arch]["decode"])
        prof["device_busy_share_of_median_step"] = (
            prof["device_ms_per_step"] / result["decode_ms_per_step_median"])
        result["decode_profile"] = prof
        result["prefill_profile"] = profile_prefill(engine, prompts[0], PROFILED[arch]["prefill"],
                                                    length=prefill_length)
    # the timing wrappers refer back to the engine: collect the cycle, so
    # that the next slice's peak memory does not count this one's weights
    del engine, batcher, params
    gc.collect()
    torch.cuda.empty_cache()
    t_f32 = time.perf_counter()
    result["f32_check"] = f32(seed, prompts[0])
    result["phase_s"] = time.perf_counter() - t_phase
    result["seconds"] = phase_seconds(t_phase, t0, t_profiles, t_f32)
    return result


def phase_seconds(t_phase, t_serve, t_profiles, t_f32) -> dict:
    """Host seconds of a served slice's parts, from the start of each: the
    weights and engine, the served run, the profiles (and checks after the
    run), the f32 check to now."""
    now = time.perf_counter()
    return {"setup": t_serve - t_phase, "served_run_and_checks": t_profiles - t_serve,
            "profiles": t_f32 - t_profiles, "f32_check": now - t_f32}


@contextlib.contextmanager
def wrapped(module, name, wrapper):
    """``module.<name>`` replaced by ``wrapper(original)`` inside the block:
    the port's code looks its helpers up in the module at each call."""
    original = getattr(module, name)
    setattr(module, name, wrapper(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def in_range(label):
    """A wrapper that runs the function inside the profiler range ``label``."""
    def wrapper(fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return run
    return wrapper


@contextlib.contextmanager
def moe_ranges():
    """Every MOE_RANGES function of the MoE module inside its profiler range."""
    with contextlib.ExitStack() as stack:
        for label, name in MOE_RANGES.items():
            stack.enter_context(wrapped(moe_lib, name, in_range(f"moe.{label}")))
        yield


def check_moe_sync_free(cfg, p):
    """The MoE layer at the served decode (all slots) and prefill (512
    tokens) shapes under the sync debug mode "error": any op of it that
    waits on the card raises."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(SLOTS, 1, cfg.d_model), (1, PROMPT_MAX, cfg.d_model)]
    xs = [randn(gen, shape, torch.bfloat16) for shape in shapes]
    for x in xs:                                 # warm-up
        moe_lib.moe_sort_local(cfg, p, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ys = [moe_lib.moe_sort_local(cfg, p, x)[0] for x in xs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not all(bool(torch.isfinite(y.float()).all()) for y in ys):
        raise AssertionError("the MoE layer gave non-finite values")
    return {"shapes": [list(sh) for sh in shapes], "sync_debug_mode": "error"}


def f32_check(cfg, seed, prompt, fill=None, enc_inputs=None, image=None, window=0):
    """The same port code in f32 with the kernels on the card and the plain
    versions on the CPU, on one prompt plus F32_DECODE_STEPS decode steps;
    ``fill(params, gen)`` may first change the weights on the card,
    ``enc_inputs`` (1, frames, d) on the CPU are whisper's audio, ``image``
    (patches, d) on the CPU a VLM's patch embeddings ahead of the prompt's
    (``_teacher_forced``), and ``window`` runs the sliding-window mode over
    a ring of ``window`` slots.  An MoE model's experts chosen must also be
    the same on both sides."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    p_gpu = model_lib.init_params(cfg, gen, dtype=torch.float32, device=dev)
    if fill is not None:
        fill(p_gpu, gen)
    p_cpu = _tree_to(p_gpu, "cpu")
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    before = launch_counts()
    card_routes, cpu_routes = [], []
    with wrapped(moe_lib, "_route", record_routes(card_routes)):
        gpu_logits, tokens = _teacher_forced(cfg, p_gpu, prompt, None, dev, enc_inputs,
                                             image, window)
    ran = {name: n - before[name] for name, n in launch_counts().items()}
    if ran != expected_launches(cfg, 1, F32_DECODE_STEPS):
        raise AssertionError(f"the f32 run on the card did not go through the kernels: {ran}")
    with wrapped(moe_lib, "_route", record_routes(cpu_routes)):
        cpu_logits, _ = _teacher_forced(cfg, p_cpu, prompt, tokens, torch.device("cpu"),
                                        enc_inputs, image, window)
    checked = compare_routes(cfg, card_routes, cpu_routes) if cfg.num_experts else {}
    errs = []
    for step, (g, c) in enumerate(zip(gpu_logits, cpu_logits)):
        if g.shape != (1, cfg.vocab_size) or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"f32 step {step}: bad logits {tuple(g.shape)}")
        errs.append(max_err(g.cpu(), c))
    check(f"{cfg.name} f32 logits card vs CPU", max(errs), LOGIT_TOL)
    del p_gpu, p_cpu
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "prompt_tokens": len(prompt),
            **({"image_patches": len(image)} if image is not None else {}),
            **({"window": window, "ring_slots": window} if window else {}),
            "decode_steps": F32_DECODE_STEPS, "max_abs_err_per_step": errs, "tol": LOGIT_TOL,
            **checked}


def f32_check_rwkv(seed, prompt):
    """The RWKV path's f32 check at full width and RWKV_F32_LAYERS layers,
    on a RWKV_F32_PROMPT-token prompt (prefill in chunks of 32, 32 and 13,
    then one-token launches), with the zero-initialised leaves ``mu``,
    ``cm_mu``, ``w0`` and ``u`` filled with noise of scale 0.3 so that the
    token shift and the bonus are exercised.  Tolerance LOGIT_TOL, as for
    attention: the same f32 arithmetic in another order (the chunked scan
    sums log-decays where the plain version multiplies decays, ~1e-6
    relative), through 4 residual layers to logits of size ~1."""
    cfg = dataclasses.replace(get_config(RWKV_ARCH), num_layers=RWKV_F32_LAYERS)
    return f32_check(cfg, seed, np.resize(prompt, RWKV_F32_PROMPT), fill_rwkv_leaves)


def fill_rwkv_leaves(params, gen):
    """RWKV's zero-initialised leaves (``mu``, ``cm_mu``, ``w0``, ``u``)
    filled with 0.3 N from ``gen``, so that the token shift and the bonus
    carry weight."""
    for layer in params["layers"]:
        for name in F32_LEAVES:
            leaf = layer["rwkv"][name]
            leaf.copy_(0.3 * randn(gen, leaf.shape, torch.float32))


def f32_check_moe(seed, prompt):
    """phi3.5-moe's f32 check at full width and MOE_F32_LAYERS layers on a
    MOE_F32_PROMPT-token prompt (capacity 16 in prefill, 8 in each one-token
    step, so nothing drops).  Card and CPU sum the router product in other
    orders, so a token whose k-th and (k+1)-th logits nearly tie could
    choose another expert and then differ by O(1): the experts chosen in
    every layer and call are recorded on both sides and must be equal, which
    is checked before the logits."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_F32_LAYERS)
    return f32_check(cfg, seed, np.resize(prompt, MOE_F32_PROMPT))


def f32_check_kimi(seed, prompt):
    """kimi-k2's f32 check at full attention width (d 7168, 64 q heads over
    8 kv heads of 112) and KIMI_LAYERS layer, with its experts cut to
    KIMI_F32_EXPERTS (top-8 kept) and its vocabulary to KIMI_F32_VOCAB, on a
    KIMI_F32_PROMPT-token prompt; the experts chosen must be equal card vs
    CPU, then the logits within LOGIT_TOL (``f32_check_moe``'s reasons)."""
    cfg = dataclasses.replace(get_config(KIMI_ARCH), num_layers=KIMI_LAYERS,
                              num_experts=KIMI_F32_EXPERTS, vocab_size=KIMI_F32_VOCAB)
    out = f32_check(cfg, seed, np.resize(prompt, KIMI_F32_PROMPT) % KIMI_F32_VOCAB)
    out["cuts"] = {"layers": f"{KIMI_LAYERS} of 61", "experts": f"{KIMI_F32_EXPERTS} of 384, top-8 kept",
                   "vocab": f"{KIMI_F32_VOCAB} of 163840",
                   "kept": "d_model 7168, 64 q heads over 8 kv heads of 112, expert ff 2048"}
    return out


def f32_check_rg(seed, prompt):
    """recurrentgemma-9b's f32 check at full width and RG_F32_LAYERS layers
    (the pattern once and the tail) on a RG_F32_PROMPT-token prompt: longer
    than the 2048-token window, so flash attention's window masks keys and
    the prefill wraps the 2048-slot ring; the decode steps then write over
    its oldest slots.  Tolerance LOGIT_TOL, as for attention: the RG-LRU's
    log-depth scan is the same PyTorch ops on both sides."""
    cfg = dataclasses.replace(get_config(RG_ARCH), num_layers=RG_F32_LAYERS)
    return f32_check(cfg, seed, np.resize(prompt, RG_F32_PROMPT))


def f32_check_cut(arch, layers):
    """The f32 check (``f32_check``, its keywords passed on) of ``arch`` at
    full width and ``layers`` layers; the cut is stated in the result."""
    def run(seed, prompt, **kw):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        out = f32_check(cfg, seed, prompt, **kw)
        out["cuts"] = {"layers": f"{layers} of {get_config(arch).num_layers}"}
        return out
    return run


def f32_check_long(seed, prompt):
    """llama3-8b's f32 check in sliding-window mode at full width and
    LONG_F32_LAYERS layers, on a LONG_F32_PROMPT-token prompt, longer than
    the cfg.long_context_window-slot ring and window: the prefill's flash
    attention masks keys past the window and keeps the prompt's tail in the
    ring, and the decode steps write over its oldest slots.  Tolerance
    LOGIT_TOL, as for attention."""
    return f32_check_cut(LLAMA_ARCH, LONG_F32_LAYERS)(
        seed, np.resize(prompt, LONG_F32_PROMPT),
        window=get_config(LLAMA_ARCH).long_context_window)


# ---------------------------------------------------------------------------
# Phase 3e: whisper-small, served at the model's entry points.
# ---------------------------------------------------------------------------
def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_numel(v) for v in tree)
    return tree.numel()


def whisper_floors(cfg, params, batch, valid_slots):
    """The least device time of a decode step and of a batch prefill, from
    the shapes.  A step reads every decoder weight but the cross-attention's
    K/V projections (their output is cached), the final norm and the
    unembedding, all layers' cross-attention K/V and the self-attention
    cache's valid rows (the token embedding gathers 8 rows): bytes bound
    it.  A prefill multiplies every frame through the encoder's products and
    each decoder layer's cross K/V projections, runs the encoder's attention
    over all frame pairs, and the prompt through the decoder and the last
    row through the unembedding: operations bound it."""
    es = params["embed"].element_size()
    hd, nq, nkv, L = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
    xkv = lambda p: _numel({k: v for k, v in p["xattn"].items() if k in ("wk", "wv", "bk", "bv")})
    dec = sum(_numel(p) - xkv(p) for p in params["layers"])
    head = _numel(params["lm_head"]) + _numel(params["final_norm"])
    kv_row = 2 * nkv * hd                                  # K and V of one position
    step_bytes = es * (dec + head + L * batch * kv_row * (WHISPER_FRAMES + valid_slots))
    enc_w = sum(_numel(p["attn"]) + _numel(p["mlp"]) for p in params["encoder"]["blocks"])
    frames = batch * WHISPER_FRAMES
    prefill_ops = (2 * frames * (enc_w + sum(xkv(p) for p in params["layers"]))
                   + cfg.encoder_layers * 4 * hd * batch * nq * WHISPER_FRAMES ** 2
                   + 2 * batch * WHISPER_PROMPT * dec + 2 * batch * _numel(params["lm_head"]))
    return {"decode_step_bytes": step_bytes, "decode_step_floor_ms": 1e3 * step_bytes / PEAK_BYTES,
            "prefill_operations": prefill_ops,
            "prefill_floor_ms": 1e3 * prefill_ops / PEAK_BF16_FLOPS}


def generate(cfg, params, inputs, steps, spent, cache_len, enc_inputs=None):
    """Greedy tokens of one batch at the model's entry points: ``init_cache``
    of ``cache_len`` slots, ``prefill(inputs, enc_inputs=)`` (``inputs`` the
    prompts' tokens (B, S) or a VLM's embeddings (B, S, d); ``enc_inputs``
    whisper's frames) and ``steps`` decode steps, each timed on the host
    clock between syncs into ``spent``; returns (B, 1 + steps) tokens on
    the host."""
    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        spent[name].append(time.perf_counter() - t0)
        return out

    def prefill():
        cache = model_lib.init_cache(cfg, inputs.shape[0], cache_len,
                                     dtype=params["embed"].dtype, device=inputs.device)
        return model_lib.prefill(cfg, params, inputs, cache, enc_inputs=enc_inputs)

    logits, cache = timed("prefill", prefill)
    out = [torch.argmax(logits, dim=-1)]
    for _ in range(steps):
        logits, cache = timed("step", lambda: model_lib.decode_step(cfg, params, out[-1], cache))
        out.append(torch.argmax(logits, dim=-1))
    if not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return torch.stack(out, dim=1).cpu()


# every kernel of the flash library, by name: bf16 and f32 at every hd
FLASH_KERNELS = ("fa_wgmma_kernel", "fa_tf32_kernel")


def check_only_kernel(by_kernel, family, expected) -> None:
    """Every kernel of ``family`` (name patterns) in a profile is one of
    ``expected``: the bf16 flash launches of a served run are all the
    wgmma kernel, the f32 ones of a training step the tf32 one."""
    other = [k for k in by_kernel if any(p in k for p in family)
             and not any(p in k for p in expected)]
    if other:
        raise AssertionError(f"kernels other than {expected} in the profile: {other}")


FLASH_KINDS = ("encoder", "self", "cross")


def flash_by_kind(kinds):
    """A wrapper of the flash kernel's entry that appends what each call
    attends to ``kinds`` and runs it inside the profiler range
    ``flash.<kind>``: ``self`` (causal, the decoder's prompt), ``encoder``
    (non-causal, Sq = Sk, the frames) or ``cross`` (non-causal, decoder rows
    over the frames)."""
    def wrapper(flash):
        def run(q, k, v, *, causal=True, **kw):
            kind = "self" if causal else ("encoder" if q.shape[1] == k.shape[1] else "cross")
            kinds.append(kind)
            with torch.profiler.record_function(f"flash.{kind}"):
                return flash(q, k, v, causal=causal, **kw)
        return run
    return wrapper


def flash_split(prof, kinds, launched, per, suffix):
    """Device ms (per ``per`` calls of the profiled work) of the flash
    kernel by what it attended: ``read_profile`` matches each kernel
    launched inside a ``flash.<kind>`` range (its runtime call, through
    ctypes) to the range by correlation id.  The count is held on the
    wrapper's launch counter: ``launched`` launches for the ``kinds`` calls.
    A kernel the profiler drops (one proof run of the earlier tree saw 95
    flash kernels for 96 calls, with every launch counted) is then missing
    from the split only, and ``flash_kernels_in_profile`` shows it."""
    if launched != len(kinds):
        raise AssertionError(f"{launched} flash launches for {len(kinds)} calls")
    _, ms, n, _ = read_profile(prof, tuple(f"flash.{kind}" for kind in FLASH_KINDS))
    out = {f"flash_{kind}{suffix}": ms[f"flash.{kind}"] / per / 1e3 for kind in FLASH_KINDS}
    out["flash_launches"] = launched
    out["flash_kernels_in_profile"] = sum(n.values())
    return out


def profile_whisper(cfg, params, frames, prompt, steps=8):
    """Device time of one batch prefill and of ``steps`` decode steps after
    it, from ``torch.profiler``: busy share of the host-clock window, the
    flash kernel's time split into encoder, self and cross
    (``flash_split``), the decode kernel's (the decoder's self-attention),
    and the kernels that take the most."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cache = model_lib.init_cache(cfg, prompt.shape[0], WHISPER_CACHE,
                                 dtype=params["embed"].dtype, device=prompt.device)
    result, kinds = {}, []
    with wrapped(fa, "flash_attention", flash_by_kind(kinds)):
        for name, per in (("prefill", 1), ("decode", steps)):
            kinds.clear()
            before, dec_before = fa.launches, da.launches
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if name == "prefill":
                    logits, cache = model_lib.prefill(cfg, params, prompt, cache,
                                                      enc_inputs=frames)
                    tok = torch.argmax(logits, dim=-1)
                else:
                    for _ in range(steps):
                        logits, cache = model_lib.decode_step(cfg, params, tok, cache)
                        tok = torch.argmax(logits, dim=-1)
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            by_kernel = device_times(prof)
            busy = sum(by_kernel.values())
            flash = kernel_time(by_kernel, ("fa_wgmma_kernel",))
            check_only_kernel(by_kernel, FLASH_KERNELS, ("fa_wgmma_kernel",))
            dec = kernel_time(by_kernel, DECODE_KERNELS) if per > 1 else 0
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
            suffix = "_ms" if per == 1 else "_ms_per_step"
            r = {"profiled_wall" + suffix: wall_us / per / 1e3, "device" + suffix: busy / per / 1e3,
                 "device_busy_share_profiled": busy / wall_us,
                 "flash_attention" + suffix: flash / per / 1e3,
                 "flash_attention_share_of_device": flash / busy,
                 **flash_split(prof, kinds, fa.launches - before, per, suffix),
                 "top_kernels" + suffix: {k[:80]: us / per / 1e3 for k, us in top}}
            if per > 1:
                r.update({"steps": steps, "decode_attention" + suffix: dec / per / 1e3,
                          "decode_attention_share_of_device": dec / busy,
                          **decode_kernels_a_call(prof, da.launches - dec_before)})
            result[name] = r
    return result


def phase_whisper(seed, gpu):
    """whisper-small at full width and depth in bf16 through ``init_cache``,
    ``prefill(enc_inputs=)`` and ``decode_step``, batched, as the JAX
    package serves it (its engine's requests carry no audio): every
    encoder, self- and cross-attention call through the flash kernel and
    every decode self-attention call through the decode kernel, by the
    launch counters; then the profile and the f32 check at full depth."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(WHISPER_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(seed)
    batches = [
        (torch.from_numpy(frontends.audio_frames(cfg, SLOTS, seed=seed + i)).to(dev, torch.bfloat16),
         torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(SLOTS, WHISPER_PROMPT)),
                         dtype=torch.long, device=dev))
        for i in range(WHISPER_BATCHES)]
    spent = {"prefill": [], "step": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    tokens = [generate(cfg, params, prompt, NEW_TOKENS, spent, WHISPER_CACHE, enc_inputs=frames)
              for frames, prompt in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = WHISPER_BATCHES * NEW_TOKENS
    if any(t.shape != (SLOTS, 1 + NEW_TOKENS) for t in tokens):
        raise AssertionError(f"{cfg.name}: tokens of shapes {[tuple(t.shape) for t in tokens]}")
    if not all(bool(((t >= 0) & (t < cfg.vocab_size)).all()) for t in tokens):
        raise AssertionError(f"{cfg.name}: a token outside the vocabulary")
    expected = expected_launches(cfg, WHISPER_BATCHES, steps)
    if launches != expected:
        raise AssertionError(f"{cfg.name}: kernel launches {launches} != {expected} "
                             f"({cfg.encoder_layers} + {cfg.num_layers} layers, "
                             f"{WHISPER_BATCHES} batch prefills, {steps} decode steps)")
    print(f"[slice] {cfg.name}: served {WHISPER_BATCHES * SLOTS} requests of {WHISPER_FRAMES} "
          f"frames and {WHISPER_PROMPT} prompt tokens with {1 + NEW_TOKENS} tokens each over "
          f"{steps} decode steps; kernel launches {json.dumps(launches)} = "
          f"{json.dumps(expected_launches(cfg, 1, 0))} per batch prefill + "
          f"{json.dumps(expected_launches(cfg, 0, 1))} per decode step")
    n_tokens = sum(t.numel() for t in tokens)
    result = {
        "model": cfg.name, "dtype": "bfloat16", "layers": cfg.num_layers,
        "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
        "params": model_lib.param_count(cfg), "requests": WHISPER_BATCHES * SLOTS,
        "batches": WHISPER_BATCHES, "slots": SLOTS, "frames": WHISPER_FRAMES,
        "prompt_tokens": WHISPER_PROMPT, "cache_len": WHISPER_CACHE, "new_tokens": NEW_TOKENS,
        "decode_steps": steps, "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "prefill_ms_mean": 1e3 * float(np.mean(spent["prefill"])),
        "decode_ms_per_step_median": 1e3 * float(np.median(spent["step"])),
        "peak_mem_gib": peak / 2**30, "launches": launches, "gpu": gpu,
        "floors": whisper_floors(cfg, params, SLOTS, WHISPER_PROMPT + NEW_TOKENS),
    }
    prof = profile_whisper(cfg, params, *batches[0])
    prof["decode"]["device_busy_share_of_median_step"] = (
        prof["decode"]["device_ms_per_step"] / result["decode_ms_per_step_median"])
    result["decode_profile"], result["prefill_profile"] = prof["decode"], prof["prefill"]
    prompt = batches[0][1][0].cpu().numpy()          # the first request's, and its audio:
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()
    result["f32_check"] = f32_check(
        cfg, seed, prompt, enc_inputs=torch.from_numpy(frontends.audio_frames(cfg, 1, seed=seed)))
    result["phase_s"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# Phase 3k: llava-next-mistral-7b's backbone, served at the model's entry points.
# ---------------------------------------------------------------------------
def vlm_inputs(cfg, params, text, seed):
    """(B, VLM_TILES * 576 + S_text, d) embeddings on the card, laid out as
    ``frontends.multimodal_inputs`` lays them: the seeded patch embeddings
    (``frontends.vision_embeddings``), then the rows of the text tokens
    ``text`` (B, S_text) gathered from the card's embedding table."""
    img = frontends.vision_embeddings(cfg, text.shape[0], tiles=VLM_TILES, seed=seed)
    table = params["embed"]
    return torch.cat([torch.from_numpy(img).to(table.device, table.dtype), table[text]], dim=1)


def phase_vlm(seed, texts, gpu):
    """llava-next-mistral-7b's language backbone at full width and depth in
    bf16 through ``init_cache``, ``prefill`` on (B, S, d) embeddings and
    batched ``decode_step`` (the engine and ``launch/serve.py`` take no
    image, in both packages): VLM_BATCHES batches of SLOTS requests, each
    one's patches and its ``texts`` prompt, every prefill attention call
    through the flash kernel and every decode one through the decode
    kernel, by the launch counters; then the profiles and the f32 check at
    VLM_F32_LAYERS layers on the first request."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(VLM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    batches = [vlm_inputs(cfg, params, torch.as_tensor(t, dtype=torch.long, device=dev), seed + i)
               for i, t in enumerate(texts)]
    spent = {"prefill": [], "step": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    tokens = [generate(cfg, params, x, NEW_TOKENS, spent, VLM_CACHE) for x in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = VLM_BATCHES * NEW_TOKENS
    if any(t.shape != (SLOTS, 1 + NEW_TOKENS) for t in tokens):
        raise AssertionError(f"{cfg.name}: tokens of shapes {[tuple(t.shape) for t in tokens]}")
    if not all(bool(((t >= 0) & (t < cfg.vocab_size)).all()) for t in tokens):
        raise AssertionError(f"{cfg.name}: a token outside the vocabulary")
    expected = expected_launches(cfg, VLM_BATCHES, steps)
    if launches != expected:
        raise AssertionError(f"{cfg.name}: kernel launches {launches} != {expected} "
                             f"({cfg.num_layers} layers, {VLM_BATCHES} batch prefills, "
                             f"{steps} decode steps)")
    seq = batches[0].shape[1]
    print(f"[slice] {cfg.name}: served {VLM_BATCHES * SLOTS} requests of "
          f"{VLM_TILES * frontends.VLM_BASE_PATCHES} patch embeddings and {VLM_TEXT} prompt "
          f"tokens with {1 + NEW_TOKENS} tokens each over {steps} decode steps; kernel launches "
          f"{json.dumps(launches)} = {json.dumps(expected_launches(cfg, 1, 0))} per batch "
          f"prefill + {json.dumps(expected_launches(cfg, 0, 1))} per decode step")
    result = {
        "model": cfg.name, "slice": cfg.name, "dtype": "bfloat16", "layers": cfg.num_layers,
        "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim],
        "params": model_lib.param_count(cfg), "requests": VLM_BATCHES * SLOTS,
        "batches": VLM_BATCHES, "slots": SLOTS, "tiles": VLM_TILES,
        "image_patches": VLM_TILES * frontends.VLM_BASE_PATCHES, "prompt_tokens": VLM_TEXT,
        "prefill_seq": seq, "cache_len": VLM_CACHE, "new_tokens": NEW_TOKENS,
        "decode_steps": steps, "wall_s": wall,
        "tokens_per_s": sum(t.numel() for t in tokens) / wall,
        "prefill_ms_mean": 1e3 * float(np.mean(spent["prefill"])),
        "prefill_ms_per_prompt_token": 1e3 * sum(spent["prefill"]) / (VLM_BATCHES * SLOTS * seq),
        "decode_ms_per_step_median": 1e3 * float(np.median(spent["step"])),
        "peak_mem_gib": peak / 2**30, "launches": launches, "gpu": gpu,
    }
    t_profiles = time.perf_counter()
    cache = model_lib.init_cache(cfg, SLOTS, VLM_CACHE, dtype=torch.bfloat16, device=dev)
    logits, cache = model_lib.prefill(cfg, params, batches[0], cache)
    state = {"tok": torch.argmax(logits, dim=-1), "cache": cache}

    def step():
        out, state["cache"] = model_lib.decode_step(cfg, params, state["tok"], state["cache"])
        state["tok"] = torch.argmax(out, dim=-1)

    prof = profile_steps(step, PROFILED[VLM_ARCH]["decode"])
    prof["device_busy_share_of_median_step"] = (
        prof["device_ms_per_step"] / result["decode_ms_per_step_median"])
    result["decode_profile"] = prof
    del state, cache, logits
    one = Engine(cfg, params, EngineConfig(slots=1, cache_len=VLM_CACHE, dtype=torch.bfloat16,
                                           device="cuda"))
    result["prefill_profile"] = profile_prefill(one, None, PROFILED[VLM_ARCH]["prefill"],
                                                inputs=batches[0][:1])
    text = np.asarray(texts[0][0])                     # the first request's, and its image:
    del params, batches, one
    gc.collect()
    torch.cuda.empty_cache()
    image = torch.from_numpy(frontends.vision_embeddings(cfg, 1, tiles=VLM_TILES, seed=seed)[0])
    t_f32 = time.perf_counter()
    result["f32_check"] = f32_check_cut(VLM_ARCH, VLM_F32_LAYERS)(seed, text, image=image)
    result["phase_s"] = time.perf_counter() - t_phase
    result["seconds"] = phase_seconds(t_phase, t0, t_profiles, t_f32)
    return result



# ---------------------------------------------------------------------------
# Phase 4: the control plane, the batched tick engine on the card.
# ---------------------------------------------------------------------------
# the JAX package's own benchmark shapes (benchmarks/sim_throughput.py):
# a fleet of FLEET_ARCHS archs over SCAN_TICKS ticks of the shared_berkeley
# scenario, and a grid of GRID_CELLS cells (the four GRID_SCENARIOS x 16
# seeds) of GRID_ARCHS archs over the same number of ticks; one cut,
# CONTROL_CUT: SCAN_TICKS, SAME_TICKS and PROFILE_TICKS, for time
SERVING_POOL = ["llama3-8b", "qwen1.5-0.5b", "rwkv6-1.6b", "minicpm-2b", "whisper-small",
                "llava-next-mistral-7b", "recurrentgemma-9b", "phi3.5-moe-42b-a6.6b"]
FLEET_ARCHS, SCAN_TICKS, STRICT_FRAC = 1024, 600, 0.25
GRID_CELLS, GRID_ARCHS, GRID_MEAN_RPS = 64, 16, 400.0
GRID_SCENARIOS = ("shared_berkeley", "diurnal_phases", "mmpp_bursts", "flash_correlated")
# grid cells held to the NumPy engine and to run_scenario: all four scenarios
GRID_SAMPLE = (0, 9, 18, 27, 36, 45, 54, 63)
# the grid = run_scenario check runs the grid again over the first
# SAME_TICKS ticks of every cell and each sampled cell alone over them
SAME_TICKS = 150
PROFILE_TICKS = 50
CONTROL_CUT = ("the fleet and grid runs over 600 of the benchmark's 3600 ticks, the grid = "
               "run_scenario check over 150 of 600 and the profiles over 50 of 100 ticks, so "
               "that the run, with the served slices 3g-3k, stays within 900 s: the uncut "
               "phase took 241 s, at 1200, 300 and 100 ticks 134.5 s, on an "
               "H100 80GB HBM3 at 700 W")
# the contract of tests/test_torch_sim_engine.py (and the reference's
# tests/test_jax_engine.py): raw ledger totals and per-arch flows
SIM_RTOL = SIM_ATOL = 1e-6
PER_ARCH_FLOWS = ("served_vm", "served_burst", "dropped", "violations", "acc_weight",
                  "acc_violations")


def numpy_run(arrivals, wl, policy, seed):
    """The port's NumPy engine (the oracle) driven by the vector scheduler."""
    sim = core_sim.ServingSim(arrivals, wl, seed=seed)
    pol = RLPoolPolicy(greedy=True) if policy == "rl_pool" else VECTOR_SCHEDULERS[policy]()
    while not sim.done:
        sim.apply_pool(pol(sim.tick, sim.observe_pool()))
    return sim


def raw_ledger(res):
    """A ``SimResult``'s unrounded ledger, as the torch engine's
    ``_assemble`` names it (``out["ledger"]``)."""
    return {"cost_reserved": res.cost_reserved, "cost_spot": res.cost_spot,
            "cost_burst": res.cost_burst, "cost_harvest": res.cost_other.get("harvest", 0.0),
            "cost_remote": res.cost_other.get("remote", 0.0), "violations": res.violations,
            "violations_strict": res.violations_strict, "served_vm": res.served_vm,
            "served_burst": res.served_burst, "preemptions": float(res.preemptions),
            "chip_seconds": res.chip_seconds, "chip_seconds_needed": res.chip_seconds_needed,
            "chip_seconds_over": res.chip_seconds_over,
            "accuracy_weighted": res.accuracy_weighted,
            "accuracy_served": res.accuracy_served, "acc_violations": res.acc_violations}


def hold_to_numpy(name, out, sim) -> float:
    """Raise unless the torch engine's raw ledger and per-arch flows are
    within SIM_RTOL / SIM_ATOL of the NumPy engine's and their summaries
    have the same keys; returns the largest relative ledger error."""
    want, got = raw_ledger(sim.res), out["ledger"]
    worst = 0.0
    for k, w in want.items():
        if not abs(got[k] - w) <= SIM_ATOL + SIM_RTOL * abs(w):
            raise AssertionError(f"control plane {name}: ledger {k} {got[k]!r} on the card, "
                                 f"{w!r} from the NumPy engine")
        worst = max(worst, abs(got[k] - w) / max(abs(w), 1e-300))
    counts = sim.per_arch_counts()
    for k in PER_ARCH_FLOWS:
        if not np.allclose(out["per_arch"][k], counts[k], rtol=SIM_RTOL, atol=SIM_ATOL):
            i = int(np.argmax(np.abs(out["per_arch"][k] - counts[k])))
            raise AssertionError(f"control plane {name}: per-arch {k} of arch {i}: "
                                 f"{out['per_arch'][k][i]!r} on the card, {counts[k][i]!r}")
    if set(out["summary"]) != set(sim.res.summary()):
        raise AssertionError(f"control plane {name}: summary keys {sorted(out['summary'])} "
                             f"!= {sorted(sim.res.summary())}")
    return worst


def timed_ticks(policy, inputs, ticks=None):
    """One tick loop on the card, host clock from a sync to the end of a
    sync; returns (wall seconds, device outputs)."""
    statics, state0, xs, variants = inputs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = torch_engine.run_ticks(torch_engine.TORCH_POLICIES[policy].apply, statics, state0, xs,
                                 variants=variants, ticks=ticks)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def profile_ticks(policy, inputs):
    """Device busy share of PROFILE_TICKS ticks from ``torch.profiler``, the
    kernels launched a tick and the kernels that take the most time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall, _ = timed_ticks(policy, inputs, ticks=PROFILE_TICKS)
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    by_kernel = {e.key: e.self_device_time_total for e in device}
    launches = sum(e.count for e in device)
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {"ticks": PROFILE_TICKS, "profiled_wall_ms_per_tick": 1e3 * wall / PROFILE_TICKS,
            "device_ms_per_tick": busy / PROFILE_TICKS / 1e3,
            "device_busy_share": busy / (1e6 * wall),
            "device_kernels_per_tick": launches / PROFILE_TICKS,
            "top_kernels_ms_per_tick": {k[:60]: us / PROFILE_TICKS / 1e3 for k, us in top}}


def busy_share(row):
    """The profiled device time a tick over the unprofiled run's wall time a
    tick: the device's busy share of the timed run."""
    row["device_busy_share_of_timed_run"] = (
        row["profile"]["device_ms_per_tick"] / (1e3 * row["wall_s"] / row["ticks"]))


def check_sync_guard(dev):
    """The tick loop's guard is live: a host sync inside it raises."""
    x = torch.ones(1, device=dev)
    try:
        with torch_engine._SyncGuard(dev):
            x.item()
    except RuntimeError:
        return True
    raise AssertionError("torch.cuda.set_sync_debug_mode('error') did not catch a sync")


def phase_control_plane(seed):
    """The control plane on the card: run_scenario over a fleet of 1024 archs
    under portfolio and rl_pool, run_grid over 64 cells of 16 archs under
    portfolio, every run held to the port's NumPy engine."""
    t_phase = time.perf_counter()
    print(f"[cut] phase 4: {CONTROL_CUT}")
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    result = {"sync_guard_catches_a_sync": check_sync_guard(dev), "cut": CONTROL_CUT}
    wl = core_sim.replicate_pool(SERVING_POOL, FLEET_ARCHS, strict_frac=STRICT_FRAC)
    arr = SCENARIO_ZOO["shared_berkeley"].build(FLEET_ARCHS, duration_s=SCAN_TICKS)
    worst = 0.0
    for policy in ("portfolio", "rl_pool"):
        t0 = time.perf_counter()
        inputs = torch_engine.prepare_grid(arr[None], wl, policy, seeds=[seed], device=dev)
        build_s = time.perf_counter() - t0
        timed_ticks(policy, inputs, ticks=20)                 # warm-up, not timed
        wall, out = timed_ticks(policy, inputs)
        res = torch_engine._assemble(torch_engine._cell(torch_engine._to_host(out), 0), arr)
        t0 = time.perf_counter()
        sim = numpy_run(arr, wl, policy, seed)
        numpy_s = time.perf_counter() - t0
        err = hold_to_numpy(f"{policy} A={FLEET_ARCHS}", res, sim)
        worst = max(worst, err)
        result[f"fleet_{policy}"] = {
            "archs": FLEET_ARCHS, "ticks": SCAN_TICKS, "build_inputs_s": build_s,
            "wall_s": wall, "ticks_per_s": SCAN_TICKS / wall,
            "arch_ticks_per_s": FLEET_ARCHS * SCAN_TICKS / wall,
            "numpy_engine_s": numpy_s, "max_rel_ledger_err": err,
            "profile": profile_ticks(policy, inputs),
        }
        busy_share(result[f"fleet_{policy}"])
        del inputs, out
        print(f"[control] {policy} A={FLEET_ARCHS} T={SCAN_TICKS}: "
              + json.dumps(result[f"fleet_{policy}"]))

    gwl = core_sim.replicate_pool(SERVING_POOL, GRID_ARCHS, strict_frac=STRICT_FRAC)
    arrs = np.stack([
        SCENARIO_ZOO[GRID_SCENARIOS[i % len(GRID_SCENARIOS)]].build(
            GRID_ARCHS, duration_s=SCAN_TICKS, mean_rps=GRID_MEAN_RPS,
            seed=100 + i // len(GRID_SCENARIOS))
        for i in range(GRID_CELLS)])
    seeds = [seed + i // len(GRID_SCENARIOS) for i in range(GRID_CELLS)]
    t0 = time.perf_counter()
    inputs = torch_engine.prepare_grid(arrs, gwl, "portfolio", seeds=seeds, device=dev)
    build_s = time.perf_counter() - t0
    timed_ticks("portfolio", inputs, ticks=20)
    wall, out = timed_ticks("portfolio", inputs)
    host = torch_engine._to_host(out)
    cells, numpy_s = {}, 0.0
    for i in GRID_SAMPLE:
        cell = torch_engine._assemble(torch_engine._cell(host, i), arrs[i])
        t0 = time.perf_counter()
        sim = numpy_run(arrs[i], gwl, "portfolio", seeds[i])
        numpy_s += time.perf_counter() - t0
        err = hold_to_numpy(f"grid cell {i}", cell, sim)
        worst = max(worst, err)
        cells[i] = {"max_rel_ledger_err": err}
    short = arrs[:, :, :SAME_TICKS]
    grid = torch_engine.run_grid(short, gwl, "portfolio", seeds=seeds, device=dev)
    for i in GRID_SAMPLE:
        single = torch_engine.run_scenario(short[i], gwl, "portfolio", seed=seeds[i], device=dev)
        if single["summary"] != grid[i]["summary"]:
            raise AssertionError(f"control plane grid cell {i}: summary {grid[i]['summary']} "
                                 f"!= run_scenario's {single['summary']}")
        gap = max(abs(grid[i]["ledger"][k] - v) / max(abs(v), 1e-300)
                  for k, v in single["ledger"].items())
        if gap > 1e-12:
            raise AssertionError(f"control plane grid cell {i}: raw ledger {gap} from "
                                 "run_scenario's")
        cells[i]["vs_run_scenario"] = gap
    result["grid_portfolio"] = {
        "cells": GRID_CELLS, "archs": GRID_ARCHS, "ticks": SCAN_TICKS,
        "build_inputs_s": build_s, "wall_s": wall,
        "cell_ticks_per_s": GRID_CELLS * SCAN_TICKS / wall,
        "ticks_per_s": SCAN_TICKS / wall,
        "numpy_engine_s": numpy_s,
        "numpy_cell_ticks_per_s": len(GRID_SAMPLE) * SCAN_TICKS / numpy_s,
        "vs_run_scenario_ticks": SAME_TICKS, "sampled_cells": cells,
        "profile": profile_ticks("portfolio", inputs),
    }
    busy_share(result["grid_portfolio"])
    print(f"[control] grid {GRID_CELLS} cells x A={GRID_ARCHS}: "
          + json.dumps(result["grid_portfolio"]))
    result["max_rel_ledger_err"] = worst
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    result["phase_s"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# Phase 5: the PPO controller, trained on the card.
# ---------------------------------------------------------------------------
# the JAX package's own training env (benchmarks/rl_vs_schemes.py:351-380):
# its 8-model serving pool, strict share 0.25, 400 requests/s, 900-tick
# episodes, $0.02 per violated request, the variant catalog, every scenario
# of the zoo (scenario_seed 1), entropy bonus 0.0005, batched full-zoo
# rollouts; one cut: PPO_ITERATIONS iterations, not its 192, for time
PPO_MEAN_RPS, PPO_DURATION_S, PPO_PENALTY, PPO_ENTROPY = 400.0, 900, 0.02, 0.0005
PPO_ITERATIONS = 3
# its rollout-throughput metric (rl_vs_schemes.py:131-165): a 64-arch pool
# over 600 ticks of mmpp_bursts, the step-wise env loop against the collector
ROLLOUT_ARCHS, ROLLOUT_TICKS = 64, 600
# the checkpoint run: a held-out realization (its EVAL_SEED_OFFSET), cut to
# CHECKPOINT_TICKS ticks: equality card vs CPU needs no whole episode
PPO_HOLDOUT_SEED, CHECKPOINT_TICKS = 4242, 300
# a float32 update, card (TF32 off) vs CPU: tests/test_torch_ppo.py's 1e-5;
# a rollout against the NumPy env: its 1e-6
PPO_UPDATE_TOL, PPO_REPLAY_TOL = 1e-5, 1e-6
PPO_MEANS = ("loss_mean", "pi_loss", "v_loss", "entropy_mean", "approx_kl")


def ppo_env(duration_s=PPO_DURATION_S):
    wl = core_sim.uniform_pool_workload(SERVING_POOL, strict_frac=STRICT_FRAC)
    cfg = EnvConfig(strict_frac=STRICT_FRAC, mean_rps=PPO_MEAN_RPS, duration_s=duration_s,
                    violation_penalty=PPO_PENALTY)
    return PoolServingEnv(wl, cfg, scenarios=list(SCENARIO_ZOO.values()), scenario_seed=1,
                          catalog=core_sim.VariantCatalog.for_workload(wl))


class TrainingProbe:
    """Wrappers of the trainer's collector, update phase and minibatch step:
    the host time of each collection and update phase (each ends in a copy
    to the host), and host copies of the first collection's inputs and
    buffer and of the first minibatch step's inputs, for the checks."""

    def __init__(self):
        self.rollout_s, self.update_s = [], []
        self.first_rollout = self.first_step = None

    def collect(self, fn):
        def run(env, params, gen, **kw):
            gen_state = gen.get_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            buf = fn(env, params, gen, **kw)
            self.rollout_s.append(time.perf_counter() - t0)
            if self.first_rollout is None:
                self.first_rollout = {"gen_state": gen_state, "episode": env._episode,
                                      "params": ppo.params_to_numpy(params), "buf": buf}
            return buf
        return run

    def update(self, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.update_s.append(time.perf_counter() - t0)
            return out
        return run

    def step(self, fn):
        def run(params, opt_state, batch, cfg):
            if self.first_step is None:
                step, m, v = opt_state
                self.first_step = (ppo.params_to_numpy(params),
                                   (int(step), ppo.params_to_numpy(m), ppo.params_to_numpy(v)),
                                   {k: x.cpu().numpy() for k, x in batch.items()})
            return fn(params, opt_state, batch, cfg)
        return run


def replay_cell(env, first, cell):
    """One cell of a zoo collection replayed through the NumPy env: from the
    env's observation at each tick, the net's float64 NumPy forward and the
    cell's uniforms must draw the collector's action; the features and
    rewards must agree within PPO_REPLAY_TOL."""
    S, A, T = len(env.scenarios), env.n_archs, env.cfg.duration_s
    gen = torch.Generator()
    gen.set_state(first["gen_state"])
    u = torch.rand((S, T, A), generator=gen, dtype=torch.float64).numpy()[cell]
    ep, sc = first["episode"], env.scenarios[cell]
    arr = sc.build(A, seed=sc.seed + ep, duration_s=T, mean_rps=env.cfg.mean_rps)
    numpy_env = PoolServingEnv(env.workload, env.cfg, arrivals=arr, catalog=env.catalog)
    numpy_env._episode = ep * S + cell          # the collector's sim seed for the cell
    net = {n: {k: v.astype(np.float64) for k, v in layer.items()}
           for n, layer in first["params"].items()}
    cols = slice(cell * A, (cell + 1) * A)
    buf = {k: first["buf"][k][:, cols] for k in ("obs", "actions", "rewards")}
    obs, obs_err, rew_err = numpy_env.reset(), 0.0, 0.0
    for t in range(T):
        obs_err = max(obs_err, float(np.abs(obs - buf["obs"][t]).max()))
        logits = policy_logits(net, obs.astype(np.float64))
        p = np.exp(logits - logits.max(-1, keepdims=True))
        cdf = np.cumsum(p / p.sum(-1, keepdims=True), -1)
        a = np.minimum((u[t][:, None] >= cdf).sum(-1), cdf.shape[-1] - 1)
        if not np.array_equal(a, buf["actions"][t]):
            raise AssertionError(f"ppo replay cell {cell} tick {t}: actions {a} from the NumPy "
                                 f"env, {buf['actions'][t]} from the card")
        obs, r, _, _ = numpy_env.step(a)
        rew_err = max(rew_err, float(np.abs(r - buf["rewards"][t]).max()))
    check(f"ppo replay cell {cell} features", obs_err, PPO_REPLAY_TOL)
    check(f"ppo replay cell {cell} rewards", rew_err, PPO_REPLAY_TOL)
    return {"cell": cell, "scenario": sc.name, "ticks": T, "actions_equal": True,
            "max_abs_obs_err": obs_err, "max_abs_reward_err": rew_err}


def update_card_vs_cpu(first_step, cfg):
    """The trainer's first minibatch step again, on the card and on the CPU:
    parameters, Adam's moments, the loss and its aux values must agree."""
    params, (step, m, v), batch = first_step
    outs = []
    for dev in ("cuda", "cpu"):
        p = ppo.params_from_jax(params, device=dev)
        opt = (torch.tensor(step, dtype=torch.int32, device=dev),
               ppo.params_from_jax(m, device=dev), ppo.params_from_jax(v, device=dev))
        new, (_, m2, v2), loss, aux = ppo.ppo_update(
            p, opt, {k: torch.as_tensor(x, device=dev) for k, x in batch.items()}, cfg)
        outs.append([np.asarray(float(loss))] + [np.asarray(float(aux[k])) for k in sorted(aux)]
                    + [x for tree in (new, m2, v2) for layer in ppo.params_to_numpy(tree).values()
                       for x in layer.values()])
    err = max(float(np.abs(a - b).max()) for a, b in zip(*outs))
    check("ppo update card vs CPU", err, PPO_UPDATE_TOL)
    return {"rows": int(len(batch["obs"])), "max_abs_err": err}


def checkpoint_card_vs_cpu(env, params, seed):
    """save_policy_params -> RLPoolPolicy(checkpoint=) -> run_scenario under
    rl_pool on a held-out realization, on the card and on the CPU."""
    with tempfile.TemporaryDirectory() as d:
        path = save_policy_params(params, os.path.join(d, "pool_policy.json"),
                                  rate_scale=env.cfg.rate_scale,
                                  fleet_scale=env.cfg.fleet_scale)
        policy = RLPoolPolicy(checkpoint=path)
    sc = SCENARIO_ZOO["flash_correlated"]
    arr = sc.build(env.n_archs, seed=sc.seed + PPO_HOLDOUT_SEED, duration_s=CHECKPOINT_TICKS,
                   mean_rps=PPO_MEAN_RPS)
    pol = {"net": policy.params, "rate_scale": policy.rate_scale,
           "fleet_scale": policy.fleet_scale}
    card, cpu = (torch_engine.run_scenario(arr, env.workload, "rl_pool", pol, catalog=env.catalog,
                                           seed=seed, device=d) for d in ("cuda", "cpu"))
    if card["summary"] != cpu["summary"]:
        raise AssertionError(f"ppo checkpoint run: summary {card['summary']} on the card, "
                             f"{cpu['summary']} on the CPU")
    gap = max(abs(card["ledger"][k] - v) / max(abs(v), 1e-300) for k, v in cpu["ledger"].items())
    check("ppo checkpoint run card vs CPU (relative ledger)", gap, SIM_RTOL)
    return {"scenario": sc.name, "ticks": CHECKPOINT_TICKS, "trained": policy.trained,
            "max_rel_ledger_err": gap, "cost_total": card["summary"]["cost_total"],
            "violation_rate": card["summary"]["violation_rate"]}


def rollout_throughput(env_cfg, params, dev):
    """The benchmark's rollout metric: the step-wise env loop (NumPy env,
    one forward pass a tick on the card) against the batched collector
    (one tick loop of the engine) on the same 64-arch episode."""
    wl = core_sim.replicate_pool(SERVING_POOL, ROLLOUT_ARCHS, strict_frac=STRICT_FRAC)
    arr = SCENARIO_ZOO["mmpp_bursts"].build(ROLLOUT_ARCHS, duration_s=ROLLOUT_TICKS,
                                            mean_rps=PPO_MEAN_RPS)
    env = PoolServingEnv(wl, env_cfg, arrivals=arr)
    net = ppo.params_from_jax(params, device=dev)
    gen = torch.Generator().manual_seed(0)
    obs = env.reset()
    ppo.pool_policy_action(net, obs, gen)        # warm-up, not timed
    t0, steps, done = time.perf_counter(), 0, False
    while not done:
        a, _, _ = ppo.pool_policy_action(net, obs, gen)
        obs, _, done, _ = env.step(a)
        steps += 1
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()             # training ran the collector's ops already
    t0 = time.perf_counter()
    ppo.collect_rollouts_torch(env, net, gen, device=dev)
    batched = time.perf_counter() - t0
    return {"pool_size": ROLLOUT_ARCHS, "ticks": steps, "stepwise_wall_s": wall,
            "stepwise_ticks_per_s": steps / wall, "collector_wall_s": batched,
            "collector_ticks_per_s": steps / batched, "speedup_vs_env_loop": wall / batched}


def profiled(fn, per):
    """Device kernels (and copies) per ``per`` units of ``fn``'s work, its
    device time and the device's busy share of its (profiled) wall time;
    device activity only, which keeps the profiler's own cost small."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in device)
    return {"wall_s": wall, "device_ms": busy_us / 1e3, "device_busy_share": busy_us / (1e6 * wall),
            "kernels": sum(e.count for e in device),
            "kernels_per_unit": sum(e.count for e in device) / per,
            "device_ms_per_unit": busy_us / 1e3 / per}


def phase_ppo(seed):
    """PPO on the card: train the pool controller with full-zoo rollouts of
    the torch engine, check a replayed cell, a minibatch update and the
    trained checkpoint's run against NumPy and the CPU, time the rollout
    metric and profile a rollout and an update phase."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    env = ppo_env()
    cfg = ppo.PPOConfig(iterations=PPO_ITERATIONS, rollout_len=PPO_DURATION_S,
                        entropy_coef=PPO_ENTROPY, seed=seed)
    probe = TrainingProbe()
    with wrapped(ppo, "collect_rollouts_torch_zoo", probe.collect), \
            wrapped(ppo, "update_phase", probe.update), wrapped(ppo, "ppo_update", probe.step):
        state = ppo.train_ppo_pool(env, cfg, torch_rollouts=True, full_zoo=True, device=dev)
    S, T = len(env.scenarios), PPO_DURATION_S
    iters = []
    for it, h in enumerate(state.history):
        row = {"iter": it, "rollout_s": probe.rollout_s[it], "ticks_per_s": T / probe.rollout_s[it],
               "cell_ticks_per_s": S * T / probe.rollout_s[it], "update_s": probe.update_s[it],
               "rollout_reward": h["rollout_reward"], **{k: h[k] for k in PPO_MEANS}}
        if not np.isfinite(list(row.values())).all():
            raise AssertionError(f"ppo iteration {it}: {row}")
        iters.append(row)
        print("[ppo] " + json.dumps(row))
    result = {"reduced": {"iterations": [PPO_ITERATIONS, 192]},
              "config": {"archs": env.n_archs, "cells": S, "ticks": T, "mean_rps": PPO_MEAN_RPS,
                         "rows_per_update_phase": T * S * env.n_archs,
                         "minibatch_steps": cfg.epochs * cfg.minibatches},
              "iterations": iters, "best_reward": state.best_reward}
    result["replay"] = replay_cell(env, probe.first_rollout, cell=0)
    result["update_card_vs_cpu"] = update_card_vs_cpu(probe.first_step, cfg)
    result["checkpoint_card_vs_cpu"] = checkpoint_card_vs_cpu(env, state.params, seed)
    for key in ("replay", "update_card_vs_cpu", "checkpoint_card_vs_cpu"):
        print(f"[ppo] {key}: " + json.dumps(result[key]))
    result["rollout_64"] = rollout_throughput(env.cfg, state.params, dev)
    print("[ppo] rollout_64: " + json.dumps(result["rollout_64"]))
    # one rollout of the training env cut to PROFILE_TICKS ticks, and one
    # update phase on the first iteration's buffer
    short, net = ppo_env(PROFILE_TICKS), ppo.params_from_jax(state.params, device=dev)
    gen = torch.Generator().manual_seed(seed)
    result["profile_rollout"] = profiled(
        lambda: ppo.collect_rollouts_torch_zoo(short, net, gen, device=dev), PROFILE_TICKS)
    result["profile_update_phase"] = profiled(
        lambda: ppo.update_phase(net, ppo.init_opt_state(net), probe.first_rollout["buf"], cfg, 0,
                                 device=dev), cfg.epochs * cfg.minibatches)
    # the device's busy share of the last timed rollout and update phase
    result["profile_rollout"]["busy_share_of_timed_run"] = (
        result["profile_rollout"]["device_ms_per_unit"] / (1e3 * iters[-1]["rollout_s"] / T))
    result["profile_update_phase"]["busy_share_of_timed_run"] = (
        result["profile_update_phase"]["device_ms"] / (1e3 * iters[-1]["update_s"]))
    print("[ppo] profiles (per unit: a tick; a minibatch step): " + json.dumps(
        {k: result[k] for k in ("profile_rollout", "profile_update_phase")}))
    result["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    result["phase_s"] = time.perf_counter() - t_phase
    return result


# ---------------------------------------------------------------------------
# Phase 6: training on the card.
# ---------------------------------------------------------------------------
# launch/train.py's configuration (AdamW lr 3e-4, wsd, warmup
# max(10, steps // 10), remat on) in f32, the JAX package's training
# default, on SyntheticLM batches of TRAIN_BATCH x TRAIN_SEQ from --seed
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 512, 20, 3e-4
TRAIN_TIMED = 5
# card vs CPU: one make_train_step at full width and depth, B=1, S=128
# (rwkv6-1.6b: full width, 4 layers, T=64).  The same f32 arithmetic in
# another order (and the kernels' forwards ~1e-6 from the plain versions)
# through 24 layers: loss and grad_norm within 1e-4 relative, every gradient
# leaf within 1e-3 of its largest value, which still catches a lost or
# misweighted gradient term (errors of order 1)
CHECK_SEQ, RWKV_CHECK_LAYERS, RWKV_CHECK_SEQ = 128, 4, 64
TRAIN_RTOL, GRAD_LEAF_TOL = 1e-4, 1e-3
RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, RWKV_TRAIN_STEPS = 4, 128, 3
# the kernels of the training path, by name in a profile, and the profiler
# ranges of their Functions' plain backwards (kernels/ops.py) and of the
# optimizer (train_loop.adamw_update, wrapped here)
TRAIN_KERNELS = {"flash_attention": FLASH_KERNELS, "rwkv6_scan": ("rwkv6::",)}
BACKWARD_RANGES = {"flash_attention": "flash_attention.backward", "rwkv6_scan": "rwkv6.backward"}
ADAMW_RANGE = "train.adamw_update"


def train_config(steps):
    return train_loop.TrainConfig(
        optimizer=OptimizerConfig(lr=TRAIN_LR),
        schedule=ScheduleConfig(kind="wsd", peak_lr=TRAIN_LR, warmup_steps=max(10, steps // 10),
                                total_steps=steps))


def leaf_names(tree, prefix=""):
    """Dotted paths of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


class GradProbe:
    """A wrapper of ``train_loop.adamw_update`` that keeps the gradients of
    the first step it sees."""

    def __init__(self):
        self.grads = None

    def __call__(self, update):
        def run(params, grads, opt_state, cfg, lr=None):
            if self.grads is None:
                self.grads = grads
            return update(params, grads, opt_state, cfg, lr=lr)
        return run


def check_grads(params, grads):
    """Raise unless every parameter leaf got a finite, non-zero gradient;
    returns the count, the smallest leaf's largest |g| and layer 0's
    attention projections'."""
    names = leaf_names(params)
    leaves = tree_leaves(grads)
    missing = [n for n, g in zip(names, leaves) if g is None]
    if missing:
        raise AssertionError(f"no gradient for {missing}")
    big = torch.stack([g.abs().max() for g in leaves]).cpu()
    finite = torch.stack([torch.isfinite(g).all() for g in leaves]).cpu()
    bad = [n for n, m, f in zip(names, big.tolist(), finite.tolist()) if not (f and m > 0)]
    if bad:
        raise AssertionError(f"gradients zero or not finite: {bad}")
    named = {n: m for n, m in zip(names, big.tolist())
             if n.startswith(("layers.0.attn.", "layers.0.rwkv.")) and n.split(".")[-1]
             in ("wq", "wk", "wv", "bq", "bk", "bv", "wr", "wg", "decay_a", "w0", "u")}
    return {"leaves": len(leaves), "all_finite_nonzero": True,
            "min_leaf_max_abs_grad": float(big.min()), "layer0_max_abs_grad": named}


def expected_train_launches(cfg, steps, remat=True):
    """Each step runs every attention layer's flash call and every RWKV
    layer's scan once in the forward and, under remat, once more in the
    backward's recompute; the backward itself is the plain VJP."""
    per = expected_launches(cfg, 1, 0)
    return {name: n * steps * (1 + bool(remat)) for name, n in per.items()}


def train_step_floor(cfg, params, b, s):
    """Operations of a step, 6 x (non-embedding + unembedding parameters) x
    tokens plus 3 x the causal attention's forward (4 hd per visible pair,
    every head of every attention layer), at 67 TFLOP/s f32; the optimizer's
    bytes (p, g, m, v read, p, m, v written, f32) at 3.35 TB/s after them.
    Remat's recompute is not counted: the floor is of the step's work."""
    numel = lambda tree: sum(t.numel() for t in tree_leaves(tree))
    head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    n_attn = sum(k in (ATTN, LOCAL_ATTN) for k in cfg.layer_kinds())
    pairs = b * cfg.num_heads * s * (s + 1) // 2
    flops = (6 * (numel(params["layers"]) + numel(params["final_norm"]) + head.numel()) * b * s
             + 3 * 4 * cfg.resolved_head_dim * pairs * n_attn)
    opt_bytes = 7 * 4 * numel(params)
    return {"flops": flops, "ops_floor_ms": 1e3 * flops / PEAK_F32_FLOPS,
            "optimizer_bytes": opt_bytes, "optimizer_floor_ms": 1e3 * opt_bytes / PEAK_BYTES,
            "floor_ms": 1e3 * (flops / PEAK_F32_FLOPS + opt_bytes / PEAK_BYTES)}




def read_profile(prof, ranges):
    """Device time by kernel name, of the kernels launched inside each
    profiler range of ``ranges`` (a launch's runtime call on the range's
    thread, within its span, matched to its kernel by correlation id) and
    their number, read from the raw kineto events: the operator tree is
    never built, which at ~10^5 kernels a step (phase 6d) would take
    minutes.  Returns (by kernel, by range, kernels by range, kernels)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    by_kernel, by_corr, count = {}, {}, 0
    spans = {label: {} for label in ranges}
    for e in events:
        if e.device_type() == cuda and not e.is_user_annotation():
            count += 1
            us = e.duration_ns() / 1e3
            by_kernel[e.name()] = by_kernel.get(e.name(), 0.0) + us
            by_corr[e.correlation_id()] = by_corr.get(e.correlation_id(), 0.0) + us
        elif e.device_type() == cpu and e.is_user_annotation() and e.name() in spans:
            spans[e.name()].setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for per_thread in spans.values():
        for sp in per_thread.values():
            sp.sort()
    in_range = {label: 0.0 for label in ranges}
    n_in_range = {label: 0 for label in ranges}
    for e in events:
        if e.device_type() != cpu or not e.name().startswith("cu") or e.correlation_id() not in by_corr:
            continue
        for label, per_thread in spans.items():
            sp = per_thread.get(e.start_thread_id(), ())
            i = bisect.bisect_right(sp, (e.start_ns(), float("inf"))) - 1
            if i >= 0 and e.start_ns() <= sp[i][1]:
                in_range[label] += by_corr[e.correlation_id()]
                n_in_range[label] += 1
    return by_kernel, in_range, n_in_range, count


def profile_train_step(fn, kernel):
    """One step under ``torch.profiler``: its device time and busy share of
    the host-clock window, the kernel forwards' device time, the plain
    backwards' (the Functions' profiler range), AdamW's (a range around
    ``train_loop.adamw_update``) and the kernels that take the most."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with wrapped(train_loop, "adamw_update", in_range(ADAMW_RANGE)), \
            torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    by_kernel, ranges, _, count = read_profile(prof, (BACKWARD_RANGES[kernel], ADAMW_RANGE))
    busy = sum(by_kernel.values())
    fwd = kernel_time(by_kernel, TRAIN_KERNELS[kernel])
    if kernel == "flash_attention":     # f32 at hd 64: every forward on the tensor cores
        check_only_kernel(by_kernel, FLASH_KERNELS, ("fa_tf32_kernel",))
    bwd, opt = ranges[BACKWARD_RANGES[kernel]], ranges[ADAMW_RANGE]
    if not (0 < bwd < busy and 0 < opt < busy):
        raise AssertionError(f"profiler ranges: backward {bwd} us, adamw {opt} us, of {busy} us")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return out, {
        "profiled_wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
        "device_busy_share_profiled": busy / wall_us,
        "device_kernels": count,
        f"{kernel}_forward_ms": fwd / 1e3, f"{kernel}_forward_share_of_device": fwd / busy,
        f"{kernel}_plain_backward_ms": bwd / 1e3,
        f"{kernel}_plain_backward_share_of_device": bwd / busy,
        "adamw_ms": opt / 1e3, "adamw_share_of_device": opt / busy,
        "top_kernels_ms": {k[:80]: us / 1e3 for k, us in top},
        "profile_read_s": time.perf_counter() - t0,
    }


def timed_steps(step, state, batches):
    """Host ms of each step (a sync before, a sync at the end), chaining the
    state; returns (the last state, the times)."""
    times = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = step(*state, batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        state = (params, opt)
    return state, times


def train_card_vs_cpu(cfg, seed, seq, fill=None):
    """One make_train_step (launch/train.py's configuration) from the same
    params and batch on the card and on the CPU: loss and grad_norm within
    TRAIN_RTOL, every gradient leaf within GRAD_LEAF_TOL of its largest
    value, and every card gradient finite and non-zero."""
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    if fill is not None:
        fill(params, torch.Generator().manual_seed(seed + 1))
    batch = next(SyntheticLM(cfg.vocab_size, seq, 1, seed=seed + 1))
    tcfg = train_config(TRAIN_STEPS)
    out = {}
    for dev in ("cuda", "cpu"):
        probe = GradProbe()
        p = _tree_to(params, dev)
        with wrapped(train_loop, "adamw_update", probe):
            _, _, m = train_loop.make_train_step(cfg, tcfg)(
                p, adamw_init(p, tcfg.optimizer), train_loop.batch_to(batch, dev))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]), probe.grads)
        del p, m
    (loss_g, norm_g, grads_g), (loss_c, norm_c, grads_c) = out["cuda"], out["cpu"]
    grads = check_grads(params, grads_g)
    rel = {"loss": abs(loss_g - loss_c) / abs(loss_c),
           "grad_norm": abs(norm_g - norm_c) / abs(norm_c)}
    for k, e in rel.items():
        check(f"{cfg.name} train step card vs CPU {k} (relative)", e, TRAIN_RTOL)
    leaf = max(max_err(a.cpu(), b) / float(b.abs().max())
               for a, b in zip(tree_leaves(grads_g), tree_leaves(grads_c)))
    check(f"{cfg.name} train step card vs CPU gradients (of each leaf's max)", leaf, GRAD_LEAF_TOL)
    del out, grads_g, grads_c
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "batch": 1, "seq": seq, "loss_card": loss_g,
            "loss_cpu": loss_c, "grad_norm_card": norm_g, "grad_norm_cpu": norm_c,
            "rel_err": rel, "max_grad_leaf_err_of_leaf_max": leaf,
            "tol": {"loss_grad_norm_rel": TRAIN_RTOL, "grad_leaf": GRAD_LEAF_TOL},
            "card_grads": grads}


def checkpoint_round_trip(cfg, tcfg, state, batch, prompt):
    """Save {params, opt_state} to a temporary directory and restore it onto
    the card (bit-equal); one step from the restored state and from the one
    in memory; prefill + F32_DECODE_STEPS decode steps from the restored and
    the in-memory params through both attention kernels (logits equal)."""
    params, opt = state
    tree = {"params": params, "opt_state": opt}
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(d, int(opt["step"]), tree)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        back = restore_checkpoint(d, latest_step(d), tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    if not all(a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
               for a, b in zip(tree_leaves(tree), tree_leaves(back))):
        raise AssertionError("checkpoint: the restored state is not bit-equal to the saved one")
    step = train_loop.make_train_step(cfg, tcfg)
    a = step(params, opt, batch)
    b = step(back["params"], back["opt_state"], batch)
    gaps = [max_err(x, y) / max(float(x.abs().max()), 1e-30)
            for x, y in zip(tree_leaves(a), tree_leaves(b))]
    bit_equal = all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    check("checkpoint: a step from the restored state vs the in-memory one (of each leaf's max)",
          max(gaps), 1e-6)
    del a, b
    before = launch_counts()
    prompt = torch.as_tensor(prompt, dtype=torch.long)
    mem_logits, tokens = _teacher_forced(cfg, params, prompt, None, torch.device("cuda"))
    restored_logits, _ = _teacher_forced(cfg, back["params"], prompt, tokens, torch.device("cuda"))
    ran = {k: n - before[k] for k, n in launch_counts().items()}
    want = {k: 2 * n for k, n in expected_launches(cfg, 1, F32_DECODE_STEPS).items()}
    if ran != want:
        raise AssertionError(f"checkpoint serve check launches {ran} != {want}")
    if not all(torch.equal(x, y) for x, y in zip(mem_logits, restored_logits)):
        raise AssertionError("checkpoint: logits from the restored params differ")
    del back
    torch.cuda.empty_cache()
    return {"bytes": nbytes, "save_s": save_s, "restore_s": restore_s, "bit_equal_restore": True,
            "resume_step_bit_equal": bit_equal, "resume_step_max_err_of_leaf_max": max(gaps),
            "serve_prompt_tokens": len(prompt), "serve_decode_steps": F32_DECODE_STEPS,
            "serve_logits_equal": True, "serve_launches": ran}


def phase_train(seed, gpu, prompt):
    """qwen1.5-0.5b trained at full width and depth in f32 (6a), one step
    card vs CPU (6b), the checkpoint round trip (6c)."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    tcfg = train_config(TRAIN_STEPS)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=seed)
    probe, logged = GradProbe(), []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    with wrapped(train_loop, "adamw_update", probe):
        params, opt, history = train_loop.train(
            cfg, tcfg, iter(data), TRAIN_STEPS, seed=seed,
            callback=lambda step, m: logged.append(step), device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    expected = expected_train_launches(cfg, TRAIN_STEPS)
    if launches != expected:
        raise AssertionError(f"train launches {launches} != {expected}")
    first, last = history[0]["loss"], history[-1]["loss"]
    if not (np.isfinite([h["loss"] for h in history]).all() and last < first):
        raise AssertionError(f"{cfg.name} training: loss {first} -> {last}")
    grads = check_grads(params, probe.grads)
    probe.grads = None
    print(f"[train] {cfg.name}: {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, loss "
          f"{first:.4f} -> {last:.4f}; kernel launches {json.dumps(launches)} = "
          f"{json.dumps(expected_launches(cfg, 1, 0))} per step x {TRAIN_STEPS} steps x 2 "
          "(forward, remat recompute)")
    step = train_loop.make_train_step(cfg, tcfg)
    batches = [train_loop.batch_to(next(data), dev) for _ in range(TRAIN_TIMED + 2)]
    state, times = timed_steps(step, (params, opt), batches[:TRAIN_TIMED + 1])
    del params, opt
    step_ms = float(np.median(times[1:]))
    floor = train_step_floor(cfg, state[0], TRAIN_BATCH, TRAIN_SEQ)
    (p, o, _), prof = profile_train_step(lambda: step(*state, batches[-1]), "flash_attention")
    del p, o
    result = {
        "model": cfg.name, "dtype": "float32", "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": model_lib.param_count(cfg), "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "steps": TRAIN_STEPS, "schedule": dataclasses.asdict(tcfg.schedule),
        "optimizer": {k: v for k, v in dataclasses.asdict(tcfg.optimizer).items()
                      if k != "state_dtype"}, "remat": tcfg.remat,
        "loss_first": first, "loss_last": last, "logged_steps": logged,
        "history": [{k: h[k] for k in ("step", "loss", "ce", "grad_norm", "lr")} for h in history],
        "train_wall_s": wall, "launches": launches,
        "launch_formula": "per step: attention layers x (1 forward + 1 remat recompute)",
        "first_step_grads": grads,
        "step_ms_host": times, "step_ms_median": step_ms,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "step_floor": floor, "train_step_mfu": floor["flops"] / (step_ms / 1e3) / PEAK_F32_FLOPS,
        "floor_share_of_step": floor["floor_ms"] / step_ms,
        "profile": prof, "gpu": gpu,
    }
    result["profile"]["device_busy_share_of_median_step"] = prof["device_ms"] / step_ms
    print("[train] 6a: " + json.dumps({k: result[k] for k in (
        "step_ms_median", "tokens_per_s", "peak_mem_gib", "train_step_mfu", "floor_share_of_step",
        "first_step_grads", "profile")}))
    result["checkpoint"] = checkpoint_round_trip(cfg, tcfg, state, batches[0],
                                                 np.resize(prompt, PROMPT_MIN))
    print("[train] 6c checkpoint: " + json.dumps(result["checkpoint"]))
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result["card_vs_cpu"] = train_card_vs_cpu(cfg, seed, CHECK_SEQ)
    result["card_vs_cpu"]["s"] = time.perf_counter() - t0
    print("[train] 6b card vs CPU: " + json.dumps(result["card_vs_cpu"]))
    result["phase_s"] = time.perf_counter() - t_phase
    return result


def phase_train_rwkv(seed, gpu):
    """rwkv6-1.6b trained at full width and depth in f32 (6d): every WKV
    call through the scan's autograd Function, by the launch counter; one
    profiled step; card vs CPU at full width and 4 layers."""
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cfg = get_config(RWKV_ARCH)
    tcfg = train_config(RWKV_TRAIN_STEPS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model_lib.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    data = SyntheticLM(cfg.vocab_size, RWKV_TRAIN_SEQ, RWKV_TRAIN_BATCH, seed=seed)
    batches = [train_loop.batch_to(next(data), dev) for _ in range(RWKV_TRAIN_STEPS + 1)]
    step = train_loop.make_train_step(cfg, tcfg)
    losses = []

    def run(p, o, batch):
        out = step(p, o, batch)
        losses.append(out[2]["loss"])
        return out

    for mod in KERNELS.values():
        mod.launches = 0
    state, times = timed_steps(run, (params, adamw_init(params, tcfg.optimizer)),
                               batches[:RWKV_TRAIN_STEPS])
    launches = launch_counts()
    del params
    expected = expected_train_launches(cfg, RWKV_TRAIN_STEPS)
    if launches != expected:
        raise AssertionError(f"{cfg.name} train launches {launches} != {expected}")
    losses = [float(x) for x in losses]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{cfg.name} training: losses {losses}")
    print(f"[train] {cfg.name}: {RWKV_TRAIN_STEPS} steps of {RWKV_TRAIN_BATCH} x "
          f"{RWKV_TRAIN_SEQ}, losses {losses}; kernel launches {json.dumps(launches)} = "
          f"{json.dumps(expected_launches(cfg, 1, 0))} per step x {RWKV_TRAIN_STEPS} steps x 2 "
          "(forward, remat recompute)")
    t0 = time.perf_counter()
    (p, o, _), prof = profile_train_step(lambda: step(*state, batches[-1]), "rwkv6_scan")
    prof["profile_s"] = time.perf_counter() - t0
    del p, o
    result = {"model": cfg.name, "dtype": "float32", "layers": cfg.num_layers,
              "d_model": cfg.d_model, "params": model_lib.param_count(cfg),
              "batch": RWKV_TRAIN_BATCH, "seq": RWKV_TRAIN_SEQ, "steps": RWKV_TRAIN_STEPS,
              "losses": losses, "launches": launches, "step_ms_host": times,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
              "profile": prof, "gpu": gpu}
    del state, batches
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result["card_vs_cpu"] = train_card_vs_cpu(
        dataclasses.replace(cfg, num_layers=RWKV_CHECK_LAYERS), seed, RWKV_CHECK_SEQ,
        fill=fill_rwkv_leaves)
    result["card_vs_cpu"]["s"] = time.perf_counter() - t0
    print(f"[train] 6d {cfg.name}: " + json.dumps(result))
    result["phase_s"] = time.perf_counter() - t_phase
    return result


def f32_flash_timing(q, k, v, flush, causal=True) -> dict:
    """The f32 flash kernel on (q, k, v) from position 0: its ms beside its
    bound and the plain version's and SDPA's forward (TF32 off).  The bound
    is the kernel's own ceiling at every hd (``fa_tf32_kernel``, at hd 256
    over a cluster of two CTAs): three tf32 products on the tensor cores,
    165 TFLOP/s of f32-accurate products, with the 67 TFLOP/s f32 one of
    the SIMT units beside it as ``simt_bound_ms``.  Bytes at 3.35 TB/s."""
    b, sq, nq, hd = q.shape
    nkv = k.shape[2]
    pairs = b * nq * (sq * (sq + 1) // 2 if causal else sq * k.shape[1])
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    simt = bound(4 * hd * pairs, nbytes, PEAK_F32_FLOPS)
    own = bound(4 * hd * pairs, nbytes, PEAK_TF32X3_FLOPS)
    gqa = {"enable_gqa": True} if nq != nkv else {}
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return {
        "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=causal), flush),
        "bound_ms": own[0], "bound_by": own[1],
        "simt_bound_ms": simt[0], "simt_bound_by": simt[1],
        "plain_forward_ms": time_ms(lambda: ref.mha_reference(q, k, v, causal=causal), flush),
        "library_forward_ms": time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, **gqa), flush),
    }


def time_training_kernels(seed):
    """The two kernels of the training path at its shapes, f32: flash
    attention at qwen1.5-0.5b's (B=8, S=512, 16 heads of 64, causal) and the
    scan at rwkv6-1.6b's (B=4, T=128, H=32, hd 64): the kernel forward, the
    plain backward the Function runs (its recompute included), SDPA forward
    alone and forward + backward as the yardsticks, and their floors at 67
    TFLOP/s f32 (flash's forward at three tf32 products on the tensor cores,
    165 TFLOP/s of f32-accurate products, the 67 beside it).  Flash's f32
    kernel also at the main path's, phi3.5-moe's, kimi-k2's and
    recurrentgemma-9b's prefill shapes (B=1, S=512: 16:16 heads of 64, 32:8
    of 128, 64:8 of 112, 16:1 of 256, the last over clusters of two CTAs),
    each checked against the plain version and beside its bounds
    (``f32_flash_timing``)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = L2Flush(dev)
    f32 = torch.float32
    b, s, h, hd = TRAIN_BATCH, TRAIN_SEQ, 16, 64
    q, k, v, g = (randn(gen, (b, s, h, hd), f32) for _ in range(4))
    err = max_err(fa.flash_attention(q, k, v), ref.mha_reference(q, k, v))
    check("flash_attention f32 at the training shape", err, TOL[f32])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    sdpa_in = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    g_t = g.transpose(1, 2)
    pairs = b * h * s * (s + 1) // 2
    es = 4
    # backward from q, k, v, dO: P recomputed, then dV, dP, dS, dQ, dK
    bwd_floor = bound(10 * hd * pairs, 7 * q.numel() * es, PEAK_F32_FLOPS)
    flash = {
        "shape": f"train B={b} S={s} nq={h} nkv={h} hd={hd} causal float32",
        "max_abs_err": err,
        **f32_flash_timing(q, k, v, flush),
        "plain_backward_ms": time_ms(
            lambda: torch.autograd.grad(ref.mha_reference(*leaves), leaves, g), flush),
        "backward_bound_ms": bwd_floor[0], "backward_bound_by": bwd_floor[1],
        "library_forward_backward_ms": time_ms(
            lambda: torch.autograd.grad(F.scaled_dot_product_attention(*sdpa_in, is_causal=True),
                                        sdpa_in, g_t), flush),
    }
    flash["f32_shapes"] = {}
    for name, (nq, nkv, d) in (("main", (16, 16, 64)), (MOE_ARCH, (32, 8, 128)),
                               ("kimi_k2", (64, 8, 112)), (RG_ARCH, (16, 1, 256))):
        err_f, qkv = check_flash(gen, 1, PROMPT_MAX, PROMPT_MAX, nq, nkv, d, True, 0, f32)
        flash["f32_shapes"][name] = {
            "shape": f"prefill B=1 S={PROMPT_MAX} nq={nq} nkv={nkv} hd={d} causal float32",
            "max_abs_err": err_f, **f32_flash_timing(*qkv, flush)}
        del qkv
    del q, k, v, g, leaves, sdpa_in, g_t
    args = rwkv_inputs(gen, RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, 32, 64, False, f32)
    r = args[0]
    err = max(max_err(x, y) for x, y in zip(rk.rwkv6_scan(*args), ref.rwkv6_reference(*args)))
    check("rwkv6_scan f32 at the training shape", err, RWKV_TOL[f32])
    bt, t, hh = r.shape[:3]
    state_bytes = bt * hh * hd * hd * es
    g_out, g_s = randn(gen, r.shape, f32), randn(gen, (bt, hh, hd, hd), f32)
    leaves = [x.clone().requires_grad_() for x in args[:5]]
    tok_ops = 4 * hd * hd * bt * t * hh
    fwd_floor = bound(tok_ops, 5 * r.numel() * es + state_bytes, PEAK_F32_FLOPS)
    # backward: the state's update and the output recomputed and the reverse
    # pass's products, 12 hd^2 a token and head; r, k, v, w, dO and dS_T in,
    # dr, dk, dv, dw out
    bwd_floor = bound(3 * tok_ops, 9 * r.numel() * es + state_bytes, PEAK_F32_FLOPS)
    scan = {
        "shape": f"train B={bt} T={t} H={hh} hd={hd} no state float32", "max_abs_err": err,
        "ms": time_ms(lambda: rk.rwkv6_scan(*args), flush),
        "bound_ms": fwd_floor[0], "bound_by": fwd_floor[1],
        "plain_backward_ms": time_ms(
            lambda: torch.autograd.grad(ref.rwkv6_reference(*leaves), leaves, (g_out, g_s)),
            flush, iters=5, warmup=1),
        "backward_bound_ms": bwd_floor[0], "backward_bound_by": bwd_floor[1],
        "plain_forward_ms": time_ms(lambda: ref.rwkv6_reference(*args), flush, iters=5, warmup=1),
        "library_forward_backward_ms": None,
    }
    del flush
    torch.cuda.empty_cache()
    return {"flash_attention": flash, "rwkv6_scan": scan}


# ---------------------------------------------------------------------------
# Phase 7: the specs' steps (launch/specs.py) on the card, and the dry-run.
# ---------------------------------------------------------------------------
# a card-sized shape of each kind for qwen1.5-0.5b at full width and depth,
# and kimi-k2's decode at phase 3f's one layer
SPEC_SHAPES = (InputShape("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train"),
               InputShape("prefill_1x512", PROMPT_MAX, 1, "prefill"),
               InputShape("decode_8x2048", CACHE_LEN, SLOTS, "decode"))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _same_specs(name, got, spec):
    """Raise unless the tensors of ``got`` have the shapes and dtypes of the
    meta ``spec`` tree, leaf for leaf."""
    a, b = tree_leaves(got), tree_leaves(spec)
    if len(a) != len(b) or any(x.shape != y.shape or x.dtype != y.dtype for x, y in zip(a, b)):
        raise AssertionError(f"{name}: the tensors on the card differ from the meta specs")


def _bit_equal(name, a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or not all(torch.equal(x, y) for x, y in zip(la, lb)):
        raise AssertionError(f"{name}: build_step's step differs from the direct call")


def spec_step_on_card(cfg, shape, seed):
    """``build_step``'s step for ``cfg`` at ``shape`` on tensors made on the
    card from its meta specs (params from ``init_params``, optimizer state
    from ``adamw_init``, fresh caches from ``init_cache``, random tokens):
    every attention call through the kernels (launch counters), the output
    bit-equal to a direct call of the model's entry point on the same
    tensors, and the dry-run's parameter, optimizer and cache bytes equal to
    the tensors' numel x element size (beside the allocator's growth)."""
    dev = torch.device("cuda")
    step, args, _, _, _ = specs.build_step(cfg, shape, make_production_mesh())
    rec = dryrun.record(cfg, shape)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = model_lib.init_params(cfg, gen, dtype=args[0]["embed"].dtype, device=dev)
    _same_specs("params", params, args[0])
    made = {"params": (_tree_bytes(params), torch.cuda.memory_allocated() - base)}
    b, s = shape.global_batch, shape.seq_len
    tokens = lambda *sh: torch.randint(0, cfg.vocab_size, sh, generator=gen, device=dev,
                                       dtype=torch.int32)
    window = specs.decode_window(cfg, shape)
    moe_path = "ep_a2a" if cfg.num_experts else "local"
    if shape.kind == "train":
        tcfg = train_loop.TrainConfig(
            optimizer=OptimizerConfig(state_dtype=tree_leaves(args[1]["m"])[0].dtype),
            moe_path=moe_path, window=window, remat=True)
        at = torch.cuda.memory_allocated()
        opt = adamw_init(params, tcfg.optimizer)
        _same_specs("optimizer state", opt, args[1])
        made["opt_state"] = (_tree_bytes(opt), torch.cuda.memory_allocated() - at)
        batch = {"inputs": tokens(b, s), "labels": tokens(b, s)}
        _same_specs("batch", batch, args[2])
        direct = lambda: train_loop.make_train_step(cfg, tcfg)(params, opt, batch)
        run = lambda: step(params, opt, batch)
        expected = expected_train_launches(cfg, 1)
    else:
        fresh = lambda: model_lib.init_cache(cfg, b, s, window=window, dtype=params["embed"].dtype,
                                             device=dev)
        at = torch.cuda.memory_allocated()
        caches = [fresh(), fresh()]
        _same_specs("cache", caches[0], args[2])
        made["cache"] = (_tree_bytes(caches[0]), (torch.cuda.memory_allocated() - at) // 2)
        if shape.kind == "prefill":
            inputs = tokens(b, s)
            run = lambda: step(params, inputs, caches[0])
            direct = lambda: model_lib.prefill(cfg, params, inputs, caches[1], window=window,
                                               moe_path=moe_path)
            expected = expected_launches(cfg, 1, 0)
        else:
            inputs = tokens(b)
            run = lambda: step(params, inputs, caches[0])
            direct = lambda: model_lib.decode_step(cfg, params, inputs, caches[1], window=window)
            expected = expected_launches(cfg, 0, 1)
    for mod in KERNELS.values():
        mod.launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = launch_counts()
    if launches != expected:
        raise AssertionError(f"{cfg.name} {shape.name}: launches {launches} != {expected}")
    _bit_equal(f"{cfg.name} {shape.name}", out, direct())
    finite = all(bool(torch.isfinite(t.float()).all()) for t in tree_leaves(out)
                 if t.is_floating_point())
    if not finite:
        raise AssertionError(f"{cfg.name} {shape.name}: non-finite outputs")
    for part, (nbytes, grown) in made.items():
        if rec["bytes"][part] != nbytes:
            raise AssertionError(f"{cfg.name} {shape.name}: the dry-run's {part} bytes "
                                 f"{rec['bytes'][part]} != {nbytes} on the card")
    del params, out
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.num_layers, "shape": dataclasses.asdict(shape),
            "launches": launches, "bit_equal_to_direct_call": True,
            "bytes_dry_run": {part: rec["bytes"][part] for part in made},
            "bytes_on_card": {part: nbytes for part, (nbytes, _) in made.items()},
            "memory_allocated_growth": {part: grown for part, (_, grown) in made.items()},
            "flops_dry_run": rec["flops"]}


DRYRUN_CUT = ("the dry-run's table at one input shape an arch, 10 records instead of all 40, "
              "each arch and each shape at least once: the shallowest arch at the train "
              "shape (a forward and a backward to count), the others deepest first at the "
              "three one-pass shapes in turn; so that the run, with the served slices 3g-3k, "
              "stays within 900 s: the 40 took ~96 s of host time on the H100 machine; "
              "tests/test_torch_dryrun.py holds all 40 on the CPU at one pattern repetition")


def dryrun_plan() -> dict:
    """DRYRUN_CUT's shape for each arch."""
    archs = sorted(list_architectures(), key=lambda a: -get_config(a).num_layers)
    train = [n for n, shape in INPUT_SHAPES.items() if shape.kind == "train"]
    one_pass = [n for n in INPUT_SHAPES if n not in train]
    plan = {arch: one_pass[i % len(one_pass)] for i, arch in enumerate(archs[:-1])}
    return {**plan, archs[-1]: train[0]}


def phase_specs(seed, gpu):
    """qwen1.5-0.5b's train, prefill and decode steps from ``build_step`` on
    the card, kimi-k2's decode step at one layer, then the dry-run's FLOP
    and byte table for every arch x input shape (meta tensors, on the
    host)."""
    t_phase = time.perf_counter()
    qwen = get_config(ARCH)
    kimi = dataclasses.replace(get_config(KIMI_ARCH), num_layers=KIMI_LAYERS)
    steps = [spec_step_on_card(qwen, shape, seed) for shape in SPEC_SHAPES]
    steps.append(spec_step_on_card(kimi, SPEC_SHAPES[2], seed))
    for r in steps:
        print("[specs] " + json.dumps(r))
    t0 = time.perf_counter()
    print(f"[cut] phase 7: {DRYRUN_CUT}")
    table = {}
    for arch, name in dryrun_plan().items():
        rec = dryrun.record(get_config(arch), INPUT_SHAPES[name])
        table[f"{arch} {name}"] = {"flops": rec["flops"], "flops_ideal": rec["flops_ideal"],
                                   **{f"{k}_bytes": v for k, v in rec["bytes"].items()}}
    print("[dryrun] product FLOPs (FlopCounterMode on meta tensors, equal to the analytic "
          "count), the ideal count and bytes, every arch at one input shape (DRYRUN_CUT): "
          + json.dumps(table))
    dry_run_s = time.perf_counter() - t0
    partition = partition_runs()
    return {"steps": steps, "dry_run_s": dry_run_s, "dry_run_cut": DRYRUN_CUT,
            "partition": partition, "gpu": gpu, "phase_s": time.perf_counter() - t_phase}


# the dry-run's partition (launch/dryrun.py:run_one) over the
# single-pod (16, 16) mesh of 256 fake ranks, on meta DTensors on the host
PARTITION_RUNS = (("qwen1.5-0.5b", "train_4k"), (KIMI_ARCH, "decode_32k"),
                  ("whisper-small", "prefill_32k"))


def partition_runs() -> list:
    """``dryrun.run_one`` of each of PARTITION_RUNS at pod1: its collectives
    (the reference's keys, ring-factor bytes) and per-device bytes, each
    printed on a ``[dryrun-partition]`` line; a failed run fails the phase.
    The fake group is gone afterwards (phase 8 starts an NCCL one)."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for arch, shape_name in PARTITION_RUNS:
            rec = dryrun.run_one(arch, shape_name, out_dir=tmp)
            if not rec["ok"]:
                raise AssertionError(f"dry-run partition of {arch} {shape_name}: {rec['error']}")
            row = {"arch": arch, "shape": shape_name, "mesh": rec["partition_mesh"],
                   "collectives": rec["collectives"], "collective_ops": rec["collective_ops"],
                   "per_device": rec["per_device"], "seconds": rec["partition_seconds"]}
            print(f"[dryrun-partition] {arch} {shape_name} pod1: collectives.total "
                  f"{rec['collectives']['total']} B in {rec['collectives']['count']}, "
                  f"per_device.total {rec['per_device']['total']} B, "
                  f"{rec['partition_seconds']:.1f} s: " + json.dumps(row))
            out.append(row)
    if dist.is_initialized():
        raise AssertionError("the dry-run left its fake process group up")
    return out


# ---------------------------------------------------------------------------
# Phase 8: the multi-device paths at one rank.
# ---------------------------------------------------------------------------
# phi3.5-moe through expert parallelism on a (1, 1) mesh of one NCCL rank:
# its f32 check at full width and EP_F32_LAYERS layers (forward and one
# loss_fn gradient), then phase 3c's bf16 slice on one EP_TOKENS-token prompt
EP_F32_LAYERS, EP_TOKENS = 2, PROMPT_MAX
# relative to each leaf's largest magnitude: at one shard the capacity is
# the batch's, aux is the same and the exchange is a copy, so EP runs the
# sort path's arithmetic
EP_TOL = 1e-5
EP_RULES = {"experts": "model", "batch": ("data",)}
# each MoE path's layer and parts, each inside a profiler range "ep.<label>"
EP_RANGES = {"ep_a2a": {"layer": "moe_ep_a2a", "all_to_all": "_all_to_all",
                        "route": "_route", "experts": "_expert_ffn"},
             "local": {"layer": "moe_sort_local", "route": "_route", "experts": "_expert_ffn"}}
# the sharded grid's check: three archs over 120 ticks, two zoo cells
GRID_CHECK_ARCHS, GRID_CHECK_TICKS = ["llama3-8b", "minicpm-2b", "qwen1.5-0.5b"], 120


def rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


def ep_f32_check(seed, rules, tokens):
    """phi3.5-moe at full width and EP_F32_LAYERS layers in f32: ``forward``
    and one ``loss_fn`` gradient through ``moe_path="ep_a2a"`` on the
    one-rank mesh against ``"local"``: logits, aux, loss and every gradient
    leaf within EP_TOL of the leaf's largest magnitude."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=EP_F32_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model_lib.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
    batch = {"inputs": tokens, "labels": labels}
    out = {}
    for path in ("ep_a2a", "local"):
        with axis_rules(rules):
            with torch.no_grad():
                logits, aux = model_lib.forward(cfg, params, tokens, moe_path=path)
            loss, _ = model_lib.loss_fn(cfg, params, batch, moe_path=path)
            grads = torch.autograd.grad(loss, leaves)
        out[path] = {"logits": logits, "aux": aux, "loss": loss.detach(), "grads": grads}
    ep, local = out["ep_a2a"], out["local"]
    errs = {k: rel_err(ep[k], local[k]) for k in ("logits", "aux", "loss")}
    grad_errs = [rel_err(a, b) for a, b in zip(ep["grads"], local["grads"])]
    errs["grads_max"] = max(grad_errs)
    names = leaf_names(params)
    bad = {k: v for k, v in errs.items() if not v <= EP_TOL}
    bad.update({names[i]: e for i, e in enumerate(grad_errs) if not e <= EP_TOL})
    if bad:
        raise AssertionError(f"EP at one rank departs from the sort path by more than "
                             f"{EP_TOL} relative: {bad}")
    check_grads(params, list(ep["grads"]))
    del params, out, ep, local
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": EP_F32_LAYERS, "tokens": tokens.shape[1],
            "tolerance": EP_TOL, "rel_err": errs, "grad_leaves": len(grad_errs)}


def ep_profile(fwd, path):
    """Device time of one forward through ``path`` with each of EP_RANGES'
    parts in its profiler range: the whole forward's and each range's."""
    with contextlib.ExitStack() as stack:
        for label, name in EP_RANGES[path].items():
            stack.enter_context(wrapped(moe_lib, name, in_range(f"ep.{label}")))
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            fwd(path)
            torch.cuda.synchronize()
    busy = sum(device_times(prof).values())
    ranges = {label: 0.0 for label in EP_RANGES[path]}
    for e in prof.events():
        label = e.name[len("ep."):]
        if e.name.startswith("ep.") and label in ranges and \
                e.device_type == torch.autograd.DeviceType.CPU:
            ranges[label] += e.device_time_total
    if not (ranges["layer"] and ranges["experts"]) or ranges["layer"] > busy:
        raise AssertionError(f"{path}: the MoE profiler ranges hold no device time, or more "
                             f"than the {busy} us of the forward: {ranges}")
    return {"forward_device_ms": busy / 1e3,
            **{f"moe_{label}_ms": us / 1e3 for label, us in ranges.items()}}


def ep_bf16_run(seed, rules, tokens):
    """Phase 3c's slice (phi3.5-moe, full width, MOE_LAYERS layers, bf16):
    one forward through EP on the one-rank mesh with the launch counters
    from 0 (flash attention once a layer), then the forward's and the MoE
    layers' device time through EP (the all-to-alls in a range of their
    own) beside the sort path's, and the largest logit difference."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16, device="cuda")

    def fwd(path):
        with axis_rules(rules), torch.no_grad():
            return model_lib.forward(cfg, params, tokens, moe_path=path)[0]

    for path in ("ep_a2a", "local"):                 # warm-up
        fwd(path)
    torch.cuda.synchronize()
    for mod in KERNELS.values():
        mod.launches = 0
    logits = fwd("ep_a2a")
    torch.cuda.synchronize()
    launches = launch_counts()
    expected = expected_launches(cfg, 1, 0)
    if launches != expected:
        raise AssertionError(f"EP forward: kernel launches {launches} != {expected}")
    if logits.shape != (1, tokens.shape[1], cfg.vocab_size) or \
            not bool(torch.isfinite(logits.float()).all()):
        raise AssertionError(f"EP forward: logits {tuple(logits.shape)} or not finite")
    diff = float((logits.float() - fwd("local").float()).abs().max())
    prof = {path: ep_profile(fwd, path) for path in ("ep_a2a", "local")}
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": MOE_LAYERS, "dtype": "bfloat16",
            "tokens": tokens.shape[1], "launches": launches,
            "max_abs_logit_diff_ep_vs_local": diff, "profile": prof,
            "ep_minus_local_forward_device_ms": (prof["ep_a2a"]["forward_device_ms"]
                                                 - prof["local"]["forward_device_ms"]),
            "ep_minus_local_moe_device_ms": (prof["ep_a2a"]["moe_layer_ms"]
                                             - prof["local"]["moe_layer_ms"])}


# phase 8b: qwen1.5-0.5b's build_step steps partitioned on the one-rank
# (1, 1) mesh (DTensor arguments placed by make_rules' specs), bf16 at full
# width and depth at phase 7's prefill and decode shapes; the f32 check at
# full width and SHARDED_F32_LAYERS layers, its train step on a
# SHARDED_TRAIN batch; each decode step timed SHARDED_TIMED times
SHARDED_F32_LAYERS, SHARDED_TRAIN, SHARDED_TIMED = 2, (2, 128), 10
# bf16 logits, DTensor steps vs plain ones at one rank: the same kernels and
# products on the same local tensors; one bf16 step of the logits' scale
# (tests/test_torch_moe.py's bf16 tolerance)
SHARDED_BF16_TOL = 2e-2


def _placed_step(cfg, shape, mesh, params, dev, gen):
    """``build_step``'s step at ``shape`` and its real arguments on ``mesh``,
    placed by its specs (``specs.place``), beside the same arguments as
    plain tensors: (step, rules, sharded args, plain args)."""
    step, _, arg_specs, rules, _ = specs.build_step(cfg, shape, mesh,
                                                    param_dtype=tree_leaves(params)[0].dtype)
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
        labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -1)], dim=1)
        opt = adamw_init(params, OptimizerConfig())
        plain = (params, opt, {"inputs": tokens, "labels": labels})
    else:
        tokens = torch.randint(0, cfg.vocab_size, (b, s) if shape.kind == "prefill" else (b,),
                               generator=gen, device=dev)
        plain = (params, tokens, model_lib.init_cache(cfg, b, s, dtype=params["embed"].dtype,
                                                      device=dev))
    sharded = tuple(specs.place(a, sp, mesh) for a, sp in zip(plain, arg_specs))
    if shape.kind != "train":          # each run writes its own cache
        plain = (plain[0], plain[1], model_lib.init_cache(cfg, b, s, dtype=params["embed"].dtype,
                                                          device=dev))
    return step, rules, sharded, plain


def _local_calls():
    """A wrapper of ``ops.local_call`` that counts the kernels' calls
    through ``local_map``."""
    seen = {"n": 0}

    def wrapper(real):
        def run(*args, **kwargs):
            seen["n"] += 1
            return real(*args, **kwargs)
        return run
    return seen, wrapper


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def sharded_bf16(seed, mesh):
    """qwen1.5-0.5b at full width and depth in bf16: ``build_step``'s
    prefill (1 x 512) and decode (8 slots, cache 2048) on DTensor arguments
    with the launch counters from 0: every flash and decode call through
    ``local_map`` (``ops.local_call`` counted), the launches expected, the
    logits against the same steps on plain tensors; then the host and
    device ms of the decode step, sharded and plain."""
    cfg, dev = get_config(ARCH), torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model_lib.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    out, launches = {}, {name: 0 for name in KERNELS}
    calls, counting = _local_calls()
    for shape in SPEC_SHAPES[1:]:
        step, rules, sharded, plain = _placed_step(cfg, shape, mesh, params, dev, gen)
        with torch.no_grad():
            want = _whole(step(*plain)[0])
            for mod in KERNELS.values():
                mod.launches = 0
            calls["n"] = 0
            with axis_rules(rules), wrapped(ops, "local_call", counting):
                got = step(*sharded)[0]
            torch.cuda.synchronize()
        ran = launch_counts()
        expected = expected_launches(cfg, 1 if shape.kind == "prefill" else 0,
                                     1 if shape.kind == "decode" else 0)
        if ran != expected or calls["n"] != sum(expected.values()):
            raise AssertionError(f"sharded {shape.name}: launches {ran} (expected {expected}), "
                                 f"{calls['n']} calls through local_map")
        got = _whole(got)
        err = rel_err(got, want)
        if got.shape != want.shape or not bool(torch.isfinite(got.float()).all()) or \
                not err <= SHARDED_BF16_TOL:
            raise AssertionError(f"sharded {shape.name}: logits {tuple(got.shape)}, rel err {err}")
        launches = {k: launches[k] + ran[k] for k in launches}
        out[shape.name] = {"launches": ran, "local_map_calls": calls["n"], "logits_rel_err": err,
                           "bit_equal": bool(torch.equal(got, want))}
        if shape.kind == "decode":
            out["decode_timing"] = decode_step_cost(step, rules, sharded, plain)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": cfg.num_layers, "dtype": "bfloat16", "steps": out,
            "launches": launches}


def decode_step_cost(step, rules, sharded, plain):
    """Host ms of one decode step (the card synchronised after each, median
    of SHARDED_TIMED) and its device ms from ``torch.profiler`` (the sum of
    its kernels' device time), on DTensors and on plain tensors."""
    res = {}
    for name, args, ctx in (("sharded", sharded, lambda: axis_rules(rules)),
                            ("plain", plain, contextlib.nullcontext)):
        with torch.no_grad(), ctx():
            step(*args)
            torch.cuda.synchronize()
            host = []
            for _ in range(SHARDED_TIMED):
                t0 = time.perf_counter()
                step(*args)
                torch.cuda.synchronize()
                host.append(1e3 * (time.perf_counter() - t0))
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                step(*args)
                torch.cuda.synchronize()
        res[name] = {"host_ms": float(np.median(host)),
                     "device_ms": sum(device_times(prof).values()) / 1e3}
    if not (res["sharded"]["device_ms"] > 0 and res["plain"]["device_ms"] > 0):
        raise AssertionError(f"a decode step's profile holds no device time: {res}")
    res["host_ms_ratio"] = res["sharded"]["host_ms"] / res["plain"]["host_ms"]
    res["device_ms_ratio"] = res["sharded"]["device_ms"] / res["plain"]["device_ms"]
    return res


def sharded_f32(seed, mesh):
    """qwen1.5-0.5b at full width and SHARDED_F32_LAYERS layers in f32, on
    DTensors against plain tensors: the prefill's and the decode step's
    logits, then ``loss_fn``'s loss and every gradient leaf (the backward
    under ``partitioned``) and one ``make_train_step`` step's loss, each
    within EP_TOL of the leaf's largest magnitude; whether each is
    bit-equal is printed, not required."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=SHARDED_F32_LAYERS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = model_lib.init_params(cfg, gen, dtype=torch.float32, device=dev)
    errs, equal = {}, {}
    for shape in SPEC_SHAPES[1:]:
        step, rules, sharded, plain = _placed_step(cfg, shape, mesh, params, dev, gen)
        with torch.no_grad():
            want = step(*plain)[0]
            with axis_rules(rules):
                got = _whole(step(*sharded)[0])
        errs[f"{shape.kind}_logits"] = rel_err(got, want)
        equal[f"{shape.kind}_logits"] = bool(torch.equal(got, want))
    b, s = SHARDED_TRAIN
    shape = InputShape(f"train_{b}x{s}", s, b, "train")
    step, rules, sharded, plain = _placed_step(cfg, shape, mesh, params, dev, gen)
    grads = {}
    for name, (p, _, batch) in (("sharded", sharded), ("plain", plain)):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        with axis_rules(rules), partitioned(rules):
            loss, _ = model_lib.loss_fn(cfg, tree_unflatten(p, leaves), batch,
                                        remat=True)
            grads[name] = (_whole(loss).detach(),
                           [_whole(g) for g in torch.autograd.grad(loss, leaves)])
    errs["loss"] = rel_err(grads["sharded"][0], grads["plain"][0])
    equal["loss"] = bool(torch.equal(grads["sharded"][0], grads["plain"][0]))
    grad_errs = [rel_err(a, b) for a, b in zip(grads["sharded"][1], grads["plain"][1])]
    errs["grads_max"] = max(grad_errs)
    equal["grads"] = all(torch.equal(a, b) for a, b in zip(grads["sharded"][1],
                                                           grads["plain"][1]))
    with axis_rules(rules):
        got = _whole(step(*sharded)[2]["loss"])
    want = step(*plain)[2]["loss"]
    errs["train_step_loss"] = rel_err(got, want)
    equal["train_step_loss"] = bool(torch.equal(got, want))
    names = leaf_names(params)
    bad = {k: v for k, v in errs.items() if not v <= EP_TOL}
    bad.update({names[i]: e for i, e in enumerate(grad_errs) if not e <= EP_TOL})
    if bad:
        raise AssertionError(f"the partitioned step departs from the plain one by more than "
                             f"{EP_TOL} relative: {bad}")
    check_grads(params, grads["sharded"][1])
    del params, grads
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": cfg.name, "layers": SHARDED_F32_LAYERS, "tolerance": EP_TOL,
            "rel_err": errs, "bit_equal": equal, "grad_leaves": len(grad_errs)}


def phase_sharded_step(seed, gpu, mesh):
    """Phase 8b, under phase 8's NCCL group of one rank: the partitioned
    steps (``sharded_bf16``, ``sharded_f32``) on ``make_test_mesh((1, 1))``
    with make_rules' rules."""
    t0 = time.perf_counter()
    res = {"mesh": {"names": list(mesh.mesh_dim_names), "shape": list(mesh.shape)},
           "bf16": sharded_bf16(seed, mesh), "f32_check": sharded_f32(seed, mesh), "gpu": gpu}
    res["launches"] = res["bf16"]["launches"]
    res["phase_s"] = time.perf_counter() - t0
    t = res["bf16"]["steps"]["decode_timing"]
    print(f"[sharded-step] qwen1.5-0.5b on DTensors at one NCCL rank: launches "
          f"{json.dumps(res['launches'])}; f32 rel err {json.dumps(res['f32_check']['rel_err'])}, "
          f"bit-equal {json.dumps(res['f32_check']['bit_equal'])}; decode step host ms "
          f"{t['sharded']['host_ms']:.3f} sharded vs {t['plain']['host_ms']:.3f} plain, device ms "
          f"{t['sharded']['device_ms']:.4f} vs {t['plain']['device_ms']:.4f} ({gpu})")
    return res


def grid_without_a_group(seed):
    """``run_grid`` on the card with no process group: ``sharded=None`` is
    the one-dispatch run, bit for bit, and ``sharded=True`` raises, as the
    reference's assert does."""
    if device_mesh() is not None:
        raise AssertionError("a device mesh without a process group")
    a = len(GRID_CHECK_ARCHS)
    wl = [core_sim.ArchLoad(name, 1.0 / a, 0.25, name=f"m@{i}")
          for i, name in enumerate(GRID_CHECK_ARCHS)]
    arrs = np.stack([SCENARIO_ZOO[n].build(a, duration_s=GRID_CHECK_TICKS, seed=seed + i)
                     for i, n in enumerate(("shared_berkeley", "mmpp_bursts"))])
    try:
        torch_engine.run_grid(arrs, wl, "portfolio", seeds=[5, 6], sharded=True)
    except ValueError as err:
        refused = str(err)
    else:
        raise AssertionError("run_grid(sharded=True) ran without a process group")
    auto = torch_engine.run_grid(arrs, wl, "portfolio", seeds=[5, 6])
    one = torch_engine.run_grid(arrs, wl, "portfolio", seeds=[5, 6], sharded=False)
    for i, (x, y) in enumerate(zip(auto, one)):
        if x["summary"] != y["summary"] or x["ledger"] != y["ledger"]:
            raise AssertionError(f"grid cell {i}: sharded=None differs from sharded=False")
    return {"cells": len(auto), "ticks": GRID_CHECK_TICKS, "archs": a,
            "auto_equals_one_dispatch": True, "sharded_true_raises": refused}


def phase_multi_device(seed, gpu, prompt):
    """Expert parallelism and the sharded grid at one rank: an NCCL group
    of one (a FileStore in a temporary directory) and ``make_test_mesh((1,
    1))`` on the card, rules mapping ``experts`` to ``model``; the f32
    check, the bf16 run, then the group destroyed and the grid run without
    one."""
    t_phase = time.perf_counter()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = make_test_mesh((1, 1))
            if not isinstance(mesh, DeviceMesh) or mesh.device_type != "cuda":
                raise AssertionError(f"make_test_mesh under a group gave {mesh!r}")
            rules = AxisRules(mesh, dict(EP_RULES))
            tokens = torch.as_tensor(np.resize(prompt, EP_TOKENS), dtype=torch.long,
                                     device="cuda")[None, :]
            result = {"backend": dist.get_backend(), "world_size": dist.get_world_size(),
                      "mesh": {"names": list(mesh.mesh_dim_names),
                               "shape": list(mesh.shape), "device_type": mesh.device_type},
                      "rules": EP_RULES}
            result["f32_check"] = ep_f32_check(seed, rules, tokens)
            result["bf16"] = ep_bf16_run(seed, rules, tokens)
            result["sharded_step"] = phase_sharded_step(seed, gpu, mesh)
        finally:
            dist.destroy_process_group()
    result["grid"] = grid_without_a_group(seed)
    result["launches"] = {k: result["bf16"]["launches"][k]
                          + result["sharded_step"]["launches"][k] for k in KERNELS}
    result["gpu"] = gpu
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"[multi-device] EP at one NCCL rank: f32 rel err {json.dumps(result['f32_check']['rel_err'])}; "
          f"bf16 MoE device ms EP {result['bf16']['profile']['ep_a2a']['moe_layer_ms']:.4f} "
          f"(all-to-alls {result['bf16']['profile']['ep_a2a']['moe_all_to_all_ms']:.4f}) vs "
          f"sort {result['bf16']['profile']['local']['moe_layer_ms']:.4f}")
    return result


def record_routes(into):
    """A wrapper of ``_route`` that appends each call's expert indices to ``into``."""
    def wrapper(route):
        def run(cfg, router_w, xf):
            gates, topi, aux = route(cfg, router_w, xf)
            into.append(topi.cpu())
            return gates, topi, aux
        return run
    return wrapper


def compare_routes(cfg, card, cpu):
    """Raise if any call chose other experts on the card than on the CPU;
    calls run layer by layer for the prefill, then for each decode step."""
    if len(card) != len(cpu):
        raise AssertionError(f"{len(card)} routing calls on the card, {len(cpu)} on the CPU")
    flips = {f"call {i} (step {i // cfg.num_layers}, layer {i % cfg.num_layers})":
             int((a != b).any(dim=-1).sum()) for i, (a, b) in enumerate(zip(card, cpu))
             if not torch.equal(a, b)}
    if flips:
        raise AssertionError(f"{cfg.name}: experts chosen differ between card and CPU "
                             f"(tokens with another choice): {flips}")
    return {"routing_calls": len(card), "tokens_routed": int(sum(a.shape[0] for a in card)),
            "experts_equal": True}


def kernel_time(by_kernel, patterns) -> float:
    """Device time of the kernels whose names hold one of ``patterns``;
    raises if the profile has device time but none of those kernels."""
    own = sum(us for k, us in by_kernel.items() if any(p in k for p in patterns))
    if own == 0 and any(by_kernel.values()):
        held = sorted(by_kernel.items(), key=lambda kv: -kv[1])
        raise AssertionError(
            f"no kernel named like {patterns} in the profile; it held {len(held)} kernel "
            f"names, {sum(by_kernel.values()):.1f} us, the largest: "
            + json.dumps({k[:80]: us for k, us in held[:12]}))
    return own


def profile_decode(engine, prompts, kernel, steps=8):
    """``profile_steps`` of the engine's ``step`` with all slots live.  Runs
    after the served run; its launches are not counted against the main
    path."""
    for i, p in enumerate(prompts[:SLOTS]):
        engine.insert(Request(rid=1000 + i, prompt=p, max_new_tokens=steps + 1))
    return profile_steps(engine.step, kernel, steps)


def profile_steps(step, kernel, steps=8):
    """Device time of ``steps`` calls of ``step`` (one decode step each),
    from ``torch.profiler``: busy share of the host-clock window, the time
    of ``kernel`` = (label, name patterns) and the kernels that take the
    most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    before = da.launches
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    by_kernel = device_times(prof)
    busy = sum(by_kernel.values())
    own = kernel_time(by_kernel, kernel[1])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    per_call = (decode_kernels_a_call(prof, da.launches - before)
                if kernel[0] == "decode_attention" else {})
    return {
        "steps": steps, "profiled_wall_ms_per_step": wall_us / steps / 1e3, **per_call,
        "device_ms_per_step": busy / steps / 1e3,
        "device_busy_share_profiled": busy / wall_us,
        f"{kernel[0]}_ms_per_step": own / steps / 1e3, f"{kernel[0]}_share_of_device": own / busy,
        "top_kernels_ms_per_step": {k[:80]: us / steps / 1e3 for k, us in top},
        **moe_breakdown(prof, busy, steps, "_ms_per_step"),
    }


def decode_kernels_a_call(prof, calls) -> dict:
    """The decode library's kernels in a profile of ``calls`` decode calls:
    each is ``da_cluster_kernel``, one launch a call (the profiler may drop
    a kernel's record, never add one, so the count may fall short of the
    calls but never exceed them)."""
    found = {e.key: e.count for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and "namespace)::da_" in e.key}
    n = sum(found.values())
    if calls < 1 or n > calls or any(not any(p in k for p in DECODE_KERNELS) for k in found):
        raise AssertionError(f"{calls} decode calls ran the decode kernels {found}")
    return {"decode_calls": calls, "decode_kernels_in_profile": n}


def device_times(prof):
    """Device time by kernel name: device-side events only (kernels, copies,
    memsets); a CPU op's entry repeats the device time of what it launched,
    and a profiler range's device-side mirror spans other kernels."""
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation}


def moe_breakdown(prof, busy, per, suffix):
    """Device time (ms per ``per`` calls of the profiled work) and share of
    the busy time of the MoE layer's parts, from the MOE_RANGES profiler
    ranges: the device time of the kernels launched inside each; empty when
    no range was recorded, and raises when ranges hold no device time."""
    ranges = {label: 0.0 for label in MOE_RANGES}
    seen = False
    for e in prof.events():
        label = e.name[len("moe."):]
        if (e.name.startswith("moe.") and label in ranges
                and e.device_type == torch.autograd.DeviceType.CPU):
            ranges[label] += e.device_time_total
            seen = True
    if not seen:
        return {}
    if (busy and not (ranges["layer"] and ranges["experts"])) or ranges["layer"] > busy:
        raise AssertionError(f"the MoE profiler ranges hold no device time, or more than "
                             f"the {busy} us of the profile: {ranges}")
    parts = {"moe_layers": ranges["layer"], "moe_experts": ranges["experts"],
             "moe_route": ranges["route"],
             "moe_dispatch_combine": ranges["layer"] - ranges["experts"] - ranges["route"]}
    out = {f"{name}{suffix}": us / per / 1e3 for name, us in parts.items()}
    out.update({f"{name}_share_of_device": us / busy for name, us in parts.items()})
    return out


def kernel_records(prof, patterns) -> dict:
    """The records of the kernels named like ``patterns`` in one prefill
    profile, by each of the two readers: ``prof.key_averages()`` (what
    ``device_times`` reads) and the raw kineto events (what ``read_profile``
    reads), each their number and device µs; and, from the raw events, the
    kernel launches traced (runtime calls named like ``LaunchKernel``) after
    the PROFILE_PAD_LAUNCHES that open the profile, for each of these whose
    kernel has no record [its place among them, µs from the trace's start
    to it], how many of the opening launches have none, and the names of
    those that have one."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    results = prof.profiler.kineto_results
    events = results.events()
    avg = [e for e in prof.key_averages() if e.device_type == cuda
           and not e.is_user_annotation and any(p in e.key for p in patterns)]
    device = [e for e in events if e.device_type() == cuda and not e.is_user_annotation()]
    raw = [e for e in device if any(p in e.name() for p in patterns)]
    recorded = {e.correlation_id() for e in device}
    launches = sorted((e for e in events if e.device_type() == cpu and "LaunchKernel" in e.name()),
                      key=lambda e: e.start_ns())
    pad = {e.correlation_id() for e in launches[:PROFILE_PAD_LAUNCHES]}
    return {"key_averages": sum(e.count for e in avg),
            "key_averages_us": sum(e.self_device_time_total for e in avg),
            "raw": len(raw), "raw_us": sum(e.duration_ns() for e in raw) / 1e3,
            "launches_traced": len(launches) - PROFILE_PAD_LAUNCHES,
            "unrecorded": [[i, (e.start_ns() - results.trace_start_ns()) / 1e3]
                           for i, e in enumerate(launches[PROFILE_PAD_LAUNCHES:])
                           if e.correlation_id() not in recorded],
            "pad_unrecorded": len(pad - recorded),
            "pad_kernels": sorted({e.name() for e in device if e.correlation_id() in pad})}


# profiled prefills a profile_prefill call makes at most while its profile
# lacks a record of one of the prefill's launches; each such miss is allowed
# only where the output check and the counter show that the kernel ran
PREFILL_PROFILE_TRIES = 3
# the profiler loses the kernel records of a prefix of a profile's launches,
# never of a later launch (chip_profile_repeat.py: up to 31 launches in 370
# profiles of 140 and 1845 launches on an H100), so each
# prefill profile opens with this many launches of a device sleep of
# PROFILE_PAD_CYCLES (~0.1 ms each), whose own records no reading uses
PROFILE_PAD_LAUNCHES = 256
PROFILE_PAD_CYCLES = 200_000


def profile_prefill(engine, prompt, kernel, length=PROMPT_MAX, inputs=None):
    """Device time of one ``length``-token prefill, the engine's own call
    (batch 1, a fresh one-sequence cache), after one unprofiled warm-up
    (``inputs`` (1, S, d), a VLM's embeddings, in place of the prompt):
    busy share of its host-clock window, the time and share of device time
    of ``kernel`` = (label, name patterns) and the kernels that take the
    most.

    Each profiled prefill is held to the warm-up: its launch counter must
    count the kernel's launches of one prefill and its last-token logits
    must equal the warm-up's bit for bit (no float atomics on the path, so
    a run repeats itself); a prefill of other tokens runs unprofiled just
    before it, so that an output buffer the caching allocator hands back
    holds that prefill's values and a lost launch shows.  The profile opens
    with PROFILE_PAD_LAUNCHES device sleeps, on which the profiler's lost
    prefix of records falls; their kernels are left out of every reading.
    A profile in which a launch of the prefill has no record, or which
    holds fewer records of the kernel than launches, is a miss: printed
    with its count, and the prefill is profiled again, at most
    PREFILL_PROFILE_TRIES times in all, before ``kernel_time`` fails.  Each
    profile's readings are returned under ``"profiles"``."""
    if inputs is None:
        tokens = torch.as_tensor(np.resize(prompt, length), dtype=torch.long,
                                 device=engine.device)[None, :]
        other = torch.roll(tokens, 1, dims=1) + 1
        other = torch.where(other < engine.cfg.vocab_size, other, torch.zeros_like(other))
    else:
        tokens, other = inputs, torch.roll(inputs, 1, dims=1)
    length = tokens.shape[1]

    def run(x):
        return model_lib.prefill(engine.cfg, engine.params, x, engine._init_cache(1),
                                 window=engine.ecfg.window)[0]

    mod = KERNELS[kernel[0]]
    per_call = expected_launches(engine.cfg, 1, 0)[kernel[0]]
    expect = run(tokens)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    readings, found = [], None
    while found is None and len(readings) < PREFILL_PROFILE_TRIES:
        run(other)
        torch.cuda.synchronize()
        before = mod.launches
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILE_PAD_LAUNCHES):
                torch.cuda._sleep(PROFILE_PAD_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = run(tokens)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        reading = {"launches": mod.launches - before, "logits_equal": torch.equal(logits, expect),
                   **kernel_records(prof, kernel[1])}
        pad = reading.pop("pad_kernels")
        readings.append(reading)
        if reading["launches"] != per_call or not reading["logits_equal"]:
            raise AssertionError(
                f"{engine.cfg.name}: profiled prefill {len(readings)}: {json.dumps(reading)}; "
                f"{per_call} {kernel[0]} launches a prefill, logits equal to the warm-up's")
        if (reading["key_averages"] >= per_call and reading["key_averages_us"]
                and not reading["unrecorded"]):
            found = prof, wall_us, pad
    misses = {reader: sum(r[reader] < per_call for r in readings)
              for reader in ("key_averages", "raw")}
    misses["launches"] = sum(bool(r["unrecorded"]) for r in readings)
    if any(misses.values()):
        print(f"[profile] {engine.cfg.name} prefill: of {len(readings)} profiles, "
              f"{misses['key_averages']} (key_averages) and {misses['raw']} (raw events) held "
              f"fewer than the {per_call} {kernel[0]} launches the counter saw, and "
              f"{misses['launches']} lacked the record of a launch, with the logits equal "
              f"to the warm-up's: " + json.dumps(readings))
    prof, wall_us, pad = found or (prof, wall_us, pad)
    by_kernel = {name: us for name, us in device_times(prof).items() if name not in pad}
    busy = sum(by_kernel.values())
    own = kernel_time(by_kernel, kernel[1])
    if kernel[0] == "flash_attention":
        check_only_kernel(by_kernel, FLASH_KERNELS, kernel[1])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {
        "prompt_tokens": length, "profiled_wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
        "device_busy_share_profiled": busy / wall_us,
        f"{kernel[0]}_ms": own / 1e3, f"{kernel[0]}_share_of_device": own / busy,
        "top_kernels_ms": {k[:80]: us / 1e3 for k, us in top},
        **moe_breakdown(prof, busy, 1, "_ms"),
        "profiles_taken": len(readings), "profile_misses": misses, "profiles": readings,
    }


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _teacher_forced(cfg, params, prompt, tokens, device, enc_inputs=None, image=None,
                    window=0):
    """Prefill plus F32_DECODE_STEPS decode steps of batch 1; feeds ``tokens``
    when given, else the greedy ones, which it returns.  With ``image``
    (patches, d) the prefill takes embeddings, the patches then the
    prompt's rows of the embedding table, as ``frontends.multimodal_inputs``
    builds them; with ``window`` the cache is a ring of ``window`` slots."""
    inputs = prompt[None].to(device)
    if image is not None:
        inputs = torch.cat([image.to(device, params["embed"].dtype)[None],
                            params["embed"][inputs]], dim=1)
    cache = model_lib.init_cache(cfg, 1, window or inputs.shape[1] + F32_DECODE_STEPS,
                                 window=window, dtype=torch.float32, device=device)
    enc = enc_inputs.to(device) if enc_inputs is not None else None
    logits, cache = model_lib.prefill(cfg, params, inputs, cache, enc_inputs=enc, window=window)
    out, fed = [logits], []
    for i in range(F32_DECODE_STEPS):
        tok = tokens[i] if tokens is not None else int(torch.argmax(logits[0]))
        fed.append(tok)
        logits, cache = model_lib.decode_step(
            cfg, params, torch.tensor([tok], dtype=torch.long, device=device), cache,
            window=window)
        out.append(logits)
    return out, fed


def served_prompts(seed) -> dict:
    """The slices' traffic by arch: N_REQUESTS prompts of PROMPT_MIN to
    PROMPT_MAX tokens from ``seed`` for the main path, and the same lengths
    in each other served model's vocabulary; under LONG_SLICE LONG_REQUESTS
    prompts of LONG_MIN to LONG_MAX tokens in llama3-8b's, and under
    VLM_ARCH VLM_BATCHES batches of SLOTS text prompts of VLM_TEXT tokens."""
    rng = np.random.default_rng(seed)
    vocab = get_config(ARCH).vocab_size
    prompts = [
        rng.integers(0, vocab, size=int(rng.integers(PROMPT_MIN, PROMPT_MAX + 1))).astype(np.int32)
        for _ in range(N_REQUESTS)
    ]
    out = {ARCH: prompts}
    for arch in (RWKV_ARCH, MOE_ARCH, RG_ARCH, KIMI_ARCH, LLAMA_ARCH, MINICPM_ARCH, QWEN2_ARCH):
        v = get_config(arch).vocab_size
        out[arch] = [rng.integers(0, v, size=len(p)).astype(np.int32) for p in prompts]
    v = get_config(LLAMA_ARCH).vocab_size
    out[LONG_SLICE] = [
        rng.integers(0, v, size=int(rng.integers(LONG_MIN, LONG_MAX + 1))).astype(np.int32)
        for _ in range(LONG_REQUESTS)]
    v = get_config(VLM_ARCH).vocab_size
    out[VLM_ARCH] = [rng.integers(0, v, size=(SLOTS, VLM_TEXT)).astype(np.int32)
                     for _ in range(VLM_BATCHES)]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase_analysis()
    gpu = phase_build()
    traffic = served_prompts(args.seed)
    prompts, rwkv_prompts, moe_prompts, rg_prompts, kimi_prompts = (
        traffic[a] for a in (ARCH, RWKV_ARCH, MOE_ARCH, RG_ARCH, KIMI_ARCH))
    rows = phase_kernels(args.seed, [len(p) for p in prompts],
                         [len(p) for p in traffic[LONG_SLICE]])
    rows.append(phase_rwkv_kernel(args.seed))
    qwen = get_config(ARCH)
    moe = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_LAYERS)
    kimi = dataclasses.replace(get_config(KIMI_ARCH), num_layers=KIMI_LAYERS)
    llama = get_config(LLAMA_ARCH)
    # one slice at a time: each phase frees its weights before the next
    slices = [phase_slice(qwen, args.seed, prompts, gpu,
                          lambda seed, prompt: f32_check(qwen, seed, prompt)),
              phase_slice(get_config(RWKV_ARCH), args.seed, rwkv_prompts, gpu, f32_check_rwkv),
              phase_slice(moe, args.seed, moe_prompts, gpu, f32_check_moe),
              phase_slice(get_config(RG_ARCH), args.seed, rg_prompts, gpu, f32_check_rg),
              phase_whisper(args.seed, gpu),
              phase_slice(kimi, args.seed, kimi_prompts, gpu, f32_check_kimi),
              phase_slice(llama, args.seed, traffic[LLAMA_ARCH], gpu,
                          f32_check_cut(LLAMA_ARCH, LLAMA_F32_LAYERS)),
              phase_slice(llama, args.seed, traffic[LONG_SLICE], gpu, f32_check_long,
                          cache_len=LONG_CACHE, window=llama.long_context_window,
                          prefill_length=LONG_MAX, label=LONG_SLICE),
              phase_slice(get_config(MINICPM_ARCH), args.seed, traffic[MINICPM_ARCH], gpu,
                          f32_check_cut(MINICPM_ARCH, MINICPM_F32_LAYERS)),
              phase_slice(dataclasses.replace(get_config(QWEN2_ARCH), num_layers=QWEN2_LAYERS),
                          args.seed, traffic[QWEN2_ARCH], gpu,
                          f32_check_cut(QWEN2_ARCH, QWEN2_F32_LAYERS)),
              phase_vlm(args.seed, traffic[VLM_ARCH], gpu)]
    control = phase_control_plane(args.seed)
    ppo_run = phase_ppo(args.seed)
    trained = [phase_train(args.seed, gpu, prompts[0]), phase_train_rwkv(args.seed, gpu)]
    at_training_shapes = time_training_kernels(args.seed)
    spec_run = phase_specs(args.seed, gpu)
    multi = phase_multi_device(args.seed, gpu, moe_prompts[0])
    for row in rows:
        row["launches"] = sum(res["launches"][row["name"]] for res in slices + trained + [multi])
        if row["name"] in at_training_shapes:
            row["training"] = at_training_shapes[row["name"]]
    for res in slices:
        print(json.dumps({"slice": res}))
    print(json.dumps({"control_plane": control}))
    print(json.dumps({"ppo": ppo_run}))
    print(json.dumps({"train": trained}))
    print(json.dumps({"specs": spec_run}))
    print(json.dumps({"multi_device": multi}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
