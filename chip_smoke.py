#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their plain
versions.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):

1. device   the card's name, count, and nvidia-smi's name and power limit;
2. build    nvcc builds every kernel from the sources in the checkout;
3. check    each kernel against its plain PyTorch version on the card, on
            the reference's shape sweep, ragged shapes and the full 512^3
            width, in float32 (within 2e-5) and bfloat16 (within 0.15);
4. time     each kernel at the main path's shape with CUDA events, beside
            its plain version, its bound and a device-to-device copy;
5. main     the main path at full width: 6 seismic shots of a 512^3 model,
            400 steps each, scheduled by A2WS over 3 workers (worker 2 made
            4x slow), each worker on its own stream; launch counts are set
            to 0 just before and read just after;
6. parity   one shot alone, timed per step through the kernel and through
            the plain version; the kernel's seismogram must equal the A2WS
            run's bit for bit and the plain one within 1e-4 of its peak;
7. serve-check  phi4-mini-3.8b at full width in bf16 on the card, weights
            drawn from a seeded torch.Generator: prefill's last logits
            against token-by-token decode_step's for a 128-token prompt, and
            one decode_step after pad_caches against forward at that position
            (bf16 within BF16_LOGIT_ATOL, a relative L2 gap within
            BF16_LOGIT_REL_L2, the same argmax); the same in f32 at full
            width and 2 layers within the reference's own 2e-3;
8. serve-time   decode ms per token at batch 1 and 8 against a 160-token
            cache, prefill ms for 128 tokens and one request alone (128
            prompt + 32 new tokens), CUDA events, beside their bounds;
9. serve-main   the serving main path: an open-arrival A2WS ServePool of 3
            replicas sharing the weights, each on its own stream, slowdowns
            {1, 1, 4}, 12 Poisson requests of 128 + 32 tokens at 1.5x the rate
            one replica sustains alone; every request is served, and
            requests served by each replica, one of them stolen, give the
            same completion run alone;
10. sched   the device scheduler (``repro_torch.core.device_sched``): Eq. 5
            and the γ-rounding on 10^5 random windows on the card against
            the CPU (rates within SCHED_RTOL, γ equal); ``virtual_run`` at
            scripts/sched_cell.py's configuration (P=256, R=51, max_steal
            16, 7680 tasks), packed and baseline, on the card against the
            same run on the CPU with the same draws (integer state equal,
            makespan within SCHED_RTOL; a split is traced to its first round
            and field), conservation of every task id, tasks executed per
            speed quarter and tasks moved; the same at P=1024, R=204, then
            its ms per round and peak memory;
11. moe     moonshot-v1-16b-a3b at full width and depth (48 layers, 64
            experts, top-6; 56.1 GB in bf16), after phi4's weights are
            freed: phase 7's checks with the capacity factor raised to
            num_experts / top_k so that no token drops, first in f32 at full
            width and MOE_F32_LAYERS layers within 2e-3, then in bf16 at 48
            layers with forward's routing replayed into prefill and decode
            (within MOE_BF16_LOGIT_ATOL and MOE_BF16_LOGIT_REL_L2, the
            argmax reported), counting the decisions that would have flipped; phase
            8's times at the published capacity factor, each beside two
            bounds, every expert's weights read (the reference's design) and
            the active ones; phase 9's pool over MOE_POOL_REQUESTS shorter
            requests, one stolen request replayed alone;
12. mla     deepseek-v3-671b at full width cut to MLA_LAYERS layers, MTP off
            (3 dense MLA layers and 1 MoE layer of 256 experts, top-8, and
            the shared expert; 30.2 GB): phase 11's checks (f32 at its 4
            layers; bf16 within phase 7's bounds) and times, no pool;
13. ssm     mamba2-2.7b at full width and depth (64 layers, 2.70 G
            parameters, 5.41 GB in bf16), no cut, after the MoE models are
            freed: prefill vs 128 decode steps, and a 512-token prefill
            continued by 8 decode steps after pad_caches vs forward over 640
            (whole SSD chunks of 128), in f32 within 2e-3 and in bf16 within
            SSM_BF16_LOGIT_ATOL and SSM_BF16_LOGIT_REL_L2 (the argmax
            reported), over the real vocabulary; phase 8's times; phase 9's
            pool over REC_POOL_REQUESTS requests, whose replicas also return
            every decode step's logits: a stolen request's equal its run
            alone bit for bit, and a control request (the first prompt token
            changed) shows that they would not otherwise;
14. rglru   recurrentgemma-2b at full width and depth (26 layers: 8 cycles
            of rglru, rglru, local and 2 rglru; 2.89 G parameters, 5.79 GB),
            no cut: phase 13's checks with a 2304-token prefill, past the
            local window of 2048 so that its ring wraps, against forward over
            2312; bf16 within phase 7's bounds; the cost of the gates' f32
            widening of w_a and w_i; phase 13's times and pool;
15. encdec  seamless-m4t-medium at full width and depth (12 encoder and 12
            decoder layers; 877 M parameters), no cut, after the recurrent
            models are freed; a request is ENC_FRAMES stub frame embeddings
            (past one attention chunk of 1024) and its decoder tokens.  In
            f32 (within 2e-3), then in bf16 (phase 7's bounds, the argmax
            reported: FRONTEND_BF16_TOLS): a prefill,
            pad_caches and CONTINUE decode steps, each against forward at
            its position, the last against prefill of the whole prompt; the
            memory K/V bit-equal after decode; the caches padded to a second
            length give the same decode logits.  The encoder's ms beside its
            bound, phase 8's times, phase 13's pool (frames + REC_PROMPT +
            REC_NEW_TOKENS), each replica prefilling, padding and decoding;
16. vlm     qwen2-vl-2b at full width and depth (28 layers; 1.78 G
            parameters), no cut: an image of VLM_GRID^2 stub patch
            embeddings on an M-RoPE grid and VLM_TEXT text tokens, phase
            15's checks and phase 8's times (the prefill over the image and
            text); no pool;
17. train-check  training phi4-mini-3.8b at full width, after the serving
            models are freed: HetDPTrainer's combined gradient over
            TRAIN_TASKS microbatches of 2 x 1024 tokens (3 workers, slowdowns
            {1, 1, 4}, steals) against its first worker's alone over the same
            microbatches, in f32 at TRAIN_F32_LAYERS layers within a relative
            L2 of TRAIN_F32_REL_L2 over the whole tree and over each leaf, and
            in bf16 at TRAIN_LAYERS layers within TRAIN_BF16_REL_L2 and
            TRAIN_BF16_LEAF_REL_L2, bounds measured on the CPU first;
18. train-main  TRAIN_STEPS optimizer steps of that pool at TRAIN_LAYERS of
            the 32 layers (bf16 parameters, f32 moments, full remat): loss,
            grad_norm, tasks per worker, steals (at least one), makespan
            beside the paced schedule's floor; one microbatch's ms (forward,
            recompute, backward) and an AdamW update's ms, CUDA events, beside
            their bounds, and the step's work beside its bound at the card's
            peak rates; the loss finite, grad_norm > 0, every parameter leaf
            moved; peak memory; then a ResilientDriver run at SMOKE size whose
            failing worker is removed, and a fresh trainer that resumes from
            its checkpoint.
19. shard   phi4-mini-3.8b at full width and depth, served through the
            sharded step makers (``jit_prefill_step``, ``jit_decode_step``
            with the serving layout) on a one-rank ``nccl`` mesh (1, 1)
            ("data", "model"), its parameters phases 7-9's own wrapped as
            DTensors without a copy: a PROMPT-token prefill, then NEW_TOKENS
            decode steps, at batch 1 and 8, each step's logits against the
            unsharded port's within phase 7's bf16 bounds (and whether they
            are bit-equal); decode ms per step beside the unsharded step's,
            the host's enqueue time and the bytes bound; peak memory.  Run
            at the end of phases 7-9, while their parameters live;
20. shard   deepseek-v3-671b at full width and MLA_LAYERS layers, phase
            12's parameters, the same through ``serve_context``'s full-EP
            layout (``moe_apply`` under ``local_map``), the unsharded run's
            routing replayed, at the MoE bounds; then MLA decode's split
            softmax with the cache's slots split over the one-rank 'model'
            axis against the unsplit attention (f32, MLA_SPLIT_REL_L2).
            Run at the end of phase 12.
21. sched-ranks  the multi-rank device scheduler on a 1-D ("workers",)
            mesh of the one-rank ``nccl`` group (phase 19's, made here if
            it is not there yet): ``virtual_run(mesh=...)`` at SCHED_CELL
            and SCHED_BIG, packed and baseline, against the one-process card
            run on the same CPU generator's draws (rounds, makespan and
            every field equal); ms per round (CUDA events) beside the
            one-process round's, and the host's enqueue time of each.  Run
            at the end of phase 10;
22. sched-ranks  SCHED_RANKS processes started by this script, one ``gloo``
            group whose tensors lie on the one card, SCHED_CELL's workers
            in blocks of P / SCHED_RANKS, packed and baseline: every rank's
            block after every round against its rows of the one-process
            card run on the same draws (integers equal, floats within
            SCHED_RTOL); wall ms per round.  A rank that fails or outlasts
            SCHED_RANKS_TIMEOUT fails the phase.  Run after phase 21;
23. shard-train  one ``jit_train_step`` of phi4-mini-3.8b at full width and
            TRAIN_F32_LAYERS layers in f32 on phase 19's one-rank mesh, its
            parameters wrapped as DTensors (the vocab-parallel lookup and
            cross-entropy, the pinned ``wo`` input), against the unsharded
            port's step on the same microbatch: the loss, the gradient
            (whole and every leaf) and the updated parameters (whole) within
            a relative L2 of TRAIN_F32_REL_L2, and whether the gradients are
            bit-equal; the step's ms beside the unsharded step's.  Run after
            phase 17;
24. shard-train-ssm  phase 23 for mamba2-2.7b at full width (d_model 2560,
            80 heads of 64, one group, state 128) and TRAIN_F32_LAYERS
            layers in f32: on the one-rank mesh its mixer runs per rank
            (``ssm._mixer`` under ``local_map``, 'model' of one rank: the
            trivial split), held to the unsharded step by phase 23's
            bounds, but for its per-head gradient leaves (LEAF_REL_L2);
            its ms, sharded and unsharded, and peak memory beside the
            card's name and power limit.  Run after phase 23.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card, or outside a checkout,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

N = 512            # full width: a 512^3 shot volume, 134 M cells
NT = 400           # steps per shot
NUM_SHOTS = 6
SLOWDOWN = {0: 1.0, 1: 1.0, 2: 4.0}
FP32_TOL = 2e-5    # the reference's own fp32 tolerance
BF16_TOL = 0.15    # the reference's own bf16 tolerance
SEIS_REL_TOL = 1e-4  # summation order and FMA differ; error grows over NT steps
CHECK_SHAPES = [
    (8, 16, 16), (16, 16, 16), (16, 24, 16), (32, 16, 32), (8, 8, 8),  # reference sweep
    (13, 17, 29), (1, 9, 130), (1, 1, 1), (5, 1, 3), (9, 33, 65),       # ragged
    (N, N, N),                                                          # full width
]
# H100 SXM published peaks (NVIDIA data sheet, at a 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FD3D_FLOP_PER_CELL = 42  # 25 taps (13 mul, 24 add), the divide, the leapfrog's 4
BF16_FLOP_PER_S = 989e12
SERVE_ARCH = "phi4-mini-3.8b"
PROMPT = 128         # prompt tokens of the serving phases
NEW_TOKENS = 32      # tokens generated per request
DECODE_CACHE = 160   # cache length of the decode timing
POOL_SLOW = (1.0, 1.0, 4.0)
POOL_REQUESTS = 12
RATE_X = 1.5         # arrival rate, in multiples of one replica's rate alone
F32_LOGIT_TOL = 2e-3  # atol = rtol, the reference's own (tests/test_decode_consistency.py)
# bf16 at full width: prefill and decode round the activations to bf16 at
# different places (blocked vs direct softmax, 128-row vs 1-row products),
# ~10 roundings a layer over 32 layers, and the random-weight logits reach
# ~5 (std ~1).  Two H100 runs showed max|d| 0.0938 (prefill vs decode) and
# 0.0811 (decode vs forward), relative L2 gap 1.84e-2; the f32 run of the same
# checks agrees within 2e-3, so what is left is rounding.  Held with an
# absolute bound only, about 2x the worst seen, plus the relative L2 gap and
# the argmax, which must match in every comparison:
BF16_LOGIT_ATOL = 0.2
BF16_LOGIT_REL_L2 = 0.05
# Phases 11-12: the MoE family.  The logit comparisons raise the capacity
# factor, as the reference's own consistency test does
# (tests/test_decode_consistency.py), to num_experts / top_k, where an
# expert's capacity is every token of the call and none can drop: at the
# published 1.25 a 128-token prefill and a 1-token decode drop other
# tokens, which is the reference's semantics, not rounding (and at
# deepseek's 256 experts even the reference test's 16 leaves room for only
# half the tokens).  Times and the pool run at the published factor.
MOE_ARCH = "moonshot-v1-16b-a3b"
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 4        # 3 dense MLA layers + 1 MoE layer: 15.1 G parameters
# Phase 20's split-softmax MLA attention against the unsplit one, f32: the
# two sum and normalise in other orders (2.9e-7 on the CPU at deepseek's widths)
MLA_SPLIT_REL_L2 = 1e-5
# The f32 checks run before the bf16 model is drawn: moonshot at full width
# and MOE_F32_LAYERS layers (5.6 GB), deepseek at its MLA_LAYERS (60.4 GB).
MOE_F32_LAYERS = 2
# moonshot in bf16 at 48 layers, forward's routing replayed into prefill and
# decode: max|d| 0.25, relative L2 6.58e-2 (H100, the first runs of these
# checks), where the f32 run of the same checks at full width and 2 layers
# agrees within 1.44e-5.  What is left is rounding, carried through 48 MoE
# layers whose outputs (std ~75 at random init, the experts' fan-in being
# num_experts) swamp the residual stream, so phase 7's bounds (set at about
# 2x phi4's worst) do not carry over.  Held at about 2x the worst seen.  The
# argmax is reported, not required: at a gap of 0.2148 one run's decode
# picked another of the 163,840 random-weight logits, which crowd their
# maximum, and the absolute bound already holds a reordering to 2 max|d|.
# deepseek at 4 layers keeps phase 7's bounds, its argmax included.
MOE_BF16_LOGIT_ATOL = 0.5
MOE_BF16_LOGIT_REL_L2 = 0.15
MOE_POOL_REQUESTS = 6
MOE_PROMPT = 8        # prompt tokens of a pooled MoE request
MOE_NEW_TOKENS = 4
# Phases 13-14: the recurrent families, at full width and depth, no cut.
SSM_ARCH = "mamba2-2.7b"
RGLRU_ARCH = "recurrentgemma-2b"
# (prefill, decode steps, forward) of the decode-vs-forward check: mamba2's
# prefill and forward run whole SSD chunks of 128; recurrentgemma's prefill
# passes its local window of 2048, so that the ring buffer wraps.
SSM_CONTINUE = (512, 8, 640)
RGLRU_CONTINUE = (2304, 8, 2312)
# mamba2 in bf16.  scripts/bf16_gap_torch.py on the CPU, mamba2-2.7b at full
# width cut to 4, 8 and 16 layers, the reference's lm.init(key 0) bridged to
# the port, 4 prompts of 128 tokens, prefill vs 128 decode steps, last
# logits over the real vocabulary (max|d|; relative L2, the worst prompt):
#   layers  reference           port
#   4       0.0703, 1.673e-2    0.0703, 1.541e-2
#   8       0.1094, 2.445e-2    0.1074, 2.399e-2
#   16      0.1836, 3.995e-2    0.1484, 3.622e-2
# The port's gap is 0.91-0.98x the reference's: the gap is the reference's
# own (the rounding of its bf16 products, carried through the recurrence),
# not the port's.  A power law fitted over 4-16 layers (depth^0.69 for
# max|d|, depth^0.63 for the relative L2, steeper than the square root)
# carries it to 64 layers as 0.48 and 9.5e-2; the bounds allow about 2x.
# The argmax is reported, not required: the reference's own bf16 run
# flipped it for 1 of the 4 prompts at 16 layers.  recurrentgemma keeps
# phase 7's bounds (BF16_LOGIT_ATOL, BF16_LOGIT_REL_L2, the argmax required).
SSM_BF16_LOGIT_ATOL = 1.0
SSM_BF16_LOGIT_REL_L2 = 0.2
REC_POOL_REQUESTS = 6
REC_PROMPT = 32      # prompt tokens of a pooled recurrent request
REC_NEW_TOKENS = 8
# Phases 15-16: the enc-dec and VLM families, at full width and depth, no cut.
# Their frontends are stubs in the reference, so their inputs are embeddings
# drawn from the seed at std 0.2, as the reference's own tests draw them.
ENCDEC_ARCH = "seamless-m4t-medium"
VLM_ARCH = "qwen2-vl-2b"
ENC_FRAMES = 1500     # audio frames a request: past one attention chunk of 1024
STUB_STD = 0.2
CONTINUE = 16         # decode steps of the checks, continuing a prefill
VLM_GRID = 16         # a 448x448 image, patches of 14 merged 2x2: a 16x16 grid
VLM_TEXT = 64         # text tokens after the image
# Both in bf16.  The first card run of phase 15 failed on the argmax alone:
# in 1 of its 16 decode-vs-forward rows seamless's decode put its top token
# 0.0156 (one bf16 ulp of logits near 3) below forward's, at max|d| 0.0312.
# scripts/bf16_gap_torch.py on the CPU then ran the same check at full width
# and depth, the reference's lm.init(key 0) bridged to the port, prompts as
# these phases draw them, 16 decode steps each (rows: prompts x 16; "below":
# rows where the decode's top token is below forward's top logit, the worst
# gap; "near ties": rows whose top two logits lie within the row's max|d|):
#                 max|d|, rel L2     argmax differs, below    near ties
#   seamless, 12 prompts, 192 rows:
#     reference   0.0312, 9.29e-3    8, 4 (0.0156)            40
#     port        0.0312, 9.93e-3    8, 5 (0.0469)            48
#   qwen2-vl, 8 prompts, 128 rows:
#     reference   0.0898, 2.13e-2    6, 5 (0.0156)            40
#     port        0.0859, 2.13e-2    6, 4 (0.0156)            39
# The reference's own decode reorders near-tied top logits as often as the
# port's, so the argmax is reported, not required (as for mamba2).  Phase
# 7's bounds hold about 6x (seamless) and 2.2x (qwen2-vl) the reference's
# gap, and stay.
FRONTEND_BF16_TOLS = (BF16_LOGIT_ATOL, 0.0, BF16_LOGIT_REL_L2, False)
# Phase 10: scripts/sched_cell.py's configuration, and the same at 4x the workers.
SCHED_CELL = (256, 51, 16, 30)   # P, radius (20% of P), max_steal, tasks per worker
SCHED_BIG = (1024, 204, 16, 30)
SCHED_WINDOWS = 100_000
SCHED_RTOL = 1e-6
SCHED_MAX_ROUNDS = 4096
# Phases 21-22: the multi-rank scheduler.  The card machine has one card, and
# NCCL takes one rank a card, so phase 22's ranks share it through gloo.
SCHED_RANKS = 4
SCHED_RANKS_TIMEOUT = 300.0   # s, phase 22's group from start to end
SCHED_WARM_ROUNDS = 5         # phase 21's timed state: steals under way
SCHED_TIMED_ROUNDS = 40       # phase 21's timed rounds of each round function
# Phases 17-18: training phi4-mini-3.8b at full width through HetDPTrainer.
# 16 of its 32 layers: bf16 parameters (5.68 GB), f32 moments (22.7 GB) and
# 3 workers' accumulators and fresh gradients (34.1 GB) make 62.5 GB before
# activations at 16 layers, 98 GB at 32, more than the card's 80 GB.
TRAIN_ARCH = SERVE_ARCH
TRAIN_LAYERS = 16
TRAIN_F32_LAYERS = 2
TRAIN_STEPS = 3
# Microbatch tasks per optimizer step: 3 a worker.  A worker's queue reaches
# the thieves' view only when it finishes its first task, and with 2 tasks a
# worker it pops its last one at that same boundary: at 6 tasks the copied
# A2WS never steals from the slow worker, at 9 it does (scripts/steal_probe.py).
TRAIN_TASKS = 9
TRAIN_ROWS, TRAIN_SEQ = 2, 1024  # one microbatch: 2 rows of 1024 tokens
TRAIN_SLOW = (1.0, 1.0, 4.0)
# Each worker sleeps TRAIN_PACE measured microbatches per task, times its
# slowdown (HetDPTrainer's base_task_time), so that the slow one is slow.
TRAIN_PACE = 1.0
# The pool's combined gradient vs one worker's in f32, over the whole tree
# and over each leaf alone (the embedding and head dominate the whole tree)
TRAIN_F32_REL_L2 = 1e-5
# Phases 23-24 hold mamba2's per-head gradient leaves ([layers, 80]: a_log,
# dt_bias, d_skip) to the bound the CPU tests hold every leaf of the port's
# gradient to against the reference's (tests/test_torch_train.py, 1e-4), the
# other leaves to TRAIN_F32_REL_L2.  Each entry sums one head's gradient over
# every token, terms that cancel: with the whole tree 7.766e-07 apart, the
# sharded step's a_log read 1.907e-05 and its dt_bias 1.238e-05 from the
# unsharded step's on the card.
LEAF_REL_L2 = {"ssm/a_log": 1e-4, "ssm/dt_bias": 1e-4, "ssm/d_skip": 1e-4}
# The same comparison in bf16.  Each worker sums its gradients in bf16 in the
# order its tasks ran, so another assignment rounds at other places.
# scripts/het_dp_bf16_gap.py on the CPU, the reference's own HetDPTrainer
# and the port's, a pool of 3 workers (one 4x slow, a steal) against one
# worker over the same 9 microbatches (relative L2, whole tree / worst
# leaf).  SMOKE at 2 and 4 layers, 3 trials: the whole tree 2.77e-3 to
# 4.73e-3 over two series (reference 3.10e-3 to 4.58e-3), the worst leaf
# 4.62e-3 to 6.07e-3 (reference 4.51e-3 to 5.19e-3).  phi4 narrowed to
# d_model 768 (the real vocabulary), 2 trials: at 1, 2 and 4 layers the
# whole tree reads 2.83e-3 to 2.85e-3, 3.09e-3, 3.29e-3
# (reference 2.86e-3 to 2.96e-3, 3.22e-3 to 3.24e-3, 3.43e-3 to 3.45e-3),
# the worst leaf 4.66e-3 to 4.92e-3 (reference 4.88e-3 to 5.07e-3) at every
# depth.  The whole-tree gap grows with depth: on the card at full width
# and 16 layers it read 4.38e-3 to 4.56e-3, above every narrowed CPU
# reading.  Held at 1e-2 (2.1x the worst CPU reading) and, leaf by leaf,
# at 1.5e-2 (2.5x).
TRAIN_BF16_REL_L2 = 1e-2
TRAIN_BF16_LEAF_REL_L2 = 1.5e-2
DRIVER_STEPS = 4             # phase 18's ResilientDriver run, SMOKE size


class SmokeError(RuntimeError):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def timed_ms(torch, fn, iters: int, warmup: int) -> float:
    """Mean device ms per call of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def fields(torch, shape, dtype, gen):
    u = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    u_prev = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    c2dt2 = torch.full(shape, 0.1, device="cuda", dtype=dtype)
    return u, u_prev, c2dt2


def run() -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeError("no CUDA device: torch.cuda.is_available() is false")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    need(os.path.isdir(os.path.join(src, "repro_torch")),
         f"no repro_torch package under {src}: run from a checkout")
    sys.path.insert(0, src)
    from repro_torch.core import A2WSRuntime, SlowdownEvent, SlowdownSchedule
    from repro_torch.kernels.fd3d import fd3d as fd3d_kernel
    from repro_torch.kernels.fd3d import ref
    from repro_torch.seismic import make_demo_model, make_shot_grid, run_shot
    from repro_torch.seismic.tasks import make_shot_task

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    cuda = torch.device("cuda")

    # 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"[device] {kind} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi.stdout.strip().splitlines()[0]}")

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    fd3d_kernel.build()
    print(f"[build] fd3d: {time.perf_counter() - t0:.2f} s")
    for line in fd3d_kernel.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")

    # 3. kernel against plain -------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    dx = 10.0
    fp32_err = 0.0
    for shape in CHECK_SHAPES:
        for dtype, tol in ((torch.float32, FP32_TOL), (torch.bfloat16, BF16_TOL)):
            u, u_prev, c2dt2 = fields(torch, shape, dtype, gen)
            got = fd3d_kernel.fd3d_cuda(u, u_prev, c2dt2, dx=dx).float()
            want = ref.fd3d_step(u, u_prev, c2dt2, dx).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, rtol=tol, atol=tol)
            print(f"[check] fd3d {shape} {str(dtype)[6:]}: max|d| {err:.3e} "
                  f"(tol {tol}) {'ok' if ok else 'FAIL'}")
            need(ok, f"fd3d kernel disagrees with plain at {shape} {dtype}: {err}")
            if dtype == torch.float32:
                fp32_err = max(fp32_err, err)
            del u, u_prev, c2dt2, got, want

    # 4. timing at the main path's shape ---------------------------------
    shape = (N, N, N)
    cells = N ** 3
    u, u_prev, c2dt2 = fields(torch, shape, torch.float32, gen)
    kernel_ms = timed_ms(torch, lambda: fd3d_kernel.fd3d_cuda(u, u_prev, c2dt2, dx=dx),
                         iters=50, warmup=5)
    plain_ms = timed_ms(torch, lambda: ref.fd3d_step(u, u_prev, c2dt2, dx),
                        iters=10, warmup=2)
    dst = torch.empty_like(u)
    copy_ms = timed_ms(torch, lambda: dst.copy_(u), iters=50, warmup=5)
    step_bytes = 4 * cells * 4  # u, u_prev, c2dt2 read once, out written once
    bytes_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = FD3D_FLOP_PER_CELL * cells / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"[time] fd3d {shape} float32: kernel {kernel_ms:.4f} ms/step, "
          f"plain {plain_ms:.4f} ms/step, bound {bound_ms:.4f} ms "
          f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f})")
    print(f"[time] fd3d achieved {step_bytes / kernel_ms / 1e6:.1f} GB/s "
          f"({bound_ms / kernel_ms:.1%} of the bound); device copy_ "
          f"{2 * cells * 4 / copy_ms / 1e6:.1f} GB/s ({copy_ms:.4f} ms for "
          f"{cells * 4 / 1e6:.0f} MB)")
    del u, u_prev, c2dt2, dst
    torch.cuda.empty_cache()

    # 5. main path: shots scheduled by A2WS at full width ------------------
    model = make_demo_model(n=N, device="cuda")
    shots = make_shot_grid(model, NUM_SHOTS)
    need(model.cfl_ok(), "demo model violates CFL")
    seismograms: dict = {}
    task_fn = make_shot_task(model, NT, len(SLOWDOWN), seismograms)
    slowdown = SlowdownSchedule(
        [SlowdownEvent(w, 0.0, f) for w, f in SLOWDOWN.items() if f != 1.0]
    )
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rt = A2WSRuntime(shots, len(SLOWDOWN), task_fn, seed=0, slowdown=slowdown)
    fd3d_kernel.launches = 0
    t0 = time.perf_counter()
    stats = rt.run()
    wall = time.perf_counter() - t0
    launches = fd3d_kernel.launches
    peak_mem = torch.cuda.max_memory_allocated()
    print(f"[main] A2WS {NUM_SHOTS} shots x {NT} steps of {shape}, "
          f"{len(SLOWDOWN)} workers, slowdowns {SLOWDOWN}: makespan "
          f"{stats.makespan:.3f} s (wall {wall:.3f} s), tasks/worker "
          f"{stats.per_worker_tasks}, steals {len(stats.steals)}, "
          f"max_memory_allocated {peak_mem / 2**30:.2f} GiB")
    print(f"[main] fd3d launches {launches} (expected {NUM_SHOTS * NT})")
    need(not rt.errors, f"worker errors: {rt.errors}")
    need(sum(stats.per_worker_tasks) == NUM_SHOTS,
         f"{sum(stats.per_worker_tasks)} tasks ran, expected {NUM_SHOTS}")
    need(len(seismograms) == NUM_SHOTS, f"{len(seismograms)} seismograms")
    for key, seis in seismograms.items():
        need(seis.shape == (NT, len(shots[0].receivers)), f"seismogram {key} shape {seis.shape}")
        need(bool(np.isfinite(seis).all()) and bool(np.abs(seis).max() > 0),
             f"seismogram {key} not finite and non-zero")
    need(launches == NUM_SHOTS * NT,
         f"fd3d launched {launches} times on the main path, expected {NUM_SHOTS * NT}")

    # 6. one shot alone, timed, and its parity at full width ---------------
    shot = shots[0]

    def timed_shot(backend):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        seis = run_shot(model, shot.src, shot.rec_array(), NT, backend=backend)
        stop.record()
        torch.cuda.synchronize()
        return seis.cpu().numpy(), start.elapsed_time(stop) / NT

    alone, step_ms = timed_shot(None)
    want, plain_step_ms = timed_shot("ref")
    print(f"[time] run_shot {shape} alone, {NT} steps: kernel path {step_ms:.4f} "
          f"ms/step (fd3d {kernel_ms:.4f} of it), plain path {plain_step_ms:.4f} ms/step")
    need(np.array_equal(alone, seismograms[shot.src]),
         "the shot run alone differs from the same shot run on a worker's stream")
    peak = float(np.abs(want).max())
    seis_err = float(np.abs(alone - want).max())
    print(f"[parity] shot {shot.src} kernel vs plain on the card: max|d| "
          f"{seis_err:.3e}, peak {peak:.3e}, ratio {seis_err / peak:.3e} "
          f"(tol {SEIS_REL_TOL}); A2WS run's seismogram bit-identical")
    need(peak > 0 and seis_err <= SEIS_REL_TOL * peak, "seismogram parity failed")

    del model, shots, seismograms, task_fn, rt, alone, want
    torch.cuda.empty_cache()
    for what, phase in (("phases 7-9 (serve)", lambda: serve_phases(torch, np, gen, cuda)),
                        ("phase 10 (sched)", lambda: sched_phase(torch, np, cuda)),
                        ("phases 11-12 (moe, mla)", lambda: moe_phases(torch, np, gen, cuda)),
                        ("phases 13-14 (ssm, rglru)",
                         lambda: recurrent_phases(torch, np, gen, cuda)),
                        ("phases 15-16 (encdec, vlm)",
                         lambda: frontend_phases(torch, np, gen, cuda)),
                        ("phases 17-18 (train)", lambda: train_phases(torch, np, gen, cuda))):
        print(f"[clock] {what}: {time.perf_counter() - t_start:.1f} s since the start")
        phase()
    print(f"[clock] the end of the phases: {time.perf_counter() - t_start:.1f} s since the start")
    if _MESH:
        import torch.distributed as dist

        dist.destroy_process_group()

    print(json.dumps({"kernels": [{
        "name": "fd3d_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/fd3d/csrc/fd3d.cu",
        "replaces": "src/repro/kernels/fd3d/fd3d.py:73",
        "launches": launches,
        "max_abs_err": fp32_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]}))
    return {"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}


def _gb(nbytes: float) -> str:
    return f"{nbytes / 1e9:.3f} GB"


def compare_logits(torch, got, want, atol: float, rtol: float, rel_l2: float, vocab: int,
                   what: str, argmax: bool = True) -> None:
    """``got`` against ``want`` over the first ``vocab`` columns (the real
    vocabulary: padded columns hold -2e38) within ``atol + rtol * |want|``,
    a relative L2 gap of at most ``rel_l2``, and, with ``argmax``, the same
    argmax: ``got``'s top token is one of ``want``'s top tokens (bf16
    logits tie).  Without it an argmax that differs is reported with how
    far below its own top ``want`` ranks it; the absolute bound already
    holds that to 2 max|d|."""
    got, want = got[..., :vocab], want[..., :vocab]
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    top = got.argmax(-1, keepdim=True)
    rows = want.amax(-1, keepdim=True) - want.gather(-1, top)
    below = rows.max().item()
    same = below == 0.0
    ok = torch.allclose(got, want, atol=atol, rtol=rtol)
    note = "" if same else (f" (in {int((rows > 0).sum())} of {rows.numel()} rows; ranked "
                            f"{below:.4e} below the top{'' if argmax else ', reported'})")
    print(f"[serve-check] {what}: max|d| {err:.4e} (atol {atol}, rtol {rtol}; max|logit| "
          f"{want.abs().max().item():.4f}), relative L2 {rel:.3e} (limit {rel_l2}), same "
          f"argmax {same}{note} {'ok' if ok and rel <= rel_l2 and (same or not argmax) else 'FAIL'}")
    need(ok, f"{what}: max|d| {err} beyond atol {atol}, rtol {rtol}")
    need(rel <= rel_l2, f"{what}: relative L2 gap {rel} beyond {rel_l2}")
    need(same or not argmax, f"{what}: argmax differs")
    need(bool(torch.isfinite(got).all()), f"{what}: logits not finite")


def check_consistency(torch, lm, cfg, params, toks, tols, label: str, pin=None,
                      cont=None) -> None:
    """prefill's last logits vs token-by-token decode_step over PROMPT
    tokens, then decode_step after pad_caches vs forward; ``tols`` is
    ``(atol, rtol, rel_l2)``, or ``(atol, rtol, rel_l2, argmax)`` (see
    :func:`compare_logits`).  ``cont`` is ``(prefill, steps, forward)``,
    by default ``(PROMPT, 1, PROMPT + 1)``: a prefill of ``prefill`` tokens,
    padded, continued by ``steps`` decode steps, each held to a forward
    over the first ``forward`` tokens of ``toks`` (an SSM runs forward and
    prefill over whole chunks).  With ``pin`` (a :class:`PinnedRouting`)
    the forward runs first and every later call takes its routing
    decisions."""
    dev = toks.device
    p0, steps, fwd = cont or (PROMPT, 1, PROMPT + 1)

    def pinned(a: int, b: int):
        return pin.replay(slice(a, b)) if pin else contextlib.nullcontext()

    if pin:
        with pin.record():
            full, _ = lm.forward(params, {"tokens": toks[:, :fwd]}, cfg)
    with pinned(0, PROMPT):
        pre, caches = lm.prefill(params, {"tokens": toks[:, :PROMPT]}, cfg)
    dc = lm.init_caches(cfg, 1, PROMPT, device=dev)
    for i in range(PROMPT):
        with pinned(i, i + 1):
            step, dc = lm.decode_step(params, toks[:, i : i + 1], dc, i, cfg)
    del dc
    *bounds, argmax = tols if len(tols) == 4 else (*tols, True)
    compare_logits(torch, pre, step, *bounds, cfg.vocab,
                   f"{label}: prefill vs {PROMPT} decode steps, last logits", argmax)
    if p0 != PROMPT:
        del caches
        with pinned(0, p0):
            _, caches = lm.prefill(params, {"tokens": toks[:, :p0]}, cfg)
    caches = lm.pad_caches(caches, cfg, p0 + steps)
    nxt = []
    for i in range(p0, p0 + steps):
        with pinned(i, i + 1):
            nxt.append(lm.decode_step(params, toks[:, i : i + 1], caches, i, cfg)[0])
    del caches
    if not pin:
        full, _ = lm.forward(params, {"tokens": toks[:, :fwd]}, cfg)
    where = (f"position {p0}" if steps == 1 else
             f"positions {p0}..{p0 + steps - 1} ({p0}-token prefill, forward over {fwd})")
    compare_logits(torch, torch.cat(nxt, 1), full[:, p0 : p0 + steps], *bounds, cfg.vocab,
                   f"{label}: decode_step after pad_caches vs forward at {where}", argmax)
    del full


class PinnedRouting:
    """One run's MoE routing decisions replayed in others.

    ``record()`` keeps each MoE layer's ``(top_i, top_w)`` of the run inside
    it, in layer order; inside ``replay(rows)`` the n-th routing call of a
    model call gets the n-th layer's recorded decisions for the token rows
    ``rows``, and the rows whose own top-k set differs are counted: router
    near-ties that rounding tips the other way.
    """

    def __init__(self):
        from repro_torch.models import moe

        self.mod, self.route = moe, moe.route
        self.tape, self.flips, self.decisions = [], 0, 0

    @contextlib.contextmanager
    def _routing(self, fn):
        self.mod.route = fn
        try:
            yield
        finally:
            self.mod.route = self.route

    def record(self):
        self.tape = []

        def record(router_w, x, m):
            out = self.route(router_w, x, m)
            self.tape.append(out[:2])
            return out

        return self._routing(record)

    def replay(self, rows: slice):
        layers = iter(self.tape)

        def replay(router_w, x, m):
            top_i, _, probs = self.route(router_w, x, m)
            pin_i, pin_w = (t[:, rows] for t in next(layers))
            own, pinned = top_i.sort(-1).values, pin_i.sort(-1).values
            self.flips += int((own != pinned).any(-1).sum())
            self.decisions += own.shape[0] * own.shape[1]
            return pin_i, pin_w, probs

        return self._routing(replay)


def serve_phases(torch, np, gen, dev) -> None:
    """Phases 7-9: the dense-family serving path at full width on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.bridge import flatten

    cfg = get_config(SERVE_ARCH)
    h, hkv, hd, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.n_layers

    # 7. serve-check ------------------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = flatten(params)
    n_params = sum(t.numel() for t in leaves.values())
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    need(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
    print(f"[serve-check] {SERVE_ARCH} full width: {L} layers, d_model {cfg.d_model}, "
          f"{h}/{hkv} heads of {hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{n_params:,} parameters, {_gb(weight_bytes)} in bf16, drawn in {init_s:.2f} s; "
          f"max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
    toks = torch.randint(0, cfg.vocab, (1, PROMPT + 1), device=dev, generator=gen)
    check_consistency(torch, lm, cfg, params, toks, (BF16_LOGIT_ATOL, 0.0, BF16_LOGIT_REL_L2),
                      f"bf16, {L} layers")
    cfg32 = cfg.with_(n_layers=2, dtype="float32")
    p32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(1), device=dev,
                  dtype=torch.float32)
    check_consistency(torch, lm, cfg32, p32, toks, (F32_LOGIT_TOL, F32_LOGIT_TOL, F32_LOGIT_TOL),
                      "f32, 2 layers")
    del p32
    torch.cuda.empty_cache()
    print(f"[serve-check] max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")

    # 8. serve-time -------------------------------------------------------
    serve_times(torch, lm, cfg, params, dev, gen, active=False)
    # 9. serve-main -------------------------------------------------------
    rng = np.random.default_rng(0)
    pool_phase(torch, np, lm, cfg, params, dev, token_requests(rng, cfg, POOL_REQUESTS, PROMPT),
               NEW_TOKENS, rng, "serve")
    # 19. shard -----------------------------------------------------------
    sharded_phase(torch, lm, cfg, params, dev, gen, "shard-19",
                  (BF16_LOGIT_ATOL, 0.0, BF16_LOGIT_REL_L2, True))


_MESH = []  # the one-rank mesh of phases 19-20, made once


def one_rank_mesh(torch, dev):
    """A (1, 1) ("data", "model") mesh over a one-rank process group of its
    own store (``nccl`` on the card, ``gloo`` on the host)."""
    import torch.distributed as dist

    if not _MESH:
        from repro_torch.launch.mesh import make_debug_mesh

        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)  # the rank's card, before NCCL starts
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
        _MESH.append(make_debug_mesh(1, 1))
    return _MESH[0]


@contextlib.contextmanager
def replay_on_mesh(pin, rows):
    """``pin.replay(rows)`` for a model whose routing runs on DTensors: the
    recorded decisions go back in as DTensors of the mesh's (one-rank)
    layout, and the flips are counted on whole tensors."""
    from torch.distributed.tensor import DTensor

    layers = iter(pin.tape)

    def replay(router_w, x, m):
        top_i, top_w, probs = pin.route(router_w, x, m)
        pin_i, pin_w = (t[:, rows] for t in next(layers))
        own = top_i.full_tensor() if isinstance(top_i, DTensor) else top_i
        pin.flips += int((own.sort(-1).values != pin_i.sort(-1).values).any(-1).sum())
        pin.decisions += own.shape[0] * own.shape[1]
        if isinstance(top_i, DTensor):
            pin_i = DTensor.from_local(pin_i, top_i.device_mesh, top_i.placements)
            pin_w = DTensor.from_local(pin_w, top_w.device_mesh, top_w.placements)
        return pin_i, pin_w, probs

    with pin._routing(replay):
        yield


def sharded_phase(torch, lm, cfg, params, dev, gen, tag: str, tols, pin=None) -> None:
    """Phases 19-20: ``cfg`` served through the sharded step makers on a
    one-rank mesh, ``params`` wrapped as DTensors in place, against the
    unsharded port on the same prompts (see the module docstring)."""
    from repro_torch.models.bridge import flatten
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve import engine

    card = card_name()
    mesh = one_rank_mesh(torch, dev)
    ctx = sh.serve_context(mesh, cfg.moe.num_experts if cfg.moe else 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dparams = sh.distribute_tree(params, engine._param_shardings(cfg, ctx))
    wrap_s = time.perf_counter() - t0
    plain, wrapped = flatten(params), flatten(dparams)
    need(all(wrapped[k].to_local().data_ptr() == t.data_ptr() for k, t in plain.items()),
         f"{tag}: wrapping the parameters as DTensors copied one")
    atol, rtol, rel, argmax = tols
    total = PROMPT + NEW_TOKENS
    print(f"[{tag}] {cfg.name}, {cfg.n_layers} layers, on a one-rank mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} ({card}), experts over {ctx.ep_axes}: "
          f"{len(plain)} parameter leaves wrapped as DTensors in {wrap_s * 1e3:.1f} ms, no copy")
    for bsz in (1, 8):
        toks = torch.randint(0, cfg.vocab, (bsz, total), device=dev, generator=gen)
        prompt = {"tokens": toks[:, :PROMPT]}
        prefill = engine.jit_prefill_step(cfg, ctx, prompt)
        decode = engine.jit_decode_step(cfg, ctx, bsz, total)
        steps, equal = [], True

        def both(plain_fn, sharded_fn, rows):
            if pin is None:
                return plain_fn(), sharded_fn()
            with pin.record():
                want = plain_fn()
            with replay_on_mesh(pin, rows):
                return want, sharded_fn()

        (wl, wc), (gl, sc) = both(lambda: lm.prefill(params, prompt, cfg),
                                  lambda: prefill(dparams, prompt), slice(None))
        steps.append(("prefill", gl.full_tensor(), wl))
        wc, sc = lm.pad_caches(wc, cfg, total), lm.pad_caches(sc, cfg, total)
        for i in range(NEW_TOKENS):
            tok = toks[:, PROMPT + i:PROMPT + i + 1]
            (wl, wc), (gl, sc) = both(lambda: lm.decode_step(params, tok, wc, PROMPT + i, cfg),
                                      lambda: decode(dparams, tok, sc, PROMPT + i), slice(None))
            steps.append((f"decode {i}", gl.full_tensor(), wl))
        for what, got, want in steps:
            equal = equal and torch.equal(got, want)
        worst = max(steps, key=lambda s: (s[1] - s[2])[..., :cfg.vocab].abs().max().item())
        compare_logits(torch, worst[1], worst[2], atol, rtol, rel, cfg.vocab,
                       f"{tag} batch {bsz}: sharded vs unsharded, worst of prefill + "
                       f"{NEW_TOKENS} decode steps ({worst[0]})", argmax)
        for what, got, want in steps:
            need(torch.allclose(got[..., :cfg.vocab], want[..., :cfg.vocab], atol=atol, rtol=rtol),
                 f"{tag} batch {bsz} {what}: sharded logits beyond atol {atol}")
        print(f"[{tag}] batch {bsz}: prefill + {NEW_TOKENS} decode steps' logits bit-equal to "
              f"the unsharded port's: {equal}" + (
                  f"; routing replayed, {pin.flips} of {pin.decisions} token-layer decisions "
                  f"would have flipped" if pin is not None else ""))
        del wc, sc, steps
        # decode ms per step, sharded and not, against a DECODE_CACHE-token cache
        caches = lm.init_caches(cfg, bsz, DECODE_CACHE, device=dev)
        dcaches = engine.cache_shardings(cfg, ctx, bsz, DECODE_CACHE)
        dcaches = sh.distribute_tree(lm.init_caches(cfg, bsz, DECODE_CACHE, device=dev), dcaches)
        dec_time = engine.jit_decode_step(cfg, ctx, bsz, DECODE_CACHE)
        tok = toks[:, :1]
        times = {}
        for name, fn, cache in (("unsharded", lambda c, p: lm.decode_step(params, tok, c, p, cfg),
                                 caches),
                                ("sharded", lambda c, p: dec_time(dparams, tok, c, p), dcaches)):
            pos, host = iter(range(PROMPT, DECODE_CACHE)), []

            def step():
                t = time.perf_counter()
                fn(cache, next(pos))
                host.append(time.perf_counter() - t)

            times[name] = (timed_ms(torch, step, iters=16, warmup=4),
                           1e3 * sum(host[4:]) / len(host[4:]))
        nbytes, flops = step_work(lm, cfg, plain, bsz, 1, DECODE_CACHE - 1, cfg.moe is not None)
        bms, by = bound(nbytes, flops)
        (s_ms, s_host), (u_ms, u_host) = times["sharded"], times["unsharded"]
        print(f"[{tag}] decode batch {bsz}, {DECODE_CACHE}-token cache ({card}): sharded "
              f"{s_ms:.4f} ms per step (host enqueue {s_host:.4f} ms), unsharded {u_ms:.4f} ms "
              f"(host enqueue {u_host:.4f} ms), {s_ms / u_ms:.2f}x; bound {bms:.4f} ms "
              f"({_gb(nbytes)} at 3.35 TB/s, {by}-bound)")
        del caches, dcaches
    if cfg.mla is not None:
        mla_split_check(torch, cfg, mesh, dev, gen, tag)
    print(f"[{tag}] max_memory_allocated {_gb(torch.cuda.max_memory_allocated())} ({card})")
    del dparams, wrapped
    gc.collect()
    torch.cuda.empty_cache()


def mla_split_check(torch, cfg, mesh, dev, gen, tag: str) -> None:
    """MLA decode's split softmax (``attention._mla_attend_split``) with the
    one-rank mesh's 'model' axis splitting the compressed cache's slots
    (the layout ``cache_pspecs`` gives a mesh whose 'model' axis divides
    the cache), against the unsplit ``_mla_attend`` on the same f32 inputs
    at ``cfg``'s widths, batch 8, a DECODE_CACHE-slot cache of which
    PROMPT + 1 are valid: within a relative L2 of MLA_SPLIT_REL_L2."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models import attention

    m, b, s = cfg.mla, 8, DECODE_CACHE
    rows = lambda *shape: torch.randn(*shape, device=dev, generator=gen)  # noqa: E731
    args = (rows(b, 1, cfg.n_heads, m.kv_lora_rank), rows(b, 1, cfg.n_heads, m.qk_rope_dim),
            rows(b, s, m.kv_lora_rank), rows(b, s, m.qk_rope_dim))
    valid = torch.arange(s, device=dev) <= PROMPT
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    split = [Replicate(), Shard(1)]  # ("data", "model"): slots over 'model'
    d_args = [DTensor.from_local(t, mesh, [Replicate()] * 2 if i < 2 else split,
                                 run_check=False) for i, t in enumerate(args)]
    got = attention._mla_attend_split(*d_args, valid, scale).full_tensor()
    want = attention._mla_attend(*args, valid, scale)
    gap = float((got - want).double().norm() / want.double().norm())
    print(f"[{tag}] MLA decode's split softmax, the cache's {s} slots split over 'model' "
          f"({cfg.n_heads} heads, kv rank {m.kv_lora_rank}, batch {b}, f32): relative L2 "
          f"{gap:.3e} to the unsplit attention (bound {MLA_SPLIT_REL_L2:g}), max|d| "
          f"{(got - want).abs().max().item():.3e}")
    need(gap <= MLA_SPLIT_REL_L2, f"{tag}: MLA split softmax differs by {gap}")


def step_work(lm, cfg, leaves, bsz: int, seq: int, ctx: int, active: bool, enc_len: int = 0):
    """(bytes, flops) that one step of ``bsz`` x ``seq`` new tokens against
    ``ctx`` cached ones must move and do: every weight but the embedding
    table read once (the table too where the head is tied to it), the
    caches read and written once, the f32 logits of the last position
    written.  MoE expert stacks count whole (the
    reference's design: every expert runs its ``cap`` slots) or, with
    ``active``, scaled by top_k/num_experts for the tokens' own experts.
    Attention counts on attention layers only.  The recurrences' own
    arithmetic (the SSM state update and SSD, the RG-LRU gates' elementwise
    work and scan) is left out: about 5% of the products' operations, which
    take less time than the bytes at these shapes.  An enc-dec model's step
    (``enc_len`` encoder frames a request) reads each layer's memory K/V
    from the caches and cross-attends them; a step from empty caches (ctx
    0, a prefill) also runs the encoder over the frames and projects them
    into the memory K/V (the encoder's weights and the cross-attention's
    wk/wv, applied per frame), which a decode step does not read."""
    from repro_torch.serve.engine import abstract_caches

    encode = bool(enc_len) and ctx == 0
    per_frame = {k for k in leaves if k.startswith("enc_")
                 or k.split("/")[-2:] in (["xattn", w] for w in ("wk", "wv", "bk", "bv"))}
    if enc_len and not encode:
        leaves = {k: t for k, t in leaves.items() if k not in per_frame}
    frame_params = sum(leaves[k].numel() for k in per_frame) if encode else 0
    m = cfg.moe
    expert = {k: t for k, t in leaves.items()
              if "moe" in k.split("/") and k.split("/")[-1] in ("w1", "w2", "w3")}
    read = {k: t for k, t in leaves.items() if k != "embed" or cfg.tie_embeddings}
    weight_bytes = sum(t.numel() * t.element_size() for t in read.values())
    expert_bytes = sum(t.numel() * t.element_size() for t in expert.values())
    expert_params = sum(t.numel() for t in expert.values())
    dense_params = sum(t.numel() for t in read.values()) - expert_params - frame_params
    tokens = bsz * seq
    caches = abstract_caches(cfg, bsz, ctx + seq, enc_len or None)
    cache_bytes = sum(t.numel() * t.element_size() for t in flatten_caches(caches))
    nbytes = weight_bytes + tokens * cfg.d_model * 2 + cache_bytes + bsz * cfg.vocab_padded * 4
    flops = 2 * tokens * dense_params
    if encode:  # frames in; the encoder, its attention, and the memory K/V projections
        nbytes += bsz * enc_len * cfg.d_model * 2
        flops += 2 * bsz * enc_len * frame_params
        flops += 2 * bsz * enc_len * enc_len * cfg.enc_layers * cfg.n_heads * 2 * cfg.head_dim_
    if enc_len:  # cross-attention: every new token against every frame
        flops += 2 * bsz * seq * enc_len * cfg.n_layers * cfg.n_heads * 2 * cfg.head_dim_
    if m is not None:
        if active:
            nbytes -= expert_bytes * (1 - m.top_k / m.num_experts)
            flops += 2 * tokens * expert_params * m.top_k / m.num_experts
        else:
            cap = math.ceil(tokens * m.top_k / m.num_experts * m.capacity_factor)
            flops += 2 * cap * expert_params  # each expert runs cap slots
    if cfg.mla is not None:  # absorbed decode: scores on kvr + rope, values on kvr
        ml = cfg.mla
        qk, v = ((ml.kv_lora_rank + ml.qk_rope_dim, ml.kv_lora_rank) if seq == 1
                 else (ml.qk_nope_dim + ml.qk_rope_dim, ml.v_dim))
    else:
        qk = v = cfg.head_dim_
    # causal: query i sees ctx + i + 1 keys, at most a local block's window
    keys = sum(min(ctx + i + 1, cfg.window or ctx + seq) for i in range(seq))
    n_attn = sum(k in ("attn", "local", "attn_dense", "attn_moe") for k in cfg.block_types())
    flops += 2 * bsz * keys * n_attn * cfg.n_heads * (qk + v)
    return nbytes, flops


def flatten_caches(caches):
    out = []
    for c in caches:
        out.extend(flatten_caches(c) if isinstance(c, (list, tuple)) else [c])
    return out


def bound(nbytes: float, flops: float):
    """The least ms for the work, and what sets it."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def serve_times(torch, lm, cfg, params, dev, gen, active: bool, tag: str = "serve-time",
                caches_for=None, prefill=None, enc_len: int = 0) -> None:
    """Decode ms per step at batch 1 and 8 against a DECODE_CACHE-token cache
    and prefill ms for PROMPT tokens, CUDA events, each beside its bound; MoE
    configs beside two bounds, every expert's weights and the active ones.
    ``caches_for(bsz)`` gives the caches decode runs against (by default
    zero caches from ``init_caches``); ``prefill`` is ``(batch, what)``, the
    timed prefill's batch and its description (by default PROMPT random
    tokens); ``enc_len`` an enc-dec model's encoder frames (``step_work``)."""
    from repro_torch.models.bridge import flatten

    leaves = flatten(params)
    kinds = [False, True] if active else [False]

    def beside(ms, bsz, seq, ctx):
        parts = []
        for act in kinds:
            nbytes, flops = step_work(lm, cfg, leaves, bsz, seq, ctx, act, enc_len)
            bms, by = bound(nbytes, flops)
            what = ("active experts, " if act else "every expert, ") if active else ""
            parts.append(f"bound {bms:.4f} ms ({what}{_gb(nbytes)} at 3.35 TB/s, {by}-bound) "
                         f"= {bms / ms:.1%} of it")
        return "; ".join(parts)

    for bsz in (1, 8):
        caches = (caches_for(bsz) if caches_for
                  else lm.init_caches(cfg, bsz, DECODE_CACHE, device=dev))
        tok = torch.randint(0, cfg.vocab, (bsz, 1), device=dev, generator=gen)
        pos = iter(range(PROMPT, DECODE_CACHE))
        t_host = []

        def step():
            t = time.perf_counter()
            lm.decode_step(params, tok, caches, next(pos), cfg)
            t_host.append(time.perf_counter() - t)

        ms = timed_ms(torch, step, iters=24, warmup=4)
        host_ms = 1e3 * sum(t_host[4:]) / len(t_host[4:])
        print(f"[{tag}] decode batch {bsz}, {DECODE_CACHE}-token cache: {ms:.4f} ms "
              f"per step ({ms / bsz:.4f} ms per token), host enqueue {host_ms:.4f} ms per "
              f"step; {beside(ms, bsz, 1, DECODE_CACHE - 1)}")
        del caches
    if prefill is None:
        prefill = ({"tokens": torch.randint(0, cfg.vocab, (1, PROMPT), device=dev, generator=gen)},
                   f"{PROMPT} tokens")
    batch, what = prefill
    seq = (batch["embeds"] if "embeds" in batch else batch["tokens"]).shape[1]
    ms = timed_ms(torch, lambda: lm.prefill(params, batch, cfg), iters=5, warmup=2)
    print(f"[{tag}] prefill {what}: {ms:.4f} ms; {beside(ms, 1, seq, 0)}")


def logits_generate(torch, np, cfg, params, new_tokens: int, decode):
    """``make_replica_generate``'s replica (its own stream, the launcher's
    ``generate``) that also returns every decode step's last logits, f32 on
    the host, under ``"logits"``."""
    from repro_torch.launch.serve import generate

    dev = params["embed"].device
    stream = torch.cuda.Stream(dev)

    def gen(request: dict) -> dict:
        sink = []

        def step(p, tok, caches, pos):
            logits, caches = decode(p, tok, caches, pos)
            sink.append(logits[:, -1])
            return logits, caches

        with torch.cuda.stream(stream):
            toks = torch.as_tensor(np.asarray(request["tokens"]), device=dev)[None, :]
            out = generate(cfg, params, toks, new_tokens, decode=step)
            return {"completion": out[0].cpu().tolist(),
                    "logits": torch.cat(sink)[:, : cfg.vocab].float().cpu()}

    return gen


def token_requests(rng, cfg, n: int, prompt: int) -> list[dict]:
    """``n`` requests of ``prompt`` random token ids from ``rng``."""
    return [{"tokens": t} for t in rng.integers(0, cfg.vocab, (n, prompt))]


def encdec_generate(torch, np, cfg, params, new_tokens: int):
    """A replica's ``generate`` for an enc-dec model, over the engine's
    ``jit_prefill_step`` and ``jit_decode_step``: prefill the request's
    encoder frames (``"enc_embeds"`` [S_enc, d]) and decoder prompt
    (``"tokens"``), pad the caches, then decode greedily; returns the
    ``new_tokens`` ids under ``"completion"`` and the logits behind each of
    them (the prefill's, then every decode step's), f32 on the host, under
    ``"logits"``.  On a card it runs on a stream of its own.  (The serve
    launcher's ``generate`` starts from ``init_caches`` and token ids, which
    an enc-dec model cannot: its memory K/V come from a prefill.)"""
    from repro_torch.serve.engine import jit_decode_step, jit_prefill_step
    from repro_torch.models import lm

    prefill, decode = jit_prefill_step(cfg), jit_decode_step(cfg)
    dev = params["embed"].device
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def gen(request: dict) -> dict:
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            toks = torch.as_tensor(np.asarray(request["tokens"]), device=dev)[None, :]
            enc = torch.as_tensor(np.asarray(request["enc_embeds"]), device=dev)[None]
            logits, caches = prefill(params, {"tokens": toks, "enc_embeds": enc})
            s = toks.shape[1]
            caches = lm.pad_caches(caches, cfg, s + new_tokens - 1)
            sink = [logits[:, -1]]
            out = [sink[-1].argmax(-1)]
            for i in range(new_tokens - 1):
                logits, caches = decode(params, out[-1][:, None], caches, s + i)
                sink.append(logits[:, -1])
                out.append(sink[-1].argmax(-1))
            return {"completion": torch.cat(out).cpu().tolist(),
                    "logits": torch.cat(sink)[:, : cfg.vocab].float().cpu()}

    return gen


def pool_phase(torch, np, lm, cfg, params, dev, requests, new_tokens: int, rng,
               tag: str, logits: bool = False) -> None:
    """One request alone, then an open-arrival A2WS ServePool of
    len(POOL_SLOW) replicas sharing ``params`` on their own streams, Poisson
    arrivals (from ``rng``) of ``requests`` (dicts of ``"tokens"``, and of
    ``"enc_embeds"`` for an enc-dec model) at RATE_X times one replica's
    rate; every request served, and requests served by each replica, one of
    them stolen, give the same completion run alone.  With ``logits`` the
    replicas also return every decode step's logits, which must equal the
    run alone bit for bit, and a control (request 0 with its first prompt
    token changed) shows that they depend on the whole prompt.  An enc-dec
    model's replicas generate with :func:`encdec_generate` (which returns
    its logits)."""
    from repro_torch.launch.serve import make_decode, make_replica_generate
    from repro_torch.serve import Replica, ServePool

    n_req, prompt_len = len(requests), len(requests[0]["tokens"])
    frames = len(requests[0].get("enc_embeds", ()))
    decode = make_decode(cfg)

    def replica_gen():
        if cfg.enc_layers:
            return encdec_generate(torch, np, cfg, params, new_tokens)
        if logits:
            return logits_generate(torch, np, cfg, params, new_tokens, decode)
        return make_replica_generate(cfg, params, new_tokens, decode)

    alone_gen = replica_gen()
    alone_gen({**requests[1], "tokens": requests[1]["tokens"][:2]})  # warm-up of its stream
    t0 = time.perf_counter()
    alone_out = alone_gen(requests[0])
    service_s = time.perf_counter() - t0
    alone = alone_out["completion"]
    rate = RATE_X / service_s
    # the launcher's generate feeds the prompt through decode_step; an
    # enc-dec replica prefills it (and the frames) and decodes the rest
    steps = new_tokens - 1 if cfg.enc_layers else prompt_len + new_tokens - 1
    shape = f"{frames} frames + " * bool(frames)
    print(f"[{tag}-time] one request alone ({shape}{prompt_len} prompt + {new_tokens} new "
          f"tokens, {'a prefill and ' * bool(frames)}{steps} decode steps): {service_s:.3f} s = "
          f"{1e3 * service_s / steps:.4f} ms per step; one replica sustains "
          f"{1 / service_s:.4f} requests/s")

    replicas = [Replica(f"replica{i}", replica_gen(), slow_factor=f)
                for i, f in enumerate(POOL_SLOW)]
    pool = ServePool(replicas, seed=0)
    torch.cuda.synchronize()
    pool.start()
    arrivals = rng.exponential(1.0 / rate, n_req)
    t0 = time.perf_counter()
    futs = []
    for dt, request in zip(arrivals, requests):
        time.sleep(float(dt))
        # round-robin, as the pool's own routing, but named: see the replay
        futs.append(pool.submit(request, replica=len(futs) % len(POOL_SLOW)))
    deadline = time.perf_counter() + 900
    while not all(f.done() for f in futs) and time.perf_counter() < deadline:
        time.sleep(0.05)
    need(all(f.done() for f in futs), "requests unresolved after 900 s")
    wall = max(f.end_t for f in futs) - t0
    live = pool.live_replicas()
    stats = pool.shutdown()
    errors = [f.error for f in futs if f.error is not None]
    need(not errors, f"requests failed: {errors}")
    need(live == list(range(len(POOL_SLOW))), f"replicas died: live {live}")
    lens = [len(f.result()["completion"]) for f in futs]
    need(lens == [new_tokens] * n_req, f"completion lengths {lens}")
    need(sum(stats.per_worker_tasks) == n_req,
         f"requests per replica {stats.per_worker_tasks} do not sum to {n_req}")
    pct = stats.latency_percentiles()
    print(f"[{tag}-main] A2WS ServePool, {len(POOL_SLOW)} replicas sharing {cfg.name} on "
          f"their own streams, slowdowns {list(POOL_SLOW)}; {n_req} Poisson requests "
          f"of {shape}{prompt_len} + {new_tokens} tokens at {rate:.4f}/s ({RATE_X}x one replica)")
    print(f"[{tag}-main] requests/replica {stats.per_worker_tasks}, steals "
          f"{len(stats.steals)}, latency p50/p95/p99 {pct[50.0]:.3f}/{pct[95.0]:.3f}/"
          f"{pct[99.0]:.3f} s, makespan {stats.makespan:.3f} s (first arrival to last "
          f"completion {wall:.3f} s), {n_req * new_tokens / wall:.2f} generated "
          f"tokens/s; max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
    # Replay alone: request 0 (the first arrival, served by replica 0 into an
    # empty pool), and for replicas 1 and 2 a request each served, a stolen
    # one where there is one (it landed on another replica's deque); at least
    # one replayed request must have been stolen.
    landed = [k % len(POOL_SLOW) for k in range(n_req)]
    stolen = [k for k, f in enumerate(futs) if f.worker != landed[k]]
    need(bool(stolen), "no request left the replica it was submitted to")
    picks = {0: alone_out}
    for r in range(1, len(POOL_SLOW)):
        served = [k for k, f in enumerate(futs) if f.worker == r]
        need(bool(served), f"replica {r} served no request")
        picks.setdefault(next((k for k in served if k in stolen), served[0]), None)
    if not any(k in stolen for k in picks):
        picks[stolen[0]] = None
    for k in picks:
        want = picks[k] if picks[k] is not None else alone_gen(requests[k])
        what = (f"request {k} (submitted to replica {landed[k]}, served by replica "
                f"{futs[k].worker}{', stolen' if k in stolen else ''})")
        got = futs[k].result()
        same_as_alone(torch, np, lm, cfg, params, decode, dev, requests[k]["tokens"],
                      want["completion"], got["completion"], what, tag)
        if logits:
            gap = (got["logits"] - want["logits"]).abs().max().item()
            print(f"[{tag}-main] {what}: logits at all {got['logits'].shape[0]} steps max|d| "
                  f"{gap:.4e} (limit 0.0)")
            need(gap == 0.0, f"{what}: pooled logits differ from the run alone by {gap}")
    if logits:
        changed = requests[0]["tokens"].copy()
        changed[0] = (changed[0] + 1) % cfg.vocab
        ctl = alone_gen({**requests[0], "tokens": changed})
        gap = (ctl["logits"] - alone_out["logits"]).abs().max().item()
        print(f"[{tag}-main] control: request 0 with its first prompt token changed, the "
              f"other {prompt_len - 1} the same: logits max|d| {gap:.4e} from request 0 "
              f"alone (the replay's limit 0.0); completion {ctl['completion'][:8]}")
        need(gap > 0.0, "the control's logits equal request 0's: the replay tests nothing")


def moe_phases(torch, np, gen, dev) -> None:
    """Phases 11-12: moonshot-v1-16b-a3b at full width and depth, then
    deepseek-v3-671b at full width and MLA_LAYERS layers, one after the
    other on ``dev``."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    moon, ds = get_config(MOE_ARCH), get_config(MLA_ARCH)
    moe_tols = (MOE_BF16_LOGIT_ATOL, 0.0, MOE_BF16_LOGIT_REL_L2, False)
    phi_tols = (BF16_LOGIT_ATOL, 0.0, BF16_LOGIT_REL_L2)
    for tag, published, cfg, f32_layers, tols, pool in (
            ("moe", moon, moon, MOE_F32_LAYERS, moe_tols, True),
            ("mla", ds, ds.with_(n_layers=MLA_LAYERS, mtp=False), MLA_LAYERS, phi_tols, False)):
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] before {cfg.name}: memory_allocated {_gb(torch.cuda.memory_allocated())}"
              f" (earlier models freed); max_memory_allocated so far "
              f"{_gb(torch.cuda.max_memory_allocated())}")
        torch.cuda.reset_peak_memory_stats()
        no_drop_cf = cfg.moe.num_experts / cfg.moe.top_k
        no_drop = cfg.with_(moe=dataclasses.replace(cfg.moe, capacity_factor=no_drop_cf))
        toks = torch.randint(0, cfg.vocab, (1, PROMPT + 1), device=dev, generator=gen)
        cfg32 = no_drop.with_(n_layers=f32_layers, dtype="float32")
        p32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(1), device=dev,
                      dtype=torch.float32)
        check_consistency(torch, lm, cfg32, p32, toks, (F32_LOGIT_TOL, F32_LOGIT_TOL, F32_LOGIT_TOL),
                          f"{cfg.name} f32, {cfg32.n_layers} layers, capacity factor {no_drop_cf:g}")
        del p32
        torch.cuda.empty_cache()
        params = moe_model(torch, lm, cfg, published, dev, tag)
        # In bf16 the prefill, decode and forward hidden states part by
        # rounding, and where a router is near a tie they pick other
        # experts, whose outputs (std ~75 at random init) swamp the
        # residual; later routers then see other inputs.  So the bf16
        # checks replay forward's routing and count what would have flipped.
        pin = PinnedRouting()
        check_consistency(torch, lm, no_drop, params, toks, tols,
                          f"{cfg.name} bf16, {cfg.n_layers} layers, capacity factor {no_drop_cf:g}, "
                          f"forward's routing", pin)
        print(f"[{tag}] routing replayed from forward: {pin.flips} of {pin.decisions} token-layer "
              f"decisions of prefill and decode would have picked another expert set")
        serve_times(torch, lm, cfg, params, dev, gen, active=True, tag=f"{tag}-time")
        if pool:
            rng = np.random.default_rng(2)
            pool_phase(torch, np, lm, cfg, params, dev,
                       token_requests(rng, cfg, MOE_POOL_REQUESTS, MOE_PROMPT),
                       MOE_NEW_TOKENS, rng, tag)
        else:  # 20. shard: deepseek through the full-EP layout
            sharded_phase(torch, lm, no_drop, params, dev, gen, "shard-20",
                          (MOE_BF16_LOGIT_ATOL, 0.0, MOE_BF16_LOGIT_REL_L2, False),
                          pin=PinnedRouting())
        print(f"[{tag}] max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
        del params
    gc.collect()
    torch.cuda.empty_cache()


def recurrent_phases(torch, np, gen, dev) -> None:
    """Phases 13-14: mamba2-2.7b, then recurrentgemma-2b, at full width and
    depth on ``dev``, each freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.bridge import flatten

    ssm_tols = (SSM_BF16_LOGIT_ATOL, 0.0, SSM_BF16_LOGIT_REL_L2, False)
    phi_tols = (BF16_LOGIT_ATOL, 0.0, BF16_LOGIT_REL_L2)
    for tag, arch, cont, tols in (("ssm", SSM_ARCH, SSM_CONTINUE, ssm_tols),
                                  ("rglru", RGLRU_ARCH, RGLRU_CONTINUE, phi_tols)):
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] before {arch}: memory_allocated {_gb(torch.cuda.memory_allocated())} "
              f"(earlier models freed); max_memory_allocated so far "
              f"{_gb(torch.cuda.max_memory_allocated())}")
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        L = cfg.n_layers
        toks = torch.randint(0, cfg.vocab, (1, cont[2]), device=dev, generator=gen)
        cfg32 = cfg.with_(dtype="float32")
        p32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(1), device=dev,
                      dtype=torch.float32)
        check_consistency(torch, lm, cfg32, p32, toks, (F32_LOGIT_TOL, F32_LOGIT_TOL, F32_LOGIT_TOL),
                          f"{arch} f32, {L} layers", cont=cont)
        del p32
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] f32 checks: max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = flatten(params)
        n_params = sum(t.numel() for t in leaves.values())
        need(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
        f32 = sorted({k.split("/")[-1] for k, t in leaves.items() if t.dtype == torch.float32})
        need(f32 == (["a_log", "dt_bias"] if cfg.ssm else ["lam"]),
             f"leaves stored in f32: {f32}")
        if cfg.ssm:
            s = cfg.ssm
            mixer = (f"SSD: {s.expand * cfg.d_model // s.head_dim} heads of {s.head_dim}, "
                     f"state {s.d_state}, chunk {s.chunk}")
        else:
            mixer = (f"RG-LRU width {cfg.rglru.lru_width}; local attention {cfg.n_heads}/"
                     f"{cfg.n_kv_heads} heads of {cfg.head_dim_}, window {cfg.window}")
        print(f"[{tag}] {arch} full width and depth, no cut: {L} layers {cfg.scan_groups()}, "
              f"d_model {cfg.d_model}, {mixer}; vocab {cfg.vocab} (padded to "
              f"{cfg.vocab_padded}, tied); {n_params:,} parameters, "
              f"{_gb(sum(t.numel() * t.element_size() for t in leaves.values()))} in bf16 "
              f"({', '.join(f32)} f32), drawn in {init_s:.2f} s; max_memory_allocated "
              f"{_gb(torch.cuda.max_memory_allocated())}")
        check_consistency(torch, lm, cfg, params, toks, tols, f"{arch} bf16, {L} layers",
                          cont=cont)
        del toks
        serve_times(torch, lm, cfg, params, dev, gen, active=False, tag=f"{tag}-time")
        if cfg.rglru:
            gates = [t for k, t in leaves.items() if k.split("/")[-1] in ("w_a", "w_i")]
            ms = timed_ms(torch, lambda: [w.float() for w in gates], iters=10, warmup=2)
            n = sum(t.numel() for t in gates)
            print(f"[{tag}-time] _gates' f32 widening of w_a and w_i, {len(gates)} stacks "
                  f"({n:,} elements): {ms:.4f} ms a decode step, {_gb(8 * n)} moved beyond "
                  f"the bound (written and read again in f32)")
        del leaves
        rng = np.random.default_rng(3)
        pool_phase(torch, np, lm, cfg, params, dev,
                   token_requests(rng, cfg, REC_POOL_REQUESTS, REC_PROMPT),
                   REC_NEW_TOKENS, rng, tag, logits=True)
        print(f"[{tag}] max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
        del params
    gc.collect()
    torch.cuda.empty_cache()


def frontend_inputs(torch, cfg, dev, gen):
    """The inputs of an enc-dec or VLM request, drawn from ``gen``, as a
    function of the parameters: ``batches(params) -> (prompt, full, cont)``.
    ``cont`` [1, CONTINUE] are the tokens decoded after the prompt; ``full``
    is the prompt and ``cont`` in one batch.  seamless: ENC_FRAMES stub
    frame embeddings and PROMPT tokens, the last CONTINUE of them decoded.
    qwen2-vl: VLM_GRID^2 stub patch embeddings at M-RoPE (t, h, w) = (0, i,
    j), VLM_TEXT text tokens at t = h = w = VLM_GRID + k (their embedding
    rows in the model's dtype), then CONTINUE tokens at their cache index
    in all three sections, where decode_step puts them."""
    d = cfg.d_model
    if cfg.enc_layers:
        enc = torch.randn((1, ENC_FRAMES, d), device=dev, generator=gen) * STUB_STD
        toks = torch.randint(0, cfg.vocab, (1, PROMPT), device=dev, generator=gen)
        p0 = PROMPT - CONTINUE

        def batches(params):
            return ({"tokens": toks[:, :p0], "enc_embeds": enc},
                    {"tokens": toks, "enc_embeds": enc}, toks[:, p0:])

        return batches
    n_img = VLM_GRID * VLM_GRID
    patches = torch.randn((1, n_img, d), device=dev, generator=gen) * STUB_STD
    text = torch.randint(0, cfg.vocab, (1, VLM_TEXT), device=dev, generator=gen)
    cont = torch.randint(0, cfg.vocab, (1, CONTINUE), device=dev, generator=gen)
    grid = torch.arange(n_img, device=dev)
    img = torch.stack([torch.zeros_like(grid), grid // VLM_GRID, grid % VLM_GRID])
    p0 = n_img + VLM_TEXT
    pos = torch.cat([img, (VLM_GRID + torch.arange(VLM_TEXT, device=dev)).expand(3, -1),
                     (p0 + torch.arange(CONTINUE, device=dev)).expand(3, -1)], 1)[:, None]

    def batches(params):
        emb = torch.cat([patches.to(params["embed"].dtype), params["embed"][text],
                         params["embed"][cont]], 1)
        return ({"embeds": emb[:, :p0], "positions": pos[..., :p0]},
                {"embeds": emb, "positions": pos}, cont)

    return batches


def prefill_consistency(torch, lm, cfg, params, prompt, full, cont, tols, label: str) -> None:
    """The checks of a model whose decode starts from a prefill (an enc-dec
    model's memory K/V come from it; a VLM's image arrives as embeddings):
    (a) a prefill of ``prompt``, pad_caches, then a decode step for each
    token of ``cont``, each step's logits against forward over ``full`` at
    its position, and the last against prefill of ``full``; (b) an enc-dec
    model's memory K/V bit-equal after the decode steps to prefill's; (c)
    the caches padded to a second length, PROMPT longer, give the same
    decode logits.  ``tols`` as in :func:`check_consistency`."""
    n = cont.shape[1]
    p0 = (full["embeds"] if "embeds" in full else full["tokens"]).shape[1] - n
    *bounds, argmax = tols if len(tols) == 4 else (*tols, True)
    want, _ = lm.forward(params, full, cfg)
    last, _ = lm.prefill(params, full, cfg)
    _, caches = lm.prefill(params, prompt, cfg)
    memory = [t.clone() for t in caches[0][0][1]] if cfg.enc_layers else []
    runs = []
    for cache_len in (p0 + n, p0 + n + PROMPT):
        padded = lm.pad_caches(caches, cfg, cache_len)
        runs.append(torch.cat([lm.decode_step(params, cont[:, i : i + 1], padded, p0 + i, cfg)[0]
                               for i in range(n)], 1))
        del padded
    compare_logits(torch, runs[0], want[:, p0:], *bounds, cfg.vocab,
                   f"{label}: {n} decode steps after a {p0}-position prefill and pad_caches vs "
                   f"forward at positions {p0}..{p0 + n - 1}", argmax)
    compare_logits(torch, runs[0][:, -1:], last, *bounds, cfg.vocab,
                   f"{label}: the last decode step vs prefill of all {p0 + n} positions", argmax)
    compare_logits(torch, runs[1], runs[0], *bounds, cfg.vocab,
                   f"{label}: the decode steps with the caches padded to {p0 + n + PROMPT} vs "
                   f"{p0 + n}", argmax)
    if memory:
        same = all(torch.equal(a, b) for a, b in zip(caches[0][0][1], memory))
        print(f"[serve-check] {label}: memory K/V {list(memory[0].shape)} x 2 bit-equal to "
              f"prefill's after {2 * n} decode steps: {same}")
        need(same, f"{label}: decode changed the memory K/V")
    del want, last, caches, runs


def frontend_phases(torch, np, gen, dev) -> None:
    """Phases 15-16: seamless-m4t-medium, then qwen2-vl-2b, at full width and
    depth on ``dev``, each freed before the next."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.bridge import flatten

    f32_tols = (F32_LOGIT_TOL, F32_LOGIT_TOL, F32_LOGIT_TOL)
    for tag, arch in (("encdec", ENCDEC_ARCH), ("vlm", VLM_ARCH)):
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] before {arch}: memory_allocated {_gb(torch.cuda.memory_allocated())} "
              f"(earlier models freed); max_memory_allocated so far "
              f"{_gb(torch.cuda.max_memory_allocated())}")
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch)
        depth = (f"{cfg.enc_layers} encoder + {cfg.n_layers} decoder layers" if cfg.enc_layers
                 else f"{cfg.n_layers} layers")
        batches = frontend_inputs(torch, cfg, dev, gen)
        cfg32 = cfg.with_(dtype="float32")
        p32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(1), device=dev,
                      dtype=torch.float32)
        prefill_consistency(torch, lm, cfg32, p32, *batches(p32), f32_tols, f"{arch} f32, {depth}")
        del p32
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] f32 checks: max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = flatten(params)
        n_params = sum(t.numel() for t in leaves.values())
        need(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
        if cfg.enc_layers:
            shape = f"d_ff {cfg.d_ff} plain ReLU MLP; stub audio frames"
        else:
            shape = (f"d_ff {cfg.d_ff}, q/k/v biases, M-RoPE sections {cfg.mrope_sections}; stub "
                     f"patch embeddings")
        print(f"[{tag}] {arch} full width and depth, no cut: {depth}, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}, {shape}; vocab "
              f"{cfg.vocab} (padded to {cfg.vocab_padded}, untied); {n_params:,} parameters, "
              f"{_gb(sum(t.numel() * t.element_size() for t in leaves.values()))} in bf16, drawn "
              f"in {init_s:.2f} s; max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
        prompt, full, cont = batches(params)
        prefill_consistency(torch, lm, cfg, params, prompt, full, cont, FRONTEND_BF16_TOLS,
                            f"{arch} bf16, {depth}")
        if cfg.enc_layers:
            encdec_times(torch, np, lm, cfg, params, leaves, dev, gen, full["enc_embeds"], tag)
        else:
            n_img = VLM_GRID * VLM_GRID
            serve_times(torch, lm, cfg, params, dev, gen, active=False, tag=f"{tag}-time",
                        prefill=(prompt, f"{n_img + VLM_TEXT} positions ({n_img} image, "
                                         f"{VLM_TEXT} text)"))
        del leaves, prompt, full, cont, batches
        print(f"[{tag}] max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
        del params
    gc.collect()
    torch.cuda.empty_cache()


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def rel_l2(torch, got, want) -> tuple[float, float, float, str]:
    """(relative L2 distance, max|d|, the largest relative L2 of one leaf,
    that leaf's key) of two gradient trees, in f64."""
    from repro_torch.models.bridge import flatten

    got, want = flatten(got), flatten(want)
    need(got.keys() == want.keys(), "gradient trees of different structure")
    num = den = worst = 0.0
    leaf = (0.0, "")
    for k, w in want.items():
        d = got[k].double() - w.double()
        dd, ww = float((d * d).sum()), float((w.double() ** 2).sum())
        num += dd
        den += ww
        worst = max(worst, float(d.abs().max()))
        leaf = max(leaf, (math.sqrt(dd / ww) if ww else (0.0 if dd == 0 else math.inf), k))
    return math.sqrt(num / den), worst, *leaf


def train_microbatches(torch, cfg, dev, step: int) -> list[dict]:
    """Step ``step``'s TRAIN_TASKS microbatches of TRAIN_ROWS x TRAIN_SEQ
    tokens from the copied SyntheticLM (seed 0), on ``dev``."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_ROWS * TRAIN_TASKS, seed=0))
    b = data.batch_at(step)
    return [{k: torch.from_numpy(v[i::TRAIN_TASKS].copy()).to(dev) for k, v in b.items()}
            for i in range(TRAIN_TASKS)]


def microbatch_work(cfg, leaves, tokens: int) -> tuple[float, float]:
    """(bytes, flops) one microbatch's gradient must move and do under full
    remat: every parameter read and its gradient written once, the tokens
    read; 8 flops per matmul parameter per token (2 forward, 2 recompute, 4
    backward; the embedding is a lookup, the head a matmul) and the causal
    attention's scores and values, 4 times (forward, recompute, backward's
    two products)."""
    nbytes = 2 * sum(t.numel() * t.element_size() for t in leaves.values()) + 8 * tokens
    matmul = sum(t.numel() for k, t in leaves.items() if k != "embed" and t.ndim >= 2
                 and not k.split("/")[-1].startswith("norm"))
    keys = TRAIN_ROWS * TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn = 2 * keys * cfg.n_heads * 2 * cfg.head_dim_ * cfg.n_layers
    return nbytes, 8 * matmul * tokens + 4 * attn


def adamw_bytes(params, grads, opt_state) -> int:
    """What one AdamW update must move: the gradient, parameters and both
    moments read once, the parameters and moments written once."""
    from repro_torch.autodiff import tree_leaves

    size = lambda tree: sum(t.numel() * t.element_size() for t in tree_leaves(tree))  # noqa: E731
    return size(grads) + 2 * (size(params) + size(opt_state["m"]) + size(opt_state["v"]))


def paced_floor_ms(mb_ms: float) -> tuple[float, float, float]:
    """The least makespan of a step's TRAIN_TASKS paced tasks, in ms, and its
    two terms in microbatches of ``mb_ms``: a task costs its microbatch plus
    a sleep of TRAIN_PACE microbatches times its worker's slowdown, so
    (a) balanced over the workers, as if tasks could be split, the step
    takes TRAIN_TASKS / sum(1 / (1 + TRAIN_PACE * slowdown)) microbatches;
    (b) one card runs the microbatches one after another (threads gain
    nothing by overlapping them: ``threads_vs_one``), and the last one
    still sleeps: TRAIN_TASKS + TRAIN_PACE * min(slowdown)."""
    balanced = TRAIN_TASKS / sum(1.0 / (1.0 + TRAIN_PACE * max(s, 1.0)) for s in TRAIN_SLOW)
    serial = TRAIN_TASKS + TRAIN_PACE * max(min(TRAIN_SLOW), 1.0)
    return max(balanced, serial) * mb_ms, balanced, serial


def pool_gradient_check(torch, trainer, mbs, tag: str, label: str, bound: float,
                        leaf_bound: float) -> None:
    """The pool's combined gradient (its workers as they are) against the
    same microbatches run by its first worker alone, within a relative L2
    of ``bound`` over the whole tree and of ``leaf_bound`` over each leaf."""
    g_pool, m = trainer.gradient(mbs)
    specs = list(trainer.workers)
    for wid in range(len(specs) - 1, 0, -1):
        trainer.remove_worker(wid)
    g_one, m_one = trainer.gradient(mbs)
    for spec in specs[1:]:
        trainer.add_worker(spec)
    rel, worst, leaf_rel, leaf = rel_l2(torch, g_pool, g_one)
    del g_pool, g_one
    ok = rel <= bound and leaf_rel <= leaf_bound
    print(f"[{tag}] {label}: the pool's combined gradient (tasks/worker "
          f"{m['tasks_per_worker']}, steals {m['steals']}) vs one worker's "
          f"({m_one['tasks_per_worker']}) over the same {len(mbs)} microbatches: relative L2 "
          f"{rel:.3e} (limit {bound}), worst leaf {leaf} {leaf_rel:.3e} (limit {leaf_bound}), "
          f"max|d| {worst:.3e} {'ok' if ok else 'FAIL'}")
    need(rel <= bound, f"{label}: the pool's gradient is {rel} from one worker's, beyond {bound}")
    need(leaf_rel <= leaf_bound,
         f"{label}: the pool's gradient leaf {leaf} is {leaf_rel} from one worker's, "
         f"beyond {leaf_bound}")


def threads_vs_one(torch, lm, cfg, params, mbs, mb_ms: float, card: str) -> None:
    """How far worker threads overlap: the microbatches' gradients back to
    back on one thread, then split over len(TRAIN_SLOW) threads each on a
    stream of its own (the pool's arrangement, without its sleeps), host
    clock; and one microbatch's host time, from the call to its return, of
    its time to the end of its device work.  PyTorch runs every backward
    on one autograd thread per device, whichever thread asked for it."""
    import threading

    from repro_torch.autodiff import value_and_grad

    grad = value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg))
    nw = len(TRAIN_SLOW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grad(params, mbs[0])
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    whole = time.perf_counter() - t0
    t0 = time.perf_counter()
    for mb in mbs:
        grad(params, mb)
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    streams = [torch.cuda.Stream() for _ in range(nw)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    errors = []

    def work(w: int) -> None:
        try:
            with torch.cuda.stream(streams[w]):
                for mb in mbs[w::nw]:
                    grad(params, mb)
                streams[w].synchronize()
        except Exception as e:  # noqa: BLE001 — reported below, after the join
            errors.append(e)

    threads = [threading.Thread(target=work, args=(w,)) for w in range(nw)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    many = time.perf_counter() - t0
    need(not errors and not any(t.is_alive() for t in threads), f"worker threads: {errors}")
    print(f"[train-threads] {card}: {len(mbs)} microbatch gradients back to back on one thread "
          f"{one:.3f} s ({1e3 * one / len(mbs):.1f} ms each; {mb_ms:.1f} ms alone on the device); "
          f"over {nw} threads, a stream each, {many:.3f} s = {many / one:.2f}x one thread; one "
          f"microbatch's host time to return {1e3 * host:.1f} ms of {1e3 * whole:.1f} ms to its "
          f"device work's end")


def train_phases(torch, np, gen, dev) -> None:
    """Phases 17-18: phi4-mini-3.8b trained at full width on ``dev`` through
    HetDPTrainer, after the serving models are freed."""
    from repro_torch.autodiff import tree_leaves, value_and_grad
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import lm
    from repro_torch.models.bridge import flatten
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.runtime.fault_tolerance import ResilientDriver
    from repro_torch.runtime.het_dp import HetDPTrainer, WorkerSpec

    gc.collect()
    torch.cuda.empty_cache()
    card = card_name()
    print(f"[train] {card}; memory_allocated {_gb(torch.cuda.memory_allocated())} "
          f"(the serving models freed)")
    full = get_config(TRAIN_ARCH)
    tokens = TRAIN_ROWS * TRAIN_SEQ

    def workers():
        return [WorkerSpec(f"w{i}", slow_factor=f) for i, f in enumerate(TRAIN_SLOW)]

    def pace(cfg, params, mbs) -> float:
        """ms of one microbatch's gradient alone on the default stream."""
        grad = value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg))
        return timed_ms(torch, lambda: grad(params, mbs[0]), iters=2, warmup=1)

    # 17. train-check: (a) the gradient's exactness in f32 --------------------
    torch.cuda.reset_peak_memory_stats()
    cfg32 = full.with_(n_layers=TRAIN_F32_LAYERS, dtype="float32")
    p32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(1), device=dev,
                  dtype=torch.float32)
    mbs = train_microbatches(torch, cfg32, dev, 0)
    ms32 = pace(cfg32, p32, mbs)
    tr = HetDPTrainer(lambda p, b: lm.loss_fn(p, b, cfg32), p32, workers(),
                      base_task_time=TRAIN_PACE * ms32 / 1e3)
    pool_gradient_check(torch, tr, mbs, "train-check",
                        f"f32, full width, {TRAIN_F32_LAYERS} layers", TRAIN_F32_REL_L2,
                        TRAIN_F32_REL_L2)
    del tr, p32, mbs
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train-check] f32: one microbatch {ms32:.2f} ms alone ({card}); "
          f"max_memory_allocated {_gb(torch.cuda.max_memory_allocated())}")
    shard_train_phase(torch, lm, cfg32, dev)
    # 24. shard-train-ssm: mamba2's mixer per rank on the same mesh
    shard_train_phase(torch, lm, get_config(SSM_ARCH).with_(n_layers=TRAIN_F32_LAYERS,
                                                            dtype="float32"),
                      dev, tag="shard-train-ssm")

    # 18. train-main: 16 layers in bf16 through the pool ----------------------
    torch.cuda.reset_peak_memory_stats()
    cfg = full.with_(n_layers=TRAIN_LAYERS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    leaves = flatten(params)
    n_params = sum(t.numel() for t in leaves.values())
    need(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
    print(f"[train] {TRAIN_ARCH} at full width, {TRAIN_LAYERS} of {full.n_layers} layers, "
          f"remat {cfg.remat!r}: d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
          f"of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab} (untied); {n_params:,} "
          f"parameters, {_gb(2 * n_params)} in bf16, drawn in {time.perf_counter() - t0:.2f} s")
    mbs = train_microbatches(torch, cfg, dev, 0)
    mb_ms = pace(cfg, params, mbs)
    mb_bytes, mb_flops = microbatch_work(cfg, leaves, tokens)
    mb_bound, mb_by = bound(mb_bytes, mb_flops)
    print(f"[train-time] {card}: one microbatch ({TRAIN_ROWS} x {TRAIN_SEQ} tokens; forward, "
          f"recompute, backward) {mb_ms:.2f} ms alone, CUDA events; bound {mb_bound:.2f} ms "
          f"({mb_flops:.3e} flop at 989 TFLOP/s bf16, {_gb(mb_bytes)}; {mb_by}-bound) = "
          f"{mb_bound / mb_ms:.1%} of it")
    tr = HetDPTrainer(lambda p, b: lm.loss_fn(p, b, cfg), params, workers(),
                      base_task_time=TRAIN_PACE * mb_ms / 1e3)
    del params
    # (b) the same comparison in bf16, reported
    pool_gradient_check(torch, tr, mbs, "train-check", f"bf16, {TRAIN_LAYERS} layers",
                        TRAIN_BF16_REL_L2, TRAIN_BF16_LEAF_REL_L2)
    gc.collect()
    torch.cuda.empty_cache()
    before = {k: t.reshape(-1)[:4096].float().cpu() for k, t in flatten(tr.params).items()}
    floor_ms, balanced, serial = paced_floor_ms(mb_ms)
    steals = 0
    for step in range(TRAIN_STEPS):
        mbs = train_microbatches(torch, cfg, dev, step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.step(mbs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steals += m["steals"]
        print(f"[train-main] {card}: step {step}: loss {m['loss']:.4f}, grad_norm "
              f"{m['grad_norm']:.4f}, tasks/worker {m['tasks_per_worker']} (slowdowns "
              f"{list(TRAIN_SLOW)}), steals {m['steals']}, makespan {m['makespan']:.3f} s "
              f"(wall with the combine and the update {wall:.3f} s); the paced schedule's "
              f"floor {floor_ms / 1e3:.3f} s = {floor_ms / mb_ms:.2f} microbatches of "
              f"{mb_ms:.2f} ms (each task sleeps {TRAIN_PACE:g} microbatch times its slowdown: "
              f"balanced over the workers {balanced:.2f}, the card running the "
              f"{TRAIN_TASKS} one after another and the last one's sleep {serial:.2f})")
        need(math.isfinite(m["loss"]), f"step {step}: loss {m['loss']}")
        need(m["grad_norm"] > 0 and math.isfinite(m["grad_norm"]),
             f"step {step}: grad_norm {m['grad_norm']}")
        need(sum(m["tasks_per_worker"]) == TRAIN_TASKS and not m["failed_workers"],
             f"step {step}: tasks/worker {m['tasks_per_worker']}")
    moved = [k for k, t in flatten(tr.params).items()
             if not torch.equal(t.reshape(-1)[:4096].float().cpu(), before[k])]
    print(f"[train-main] {len(moved)} of {len(before)} parameter leaves moved; steals in "
          f"{TRAIN_STEPS} steps {steals}; max_memory_allocated "
          f"{_gb(torch.cuda.max_memory_allocated())} ({card})")
    need(len(moved) == len(before), f"leaves that did not move: {sorted(set(before) - set(moved))}")
    need(steals >= 1, f"no steal in {TRAIN_STEPS} steps")
    # AdamW alone, on one more combined gradient: the update writes into the
    # trainer's parameters and moments, which are not read for checks again
    grads, _ = tr.gradient(mbs)
    u_bytes = adamw_bytes(tr.params, grads, tr.opt_state)
    u_ms = timed_ms(torch, lambda: adamw_update(grads, tr.opt_state, tr.params, tr.opt_cfg),
                    iters=3, warmup=1)
    del grads
    u_bound = u_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[train-time] {card}: adamw_update {u_ms:.2f} ms, bound {u_bound:.2f} ms "
          f"({_gb(u_bytes)} at 3.35 TB/s) = {u_bound / u_ms:.1%} of it; a step's work at the "
          f"card's peak rates, without the pacing: {TRAIN_TASKS} microbatches and the update "
          f"{TRAIN_TASKS * mb_bound + u_bound:.1f} ms against {TRAIN_TASKS * mb_ms + u_ms:.1f} "
          f"ms measured alone")
    threads_vs_one(torch, lm, cfg, tr.params, mbs, mb_ms, card)
    del tr, mbs, before, leaves
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the ResilientDriver at SMOKE size: a worker fails, is removed, and a
    # fresh trainer resumes from the last checkpoint
    smoke = get_smoke(TRAIN_ARCH)

    def smoke_trainer(seed: int, specs):
        params = lm.init(smoke, torch.Generator(device=dev).manual_seed(seed), device=dev)
        return HetDPTrainer(lambda p, b: lm.loss_fn(p, b, smoke), params, specs,
                            AdamWConfig(lr=1e-3), base_task_time=0.002)

    def smoke_mbs(step: int):
        r = np.random.default_rng(step)
        toks = torch.from_numpy(r.integers(0, smoke.vocab, (TRAIN_TASKS, 2, 33))).to(dev)
        return [{"tokens": t[:, :-1], "labels": t[:, 1:]} for t in toks]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt:
        tr = smoke_trainer(0, [WorkerSpec("a"), WorkerSpec("b", slow_factor=4.0),
                               WorkerSpec("dies", fail_at_step=2)])
        report = ResilientDriver(tr, smoke_mbs, ckpt, ckpt_every=2).run(DRIVER_STEPS)
        fresh = smoke_trainer(1, [WorkerSpec("c")])
        again = ResilientDriver(fresh, smoke_mbs, ckpt, ckpt_every=2)
        resumed = again._maybe_restore()
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(fresh.params),
                                                     tree_leaves(tr.params)))
        more = again.run(DRIVER_STEPS + 2)
    print(f"[train-driver] SMOKE {TRAIN_ARCH}: {report.steps_run} steps, removed "
          f"{report.removed_workers}, restarts {report.restarts}, final loss "
          f"{report.final_loss:.4f}; a fresh trainer resumed at step {resumed} with the saved "
          f"parameters ({same}) and ran {more.steps_run} more, final loss {more.final_loss:.4f}")
    need(report.steps_run == DRIVER_STEPS and report.removed_workers == ["dies"],
         f"driver: {report}")
    need(resumed == DRIVER_STEPS and same and more.steps_run == 2, "driver: resume failed")
    need(math.isfinite(report.final_loss) and math.isfinite(more.final_loss), "driver: loss")


def shard_train_phase(torch, lm, cfg, dev, tag: str = "shard-train") -> None:
    """Phases 23 and 24: one sharded ``jit_train_step`` of ``cfg`` on the
    one-rank mesh against the unsharded step (see the module docstring).
    A gradient leaf whose name ends in a key of LEAF_REL_L2 is held to that
    key's bound, the others to TRAIN_F32_REL_L2."""
    from repro_torch.autodiff import tree_map, value_and_grad
    from repro_torch.models.bridge import flatten
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.step import (
        batch_shardings,
        jit_train_step,
        make_train_step,
        train_shardings,
    )

    card = card_name()
    mesh = one_rank_mesh(torch, dev)
    ctx = sh.make_context(mesh)
    torch.cuda.reset_peak_memory_stats()
    opt_cfg = AdamWConfig()
    plain = lm.init(cfg, torch.Generator(device=dev).manual_seed(2), device=dev,
                    dtype=torch.float32)
    mine = tree_map(torch.clone, plain)  # the sharded step writes into its own copy
    plain_opt, mine_opt = adamw_init(plain, opt_cfg), adamw_init(mine, opt_cfg)
    batch = train_microbatches(torch, cfg, dev, 1)[0]
    step = jit_train_step(cfg, ctx, opt_cfg, batch)
    p_sh, o_sh = (sh.distribute_tree(t, s) for t, s in
                  zip((mine, mine_opt), train_shardings(cfg, ctx, opt_cfg)))
    d_batch = sh.distribute_tree(batch, batch_shardings(batch, ctx))
    @sh.mesh_region  # backward too meets plain tensors as replicated ones
    def grads(params, batch, ctx=None):
        return value_and_grad(lambda p, b: lm.loss_fn(p, b, cfg, ctx))(params, batch)

    # the gradients, sharded and not, on the same parameters
    (lu, _), gu = grads(plain, batch)
    (ls, _), gs = grads(p_sh, d_batch, ctx=ctx)
    gs, gu = {k: v.full_tensor() for k, v in flatten(gs).items()}, flatten(gu)
    g_rel, g_max, _, _ = rel_l2(torch, gs, gu)
    own = {k: next(b for end, b in LEAF_REL_L2.items() if k.endswith(end)) for k in gu
           if k.endswith(tuple(LEAF_REL_L2))}
    rest = [k for k in gu if k not in own]
    _, _, g_leaf, g_key = rel_l2(torch, {k: gs[k] for k in rest}, {k: gu[k] for k in rest})
    held = {k: (rel_l2(torch, {k: gs[k]}, {k: gu[k]})[0], b) for k, b in own.items()}
    g_equal = all(torch.equal(gs[k], v) for k, v in gu.items())
    loss_u, loss_s = float(lu), float(ls.full_tensor())
    del gu, gs
    print(f"[{tag}] {cfg.name} at full width, {cfg.n_layers} layers, f32, on a one-rank mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} ({card}), {TRAIN_ROWS} x {TRAIN_SEQ} "
          f"tokens: loss sharded {loss_s:.8f}, unsharded {loss_u:.8f}; gradients rel L2 "
          f"{g_rel:.3e} (max|d| {g_max:.3e}; worst leaf {g_key} {g_leaf:.3e}; bound "
          f"{TRAIN_F32_REL_L2:g}), bit-equal: {g_equal}")
    for k, (gap, bound) in held.items():
        print(f"[{tag}] leaf {k}: rel L2 {gap:.3e} (its bound {bound:g})")
    need(abs(loss_s - loss_u) <= TRAIN_F32_REL_L2 * abs(loss_u), f"{tag}: losses differ")
    need(g_rel <= TRAIN_F32_REL_L2 and g_leaf <= TRAIN_F32_REL_L2
         and all(gap <= bound for gap, bound in held.values()), f"{tag}: gradients differ")
    # one step each, then their updated parameters
    unsharded = make_train_step(cfg, opt_cfg)
    new_u, _, mu = unsharded(plain, plain_opt, batch)
    new_s, _, ms = step(p_sh, o_sh, batch)
    p_rel, p_max, p_leaf, p_key = rel_l2(torch, {k: v.full_tensor() for k, v in
                                                 flatten(new_s).items()}, flatten(new_u))
    print(f"[{tag}] after one step: loss sharded {float(ms['loss']):.8f}, unsharded "
          f"{float(mu['loss']):.8f}; updated parameters rel L2 {p_rel:.3e} (max|d| {p_max:.3e}; "
          f"worst leaf {p_key} {p_leaf:.3e})")
    # AdamW's first step divides each gradient element by its own size, so a
    # leaf whose gradients sit near eps (the norm scales start at 0) shows
    # the f32 gradient gap magnified: the whole tree is held, the worst leaf
    # reported
    need(p_rel <= TRAIN_F32_REL_L2, f"{tag}: updated parameters differ")
    s_ms = timed_ms(torch, lambda: step(p_sh, o_sh, batch), iters=2, warmup=1)
    u_ms = timed_ms(torch, lambda: unsharded(plain, plain_opt, batch), iters=2, warmup=1)
    print(f"[{tag}] {card}: a train step (loss, gradients, AdamW) sharded {s_ms:.2f} ms, "
          f"unsharded {u_ms:.2f} ms ({s_ms / u_ms:.2f}x), CUDA events; max_memory_allocated "
          f"{_gb(torch.cuda.max_memory_allocated())}")
    del plain, mine, plain_opt, mine_opt, p_sh, o_sh, new_u, new_s
    gc.collect()
    torch.cuda.empty_cache()


def encdec_times(torch, np, lm, cfg, params, leaves, dev, gen, enc, tag: str) -> None:
    """seamless's times: the encoder over ENC_FRAMES frames beside its bound,
    then phase 8's times (decode against caches that a prefill of PROMPT
    tokens and the frames filled, and a prefill of PROMPT tokens with the
    frames), then phase 13's pool over REC_POOL_REQUESTS requests of
    ENC_FRAMES frames and REC_PROMPT tokens, each replica generating with
    :func:`encdec_generate`."""
    enc_leaves = [t for k, t in leaves.items() if k.startswith("enc_")]
    nbytes = (sum(t.numel() * t.element_size() for t in enc_leaves)
              + 2 * ENC_FRAMES * cfg.d_model * 2)  # the weights, the frames in and out
    flops = (2 * ENC_FRAMES * sum(t.numel() for t in enc_leaves)
             + 2 * ENC_FRAMES * ENC_FRAMES * cfg.enc_layers * cfg.n_heads * 2 * cfg.head_dim_)
    ms = timed_ms(torch, lambda: lm._encode(params, {"enc_embeds": enc}, cfg, {"chunk": 1024}),
                  iters=5, warmup=2)
    bms, by = bound(nbytes, flops)
    print(f"[{tag}-time] encoder, {cfg.enc_layers} layers over {ENC_FRAMES} frames: {ms:.4f} ms; "
          f"bound {bms:.4f} ms ({flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16, {_gb(nbytes)}, "
          f"{by}-bound) = {bms / ms:.1%} of it")

    def caches_for(bsz):
        toks = torch.randint(0, cfg.vocab, (bsz, PROMPT), device=dev, generator=gen)
        _, caches = lm.prefill(params, {"tokens": toks, "enc_embeds": enc.expand(bsz, -1, -1)}, cfg)
        return lm.pad_caches(caches, cfg, DECODE_CACHE)

    ptoks = torch.randint(0, cfg.vocab, (1, PROMPT), device=dev, generator=gen)
    serve_times(torch, lm, cfg, params, dev, gen, active=False, tag=f"{tag}-time",
                caches_for=caches_for, enc_len=ENC_FRAMES,
                prefill=({"tokens": ptoks, "enc_embeds": enc},
                         f"{PROMPT} tokens after {ENC_FRAMES} encoder frames"))
    rng = np.random.default_rng(4)
    requests = [{"tokens": rng.integers(0, cfg.vocab, REC_PROMPT),
                 "enc_embeds": (rng.standard_normal((ENC_FRAMES, cfg.d_model)) * STUB_STD
                                ).astype(np.float32)} for _ in range(REC_POOL_REQUESTS)]
    pool_phase(torch, np, lm, cfg, params, dev, requests, REC_NEW_TOKENS, rng, tag, logits=True)


def moe_model(torch, lm, cfg, published, dev, tag: str):
    """``cfg``'s weights drawn on ``dev`` from a seeded generator, counted
    against the reference's parameter count; its cuts from ``published``
    are printed."""
    from repro_torch.models.bridge import flatten

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = flatten(params)
    n_params = sum(t.numel() for t in leaves.values())
    need(n_params == cfg.param_count(), f"{n_params} parameters, expected {cfg.param_count()}")
    routers = [k for k in leaves if k.endswith("/router")]
    need(bool(routers) and all(leaves[k].dtype == torch.float32 for k in routers),
         "the router is not stored in f32")
    m = cfg.moe
    cuts = [f"{cfg.n_layers} of {published.n_layers} layers"] * (cfg.n_layers != published.n_layers)
    cuts += ["MTP off"] * (published.mtp and not cfg.mtp)
    attn = (f"MLA (q rank {cfg.mla.q_lora_rank}, kv rank {cfg.mla.kv_lora_rank})"
            if cfg.mla is not None else f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim_}")
    print(f"[{tag}] {cfg.name} full width, cut: {', '.join(cuts) or 'none'}; {cfg.n_layers} "
          f"layers {cfg.scan_groups()}, d_model "
          f"{cfg.d_model}, {attn}; {m.num_experts} experts of {m.d_expert}, top-{m.top_k}, "
          f"{m.num_shared} shared, capacity factor {m.capacity_factor}; {n_params:,} parameters "
          f"({cfg.active_param_count():,} active), "
          f"{_gb(sum(t.numel() * t.element_size() for t in leaves.values()))} in bf16 (router "
          f"f32), drawn in {init_s:.2f} s; max_memory_allocated "
          f"{_gb(torch.cuda.max_memory_allocated())}")
    return params


def same_as_alone(torch, np, lm, cfg, params, decode, dev, prompt, alone, pooled,
                  what: str, tag: str) -> None:
    """A completion through the pool must equal the same request run alone;
    where it does not, report the logits gap at the first token that differs,
    seen from the alone run's context."""
    if pooled == alone:
        print(f"[{tag}-main] {what} equals it run alone: {pooled[:8]}...")
        return
    # the diagnosis decodes the context from empty caches: an enc-dec
    # model cannot (its memory K/V come from a prefill)
    need(not cfg.enc_layers, f"{what}: pooled completion {pooled} differs from {alone} alone")
    j = next(i for i, (a, b) in enumerate(zip(alone, pooled)) if a != b)
    ctx = torch.as_tensor(np.concatenate([prompt, alone[:j]]), device=dev)[None]
    caches = lm.init_caches(cfg, 1, ctx.shape[1], device=dev)
    for i in range(ctx.shape[1]):
        logits, caches = decode(params, ctx[:, i : i + 1], caches, i)
    gap = (logits[0, -1, alone[j]] - logits[0, -1, pooled[j]]).item()
    print(f"[{tag}-main] {what} differs from it run alone at token {j}: logits gap "
          f"{gap:.4e} between tokens {alone[j]} and {pooled[j]}")
    need(False, f"{what}: pooled completion differs from the request run alone")


def quarter_speeds(p: int) -> list[float]:
    return [s for s in (24.0, 16.0, 4.0, 1.0) for _ in range(p // 4)]


def sched_states_equal(torch, a, b) -> str | None:
    """The first field in which two scheduler states differ (NaN equals
    NaN; queues compared on each worker's prefix [0, tail)), else None."""
    for name in a._fields:
        x, y = getattr(a, name).cpu(), getattr(b, name).cpu()
        if name == "queue":
            live = torch.arange(x.shape[1])[None, :] < a.tail.cpu()[:, None]
            x, y = torch.where(live, x, -2), torch.where(live, y, -2)
        same = (x == y) | (x.isnan() & y.isnan()) if x.is_floating_point() else x == y
        if not bool(same.all()):
            return name
    return None


def sched_first_split(torch, ds, cfg, packed: bool, dev) -> tuple[int, str] | None:
    """Rerun both devices round by round on one CPU generator's draws, as
    ``virtual_run`` draws them, and name the first round and field that split."""
    p, radius, max_steal, per = cfg
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    states = {d: ds.init_state(p, [per] * p, quarter_speeds(p), radius, p * per, device=d)
              for d in (cpu, dev)}
    fns = {d: ds.make_round_fn(p, radius, max_steal, packed=packed, device=d) for d in states}
    for rnd in range(1, SCHED_MAX_ROUNDS + 1):
        g = ds.gumbel_draws((p, 2 * radius + 1), gen, cpu)
        states = {d: fns[d](s, gumbel=g.to(d)) for d, s in states.items()}
        field = sched_states_equal(torch, states[dev], states[cpu])
        if field is not None:
            return rnd, field
        if int((states[cpu].tail - states[cpu].head).sum()) == 0:
            return None
    return None


def sched_check_conserved(torch, state, rounds: int, num_tasks: int, what: str) -> None:
    tail = state.tail.cpu()
    queue = state.queue.cpu()
    ids = torch.cat([queue[i, : tail[i]] for i in range(queue.shape[0])])
    need(torch.equal(ids.sort().values, torch.arange(num_tasks, dtype=torch.int32)),
         f"{what}: the queues do not hold every task id exactly once")
    need(torch.equal(state.head.cpu(), tail), f"{what}: head != tail at the end")
    need(int(state.executed.sum()) == num_tasks,
         f"{what}: executed {int(state.executed.sum())} of {num_tasks}")
    need(rounds < SCHED_MAX_ROUNDS, f"{what}: hit max_rounds {SCHED_MAX_ROUNDS}")


def sched_phase(torch, np, dev) -> None:
    """Phase 10: the device scheduler on ``dev`` against the CPU."""
    from repro_torch.core import device_sched as ds

    cpu = torch.device("cpu")
    radius = SCHED_CELL[1]
    w = 2 * radius + 1

    # (a) Eq. 5 and the γ-rounding on random windows ----------------------
    rng = np.random.default_rng(0)
    win_n = rng.integers(0, 40, (SCHED_WINDOWS, w)).astype(np.float32)
    win_t = rng.uniform(0.05, 4.0, (SCHED_WINDOWS, w)).astype(np.float32)
    win_t[rng.random((SCHED_WINDOWS, w)) < 0.3] = np.nan
    win_t[:, radius] = rng.uniform(0.05, 4.0, SCHED_WINDOWS)
    args = [torch.from_numpy(a) for a in (win_n, win_t)]
    rate = {d: ds.steal_rate_window(*(a.to(d) for a in args), radius).cpu() for d in (dev, cpu)}
    rel = ((rate[dev] - rate[cpu]).abs() / rate[cpu].abs().clamp_min(1e-30)).max().item()
    g_args = [torch.from_numpy(rng.uniform(0, 12, SCHED_WINDOWS).astype(np.float32))]
    g_args += [torch.from_numpy(a) for a in (win_n[:, 0], win_t[:, radius], win_n[:, 1],
                                             np.nan_to_num(win_t[:, 1], nan=np.inf))]
    gam = {d: ds.gamma_round(*(a.to(d) for a in g_args)).cpu() for d in (dev, cpu)}
    n_gamma = int((gam[dev] != gam[cpu]).sum())
    print(f"[sched] {SCHED_WINDOWS} windows of {w} cells (30% unknown): steal rate on the "
          f"card vs the CPU max relative gap {rel:.3e} (limit {SCHED_RTOL}); gamma_round "
          f"differs in {n_gamma} of {SCHED_WINDOWS}")
    need(bool(torch.isfinite(rate[cpu]).all()), "steal rates not finite")
    need(rel <= SCHED_RTOL, f"steal_rate_window: card vs CPU relative gap {rel}")
    need(n_gamma == 0, f"gamma_round: card and CPU differ in {n_gamma} cases")

    # (b), (c) scripts/sched_cell.py's configuration, card against CPU -----
    for packed in (True, False):
        sched_card_vs_cpu(torch, ds, SCHED_CELL, packed, dev)

    # (d) four times the workers, card against CPU, then timed -------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sched_card_vs_cpu(torch, ds, SCHED_BIG, True, dev)
    peak = torch.cuda.max_memory_allocated()
    p, radius, max_steal, per = SCHED_BIG
    round_fn = ds.make_round_fn(p, radius, max_steal, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = ds.init_state(p, [per] * p, quarter_speeds(p), radius, p * per, device=dev)
    ms = []
    while int((state.tail - state.head).sum()) > 0:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state = round_fn(state, gen)
        stop.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(stop))
        need(len(ms) < SCHED_MAX_ROUNDS, f"P={p}: timed run hit max_rounds")
    print(f"[sched] P={p} R={radius} packed: {float(np.median(ms)):.4f} ms per round "
          f"(median of {len(ms)}, CUDA events, draws on the card); max_memory_allocated "
          f"{_gb(peak)} (card run of the comparison)")
    # 21. sched-ranks, one rank ------------------------------------------------
    sched_one_rank_phase(torch, np, dev)
    # 22. sched-ranks, four processes on the card --------------------------------
    sched_four_ranks_phase(torch, np, dev)


def sched_one_rank_phase(torch, np, dev) -> None:
    """Phase 21 (see the module docstring)."""
    import torch.distributed as dist

    from repro_torch.core import device_sched as ds
    from repro_torch.launch.mesh import make_workers_mesh

    card = card_name()
    one_rank_mesh(torch, dev)  # the one-rank group of phases 19-20
    mesh = make_workers_mesh(1)
    for cfg in (SCHED_CELL, SCHED_BIG):
        p, radius, max_steal, per = cfg
        for packed in (True, False):
            what = f"sched-21 P={p} R={radius} {'packed' if packed else 'baseline'}"
            runs = [ds.virtual_run(p, quarter_speeds(p), p * per, radius, max_steal, device=dev,
                                   packed=packed, generator=torch.Generator().manual_seed(0),
                                   mesh=m)
                    for m in (None, mesh)]
            (want, want_rounds, want_ms), (got, rounds, makespan) = runs
            need(got.queue.device.type == dev.type, f"{what}: state left {dev}")
            field = sched_states_equal(torch, got, want)
            need(rounds == want_rounds and makespan == want_ms and field is None,
                 f"{what}: one rank vs one process: rounds {rounds} vs {want_rounds}, "
                 f"makespan {makespan} vs {want_ms}, first field that differs {field}")
            sched_check_conserved(torch, got, rounds, p * per, what)
            times = sched_round_times(torch, np, ds, cfg, packed, dev, mesh)
            print(f"[{what}] one {dist.get_backend()} rank == one process: {rounds} rounds, "
                  f"makespan {makespan}, every field equal; ms per round (median of "
                  f"{SCHED_TIMED_ROUNDS}, CUDA events) one rank {times['ranks'][0]:.4f} / one "
                  f"process {times['one'][0]:.4f}; host enqueue {times['ranks'][1]:.4f} / "
                  f"{times['one'][1]:.4f} ms; {card}")


def sched_round_times(torch, np, ds, cfg, packed: bool, dev, mesh) -> dict:
    """Median device ms (CUDA events) and host enqueue ms of one round on a
    fixed mid-run state, one process and on ``mesh``, in turns (one, ranks,
    ranks, one) so that drift shows between two runs of one."""
    p, radius, max_steal, per = cfg
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {k: ds.make_round_fn(p, radius, max_steal, packed=packed, device=dev, mesh=m)
           for k, m in (("one", None), ("ranks", mesh))}
    state = ds.init_state(p, [per] * p, quarter_speeds(p), radius, p * per, device=dev)
    for _ in range(SCHED_WARM_ROUNDS):
        state = fns["one"](state, gen)
    dev_ms = {k: [] for k in fns}
    host_ms = {k: [] for k in fns}
    for k in ("one", "ranks", "ranks", "one"):
        for i in range(SCHED_TIMED_ROUNDS // 2 + 2):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fns[k](state, gen)
            t1 = time.perf_counter()
            stop.record()
            torch.cuda.synchronize()
            if i >= 2:  # two warm-up calls a turn
                dev_ms[k].append(start.elapsed_time(stop))
                host_ms[k].append((t1 - t0) * 1e3)
    return {k: (float(np.median(dev_ms[k])), float(np.median(host_ms[k]))) for k in fns}


_RANK_BOOT = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import chip_smoke
chip_smoke.sched_rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
"""


def sched_snapshot(torch, state) -> dict:
    """A block of scheduler state on the host: the queue as a digest of each
    worker's live prefix [0, tail), every other field whole."""
    import hashlib

    out = {k: v.cpu().numpy() for k, v in state._asdict().items() if k != "queue"}
    queue = state.queue.cpu()
    live = torch.arange(queue.shape[1])[None, :] < state.tail.cpu()[:, None]
    out["queue"] = hashlib.sha256(torch.where(live, queue, -2).numpy().tobytes()).hexdigest()
    return out


def sched_rank_main(rank: int, tmp: str, device: str) -> None:
    """One of phase 22's processes: rank ``rank`` of a ``gloo`` group of
    SCHED_RANKS joined through a file store under ``tmp``, SCHED_CELL's
    workers in blocks on ``device``; writes its block's snapshot after every
    round and the wall ms of every round to ``tmp``/rank<r>.pkl."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    from repro_torch.core import device_sched as ds
    from repro_torch.launch.mesh import make_workers_mesh
    from repro_torch.parallel.collectives import all_reduce

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), SCHED_RANKS),
                            rank=rank, world_size=SCHED_RANKS,
                            timeout=datetime.timedelta(seconds=SCHED_RANKS_TIMEOUT))
    try:
        mesh = make_workers_mesh(SCHED_RANKS)
        p, radius, max_steal, per = SCHED_CELL
        out = {}
        for packed in (True, False):
            gen = torch.Generator().manual_seed(0)
            state = ds.init_state(p, [per] * p, quarter_speeds(p), radius, p * per, device=dev,
                                  mesh=mesh)
            step = ds.make_round_fn(p, radius, max_steal, packed=packed, device=dev, mesh=mesh)
            snaps, ms = [], []
            while len(ms) < SCHED_MAX_ROUNDS and int(
                    all_reduce((state.tail - state.head).sum(), mesh, ("workers",))) > 0:
                sync()
                t0 = time.perf_counter()
                state = step(state, gen)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                snaps.append(sched_snapshot(torch, state))
            out[packed] = {"snaps": snaps, "ms": ms}
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def sched_four_ranks_phase(torch, np, dev) -> None:
    """Phase 22 (see the module docstring)."""
    import pickle

    from repro_torch.core import device_sched as ds

    card = card_name()
    root = os.path.dirname(os.path.abspath(__file__))
    p, radius, max_steal, per = SCHED_CELL
    b = p // SCHED_RANKS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        code = _RANK_BOOT.format(root=root, src=os.path.join(root, "src"))
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(SCHED_RANKS)]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, "-c", code, str(r), tmp, dev.type], env=env,
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(SCHED_RANKS)]
        try:
            while any(q.poll() is None for q in procs):
                if (time.perf_counter() - t0 > SCHED_RANKS_TIMEOUT
                        or any(q.poll() not in (None, 0) for q in procs)):
                    break
                time.sleep(0.1)
        finally:
            for q in procs:
                if q.poll() is None:
                    q.kill()
                q.wait()
            for f in logs:
                f.close()
        wall = time.perf_counter() - t0
        if any(q.returncode != 0 for q in procs):
            tails = "".join(f"\n--- rank {r} (rc {q.returncode}):\n"
                            + open(os.path.join(tmp, f"rank{r}.log")).read()[-2000:]
                            for r, q in enumerate(procs))
            need(False, f"sched-22: a rank failed or outlasted {SCHED_RANKS_TIMEOUT} s:{tails}")
        ranks = []
        for r in range(SCHED_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for packed in (True, False):
        what = f"sched-22 P={p} R={radius} {'packed' if packed else 'baseline'}"
        gen = torch.Generator().manual_seed(0)
        state = ds.init_state(p, [per] * p, quarter_speeds(p), radius, p * per, device=dev)
        step = ds.make_round_fn(p, radius, max_steal, packed=packed, device=dev)
        n_rounds = len(ranks[0][packed]["snaps"])
        bit_equal = True
        for rnd in range(n_rounds):
            need(int((state.tail - state.head).sum()) > 0,
                 f"{what}: the ranks ran {n_rounds} rounds, one process ended after {rnd}")
            state = step(state, gen)
            for r, res in enumerate(ranks):
                want = sched_snapshot(torch, ds.SchedState(*(t[r * b:(r + 1) * b] for t in state)))
                got = res[packed]["snaps"][rnd]
                for k, w in want.items():
                    g = got[k]
                    if isinstance(w, str) or w.dtype.kind != "f":
                        same = g == w if isinstance(w, str) else np.array_equal(g, w)
                        need(same, f"{what}: round {rnd + 1}, rank {r}, field {k} differs")
                    else:
                        need(np.allclose(g, w, rtol=SCHED_RTOL, atol=0, equal_nan=True),
                             f"{what}: round {rnd + 1}, rank {r}, field {k} beyond {SCHED_RTOL}")
                        bit_equal &= np.array_equal(g, w, equal_nan=True)
        need(int((state.tail - state.head).sum()) == 0,
             f"{what}: the ranks ended after {n_rounds} rounds, one process goes on")
        makespan = max(float(res[packed]["snaps"][-1]["clock"].max()) for res in ranks)
        ms = ranks[0][packed]["ms"]
        print(f"[{what}] {SCHED_RANKS} gloo processes on the card, {b} workers each == one "
              f"process, every round: {n_rounds} rounds, makespan {makespan}, floats "
              f"{'bit-equal' if bit_equal else f'within {SCHED_RTOL}'}; wall ms per round "
              f"(rank 0, synchronized) median {float(np.median(ms)):.4f}, min "
              f"{min(ms):.4f}; the group's {wall:.1f} s in all; {card}")


def sched_card_vs_cpu(torch, ds, cfg, packed: bool, dev) -> None:
    """``virtual_run`` at ``cfg`` on the card and on the CPU with the same
    draws: integer state equal, makespan within SCHED_RTOL, every task id
    conserved.  Prints the rounds, the makespan beside its bounds, the tasks
    executed per speed quarter and the tasks run away from their first
    worker."""
    p, radius, max_steal, per = cfg
    cpu = torch.device("cpu")
    num_tasks = p * per
    speeds = quarter_speeds(p)
    what = f"P={p} R={radius} {'packed' if packed else 'baseline'}"
    runs = {d: ds.virtual_run(p, speeds, num_tasks, radius, max_steal, device=d,
                              packed=packed, generator=torch.Generator().manual_seed(0))
            for d in (cpu, dev)}
    (got, rounds, makespan), (want, want_rounds, want_ms) = runs[dev], runs[cpu]
    need(got.queue.device.type == dev.type, f"{what}: state left {dev}")
    field = sched_states_equal(torch, got, want)
    if rounds != want_rounds or field is not None:
        split = sched_first_split(torch, ds, cfg, packed, dev)
        need(False, f"{what}: card and CPU split (rounds {rounds} vs {want_rounds}, "
                    f"final field {field}); first split at (round, field) {split}")
    need(abs(makespan - want_ms) <= SCHED_RTOL * max(1.0, abs(want_ms)),
         f"{what}: makespan {makespan} vs {want_ms} on the CPU")
    sched_check_conserved(torch, got, rounds, num_tasks, what)
    queue, tail = got.queue.cpu(), got.tail.cpu()
    live = torch.arange(num_tasks)[None, :] < tail[:, None]
    home = torch.div(queue, per, rounding_mode="floor")  # block partition: per tasks each
    moved = int((live & (home != torch.arange(p)[:, None])).sum())
    print(f"[sched] {what}, max_steal {max_steal}, {num_tasks} tasks: {rounds} rounds, "
          f"makespan {makespan} (static partition {max(per / s for s in speeds)}, balanced "
          f"{num_tasks / sum(speeds):.4f}); card == CPU in rounds, executed, head, tail, "
          f"queues; executed per speed quarter {{24,16,4,1}} "
          f"{got.executed.cpu().view(4, -1).sum(1).tolist()}; {moved} tasks run by "
          f"another worker than their first")


def main() -> int:
    try:
        result = run()
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
