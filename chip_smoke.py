"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the six CUDA sources from ``src/repro_torch/kernels/csrc``
with nvcc, one nvcc per source in parallel, and drives the port's
paths:

  * the PD-ORS offer path: both offer-path kernels and their host-level
    calls against their plain torch versions on the card (bit for bit;
    near-ties at three magnitudes, unreachable rows, Q1 up to 1024, k
    up to 200, R from 1 to 8, NaN and negative free), then the paper's
    largest Fig. 6 point (H=100 machines, T=20 slots, 50 jobs, ethernet preset,
    workload_scale=0.3, batch=(50,200), quanta=20, seed 0) on the card
    and on the CPU, requiring identical decisions;
  * the online simulator (``repro_torch.launch.sim``) at the JAX package's
    largest simulator benchmark point (``benchmarks/bench_sim.py``
    FULL_GRID row 2: 16 machines, a 16-slot lookahead window, the google
    preset, 500 jobs at 6.0 arrivals a slot, failure rate 0.05, seed 0,
    quanta 12, 48 calibration jobs): PD-ORS on the card after a warm-up
    run and on the CPU, requiring an identical per-job decision log (every
    offer's admission and schedule, every outcome) and utility within rel
    1e-9, both offer kernels launched inside the event engine on every
    plan and sweep; fifo, drf and dorm on the card and on the CPU with
    identical logs; OASiS (R = 6 pseudo-resources) at the Fig. 6 point on
    the card and on the CPU, identical decisions;
  * the simulator's other paths (``launch.sim``'s tiers), each on the card
    against the CPU with both offer kernels launched: the sim point with
    ``bench_sim.py``'s chaos leg (rack-pair crashes and stragglers in the
    capacity mask, injected LP faults, pdors wrapped in
    ``ResilientPolicy``), identical decision logs, summaries and policy
    health; the same run checkpointed every 16 slots, killed at slot 64
    and recovered (summary, outcomes and ledger equal the uninterrupted
    run's; the checkpoint's and the restored ledgers on the card);
    ``bench_sim.py``'s elastic tier (8 machines, W = 16, google, 300 jobs
    at 4.0, failure 0.05, its reshape storm), batched and per-event
    engines bit-identical on the card and the batched run identical on
    the CPU; its service row (8 machines, W = 16, google, 1500 jobs at 4.0
    submitted 64 at a time through the asyncio ``OfferService``), each
    formed batch offered again through ``PDORS.offer_batch`` on the CPU
    with identical admissions; and, last, one profiled chaos run (idle
    share, spans by self time);
  * the serving path: the rmsnorm and flash-attention kernels (bf16 on
    the tensor cores, float32 on the CUDA cores) against their plain
    versions on the card (the bf16 kernel also at its edges in both of
    its instances, each call repeated bit for bit, and on unaligned
    inputs), then Gemma-7B at full width and
    full depth (28 layers, random weights from seed 0, float32 params,
    bfloat16 compute) serving 8 requests of 1024 prompt tokens and 32
    new tokens, max_batch 4, greedy, through ``ServeEngine.serve``, with
    exact launch counts of both kernels, every prefill's attention on
    the tensor-core kernel, and a profiled serve giving the idle share
    and the rmsnorm device time split by phase and launch shape (each
    profiler session padded with launches before and after its work and
    held to its launch count: a session that lost a launch of its work
    reads None); then a
    2-layer float32 cut of the full-width model served on the card and
    on the CPU from the same weights, requiring identical greedy tokens;
  * the training path: rmsnorm's backward kernel against its plain
    version on the card (the training shape (8192, 3072), decode rows,
    d = 1, an odd d, d = 16384, narrow rows, the partition's edges,
    unaligned pointers; twice bit for bit at (8192, 3072) and at Qwen3's
    QK-norm rows), then Gemma-7B at full width cut to 4 of its 28 layers
    (float32 params and AdamW moments, bfloat16 compute, remat "full")
    trained 8 steps of SyntheticLM batches of 2 x 4096 tokens through
    ``Trainer.run``: every loss finite and the last below the first, a
    finite non-zero gradient on every parameter at step 0, exact rmsnorm
    forward and backward launch counts (the remat recomputation
    included), the profiled step 6's idle share, and the checkpoint the
    trainer writes read back equal leaf for leaf; then its 2-layer
    float32 cut trained 3 steps on the card and on the CPU from the same
    weights (each loss to rel 1e-5, every step-0 gradient to 1e-4 of its
    tensor's largest, launches exact), and one more step of the trained
    point under ``FlopCounterMode``;
  * the scheduler-driven training runtime (``repro_torch.launch.cluster``,
    the port of ``examples/cluster_sim.py``'s default mode): the
    example's own settings (8 slots, 6 jobs over the ten archs, 3 steps a
    slot, reduced float32 configs) scheduled and trained on the card and
    on the CPU, the CPU run from the card run's initial params and
    batches: identical decisions and utility, each offer kernel launched
    as often as the CPU run calls its wrapper, exact rmsnorm launches,
    every job's loss in every slot within 1e-5; then Gemma-7B and
    Qwen3-32B jobs at full width cut to 2 layers (float32 params and
    moments, bf16 compute, remat "full"), each job's state reckoned
    from ``param_count`` before anything is allocated (the jobs sharing
    a slot at most 64 GB), its step times, tokens/s, peak memory, the
    profiled third step's idle share, finite losses, launches exact;
  * the dry run (``repro_torch.launch.dryrun`` through its CLI, each plan
    in a process of its own, all at once): the production plans at full
    width and depth on fake process groups — Gemma-7B train_4k,
    prefill_32k and decode_32k on 16x16 and train_4k on 2x16x16,
    Phi-3.5-MoE train_4k, MiniCPM3-4B decode_32k — each with finite
    per-device FLOPs, argument and peak bytes, collective bytes by kind
    and link and the H100 roofline terms (Gemma's train_4k state under
    80 GB a device); and the one-card plan of the training point
    (``--host``, 4 layers, 2 x 4096), whose FLOPs and argument bytes must
    equal the counted step's exactly, its peak and roofline compute term
    printed beside the run's peak memory and step time;
  * the MoE serving path: Phi-3.5-MoE at full width (d_model 4096, 32 x
    128 query heads, 8 kv heads, 16 experts top-2 of d_ff 6400, vocab
    32064, capacity factor 1.25, groups of 512) cut to 8 of its 32
    layers, served as Gemma-7B is, with exact launch counts and the
    dropped (token, k) slots of a prefill and a decode forward (routed
    again from each MoE layer's input by a forward pre-hook); then its
    2-layer float32 cut on the card and on the CPU, requiring identical
    greedy tokens and identical routing (top-k indices, keep masks) at
    every token whose routing gap exceeds 1e-6;
  * Command R+ at full width (d_model 12,288, 96 x 128 query heads over
    8 kv heads, d_ff 33,792, vocab 256,000 untied, bf16 params) cut to 1
    of its 64 layers, trained 3 steps of 16 x 64 tokens with the cluster
    example's AdamW (lr 1e-3, bf16 moments), its update in slabs: the
    peak reckoned first and printed beside the measured one, finite
    losses, a finite non-zero gradient on every param, exact norm
    launches, step times and the profiled step's idle share;
  * the dense GQA, MLA, vision, SSM, hybrid and enc-dec serving paths,
    each phase freeing the last model first: Qwen3-32B at full width
    (d_model 5120, 64 x 128 query heads over 8 kv heads, QK-norm, d_ff
    25,600, vocab 151,936 untied, float32 params) cut to 16 of its 64
    layers and Command R+ (as above, bf16 params) cut to 12 of its 64,
    each with Gemma-7B's traffic through ``ServeEngine.serve``;
    MiniCPM3-4B at full width (d_model
    2560, 40 heads, q_lora 768, kv_lora 256, nope 64 / rope 32 / v 64,
    vocab 73448, tied) cut to 16 of its 62 layers, with Gemma-7B's
    traffic through ``ServeEngine.serve``; LLaVA-NeXT (Mistral-7B) at
    full width cut to 16 of its 32 layers (32 x 128 query heads over 8 kv
    heads, frontend_dim 1024) through ``Model.prefill`` / ``decode``, two
    batches of 4 requests of 2880 random image embeddings + 128 tokens
    (S = 3008), 32 new tokens; DeepSeek-V2 at full width (MLA with
    kv_lora 512, 160 experts top-6 of d_ff 1536 plus 2 shared, bf16
    params) cut to 6 of its 60 layers, 8 prompts of 512 tokens, 16 new,
    max_batch 4; Mamba2-780m at full width and depth (48 layers, d_model
    1536, 48 SSD heads of 64, state 128, vocab 50280, tied) with Gemma's
    traffic; Hymba-1.5B at full width cut to 16 of its 32 layers
    (d_model 1600, 25 x 64 query heads over 5 kv heads, a sliding window
    of 1024 with the first and last layers global, SSD state 16) serving
    8 prompts of 2048 tokens, 32 new, max_batch 4; and SeamlessM4T-medium
    at full width and depth (12 encoder + 12 decoder layers, d_model 1024,
    16 x 64 heads,
    vocab 256206) through ``Model.prefill`` / ``decode``, two batches of 4
    requests of 1600 random frame embeddings + 128 target tokens, 32 new;
    each with exact launch counts (QK-norm and MLA: four norms a layer,
    MLA no flash; the SSM: two, no flash; Hymba: five and one flash a
    layer a prefill; SeamlessM4T: 25 an encode, 37 a decoder forward, 36
    flash a prefill)
    and then its 2-layer float32 cut on the card and on the CPU
    (identical greedy tokens, logits within 1e-3, exact launches;
    DeepSeek-V2 also identical routing above the 1e-6 gap; LLaVA with 256
    image embeddings + 64 tokens; SeamlessM4T 2 + 2 layers with 256
    frames + 64 tokens); the SSM phases also time the SSD alone at their
    shapes for its share of the device's busy time.

It prints each path's numbers, the card's name and power limit, one JSON
line with each kernel's launches, error, times and bound (the offer
kernels also with their host-level call's time, copies included;
rmsnorm at the prefill shape (4096, 3072) and, nested, the decode shape
(4, 3072), under ``qwen3_32b`` and ``command_r_plus`` at their block
rows (4096 and 4) and Qwen3-32B's QK-norm rows (262144, 32768, 256 and
32 of 128), Command R+'s training rows (1024, 12288) too, under
``gemma_7b_train`` the training run's launches and the
training shape (8192, 3072), under ``cluster`` the cluster phase's
launches and Qwen3-32B's QK-norm shapes (65536, 128) and (8192, 128),
and under ``phi35_moe`` at (4096, 4096) and
(4, 4096); rmsnorm's backward at the training shape, its launches the
training run's, under ``cluster`` as the forward and under
``command_r_plus_train`` at (1024, 12288); flash attention's bf16 route
and, under ``qwen3_32b`` and ``command_r_plus``, at their prefill (4,
1024, 64 or 96 heads, 8 kv heads, 128), under ``phi35_moe`` at Phi-3.5-MoE's
prefill (4, 1024, 32 heads, 8 kv heads, 128), under ``llava_next`` at
LLaVA-NeXT's (4, 3008, 32, 8, 128), under ``hymba_1_5b`` at Hymba's (4,
2048, 25, 5, 64; window 1024 and global) and under
``seamless_m4t_medium`` at SeamlessM4T's (encoder 1600 x 1600, cross 128
x 1600, decoder 128 x 128); flash attention's float32 route as a kernel
of its own (its launches: the float32 parity cuts'); rmsnorm at MLA's
ranks under ``mla_norms`` and at the SSM, hybrid and enc-dec widths under
``ssm_hybrid_encdec_norms``; each serving phase's launches; the offer
kernels' launches on the sim path beside the static path's, and on each
of the chaos, recover, elastic, service and cluster paths), and as its
last line ``{"ok": true, "device": {...}}``. Every phase raises on
failure; the script exits 2 without a result line when there is no card
or no port (``src/repro_torch``) next to it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12          # float64 outside the tensor cores
FP32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12         # bfloat16 tensor cores, dense
L2_BYTES = 50 * 2**20           # the H100 SXM's L2 cache

# the serving run: Gemma-7B at full width and depth
SERVE_POINT = dict(arch="gemma-7b", requests=8, prompt_len=1024,
                   max_new=32, max_batch=4, seed=0)
# the cuda-vs-cpu parity run: the full-width model cut to 2 layers, f32
PARITY_POINT = dict(arch="gemma-7b", layers=2, requests=2, prompt_len=128,
                    max_new=8, seed=1)

# the MoE serving run: Phi-3.5-MoE at full width, 8 of its 32 layers (the
# whole model, 41.9 B params, is 83.7 GB even in bf16; at 8 layers the
# float32 master and the engine's bf16 copy peak near 64 GB at set-up)
MOE_SERVE_POINT = dict(arch="phi3.5-moe-42b-a6.6b", layers=8, requests=8,
                       prompt_len=1024, max_new=32, max_batch=4, seed=0)
MOE_PARITY_POINT = dict(arch="phi3.5-moe-42b-a6.6b", layers=2, requests=2,
                        prompt_len=128, max_new=8, seed=1)
# cuda and cpu must route a token alike when each gap between its k + 1
# largest router probabilities exceeds this
ROUTING_GAP = 1e-6

# MLA serving: MiniCPM3-4B at full width, 16 of its 62 layers (the whole
# depth's phase took 83 s on an H100 80GB HBM3 at 700 W; its layers are
# alike), Gemma's traffic
MLA_SERVE_POINT = dict(arch="minicpm3-4b", layers=16, requests=8,
                       prompt_len=1024, max_new=32, max_batch=4, seed=0)
MLA_PARITY_POINT = dict(arch="minicpm3-4b", layers=2, requests=2,
                        prompt_len=128, max_new=8, seed=1)
# vision serving: LLaVA-NeXT (Mistral-7B) at full width, 16 of its 32
# layers (the whole depth's phase took 49 s on an H100 80GB HBM3 at 700
# W; its layers are alike), each request 2880 image embeddings (the
# config's frontend_tokens) + 128 text tokens, through Model.prefill /
# decode (ServeEngine takes tokens only)
VLM_SERVE_POINT = dict(arch="llava-next-mistral-7b", layers=16, requests=8,
                       prompt_len=128, images=2880, max_new=32, max_batch=4,
                       seed=0)
VLM_PARITY_POINT = dict(arch="llava-next-mistral-7b", layers=2, requests=2,
                        prompt_len=64, images=256, max_new=8, seed=1)
# MLA + MoE serving: DeepSeek-V2 at full width, 6 of its 60 layers (a
# layer is 3.97 B bf16 params, 7.94 GB: 6 layers and the tables are 49.8
# GB; the whole model is 472 GB)
DSV2_SERVE_POINT = dict(arch="deepseek-v2-236b", layers=6, requests=8,
                        prompt_len=512, max_new=16, max_batch=4, seed=0)
DSV2_PARITY_POINT = dict(arch="deepseek-v2-236b", layers=2, requests=2,
                         prompt_len=128, max_new=8, seed=1)
# dense GQA at the widths not served before: Qwen3-32B (QK-norm over
# rows of its head width 128; 64 query heads over 8 kv heads; float32
# params) cut to 16 of its 64 layers (9.36 B params: 56.2 GB at set-up
# with the engine's bf16 copy), and Command R+ (d 12,288, 96 query heads
# over 8 kv heads, d_ff 33,792, vocab 256,000 untied, bf16 params, which
# the engine reads as they are) cut to 12 of its 64 layers (25.2 B
# params, 50.3 GB); Gemma's traffic
QWEN3_SERVE_POINT = dict(arch="qwen3-32b", layers=16, requests=8,
                         prompt_len=1024, max_new=32, max_batch=4, seed=0)
QWEN3_PARITY_POINT = dict(arch="qwen3-32b", layers=2, requests=2,
                          prompt_len=128, max_new=8, seed=1)
CMDR_SERVE_POINT = dict(arch="command-r-plus-104b", layers=12, requests=8,
                        prompt_len=1024, max_new=32, max_batch=4, seed=0)
CMDR_PARITY_POINT = dict(arch="command-r-plus-104b", layers=2, requests=2,
                         prompt_len=128, max_new=8, seed=1)
# the SSM, hybrid and enc-dec serving runs, each at full width:
# Mamba2-780m at full depth with Gemma's traffic (a 1024-token prompt is
# 4 SSD chunks); Hymba-1.5B cut to 16 of its 32 layers (the whole depth's
# phase took 66 s on an H100 80GB HBM3 at 700 W) with 2048-token prompts,
# so its 1024 window cuts the prompt in all but its global first and
# last layers; SeamlessM4T-medium at full depth through Model.prefill /
# decode, each request 1600 frame embeddings (the config's
# frontend_tokens) and a 128-token target prompt
SSM_SERVE_POINT = dict(arch="mamba2-780m", requests=8, prompt_len=1024,
                       max_new=32, max_batch=4, seed=0)
SSM_PARITY_POINT = dict(arch="mamba2-780m", layers=2, requests=2,
                        prompt_len=128, max_new=8, seed=1)
HYBRID_SERVE_POINT = dict(arch="hymba-1.5b", layers=16, requests=8,
                          prompt_len=2048, max_new=32, max_batch=4, seed=0)
HYBRID_PARITY_POINT = dict(arch="hymba-1.5b", layers=2, requests=2,
                           prompt_len=128, max_new=8, seed=1)
ENCDEC_SERVE_POINT = dict(arch="seamless-m4t-medium", requests=8,
                          prompt_len=128, frames=1600, max_new=32,
                          max_batch=4, seed=0)
ENCDEC_PARITY_POINT = dict(arch="seamless-m4t-medium", layers=2, requests=2,
                           prompt_len=64, frames=256, max_new=8, seed=1)

# training: Gemma-7B at full width cut to 4 of its 28 layers (full depth's
# params, grads and two float32 moments, ~136 GB, do not fit one card),
# SyntheticLM batches of 2 x 4096 (train_4k's length: 4 query chunks of
# 1024), 8 steps of AdamW at lr 3e-4 through Trainer.run; step 6 is
# profiled. Its parity cut: 2 layers, float32, 2 x 128 tokens, cuda vs
# cpu, 3 steps with a 1-step warm-up (the reference's warm-up gives step 0
# an lr of 0, so step 2's loss is the first after a full-lr update)
TRAIN_POINT = dict(arch="gemma-7b", layers=4, batch=2, seq_len=4096,
                   steps=8, lr=3e-4, seed=0, profile_step=6)
TRAIN_PARITY_POINT = dict(arch="gemma-7b", layers=2, batch=2, seq_len=128,
                          steps=3, warmup=1, lr=3e-4, seed=1)

# scheduler-driven training (repro_torch.launch.cluster): the example's
# own settings (examples/cluster_sim.py's defaults: 8 slots, 6 jobs over
# the ten archs, 3 steps a slot; reduced configs, float32) on cuda and
# cpu; then Gemma-7B and Qwen3-32B jobs at full width cut to 2 layers
# (float32 params and moments, bf16 compute, remat "full"), the third
# step of each job profiled. The jobs sharing a slot must hold at most
# 64 GB of params, gradients and moments (a 2-layer Qwen3-32B job, 40.5
# GB; the whole model's 524 GB does not fit)
CLUSTER_POINT = dict(slots=8, jobs=6, steps_per_slot=3)
CLUSTER_FULL_POINT = dict(archs=("gemma-7b", "qwen3-32b"), slots=8, jobs=6,
                          steps_per_slot=3, layers=2, state_limit_gb=64.0,
                          profile_step=2)

# Command R+ trained at full width cut to 1 of its 64 layers, as the
# cluster phase trains its jobs: 16 x 64 tokens, 3 steps, the cluster
# example's AdamW (lr 1e-3, moments in the params' bf16) and train step
# (remat "full", the reference's warm-up, the float32 loss head over
# 256,000 words); the third step profiled. Its params, gradients and
# moments (8 B a param) are 62.9 GB
CMDR_TRAIN_POINT = dict(arch="command-r-plus-104b", layers=1, batch=16,
                        seq_len=64, steps=3, lr=1e-3, seed=0, profile_step=2)

PAPER_POINT = dict(machines=100, horizon=20, jobs=50, preset="ethernet",
                   workload_scale=0.3, batch=(50, 200), quanta=20, seed=0)
# the online simulator: bench_sim.py's FULL_GRID row 2, not cut
# (quanta 12 and 48 calibration jobs are launch.sim's, as bench_sim's)
SIM_POINT = dict(machines=16, lookahead=16, preset="google", jobs=500,
                 rate=6.0, failure_rate=0.05, seed=0)
SIM_BASELINES = ("fifo", "drf", "dorm")
# the chaos and recover phases run the sim point with bench_sim's chaos
# leg; the recover phase checkpoints every 16 slots and is killed at 64
RECOVER = dict(checkpoint_every=16, kill_at=64)
# bench_sim.py's ELASTIC_GRID row and STREAM_GRID row (the service row
# takes min(jobs, 1500) of its trace), not cut
ELASTIC_POINT = dict(machines=8, lookahead=16, preset="google", jobs=300,
                     rate=4.0, failure_rate=0.05, seed=0)
SERVICE_POINT = dict(machines=8, lookahead=16, preset="google",
                     jobs=100_000, rate=4.0, seed=0)


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _equal(a: torch.Tensor, b: torch.Tensor, what: str) -> float:
    """Bit-for-bit equality (NaN == NaN, inf == inf); returns max |a-b|
    over finite entries (0.0 when equal)."""
    x, y = a.cpu().numpy(), b.cpu().numpy()
    np.testing.assert_array_equal(x, y, err_msg=what)
    fin = np.isfinite(x) & np.isfinite(y)
    return float(np.max(np.abs(x[fin] - y[fin]), initial=0.0))


def _time_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    """Mean time per call on the card's clock: CUDA events around
    ``reps`` back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _copies(nbytes: int, *tensors) -> list:
    """``tensors`` and enough copies of them that one round over the sets
    moves at least twice the L2 (``nbytes`` a call): a call that takes the
    next set in turn reads its inputs from HBM, as its byte bound
    assumes, and not from the L2 the call before left them in."""
    n = max(1, -(-2 * L2_BYTES // nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]


def _rotating(fn, sets: list):
    """``fn`` over ``sets``, one set a call in turn."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def _device_ms(fn, name: str, reps: int = 50) -> float:
    """Mean device time of the kernel whose name contains ``name`` over
    ``reps`` calls of ``fn`` in a held session (``start_session``); None
    unless the session recorded a kernel for every launch of the calls."""
    fn()
    torch.cuda.synchronize()
    prof = start_session()
    for _ in range(reps):
        fn()
    stop_session(prof)
    launched, ran, _ = _kernel_counts(prof, PAD_HEAD + PAD_TAIL)
    times = [ns for n, _, ns in _device_events(prof) if name in n]
    return sum(times) / len(times) / 1e6 \
        if times and launched == ran else None


#: the kernel ``torch.cuda._sleep`` launches: a held session's pads
PAD_KERNEL = "spin_kernel"
#: launches padding a held session before and after its work. In a
#: process that has profiled before, a CUDA profiler session can drop the
#: kernel records of its first launches and of a tail of its last ones;
#: the first session of a process drops none (``scripts/
#: profiler_sessions.py``: bare sessions of a 36,948-launch serve lost
#: their first launch and their last 584 or 424; held ones lost only
#: pads, up to the last 1400 of the tail's; H100 80GB HBM3, torch 2.11)
PAD_HEAD, PAD_TAIL = 64, 16384


def _pad(n: int) -> None:
    for _ in range(n):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()


def start_session():
    """A CUDA-activity profiler session, started and padded (``PAD_HEAD``
    launches of ``PAD_KERNEL``, then a sync): the work that follows is the
    session's. ``stop_session`` ends it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    _pad(PAD_HEAD)
    return prof


def stop_session(prof):
    """Sync, pad (``PAD_TAIL`` launches) and stop ``prof``, dropping the
    port's spans recorded under it."""
    torch.cuda.synchronize()
    _pad(PAD_TAIL)
    prof.stop()
    _drop_session_spans()
    return prof


def _drop_session_spans() -> None:
    """Read the port's spans of the profiler session just stopped, which
    closes them: the next session's spans start afresh."""
    from repro_torch.obs import trace
    trace.session_spans()


def _device_events(prof) -> list:
    """A stopped session's device events (kernels, copies, fills) as
    (name, start ns, duration ns), read from the profiler's raw results:
    building its ``events()`` would take seconds at 10^5 events."""
    from torch.autograd import DeviceType
    return [(ev.name(), ev.start_ns(), ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == DeviceType.CUDA]


# --------------------------------------------------------------- inputs
def _bundle_inputs(gen, W, H, R, zero_cols=(), edges=False):
    price = torch.rand((W, H, R), generator=gen, dtype=torch.float64) * 8
    price += 0.1
    free = torch.rand((W, H, R), generator=gen, dtype=torch.float64) * 33
    free -= 3.0                               # < 0: over-committed
    wdem = (torch.rand(R, generator=gen, dtype=torch.float64) * 3).numpy()
    sdem = (torch.rand(R, generator=gen, dtype=torch.float64) * 3).numpy()
    for k in zero_cols:
        wdem[k] = 0.0
        sdem[(k + 1) % R] = 0.0
    if edges:                  # NaN, -inf and exact multiples of a demand
        flat = free.view(-1)
        flat[::7] = float("nan")
        flat[3::11] = -float("inf")
        free[..., R - 1] = 3.0 * wdem[R - 1]
    return price, free, wdem, sdem


def _sweep_inputs(gen, k, Q1, inf_frac=0.2):
    tc = torch.rand((k, Q1), generator=gen, dtype=torch.float64) * 100
    tc[torch.rand((k, Q1), generator=gen) < inf_frac] = float("inf")
    tc[:, 0] = 0.0
    return tc


def _near_tie_inputs(gen, k, Q1, mag):
    """tcost on a 0.1 * mag grid plus absolute offsets of 0.5e-12 to
    3e-12: rows whose candidates tie exactly, to an ulp, or within a few
    1e-12 on both sides of the hysteresis, so the kernel's replay of the
    scalar scan runs."""
    tc = torch.round(torch.rand((k, Q1), generator=gen,
                                dtype=torch.float64) * 50) / 10 * mag
    offs = torch.tensor([0.0, 5e-13, -5e-13, 1e-12, -1e-12, 1.5e-12, 2e-12,
                         -2e-12, 3e-12], dtype=torch.float64)
    tc += offs[torch.randint(0, len(offs), (k, Q1), generator=gen)]
    tc[torch.rand((k, Q1), generator=gen) < 0.1] = float("inf")
    tc[:, 0] = 0.0
    return tc


def check_kernels(pricing, minplus) -> dict:
    """Each kernel against its plain version on the card; returns the
    max abs error per kernel (0.0: bit-identical)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    err = {"price_bundle": 0.0, "minplus_sweep": 0.0}
    gamma = 8.789275684645638           # coef's product rounds
    cases = [
        _bundle_inputs(gen, 20, 100, 4),
        _bundle_inputs(gen, 1, 100, 4),
        _bundle_inputs(gen, 37, 1000, 7, zero_cols=(1, 4)),
    ]
    # the kernel's widths, zero-demand columns, NaN / -inf / negative free
    for R in (1, 4, 7, 8):
        cases.append(_bundle_inputs(gen, 20, 100, R,
                                    zero_cols=(0,) if R > 1 else (),
                                    edges=True))
    # exact capacity: free=9, demand=3 gives head-room 3, not 2 or 4
    cases.append((torch.ones((2, 3, 1), dtype=torch.float64),
                  torch.full((2, 3, 1), 9.0, dtype=torch.float64),
                  np.array([3.0]), np.array([3.0])))
    # no positive demand: head-room +inf
    cases.append((torch.ones((2, 3, 4), dtype=torch.float64),
                  torch.ones((2, 3, 4), dtype=torch.float64),
                  np.zeros(4), np.zeros(4)))
    for i, (price, free, wdem, sdem) in enumerate(cases):
        price, free = price.to(dev), free.to(dev)
        got = pricing.price_bundle_batch_cuda(price, free, wdem, sdem, gamma)
        want = pricing.price_bundle_batch_torch(price, free, wdem, sdem,
                                                gamma)
        torch.cuda.synchronize()
        err["price_bundle"] = max(err["price_bundle"], _equal(
            got, want, f"price_bundle case {i} {tuple(price.shape)}"))
    # operands one double off a 16-byte boundary: element loads
    price, free, wdem, sdem = _bundle_inputs(gen, 20, 100, 4, edges=True)
    price, free = (torch.cat([torch.zeros(1, dtype=torch.float64),
                              a.reshape(-1)]).to(dev)[1:].view(a.shape)
                   for a in (price, free))
    aligned = (price.data_ptr() | free.data_ptr()) % 16 == 0
    if aligned or pricing.bundle_vec(4, aligned) != 1:
        raise AssertionError("offset operands took double2 loads")
    err["price_bundle"] = max(err["price_bundle"], _equal(
        pricing.price_bundle_batch_cuda(price, free, wdem, sdem, gamma),
        pricing.price_bundle_batch_torch(price, free, wdem, sdem, gamma),
        "price_bundle element loads"))
    edge = pricing.price_bundle_batch_cuda(
        cases[-2][0].to(dev), cases[-2][1].to(dev), cases[-2][2],
        cases[-2][3], 1.0)
    if not (edge[3] == 3.0).all():
        raise AssertionError("exact-capacity head-room is not 3")
    # the backend's host-level call against the CPU's
    price, free, wdem, sdem = cases[0]
    for g, w in zip(pricing.price_bundle_batch(price.to(dev), free.to(dev),
                                               wdem, sdem, gamma),
                    pricing.price_bundle_batch(price, free, wdem, sdem,
                                               gamma)):
        np.testing.assert_array_equal(g, w, err_msg="price_bundle host call")

    # every width and depth (k*Q1 past shared memory streams through the
    # ring), near-ties at three magnitudes, unreachable rows
    sweeps = [_sweep_inputs(gen, k, Q1)
              for Q1 in (1, 2, 21, 32, 33, 49, 100, 129, 1024)
              for k in (1, 3, 20, 200)]
    sweeps.append(_sweep_inputs(gen, 5, 49, inf_frac=0.0))
    sweeps += [_near_tie_inputs(gen, k, Q1, mag) for mag in (1.0, 1e3, 1e6)
               for k, Q1 in ((20, 21), (20, 33), (200, 49), (20, 100),
                             (3, 1024))]
    tie = torch.tensor([[0.0, 0.30000000000000004, 0.6],
                        [0.0, 0.3, 0.6000000000000001]], dtype=torch.float64)
    sweeps.append(tie)
    unreach = torch.full((4, 21), float("inf"), dtype=torch.float64)
    unreach[:, 0] = 0.0
    sweeps.append(unreach)
    sweeps.append(torch.full((3, 2), float("inf"), dtype=torch.float64))
    sweeps.append(torch.full((200, 1024), float("inf"), dtype=torch.float64))
    ring = 0
    for i, tc in enumerate(sweeps):
        ring += minplus.sweep_layout(*tc.shape).ring
        tc = tc.to(dev)
        gc, gch = minplus.minplus_sweep_cuda(tc)
        wc, wch = minplus.minplus_sweep_torch(tc)
        torch.cuda.synchronize()
        err["minplus_sweep"] = max(err["minplus_sweep"], _equal(
            gc, wc, f"minplus_sweep values case {i} {tuple(tc.shape)}"))
        _equal(gch, wch, f"minplus_sweep choice case {i}")
    if ring < 3:
        raise AssertionError("too few sweeps streamed tcost through the ring")
    # the DP's host-level call against the CPU's
    tc = _near_tie_inputs(gen, 20, 21, 1.0).numpy()
    for g, w in zip(minplus.minplus_sweep_host(tc, dev),
                    minplus.minplus_sweep_host(tc, "cpu")):
        np.testing.assert_array_equal(g, w, err_msg="minplus_sweep host call")
    return err


# ------------------------------------------------------------ main path
def decision_trace(records) -> list:
    """(job id, admitted, slot -> (workers, PSs)) of each record."""
    out = []
    for r in records:
        slots = None
        if r.schedule is not None:
            slots = {t: (sorted(a.workers.items()), sorted(a.ps.items()))
                     for t, a in r.schedule.slots.items()}
        out.append((r.job.job_id, r.admitted, slots))
    return out


def run_main_path(rt, trace, device: str):
    p = PAPER_POINT
    jobs = rt.synthetic_jobs(rt.WorkloadConfig(
        num_jobs=p["jobs"], horizon=p["horizon"], seed=p["seed"],
        batch=p["batch"], workload_scale=p["workload_scale"]))
    cluster = rt.make_cluster(p["machines"], p["horizon"], preset=p["preset"],
                              device=device)
    tracer = trace.Tracer()
    with trace.activate(tracer):
        t0 = time.perf_counter()
        res = rt.run_pdors(jobs, cluster, quanta=p["quanta"], seed=p["seed"])
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return jobs, res, wall, tracer


def device_busy_share(rt, trace) -> dict:
    """``profile_busy`` of one main-path run in a held session."""
    prof = start_session()
    _, _, wall, _ = run_main_path(rt, trace, "cuda")
    return profile_busy(stop_session(prof), wall)


# ----------------------------------------------------------- online sim
def _alloc(a) -> tuple:
    return (tuple(sorted(a.workers.items())), tuple(sorted(a.ps.items())))


def record_decisions(policy) -> list:
    """Log every decision ``policy`` returns to the engine: each ARRIVAL
    batch's admissions and committed schedules, each SLOT tick's grants."""
    log = []
    inner = policy.offer

    def offer(event, view):
        dec = inner(event, view)
        if event.kind.name in ("ARRIVAL", "SLOT"):
            log.append((
                event.time, event.kind.name,
                tuple(sorted(dec.admitted.items())),
                tuple((j, tuple((t, _alloc(a)) for t, a in sorted(s.items())))
                      for j, s in sorted(dec.schedules.items())),
                tuple((j, _alloc(a)) for j, a in sorted(dec.grants.items())),
            ))
        return dec

    policy.offer = offer
    return log


def outcome_rows(engine) -> list:
    return [tuple(sorted(dataclasses.asdict(oc).items()))
            for _, oc in sorted(engine.metrics.outcomes.items())]


def run_sim(launch_sim, name: str, device: str, tracer=None,
            point=SIM_POINT, **tier) -> dict:
    """One replay of ``point`` (default: the sim point) through
    ``launch.sim``'s engine, with the decision log and each job's outcome
    row kept; ``tier`` passes ``faults``, ``elastic`` or ``engine_mode``
    on to ``make_engine``."""
    engine, events = launch_sim.make_engine(name, device=device,
                                            tracer=tracer, **point, **tier)
    log = record_decisions(engine.policy)
    report, wall = launch_sim.run_engine(engine, events)
    return {"report": report, "engine": engine, "wall": wall,
            "log": log, "rows": outcome_rows(engine)}


def same_sim_run(a: dict, b: dict, what: str) -> None:
    """Identical decision logs, outcome rows and summaries; utility within
    rel 1e-9."""
    if a["log"] != b["log"]:
        i = next(i for i, (x, y) in enumerate(zip(a["log"], b["log"]))
                 if x != y) if len(a["log"]) == len(b["log"]) else None
        raise AssertionError(f"{what}: decision logs differ (first at "
                             f"{i}: {a['log'][i] if i is not None else ''}"
                             f" vs {b['log'][i] if i is not None else ''})")
    if a["rows"] != b["rows"]:
        raise AssertionError(f"{what}: per-job outcome rows differ")
    sa, sb = a["report"].summary, b["report"].summary
    ua, ub = sa["total_utility"], sb["total_utility"]
    if {k: v for k, v in sa.items() if k != "total_utility"} != \
            {k: v for k, v in sb.items() if k != "total_utility"} \
            or a["report"].slots_run != b["report"].slots_run:
        raise AssertionError(f"{what}: summaries differ")
    if not (np.isfinite(ua) and abs(ua - ub) <= 1e-9 * abs(ub)):
        raise AssertionError(f"{what}: utility {ua} != {ub}")


def sim_line(name: str, device: str, r: dict) -> str:
    s = r["report"].summary
    return (f"  {name} on {device}: wall {r['wall']:.4f} s = "
            f"{SIM_POINT['jobs'] / r['wall']:.2f} jobs/s, slots run "
            f"{r['report'].slots_run}, admitted {s['jobs_admitted']}, "
            f"completed {s['jobs_completed']}/{s['jobs_offered']}, "
            f"preemptions {s['preemptions']}, utility "
            f"{s['total_utility']!r}, JCT p50 {s['jct_p50']} p95 "
            f"{s['jct_p95']}")


def _launches(pricing, minplus) -> dict:
    return {"price_bundle": pricing.LAUNCHES,
            "minplus_sweep": minplus.LAUNCHES}


def _require_launches(launches: dict, what: str) -> None:
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} kernel never launched in {what}")


def _require_cuda_spans(tracer, what: str) -> dict:
    spans = {"plan.bundle": 0, "dp.sweep": 0}
    for sp in tracer.spans:
        if sp.name in spans:
            spans[sp.name] += 1
            if sp.attrs.get("backend") != "cuda":
                raise AssertionError(f"{what}: {sp.name} ran on {sp.attrs}")
    if not all(spans.values()):
        raise AssertionError(f"{what}: no offer spans {spans}")
    return spans


def online_sim(rt, launch_sim, trace, pricing, minplus) -> dict:
    """The online simulator on the card against the CPU: PD-ORS, the three
    slot-driven baselines, and OASiS at the Fig. 6 point."""
    t_phase = time.perf_counter()
    warm = run_sim(launch_sim, "pdors", "cuda")
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    tracer = trace.Tracer()
    gpu = run_sim(launch_sim, "pdors", "cuda", tracer)
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the online sim")
    spans = _require_cuda_spans(tracer, "online sim")
    cpu = run_sim(launch_sim, "pdors", "cpu")
    same_sim_run(gpu, cpu, "pdors cuda vs cpu")
    same_sim_run(warm, gpu, "pdors warm-up vs counted run")
    rows = [sim_line("pdors", "cuda", gpu), sim_line("pdors", "cpu", cpu)]
    table = tracer.phase_table()
    top = sorted(table.items(), key=lambda kv: -kv[1]["self_s"])[:10]
    adm = gpu["engine"].admission_latency()

    base = {}
    for name in SIM_BASELINES:
        g = run_sim(launch_sim, name, "cuda")
        c = run_sim(launch_sim, name, "cpu")
        same_sim_run(g, c, f"{name} cuda vs cpu")
        rows += [sim_line(name, "cuda", g), sim_line(name, "cpu", c)]
        base[name] = {"wall": g["wall"], "cpu_wall": c["wall"],
                      "jobs_per_s": SIM_POINT["jobs"] / g["wall"]}

    prof = start_session()
    prof_run = run_sim(launch_sim, "pdors", "cuda")
    busy = profile_busy(stop_session(prof), prof_run["wall"])

    # OASiS at the Fig. 6 point: the bundle kernel at R = 6
    p = PAPER_POINT
    jobs = rt.synthetic_jobs(rt.WorkloadConfig(
        num_jobs=p["jobs"], horizon=p["horizon"], seed=p["seed"],
        batch=p["batch"], workload_scale=p["workload_scale"]))
    oasis = {}
    for device in ("cuda", "cpu"):
        pricing.LAUNCHES = 0
        t0 = time.perf_counter()
        res = rt.core.run_oasis(jobs, rt.make_cluster(
            p["machines"], p["horizon"], preset=p["preset"], device=device),
            quanta=p["quanta"], seed=p["seed"])
        oasis[device] = (res, time.perf_counter() - t0, pricing.LAUNCHES)
    if oasis["cuda"][2] <= 0:
        raise AssertionError("OASiS never launched the bundle kernel")
    if decision_trace(oasis["cuda"][0].records) != \
            decision_trace(oasis["cpu"][0].records):
        raise AssertionError("OASiS: cuda and cpu made different decisions")
    uo, uc = oasis["cuda"][0].total_utility, oasis["cpu"][0].total_utility
    if not (np.isfinite(uo) and abs(uo - uc) <= 1e-9 * abs(uc)):
        raise AssertionError(f"OASiS utility {uo} != {uc}")
    return {"gpu": gpu, "warm_wall": warm["wall"], "launches": launches,
            "spans": spans, "rows": rows, "top": top, "admission": adm,
            "baselines": base, "busy": busy,
            "oasis": oasis, "wall": time.perf_counter() - t_phase}


# ----------------------------------- chaos, recovery, elastic, service
def _ledger_on_card(cl, what: str, read: bool) -> None:
    """The cluster's ledger is a CUDA tensor, and every version-keyed
    cache that claims the current version agrees with a fresh read of it;
    ``read`` also reads every slot through the caches."""
    if cl._used.device.type != "cuda":
        raise AssertionError(f"{what}: ledger on {cl._used.device}")
    used = cl.backend.to_host(cl._used)
    free = cl.capacity_matrix[None] - used
    for name, want in (("_used_host", used), ("_free_host", free)):
        ent = getattr(cl, name)
        if ent is not None and ent[0] == cl.version and \
                not np.array_equal(ent[1], want):
            raise AssertionError(f"{what}: stale {name}")
    if read:
        for t in range(cl.horizon):
            if not (np.array_equal(cl.used_matrix(t), used[t]) and
                    np.array_equal(cl.free_matrix(t), free[t])):
                raise AssertionError(f"{what}: cached slot {t} is stale")


def chaos_sim(launch_sim, trace, pricing, minplus) -> dict:
    """The sim point with bench_sim's chaos leg (crashes and stragglers
    over rack pairs, injected LP faults, pdors resilient-wrapped) on the
    card and on the CPU: identical decision logs, outcomes, summaries and
    policy health; both kernels launched, every offer span on cuda; the
    capacity-mask overcommit checks (each a whole-ledger copy to the
    host) counted."""
    from repro_torch.core.cluster import Cluster
    t_phase = time.perf_counter()
    checks = [0]
    overcommitted = Cluster.machine_overcommitted

    def counted(self, h, tol=1e-6):
        checks[0] += 1
        return overcommitted(self, h, tol)

    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    tracer = trace.Tracer()
    Cluster.machine_overcommitted = counted
    try:
        gpu = run_sim(launch_sim, "pdors", "cuda", tracer, faults=True)
    finally:
        Cluster.machine_overcommitted = overcommitted
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the chaos run")
    spans = _require_cuda_spans(tracer, "chaos")
    cpu = run_sim(launch_sim, "pdors", "cpu", faults=True)
    same_sim_run(gpu, cpu, "chaos pdors cuda vs cpu")
    return {"gpu": gpu, "cpu_wall": cpu["wall"], "launches": launches,
            "spans": spans, "overcommit_checks": checks[0],
            "admission": gpu["engine"].admission_latency(),
            "wall": time.perf_counter() - t_phase}


def recover_sim(launch_sim, pricing, minplus, want: dict) -> dict:
    """The chaos run on the card, checkpointed every 16 slots and killed
    at slot 64, then recovered from the regenerated stream: the snapshot
    and the restored ledger are on the card with fresh caches, and the
    recovered summary, slot count and outcome rows equal the
    uninterrupted cuda run's (``want``)."""
    from repro_torch.sim import SimKilled
    engine, events = launch_sim.make_engine("pdors", device="cuda",
                                            faults=True, **SIM_POINT,
                                            **RECOVER)
    taken = [0]
    take = engine._take_checkpoint

    def counted(t):
        taken[0] += 1
        take(t)

    engine._take_checkpoint = counted
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        engine.run(events)
    except SimKilled:
        pass
    else:
        raise AssertionError("the recover run was not killed")
    killed_wall = time.perf_counter() - t0
    snap = engine._checkpoint
    _ledger_on_card(snap.state[0].cluster, "checkpoint", read=False)
    t0 = time.perf_counter()
    report = engine.recover(launch_sim.make_events(faults=True, **SIM_POINT))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the recover run")
    _ledger_on_card(engine.window.cluster, "recovered ledger", read=True)
    if report.summary != want["report"].summary or \
            report.slots_run != want["report"].slots_run:
        raise AssertionError("recovered summary != uninterrupted summary")
    if outcome_rows(engine) != want["rows"]:
        raise AssertionError("recovered outcome rows differ")
    if not torch.equal(engine.window.cluster._used,
                       want["engine"].window.cluster._used):
        raise AssertionError("recovered ledger differs")
    return {"checkpoints": taken[0], "slot": snap.slot,
            "consumed": snap.consumed, "killed_wall": killed_wall,
            "wall": wall, "launches": launches}


def elastic_sim(launch_sim, trace, pricing, minplus) -> dict:
    """bench_sim's elastic tier, pdors: the reshape storm through the
    batched engine on the card (counted), the per-event oracle on the card
    (bit-identical: summary, slots, ledger, journal, outcomes) and the
    batched engine on the CPU (identical decision logs)."""
    t_phase = time.perf_counter()
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    tracer = trace.Tracer()
    gb = run_sim(launch_sim, "pdors", "cuda", tracer, point=ELASTIC_POINT,
                 elastic=True, engine_mode="batched")
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the elastic run")
    spans = _require_cuda_spans(tracer, "elastic")
    ge = run_sim(launch_sim, "pdors", "cuda", point=ELASTIC_POINT,
                 elastic=True, engine_mode="event")
    eb, ee = gb["engine"], ge["engine"]
    if gb["report"].summary != ge["report"].summary or \
            gb["report"].slots_run != ge["report"].slots_run or \
            not torch.equal(eb.window.cluster._used,
                            ee.window.cluster._used) or \
            eb.journal != ee.journal or \
            eb.metrics.outcomes != ee.metrics.outcomes:
        raise AssertionError("elastic: batched and event engines differ")
    cb = run_sim(launch_sim, "pdors", "cpu", point=ELASTIC_POINT,
                 elastic=True, engine_mode="batched")
    same_sim_run(gb, cb, "elastic pdors cuda vs cpu")
    return {"gpu": gb, "event_wall": ge["wall"], "cpu_wall": cb["wall"],
            "launches": launches, "spans": spans,
            "wall": time.perf_counter() - t_phase}


def service_sim(launch_sim, pricing, minplus) -> dict:
    """bench_sim's service row on the card: jobs submitted 64 at a time
    through the asyncio ``OfferService``; each batch it formed (how they
    form depends on timing) is offered again through ``PDORS.offer_batch``
    on the CPU, requiring the same admissions and schedules."""
    sched, jobs = launch_sim.make_service_point(device="cuda",
                                                **SERVICE_POINT)
    batches = []
    offer_batch = sched.offer_batch

    def recorded(batch):
        batches.append([j.job_id for j in batch])
        return offer_batch(batch)

    sched.offer_batch = recorded
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    run = launch_sim.drive_service(sched, jobs, SERVICE_POINT["machines"])
    launches = _launches(pricing, minplus)
    _require_launches(launches, "the service run")
    if len(batches) != run["batches"] or \
            sorted(i for b in batches for i in b) != \
            sorted(j.job_id for j in jobs):
        raise AssertionError("service: batches do not cover the jobs")
    cpu, cpu_jobs = launch_sim.make_service_point(device="cpu",
                                                  **SERVICE_POINT)
    by_id = {j.job_id: j for j in cpu_jobs}
    t0 = time.perf_counter()
    want = [r for b in batches
            for r in cpu.offer_batch([by_id[i] for i in b])]
    cpu_wall = time.perf_counter() - t0
    got = sorted(decision_trace(run["records"]), key=lambda d: d[0])
    if got != sorted(decision_trace(want), key=lambda d: d[0]):
        raise AssertionError("service: cuda and cpu admissions differ")
    admitted = sum(1 for r in run["records"] if r.admitted)
    if run["grants"] != admitted:
        raise AssertionError(f"service: {run['grants']} grants polled for "
                             f"{admitted} admissions")
    return {"jobs": len(jobs), "admitted": admitted,
            "batches": run["batches"],
            "sizes": sorted({len(b) for b in batches}),
            "wall": run["wall"], "cpu_wall": cpu_wall,
            "latency": run["latency"], "launches": launches}


def chaos_profiled(launch_sim, trace) -> dict:
    """One cuda chaos run in a held session and under a tracer: its
    ``profile_busy`` and the top spans by self time."""
    tracer = trace.Tracer()
    prof = start_session()
    r = run_sim(launch_sim, "pdors", "cuda", tracer, faults=True)
    busy = profile_busy(stop_session(prof), r["wall"])
    top = sorted(tracer.phase_table().items(),
                 key=lambda kv: -kv[1]["self_s"])[:10]
    return {"wall": r["wall"], "busy": busy, "top": top}


# ---------------------------------------------------------------- times
def _host_ms(fn, reps: int = 500, warmup: int = 20) -> float:
    """Mean time per call on the host's clock, for a call that ends in a
    sync of its own (the host-level calls the offer path makes)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def bundle_numbers(pricing, price, free, wdem, sdem, gamma) -> dict:
    W, H, R = price.shape
    nnz_w = int(np.count_nonzero(wdem))
    nnz_s = int(np.count_nonzero(sdem))
    pos = int((wdem > 0).sum() + (sdem > 0).sum())
    ops = W * H * (2 * nnz_w + 2 * nnz_s + 2 * R + 2 * pos)
    nbytes = 8 * (2 * W * H * R + 3 * R + 5 * W * H)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    coef = torch.from_numpy(np.stack([wdem, sdem, wdem * gamma + sdem],
                                     axis=1)).to(price.device)   # (R, 3)
    flat = price.reshape(W * H, R)
    return {
        "ms": _time_ms(lambda: pricing.price_bundle_batch_cuda(
            price, free, wdem, sdem, gamma)),
        "device_ms": _device_ms(lambda: pricing.price_bundle_batch_cuda(
            price, free, wdem, sdem, gamma), "price_bundle"),
        # what a plan pays: launch, copy back, sync (plan.bundle's call)
        "host_ms": _host_ms(lambda: pricing.price_bundle_batch(
            price, free, wdem, sdem, gamma)),
        "plain_ms": _time_ms(lambda: pricing.price_bundle_batch_torch(
            price, free, wdem, sdem, gamma), reps=50),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": _time_ms(lambda: torch.matmul(flat, coef)),
    }


def sweep_numbers(minplus, tcost) -> dict:
    k, Q1 = tcost.shape
    # finite (prev, tcost) pairs the scan adds and compares, this input
    C, _ = minplus.minplus_sweep_torch(tcost)
    fin_c = torch.isfinite(C[:-1]).cpu().numpy()
    fin_t = torch.isfinite(tcost).cpu().numpy()
    pairs = 0
    for s in range(k):
        for u in range(Q1):
            pairs += int(np.sum(fin_c[s, u::-1][:u + 1] & fin_t[s, :u + 1]))
    ops = 2 * pairs
    nbytes = 8 * (k * Q1 + 2 * (k + 1) * Q1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    host = tcost.cpu().numpy()
    return {
        "ms": _time_ms(lambda: minplus.minplus_sweep_cuda(tcost)),
        "device_ms": _device_ms(lambda: minplus.minplus_sweep_cuda(tcost),
                                "minplus_sweep"),
        # the DP's call: copy in, launch, copy back, sync (dp.sweep's)
        "host_ms": _host_ms(lambda: minplus.minplus_sweep_host(
            host, tcost.device)),
        "plain_ms": _time_ms(lambda: minplus.minplus_sweep_torch(tcost),
                             reps=10, warmup=2),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }


# ------------------------------------------------ serving path: kernels
def _max_err(got: torch.Tensor, want: torch.Tensor, what: str, **tol) -> float:
    """Hold ``got`` to ``want`` in float32 within ``tol``; returns the max
    abs difference."""
    g, w = got.float(), want.float()
    torch.testing.assert_close(g, w, msg=lambda m: f"{what}: {m}", **tol)
    return float((g - w).abs().max())


#: the bf16 flash kernel's edges (B, S_q, S_k, H, KV, D, causal, window):
#: S_q and S_k off every tile, S_k under one key tile, D 72, 80 and 40
#: (padded buckets, a box wider than the row), query groups of 5, 8 and
#: 12, window edges inside tiles, window 1, rows with no allowed key, the
#: 128 x 1600 cross-attention
TC_EDGES = (
    (1, 200, 333, 4, 4, 128, False, 0), (2, 300, 300, 4, 2, 64, True, 0),
    (1, 130, 70, 2, 2, 256, False, 0), (2, 100, 40, 4, 4, 128, True, 0),
    (1, 257, 257, 8, 8, 72, True, 0), (1, 200, 200, 4, 2, 80, False, 0),
    (1, 136, 136, 2, 2, 40, True, 0), (2, 256, 256, 5, 1, 64, True, 0),
    (1, 384, 384, 16, 2, 128, True, 0), (1, 256, 256, 24, 2, 256, True, 0),
    (1, 512, 512, 4, 4, 128, True, 100), (1, 520, 520, 4, 2, 256, True, 200),
    (1, 300, 300, 2, 2, 64, False, 77), (1, 256, 256, 4, 4, 128, True, 1),
    (1, 300, 100, 2, 2, 64, False, 8), (4, 128, 1600, 16, 16, 64, False, 0),
)


def check_model_kernels(rmsnorm, flash) -> dict:
    """rmsnorm and flash attention against their plain versions on the
    card, at the serving path's shapes and the edge cases; returns the
    max abs error per kernel."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    err = {"rmsnorm": 0.0, "flash_attention": 0.0,
           "flash_attention_f32": 0.0}
    for N, d in [(4096, 3072), (4, 3072), (4096, 4096), (4, 4096),
                 (1024 * 64, 128), (96, 512), (16, 12288), (5, 50), (300, 1),
                 # MiniCPM3, DeepSeek-V2 (MLA norms, block norms) and
                 # LLaVA's prefill rows, then their decode rows
                 (4096, 768), (4096, 256), (4096, 2560), (2048, 1536),
                 (2048, 512), (2048, 5120), (12032, 4096), (4, 768),
                 (4, 256), (4, 2560), (4, 1536), (4, 512), (4, 5120),
                 # Mamba-2 (d_model, the gated norm at d_inner), Hymba
                 # (1600, 3200), SeamlessM4T (encoder and decoder rows),
                 # then their decode rows
                 (4096, 1536), (8192, 1600), (8192, 3200), (6400, 1024),
                 (512, 1024), (4, 1600), (4, 3200), (4, 1024),
                 # the cluster phase: Qwen3-32B's and Gemma-7B's block rows
                 # and Qwen3's QK-norm over 16 x 64 tokens at full width;
                 # the reduced configs' widths (d_model 256, MLA ranks 64
                 # and 32, QK-norm at head width 32)
                 (1024, 5120), (1024, 3072), (8192, 128), (1024, 256),
                 (4096, 32), (1024, 64), (1024, 32), (512, 32),
                 # the dense GQA serving points: Qwen3-32B's block rows and
                 # QK-norm rows (prefill, decode), Command R+'s block rows
                 # and its training rows
                 (4096, 5120), (262144, 128), (32768, 128), (256, 128),
                 (32, 128), (4096, 12288), (4, 12288), (1024, 12288)]:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((N, d), generator=gen) * 3).to(dt).to(dev)
            scale = (torch.randn((d,), generator=gen) + 1).to(dev)
            tol = dict(rtol=8e-3, atol=1e-6) if dt == torch.bfloat16 \
                else dict(rtol=1e-5, atol=1e-5)
            err["rmsnorm"] = max(err["rmsnorm"], _max_err(
                rmsnorm.rmsnorm_cuda(x, scale),
                rmsnorm.rmsnorm_torch(x, scale),
                f"rmsnorm ({N}, {d}) {dt}", **tol))
    cases = [  # B, S_q, S_k, H, KV, D, causal, window, dtypes
        (4, 1024, 1024, 16, 16, 256, True, 0, ("bf16", "f32")),
        (4, 1024, 1024, 32, 8, 128, True, 0, ("bf16",)),    # Phi-3.5-MoE
        (4, 3008, 3008, 32, 8, 128, True, 0, ("bf16",)),    # LLaVA-NeXT
        # Hymba: sliding (window 1024) and global layers, 25:5 heads
        (4, 2048, 2048, 25, 5, 64, True, 1024, ("bf16", "f32")),
        (4, 2048, 2048, 25, 5, 64, True, 0, ("bf16",)),
        # SeamlessM4T: encoder, prefill cross-attention, decoder self
        (4, 1600, 1600, 16, 16, 64, False, 0, ("bf16", "f32")),
        (4, 128, 1600, 16, 16, 64, False, 0, ("bf16", "f32")),
        (4, 128, 128, 16, 16, 64, True, 0, ("bf16", "f32")),
        (2, 512, 512, 64, 8, 128, True, 0, ("bf16", "f32")),
        # Qwen3-32B's and Command R+'s prefill, then their float32 cuts'
        (4, 1024, 1024, 64, 8, 128, True, 0, ("bf16",)),
        (4, 1024, 1024, 96, 8, 128, True, 0, ("bf16",)),
        (2, 128, 128, 64, 8, 128, True, 0, ("f32",)),
        (2, 128, 128, 96, 8, 128, True, 0, ("bf16", "f32")),
        (1, 200, 200, 4, 2, 256, True, 0, ("bf16", "f32")),
        (2, 128, 256, 4, 4, 64, False, 0, ("bf16", "f32")),
        (1, 512, 512, 4, 4, 128, True, 32, ("bf16", "f32")),
        (1, 512, 512, 4, 4, 128, True, 128, ("bf16", "f32")),
        (1, 200, 200, 4, 2, 80, True, 0, ("bf16", "f32")),  # D % 16 != 0
        (1, 64, 64, 2, 2, 20, True, 0, ("bf16", "f32")),    # D % 8 != 0
        (1, 130, 130, 2, 1, 50, True, 0, ("bf16", "f32")),  # D % 4 != 0
    ]
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    for B, S_q, S_k, H, KV, D, causal, window, names in cases:
        for name in names:
            dt = dts[name]
            q, k, v = (torch.randn(shape, generator=gen).to(dt).to(dev)
                       for shape in ((B, S_q, H, D), (B, S_k, KV, D),
                                     (B, S_k, KV, D)))
            tol = dict(rtol=2e-2, atol=2e-2) if name == "bf16" \
                else dict(rtol=2e-5, atol=2e-5)
            which = "flash_attention" + ("_f32" if name == "f32" else "")
            err[which] = max(err[which], _max_err(
                flash.flash_attention_cuda(q, k, v, causal, window),
                flash.flash_attention_torch(q, k, v, causal, window),
                f"flash {(B, S_q, S_k, H, KV, D)} causal={causal} "
                f"window={window} {name}", **tol))
    # the bf16 kernel's edges in both of its instances (the pick by shape
    # moved by SM_COUNT): within bf16 2e-2 of the plain version, and bit
    # for bit the same on a second call
    saved = flash.SM_COUNT
    try:
        for sm_count, q_rows in ((1, 128), (1 << 30, 64)):
            flash.SM_COUNT = sm_count
            for B, S_q, S_k, H, KV, D, causal, window in TC_EDGES:
                if flash.tc_tiles(B, S_q, H, D).q_rows != q_rows:
                    raise AssertionError(f"{(B, S_q, H, D)} did not pick "
                                         f"the {q_rows}-row instance")
                q, k, v = (torch.randn(shape, generator=gen)
                           .to(torch.bfloat16).to(dev)
                           for shape in ((B, S_q, H, D), (B, S_k, KV, D),
                                         (B, S_k, KV, D)))
                what = (f"flash bf16 edge {(B, S_q, S_k, H, KV, D)} causal="
                        f"{causal} window={window} rows={q_rows}")
                got = flash.flash_attention_cuda(q, k, v, causal, window)
                err["flash_attention"] = max(err["flash_attention"], _max_err(
                    got, flash.flash_attention_torch(q, k, v, causal, window),
                    what, rtol=2e-2, atol=2e-2))
                _equal(got.float(), flash.flash_attention_cuda(
                    q, k, v, causal, window).float(), what + " repeated")
    finally:
        flash.SM_COUNT = saved
    # bf16 q, k, v 2 bytes off a 16-byte boundary: staged into aligned
    # buffers for the same kernel
    for D in (64, 128, 256):
        shape = (1, 192, 4, D)
        n = int(np.prod(shape))
        q, k, v = (torch.randn((n + 1,), generator=gen).to(torch.bfloat16)
                   .to(dev)[1:].view(shape) for _ in range(3))
        if flash.vector_loads(D, q, k, v):
            raise AssertionError("offset bf16 inputs passed as aligned")
        err["flash_attention"] = max(err["flash_attention"], _max_err(
            flash.flash_attention_cuda(q, k, v),
            flash.flash_attention_torch(q, k, v), f"flash bf16 unaligned {D}",
            rtol=2e-2, atol=2e-2))
    # float32 q, k, v 4 bytes off a 16-byte boundary: element-wise loader
    shape = (1, 160, 4, 256)
    n = int(np.prod(shape))
    q, k, v = (torch.randn((n + 1,), generator=gen).to(dev)[1:].view(shape)
               for _ in range(3))
    if flash.vector_loads(256, q, k, v):
        raise AssertionError("offset float32 inputs took 16-byte loads")
    err["flash_attention_f32"] = max(err["flash_attention_f32"], _max_err(
        flash.flash_attention_cuda(q, k, v),
        flash.flash_attention_torch(q, k, v), "flash f32 unaligned",
        rtol=2e-5, atol=2e-5))
    # window 1: every query attends to itself alone, so out == v
    q, k, v = (torch.randn((1, 128, 2, 64), generator=gen).to(dev) * 3
               for _ in range(3))
    err["flash_attention_f32"] = max(err["flash_attention_f32"], _max_err(
        flash.flash_attention_cuda(q, k, v, True, 1), v, "flash window=1",
        rtol=1e-5, atol=1e-5))
    torch.cuda.synchronize()
    return err


# ---------------------------------------------- serving path: main path
def _requests(Request, vocab: int, n: int, length: int, max_new: int,
              seed: int):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, vocab, length).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n)]


@dataclasses.dataclass
class FrontendRequest:
    request_id: int
    prompt: np.ndarray               # (S,) int32
    embeds: torch.Tensor             # (N, frontend_dim) float32, host
    max_new_tokens: int = 16


def _frontend_key(p: dict):
    """The batch key of the point's stub-frontend inputs ("image_embeds"
    for ``images``, "frames" for ``frames``) and their count; (None, 0)
    for a tokens-only point."""
    for field, key in (("images", "image_embeds"), ("frames", "frames")):
        if p.get(field):
            return key, p[field]
    return None, 0


def _frontend_requests(cfg, p: dict) -> list:
    """``p["requests"]`` requests of ``p["images"]`` random image
    embeddings or ``p["frames"]`` random frame embeddings (standing in
    for the stubbed frontend's output) and ``p["prompt_len"]`` random
    tokens, from ``p["seed"]``."""
    _, n = _frontend_key(p)
    gen = torch.Generator().manual_seed(p["seed"])
    rng = np.random.default_rng(p["seed"])
    return [FrontendRequest(
        i, rng.integers(0, cfg.vocab_size, p["prompt_len"]).astype(np.int32),
        torch.randn((n, cfg.frontend_dim), generator=gen),
        max_new_tokens=p["max_new"]) for i in range(p["requests"])]


def _frontend_server(key: str):
    """``ServeEngine`` whose batches carry each request's stub-frontend
    embeddings under ``key`` into ``Model.prefill`` (the engine takes
    tokens only, in both packages); greedy, with the engine's grouping,
    timing and copy of the params."""
    from repro_torch.serve import Completion, ServeEngine

    class FrontendServer(ServeEngine):
        def batch(self, requests: list) -> dict:
            return {"tokens": torch.from_numpy(np.stack(
                        [r.prompt for r in requests]).astype(np.int64)
                    ).to(self.device),
                    key: torch.stack(
                        [r.embeds for r in requests]).to(self.device)}

        def run_batch(self, requests: list) -> list:
            self._sync()
            t0 = time.perf_counter()
            logits, state = self.model.prefill(
                self.params, self.batch(requests), self.cache_len)
            self._sync()
            t1 = time.perf_counter()
            out = [self._sample(logits[:, -1], 0.0)[:, None]]
            for _ in range(max(r.max_new_tokens for r in requests) - 1):
                logits, state = self.model.decode(self.params, out[-1],
                                                  state)
                out.append(self._sample(logits[:, 0], 0.0)[:, None])
            tokens = torch.cat(out, dim=1)
            self._sync()
            t2 = time.perf_counter()
            toks = tokens.cpu().numpy().astype(np.int32)
            return [Completion(r.request_id, toks[i, :r.max_new_tokens],
                               prefill_ms=(t1 - t0) * 1e3,
                               decode_ms=(t2 - t1) * 1e3)
                    for i, r in enumerate(requests)]

    return FrontendServer


def _cache_len(p: dict) -> int:
    """The KV cache a point's requests fill: image tokens (not frames),
    the prompt, the new tokens, and 8 spare."""
    return p.get("images", 0) + p["prompt_len"] + p["max_new"] + 8


def point_config(p: dict):
    """The full-width config of ``p["arch"]``, cut to ``p["layers"]``
    layers where the point says (an enc-dec config's encoder too)."""
    from repro_torch.configs import get_config
    cfg = get_config(p["arch"])
    if "layers" in p:
        cfg = dataclasses.replace(cfg, num_layers=p["layers"])
        if cfg.encoder_layers:
            cfg = dataclasses.replace(cfg, encoder_layers=p["layers"])
    return cfg


def record_routing(params, cfg, record: list) -> list:
    """A forward pre-hook on each MoE layer of ``params`` that re-runs
    ``moe.route`` on the layer's input and appends (top-k indices, keep
    mask, router probabilities) to ``record`` as they lie on the device
    (the hook reads nothing back). Returns the hooks' handles."""
    from repro_torch.models import moe

    def hook(layer, args):
        r = moe.route(cfg, layer.router, moe.group_tokens(cfg.moe, args[0]))
        record.append((r.top_idx, r.keep, r.probs))

    return [b.moe.register_forward_pre_hook(hook) for b in params.layers]


def routing_gap(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Per token, the least gap between consecutive router probabilities
    among its k + 1 largest."""
    top = torch.sort(probs, dim=-1, descending=True).values[..., :k + 1]
    return (top[..., :-1] - top[..., 1:]).min(dim=-1).values


def drop_counts(record: list, cfg) -> dict:
    """The dropped (token, k) slots of each forward in ``record``, by
    token count: per forward summed over the layers, and per layer of the
    first such forward; with the group size and capacity."""
    from repro_torch.models import moe
    out: dict = {}
    L = cfg.num_layers
    for i in range(0, len(record), L):
        layers = record[i:i + L]
        G, g, K = layers[0][0].shape
        per_layer = [int(idx.numel() - keep.sum())
                     for idx, keep, _ in layers]
        row = out.setdefault(G * g, {"group": g, "capacity":
                                     moe.capacity(cfg.moe, g),
                                     "slots": G * g * K * L, "forwards": 0,
                                     "dropped": 0, "per_layer": per_layer})
        row["forwards"] += 1
        row["dropped"] += sum(per_layer)
    for row in out.values():
        row["dropped_per_forward"] = row["dropped"] / row["forwards"]
    return out


def layer_norms(cfg, cross_attention: bool = False) -> list:
    """The rmsnorm launches one block makes a forward, in the blocks'
    order, each as (width, heads, source): it norms ``heads`` rows of
    ``width`` for each position of ``source`` ("tokens": the block's own
    positions; "frames": the encoder's). ``attn_norm``, then the
    attention's own norms (GQA's qk-norm over each query and each kv head,
    MLA's q_norm and kv_norm at its ranks); the SSM's ``ssm_norm`` outside
    a hybrid, then its gated norm at d_inner; a hybrid's two output norms;
    ``cross_norm`` and the cross attention's qk-norm (its keys over the
    frames); ``ffn_norm`` with an MLP or experts."""
    d, hd = cfg.d_model, cfg.resolved_head_dim()

    def qk_norm(keys: str) -> list:
        return [(hd, cfg.num_heads, "tokens"),
                (hd, cfg.num_kv_heads, keys)] if cfg.qk_norm else []

    out = []
    if cfg.attention != "none":
        out.append((d, 1, "tokens"))
        out += [(cfg.mla.q_lora_rank, 1, "tokens"),
                (cfg.mla.kv_lora_rank, 1, "tokens")] \
            if cfg.attention == "mla" else qk_norm("tokens")
    if cfg.ssm is not None:
        if not cfg.hybrid:
            out.append((d, 1, "tokens"))
        out.append((cfg.ssm.d_inner(d), 1, "tokens"))
    if cfg.hybrid:
        out += [(d, 1, "tokens")] * 2
    if cross_attention:
        out += [(d, 1, "tokens")] + qk_norm("frames")
    if cfg.moe is not None or cfg.d_ff > 0:
        out.append((d, 1, "tokens"))
    return out


def norms_per_layer(cfg, cross_attention: bool = False) -> int:
    """rmsnorm launches one block makes a forward (``layer_norms``)."""
    return len(layer_norms(cfg, cross_attention))


def expected_launches(cfg, batches: int, forwards: int) -> dict:
    """Each kernel's launches over ``batches`` prefills and ``forwards``
    forwards in all (the prefills included): per forward the blocks'
    norms and the final norm; per prefill the enc-dec encoder's norms and
    ``enc_norm``, and a flash call for each GQA self-attention layer (the
    encoder's and the decoder's) and each cross-attention layer. A decode
    step makes no flash call, MLA and the SSM none at all."""
    L = cfg.num_layers
    if cfg.encoder_layers:
        E = cfg.encoder_layers
        return {"rmsnorm": batches * (E * norms_per_layer(cfg) + 1)
                + forwards * (L * norms_per_layer(cfg, True) + 1),
                "flash_attention": batches * (E + 2 * L)}
    return {"rmsnorm": forwards * (L * norms_per_layer(cfg) + 1),
            "flash_attention": batches * L if cfg.attention == "gqa"
            else 0}


def norm_plan(cfg, p: dict) -> list:
    """One batch's rmsnorm launches in order, each as (phase, rows,
    width): an enc-dec prefill norms the frames first (its encoder blocks
    and ``enc_norm``); the prefill runs every block over the prompt
    (image tokens first) and the final norm on its last position; each
    decode forward runs every block on one position and the final
    norm. ``layer_norms`` gives each block's norms."""
    B, d = p["max_batch"], cfg.d_model
    frames = p.get("frames", 0)
    cross = bool(cfg.encoder_layers)

    def forward(phase: str, layers: int, norms: list, tokens: int) -> list:
        return [(phase, B * heads * (tokens if src == "tokens" else frames),
                 width)
                for _ in range(layers) for width, heads, src in norms]

    plan = []
    if cross:
        plan += forward("encoder", cfg.encoder_layers, layer_norms(cfg),
                        frames) + [("encoder", B * frames, d)]
    norms = layer_norms(cfg, cross)
    plan += forward("prefill", cfg.num_layers, norms,
                    p.get("images", 0) + p["prompt_len"])
    plan.append(("prefill", B, d))
    for _ in range(p["max_new"] - 1):
        plan += forward("decode", cfg.num_layers, norms, 1)
        plan.append(("decode", B, d))
    return plan


def serving_engine(p: dict) -> tuple:
    """The point's model at full width (cut in depth where the point says)
    on the card, and its server: ``ServeEngine``, or for a stub-frontend
    point (image or frame embeddings) ``_frontend_server``. Returns (cfg,
    engine, requests, init s, set-up peak bytes: the params and the
    engine's compute copy)."""
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    torch.cuda.empty_cache()        # the last phase's model is gone
    cfg = point_config(p)
    key, _ = _frontend_key(p)
    cache_len = _cache_len(p)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_model(cfg).init(p["seed"], "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if key:
        engine = _frontend_server(key)(cfg, params, max_batch=p["max_batch"],
                                       cache_len=cache_len)
        reqs = _frontend_requests(cfg, p)
    else:
        engine = ServeEngine(cfg, params, max_batch=p["max_batch"],
                             cache_len=cache_len)
        reqs = _requests(Request, cfg.vocab_size, p["requests"],
                         p["prompt_len"], p["max_new"], p["seed"])
    torch.cuda.synchronize()
    return cfg, engine, reqs, init_s, torch.cuda.max_memory_allocated()


def warm_up(engine, cfg, p: dict, reqs: list) -> None:
    """The first cuBLAS use of each shape: one prefill of the first batch,
    whose last-position logits must be finite and of the right shape, and
    one 2-token batch."""
    key, _ = _frontend_key(p)
    first = reqs[:p["max_batch"]]
    if key:
        batch = engine.batch(first)
    else:
        batch = {"tokens": torch.from_numpy(
            np.stack([r.prompt for r in first])).long().cuda()}
    logits, _ = engine.model.prefill(engine.params, batch, _cache_len(p))
    want_shape = (len(first), 1, cfg.vocab_size)
    if tuple(logits.shape) != want_shape or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} are "
                             f"not finite {want_shape}")
    del logits, batch
    engine.run_batch([dataclasses.replace(r, max_new_tokens=2)
                      for r in first])


def profiled_serve(engine, cfg, p: dict, reqs: list, want: dict) -> tuple:
    """``engine.serve(reqs)`` once more in a held session
    (``start_session``): ((launch calls, kernels run), numbers), the
    numbers being device busy time by kernel, the idle share of the run's
    wall, the attention kernels it ran and rmsnorm's device time by phase
    and shape (``rmsnorm_by_shape``), or None when the session lost a
    launch of the serve (``profile_busy``): every sum over it would be
    short."""
    prof = start_session()
    t1 = time.perf_counter()
    engine.serve(reqs)
    torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t1
    b = profile_busy(stop_session(prof), prof_wall)
    if b["busy"] is None:
        return b["session"], None
    by_kernel = b["by_kernel"]
    batches = -(-p["requests"] // p["max_batch"])
    flash_calls: dict = {}
    for name, _, _ in _device_events(prof):
        if "flash_fwd_kernel" in name:
            flash_calls[name] = flash_calls.get(name, 0) + 1
    # every GQA prefill's attention ran on the tensor-core kernel (in
    # the instances its shapes pick); MLA and the SSM run none
    if want["flash_attention"] and (
            any("flash_fwd_kernel_tc" not in k for k in flash_calls) or
            sum(flash_calls.values()) != want["flash_attention"]) or \
            not want["flash_attention"] and flash_calls:
        raise AssertionError(f"profiled serving run's attention kernels "
                             f"{flash_calls}, want {want['flash_attention']}"
                             f" launches of flash_fwd_kernel_tc")
    return b["session"], dict(
        prof_wall=prof_wall, busy=b["busy"], idle=b["idle"], top=b["top"],
        flash_calls=flash_calls,
        rmsnorm_s=sum(t for k, t in by_kernel.items()
                      if "rmsnorm_kernel" in k),
        rmsnorm_split=rmsnorm_by_shape(prof, batches, norm_plan(cfg, p),
                                       want["rmsnorm"]),
        flash_s=sum(t for k, t in by_kernel.items()
                    if "flash_fwd_kernel" in k))




def serve_full_width(rmsnorm, flash, p: dict = SERVE_POINT) -> dict:
    """The point's model at full width (cut in depth where the point
    says) on the card, through its server (``serving_engine``). Raises
    unless every completion, the prefill logits and the launch counts are
    right. Returns the run's numbers; for MoE also the dropped slots of
    the warm-up's forwards. The device numbers come from a profiled serve
    that kept every launch (``profiled_serve``), else read None."""
    cfg, engine, reqs, init_s, setup_peak = serving_engine(p)

    # warm-up (first use of each cuBLAS shape), the prefill logits, and
    # for MoE the routing of the warm-up's forwards
    routing: list = []
    hooks = record_routing(engine.params, cfg, routing) if cfg.moe else []
    warm_up(engine, cfg, p, reqs)
    for h in hooks:
        h.remove()
    drops = drop_counts(routing, cfg) if cfg.moe else None
    del routing

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rmsnorm.LAUNCHES = 0
    flash.LAUNCHES = 0
    t0 = time.perf_counter()
    done = engine.serve(reqs)
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.LAUNCHES,
                "flash_attention": flash.LAUNCHES}
    serve_peak = torch.cuda.max_memory_allocated()

    batches = -(-p["requests"] // p["max_batch"])
    forwards = batches * p["max_new"]            # 1 prefill + decodes
    want = expected_launches(cfg, batches, forwards)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if sorted(c.request_id for c in done) != list(range(p["requests"])):
        raise AssertionError("not every request was answered")
    for c in done:
        if c.tokens.shape != (p["max_new"],) or c.tokens.min() < 0 or \
                c.tokens.max() >= cfg.vocab_size:
            raise AssertionError(f"request {c.request_id}: bad tokens "
                                 f"{c.tokens}")

    # the same run under the profiler: device busy time by kernel
    session, numbers = profiled_serve(engine, cfg, p, reqs, want)
    del engine
    torch.cuda.empty_cache()

    per_batch = sorted({(c.prefill_ms, c.decode_ms) for c in done})
    n_tok = sum(len(c.tokens) for c in done)
    out = dict(layers=cfg.num_layers, drops=drops, init_s=init_s,
               wall=wall, tokens=n_tok,
               tok_per_s=n_tok / wall, per_batch=per_batch,
               setup_peak_gb=setup_peak / 1e9, serve_peak_gb=serve_peak / 1e9,
               launches=launches, session=session,
               **(numbers or dict(prof_wall=None, busy=None, idle=None,
                                  top=[], flash_calls=None, rmsnorm_s=None,
                                  rmsnorm_split=None, flash_s=None)))
    if cfg.ssm is not None:
        out["ssd"] = ssd_share(cfg, p, batches, out["busy"])
    if cfg.sliding_window is not None:
        from repro_torch.models.blocks import layer_windows
        S = p.get("images", 0) + p["prompt_len"]
        out["windowed_layers"] = sum(
            w < S for w in layer_windows(cfg, cfg.num_layers))
    return out


#: the runtime and driver calls that launch a kernel, as the profiler
#: names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaLaunchCooperativeKernel")


def _kernel_counts(prof, pads: int = 0) -> tuple:
    """(launch calls, kernels run, device us) in a profiled session, its
    ``pads`` launches of ``PAD_KERNEL`` and their kernels aside: the
    host's calls in ``LAUNCH_CALLS`` (a driver call made inside a runtime
    call on its thread is that call's, and not counted again), the
    device's kernel events (copies, fills and CUPTI's "Command Buffer
    Full", the host waiting on a full launch queue, aside) and the time of
    every device event but that marker (a host op that launched a kernel
    also carries that kernel's time, so only the device's own events are
    summed)."""
    import bisect

    from torch.autograd import DeviceType
    calls, ran, us = [], 0, 0.0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CPU:
            if name in LAUNCH_CALLS:
                calls.append((name, ev.start_thread_id(), ev.start_ns(),
                              ev.end_ns()))
        elif ev.device_type() == DeviceType.CUDA and \
                name != "Command Buffer Full" and PAD_KERNEL not in name:
            us += ev.duration_ns() / 1e3
            if not name.startswith(("Memcpy", "Memset")):
                ran += 1
    # a thread's runtime calls do not overlap: the one that began last
    # before a driver call is the only one that can hold it
    runtime: dict = {}
    for name, thread, start, end in sorted(
            (c for c in calls if c[0].startswith("cuda")),
            key=lambda c: c[2]):
        runtime.setdefault(thread, []).append((start, end))
    starts = {t: [c[0] for c in spans] for t, spans in runtime.items()}

    def nested(thread: int, start: int, end: int) -> bool:
        i = bisect.bisect_right(starts.get(thread, []), start) - 1
        return i >= 0 and end <= runtime[thread][i][1]

    launched = sum(map(len, runtime.values())) + sum(
        1 for name, thread, start, end in calls
        if not name.startswith("cuda") and not nested(thread, start, end))
    return launched - pads, ran, us


def _busy_ms(fn, reps: int = 5) -> float:
    """Device time per call of everything ``fn`` launches: the device time
    of a held session (``start_session``) over ``reps`` calls (after one
    unprofiled call). The session must hold a kernel event for every
    launch call it saw; a session that lost one is run once more, and
    None is returned when that one loses a launch too, or the profiler
    records no device time."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        prof = start_session()
        for _ in range(reps):
            fn()
        launched, ran, us = _kernel_counts(stop_session(prof),
                                           PAD_HEAD + PAD_TAIL)
        if launched > 0 and ran == launched and us > 0:
            return us / reps / 1e3
    return None


def ssd_share(cfg, p: dict, batches: int, busy_s: float) -> dict:
    """The SSD's device time at the serving point's shapes: the chunked
    SSD of one layer's prefill (max_batch x prompt, float32, as
    ``SSM.forward`` hands it over) and one layer's recurrent decode step,
    each timed alone on random inputs; times their calls in the served
    run (a prefill and max_new - 1 steps a layer and batch) over the
    run's profiled device busy time."""
    from repro_torch.models import ssm
    s, d = cfg.ssm, cfg.d_model
    H, P, G, N = s.num_heads(d), s.head_dim, s.n_groups, s.state_dim
    B, S, L = p["max_batch"], p["prompt_len"], cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(*shape, lo=None, hi=None):
        if lo is None:
            return torch.randn(shape, generator=gen, device="cuda")
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device="cuda")

    x, dt = rand(B, S, H, P), rand(B, S, H, lo=0.01, hi=0.5)
    A = -rand(H, lo=0.1, hi=1.0)
    Bm, Cm = rand(B, S, G, N), rand(B, S, G, N)
    prefill_ms = _busy_ms(lambda: ssm.ssd_chunked(
        x, dt, A, Bm, Cm, chunk=min(256, S)))
    cache = {"state": rand(B, H, P, N)}
    step_ms = _busy_ms(lambda: ssm._recurrent_step(
        cache, x[:, :1], dt[:, :1], A, Bm[:, :1], Cm[:, :1]))
    del x, dt, Bm, Cm, cache
    if prefill_ms is None or step_ms is None or busy_s is None:
        return {"prefill_ms": prefill_ms, "step_ms": step_ms, "share": None}
    total_s = batches * L * (prefill_ms + (p["max_new"] - 1) * step_ms) / 1e3
    return {"prefill_ms": prefill_ms, "step_ms": step_ms,
            "device_s": total_s, "share": total_s / busy_s}


def rmsnorm_by_shape(prof, batches: int, plan: list, launches: int):
    """The profiled serving run's rmsnorm device time split by phase and
    launch shape. The server fixes the order of the launches, and the
    exact launch count holds it: each batch runs ``plan``'s (phase, rows,
    width) launches in order (``norm_plan``). The launches, in device
    order, are split so; None unless the profiler recorded all
    ``launches``."""
    evs = sorted((ev for ev in _device_events(prof)
                  if "rmsnorm_kernel" in ev[0]), key=lambda ev: ev[1])
    if len(evs) != launches or len(plan) * batches != launches:
        return None
    out: dict = {}
    for i, (_, _, ns) in enumerate(evs):
        phase, rows, width = plan[i % len(plan)]
        side = out.setdefault(f"{phase} ({rows}, {width})", [0, 0.0])
        side[0] += 1
        side[1] += ns / 1e9
    return {k: {"launches": n, "device_s": t, "us_per_launch": t / n * 1e6}
            for k, (n, t) in out.items()}


def parity_cuda_cpu(p: dict = PARITY_POINT) -> dict:
    """The full-width model cut to ``p["layers"]`` layers in float32
    (params and compute), served on the card and on the CPU from the
    same weights (a stub-frontend point with each request's image or
    frame embeddings): identical greedy tokens, last-position prefill logits
    within rtol=atol 1e-3; exact launch counts on the card (the float32
    routes: flash on the CUDA cores); for MoE, identical top-k indices
    and keep masks in every layer and forward at every token whose
    routing gap exceeds ``ROUTING_GAP``."""
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm
    from repro_torch.models import build_model
    from repro_torch.serve import Request, ServeEngine

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(point_config(p), compute_dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg)
    gpu = model.init(p["seed"], "cuda")
    cpu = type(gpu)(cfg, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    routing = {"cuda": [], "cpu": []}
    if cfg.moe:
        for name, params in (("cuda", gpu), ("cpu", cpu)):
            record_routing(params, cfg, routing[name])
    key, _ = _frontend_key(p)
    cache_len = _cache_len(p)
    if key:
        reqs = _frontend_requests(cfg, p)
        servers = {name: _frontend_server(key)(cfg, params,
                                               max_batch=p["requests"],
                                               cache_len=cache_len)
                   for name, params in (("cuda", gpu), ("cpu", cpu))}
        batches = {name: srv.batch(reqs) for name, srv in servers.items()}
    else:
        reqs = _requests(Request, cfg.vocab_size, p["requests"],
                         p["prompt_len"], p["max_new"], p["seed"])
        servers = {name: ServeEngine(cfg, params, max_batch=p["requests"],
                                     cache_len=cache_len)
                   for name, params in (("cuda", gpu), ("cpu", cpu))}
        tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).long()
        batches = {"cuda": {"tokens": tokens.cuda()},
                   "cpu": {"tokens": tokens}}
    rmsnorm.LAUNCHES = 0
    flash.LAUNCHES = 0
    lg, _ = model.prefill(gpu, batches["cuda"], cache_len)
    lc, _ = model.prefill(cpu, batches["cpu"], cache_len)
    err = _max_err(lg.cpu(), lc, "parity prefill logits", rtol=1e-3,
                   atol=1e-3)
    out = {}
    for name, server in servers.items():
        t0 = time.perf_counter()
        out[name] = server.serve(reqs)
        out[name + "_s"] = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.LAUNCHES,
                "flash_attention": flash.LAUNCHES}
    # the logits' prefill, then one served batch: a prefill and
    # max_new - 1 decode steps
    want = expected_launches(cfg, 2, 1 + p["max_new"])
    if launches != want:
        raise AssertionError(f"parity launch counts {launches} != {want}")
    for g, c in zip(out["cuda"], out["cpu"]):
        if not np.array_equal(g.tokens, c.tokens):
            raise AssertionError(f"request {g.request_id}: cuda tokens "
                                 f"{g.tokens} != cpu {c.tokens}")
    res = dict(logits_err=err, tokens=[c.tokens.tolist()
                                       for c in out["cuda"]],
               cuda_s=out["cuda_s"], cpu_s=out["cpu_s"], launches=launches)
    if cfg.moe:
        res["routing"] = same_routing(routing["cuda"], routing["cpu"], cfg)
    del gpu, cpu, servers, batches, routing, lg
    torch.cuda.empty_cache()
    return res


def same_routing(gpu: list, cpu: list, cfg) -> dict:
    """Raise unless each recorded layer-forward routed alike on both
    devices at every token whose gap (the least of both devices') exceeds
    ``ROUTING_GAP``; returns the smallest gap seen and the counts."""
    if len(gpu) != len(cpu) or not gpu:
        raise AssertionError(f"routing records {len(gpu)} vs {len(cpu)}")
    K = cfg.moe.top_k
    least, tokens, close = float("inf"), 0, 0
    for i, ((gi, gk, gp), (ci, ck, cp)) in enumerate(zip(gpu, cpu)):
        gap = torch.minimum(routing_gap(gp.cpu(), K), routing_gap(cp, K))
        stable = gap > ROUTING_GAP
        if not (torch.equal(gi.cpu()[stable], ci[stable]) and
                torch.equal(gk.cpu()[stable], ck[stable])):
            raise AssertionError(f"routing record {i}: cuda and cpu route "
                                 f"a token apart above the gap")
        least = min(least, float(gap.min()))
        tokens += gap.numel()
        close += int((~stable).sum())
    return dict(records=len(gpu), tokens=tokens, least_gap=least,
                at_or_below_gap=close)


# ----------------------------------------------- serving path: times
def rmsnorm_numbers(rmsnorm, x, scale) -> dict:
    """The forward kernel's times at x (N, d), each call on the next of
    enough copies of x and the scale to pass the L2 (``_copies``), beside
    the plain version's and ``F.rms_norm``'s on the same copies."""
    N, d = x.shape
    nbytes = 2 * N * d * x.element_size() + d * scale.element_size()
    ops = 4 * N * d                  # square, add; multiply twice
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    sets = _copies(nbytes, x, scale)
    kernel = _rotating(rmsnorm.rmsnorm_cuda, sets)
    out = {
        "shape": [N, d], "dtype": str(x.dtype).replace("torch.", ""),
        "ms": _time_ms(kernel),
        "device_ms": _device_ms(kernel, "rmsnorm_kernel"),
        "plain_ms": _time_ms(_rotating(rmsnorm.rmsnorm_torch, sets)),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": _time_ms(_rotating(
            lambda xi, wi: torch.nn.functional.rms_norm(xi, (d,), wi, 1e-6),
            [(xi, si.to(xi.dtype)) for xi, si in sets])),
    }
    del sets
    return out


def _sdpa_op(fn) -> str:
    """The fused op SDPA's dispatcher picked for one call of ``fn`` (flash,
    efficient, cuDNN or the math fallback): the ``aten::_scaled_dot_
    product_*`` op in a CPU-side profile of the call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    _drop_session_spans()
    ops = sorted({ev.key for ev in prof.key_averages()
                  if ev.key.startswith("aten::_scaled_dot_product_")})
    return ", ".join(ops) or "no aten::_scaled_dot_product_* op"


def flash_numbers(flash, q, k, v, causal: bool = True,
                  window: int = 0) -> dict:
    """The attention kernel's route for q's dtype at q (B, S_q, H, D)
    against k, v (B, S_k, KV, D) with the given masks: times, bound, the
    achieved TFLOP/s and share of the bound on the kernel's device time,
    and ``F.scaled_dot_product_attention`` on the same inputs (causal by
    ``is_causal``; a window as an explicit boolean ``attn_mask``), with
    the op SDPA's dispatcher took."""
    B, S, H, D = q.shape
    S_k, KV = k.shape[1], k.shape[2]
    ok = flash.allowed(S, S_k, causal, window, q.device)
    ops = 4 * B * H * D * int(ok.sum())
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size()  # q,k,v,o
    peak = BF16_OPS_PER_S if q.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    bound = max(t_bytes, t_ops)
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    sdpa = {"enable_gqa": True} if KV != H else {}
    if window:
        sdpa["attn_mask"] = ok
    else:
        sdpa["is_causal"] = causal

    def kernel():
        return flash.flash_attention_cuda(q, k, v, causal, window)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, **sdpa)

    device_ms = _device_ms(kernel, "flash_fwd_kernel", reps=10)
    return {
        "shape": [B, S, H, D], "kv_heads": KV, "keys": S_k,
        "causal": causal, "window": window,
        "dtype": str(q.dtype).replace("torch.", ""),
        "ms": _time_ms(kernel, reps=20, warmup=3),
        "device_ms": device_ms,
        "plain_ms": _time_ms(lambda: flash.flash_attention_torch(
            q, k, v, causal, window), reps=10, warmup=2),
        "bound_ms": bound,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "tflops": ops / device_ms / 1e9 if device_ms else None,
        "bound_share": bound / device_ms if device_ms else None,
        "library_ms": _time_ms(library, reps=20, warmup=3),
        "library_op": _sdpa_op(library),
    }


def print_serving(label: str, p: dict, sv: dict) -> None:
    key, n_embeds = _frontend_key(p)
    what = {"image_embeds": "image embeddings", "frames": "frames"}
    steps = p["max_new"] - 1
    print(f"{label} ({p['arch']}, {sv['layers']} layers, {p['requests']} "
          f"requests x " + (f"{n_embeds} {what[key]} + " if key else "")
          + f"{p['prompt_len']} prompt + {p['max_new']} new, "
          f"max_batch {p['max_batch']}, greedy): wall {sv['wall']:.4f} s, "
          f"{sv['tokens']} tokens, {sv['tok_per_s']:.2f} tok/s; per batch "
          f"(prefill ms, decode ms for {steps} steps, decode ms a step) "
          f"{[(round(a, 3), round(b, 3), round(b / steps, 3)) for a, b in sv['per_batch']]}; "
          f"launches {sv['launches']}; init {sv['init_s']:.2f} s; peak "
          f"memory {sv['setup_peak_gb']:.2f} GB at set-up (params + "
          f"compute copy), {sv['serve_peak_gb']:.2f} GB while serving")
    launched, ran = sv["session"]
    if sv["busy"] is None:
        print(f"{label} device busy: not measured (the profiled serve "
              f"recorded {ran} kernels of {launched} launch calls)")
    else:
        print(f"{label} device busy {sv['busy']:.4f} s of a profiled "
              f"{sv['prof_wall']:.4f} s run ({launched} launches, all "
              f"recorded): idle share {sv['idle']:.4f}; rmsnorm "
              f"{sv['rmsnorm_s']:.4f} s, flash {sv['flash_s']:.4f} s (calls "
              f"{sv['flash_calls']}); top kernels by device time: "
              + "; ".join(f"{name[:60]} {t:.4f} s" for name, t in sv["top"]))
    split = sv["rmsnorm_split"]
    print(f"{label} rmsnorm device time by phase and launch shape: " + (
        "; ".join(f"{k} {v['launches']} launches {v['device_s']:.6f} s = "
                  f"{v['us_per_launch']:.4f} us each"
                  for k, v in split.items())
        if split else "not measured (the profiler lost launches)"))
    if "ssd" in sv:
        ssd = sv["ssd"]
        print(f"{label} SSD alone at the point's shapes: chunked prefill "
              f"{ssd['prefill_ms']} ms a layer, recurrent step "
              f"{ssd['step_ms']} ms a layer (profiler device time); share "
              f"of the profiled run's device busy time {ssd['share']}")
    if "windowed_layers" in sv:
        print(f"{label} the sliding window cuts the prompt in "
              f"{sv['windowed_layers']} of {sv['layers']} layers")
    if sv["drops"]:
        print(f"{label} dropped (token, k) slots a forward (warm-up "
              "forwards, routed again from each layer's input): " + "; ".join(
                  f"{T} tokens (groups of {r['group']}, C = {r['capacity']})"
                  f": {r['dropped_per_forward']} of {r['slots']} over "
                  f"{sv['layers']} layers, by layer {r['per_layer']}"
                  for T, r in sorted(sv["drops"].items())))


def print_parity(label: str, p: dict, pa: dict) -> None:
    line = (f"{label} ({p['layers']}-layer full-width f32, cuda vs cpu): "
            f"identical greedy tokens {pa['tokens'][0]}..., prefill logits "
            f"max abs err {pa['logits_err']:.3e}; ")
    if "routing" in pa:
        ro = pa["routing"]
        line += (f"routing identical over {ro['records']} layer-forwards, "
                 f"{ro['tokens']} tokens, {ro['at_or_below_gap']} at or "
                 f"below the {ROUTING_GAP} gap, least gap "
                 f"{ro['least_gap']:.3e}; ")
    print(line + f"launches on the card (float32 routes) "
          f"{pa['launches']}; serve cuda {pa['cuda_s']:.4f} s, cpu "
          f"{pa['cpu_s']:.4f} s")


# ------------------------------------------------------ training path
def _bwd_err(rmsnorm, x, scale, dy, what: str) -> float:
    """Hold the backward kernel to ``rmsnorm_bwd_torch`` on the same
    inputs: float32 dx to 1e-5; bf16 dx to one bf16 ulp of its row's
    largest |dx| plus 16 float32 ulps of its row's largest |r g| (``g - x
    r^2 mean(g x)`` cancels: at d = 1, dx = r g eps / (x^2 + eps), far
    below its terms, so two float32 computations differ by a few ulps of
    the terms before the rounding); dscale to rtol 1e-5 (atol 1e-5 of its
    largest, for columns that sum to near zero). Returns the max abs
    error."""
    dx, ds = rmsnorm.rmsnorm_bwd_cuda(x, scale, dy)
    want_dx, want_ds = rmsnorm.rmsnorm_bwd_torch(x, scale, dy)
    if x.dtype == torch.bfloat16:
        r = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + 1e-6)
        terms = (r * dy.float() * scale.float()).abs().amax(-1, keepdim=True)
        big = want_dx.float().abs().amax(-1, keepdim=True)
        tol = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30))) - 7) \
            + 16 * torch.exp2(torch.floor(torch.log2(
                terms.clamp_min(1e-30))) - 23)
        gap = (dx.float() - want_dx.float()).abs()
        if not bool((gap <= tol).all()):
            raise AssertionError(f"{what}: dx beyond its tolerance, max gap "
                                 f"{float(gap.max())}")
        err = float(gap.max())
    else:
        err = _max_err(dx, want_dx, f"{what} dx", rtol=1e-5, atol=1e-5)
    return max(err, _max_err(ds, want_ds, f"{what} dscale", rtol=1e-5,
                             atol=1e-5 * float(want_ds.abs().max())))


#: shapes at which two launches of the backward must agree bit for bit:
#: Gemma-7B's training rows and Qwen3-32B's QK-norm rows
BWD_TWICE = ((8192, 3072), (65536, 128), (8192, 128))


def check_rmsnorm_bwd(rmsnorm) -> float:
    """The backward kernel against its plain version on the card at the
    training shape (8192, 3072), its decode rows, d = 1, an odd d, the
    widest row, MoE and narrow rows, the partition's edges (no row, one
    row, fewer rows than a block's lanes, a part-full last block), both
    dtypes, and with x and dy off a 16-byte boundary; two launches bit
    for bit at ``BWD_TWICE``. Returns the max abs error."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(3)
    err = 0.0
    for N, d in [(8192, 3072), (4, 3072), (300, 1), (33, 77), (16, 16384),
                 (1, 3072), (513, 256), (65536, 128), (4096, 4096),
                 # the cluster phase's full-width and reduced rows
                 (8192, 128), (1024, 5120), (1024, 3072), (1024, 256),
                 (4096, 32), (1024, 64), (1024, 32),
                 # Command R+'s d_model; the partition's edges
                 (1024, 12288), (1, 128), (5, 128), (8191, 128),
                 (65535, 128), (8191, 3072), (0, 128), (0, 3072)]:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((N, d), generator=gen) * 3).to(dt).to(dev)
            scale = (torch.randn((d,), generator=gen) + 1).to(dev)
            dy = torch.randn((N, d), generator=gen).to(dt).to(dev)
            what = f"rmsnorm_bwd ({N}, {d}) {dt}"
            if N == 0:
                dx, ds = rmsnorm.rmsnorm_bwd_cuda(x, scale, dy)
                if dx.shape != (0, d) or bool(ds.ne(0).any()):
                    raise AssertionError(f"{what}: not an empty dx and a "
                                         f"zero dscale")
                continue
            err = max(err, _bwd_err(rmsnorm, x, scale, dy, what))
            if (N, d) in BWD_TWICE:
                a = rmsnorm.rmsnorm_bwd_cuda(x, scale, dy)
                b = rmsnorm.rmsnorm_bwd_cuda(x, scale, dy)
                for u, v in zip(a, b):
                    _equal(u.float(), v.float(), f"{what} twice")
    for N, d in ((40, 3072), (70000, 24)):   # the block and narrow paths
        for dt in (torch.float32, torch.bfloat16):
            x, dy = ((torch.randn((N * d + 1,), generator=gen) * 3).to(dt)
                     .to(dev)[1:].view(N, d) for _ in range(2))
            scale = (torch.randn((d,), generator=gen) + 1).to(dev)
            err = max(err, _bwd_err(rmsnorm, x, scale, dy,
                                    f"rmsnorm_bwd unaligned ({N}, {d}) "
                                    f"{dt}"))
    torch.cuda.synchronize()
    return err


def expected_train_launches(cfg, steps: int) -> dict:
    """rmsnorm's forward and backward launches over ``steps`` train steps,
    from the code: a step's forward runs every block's norms and the
    final norm once (an enc-dec config also its encoder blocks' norms and
    ``enc_norm``); under ``remat`` "full" or "dots" the backward runs
    each block's forward again (its norms too) before its gradient; the
    backward kernel runs once for every norm of the forward."""
    blocks = cfg.num_layers * norms_per_layer(cfg, bool(cfg.encoder_layers))
    if cfg.encoder_layers:
        blocks += cfg.encoder_layers * norms_per_layer(cfg)
    per_forward = blocks + 1 + (1 if cfg.encoder_layers else 0)
    recompute = blocks if cfg.remat != "none" else 0
    return {"rmsnorm": steps * (per_forward + recompute),
            "rmsnorm_bwd": steps * per_forward}


def model_flops_per_step(cfg, params, tokens: int, seq_len: int) -> float:
    """Model FLOPs of one train step (PaLM's count, no recomputation):
    6 x the matrix params (the tied table once, as the unembedding) x
    tokens, plus 12 L H hd S a token for attention's two products over
    the whole S x S (``grouped_attention`` computes every score)."""
    n_mm = sum(p.numel() for p in params.parameters() if p.dim() >= 2)
    attn = 12 * cfg.num_layers * cfg.num_heads * cfg.resolved_head_dim() \
        * seq_len
    return tokens * (6 * n_mm + attn)


def profile_busy(prof, wall: float) -> dict:
    """A held session's (``start_session``) device time by kernel name, its
    pads aside, the seconds the host waited on a full launch queue
    (CUPTI's "Command Buffer Full", not device work), its (launch calls,
    kernels recorded), and its busy time (every kernel's and copy's
    device time), idle share of ``wall`` and top kernels: these three
    None / empty unless the session recorded a kernel for every launch
    (``_kernel_counts``)."""
    launched, ran, _ = _kernel_counts(prof, PAD_HEAD + PAD_TAIL)
    by_kernel = {}
    for name, _, ns in _device_events(prof):
        if PAD_KERNEL not in name:
            by_kernel[name] = by_kernel.get(name, 0.0) + ns / 1e9
    queue_full = by_kernel.pop("Command Buffer Full", 0.0)
    kept = bool(by_kernel) and launched > 0 and ran == launched
    busy = sum(by_kernel.values()) if kept else None
    return {"by_kernel": by_kernel, "queue_full_s": queue_full,
            "session": (launched, ran), "prof_wall": wall, "busy": busy,
            "idle": None if busy is None else 1 - busy / wall,
            "top": sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
            if kept else []}


def busy_text(b: dict, top: int = 8) -> str:
    """``profile_busy``'s numbers as printed, with the ``top`` kernels."""
    launched, ran = b["session"]
    if b["busy"] is None:
        return (f"idle share not measured (the session recorded {ran} "
                f"kernels of {launched} launch calls)")
    return (f"idle share {b['idle']:.4f} (device busy {b['busy']:.4f} s of "
            f"{b['prof_wall']:.4f} s; {launched} launches, all recorded); "
            f"the host waited on a full launch queue for "
            f"{b['queue_full_s']:.4f} s" + (
                "; top kernels by device time: " + "; ".join(
                    f"{name[:60]} {t:.4f} s" for name, t in b["top"][:top])
                if top else ""))


def train_full_width(rmsnorm, p: dict = TRAIN_POINT) -> dict:
    """The point's model at full width (cut in depth) trained on the card
    through ``Trainer.run``: every loss finite and the last below the
    first, a finite non-zero gradient on every parameter at step 0, exact
    rmsnorm forward and backward launches, and the checkpoint written at
    the end read back by ``load_checkpoint`` equal leaf for leaf to the
    final params. Returns the run's numbers: step times (CUDA events
    between the ends of consecutive steps), the profiled step's idle
    share and top kernels, memory."""
    import shutil
    import tempfile

    from repro_torch import convert
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.configs.base import InputShape
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = point_config(p)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {"layers": cfg.num_layers}
    events, prof = [], {}

    def on_step(step, state, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if step == 0:
            params = state["params"]
            bad = [n for n, q in params.named_parameters()
                   if q.grad is None or not bool(torch.isfinite(q.grad).all())
                   or not bool((q.grad != 0).any())]
            if bad:
                raise AssertionError(f"step 0: no finite non-zero gradient "
                                     f"on {bad}")
            out["params"] = sum(q.numel() for q in params.parameters())
            out["grads_checked"] = len(dict(params.named_parameters()))
            out["state_gb"] = (sum(q.numel() * q.element_size()
                                   for q in params.parameters())
                               + sum(t.numel() * t.element_size()
                                     for k in ("m", "v")
                                     for t in state["opt"][k].values())) / 1e9
            out["flops"] = model_flops_per_step(
                cfg, params, p["batch"] * p["seq_len"], p["seq_len"])
        if step == p["profile_step"] - 1:
            prof["p"] = start_session()
            prof["t0"] = time.perf_counter()
        if step == p["profile_step"]:
            torch.cuda.synchronize()
            prof["wall"] = time.perf_counter() - prof["t0"]
            stop_session(prof["p"])

    rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
    trainer = Trainer(cfg, InputShape("train_4k_cut", p["seq_len"],
                                      p["batch"], "train"),
                      TrainerConfig(steps=p["steps"], log_every=1,
                                    checkpoint_dir=ckpt_dir, seed=p["seed"],
                                    opt=AdamWConfig(lr=p["lr"])))
    t0 = time.perf_counter()
    hist = trainer.run(on_step=on_step)
    torch.cuda.synchronize()
    out["wall"] = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.LAUNCHES,
                "rmsnorm_bwd": rmsnorm.LAUNCHES_BWD}
    want = expected_train_launches(cfg, p["steps"])
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    losses = [h["loss"] for h in hist]
    if len(losses) != p["steps"] or not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["losses"] = losses
    out["grad_norms"] = [h["grad_norm"] for h in hist]
    out["launches"] = launches
    out["step_ms"] = [events[i - 1].elapsed_time(events[i])
                      for i in range(1, len(events))]
    steady = float(np.median(out["step_ms"]))
    out["tok_per_s"] = p["batch"] * p["seq_len"] / steady * 1e3
    out["mfu"] = out["flops"] / (steady / 1e3) / BF16_OPS_PER_S
    out.update(profile_busy(prof["p"], prof["wall"]))

    t0 = time.perf_counter()
    tree, step = load_checkpoint(ckpt_dir, device="cpu")
    got = _tree_leaves(tree)
    want_leaves = _tree_leaves(convert.lm_params_to_jax(
        cfg, trainer.final_state["params"]))
    if step != p["steps"] or got.keys() != want_leaves.keys():
        raise AssertionError(f"checkpoint step {step}, keys "
                             f"{sorted(got)} != {sorted(want_leaves)}")
    for name, leaf in want_leaves.items():
        if not (got[name].dtype == leaf.dtype
                and torch.equal(got[name], leaf)):
            raise AssertionError(f"checkpoint leaf {name} differs")
    out["checkpoint"] = dict(step=step, leaves=len(got),
                             read_s=time.perf_counter() - t0)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del tree, got, want_leaves
    out["counted"] = counted_step(rmsnorm, cfg, p, trainer.final_state)
    del trainer
    torch.cuda.empty_cache()
    return out


def counted_step(rmsnorm, cfg, p: dict, state: dict) -> dict:
    """One more train step of the point on the trained state, under
    ``FlopCounterMode`` (it launches both norm kernels: 17 forward and 9
    backward launches at 4 layers): its FLOPs, and the bytes of what the
    step takes (params, AdamW moments and step counter, batch), for the
    dry run's one-card plan."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_source
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    shape = InputShape("train_4k_cut", p["seq_len"], p["batch"], "train")
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             make_source(cfg, shape, p["seed"]).batch(p["steps"]).items()}
    step = make_train_step(build_model(cfg), AdamWConfig(lr=p["lr"]))
    rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
    with FlopCounterMode(display=False) as fc:
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    launches = {"rmsnorm": rmsnorm.LAUNCHES,
                "rmsnorm_bwd": rmsnorm.LAUNCHES_BWD}
    want = expected_train_launches(cfg, 1)
    if launches != want:
        raise AssertionError(f"counted step launches {launches} != {want}")
    tensors = [*state["params"].parameters(), *state["opt"]["m"].values(),
               *state["opt"]["v"].values(), state["opt"]["step"],
               *batch.values()]
    return {"flops": fc.get_total_flops(), "launches": launches,
            "argument_bytes": sum(t.numel() * t.element_size()
                                  for t in tensors)}


def _tree_leaves(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_tree_leaves(v, name))
        else:
            out[name] = v
    return out


def train_parity(rmsnorm, p: dict = TRAIN_PARITY_POINT) -> dict:
    """The full-width model cut to ``p["layers"]`` layers in float32
    (params and compute; TF32 off), trained ``p["steps"]`` steps on the
    card and on the CPU from the same weights and batches: each step's
    loss to rel 1e-5, every gradient of step 0 within 1e-4 of its
    tensor's largest CPU gradient, the card's launches exact. Params are
    not compared after a step: AdamW's first update is +-lr wherever |g|
    >> eps, so a near-zero gradient whose sign differs moves a param by 2
    lr."""
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_source
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(point_config(p), compute_dtype="float32",
                              param_dtype="float32")
    model = build_model(cfg)
    opt = AdamWConfig(lr=p["lr"])
    gpu = model.init(p["seed"], "cuda")
    cpu = type(gpu)(cfg, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    source = make_source(cfg, InputShape("parity", p["seq_len"], p["batch"],
                                         "train"), seed=p["seed"])
    out = {}
    for name, params in (("cuda", gpu), ("cpu", cpu)):
        state = {"params": params,
                 "opt": adamw_init(dict(params.named_parameters()), opt)}
        step_fn = make_train_step(model, opt, total_steps=p["steps"],
                                  warmup=p["warmup"])
        rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
        losses, t0 = [], time.perf_counter()
        for step in range(p["steps"]):
            batch = {k: torch.from_numpy(v).to(name)
                     for k, v in source.batch(step).items()}
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            if step == 0:
                grads = {n: q.grad.cpu() for n, q in
                         params.named_parameters()}
        out[name] = dict(losses=losses, grads=grads,
                         s=time.perf_counter() - t0,
                         launches={"rmsnorm": rmsnorm.LAUNCHES,
                                   "rmsnorm_bwd": rmsnorm.LAUNCHES_BWD})
    want = expected_train_launches(cfg, p["steps"])
    if out["cuda"]["launches"] != want:
        raise AssertionError(f"train parity launches "
                             f"{out['cuda']['launches']} != {want}")
    loss_err = 0.0
    for a, b in zip(out["cuda"]["losses"], out["cpu"]["losses"]):
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"train parity losses {out['cuda']['losses']}"
                                 f" != {out['cpu']['losses']}")
        loss_err = max(loss_err, abs(a - b) / abs(b))
    grad_err = 0.0
    for n, g in out["cuda"]["grads"].items():
        w = out["cpu"]["grads"][n]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        if not (scale > 0 and err <= 1e-4 * scale):
            raise AssertionError(f"train parity gradient {n}: {err} of "
                                 f"{scale}")
        grad_err = max(grad_err, err / scale)
    res = dict(losses=out["cuda"]["losses"], cpu_losses=out["cpu"]["losses"],
               loss_rel_err=loss_err, grad_rel_err=grad_err,
               grads=len(out["cuda"]["grads"]),
               launches=out["cuda"]["launches"], cuda_s=out["cuda"]["s"],
               cpu_s=out["cpu"]["s"])
    del gpu, cpu, out
    torch.cuda.empty_cache()
    return res


def bwd_device_times(shapes) -> dict:
    """The backward kernel's device time (both passes) and the library
    backward's at each bf16 (N, d) of ``shapes``, by profiler, from a
    fresh process (``scripts/rmsnorm_bwd_ab.py``): in this one, every
    profiler session after the first large one loses launches, and
    ``_busy_ms`` then reads None."""
    root = Path(__file__).resolve().parent
    torch.cuda.empty_cache()
    run = subprocess.run(
        [sys.executable, str(root / "scripts" / "rmsnorm_bwd_ab.py"),
         "--src", str(root / "src"),
         "--shapes", ",".join(f"{N}x{d}" for N, d in shapes)],
        capture_output=True, text=True, timeout=600)
    if run.returncode != 0:
        raise RuntimeError(f"rmsnorm_bwd_ab.py failed:\n{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def rmsnorm_bwd_numbers(rmsnorm, x, scale, dy, device: dict) -> dict:
    """The backward kernel's times at x (N, d): both passes by events,
    the plain version, the library's gradient (``torch.autograd.grad``
    through ``F.rms_norm``, its backward alone; the events time also
    counts autograd's host work) and the bound: x, dy and dx once, the
    scale and dscale once, over the card's memory rate; the two device
    times by profiler come in ``device`` (``bwd_device_times``). Each
    call takes the next of enough copies of x, the scale and dy to pass
    the L2 (``_copies``)."""
    N, d = x.shape
    nbytes = 3 * N * d * x.element_size() + 2 * d * 4
    ops = 10 * N * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    sets = _copies(nbytes, x, scale, dy)
    kernel = _rotating(rmsnorm.rmsnorm_bwd_cuda, sets)
    graphs = []
    for xi, si, dyi in sets:
        xr = xi.detach().clone().requires_grad_()
        w = si.to(xi.dtype).requires_grad_()
        graphs.append((torch.nn.functional.rms_norm(xr, (d,), w, 1e-6),
                       (xr, w), dyi))
    out = {
        "shape": [N, d], "dtype": str(x.dtype).replace("torch.", ""),
        "ms": _time_ms(kernel),
        "device_ms": device["device_ms"],
        "plain_ms": _time_ms(_rotating(rmsnorm.rmsnorm_bwd_torch, sets),
                             reps=50),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    library = _rotating(lambda y, inputs, dyi: torch.autograd.grad(
        y, inputs, dyi, retain_graph=True), graphs)
    out["library_ms"] = _time_ms(library, reps=50)
    out["library_device_ms"] = device["library_device_ms"]
    del sets, graphs
    return out


def print_training(label: str, p: dict, tr: dict) -> None:
    print(f"{label} ({p['arch']} full width, {tr['layers']} layers, "
          f"{tr['params']} params, {p['batch']} x {p['seq_len']} tokens, "
          f"{p['steps']} steps, AdamW lr {p['lr']}, remat full, bf16 "
          f"compute, float32 params and moments): losses "
          f"{[round(v, 5) for v in tr['losses']]}, grad norms "
          f"{[round(v, 4) for v in tr['grad_norms']]}; every one of "
          f"{tr['grads_checked']} params has a finite non-zero gradient at "
          f"step 0; launches {tr['launches']}; wall {tr['wall']:.2f} s")
    print(f"{label} step ms (CUDA events, steps 1-{p['steps'] - 1}; the "
          f"step after the profiled one includes the profiler's stop) "
          f"{[round(v, 3) for v in tr['step_ms']]}; median "
          f"{float(np.median(tr['step_ms'])):.3f} ms = "
          f"{tr['tok_per_s']:.1f} tokens/s; model FLOPs a step "
          f"{tr['flops']:.4e} = {tr['mfu']:.4f} of 989 TFLOP/s; train state "
          f"{tr['state_gb']:.2f} GB, peak {tr['peak_gb']:.2f} GB; "
          f"checkpoint step {tr['checkpoint']['step']} read back equal "
          f"({tr['checkpoint']['leaves']} leaves, "
          f"{tr['checkpoint']['read_s']:.2f} s)")
    print(f"{label} step {p['profile_step']} profiled: {busy_text(tr)}")


# ------------------------------------------- scheduler-driven training
@contextlib.contextmanager
def offer_calls():
    """Count the offer path's kernel-wrapper calls made in the block:
    ``pricing.price_bundle_batch`` (every bundle, the per-slot form's
    too) and the DP's ``minplus_sweep_host``. On a CPU ledger they run
    the plain versions; on a CUDA ledger each call is one launch."""
    from repro_torch.core import dp
    from repro_torch.kernels import pricing
    calls = {"price_bundle": 0, "minplus_sweep": 0}
    bundle, sweep = pricing.price_bundle_batch, dp.minplus_sweep_host

    def counted_bundle(*args, **kw):
        calls["price_bundle"] += 1
        return bundle(*args, **kw)

    def counted_sweep(*args, **kw):
        calls["minplus_sweep"] += 1
        return sweep(*args, **kw)

    pricing.price_bundle_batch = counted_bundle
    dp.minplus_sweep_host = counted_sweep
    try:
        yield calls
    finally:
        pricing.price_bundle_batch, dp.minplus_sweep_host = bundle, sweep


def cluster_schedules(cluster, pricing, minplus, ids, slots: int,
                      jobs: int) -> dict:
    """``cluster.schedule`` on the card and on the CPU: identical
    decisions and utility, and on the card each offer kernel launched
    exactly as often as the CPU run calls its wrapper."""
    pricing.LAUNCHES = minplus.LAUNCHES = 0
    t0 = time.perf_counter()
    gpu = cluster.schedule(ids, slots, jobs, "cuda")
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = _launches(pricing, minplus)
    t0 = time.perf_counter()
    with offer_calls() as calls:
        cpu = cluster.schedule(ids, slots, jobs, "cpu")
    cpu_s = time.perf_counter() - t0
    _require_launches(launches, "the cluster schedule")
    if launches != calls:
        raise AssertionError(f"cluster schedule launches {launches} != the "
                             f"cpu run's calls {calls}")
    if decision_trace(gpu.records) != decision_trace(cpu.records):
        raise AssertionError("cluster schedule: cuda and cpu decided "
                             "differently")
    if gpu.total_utility != cpu.total_utility:
        raise AssertionError(f"cluster utility {gpu.total_utility!r} != "
                             f"{cpu.total_utility!r}")
    return dict(res=gpu, launches=launches, offers=len(gpu.records),
                cuda_s=gpu_s, cpu_s=cpu_s)


def _job_launches(res, cfg_for, steps_per_slot: int) -> dict:
    """rmsnorm's exact launches over every admitted job's steps."""
    want = {"rmsnorm": 0, "rmsnorm_bwd": 0}
    for r in res.admitted:
        n = expected_train_launches(cfg_for(r.job.arch),
                                    len(r.schedule.slots) * steps_per_slot)
        for k in want:
            want[k] += n[k]
    return want


def cluster_example(cluster, pricing, minplus, rmsnorm,
                    p: dict = CLUSTER_POINT) -> dict:
    """The example's own settings through ``cluster.schedule`` and
    ``cluster.run_jobs`` on the card and on the CPU: identical decisions,
    exact launches of the four kernels, and every job's loss in every
    slot within 1e-5. The CPU run starts from the card run's initial
    params (``state_dict``) and trains on its batches: ``model.init``
    and ``concrete_batch`` draw from a generator on their device."""
    from repro_torch.configs import get_config
    from repro_torch.models import concrete_batch

    def cfg_for(aid):
        return get_config(aid, reduced=True)

    sched = cluster_schedules(cluster, pricing, minplus, None, p["slots"],
                              p["jobs"])
    res = sched["res"]
    initial, batches = {}, {}

    def init_gpu(job_id, model, device):
        params = model.init(job_id, device)
        initial[job_id] = (type(params), {
            k: v.cpu() for k, v in params.state_dict().items()})
        return params

    def batch_gpu(cfg, shape, seed, device):
        batch = concrete_batch(cfg, shape, seed=seed, device=device)
        batches[seed] = {k: v.cpu() for k, v in batch.items()}
        return batch

    def init_cpu(job_id, model, device):
        cls, state = initial[job_id]
        params = cls(model.cfg, device)
        params.load_state_dict(state)
        return params

    def batch_cpu(cfg, shape, seed, device):
        return batches[seed]

    rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
    t0 = time.perf_counter()
    gpu = cluster.run_jobs(res, cfg_for, p["slots"], p["steps_per_slot"],
                           "cuda", init=init_gpu, batch_for=batch_gpu)
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.LAUNCHES,
                "rmsnorm_bwd": rmsnorm.LAUNCHES_BWD}
    t0 = time.perf_counter()
    cpu = cluster.run_jobs(res, cfg_for, p["slots"], p["steps_per_slot"],
                           "cpu", init=init_cpu, batch_for=batch_cpu)
    cpu_s = time.perf_counter() - t0
    want = _job_launches(res, cfg_for, p["steps_per_slot"])
    if launches != want:
        raise AssertionError(f"cluster runtime launches {launches} != {want}")
    gap = 0.0
    for jid, losses in cpu.items():
        got = gpu[jid]
        if len(got) != len(losses) or not all(np.isfinite(got)):
            raise AssertionError(f"job {jid}: losses {got} vs {losses}")
        gap = max(gap, *(abs(a - b) for a, b in zip(got, losses)))
    if not gap <= 1e-5:
        raise AssertionError(f"cluster losses cuda {gpu} vs cpu {cpu}: max "
                             f"gap {gap}")
    return dict(sched, losses=gpu, cpu_losses=cpu, loss_gap=gap,
                train_launches=launches, train_cuda_s=gpu_s,
                train_cpu_s=cpu_s,
                steps=sum(len(r.schedule.slots) for r in res.admitted)
                * p["steps_per_slot"])


def cluster_full_width(cluster, pricing, minplus, rmsnorm,
                       p: dict = CLUSTER_FULL_POINT) -> dict:
    """Gemma-7B and Qwen3-32B jobs scheduled on the card and trained there
    at full width, each cut to ``p["layers"]`` layers (float32 params and
    AdamW moments, bf16 compute, remat "full"). Before anything is
    allocated, each admitted job's state (params, gradients and two
    moments, 16 B a param) is reckoned from ``param_count``, and the
    largest set of jobs sharing a slot must fit ``p["state_limit_gb"]``.
    Per job: its steps' times (CUDA events, each step's own; the
    ``profile_step``-th step profiled for the idle share), peak memory
    (reset at the job's build), the state measured and finite losses;
    launches exact."""
    from repro_torch.configs import get_config
    from repro_torch.models import concrete_batch

    def cfg_for(aid):
        return dataclasses.replace(get_config(aid), num_layers=p["layers"])

    sched = cluster_schedules(cluster, pricing, minplus, list(p["archs"]),
                              p["slots"], p["jobs"])
    res = sched["res"]
    jobs = {}
    for r in res.admitted:
        n = cfg_for(r.job.arch).param_count()
        jobs[r.job.job_id] = dict(
            arch=r.job.arch, slots=sorted(r.schedule.slots),
            workers=[r.schedule.slots[t].total_workers()
                     for t in sorted(r.schedule.slots)],
            params=n, state_gb=16 * n / 1e9, steps=[], open=None,
            prof=None)
    shared = max(sum(j["state_gb"] for j in jobs.values() if t in j["slots"])
                 for t in range(p["slots"]))
    print("cluster full width: state reckoned from param_count (f32 "
          "params, grads, 2 moments): " + "; ".join(
              f"job {jid} {j['arch']} {j['params']} params "
              f"{j['state_gb']:.2f} GB in slots {j['slots']} with "
              f"{j['workers']} workers" for jid, j in jobs.items())
          + f"; the largest set of jobs sharing a slot holds {shared:.2f} "
          f"GB (limit {p['state_limit_gb']} GB)")
    if shared > p["state_limit_gb"]:
        raise AssertionError(f"jobs sharing a slot need {shared:.2f} GB")

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def close_step(j):
        if j["open"] is not None:
            j["steps"].append((j["open"], mark()))
            j["open"] = None
        if j["prof"] is not None:
            torch.cuda.synchronize()
            j["prof_wall"] = time.perf_counter() - j["prof_t0"]
            j["busy"] = profile_busy(stop_session(j["prof"]),
                                     j["prof_wall"])
            j["prof"] = None

    def init(job_id, model, device):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(job_id, device)
        torch.cuda.synchronize()
        jobs[job_id]["init_s"] = time.perf_counter() - t0
        return params

    def batch_for(cfg, shape, seed, device):
        j = jobs[seed // 1000]          # the runtime's seed: job_id * 1000 + ...
        close_step(j)
        if len(j["steps"]) == p["profile_step"]:
            j["prof"] = start_session()
            j["prof_t0"] = time.perf_counter()
        j["tokens"] = shape.global_batch * shape.seq_len
        j["open"] = mark()
        return concrete_batch(cfg, shape, seed=seed, device=device)

    def on_slot(t, rec, workers, state, metrics):
        j = jobs[rec.job.job_id]
        close_step(j)
        if t == j["slots"][-1]:
            torch.cuda.synchronize()
            j["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            params = state["params"]
            j["state_measured_gb"] = sum(
                t_.numel() * t_.element_size()
                for t_ in [*params.parameters(),
                           *(q.grad for q in params.parameters()
                             if q.grad is not None),
                           *state["opt"]["m"].values(),
                           *state["opt"]["v"].values()]) / 1e9

    rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
    t0 = time.perf_counter()
    losses = cluster.run_jobs(res, cfg_for, p["slots"], p["steps_per_slot"],
                              "cuda", init=init, batch_for=batch_for,
                              on_slot=on_slot)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm.LAUNCHES,
                "rmsnorm_bwd": rmsnorm.LAUNCHES_BWD}
    want = _job_launches(res, cfg_for, p["steps_per_slot"])
    if launches != want:
        raise AssertionError(f"full-width cluster launches {launches} != "
                             f"{want}")
    for jid, j in jobs.items():
        j["losses"] = losses[jid]
        if not all(np.isfinite(j["losses"])):
            raise AssertionError(f"job {jid} losses {j['losses']}")
        j["step_ms"] = [a.elapsed_time(b) for a, b in j.pop("steps")][1:]
        j["tok_per_s"] = j["tokens"] / float(np.median(j["step_ms"])) * 1e3
        for k in ("open", "prof", "prof_t0"):
            j.pop(k, None)
    torch.cuda.empty_cache()
    return dict(sched, jobs=jobs, train_launches=launches, wall=wall)


def print_cluster(ex: dict, fw: dict, card: str) -> None:
    p, q = CLUSTER_POINT, CLUSTER_FULL_POINT
    res = ex["res"]
    print(f"cluster (the example's settings: {p['slots']} slots, "
          f"{p['jobs']} jobs over the ten archs, {p['steps_per_slot']} "
          f"steps a slot, reduced f32 configs, TF32 off): admitted "
          f"{len(res.admitted)}/{ex['offers']}, utility "
          f"{res.total_utility!r}, decisions identical on cuda and cpu "
          f"(schedule cuda {ex['cuda_s']:.4f} s, cpu {ex['cpu_s']:.4f} s); "
          f"offer launches {ex['launches']} over {ex['offers']} offers = "
          f"the cpu run's wrapper calls; {ex['steps']} train steps, rmsnorm "
          f"launches {ex['train_launches']} exact; losses cuda vs cpu max "
          f"abs gap {ex['loss_gap']:.3e} (limit 1e-5); train cuda "
          f"{ex['train_cuda_s']:.2f} s, cpu {ex['train_cpu_s']:.2f} s")
    for r in res.admitted:
        print(f"  job {r.job.job_id} ({r.job.arch}): slots "
              f"{sorted(r.schedule.slots)} workers "
              f"{[r.schedule.slots[t].total_workers() for t in sorted(r.schedule.slots)]}"
              f" losses {[round(v, 6) for v in ex['losses'][r.job.job_id]]}")
    res = fw["res"]
    print(f"cluster full width ({', '.join(q['archs'])} at published width, "
          f"{q['layers']} layers, f32 params and moments, bf16 compute, "
          f"remat full; {q['slots']} slots, {q['jobs']} jobs, "
          f"{q['steps_per_slot']} steps a slot): admitted "
          f"{len(res.admitted)}/{fw['offers']}, utility "
          f"{res.total_utility!r}, identical on cpu; offer launches "
          f"{fw['launches']}; rmsnorm launches {fw['train_launches']} "
          f"exact; run wall {fw['wall']:.2f} s [{card}]")
    for jid, j in fw["jobs"].items():
        b = j.get("busy")
        print(f"  job {jid} ({j['arch']}, slots {j['slots']}, workers "
              f"{j['workers']}, {j['tokens']} tokens a step): state "
              f"reckoned {j['state_gb']:.4f} GB, measured "
              f"{j['state_measured_gb']:.4f} GB, peak "
              f"{j['peak_gb']:.4f} GB; init {j['init_s']:.3f} s; step ms "
              f"(steps after the first) "
              f"{[round(v, 3) for v in j['step_ms']]}, median "
              f"{float(np.median(j['step_ms'])):.3f} ms = "
              f"{j['tok_per_s']:.1f} tokens/s; losses "
              f"{[round(v, 5) for v in j['losses']]}; step "
              f"{q['profile_step']} profiled: "
              + (busy_text(b, 5) if b else "not profiled"))


# ------------------------------------ training a wide model in slabs
def _finite_nonzero(t: torch.Tensor) -> bool:
    """Every element of ``t`` finite and one at least non-zero, checked
    over slabs of its flat view (no temporary of its size)."""
    parts = t.detach().reshape(-1).split(1 << 26)
    return all(bool(torch.isfinite(c).all()) for c in parts) and \
        any(bool(c.ne(0).any()) for c in parts)


def train_at_width(rmsnorm, p: dict = CMDR_TRAIN_POINT) -> dict:
    """The point's model at full width cut to ``p["layers"]`` layers,
    trained on the card with the cluster example's optimizer and train
    step (``AdamWConfig(lr=1e-3)``: moments in the params' dtype; remat
    "full", the reference's warm-up) on ``concrete_batch`` batches. The
    peak is reckoned from ``param_count`` before anything is allocated:
    params, gradients and moments, the loss head's float32 logits,
    log-probs and their gradient, and the update's float32 slab
    temporaries (``optim.adamw.UPDATE_CHUNK`` elements, at most 5 alive).
    Raises unless every loss is finite, every param has a finite non-zero
    gradient after the first step and the norm launches are exact.
    Returns the step times (CUDA events between step ends), tokens/s,
    model FLOPs, the measured state and peak, and the profiled step's
    idle share."""
    from repro_torch.configs.base import InputShape
    from repro_torch.models import build_model, concrete_batch
    from repro_torch.optim import AdamWConfig, adamw
    from repro_torch.train import make_train_step, train_state

    cfg = point_config(p)
    opt = AdamWConfig(lr=p["lr"])
    n = cfg.param_count()
    tokens = p["batch"] * p["seq_len"]
    pb = torch.empty((), dtype=cfg.dtype("param")).element_size()
    mb = 4 if opt.fp32_moments else pb
    reckoned = {"state": n * 2 * (pb + mb) / 1e9,
                "loss_head": 3 * 4 * tokens * cfg.vocab_size / 1e9,
                "slabs": 5 * 4 * adamw.UPDATE_CHUNK / 1e9}
    reckoned["peak"] = sum(reckoned.values())
    print(f"training at width: {p['arch']}, a {cfg.num_layers}-layer cut, "
          f"{n} params; reckoned before allocating: params, gradients and "
          f"moments {reckoned['state']:.4f} GB + the loss head's float32 "
          f"logits, log-probs and their gradient {reckoned['loss_head']:.4f}"
          f" GB + the update's slab temporaries {reckoned['slabs']:.4f} GB ="
          f" {reckoned['peak']:.4f} GB of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f} GB")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    t0 = time.perf_counter()
    state = train_state(model.init(p["seed"], "cuda"), opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step_fn = make_train_step(model, opt)
    shape = InputShape("train_at_width", p["seq_len"], p["batch"], "train")
    rmsnorm.LAUNCHES = rmsnorm.LAUNCHES_BWD = 0
    ends, losses, busy = [], [], None
    for k in range(p["steps"]):
        batch = concrete_batch(cfg, shape, seed=k, device="cuda")
        if k == p["profile_step"]:
            prof = start_session()
            t1 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        ends.append(torch.cuda.Event(enable_timing=True))
        ends[-1].record()
        if k == p["profile_step"]:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            busy = profile_busy(stop_session(prof), wall)
        losses.append(float(metrics["loss"]))
        if k == 0:
            bad = [name for name, q in state["params"].named_parameters()
                   if q.grad is None or not _finite_nonzero(q.grad)]
            if bad:
                raise AssertionError(f"step 0: no finite non-zero gradient "
                                     f"on {bad}")
    torch.cuda.synchronize()
    launches = {"rmsnorm": rmsnorm.LAUNCHES,
                "rmsnorm_bwd": rmsnorm.LAUNCHES_BWD}
    want = expected_train_launches(cfg, p["steps"])
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    params = state["params"]
    out = dict(layers=cfg.num_layers, params=n, init_s=init_s,
               losses=losses, launches=launches, reckoned=reckoned,
               grads_checked=len(dict(params.named_parameters())),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               state_gb=sum(t.numel() * t.element_size() for t in [
                   *params.parameters(), *(q.grad for q in params.parameters()),
                   *state["opt"]["m"].values(), *state["opt"]["v"].values()])
               / 1e9,
               step_ms=[a.elapsed_time(b) for a, b in zip(ends, ends[1:])],
               flops=model_flops_per_step(cfg, params, tokens,
                                          p["seq_len"]),
               busy=busy)
    steady = float(np.median(out["step_ms"]))
    out["tok_per_s"] = tokens / steady * 1e3
    out["mfu"] = out["flops"] / (steady / 1e3) / BF16_OPS_PER_S
    if not out["peak_gb"] * 1e9 < torch.cuda.get_device_properties(0) \
            .total_memory:
        raise AssertionError(f"peak {out['peak_gb']} GB")
    del state, params, metrics, batch
    torch.cuda.empty_cache()
    return out


def print_train_at_width(label: str, p: dict, tr: dict, card: str) -> None:
    r = tr["reckoned"]
    print(f"{label} ({p['arch']} full width, {tr['layers']} layer, "
          f"{tr['params']} params, {p['batch']} x {p['seq_len']} tokens, "
          f"{p['steps']} steps, AdamW lr {p['lr']} with moments in the "
          f"params' dtype, remat full, bf16 compute): losses "
          f"{[round(v, 5) for v in tr['losses']]}; every one of "
          f"{tr['grads_checked']} params has a finite non-zero gradient "
          f"after step 0; launches {tr['launches']} exact; init "
          f"{tr['init_s']:.2f} s [{card}]")
    print(f"{label} step ms (CUDA events, steps 2-{p['steps']}; step "
          f"{p['profile_step'] + 1} profiled) "
          f"{[round(v, 3) for v in tr['step_ms']]}, median "
          f"{float(np.median(tr['step_ms'])):.3f} ms = "
          f"{tr['tok_per_s']:.1f} tokens/s; model FLOPs a step "
          f"{tr['flops']:.4e} = {tr['mfu']:.4f} of 989 TFLOP/s; state "
          f"measured {tr['state_gb']:.4f} GB (reckoned {r['state']:.4f}); "
          f"peak {tr['peak_gb']:.4f} GB (reckoned {r['peak']:.4f} GB); "
          f"profiled step: {busy_text(tr['busy'])}")


# ------------------------------------------------------------ dry run
#: the production plans (full width and depth, launch.dryrun): Gemma-7B's
#: three shapes on 16x16 and train_4k over two pods (2x16x16); the expert
#: rules (Phi-3.5-MoE); MLA's 40 heads on a 16-way model axis (MiniCPM3)
DRYRUN_PLANS = (("gemma-7b", "train_4k", False),
                ("gemma-7b", "prefill_32k", False),
                ("gemma-7b", "decode_32k", False),
                ("gemma-7b", "train_4k", True),
                ("phi3.5-moe-42b-a6.6b", "train_4k", False),
                ("minicpm3-4b", "decode_32k", False))
#: one card's memory
CARD_BYTES = 80e9


def dryrun_plans(p: dict = TRAIN_POINT, timeout: float = 300.0) -> tuple:
    """The production plans and the one-card plan of the training point
    (``--host``: this machine's one card, cut as the point), each through
    the port's CLI (``python -m repro_torch.launch.dryrun``) in a process
    of its own, all started together: a plan's process group (a fake one
    of 256 or 512 ranks, the card's own of one) never meets this
    script's. Returns ({name: result}, wall s); every process is stopped
    before it returns."""
    import os
    import shutil
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    jobs = {f"{arch} {shape} {'2x16x16' if pods else '16x16'}":
            ["--arch", arch, "--shape", shape] + (["--multi-pod"] if pods
                                                  else [])
            for arch, shape, pods in DRYRUN_PLANS}
    jobs["one-card"] = ["--arch", p["arch"], "--shape", "train_4k", "--host",
                        "--layers", str(p["layers"]),
                        "--batch", str(p["batch"])]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    procs, results = {}, {}
    t0 = time.perf_counter()
    try:
        for i, (name, args) in enumerate(jobs.items()):
            out = os.path.join(tmp, f"{i}.json")
            log = open(out + ".log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                 "--out", out], env=env, stdout=log,
                stderr=subprocess.STDOUT), out, log)
        for name, (proc, out, log) in procs.items():
            rc = proc.wait(timeout=max(timeout - (time.perf_counter() - t0),
                                       1.0))
            log.close()
            if rc != 0:
                with open(out + ".log") as f:
                    raise AssertionError(f"dry run {name} exited {rc}: "
                                         f"{f.read()[-3000:]}")
            with open(out) as f:
                (results[name],) = json.load(f)
    finally:
        for proc, _, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return results, time.perf_counter() - t0


def plan_terms(name: str, r: dict, p: dict = TRAIN_POINT) -> dict:
    """The roofline terms of a plan (``repro_torch.roofline``, H100
    constants), for the config and shape it planned."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.roofline import roofline_terms

    shape = SHAPES[r["shape"]]
    if name == "one-card":
        cfg = point_config(p)
        shape = dataclasses.replace(shape, global_batch=p["batch"])
    else:
        cfg = get_config(r["arch"])
    return roofline_terms(cfg, shape, r)


def check_plan(name: str, r: dict) -> None:
    """Every number finite, FLOPs and argument bytes positive."""
    nums = [r["flops"], r["hlo_bytes"], *r["memory"].values(),
            *r["collective_bytes"].values()]
    if not all(np.isfinite(float(x)) for x in nums):
        raise AssertionError(f"dry run {name}: a number is not finite: {r}")
    if not (r["flops"] > 0 and r["memory"]["argument_bytes"] > 0):
        raise AssertionError(f"dry run {name}: no FLOPs or no arguments")


def print_plan(name: str, r: dict, t: dict) -> None:
    mem, coll = r["memory"], r["collective_bytes"]
    kinds = {k: v for k, v in coll.items() if not k.endswith("_pod")}
    print(f"dry run {name} (mesh {r['mesh']}, {r['devices']} devices): "
          f"{r['flops']:.6e} FLOPs a device; arguments "
          f"{mem['argument_bytes'] / 1e9:.4f} GB, peak "
          f"{mem['peak_bytes'] / 1e9:.4f} GB a device; collectives "
          f"{ {k: f'{v:.4e}' for k, v in kinds.items()} } B a device, "
          f"NVLink {coll.get('intra_pod', 0.0):.4e} B, InfiniBand "
          f"{coll.get('cross_pod', 0.0):.4e} B; roofline compute "
          f"{t['compute_s']:.4e} s, memory {t['memory_s']:.4e} s, "
          f"collective {t['collective_s']:.4e} s, dominant {t['dominant']};"
          f" L=1/L=2 extrapolation gap {r['extrapolation_gap']}; trace "
          f"{r['lower_s']} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's package is not at {src}/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch as rt
    from repro_torch.kernels import _build, minplus, pricing
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels import rmsnorm
    from repro_torch.launch import cluster
    from repro_torch.launch import sim as launch_sim
    from repro_torch.obs import trace

    # float32 products in full float32 on the card (the parity phase)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = _card_line()
    print(f"device: {kind} x{torch.cuda.device_count()}  torch "
          f"{torch.__version__} cuda {torch.version.cuda}  [{card}]")

    # 2. build (one nvcc per source, in parallel)
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "entry")) \
                    or "error" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    # 3. kernels against their plain versions on the card
    err = check_kernels(pricing, minplus)
    print(f"kernel checks: bit-identical to the plain versions "
          f"(max abs err {err})")

    # 4. main path on the card (a first run warms torch's CUDA ops, then
    # the counted run), then on the CPU
    _, _, wall_cold, _ = run_main_path(rt, trace, "cuda")
    pricing.LAUNCHES = 0
    minplus.LAUNCHES = 0
    jobs, res_gpu, wall_gpu, tr = run_main_path(rt, trace, "cuda")
    launches = _launches(pricing, minplus)
    _, res_cpu, wall_cpu, _ = run_main_path(rt, trace, "cpu")
    _require_launches(launches, "the main path")
    if decision_trace(res_gpu.records) != decision_trace(res_cpu.records):
        raise AssertionError("cuda and cpu runs made different decisions")
    u_gpu, u_cpu = res_gpu.total_utility, res_cpu.total_utility
    if not (np.isfinite(u_gpu) and abs(u_gpu - u_cpu) <= 1e-9 * abs(u_cpu)):
        raise AssertionError(f"utility {u_gpu} != {u_cpu}")
    if len(res_gpu.records) != len(jobs):
        raise AssertionError("not every job got a decision")
    for sp in tr.spans:
        if sp.name in ("dp.sweep", "plan.bundle") and \
                sp.attrs.get("backend") != "cuda":
            raise AssertionError(f"{sp.name} ran on {sp.attrs}")
    offer_ms = np.array([sp.dur * 1e3 for sp in tr.spans
                         if sp.name == "offer"])
    print(f"main path (H={PAPER_POINT['machines']} T={PAPER_POINT['horizon']}"
          f" jobs={len(jobs)} quanta={PAPER_POINT['quanta']}): admitted "
          f"{len(res_gpu.admitted)}/{len(jobs)} utility {u_gpu!r} "
          f"(cpu {u_cpu!r}); cuda wall {wall_gpu:.4f} s = "
          f"{len(jobs) / wall_gpu:.2f} jobs/s, offer p50 "
          f"{np.percentile(offer_ms, 50):.3f} ms p99 "
          f"{np.percentile(offer_ms, 99):.3f} ms; first cuda run "
          f"{wall_cold:.4f} s; cpu wall {wall_cpu:.4f} s; launches "
          f"{launches}")
    table = tr.phase_table()
    top = sorted(table.items(), key=lambda kv: -kv[1]["self_s"])[:8]
    print("phases by self time (cuda run): " + ", ".join(
        f"{name} {row['self_s']:.4f} s/{int(row['count'])}"
        for name, row in top))
    print(f"main path profiled: {busy_text(device_busy_share(rt, trace), 0)}")

    # 5. serving path: its kernels against their plain versions
    merr = check_model_kernels(rmsnorm, flash)
    print(f"model kernel checks: within tolerance of the plain versions "
          f"(max abs err {merr})")

    # 5b. training path: rmsnorm's backward kernel against its plain
    # version on the card
    berr = check_rmsnorm_bwd(rmsnorm)
    print(f"rmsnorm backward kernel checks: within tolerance of the plain "
          f"version, bit for bit twice (max abs err {berr})")

    # 6. serving path: Gemma-7B at full width and depth on the card
    sv = serve_full_width(rmsnorm, flash)
    print_serving("serving", SERVE_POINT, sv)

    # 7. serving path: 2-layer float32 cut, cuda against cpu
    pa = parity_cuda_cpu()
    print_parity("parity", PARITY_POINT, pa)

    # 7b. MoE serving: Phi-3.5-MoE at full width, 8 layers, then its
    # 2-layer float32 cut on cuda and cpu with the routing compared
    moe_sv = serve_full_width(rmsnorm, flash, MOE_SERVE_POINT)
    print_serving("moe serving", MOE_SERVE_POINT, moe_sv)
    moe_pa = parity_cuda_cpu(MOE_PARITY_POINT)
    print_parity("moe parity", MOE_PARITY_POINT, moe_pa)

    # 8. times at the main paths' shapes
    gen = torch.Generator().manual_seed(1)
    price, free, wdem, sdem = _bundle_inputs(gen, 20, 100, 4, zero_cols=(0,))
    bnum = bundle_numbers(pricing, price.cuda(), free.cuda(), wdem, sdem, 4.0)
    snum = sweep_numbers(minplus, _sweep_inputs(gen, 20, 21).cuda())
    for name, f in (("price_bundle (20, 100, 4)", bnum),
                    ("minplus_sweep (k=20, Q1=21)", snum)):
        print(f"{name}: device {f['device_ms']} ms, events {f['ms']} ms, "
              f"host-level call {f['host_ms']} ms, {f['bound_ms']} ms "
              f"{f['bound_by']} bound; plain {f['plain_ms']} ms, library "
              f"{f['library_ms']} ms")
    x = (torch.randn((4096, 3072), generator=gen) * 3).to(torch.bfloat16)
    rnum = rmsnorm_numbers(rmsnorm, x.cuda(), torch.ones(3072).cuda())
    rdec = rmsnorm_numbers(rmsnorm, x[:4].cuda(), torch.ones(3072).cuda())
    x = (torch.randn((4096, 4096), generator=gen) * 3).to(torch.bfloat16)
    rmoe = rmsnorm_numbers(rmsnorm, x.cuda(), torch.ones(4096).cuda())
    rmoe_dec = rmsnorm_numbers(rmsnorm, x[:4].cuda(),
                               torch.ones(4096).cuda())
    # MLA's q_norm / kv_norm: MiniCPM3 on 4 x 1024 prefill rows, DeepSeek-V2
    # on 4 x 512, and both on the 4 decode rows
    rmla = {}
    for N, d in ((4096, 768), (4096, 256), (2048, 1536), (2048, 512)):
        x = (torch.randn((N, d), generator=gen) * 3).to(torch.bfloat16)
        one = torch.ones(d).cuda()
        rmla[f"{N}x{d}"] = rmsnorm_numbers(rmsnorm, x.cuda(), one)
        rmla[f"4x{d}"] = rmsnorm_numbers(rmsnorm, x[:4].cuda(), one)
    # the SSM, hybrid and enc-dec widths: Mamba-2's d_model and gated
    # norm (d_inner) on 4 x 1024 prefill rows, Hymba's on 4 x 2048,
    # SeamlessM4T's encoder (4 x 1600 frames) and decoder (4 x 128) rows,
    # and each on the 4 decode rows
    rnew = {}
    # ((4096, 3072) and (4, 3072), Mamba-2's gated norm, are Gemma's above)
    for N, d in ((4096, 1536), (8192, 1600), (8192, 3200), (6400, 1024),
                 (512, 1024)):
        x = (torch.randn((N, d), generator=gen) * 3).to(torch.bfloat16)
        one = torch.ones(d).cuda()
        rnew[f"{N}x{d}"] = rmsnorm_numbers(rmsnorm, x.cuda(), one)
        if f"4x{d}" not in rnew:
            rnew[f"4x{d}"] = rmsnorm_numbers(rmsnorm, x[:4].cuda(), one)
    # the dense GQA serving points: Qwen3-32B's block norms and QK-norm
    # (4 x 1024 prefill tokens x 64 query heads and x 8 kv heads; the 4
    # decode rows likewise), Command R+'s block norms
    rwide = {}
    for N, d in ((4096, 5120), (4, 5120), (262144, 128), (32768, 128),
                 (256, 128), (32, 128), (4096, 12288), (4, 12288)):
        x = (torch.randn((N, d), generator=gen) * 3).to(torch.bfloat16)
        scale = (torch.randn((d,), generator=gen) + 1).cuda()
        rwide[f"{N}x{d}"] = rmsnorm_numbers(rmsnorm, x.cuda(), scale)
    # Qwen3-32B's QK-norm in the cluster phase: 16 x 64 tokens x 64 query
    # heads and x 8 kv heads, rows of its head width 128, both directions;
    # Command R+'s training rows (16 x 64 tokens at d 12,288)
    fresh = bwd_device_times(((65536, 128), (8192, 128), (8192, 3072),
                              (1024, 12288)))
    rqk, bqk = {}, {}
    for N in (65536, 8192):
        x = (torch.randn((N, 128), generator=gen) * 3).to(torch.bfloat16)
        dy = torch.randn((N, 128), generator=gen).to(torch.bfloat16)
        scale = (torch.randn((128,), generator=gen) + 1).cuda()
        rqk[f"{N}x128"] = rmsnorm_numbers(rmsnorm, x.cuda(), scale)
        bqk[f"{N}x128"] = rmsnorm_bwd_numbers(rmsnorm, x.cuda(), scale,
                                              dy.cuda(), fresh[f"{N}x128"])
    # the training shape: Gemma-7B's 2 x 4096 rows, forward and backward
    x = (torch.randn((8192, 3072), generator=gen) * 3).to(torch.bfloat16)
    dy = torch.randn((8192, 3072), generator=gen).to(torch.bfloat16)
    rtrain = rmsnorm_numbers(rmsnorm, x.cuda(), torch.ones(3072).cuda())
    scale = (torch.randn((3072,), generator=gen) + 1).cuda()
    bnum_train = rmsnorm_bwd_numbers(rmsnorm, x.cuda(), scale, dy.cuda(),
                                     fresh["8192x3072"])
    # Command R+'s training rows, forward and backward
    x = (torch.randn((1024, 12288), generator=gen) * 3).to(torch.bfloat16)
    dy = torch.randn((1024, 12288), generator=gen).to(torch.bfloat16)
    scale = (torch.randn((12288,), generator=gen) + 1).cuda()
    rcmdr_train = rmsnorm_numbers(rmsnorm, x.cuda(), scale)
    bcmdr_train = rmsnorm_bwd_numbers(rmsnorm, x.cuda(), scale, dy.cuda(),
                                      fresh["1024x12288"])
    del x, dy
    for f in (bnum_train, *bqk.values(), bcmdr_train):
        print(f"rmsnorm_bwd {f['shape']} {f['dtype']}: device "
              f"{f['device_ms']} ms (both passes, a fresh process), events "
              f"{f['ms']} ms, "
              f"{f['bound_ms']} ms {f['bound_by']} bound; plain "
              f"{f['plain_ms']} ms, autograd through F.rms_norm "
              f"{f['library_ms']} ms, its device time "
              f"{f['library_device_ms']} ms")
    for f in (rnum, rdec, rtrain, rmoe, rmoe_dec, *rmla.values(),
              *rnew.values(), *rqk.values(), *rwide.values(), rcmdr_train):
        print(f"rmsnorm {f['shape']} {f['dtype']}: device {f['device_ms']} "
              f"ms, events {f['ms']} ms, {f['bound_ms']} ms {f['bound_by']} "
              f"bound; plain {f['plain_ms']} ms, F.rms_norm "
              f"{f['library_ms']} ms")
    q, k, v = (torch.randn((4, 1024, 16, 256), generator=gen)
               .to(torch.bfloat16).cuda() for _ in range(3))
    fnum = flash_numbers(flash, q, k, v)       # Gemma-7B prefill, bf16
    fnum["float32"] = flash_numbers(flash, q.float(), k.float(), v.float())
    del q, k, v
    # the dense GQA serving points' prefill: Qwen3-32B's 64 query heads
    # and Command R+'s 96 (a group of 12) over 8 kv heads of 128
    fgqa = {}
    for key, H in (("qwen3_32b", 64), ("command_r_plus", 96)):
        q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
                   .cuda() for shape in ((4, 1024, H, 128), (4, 1024, 8, 128),
                                         (4, 1024, 8, 128)))
        fgqa[key] = flash_numbers(flash, q, k, v)
        del q, k, v
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()
               for shape in ((4, 1024, 32, 128), (4, 1024, 8, 128),
                             (4, 1024, 8, 128)))
    fmoe = flash_numbers(flash, q, k, v)       # Phi-3.5-MoE prefill
    del q, k, v
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16).cuda()
               for shape in ((4, 3008, 32, 128), (4, 3008, 8, 128),
                             (4, 3008, 8, 128)))
    fvlm = flash_numbers(flash, q, k, v)       # LLaVA-NeXT prefill
    del q, k, v
    # Hymba's prefill (25 query heads over 5 kv heads of 64; the sliding
    # window of 1024 and a global layer) and SeamlessM4T's (the encoder
    # over 1600 frames, the prefill's cross-attention from 128 target
    # positions over them, the decoder's causal self-attention)
    fnew = {}
    for name, (B, S_q, S_k, H, KV, causal, window) in (
            ("hymba_sliding", (4, 2048, 2048, 25, 5, True, 1024)),
            ("hymba_global", (4, 2048, 2048, 25, 5, True, 0)),
            ("seamless_encoder", (4, 1600, 1600, 16, 16, False, 0)),
            ("seamless_cross", (4, 128, 1600, 16, 16, False, 0)),
            ("seamless_decoder", (4, 128, 128, 16, 16, True, 0))):
        q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
                   .cuda() for shape in ((B, S_q, H, 64), (B, S_k, KV, 64),
                                         (B, S_k, KV, 64)))
        fnew[name] = flash_numbers(flash, q, k, v, causal, window)
        if name == "hymba_sliding":
            fnew["hymba_sliding_float32"] = flash_numbers(
                flash, q.float(), k.float(), v.float(), causal, window)
        del q, k, v
    for label, f in (("bf16, tensor cores", fnum),
                     ("float32, CUDA cores", fnum["float32"]),
                     ("bf16 at Qwen3-32B's prefill", fgqa["qwen3_32b"]),
                     ("bf16 at Command R+'s prefill", fgqa["command_r_plus"]),
                     ("bf16 at Phi-3.5-MoE's prefill", fmoe),
                     ("bf16 at LLaVA-NeXT's prefill", fvlm),
                     *((f"{f['dtype']}, {name}", f)
                       for name, f in fnew.items())):
        print(f"flash {f['shape']} kv_heads {f['kv_heads']} keys "
              f"{f['keys']} causal {f['causal']} window {f['window']} "
              f"({label}): device {f['device_ms']} ms, events {f['ms']} ms,"
              f" {f['tflops']} TFLOP/s, {f['bound_share']} of the "
              f"{f['bound_ms']} ms {f['bound_by']} bound; plain "
              f"{f['plain_ms']} ms, library {f['library_ms']} ms "
              f"({f['library_op']})")
    # 8a. training path: Gemma-7B at full width (4 layers) trained 8 steps
    # through Trainer.run, then its 2-layer float32 cut on cuda and cpu;
    # after the kernel times (with the profiled training step before
    # them, the flash timing sessions recorded no device time on an H100
    # 80GB HBM3)
    t0 = time.perf_counter()
    tr = train_full_width(rmsnorm)
    print_training("training", TRAIN_POINT, tr)
    tp = train_parity(rmsnorm)
    print(f"training parity ({TRAIN_PARITY_POINT['layers']}-layer "
          f"full-width f32, TF32 off, {TRAIN_PARITY_POINT['batch']} x "
          f"{TRAIN_PARITY_POINT['seq_len']} tokens, "
          f"{TRAIN_PARITY_POINT['steps']} steps, cuda vs cpu): losses "
          f"{tp['losses']} (cpu {tp['cpu_losses']}), max rel err "
          f"{tp['loss_rel_err']:.3e}; all {tp['grads']} step-0 gradients "
          f"within {tp['grad_rel_err']:.3e} of their largest; launches on "
          f"the card {tp['launches']}; cuda {tp['cuda_s']:.2f} s, cpu "
          f"{tp['cpu_s']:.2f} s")
    print(f"training phase wall {time.perf_counter() - t0:.2f} s")

    # 8a''. scheduler-driven training (launch.cluster): the example's own
    # settings on cuda and on cpu, then Gemma-7B and Qwen3-32B jobs at
    # full width on the card
    t0 = time.perf_counter()
    ex = cluster_example(cluster, pricing, minplus, rmsnorm)
    fw = cluster_full_width(cluster, pricing, minplus, rmsnorm)
    print_cluster(ex, fw, card)
    print(f"cluster phase wall {time.perf_counter() - t0:.2f} s")

    # 8a'''. Command R+ at full width, 1 layer, trained with the update in
    # slabs
    t0 = time.perf_counter()
    tw = train_at_width(rmsnorm)
    print_train_at_width("training at width", CMDR_TRAIN_POINT, tw, card)
    print(f"training at width phase wall {time.perf_counter() - t0:.2f} s")

    # 8a'. the dry run: the production plans at full width and depth on
    # fake 256- and 512-GPU meshes, and the one-card plan of the training
    # point held to the step the training phase counted
    plans, wall = dryrun_plans()
    print(f"dry run ({len(plans)} plans, one process each, all at once; "
          f"wall {wall:.2f} s) [{card}]")
    for name, r in plans.items():
        check_plan(name, r)
        print_plan(name, r, plan_terms(name, r))
    gemma = plans["gemma-7b train_4k 16x16"]["memory"]
    if not gemma["argument_bytes"] < CARD_BYTES:
        raise AssertionError(f"Gemma-7B train_4k's state is "
                             f"{gemma['argument_bytes']} B a device")
    one, ct = plans["one-card"], tr["counted"]
    if one["flops"] != ct["flops"]:
        raise AssertionError(f"one-card plan {one['flops']} FLOPs != the "
                             f"counted step's {ct['flops']}")
    if one["memory"]["argument_bytes"] != ct["argument_bytes"]:
        raise AssertionError(f"one-card plan's arguments "
                             f"{one['memory']['argument_bytes']} B != the "
                             f"step's {ct['argument_bytes']} B")
    t = plan_terms("one-card", one)
    print(f"one-card plan = the counted step: {ct['flops']} FLOPs and "
          f"{ct['argument_bytes']} B of params, moments, step and batch, "
          f"both exactly (its launches {ct['launches']}); Gemma-7B train_4k "
          f"on 16x16 holds {gemma['argument_bytes'] / 1e9:.4f} GB of state "
          f"a device (under {CARD_BYTES / 1e9:.0f} GB), its traced peak "
          f"{gemma['peak_bytes'] / 1e9:.4f} GB "
          f"({'under' if gemma['peak_bytes'] < CARD_BYTES else 'over'} "
          f"it); one-card plan peak {one['memory']['peak_bytes'] / 1e9:.4f} "
          f"GB vs max_memory_allocated {tr['peak_gb']:.4f} GB; roofline "
          f"compute {t['compute_s'] * 1e3:.3f} ms, memory "
          f"{t['memory_s'] * 1e3:.3f} ms vs the measured step "
          f"{float(np.median(tr['step_ms'])):.3f} ms [{card}]")

    # 8b. MLA, vision, MLA + MoE, SSM, hybrid and enc-dec serving:
    # MiniCPM3-4B cut to 16 layers, LLaVA-NeXT, DeepSeek-V2 cut to 6
    # layers, Mamba2-780m, Hymba-1.5B and SeamlessM4T-medium at full
    # width; each then its 2-layer float32 cut on cuda and cpu. After the
    # kernel times: with these long profiled runs (~10^5 kernels each)
    # before them, the profiler recorded no device time for the flash
    # kernel's timing sessions
    served, parities = {}, {}
    for key, label, point, parity in (
            ("qwen3_32b", "qk-norm serving", QWEN3_SERVE_POINT,
             QWEN3_PARITY_POINT),
            ("command_r_plus", "wide serving", CMDR_SERVE_POINT,
             CMDR_PARITY_POINT),
            ("minicpm3_4b", "mla serving", MLA_SERVE_POINT,
             MLA_PARITY_POINT),
            ("llava_next", "vision serving", VLM_SERVE_POINT,
             VLM_PARITY_POINT),
            ("deepseek_v2", "mla+moe serving", DSV2_SERVE_POINT,
             DSV2_PARITY_POINT),
            ("mamba2_780m", "ssm serving", SSM_SERVE_POINT,
             SSM_PARITY_POINT),
            ("hymba_1_5b", "hybrid serving", HYBRID_SERVE_POINT,
             HYBRID_PARITY_POINT),
            ("seamless_m4t_medium", "enc-dec serving", ENCDEC_SERVE_POINT,
             ENCDEC_PARITY_POINT)):
        t0 = time.perf_counter()
        served[key] = serve_full_width(rmsnorm, flash, point)
        print_serving(label, point, served[key])
        parities[key] = parity_cuda_cpu(parity)
        print_parity(label.replace("serving", "parity"), parity,
                     parities[key])
        print(f"{label} phase wall {time.perf_counter() - t0:.2f} s")

    # 9. the online simulator on the card (the offer kernels inside the
    # event engine), against the CPU; last, so its long profiled run
    # comes after every kernel timing
    on = online_sim(rt, launch_sim, trace, pricing, minplus)
    sp = SIM_POINT
    print(f"online sim (H={sp['machines']} W={sp['lookahead']} "
          f"{sp['preset']} jobs={sp['jobs']} rate={sp['rate']} "
          f"failure_rate={sp['failure_rate']} seed={sp['seed']} quanta="
          f"{launch_sim.QUANTA}): decisions identical on cuda and cpu for pdors "
          f"and {', '.join(SIM_BASELINES)}; phase wall {on['wall']:.2f} s; "
          f"pdors warm-up run {on['warm_wall']:.4f} s")
    for row in on["rows"]:
        print(row)
    adm = on["admission"]
    print(f"online sim pdors (cuda): admission latency p50 "
          f"{adm['p50_ms']:.3f} ms p99 {adm['p99_ms']:.3f} ms mean "
          f"{adm['mean_ms']:.3f} ms over {int(adm['count'])} offers; "
          f"launches {on['launches']}; spans {on['spans']} (all on cuda)")
    print("online sim phases by self time (cuda run): " + ", ".join(
        f"{name} {row['self_s']:.4f} s/{int(row['count'])}"
        for name, row in on["top"]))
    print(f"online sim profiled pdors run: {busy_text(on['busy'], 0)}")
    (ores, owall, olaunch), (cres, cwall, _) = on["oasis"]["cuda"], \
        on["oasis"]["cpu"]
    print(f"OASiS (Fig. 6 point, R=6): admitted {len(ores.admitted)}/"
          f"{len(ores.records)} utility {ores.total_utility!r} (cpu "
          f"{cres.total_utility!r}), identical decisions; cuda wall "
          f"{owall:.4f} s, cpu {cwall:.4f} s; bundle launches {olaunch}")

    # 10. the chaos leg, a kill and recover, the elastic storm and the
    # offer service on the card, against the CPU; then one profiled chaos
    # run, last
    ch = chaos_sim(launch_sim, trace, pricing, minplus)
    s = ch["gpu"]["report"].summary
    hl = s["policy_health"]
    print(f"chaos (the sim point with bench_sim's chaos leg, pdors "
          f"resilient-wrapped): decisions, outcomes, summaries and policy "
          f"health identical on cuda and cpu; {s['machine_incidents']} "
          f"incidents, {ch['gpu']['report'].slots_run} slots, admitted "
          f"{s['jobs_admitted']}/{s['jobs_offered']}, completed "
          f"{s['jobs_completed']}, preemptions {s['preemptions']}, "
          f"evicted {s['jobs_evicted']}, utility {s['total_utility']!r}, "
          f"goodput {s['goodput_fraction']!r}, availability "
          f"{s['machine_availability']!r}, MTTR {s['mttr']!r}; resilient "
          f"offers {hl['offers']}, solver faults {hl['solver_faults']}, "
          f"retries {hl['retries']}, retry recoveries "
          f"{hl['retry_recoveries']}, fallbacks {hl['fallbacks']} "
          f"({hl['fallback_admits']} admitted)")
    adm = ch["admission"]
    print(f"chaos pdors: cuda wall {ch['gpu']['wall']:.4f} s = "
          f"{SIM_POINT['jobs'] / ch['gpu']['wall']:.2f} jobs/s, cpu wall "
          f"{ch['cpu_wall']:.4f} s; admission latency p50 "
          f"{adm['p50_ms']:.3f} ms p99 {adm['p99_ms']:.3f} ms; launches "
          f"{ch['launches']}; spans {ch['spans']} (all on cuda); "
          f"overcommit checks (whole-ledger host copies) "
          f"{ch['overcommit_checks']}; phase wall {ch['wall']:.2f} s")
    rc = recover_sim(launch_sim, pricing, minplus, ch["gpu"])
    print(f"recover (checkpoint every {RECOVER['checkpoint_every']} slots, "
          f"killed at slot {RECOVER['kill_at']}): {rc['checkpoints']} "
          f"checkpoints taken across the killed run and the recovery, "
          f"restored from slot {rc['slot']} ({rc['consumed']} events "
          f"consumed); killed run {rc['killed_wall']:.4f} s, "
          f"recovery {rc['wall']:.4f} s; summary, slots, outcomes and "
          f"ledger equal the uninterrupted cuda run's; checkpoint and "
          f"restored ledgers on the card; launches {rc['launches']}")
    el = elastic_sim(launch_sim, trace, pricing, minplus)
    s = el["gpu"]["report"].summary
    ep = ELASTIC_POINT
    print(f"elastic (H={ep['machines']} W={ep['lookahead']} {ep['preset']} "
          f"jobs={ep['jobs']} rate={ep['rate']} failure_rate="
          f"{ep['failure_rate']}, bench_sim's ELASTIC_KNOBS, pdors): "
          f"batched == event on cuda bit for bit, batched identical on cuda "
          f"and cpu; reshapes {s['reshapes']}, admitted "
          f"{s['jobs_admitted']}/{s['jobs_offered']}, deadlines "
          f"{s['deadline_hits']}/{s['deadline_jobs']}, SLOs "
          f"{s['slo_hits']}/{s['slo_jobs']}, utility "
          f"{s['total_utility']!r}; batched cuda {el['gpu']['wall']:.4f} "
          f"s, event cuda {el['event_wall']:.4f} s, batched cpu "
          f"{el['cpu_wall']:.4f} s; launches {el['launches']}; spans "
          f"{el['spans']} (all on cuda); phase wall {el['wall']:.2f} s")
    sv2 = service_sim(launch_sim, pricing, minplus)
    lat = sv2["latency"]
    print(f"service (H={SERVICE_POINT['machines']} W="
          f"{SERVICE_POINT['lookahead']} {SERVICE_POINT['preset']}, "
          f"{sv2['jobs']} jobs in chunks of {launch_sim.SERVICE_CHUNK}, "
          f"batch window {launch_sim.SERVICE_WINDOW * 1e3} ms): admitted "
          f"{sv2['admitted']}/{sv2['jobs']} in {sv2['batches']} batches "
          f"(sizes {sv2['sizes']}), identical to offer_batch on cpu per "
          f"batch; {sv2['jobs'] / sv2['wall']:.2f} offers/s (wall "
          f"{sv2['wall']:.4f} s, cpu replay {sv2['cpu_wall']:.4f} s), "
          f"admission latency p50 {lat['p50_ms']:.3f} ms p99 "
          f"{lat['p99_ms']:.3f} ms mean {lat['mean_ms']:.3f} ms; launches "
          f"{sv2['launches']}")
    cp = chaos_profiled(launch_sim, trace)
    print(f"chaos profiled pdors run: {busy_text(cp['busy'], 0)}")
    print("chaos phases by self time (profiled cuda run): " + ", ".join(
        f"{name} {row['self_s']:.4f} s/{int(row['count'])}"
        for name, row in cp["top"]))
    paths = {"chaos": ch, "recover": rc, "elastic": el, "service": sv2}
    wide_norms = {
        "qwen3_32b": {"prefill_shape": rwide["4096x5120"],
                      "decode_shape": rwide["4x5120"],
                      "qk_norm": {k: rwide[k] for k in (
                          "262144x128", "32768x128", "256x128", "32x128")}},
        "command_r_plus": {"prefill_shape": rwide["4096x12288"],
                           "decode_shape": rwide["4x12288"],
                           "train_launches": tw["launches"]["rmsnorm"],
                           "train_shape": rcmdr_train}}

    kernels = [
        {"name": "price_bundle", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/price_bundle.cu",
         "replaces": "src/repro/kernels/pricing.py:144",
         "launches": launches["price_bundle"],
         "sim_launches": on["launches"]["price_bundle"],
         **{f"{k}_launches": v["launches"]["price_bundle"]
            for k, v in paths.items()},
         "cluster_launches": {"example": ex["launches"]["price_bundle"],
                              "full_width": fw["launches"]["price_bundle"]},
         "max_abs_err": err["price_bundle"], **bnum},
        {"name": "minplus_sweep", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/minplus_sweep.cu",
         "replaces": "src/repro/kernels/minplus.py:124",
         "launches": launches["minplus_sweep"],
         "sim_launches": on["launches"]["minplus_sweep"],
         **{f"{k}_launches": v["launches"]["minplus_sweep"]
            for k, v in paths.items()},
         "cluster_launches": {"example": ex["launches"]["minplus_sweep"],
                              "full_width": fw["launches"]["minplus_sweep"]},
         "max_abs_err": err["minplus_sweep"], **snum},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:35",
         "launches": sv["launches"]["rmsnorm"],
         "max_abs_err": merr["rmsnorm"], **rnum, "decode_shape": rdec,
         "serving_split": sv["rmsnorm_split"],
         "phi35_moe": {"launches": moe_sv["launches"]["rmsnorm"],
                       "prefill_shape": rmoe, "decode_shape": rmoe_dec,
                       "serving_split": moe_sv["rmsnorm_split"]},
         **{key: {"launches": sv_["launches"]["rmsnorm"],
                  "serving_split": sv_["rmsnorm_split"],
                  **wide_norms.get(key, {})}
            for key, sv_ in served.items()},
         "mla_norms": rmla, "ssm_hybrid_encdec_norms": rnew,
         "gemma_7b_train": {"launches": tr["launches"]["rmsnorm"],
                            "parity_launches": tp["launches"]["rmsnorm"],
                            "train_shape": rtrain},
         "cluster": {"example_launches": ex["train_launches"]["rmsnorm"],
                     "full_width_launches": fw["train_launches"]["rmsnorm"],
                     "qwen3_qk_norm": rqk}},
        {"name": "rmsnorm_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
         "replaces": "src/repro/kernels/rmsnorm.py:35",
         "gradient_of": "src/repro/models/layers.py:35 (jax.grad)",
         "launches": tr["launches"]["rmsnorm_bwd"],
         "parity_launches": tp["launches"]["rmsnorm_bwd"],
         "max_abs_err": berr, **bnum_train,
         "cluster": {"example_launches": ex["train_launches"]["rmsnorm_bwd"],
                     "full_width_launches":
                     fw["train_launches"]["rmsnorm_bwd"],
                     "qwen3_qk_norm": bqk},
         "command_r_plus_train": {"launches": tw["launches"]["rmsnorm_bwd"],
                                  **bcmdr_train}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
         "replaces": "src/repro/kernels/flash_attention.py:94",
         "launches": sv["launches"]["flash_attention"],
         "max_abs_err": merr["flash_attention"],
         **{k: v for k, v in fnum.items() if k != "float32"},
         "phi35_moe": {"launches": moe_sv["launches"]["flash_attention"],
                       **fmoe},
         **{key: {"launches": served[key]["launches"]["flash_attention"],
                  **f} for key, f in fgqa.items()},
         "llava_next": {"launches":
                        served["llava_next"]["launches"]["flash_attention"],
                        **fvlm},
         "hymba_1_5b": {"launches":
                        served["hymba_1_5b"]["launches"]["flash_attention"],
                        "sliding": fnew["hymba_sliding"],
                        "global": fnew["hymba_global"]},
         "seamless_m4t_medium": {
             "launches": served["seamless_m4t_medium"]["launches"][
                 "flash_attention"],
             "encoder": fnew["seamless_encoder"],
             "cross": fnew["seamless_cross"],
             "decoder": fnew["seamless_decoder"]},
         **{f"{key}_launches": served[key]["launches"]["flash_attention"]
            for key in ("minicpm3_4b", "deepseek_v2", "mamba2_780m")}},
        # the float32 route: the 2-layer float32 parity cuts run it on the
        # card (launches: the Gemma-7B cut's, then each cut's)
        {"name": "flash_attention_f32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:94",
         "launches": pa["launches"]["flash_attention"],
         "max_abs_err": merr["flash_attention_f32"], **fnum["float32"],
         "hymba_sliding": fnew["hymba_sliding_float32"],
         "parity_launches": {
             "phi35_moe": moe_pa["launches"]["flash_attention"],
             **{key: pa_["launches"]["flash_attention"]
                for key, pa_ in parities.items()}}},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
