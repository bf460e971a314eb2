#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then:

1. prints the card (``nvidia-smi`` name and power limit) and turns TF32 off;
2. holds the paged decode kernel (A) against its plain PyTorch version on
   the card (SLM and hymba shapes, GQA, a window, scattered pages, an idle
   slot, lengths that end mid-page, one slot of 4,096 keys; bf16 and f32),
   at the chosen cluster size and at every forced one (1, 2, 4, 8), bf16
   on both walks (the tensor-core "mma" and the FMA "fma");
3. holds the prefill attention kernel (B) against its plain version (SLM
   shapes at S in {32, 131, 256}, GQA, a window, Sq < Sk, D = 256; bf16 on
   both routes, the tensor-core "mma" and the FMA "fma", f32 on "fma";
   the output and the log-sum-exp), and
   B's output, log-sum-exp and backward kernels against the plain
   versions (the explicit backward formulas and the plain forward's
   autograd) at the round's shapes (batch 8, S = 136; the SLM's and the
   LLM's heads; bf16 and f32) and in a GQA case with a window, Sq < Sk and
   a ragged S, each row of a gradient relative to its own size (bf16 on
   the backward's tensor-core route "mma", f32 on the FMA route);
4. holds the wire codec's quantize / dequantize kernels (E, F) bit for bit
   against their plain versions on the card and on a CPU copy (the
   round's uplink and downlink tiles and ragged shapes, all-zero rows,
   half-way ties, qmax 127 and 7, f32 and bf16), then the fused LoRA
   projection (C) against its plain version (the SLM's and the LLM's
   projection shapes at M = 1088, ragged M/N/K, ranks 8 and 16, the
   transposed-W mode; bf16 and f32; dx, dA, dB against autograd; each
   case on the route it should take: the wgmma kernel for bf16 with K, N
   and r multiples of 8, the FMA kernel otherwise and when forced) and the
   Gram log-volume (D), forward and backward (k in {4, 8}, d = 1280,
   masked and all-zero rows, batches of 80, 81 and 130) through the
   autograd wrapper (the backward from the forward's saved dots, which
   are held against the plain dots),
   then the SSD chunk scan (G) at mamba2's and hymba's shapes, with two
   groups, over several chunks and at toy sizes (bf16 on both routes where
   the "mma" route takes the shape, f32 on "fma"), the whole
   ``ops.ssd_chunked`` against the token-by-token recurrence at ragged S
   of 1, 2 and 3 chunks, and G's output at a large |A| dt; then G's
   backward (G′) against its explicit formulas (``ssd_chunk_bwd_plain``)
   at mamba2's and hymba's training shapes (batch 8, one chunk of 256) and
   over two and three chunks with a state gradient, with two groups, bf16
   and f32, on each route that takes the case (bf16 at those shapes on
   "mma" and on "fma", the rest on "fma"), every gradient row against its
   own size; strong decay (all finite) and two launches bit-equal, on
   both routes; ``ops.ssd_chunked``'s whole backward at a ragged S of
   three chunks against the plain path's autograd with exactly one G and
   one G′ launch (f32: G′ on "fma"; bf16: on "mma");
5. serves 48 soft-prompted requests through ``ServingEngine`` at the full
   width of ``mlecs-slm-720m`` (bf16, random weights from a seed), checks
   every budget, the free lists and both launch counters, then checks the
   paged decode logits against a full forward over the same tokens;
6. prints a ``{"serving": ...}`` line, then profiles an admission tick
   and four decode steps (``torch.profiler``; kernel time against wall
   time, traces under ``build/profile/``) into a ``{"profile": ...}`` line;
7. runs one federated round of Algorithm 1 on the loop engine through
   ``FederatedRunner`` at full width (3 devices on ``mlecs-slm-720m``,
   ``mlecs-llm-6b`` on the server, both with a 1280-wide connector latent,
   the LLM at 4 of its 28 layers here and in every later round but the
   registered population's, ``ROUND_LLM_LAYERS``;
   bf16, random weights from a seed), checks losses, the frozen backbone,
   the trained leaves, the MMA weights and the launch counters of B (with
   its backward), C and D against the counts the step structure gives,
   checks that every launch of C and of B (forward and backward) took the
   tensor-core route, and prints a ``{"training": ...}`` line; then
   profiles one CCL step and one SE-CCL step into a
   ``{"training_profile": ...}`` line;
8. runs two rounds of the same federation over the int8 wire (error
   feedback on, 1 CCL + 1 AMT + 1 SE-CCL step each, no evaluation) and
   checks the exact bytes on the wire, the residuals and the decoded
   uploads against their quantization steps, the devices' copies of the
   decoded downlink and every launch counter, E and F included, and the
   tensor-core routes of C and B, into a ``{"channel": ...}`` line;
9. runs two rounds (evaluation on the second) of a heterogeneous
   federation through ``FederatedRunner(FederationSpec(...))`` on the loop
   engine at full width: 3 + 2 clients on ``mlecs-slm-720m`` (modalities
   0-1; modality 2 at rho 0.9 and batch 4) and 2 on ``qwen3-1.7b`` (28
   layers, 16 heads over 8 KV heads of 128), ``mlecs-llm-6b`` on the
   server, every model with a 1280-wide connector latent; trimmed-mean
   MMA under dropout, stragglers and one Byzantine client scaling its
   upload by 10.  Checks finite metrics, offline clients untouched and
   present ones moved, the frozen backbones shared and unwritten, the
   server SLM's aggregate against a float64 host recomputation of the
   trimmed cross-cohort combine of the same uploads (to bf16 rounding),
   the bytes on the wire per present client and cohort, exact launch
   counts from the step structure and the tensor-core routes; then
   ``CohortServer`` serves 8 soft-prompted requests a cohort from the
   trained parameters (merged), checks budgets, free lists and the A / B
   launch counts, holds qwen3's prefill -> decode logits against a full
   forward, and times A at qwen3's fullest decode step; prints a
   ``{"heterogeneous_round": ...}`` line;
10. holds the grouped form of C (one launch for the G clients of a
   cohort, each on its own adapter) against its plain version and against
   G ungrouped launches (bit-equal where both take one tile shape), forward
   and dx, at the SLM's round shape (G 3 x 1088 rows), qwen3's (G 2, N
   1024), a group of 136 rows and on the FMA route in f32, with its
   gradients and a planted adapter swap that must fail; then runs one
   evaluated round of the training configuration on the loop engine and
   one on the vectorized engine (``engine="vectorized"``: each local step
   one stacked step for the cohort) from the same seed's states, checks
   each round's exact launch counts (B, B', C and D once per cohort step
   on the vectorized engine, client eval once per padded batch of the
   cohort), the tensor-core routes, the frozen backbone, and the two
   rounds' summaries and LoRA leaves against each other; then one stacked
   CCL step against the loop engine's three from per-client, non-zero
   LoRA B (losses, gradients row by row, updated leaves), with client 0
   given client 1's adapter as a planted fault that must fail, and the
   same gradients once more at f32 on the same state, batches and
   anchors (TF32 off); prints a ``{"vectorized_round": ...}`` line (round
   wall time, ms per step and peak memory per engine, launches per kernel
   per engine);
11. runs the port's distribution at world size 1: an NCCL process group
   (``file://`` store in a temporary directory, ``NCCL_SOCKET_IFNAME=lo``)
   and ``make_federated_mesh()``; one evaluated round of the training
   configuration on the vectorized engine without and with ``mesh=``,
   then the overlap engine (staleness 0) on two cohorts at reduced depth
   (6 SLM' layers x 2 clients, 4 QWEN' layers x 2, 4 LLM' layers) without
   and with ``make_cohort_meshes(2)``: each pair bit-equal (summaries and
   every leaf) with equal launches by kernel and route, exact counts;
   ``moe_mlp_sharded`` in a sharding context against ``moe_mlp`` on one
   phi3.5-moe layer at full width (4 x 512 tokens): equal at f32, the
   bf16 gap printed; ``mma_psum_weights`` over the data group against its
   single-shard value; prints a ``{"distribution": ...}`` line (round
   seconds with and without the mesh, the bytes gathered a round) and
   destroys the group;
12. runs the port past one rank: spawns two ranks (``torch.
   multiprocessing``, spawn; before phase 11, so that they start and run
   beside it) of a gloo group from a ``file://`` store,
   both on cuda:0 (NCCL takes no two ranks on one device), which load the
   kernels the build made; each checks that gloo takes CUDA tensors for
   ``all_gather``, ``all_reduce``, ``broadcast`` and ``barrier``; then
   (a) the registered population at data size 2 (8 registered
   ``mlecs-slm-720m`` clients at full width and depth, 4 sampled a round,
   2 a rank; ``mlecs-llm-6b`` at 4 of its 28 layers; trimmed mean under
   faults, int8 with error feedback): rounds 0 and 1 unevaluated, a
   checkpoint (rank 0 writes), round 2 evaluated, then fresh runners load
   it and run round 2 again, bit for bit; (b) the overlap engine at
   staleness 1 on ``make_cohort_meshes(2)`` (the distribution phase's two
   cohorts at reduced depth), the server chain on rank 1 only; (c)
   ``moe_mlp_sharded`` on (data, model) = (1, 2) on one phi3.5-moe layer
   at full width, f32, capacity that drops nothing: y, aux and the
   gradients of x, the router and every expert weight against
   ``moe_mlp``'s, row by row at 2e-4 of each row's largest; every round's
   exact launches on each rank's own plan.  Here, at world size 1: (a)'s
   rounds held to rank 0's within 1e-5 (the largest gaps printed) and the
   world-2 checkpoint loaded and round 2 run again; (b)'s two rounds held
   to the ranks' (clients from rank 0, server from rank 1), the ranks'
   launches adding up to world 1's kernel by kernel; a failed rank fails
   the phase at once (the others are killed), a rank that runs past
   ``RANKS_TIMEOUT`` fails it too; each rank notes its progress on
   standard error; prints a ``{"distribution_ranks": ...}`` line;
13. drives the registered population on the vectorized engine: one
   cohort of 24 ``mlecs-slm-720m`` clients registered in the client store,
   3 sampled a round (``ParticipantSampler``), ``mlecs-llm-6b`` at all
   its 28 layers on the server, trimmed-mean MMA under the heterogeneous phase's faults, the
   int8 wire with error feedback (the residuals ride in the store and the
   checkpoint), 1 CCL + 1 AMT + 1 SE-CCL step a round; runs rounds 0 and
   1 unevaluated, saves a checkpoint (after checking the temporary
   directory's free space; its bytes and save seconds printed), runs
   round 2 evaluated; a fresh runner from the same seed loads the
   checkpoint (seconds printed) and runs round 2 again, which must be bit
   for bit the first (participants, summary, the participants' store
   entries, the server SLM's LoRA); a runner of 8 clients with its store
   spilled to disk runs round 0, and the device memory at the round's end
   must equal the 24 clients' within 1 % with a store of exactly 8/24 of
   their bytes; a loop-engine runner's round 0 from the same seed is held
   against the vectorized one's (summaries and LoRA leaves under the
   vectorized phase's bounds); every round's exact launches (counted over
   the working set) and tensor-core routes; prints a
   ``{"population_rounds": ...}`` line;
14. drives the overlap engine on the training configuration at 1 CCL + 1
   AMT + 1 SE-CCL step a round: a vectorized runner and an
   ``engine="overlap", staleness=0`` runner from one seed run two
   evaluated rounds each and are held against each other (bit-equal, else
   within the vectorized phase's bounds with the differing leaves
   listed); then a ``staleness=1`` runner over the sketch codec
   (``ChannelSpec(codec="sketch", sketch_rank=8)``, uplink and downlink)
   runs rounds 0 and 1 unevaluated and round 2 evaluated: no delivery
   after round 0, one identical delivery on every client after round 1,
   one server output always pending, ``comm_stats`` against the bytes
   computed from the leaf shapes, every basis orthonormal on the card and
   equal to the host's, a decoded leaf a fixed point of the codec, the
   anchor model on the server LLM's own frozen tensors, the peak memory
   within 1 GB of the vectorized runner's; every round's exact launches
   (the vectorized engine's count) and tensor-core routes, its wall time
   to ``sync()`` and to ``drain()``; prints an ``{"overlap_rounds":
   ...}`` line (the server stream's use, the drain time);
15. serves 24 soft-prompted requests each on ``mamba2-2.7b`` (16 of its
   64 layers, ``MAMBA2_LAYERS``, here and wherever mamba2 runs; prompts of
   20-700 tokens, no pages) and ``hymba-1.5b`` (20-1200, the window
   bites) at full width, checks budgets, free lists and exact launch
   counts (G 16 per mamba2 admission; B and G 32 per hymba admission,
   A 32 per decode step), every A, B and G launch on the "mma" route (SLM
   serving too), records hymba's fullest decode step for row A, holds
   prefill -> decode at exact length against a full
   forward on the served weights upcast to f32 (B and G on "fma") and the
   bf16 run inside the bf16 forward's own distance from f32 (on "mma"),
   profiles an
   admission tick and four decode steps, and prints ``{"ssm_serving":
   ...}`` and ``{"hybrid_serving": ...}`` lines;
16. trains the ssm and hybrid families: one ``FederationSpec`` at full
   width (bf16, remat, identity wire) of 3 ``mamba2-2.7b`` clients (16
   layers) on modalities 0-1 and 2 ``hymba-1.5b`` clients on modality 2,
   ``mlecs-llm-6b`` (4 layers) on the server (the server SLM is the mamba2 model, so
   SE-CCL runs G′ too), every model with a 1280-wide connector latent,
   batch 8, 1 CCL + 1 AMT + 1 SE-CCL step; one evaluated round on the
   vectorized engine (after an evaluation before it), then one on the
   loop engine from the same seed's states; checks each round's exact
   launches (G twice a layer of a trained pass under remat and G′ once,
   once a layer of an eval pass; C's FMA launches exactly those at
   hymba's in_proj, whose N = 6,482 is no multiple of 8, every other
   launch on the tensor-core routes), the frozen backbones, every
   trainable leaf finite and moved (but the LLM's LoRA A, which one
   SE-CCL step from B = 0 cannot reach), and the two rounds' summaries
   and leaves against each other; prints an ``{"ssm_training": ...}``
   line (round wall time, ms per step per cohort, peak memory,
   ``avg_ce`` / ``server_ce`` before and after, launches per route);
17. serves on the ring cache through ``launch/serve.py:generate`` at full
   width and published depth but mamba2's (bf16, random weights from a
   seed): ``mlecs-slm-720m`` (8 rows of 256 tokens), ``mamba2-2.7b`` (16
   layers; 8 of 300)
   and ``hymba-1.5b`` (4 of 1,100: its 1024 window bites), 32 tokens a
   row, once with merge=True on the unmerged weights and once counted on
   the merged ones (equal tokens), each beside ``ServingEngine`` on the
   same prompts (greedy agreement printed); exact launches (B and G once
   a layer of a prefill, A once an attention layer of a decode step) on
   the tensor-core routes; tokens/s, decode-step and prefill ms; then, on
   one row, prefill -> 8 teacher-forced decode steps on the ring path and
   on the paged path against one full forward, on the weights upcast to
   f32 (``E2E_TOL``; ring against paged ``RING_PAGED_TOL_F32``) and on
   the bf16 weights (ring against paged ``E2E_TOL``); then A on the SLM's
   full ring of 288 slots against the same keys as pages of 16 (the same
   capacity); prints a ``{"ring_serving": ...}`` line;
18. serves the registry's ``gemma-2b`` (8 / 1 heads of 256: every A
   launch on the FMA walk, which ``check_tensor_core_routes`` expects
   exactly), ``gemma3-1b`` (window 512), ``internvl2-1b`` (256 frontend
   tokens of 1024 from a seed) and ``granite-20b`` (40.6 GB of weights,
   after every earlier phase's memory is released) at full width and
   published depth as phase 17 does (4 rows of 590 tokens, 24 new; f32
   consistency on granite's first 13 layers), each model's peak memory,
   granite's decode step beside the bound of reading its weights once;
   A at gemma-2b's and granite's fullest engine step and B at gemma3's
   local layers (SDPA with the window as a mask beside it); prints a
   ``{"registry_serving": ...}`` line;
19. serves the moe and encdec families as phase 18 does, each after the
   memory of what ran before is released: ``phi3.5-moe-42b-a6.6b`` (16 of
   its 32 layers, 21.1 B parameters) and ``qwen3-moe-235b-a22b`` (8 of
   94, 21.2 B; 64 / 4 heads of 128) at full width, 4 rows of 590 tokens,
   24 new, at their own capacity factor; their f32 and bf16 consistency
   checks on ``no_drop`` (capacity_factor = n_experts / top_k: a call
   drops nothing, so paths with different token counts compute the same
   function), f32 on their first 4 and 2 layers; their decode steps
   beside the bound of reading every expert's weights once;
   ``whisper-medium`` at full width and depth (24 + 24 layers) behind
   1,536 stub frames of 1024 from a seed, 4 rows of 128 tokens (B once an
   encoder layer and twice a decoder layer of a prefill, A twice a
   decoder layer of a step: self- and cross-attention); A at qwen3-moe's
   fullest engine step, whisper's decode cross-attention on A (the
   path's) against B at Sq = 1, and B at whisper's encoder (no mask, 4 x
   1,536 frames); prints a ``{"moe_encdec_serving": ...}`` line;
20. trains through the trainer (``launch/train.py``) at full width,
   bf16, each model after the memory of what ran before is released:
   the paper's SLM (36 layers, connector latent 1280) through
   ``run_training`` over ``batches`` of the corpus (8 x 256 tokens,
   modality features), 8 LoRA-only AdamW steps (the CE on the first batch
   falls; every frozen leaf bit-unchanged) and 3 of a full fine-tune
   (every leaf moved; C's dW a ``torch.matmul``), each run's peak memory
   and step lines; gemma-2b (18 layers, vocab 256,000) from one set of
   params and two batches of 4 x 1,024 tokens, 2 steps on the full CE and
   2 on the chunked CE (``loss_chunk`` 512): losses within 1e-3, the
   LoRA / connector gradients row by row within 2e-2, each path's peak
   memory; phi3.5-moe (8 of 32 layers, 10.7 B parameters; 4 x 512, 4
   steps on one batch: aux > 0, the batch's CE falls) and whisper-medium
   (24 + 24 layers, 4 x 128 tokens behind 1,536 stub frames, modality
   features, 4 steps on one batch: the CE falls, the encoder's LoRA
   leaves move, the soft-prompt leaves the family does not read do
   not); then one stacked step (``ccl.make_stacked_step``, SGD) of 3
   clients x 2 x 256 against their 3 loop steps at f32 on qwen3-moe (2
   of 94 layers: each client routes alone) and whisper (2 + 2): every
   updated leaf row by row within 1e-4; exact launches of every case
   (bf16 on the tensor-core routes, f32 on FMAs); then B and B' at
   whisper's encoder and cross-attention and gemma-2b's training shape
   beside SDPA, C at gemma-2b's q projection beside the dW matmul, D at
   the SLM trainer's CCL loss; prints a ``{"trainer": ...}`` line;
21. runs the dry run (``launch/dryrun.py``) on the host's CPU in two
   processes started before the build and joined after the kernel checks
   (each starts a fake process group, which the NCCL group of this
   process rules out here): ``python -m repro_torch.launch.dryrun`` for gemma-2b
   at decode_32k over 256 fake ranks (the reference's keys, every
   roofline term finite and non-negative), and ``dryrun_one`` of the
   trainer phase's gemma-2b step (4 x 1,024) at a (1, 1) fake mesh on the
   full and the chunked CE, whose argument bytes must equal exactly those
   of the step's params, AdamW state and batch made on the card; prints
   the peak each predicts beside the trainer phase's measured one in a
   ``{"dryrun": ...}`` line;
22. prints ``{"phase_seconds": ...}`` and a ``{"kernels": [...]}`` line
   (times from CUDA-graph replay, bounds from this run's inputs; rows
   A-G and G′, each with its launches on the main paths; the rows of the five
   two-route kernels, A, B, B's backward, C and G, also time their FMA
   route on the same inputs, ``ms_fma_route``; the rows of D (forward and
   backward) and E time an empty kernel launched as the kernel launches,
   ``launch_floor_ms``, replayed in turn with it (D's rows also one wide
   sample, at the split the rule picks for it); row A, at the SLM's,
   hymba's and qwen3's fullest decode step (``at_other_shapes``), also
   times every forced cluster size, ``ms_by_splits`` and ``ms_splits1``,
   and at the SLM's ring, gemma-2b's, granite-20b's and qwen3-moe's
   shapes and whisper-medium's cross cache (beside B at Sq = 1);
   rows B, B's backward and C also at qwen3's training shapes, B at
   gemma3-1b's windowed local layers and whisper's encoder, C also at
   mamba2's and hymba's in_proj (the latter on the FMA route); the row
   of C's grouped form at G 3 x 1088 x 1280 x 1280 beside three ungrouped
   launches of the same work, ``ungrouped_x3_ms``).

Standard error gets a line as each phase ends, with its seconds from the
start; a watchdog stops the run ``WATCHDOG_S`` (1,170) s after the start
with the last phase that ended and every thread's stack, and exit code 3.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no result; it also exits
non-zero when CUDA is unavailable or the port's sources are missing.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's data-sheet rates (700 W): device memory, dense bf16 on
# the tensor cores, f32 outside them
from repro_torch.launch.mesh import (  # noqa: E402
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOP_PER_S,
    PEAK_FLOPS_F32 as F32_FLOP_PER_S)
F32_TOL = dict(atol=2e-4, rtol=2e-4)
# kernel and plain version both round one f32 result to bf16: <= 1-2 ulp
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
# paged decode vs full forward at bf16 (tests/test_serving.py's bound):
# the two paths round bf16 products at different shapes
E2E_TOL = dict(atol=6e-2, rtol=5e-2)
NO_TOL = dict(atol=math.inf, rtol=0.0)     # measure only (finite values)

CARD = {}


def emit(obj):
    """Print one JSON line that carries the card's name and power limit."""
    print(json.dumps({**obj, **CARD}), flush=True)


def check_close(name, got, want, tol):
    import torch
    err = (got.float() - want.float()).abs()
    bound = tol["atol"] + tol["rtol"] * want.float().abs()
    bad = int((err > bound).sum())
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    if bad:
        raise AssertionError(f"{name}: {bad} elements out of tolerance "
                             f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def graph_ms(fn, n_calls=20, reps=5):
    """Median device ms per call: ``n_calls`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events (no host launch
    cost in the number)."""
    return graphs_ms({"": fn}, n_calls, reps)[""]


def graphs_ms(fns, n_calls=20, reps=5):
    """``graph_ms`` of each of ``fns`` (name -> fn), the replays taken in
    turn (one of each per rep), so that a drift of the card's clocks
    falls on every version alike: {name: median ms per call}."""
    import torch
    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn(0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(n_calls):
                fn(i)
        graph.replay()
        graphs[name] = graph
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, graph in graphs.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / n_calls)
    del graphs
    return {name: statistics.median(t) for name, t in times.items()}


def _bound(bytes_, flops, flop_rate=BF16_FLOP_PER_S):
    """(least ms, what bounds it): the bytes moved over the memory rate
    against the operations over ``flop_rate``."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 1: card

def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name, power = [s.strip() for s in smi.split(",", 1)]
    CARD.update(card=name, power_limit=power)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32})


def ptxas_report(log, key_of):
    """{key: {"registers", "spill_store_bytes"}} from one source's
    ``-Xptxas=-v`` report: ``key_of(mangled entry name)`` names the
    kernel's key (None: not reported), and a key that several instances
    share keeps their largest numbers."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = key_of(m.group(1))
            continue
        if cur:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("spill_store_bytes",
                              r"(\d+) bytes spill stores")):
                hit = re.search(pat, line)
                if hit:
                    slot = out.setdefault(cur, {})
                    slot[key] = max(slot.get(key, 0), int(hit.group(1)))
    return out


def tensor_core_kernels(log):
    """``ptxas_report`` of each tensor-core kernel (a name that holds
    "mma": mma.sync or wgmma), keyed kernel<template argument>."""
    import re

    def key_of(fn):
        name = re.search(r"\d+([a-z_]+_w?mma[a-z_]*)", fn)
        arg = re.search(r"mma[a-z_]*ILi(\d+)E", fn)
        return name and name.group(1) + (f"<{arg.group(1)}>" if arg else "")
    return ptxas_report(log, key_of)


def paged_kernels(log):
    """``ptxas_report`` of A at the served models' dtype and head size,
    keyed "<walk> bf16 D64" over its head-chunk instances."""
    import re

    def key_of(fn):
        m = re.search(r"paged_attention_kernelI13__nv_bfloat16Li64ELi\d+"
                      r"ELb([01])E", fn)
        return m and ("mma" if m.group(1) == "1" else "fma") + " bf16 D64"
    return ptxas_report(log, key_of)


def phase_build():
    import re
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    report, tensor_core = {}, {}
    for name in _build.sources():
        log = _build.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        report[name] = {"max_registers": max(regs, default=None),
                        "max_spill_store_bytes": max(spills, default=None)}
        tensor_core.update(tensor_core_kernels(log))
    paged = paged_kernels(_build.build_log("paged_attention"))
    if not paged or any(v.get("spill_store_bytes") for v in paged.values()):
        raise AssertionError(f"paged_attention spills at D 64 bf16: {paged}")
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": report, "ptxas_tensor_core_kernels": tensor_core,
          "ptxas_paged_attention": paged})


# ---------------------------------------------------------------------------
# phase 2 / 3: kernels against their plain versions

def paged_case(gen, B, H, K, D, ps, M, dtype, window=0, idle=True,
               lens=None):
    """Scattered, non-monotone page ids; lens ending mid-page; one idle
    slot (or the given ``lens``)."""
    import torch
    dev = "cuda"
    P = B * M + 1
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, ps, K, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, ps, K, D), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = perm[:B * M].reshape(B, M).int().contiguous()
    if lens is not None:
        lens = torch.tensor(lens, device=dev)
    else:
        lens = torch.randint(1, M * ps + 1, (B,), generator=gen, device=dev)
        lens[1] = M * ps - ps // 2          # ends mid-page
        lens[2] = ps + 1                    # one entry into the second page
        if idle:
            lens[0] = 0                     # idle slot: zeros, not NaN
    return q, kp, vp, bt, lens.int().contiguous(), window


# A's cases: the SLM's and hymba's decode (hymba: H 25 in 5 KV groups, the
# local layers' 1024 window and the global layers' none, lens up to 1280),
# one slot of 4,096 keys, GQA with a window, D 256, and qwen3's cohort
# serving (16 heads over 8 KV groups of D 128, 8 slots of up to 21 pages)
PAGED_CASES = {
    "slm": dict(B=16, H=20, K=20, D=64, ps=16, M=32),
    "slm_window": dict(B=16, H=20, K=20, D=64, ps=16, M=32, window=100),
    "gqa_window": dict(B=8, H=8, K=2, D=64, ps=16, M=12, window=37),
    "gqa_d256": dict(B=4, H=16, K=4, D=256, ps=8, M=6),
    "hymba_local": dict(B=16, H=25, K=5, D=64, ps=16, M=80, window=1024),
    "hymba_global": dict(B=16, H=25, K=5, D=64, ps=16, M=80),
    "one_slot_4096": dict(B=1, H=20, K=20, D=64, ps=16, M=256,
                          lens=[4096]),
    "qwen3": dict(B=8, H=16, K=8, D=128, ps=16, M=21),
}


def phase_paged_checks():
    """A against its plain version in every case, at the chosen cluster
    size and at every forced one, on the walk the route function picks
    and (bf16) on the forced FMA walk; idle slots exact zeros."""
    import torch
    from repro_torch.kernels.paged_attention import (SPLITS,
                                                     paged_attention_cuda,
                                                     paged_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for name, kw in PAGED_CASES.items():
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            args = paged_case(gen, dtype=dtype, **kw)
            want = paged_attention_plain(*args)
            idle = args[4] == 0
            routes = (None, "fma") if dtype == torch.bfloat16 else (None,)
            for splits in (None, *SPLITS):
                for route in routes:
                    got = paged_attention_cuda(*args, splits=splits,
                                               route=route)
                    torch.cuda.synchronize()
                    tag = (f"{name}/{str(dtype)[6:]}/S{splits or 'auto'}"
                           f"/{route or 'auto'}")
                    results[tag] = check_close(f"paged {tag}", got, want,
                                               tol)
                    if bool(idle.any()) and \
                            float(got[idle].float().abs().max()) != 0.0:
                        raise AssertionError(f"paged {tag}: idle slot not "
                                             "zero")
    emit({"phase": "paged_attention_vs_plain", "cases": len(results),
          "max_abs_err": max(results.values()), "by_case": results})


def route_delta(fn, before):
    """Launches of ``fn`` per route since the ``before`` snapshot of its
    ``launches_by_route``, the routes that took none left out."""
    return {r: n - before[r] for r, n in fn.launches_by_route.items()
            if n != before[r]}


def phase_flash_checks():
    """B's forward against its plain version: bf16 on both routes (the
    route function's "mma" and the forced "fma"), f32 on "fma"; the output
    and the log-sum-exp."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_attention_route)
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = {f"slm_s{s}": dict(H=20, K=20, D=64, Sq=s, Sk=s)
             for s in (32, 131, 256)}
    cases.update({
        "gqa_s131": dict(H=8, K=2, D=64, Sq=131, Sk=131),
        "window48_s256": dict(H=20, K=20, D=64, Sq=256, Sk=256, window=48),
        "sq40_sk131": dict(H=20, K=20, D=64, Sq=40, Sk=131),
        "d256_s131": dict(H=4, K=4, D=256, Sq=131, Sk=131),
    })
    results = {}
    for name, kw in cases.items():
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            q = torch.randn((1, kw["Sq"], kw["H"], kw["D"]), generator=gen,
                            device="cuda").to(dtype)
            k = torch.randn((1, kw["Sk"], kw["K"], kw["D"]), generator=gen,
                            device="cuda").to(dtype)
            v = torch.randn(k.shape, generator=gen, device="cuda").to(dtype)
            w = kw.get("window", 0)
            want, want_lse = flash_attention_plain(q, k, v, causal=True,
                                                   window=w, with_lse=True)
            chosen = flash_attention_route(q, k, v)
            if chosen != ("mma" if dtype == torch.bfloat16 else "fma"):
                raise AssertionError(f"flash {name}: route {chosen}")
            for route in dict.fromkeys((chosen, "fma")):
                before = dict(flash_attention_cuda.launches_by_route)
                got, lse = flash_attention_cuda(q, k, v, causal=True,
                                                window=w, with_lse=True,
                                                route=route)
                if route_delta(flash_attention_cuda, before) != {route: 1}:
                    raise AssertionError(f"flash {name}: not on {route}")
                torch.cuda.synchronize()
                tag = f"{name}/{str(dtype)[6:]}/{route}"
                results[tag] = check_close(f"flash {tag}", got, want, tol)
                results[f"lse/{tag}"] = check_close(f"flash lse {tag}", lse,
                                                    want_lse, LSE_TOL)
    emit({"phase": "flash_attention_vs_plain", "max_abs_err": results,
          "tolerance": {"bfloat16": BF16_TOL, "float32": F32_TOL,
                        "lse": LSE_TOL}})


# ---------------------------------------------------------------------------
# phase 4: the serving engine at full width

N_REQUESTS = 48


def make_requests(cfg, params, seed=0, n=N_REQUESTS, lo=20, hi=240,
                  fixed=()):
    """``n`` prompts (lengths lo-hi, the first ones set to ``fixed``,
    budgets 16-64) with 8-token soft prompts from the connector on random
    modality features and availability."""
    import numpy as np
    import torch
    from repro_torch.core.connector import connector_prefix
    rng = np.random.RandomState(seed)
    lens = rng.randint(lo, hi + 1, n)
    lens[:len(fixed)] = fixed
    budgets = rng.randint(16, 65, n)
    prompts = [rng.randint(0, cfg.vocab_size, k).astype(np.int32)
               for k in lens]
    feats = rng.randn(n, cfg.n_modalities, cfg.modality_dim).astype(np.float32)
    mask = rng.rand(n, cfg.n_modalities) < 0.6
    for i in np.nonzero(~mask.any(1))[0]:
        mask[i, rng.randint(cfg.n_modalities)] = True
    with torch.no_grad():
        soft, _, _ = connector_prefix(params["connector"], cfg,
                                      torch.from_numpy(feats).cuda(),
                                      torch.from_numpy(mask).cuda())
    if soft.shape != (n, cfg.n_soft_tokens, cfg.d_model):
        raise AssertionError(f"soft prompt shape {tuple(soft.shape)}")
    if not torch.isfinite(soft.float()).all():
        raise AssertionError("non-finite soft prompt")
    return [(prompts[i], int(budgets[i]), soft[i]) for i in range(n)]


def phase_serving():
    import numpy as np
    import torch
    from repro_torch.configs.mlecs_paper import SLM
    from repro_torch.core.connector import init_unified
    from repro_torch.core.lora import flatten, is_lora_leaf
    from repro_torch.launch.serve_engine import EngineConfig, ServingEngine
    from repro_torch.models import transformer
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.model import build_model

    cfg = SLM
    bundle = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_unified(gen, bundle)
    for path, leaf in flatten(params).items():     # make merge_lora real work
        if path.endswith("_lora_b"):
            leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                   device="cuda") * 0.02)
    econf = EngineConfig(n_slots=16, page_size=16, n_pages=1024,
                         max_pages_per_seq=32, max_out=64,
                         buckets=(32, 64, 128, 256))
    engine = ServingEngine(bundle, params, econf)
    merged = engine.params
    if any(is_lora_leaf(p) for p in flatten(merged)):
        raise AssertionError("merged params still carry adapters")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = make_requests(cfg, params)

    # warm-up (cuBLAS handles, first launches): 4 requests, one per bucket
    for i in np.argsort([len(r[0]) for r in reqs])[::12][:4]:
        engine.submit(reqs[i][0], max_new=4, prefix_embeds=reqs[i][2])
    engine.run()
    torch.cuda.synchronize()
    base = dict(steps=engine.n_steps, prefills=engine.n_prefills,
                dec=engine.decode_seconds, pre=engine.prefill_seconds)

    # the main path, counted
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rids = [engine.submit(t, max_new=m, prefix_embeds=s) for t, m, s in reqs]
    snap, best = None, -1
    while engine.busy:
        engine.tick()
        sd = engine.sched
        lens = torch.where(sd["active"], sd["seq_lens"] + 1, 0).int()
        total = int(lens.sum())
        if total > best:        # the step with the most cached tokens
            best = total
            snap = (sd["block_tables"].clone(), sd["seq_lens"].clone(),
                    sd["active"].clone())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    routes = check_tensor_core_routes("serving")
    others = {n: v for n, v in launches.items()
              if v and n not in ("paged_attention", "flash_attention")}
    if others:
        raise AssertionError(f"serving launched other kernels: {others}")
    steps = engine.n_steps - base["steps"]
    prefills = engine.n_prefills - base["prefills"]

    # checks of the run
    V = padded_vocab(cfg)
    n_tokens = 0
    for rid, (_, budget, _) in zip(rids, reqs):
        out = engine.finished[rid].out
        if len(out) != budget:
            raise AssertionError(f"request {rid}: {len(out)} tokens, "
                                 f"budget {budget}")
        if out.min() < 0 or out.max() >= V:
            raise AssertionError(f"request {rid}: token id out of range")
        n_tokens += len(out)
    if sorted(engine._free_pages) != list(range(1, econf.n_pages)):
        raise AssertionError("pages not returned to the free list")
    if sorted(engine._free_slots) != list(range(econf.n_slots)):
        raise AssertionError("slots not returned to the free list")
    L = cfg.n_layers
    if launches["paged_attention"] != L * steps or steps == 0:
        raise AssertionError(f"paged launches {launches['paged_attention']} "
                             f"!= {L} x {steps} decode steps")
    if launches["flash_attention"] != L * prefills or prefills != N_REQUESTS:
        raise AssertionError(f"flash launches {launches['flash_attention']} "
                             f"!= {L} x {prefills} prefills")
    lat = sorted(engine.finished[r].latency for r in rids)
    serving = {
        "model": cfg.name, "dtype": cfg.dtype, "requests": N_REQUESTS,
        "tokens": n_tokens, "wall_s": wall,
        "tokens_per_s": n_tokens / wall,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "decode_steps": steps,
        "decode_step_ms_mean": 1e3 * (engine.decode_seconds - base["dec"]) / steps,
        "prefills": prefills,
        "prefill_ms_mean": 1e3 * (engine.prefill_seconds - base["pre"]) / prefills,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "init_s": init_s,
        "launches_per_decode_step": launches["paged_attention"] / steps,
        "launches_per_prefill": launches["flash_attention"] / prefills,
        "launches_by_route": {n: routes[n] for n in
                              ("paged_attention", "flash_attention")},
    }

    e2e_err, _ = prefill_decode_consistency(bundle, merged, reqs[0][2])
    serving["prefill_vs_decode_max_abs_err"] = e2e_err
    return engine, snap, launches, serving, reqs


def prefill_decode_consistency(bundle, params, soft, S=100, K=8, pad=28,
                               tol=E2E_TOL):
    """tests/test_serving.py's contract at full width: prefill a prompt
    (padded by ``pad``; the recurrent families take pad 0), seat it in
    slot 1, decode K teacher-forced tokens and hold every step's logits
    against one full forward over the same tokens (``tol`` None: measure
    only).  Returns (the largest error, the full forward's logits)."""
    import torch
    from repro_torch.models.paged import pages_for
    cfg = bundle.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (1, S + K), generator=gen,
                         device="cuda")
    prefix = soft[None]
    P = prefix.shape[1]
    ps = 16
    with torch.no_grad():
        full, _ = bundle.logits(params, {"tokens": toks, "prefix_embeds": prefix})
        n_pg = pages_for(P + S + pad + K, ps)
        pstate = bundle.init_paged(2, n_pg + 1, ps, "cuda")
        pre = torch.nn.functional.pad(toks[:, :S], (0, pad))
        last, pack, kv_len = bundle.prefill_paged(
            params, {"tokens": pre, "prefix_embeds": prefix}, S)
        errs = [check_close("prefill last logits", last[0], full[0, P + S - 1],
                            tol or NO_TOL)]
        slot = 1
        page_ids = torch.arange(1, 1 + n_pg, device="cuda")
        pstate = bundle.insert_paged(pstate, pack, slot, page_ids)
        bt = torch.zeros((2, max(n_pg, 32)), dtype=torch.int32,
                         device="cuda")
        bt[slot, :n_pg] = page_ids.int()
        seq_lens = torch.zeros((2,), dtype=torch.int32, device="cuda")
        seq_lens[slot] = kv_len
        active = torch.tensor([False, True], device="cuda")
        for i in range(K):
            tok = torch.zeros((2, 1), dtype=torch.long, device="cuda")
            tok[slot, 0] = toks[0, S + i]
            logits, pstate = bundle.decode_paged(params, pstate, bt, seq_lens,
                                                 tok, active)
            errs.append(check_close(f"decode step {i}", logits[slot],
                                    full[0, P + S + i], tol or NO_TOL))
            seq_lens = seq_lens + active.int()
    return max(errs), full


# ---------------------------------------------------------------------------
# phase 5: where the serving time goes

KERNEL_GROUPS = (("paged_attention", ("paged_attention_kernel",)),
                 ("flash_attention", ("flash_attention_kernel",)),
                 ("ssd_chunk", ("ssd_chunk_kernel",)),
                 ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "splitk")))


def _device_busy(prof, path, groups_table, annotation=None):
    """Kernel time from the profiler's trace: (busy ms, ms by group, the
    eight kernels that took the most time, the number of GPU ranges of
    ``annotation``).  A kernel inside such a range counts in a group named
    after the annotation; any other in the first group of
    ``groups_table`` whose keys its name holds, else in "other"."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    ranges = [(float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
              for ev in events if annotation is not None
              and ev.get("cat") == "gpu_user_annotation"
              and ev.get("name") == annotation]
    groups, by_name = {}, {}
    busy = 0.0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        dur = float(ev.get("dur", 0.0)) / 1e3
        busy += dur
        name = ev.get("name", "")
        ts = float(ev.get("ts", 0.0))
        if any(a <= ts < b for a, b in ranges):
            group = annotation
        else:
            group = next((g for g, keys in groups_table
                          if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + dur
        count, total = by_name.get(name[:80], (0, 0.0))
        by_name[name[:80]] = (count + 1, total + dur)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return busy, groups, [{"kernel": k, "launches": c, "ms": t}
                          for k, (c, t) in top], len(ranges)


def phase_profile(engine, reqs, tag=""):
    """Profile one admission tick (16 prefills + 1 decode step) and then
    4 decode steps of 16 busy slots: wall time against kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_dir = ROOT / "build" / "profile"      # traces are tens of MB
    out_dir.mkdir(parents=True, exist_ok=True)
    for toks, _, soft in reqs[:engine.econf.n_slots]:
        engine.submit(toks, max_new=engine.econf.max_out, prefix_embeds=soft)
    result = {}
    for window, n_ticks in (("admit_tick", 1), ("decode_steps", 4)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_ticks):
                engine.tick()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, groups, top, _ = _device_busy(
            prof, out_dir / f"trace_{tag}{window}.json", KERNEL_GROUPS)
        result[window] = {
            "ticks": n_ticks, "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": (1.0 - busy / wall) if busy else "not measured",
            "kernel_ms_by_group": groups, "top_kernels": top}
    engine.run()
    return result


# ---------------------------------------------------------------------------
# phase 6: numbers

def paged_row(engine, snap, windows, gen):
    """Row A at a serving run's fullest decode step (the step with the most
    cached tokens): the L launches of one decode step, each over its own
    layer's pool with its own window, from CUDA-graph replay (L x the
    working set >> 50 MB L2, so the pages come from HBM as in a decode
    step).  The chosen cluster size against every forced one and against
    the FMA walk, on the same inputs, their replays taken in turn; the
    bound from the bytes each layer's window keeps."""
    import torch
    from repro_torch.kernels.paged_attention import (
        SPLITS, paged_attention_cuda, paged_attention_plain,
        paged_attention_route, paged_attention_splits)
    cfg = engine.cfg
    H, K, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    bt, seq_lens, active = snap
    lens = torch.where(active, seq_lens + 1, 0).int().contiguous()
    B, M = bt.shape
    kp, vp = engine.pstate["k_pages"], engine.pstate["v_pages"]
    ps = kp.shape[2]
    qs = torch.randn((L, B, 1, H, D), generator=gen,
                     device="cuda").to(kp.dtype)

    def call(**kw):
        return lambda i: paged_attention_cuda(
            qs[i % L], kp[i % L], vp[i % L], bt, lens, windows[i % L], **kw)

    err = 0.0
    for i in range(L):
        got = paged_attention_cuda(qs[i], kp[i], vp[i], bt, lens, windows[i])
        want = paged_attention_plain(qs[i], kp[i], vp[i], bt, lens,
                                     windows[i])
        err = max(err, check_close(f"paged main-path layer {i}", got, want,
                                   BF16_TOL))
    lens_l = lens.long()
    keys = [int(torch.clamp(lens_l, max=w).sum()) for w in windows]
    esz = kp.element_size()
    bytes_ = sum(2 * n * K * D * esz for n in keys) \
        + L * (2 * B * H * D * esz + bt.numel() * 4 + lens.numel() * 4)
    flops = sum(4 * n * H * D for n in keys)
    bound, by = _bound(bytes_ / L, flops / L)
    splits = paged_attention_splits(B, K, H // K, M, ps)
    t = graphs_ms({"chosen": call(), "fma": call(route="fma"),
                   **{str(sp): call(splits=sp) for sp in SPLITS}},
                  n_calls=L, reps=7)
    by_splits = {str(sp): t[str(sp)] for sp in SPLITS}
    return {
        "max_abs_err": err, "ms": t["chosen"], "ms_splits1": by_splits["1"],
        "ms_fma_route": t["fma"],
        "plain_ms": graph_ms(lambda i: paged_attention_plain(
            qs[i % L], kp[i % L], vp[i % L], bt, lens, windows[i % L]),
            n_calls=L),
        "bound_ms": bound, "bound_by": by, "bytes_per_launch": bytes_ / L,
        "splits": splits, "ms_by_splits": by_splits,
        "kernel_route": paged_attention_route(qs[0], kp[0], vp[0]),
        "launches_per_decode_step": L,
        "shape": {"slots": B, "active": int(active.sum()),
                  "cached_keys": int(lens.sum()),
                  "kept_keys_per_layer": sorted(set(keys)),
                  "windows": sorted(set(windows)), "H": H, "K": K, "D": D,
                  "page_size": ps, "max_pages_per_seq": M,
                  "dtype": str(kp.dtype)}}


def phase_numbers(engine, snap):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_attention_route)
    from repro_torch.models.layers import BIG_WINDOW
    cfg = engine.cfg
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(4)
    kernels = []
    kp = engine.pstate["k_pages"]
    kernels.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:113",
        "tolerance": BF16_TOL,
        **paged_row(engine, snap, [BIG_WINDOW] * cfg.n_layers, gen),
        "library_ms": None,
        "library_call": "none: no single PyTorch call attends over a paged "
                        "cache",
        "ms_splits1_is": "the same kernel forced to one block a walk "
                        "(splits=1) on the same inputs in this run",
        "ms_fma_route_is": "the FMA walk (route='fma') on the same inputs "
                           "in this run",
    })

    # B: one prefill of the largest bucket (8 soft tokens + 256), the most
    # common prefill shape of the main run; then the round's forwards (8
    # sequences of 8 soft + 128 tokens) at the SLM's and the LLM's heads.
    # Each shape also times the FMA route on the same inputs and SDPA.
    def b_case(Bn, S, H, K, D):
        dt = kp.dtype
        q = torch.randn((Bn, S, H, D), generator=gen, device="cuda").to(dt)
        k, v = (torch.randn((Bn, S, K, D), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        route = flash_attention_route(q, k, v)
        if route != "mma":
            raise AssertionError(f"flash row: route {route}")
        got = flash_attention_cuda(q, k, v, causal=True, window=BIG_WINDOW)
        want = flash_attention_plain(q, k, v, causal=True, window=BIG_WINDOW)
        err = check_close("flash row", got, want, BF16_TOL)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bytes_ = 4 * Bn * S * H * D * q.element_size()
        flops = 4 * D * Bn * H * S * (S + 1) // 2
        ms = graph_ms(lambda i: flash_attention_cuda(q, k, v, True,
                                                     BIG_WINDOW))
        fma = graph_ms(lambda i: flash_attention_cuda(q, k, v, True,
                                                      BIG_WINDOW,
                                                      route="fma"))
        plain = graph_ms(lambda i: flash_attention_plain(q, k, v, True,
                                                         BIG_WINDOW))
        lib = graph_ms(lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        bound, by = _bound(bytes_, flops)
        return {"ms": ms, "ms_fma_route": fma, "plain_ms": plain,
                "library_ms": lib, "bound_ms": bound, "bound_by": by,
                "max_abs_err": err, "kernel_route": route,
                "shape": {"B": Bn, "S": S, "H": H, "K": K, "D": D,
                          "dtype": str(dt)}}

    llm = round_models()[1]
    s_round = cfg.n_soft_tokens + CORPUS["seq_len"]
    main = b_case(1, cfg.n_soft_tokens + 256, H, K, D)
    qwen = het_models()[1]
    others = {"round_slm": b_case(8, s_round, H, K, D),
              "round_llm": b_case(8, s_round, llm.n_heads, llm.n_kv_heads,
                                  llm.head_dim),
              "round_qwen3": b_case(8, s_round, qwen.n_heads,
                                    qwen.n_kv_heads, qwen.head_dim)}
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105",
        "max_abs_err": max([main["max_abs_err"]]
                           + [o["max_abs_err"] for o in others.values()]),
        "tolerance": BF16_TOL,
        **{k: main[k] for k in ("ms", "ms_fma_route", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "kernel_route", "shape")},
        "ms_fma_route_is": "the FMA route on the same inputs in this run",
        "library_call": "scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True) on (B, H, S, D) copies",
        "at_other_shapes": others,
    })
    return kernels


# ---------------------------------------------------------------------------
# phase 3b / 4: B's gradient, kernels C and D against their plain versions

def rel_check(name, got, want, tol, floor=0.0):
    """check_close on tensors divided, row by row of the first axis, by the
    larger of the row's largest |want| and ``floor`` times the largest
    |want| of the whole tensor: the tolerance is relative to each row's
    own size (gradients whose size varies by orders of magnitude), and a
    kernel that writes zeros fails.  Returns the largest absolute and
    scaled errors and the smallest and largest divisor."""
    import torch
    dims = tuple(range(1, want.dim()))
    want = want.float()
    scale = torch.maximum(want.abs().amax(dim=dims, keepdim=True),
                          floor * want.abs().max()).clamp(min=1e-30)
    rel = check_close(name, got.float() / scale, want / scale, tol)
    return {"max_abs_err": float((got.float() - want).abs().max()),
            "max_rel_err": rel, "scale": [float(scale.min()),
                                          float(scale.max())]}


# B's gradients: each (position, head) row of D is held relative to its own
# largest |value|, but to no less than a tenth of the tensor's largest.  A
# query that sees one key (the first row under the causal mask) has a dq of
# exactly zero in exact arithmetic; f32 leaves noise of ~1e-7 there (dS =
# P (dP - delta) cancels), in the plain version as in the kernel.
FLASH_GRAD_FLOOR = 0.1
# bf16 kernel against the plain forward's autograd: the kernel forms
# delta = rowsum(dO * O) from the bf16 output (as FlashAttention does),
# the autograd from the f32 one, which moves dS by up to ~2^-9 sum|dO||O|
# per row; dq's small rows feel it most (CPU emulation: 0.022 after the
# floor at the round's shapes).
FLASH_BF16_AUTOGRAD_TOL = dict(atol=5e-2, rtol=2e-2)


def grad_rows(name, got, want, tol):
    """rel_check with each (position, head) row of D as a row."""
    D = want.shape[-1]
    return rel_check(name, got.reshape(-1, D), want.reshape(-1, D), tol,
                     floor=FLASH_GRAD_FLOOR)


def phase_flash_grad_check():
    """B's forward, log-sum-exp and backward kernels against the plain
    versions: the explicit backward formulas on the kernel's own output
    and log-sum-exp, and the plain forward's autograd.  The rounds' shapes
    (batch 8, 8 soft + 128 tokens: the SLM's 20 heads of 64, the LLM's 16
    of 256 and qwen3's 16 over 8 KV heads of 128) and a GQA case with a
    window, Sq < Sk and a ragged S; bf16 and f32."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_backward_plain,
        flash_attention_backward_route, flash_attention_cuda,
        flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = {"slm": dict(B=8, Sq=136, Sk=136, H=20, K=20, D=64, window=0),
             "llm": dict(B=8, Sq=136, Sk=136, H=16, K=16, D=256, window=0),
             "qwen3": dict(B=8, Sq=136, Sk=136, H=16, K=8, D=128, window=0),
             "gqa_window": dict(B=3, Sq=57, Sk=131, H=8, K=2, D=64,
                                window=45)}
    results, routes = {}, {}
    for model, c in cases.items():
        B, Sq, Sk, H, K, D, w = (c[n] for n in
                                 ("B", "Sq", "Sk", "H", "K", "D", "window"))
        for dtype, tol in ((torch.bfloat16, BF16_TOL),
                           (torch.float32, F32_TOL)):
            q = torch.randn((B, Sq, H, D), generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn((B, Sk, K, D), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            do = torch.randn((B, Sq, H * D), generator=gen,
                             device="cuda").to(dtype)
            tag = f"{model}/{str(dtype)[6:]}"
            # the kernels end to end through autograd, then the plain
            # forward's autograd
            outs, grads = [], []
            for kernel in (True, False):
                ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
                n = flash_attention_backward_cuda.launches
                if kernel:
                    out = ops.attention(*ins, causal=True, window=w)
                else:
                    out = flash_attention_plain(*ins, True, w).reshape(
                        B, Sq, H * D)
                out.backward(do)
                if flash_attention_backward_cuda.launches != n + kernel:
                    raise AssertionError(f"flash bwd {tag}: launches")
                outs.append(out.detach())
                grads.append([t.grad for t in ins])
            # the backward kernels against the explicit formulas
            o, lse = flash_attention_cuda(q, k, v, True, w, with_lse=True)
            _, plain_lse = flash_attention_plain(q, k, v, True, w,
                                                 with_lse=True)
            dov = do.reshape(B, Sq, H, D)
            route = flash_attention_backward_route(q, k, v)
            if route != ("mma" if dtype == torch.bfloat16 else "fma"):
                raise AssertionError(f"flash bwd {tag}: route {route}")
            before = flash_attention_backward_cuda.launches_by_route[route]
            got = flash_attention_backward_cuda(q, k, v, o, dov, lse, True, w)
            if flash_attention_backward_cuda.launches_by_route[route] != \
                    before + 1:
                raise AssertionError(f"flash bwd {tag}: not on {route}")
            routes[tag] = route
            want = flash_attention_backward_plain(q, k, v, o, dov, lse, True,
                                                  w)
            torch.cuda.synchronize()
            results[f"out/{tag}"] = check_close(f"flash fwd {tag}", *outs,
                                                tol)
            results[f"lse/{tag}"] = check_close(f"flash lse {tag}", lse,
                                                plain_lse, LSE_TOL)
            for i, n in enumerate("qkv"):
                results[f"d{n}_vs_formulas/{tag}"] = grad_rows(
                    f"flash bwd d{n} {tag}", got[i], want[i], tol)
                results[f"d{n}_vs_autograd/{tag}"] = grad_rows(
                    f"flash grad d{n} {tag}", grads[0][i], grads[1][i],
                    tol if dtype == torch.float32
                    else FLASH_BF16_AUTOGRAD_TOL)
    emit({"phase": "flash_attention_backward_vs_plain",
          "shapes": cases, "max_abs_err": results, "routes": routes,
          "tolerance": {"bfloat16": BF16_TOL, "float32": F32_TOL,
                        "lse": LSE_TOL,
                        "bfloat16_vs_autograd": FLASH_BF16_AUTOGRAD_TOL,
                        "gradients": "on each (position, head) row of D "
                                     "divided by the larger of its largest "
                                     "|value| and 0.1 x the tensor's "
                                     "(scale: smallest, largest divisor)"}})


# log-sum-exp: both sides in f32 from the same inputs, summed in other orders
LSE_TOL = dict(atol=1e-4, rtol=1e-5)


def tile_rows(R, L, qmax, seed):
    """(R, L) f32 wire tiles on the host: random rows over six decades of
    scale, all-zero rows, and rows of exact half-way ties (absmax = qmax *
    2^e makes the scale exactly 2^e, and (k + 1/2) * 2^e divides to
    k + 1/2)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    x = rng.randn(R, L) * 10.0 ** rng.uniform(-3, 2, (R, 1))
    x[0] = 0.0
    if R > 2:
        x[R // 2] = 0.0
    for i in range(1, R, 5):
        e = 2.0 ** rng.randint(-6, 4)
        x[i] = (rng.randint(1 - qmax, qmax - 1, L) + 0.5) * e
        x[i, rng.randint(L)] = qmax * e * rng.choice([-1, 1])
    return torch.from_numpy(x.astype(np.float32))


def bits_equal(a, b) -> bool:
    """Equal bit for bit (floats by their bit pattern), wherever they lie."""
    import torch
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    if a.dtype != b.dtype:
        return False
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    if a.dtype in bits:
        a, b = a.view(bits[a.dtype]), b.view(bits[a.dtype])
    return torch.equal(a, b)


QUANT_SHAPES = {"uplink": (8640, 128), "downlink": (2880, 128),
                "ragged": (129, 131), "tiny": (7, 3), "one_row": (1, 257)}


def phase_quantize_checks():
    """E and F bit for bit against their plain versions, on the card and
    on a CPU copy of the same inputs."""
    import torch
    from repro_torch.kernels.quantize import (dequantize_rows_cuda,
                                              dequantize_rows_plain,
                                              quantize_rows_cuda,
                                              quantize_rows_plain)
    checked = {}
    for name, (R, L) in QUANT_SHAPES.items():
        for qmax in (127, 7):
            for dtype in (torch.float32, torch.bfloat16):
                tag = f"{name}/q{qmax}/{str(dtype)[6:]}"
                x = tile_rows(R, L, qmax, R + L + qmax).to(dtype)
                xc = x.cuda()
                q, s = quantize_rows_cuda(xc, qmax)
                out = dequantize_rows_cuda(q, s)
                for where, xr in (("card", xc), ("cpu", x)):
                    pq, ps = quantize_rows_plain(xr, qmax)
                    pout = dequantize_rows_plain(pq, ps)
                    torch.cuda.synchronize()
                    for what, a, b in (("codes", q, pq), ("scales", s, ps),
                                       ("dequantized", out, pout)):
                        if not bits_equal(a, b):
                            raise AssertionError(
                                f"quantize {tag}: {what} differ from the "
                                f"plain version on the {where}")
                if float(s[0]) != 0.0 or bool((q[0] != 0).any()):
                    raise AssertionError(f"quantize {tag}: zero row")
                ties = (x[1].float() / s[1].cpu()) if R > 1 else None
                if ties is not None and not bool(
                        (ties - ties.floor() == 0.5).any()):
                    raise AssertionError(f"quantize {tag}: no tie was hit")
                checked[tag] = True
    emit({"phase": "quantize_vs_plain", "equal_bit_for_bit": checked,
          "against": ["plain on the card", "plain on a CPU copy"]})


def lora_inputs(gen, M, K, N, r, dtype, trans_w=False):
    import torch
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    wshape = (N, K) if trans_w else (K, N)
    w = (torch.randn(wshape, generator=gen, device=dev) / math.sqrt(K)
         ).to(dtype)
    a = (torch.randn((K, r), generator=gen, device=dev) / math.sqrt(K)
         ).to(dtype)
    b = (0.1 * torch.randn((r, N), generator=gen, device=dev)).to(dtype)
    return x, w, a, b


def phase_lora_checks():
    """C against its plain version on both routes: the SLM's, the LLM's and
    qwen3's projections (and qwen3's dx) at the training M = 8 x 136,
    ragged M/N/K (bf16 with K, N
    multiples of 8 on the wgmma route; others on the FMA route), ranks 8
    and 16, the transposed-W mode of the backward, the FMA route forced
    at the LLM's shape, and the autograd gradients (dx, dA, dB).  Each
    case checks the route it launched on."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.lora_matmul import (lora_matmul_cuda,
                                                 lora_matmul_plain,
                                                 lora_matmul_route)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = {"slm_proj": (1088, 1280, 1280, 8),
             "llm_proj": (1088, 4096, 4096, 8),
             "qwen3_q_o": (1088, 2048, 2048, 8),
             "qwen3_k_v": (1088, 2048, 1024, 8),
             "ragged_aligned": (1001, 1288, 776, 16),
             "ragged": (1001, 1283, 771, 8)}
    results, routes = {}, {}

    def launch(tag, *args, **kw):
        before = dict(lora_matmul_cuda.launches_by_route)
        out = lora_matmul_cuda(*args, **kw)
        moved = [r for r, n in lora_matmul_cuda.launches_by_route.items()
                 if n != before[r]]
        want = kw.get("route") or lora_matmul_route(
            *args[:4], kw.get("trans_w", False))
        if moved != [want]:
            raise AssertionError(f"lora {tag}: launched on {moved}, "
                                 f"expected {want}")
        routes[tag] = want
        return out

    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        dt = str(dtype)[6:]
        for name, (M, K, N, r) in cases.items():
            x, w, a, b = lora_inputs(gen, M, K, N, r, dtype)
            got = launch(f"{name}/{dt}", x, w, a, b, 2.0)
            want = lora_matmul_plain(x, w, a, b, 2.0)
            torch.cuda.synchronize()
            results[f"{name}/{dt}"] = check_close(f"lora {name}/{dt}", got,
                                                  want, tol)
        # transposed W: dx = dy @ W^T + s (dy @ B^T) @ A^T at the LLM shape
        dy, wt, bt, at = lora_inputs(gen, 1088, 4096, 4096, 8, dtype,
                                     trans_w=True)
        got = launch(f"transposed_w/{dt}", dy, wt, bt, at, 2.0, trans_w=True)
        want = lora_matmul_plain(dy, wt.t(), bt, at, 2.0)
        torch.cuda.synchronize()
        results[f"transposed_w/{dt}"] = check_close(
            f"lora transposed/{dt}", got, want, tol)
        # qwen3's dx: wq / wo (2048 -> 2048) and wk / wv (1024 -> 2048)
        for name, (K, N) in {"qwen3_dx_q_o": (2048, 2048),
                             "qwen3_dx_k_v": (1024, 2048)}.items():
            dy, wt, bt, at = lora_inputs(gen, 1088, K, N, 8, dtype,
                                         trans_w=True)
            got = launch(f"{name}/{dt}", dy, wt, bt, at, 2.0, trans_w=True)
            want = lora_matmul_plain(dy, wt.t(), bt, at, 2.0)
            torch.cuda.synchronize()
            results[f"{name}/{dt}"] = check_close(f"lora {name}/{dt}", got,
                                                  want, tol)
        # gradients through autograd at the SLM shape
        x, w, a, b = lora_inputs(gen, 1088, 1280, 1280, 8, dtype)
        g = torch.randn((1088, 1280), generator=gen, device="cuda").to(dtype)
        grads = []
        for fn in (ops.lora_matmul, lora_matmul_plain):
            ins = [t.clone().requires_grad_(True) for t in (x, a, b)]
            fn(ins[0], w, ins[1], ins[2], 2.0).backward(g)
            grads.append([t.grad for t in ins])
        torch.cuda.synchronize()
        for n, got, want in zip(("dx", "dA", "dB"), *grads):
            results[f"grad_{n}/{dt}"] = rel_check(f"lora {n}/{dt}", got,
                                                  want, tol)
    # the FMA route at the LLM's shape in bf16 (what every launch took
    # before the wgmma route)
    x, w, a, b = lora_inputs(gen, 1088, 4096, 4096, 8, torch.bfloat16)
    got = launch("llm_proj/bfloat16/forced_fma", x, w, a, b, 2.0,
                 route="fma")
    torch.cuda.synchronize()
    results["llm_proj/bfloat16/forced_fma"] = check_close(
        "lora forced fma", got, lora_matmul_plain(x, w, a, b, 2.0), BF16_TOL)
    if set(routes.values()) != {"wgmma", "fma"}:
        raise AssertionError(f"lora checks did not cover both routes: "
                             f"{routes}")
    emit({"phase": "lora_matmul_vs_plain", "max_abs_err": results,
          "routes": routes,
          "tolerance": {"bfloat16": BF16_TOL, "float32": F32_TOL,
                        "gradients": "on each row divided by its largest "
                                     "|value| (scale: smallest, largest "
                                     "divisor)"}})


def gram_inputs(gen, B, k, d, dtype):
    import torch
    vs = torch.randn((B, k, d), generator=gen, device="cuda")
    mask = torch.rand((B, k), generator=gen, device="cuda") < 0.6
    mask[:, 0] = True
    vs = vs * mask[..., None]           # masked rows are all zero
    vs[3, k - 1] = 0.0                  # a present row that is all zero
    mask[3, k - 1] = True
    return vs.to(dtype).contiguous(), mask.contiguous()


GRAM_TOL = dict(atol=1e-4, rtol=1e-4)
# D's gradient: each sample is held relative to its own largest |gradient|,
# but to no less than a tenth of the batch's largest.  Where a sample's
# rows are nearly orthogonal its gradient is small, while f32 leaves noise
# of about 1e-6 of the batch's scale (the normalization projects out the
# diagonal term of the Gram's gradient, by cancellation), in the plain
# version as in the kernel.
GRAM_GRAD_FLOOR = 0.1


def phase_gram_checks():
    """D against its plain version, forward and backward, through the
    autograd wrapper (its backward reads the forward's saved dots, which
    are held against the plain dots too); k in {4, 8}, d = 1280, masked
    rows, all-zero rows, batches of 80 (the CCL loss's 2 x (1 + 4) x 8
    candidate sets), 81 and 130."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.gram_volume import (
        gram_dots_plain, gram_log_volume_backward_cuda, gram_log_volume_cuda,
        gram_log_volume_plain)
    gen = torch.Generator(device="cuda").manual_seed(8)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for B, k in ((80, 4), (81, 4), (130, 8)):
            vs, mask = gram_inputs(gen, B, k, 1280, dtype)
            gout = torch.randn((B,), generator=gen, device="cuda")
            v = vs.clone().requires_grad_(True)
            yp = gram_log_volume_plain(v, mask)
            gp = torch.autograd.grad(yp, v, gout)[0]
            fns = [gram_log_volume_cuda, gram_log_volume_backward_cuda]
            before = [f.launches for f in fns]
            v = vs.clone().requires_grad_(True)
            y = ops.gram_log_volume(v, mask)
            y.backward(gout)
            if [f.launches - n for f, n in zip(fns, before)] != [1, 1]:
                raise AssertionError("gram: the autograd wrapper did not "
                                     "launch each kernel once")
            _, dots = gram_log_volume_cuda(vs, mask, return_dots=True)
            torch.cuda.synchronize()
            tag = f"B{B}_k{k}/{dt}"
            want = gram_dots_plain(vs)
            results[f"dots/{tag}"] = check_close(
                "gram dots", dots, want,
                dict(atol=1e-5 * float(want.abs().max()), rtol=1e-4))
            results[f"fwd/{tag}"] = check_close(f"gram fwd {tag}",
                                                y.detach(), yp.detach(),
                                                GRAM_TOL)
            tol = GRAM_TOL if dtype == torch.float32 else BF16_TOL
            results[f"bwd/{tag}"] = rel_check(
                f"gram bwd {tag}", v.grad, gp, tol, floor=GRAM_GRAD_FLOOR)
            if bool((v.grad[~mask] != 0).any()):
                raise AssertionError(f"gram bwd {tag}: masked rows got a "
                                     "gradient")
    emit({"phase": "gram_log_volume_vs_plain", "max_abs_err": results,
          "tolerance": {"forward": GRAM_TOL, "backward_float32": GRAM_TOL,
                        "backward_bfloat16": BF16_TOL,
                        "dots": "1e-4 relative, 1e-5 of the largest",
                        "backward": "on each sample divided by the larger "
                                    "of its largest |gradient| and 0.1 x "
                                    "the batch's (scale: smallest, "
                                    "largest divisor)"}})


# ---------------------------------------------------------------------------
# phase 7: one federated round at full width

ROUND = dict(n_devices=3, local_steps_ccl=2, local_steps_amt=2,
             server_steps=2, engine="loop", seed=0)
CORPUS = dict(n_samples=1536, seq_len=128, vocab_size=50257, n_classes=8,
              n_modalities=3, modality_dim=256, template_len=8)
def counters():
    """Every kernel wrapper of the port, by name (each counts its own
    launches in ``.launches``)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_cuda)
    from repro_torch.kernels.gram_volume import (
        gram_log_volume_backward_cuda, gram_log_volume_cuda)
    from repro_torch.kernels.lora_matmul import (lora_matmul_cuda,
                                                 lora_matmul_grouped_cuda)
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.quantize import (dequantize_rows_cuda,
                                              quantize_rows_cuda)
    from repro_torch.kernels.ssd_scan import (ssd_chunk_bwd_cuda,
                                              ssd_chunk_cuda)
    return {"paged_attention": paged_attention_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_backward": flash_attention_backward_cuda,
            "lora_matmul": lora_matmul_cuda,
            "lora_matmul_grouped": lora_matmul_grouped_cuda,
            "gram_log_volume": gram_log_volume_cuda,
            "gram_log_volume_backward": gram_log_volume_backward_cuda,
            "quantize_rows": quantize_rows_cuda,
            "dequantize_rows": dequantize_rows_cuda,
            "ssd_chunk": ssd_chunk_cuda,
            "ssd_chunk_bwd": ssd_chunk_bwd_cuda}


# the kernels with a tensor-core route and an FMA route, and the route
# every bf16 launch of the main paths must take
TENSOR_CORE_ROUTES = {"paged_attention": "mma",
                      "lora_matmul": "wgmma",
                      "lora_matmul_grouped": "wgmma",
                      "flash_attention": "mma",
                      "flash_attention_backward": "mma",
                      "ssd_chunk": "mma",
                      "ssd_chunk_bwd": "mma"}


def zero_counters():
    for fn in counters().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_route"):
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_counters():
    return {n: fn.launches for n, fn in counters().items()}


def check_tensor_core_routes(tag, fma=None):
    """Every launch of A, C, B (forward and backward), G and G′ since the
    last ``zero_counters`` took the tensor-core route, except exactly ``fma``'s
    count of FMA launches per kernel (C at a projection whose shape the
    wgmma route does not take: ``round_launch_plan``; A at D 256, whose
    decode the mma walk does not take: ``d256_fma``); returns the
    per-route counts."""
    fns = counters()
    fma = fma or {}
    routes = {n: dict(fns[n].launches_by_route) for n in TENSOR_CORE_ROUTES}
    for name, counts in routes.items():
        off = {r: n for r, n in counts.items()
               if r != TENSOR_CORE_ROUTES[name] and n}
        if off != ({"fma": fma[name]} if fma.get(name) else {}):
            raise AssertionError(f"{tag}: {name} launched off the "
                                 f"tensor-core route: {counts}, expected "
                                 f"{fma.get(name, 0)} on fma")
    return routes


# the adapted projections fed by a layer's normed input: on a raw batch
# (no soft prompt) layer 0's take the frozen embedding and need no dx
ENTRY_PROJECTIONS = ("wq", "wk", "wv", "in_proj")


def projection_routes(mc):
    """{target: (route of y, route of dx)} for each adapted projection of
    one layer of ``mc``, from C's route rule on meta tensors at its (K, N):
    hymba's in_proj (N = 2 * 3200 + 2 * 16 + 50 = 6,482, no multiple of 8)
    takes the FMA route both ways, every other projection of the main
    paths the wgmma route."""
    import torch
    from repro_torch.kernels.lora_matmul import lora_matmul_route
    d, r = mc.d_model, mc.lora_rank
    dims = {}
    if mc.family != "ssm":
        H, K, hd = mc.n_heads, mc.n_kv_heads, mc.head_dim
        dims.update(wq=(d, H * hd), wk=(d, K * hd), wv=(d, K * hd),
                    wo=(H * hd, d))
    if mc.family in ("ssm", "hybrid"):
        di, N, G, Hs = mc.d_inner, mc.ssm_state, mc.ssm_groups, mc.ssm_heads
        dims.update(in_proj=(d, 2 * di + 2 * G * N + Hs), out_proj=(di, d))
    meta = dict(device="meta", dtype=mc.torch_dtype)
    out = {}
    for t in mc.lora_targets:
        if t not in dims:
            continue
        k, n = dims[t]
        w = torch.empty((k, n), **meta)
        a, b = torch.empty((k, r), **meta), torch.empty((r, n), **meta)
        out[t] = (lora_matmul_route(torch.empty((8, k), **meta), w, a, b),
                  lora_matmul_route(torch.empty((8, n), **meta), w, b.t(),
                                    a.t(), trans_w=True))
    return out


def pass_launches(mc, prefix, trained=True):
    """Launches of one pass of ``mc``: C per route, B, B', G, G'.  A
    trained pass launches each adapted projection's C L times forward, L
    more when ``remat`` recomputes the layers in the backward, and L for dx
    (one fewer for an entry projection on a raw batch); B (attention
    families) and G (the ssm and hybrid families) L times forward, L more
    under remat, and their backward kernels L times.  An untrained pass
    (eval, no autograd) launches each once a layer."""
    L = mc.n_layers
    rem = 2 if trained and mc.remat else 1
    c = {"wgmma": 0, "fma": 0}
    for t, (fwd, dx) in projection_routes(mc).items():
        c[fwd] += L * rem
        if trained:
            c[dx] += L - (0 if prefix or t not in ENTRY_PROJECTIONS else 1)
    attn, ssd = mc.family != "ssm", mc.family in ("ssm", "hybrid")
    return {"c": c, "b": L * rem * attn, "b_bwd": L * attn * trained,
            "g": L * rem * ssd, "g_bwd": L * ssd * trained}


def expected_round_launches(runner, evaluate=True):
    """The launches of every kernel in one round: ``round_launch_plan``'s
    first half."""
    return round_launch_plan(runner, evaluate)[0]


def round_launch_plan(runner, evaluate=True):
    """Launches of every kernel in one round (evaluated or not), from the
    step structure, cohort by cohort (each cohort's model, batch size and
    step counts) over the round's working set (under a sampler the
    sampled members, else every member), and the FMA launches of C among
    them: ({kernel: launches}, {"lora_matmul": n, "lora_matmul_grouped":
    n}).  On the loop engine only the working set's present clients
    train, each pass is one client's, and client eval runs each member's
    own batches.  On the vectorized engine each local step is ONE pass of
    the cohort's working set (offline clients train and are selected
    back), its C launches are the grouped form's, and client eval runs one
    pass per padded eval batch of the cohort (the most any registered
    member needs); the server's launches are the same on both engines.
    A pass launches what ``pass_launches`` counts; each CCL loss launches
    D once forward and once backward.  The server's passes run the LLM
    and the server SLM (the first cohort's model unless the spec names
    one).  A quantized channel encodes each of a cohort's K LoRA leaves
    once on the uplink and once on the downlink (E 2K) and decodes each of
    them on both (F 2K), plus once more for the uplink's error feedback
    (F 3K).  On a rank of a mesh: the cohorts it trains (the wire runs
    whole on every rank) and the server where it holds it."""
    cfg, spec, l = runner.cfg, runner.spec, runner.llm.cfg
    s = runner._srv_slm_bundle.cfg
    pres = runner._rnd_present
    stacked = runner.engine in ("vectorized", "overlap")
    serves = runner._serves
    passes, grouped, d, k = [], [], cfg.server_steps * serves, 0
    evals, grouped_evals = [], []
    for rt in runner.cohorts:
        k += len(rt.up_like) if runner.channel.spec.codec in (
            "int8", "int4") else 0
        if not rt.member:
            continue
        m = rt.bundle.cfg
        n = rt.work_n if pres is None else int(pres[rt.work_slice].sum())
        k_ccl = spec.cohort_steps_ccl(rt.idx)
        steps = k_ccl + spec.cohort_steps_amt(rt.idx)
        bs = spec.cohort_batch_size(rt.idx)
        blocks = [-(-runner.priv_test[rt.offset + i]["tokens"].shape[0]
                    // bs) for i in runner._members(rt)]
        if stacked:
            grouped += [pass_launches(m, True)] * steps
            d += k_ccl
            grouped_evals += [pass_launches(m, True, False)] * rt.eval_blocks
        else:
            passes += [pass_launches(m, True)] * n * steps
            d += n * k_ccl
            evals += [pass_launches(m, True, False)] * sum(blocks)
    server_evals = [pass_launches(l, True, False)] * -(
        -runner.public_test["tokens"].shape[0] // cfg.batch_size) * serves
    passes += cfg.server_steps * serves * [pass_launches(l, True),
                                           pass_launches(l, False),
                                           pass_launches(s, True),
                                           pass_launches(s, False)]
    if evaluate:
        passes += evals + server_evals
        grouped += grouped_evals

    def total(ps, key, route=None):
        return sum(p[key][route] if route else p[key] for p in ps)
    launches = {
        "paged_attention": 0,
        "flash_attention": total(passes + grouped, "b"),
        "flash_attention_backward": total(passes + grouped, "b_bwd"),
        "lora_matmul": total(passes, "c", "wgmma")
        + total(passes, "c", "fma"),
        "lora_matmul_grouped": total(grouped, "c", "wgmma")
        + total(grouped, "c", "fma"),
        "gram_log_volume": d, "gram_log_volume_backward": d,
        "quantize_rows": 2 * k,
        "dequantize_rows": (3 if runner.channel.stateful else 2) * k,
        "ssd_chunk": total(passes + grouped, "g"),
        "ssd_chunk_bwd": total(passes + grouped, "g_bwd")}
    fma = {"lora_matmul": total(passes, "c", "fma"),
           "lora_matmul_grouped": total(grouped, "c", "fma")}
    return launches, fma


def frozen_fingerprint(tree):
    """(pointer, version counter, bit-pattern sum) of every frozen leaf."""
    import torch
    from repro_torch.core.lora import default_trainable, flatten
    return {k: (t.data_ptr(), t._version,
                int(torch.sum(t.view(torch.int16), dtype=torch.int64)))
            for k, t in flatten(tree).items() if not default_trainable(k)}


def trainable_copy(tree):
    from repro_torch.core.lora import partition
    return {k: v.clone() for k, v in partition(tree).items()}


ROUND_LLM_LAYERS = 4      # the server LLM's layers in the rounds (of 28)


def round_models(llm_layers=ROUND_LLM_LAYERS):
    """The paper's SLM and LLM at full width, with one 1280-wide connector
    latent on both: the reference's FederationSpec refuses the paper's
    pair as published (SLM latent 1280, LLM latent 4096).  The SLM keeps
    its depth; the LLM its first ``llm_layers`` layers (None: all 28)."""
    from repro_torch.configs.mlecs_paper import LLM, SLM
    llm = dataclasses.replace(LLM, connector_dim=1280)
    if llm_layers is not None:
        llm = dataclasses.replace(llm, n_layers=llm_layers)
    return dataclasses.replace(SLM, connector_dim=1280), llm


def round_corpus():
    from repro_torch.data.synthetic import synthetic_multimodal_corpus
    return synthetic_multimodal_corpus(
        0, CORPUS["n_samples"], CORPUS["seq_len"], CORPUS["vocab_size"],
        n_classes=CORPUS["n_classes"], n_modalities=CORPUS["n_modalities"],
        modality_dim=CORPUS["modality_dim"],
        template_len=CORPUS["template_len"])


def unmoved_leaves(before, runner):
    """Trainable leaves (of ``trainable_copy`` snapshots) that did not
    change since the snapshot."""
    import torch
    from repro_torch.core.lora import flatten
    now = {f"device{j}": p for j, p in enumerate(runner.device_params)}
    now.update(server_slm=runner.server_slm, server_llm=runner.server_llm)
    return [f"{n}:{k}" for n, leaves in before.items()
            for k, v in flatten(now[n]).items()
            if k in leaves and torch.equal(v, leaves[k])]


def snapshot_trainable(runner):
    out = {f"device{j}": trainable_copy(p)
           for j, p in enumerate(runner.device_params)}
    out.update(server_slm=trainable_copy(runner.server_slm),
               server_llm=trainable_copy(runner.server_llm))
    return out


def phase_training():
    import torch
    from repro_torch.core.federated import FederatedConfig, FederatedRunner
    from repro_torch.core.lora import default_trainable, flatten
    from repro_torch.models.model import build_model

    slm_cfg, llm_cfg = round_models()
    fcfg = FederatedConfig(**ROUND)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = FederatedRunner(fcfg, build_model(slm_cfg), build_model(llm_cfg),
                             round_corpus(), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # step timers and metric sinks around the runner's steps
    seconds = {"ccl": [], "amt": [], "seccl": []}
    metrics = []
    steps = {"ccl": runner.ccl_step, "amt": runner.amt_step,
             "seccl": runner.se_step}

    def timed(kind):
        fn = steps[kind]

        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds[kind].append(time.perf_counter() - t)
            metrics.append({k: float(v) for k, v in out[-1].items()})
            return out
        return run
    runner.ccl_step, runner.amt_step, runner.se_step = (
        timed("ccl"), timed("amt"), timed("seccl"))

    t0 = time.perf_counter()
    pre = runner.evaluate()["summary"]
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0

    trees = {"device_base": runner.cohort_base,
             "server_slm": runner.server_slm,
             "server_llm": runner.server_llm}
    frozen0 = {n: frozen_fingerprint(t) for n, t in trees.items()}
    train0 = snapshot_trainable(runner)

    # the main path, counted
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = runner.run_round()
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = read_counters()
    routes = check_tensor_core_routes("training round")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    post = out["summary"]

    # checks of the round
    for m in metrics + [pre, post]:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite {bad} in {m}")
    for c in out["client"] + [out["server"]]:
        if not all(math.isfinite(v) for v in c.values()):
            raise AssertionError(f"non-finite eval metrics {c}")
    for n, t in (("device_base", runner.cohort_base),
                 ("server_slm", runner.server_slm),
                 ("server_llm", runner.server_llm)):
        if frozen_fingerprint(t) != frozen0[n]:
            raise AssertionError(f"{n}: the frozen backbone changed")
    base = flatten(runner.cohort_base)
    for j, p in enumerate(runner.device_params):
        for k, v in flatten(p).items():
            if not default_trainable(k) and v is not base[k]:
                raise AssertionError(f"device {j}: {k} is not the shared "
                                     "backbone tensor")
    unmoved = unmoved_leaves(train0, runner)
    if unmoved:
        raise AssertionError(f"{len(unmoved)} trainable leaves did not "
                             f"move, e.g. {unmoved[:5]}")
    wsum = float(runner.agg_weights.sum())
    if abs(wsum - 1.0) > 1e-6:
        raise AssertionError(f"MMA weights sum to {wsum}")
    want = expected_round_launches(runner)
    if launches != want:
        raise AssertionError(f"launches {launches} != expected {want}")
    if runner.comm_stats["uplink_bytes"] <= 0:
        raise AssertionError("no upload was counted")

    def ms(kind):
        return 1e3 * statistics.mean(seconds[kind])

    training = {
        "slm": slm_cfg.name, "llm": llm_cfg.name, "dtype": slm_cfg.dtype,
        "connector_dim": slm_cfg.connector_dim, "remat": [slm_cfg.remat, llm_cfg.remat],
        "round": dict(ROUND),
        "batch_size": fcfg.batch_size, "lr": fcfg.lr, "rho": fcfg.rho,
        "n_negatives": fcfg.n_negatives,
        "tokens_per_sequence": CORPUS["seq_len"] + slm_cfg.n_soft_tokens,
        "mma_weights": [float(w) for w in runner.agg_weights],
        "ccl_step_ms": ms("ccl"), "amt_step_ms": ms("amt"),
        "seccl_step_ms": ms("seccl"),
        "steps": {k: len(v) for k, v in seconds.items()},
        "round_wall_s": round_s, "eval_ms": 1e3 * eval_s,
        "init_s": init_s,
        "pre": {k: pre[k] for k in ("avg_ce", "server_ce", "avg_acc")},
        "post": {k: post[k] for k in ("avg_ce", "server_ce", "avg_acc")},
        "peak_mem_gb": peak_gb,
        "launches_per_round": launches,
        "launches_by_route": routes,
        "uplink_bytes": runner.comm_stats["uplink_bytes"],
        "downlink_bytes": runner.comm_stats["downlink_bytes"],
        "first_step_metrics": metrics[0], "last_seccl_metrics": metrics[-1],
    }
    runner.ccl_step, runner.amt_step, runner.se_step = (
        steps["ccl"], steps["amt"], steps["seccl"])
    return runner, training, launches


TRAIN_GROUPS = (("lora_matmul", ("lora_matmul_kernel",)),
                ("gram_log_volume", ("gram_log_volume",)),
                ("flash_attention_forward", ("flash_attention_kernel",)),
                ("flash_attention_backward", ("flash_attention_bwd_",)),
                ("cublas", ("gemm", "xmma", "cutlass", "nvjet", "splitk",
                            "sm90_")))
# the range the earlier interim plain backward ran in: none may remain
INTERIM = "flash_attention.interim_backward"


def phase_training_profile(runner):
    """Profile one CCL step (device 0) and one SE-CCL step; the outputs
    are dropped, so the runner's state does not change."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    pub = runner.pull("pub/0")
    anchor = runner.anchors(pub)
    server = runner.pull("server")
    calls = {
        "ccl_step": lambda: runner.ccl_step(
            runner.device_params[0], runner.device_opt[0], pub, anchor),
        "seccl_step": lambda: runner.se_step(
            runner.server_llm, runner.server_slm, runner.server_llm_opt,
            runner.server_slm_opt, server),
    }
    result = {}
    for name, call in calls.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        busy, groups, top, n_ranges = _device_busy(
            prof, out_dir / f"trace_{name}.json", TRAIN_GROUPS, INTERIM)
        if n_ranges:
            raise AssertionError(f"{name}: {n_ranges} {INTERIM} ranges")
        if not groups.get("flash_attention_backward"):
            raise AssertionError(f"{name}: no backward kernel of B ran")
        result[name] = {
            "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": (1.0 - busy / wall) if busy
            else "not measured",
            "kernel_ms_by_group": groups, "top_kernels": top,
            "interim_backward_ranges": n_ranges}
    return result


def training_kernel_rows():
    """Rows for C and D at the round's shapes (bf16), from CUDA-graph
    replay; bounds from these inputs."""
    import torch
    from repro_torch.kernels.gram_volume import (
        gram_log_volume_backward_cuda, gram_log_volume_cuda,
        gram_log_volume_empty_cuda, gram_log_volume_plain,
        gram_log_volume_splits)
    from repro_torch.kernels.lora_matmul import (lora_matmul_cuda,
                                                 lora_matmul_plain,
                                                 lora_matmul_route)
    gen = torch.Generator(device="cuda").manual_seed(9)
    dt = torch.bfloat16
    rows = []

    # C: the LLM's projections carry most of the round's C time; the
    # SLM's forward and the LLM's dx (transposed W) are timed beside it.
    # Each shape also times the FMA route (every launch's kernel before
    # the wgmma route) on the same inputs.
    def c_case(M, K, N, r, trans_w, want="wgmma"):
        x, w, a, b = lora_inputs(gen, M, K, N, r, dt, trans_w=trans_w)
        route = lora_matmul_route(x, w, a, b, trans_w)
        if route != want:
            raise AssertionError(f"lora row: route {route}")
        ms = graph_ms(lambda i: lora_matmul_cuda(x, w, a, b, 2.0,
                                                 trans_w=trans_w))
        fma = graph_ms(lambda i: lora_matmul_cuda(x, w, a, b, 2.0,
                                                  trans_w=trans_w,
                                                  route="fma"))
        wt = w.t() if trans_w else w
        plain = graph_ms(lambda i: lora_matmul_plain(x, wt, a, b, 2.0))
        lib = graph_ms(lambda i: torch.matmul(x, wt))
        got = lora_matmul_cuda(x, w, a, b, 2.0, trans_w=trans_w)
        err = check_close("lora row", got, lora_matmul_plain(x, wt, a, b,
                                                             2.0), BF16_TOL)
        es = x.element_size()
        bytes_ = (M * K + K * N + K * r + r * N + M * N) * es
        flops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
        bound, by = _bound(bytes_, flops)
        return {"ms": ms, "ms_fma_route": fma, "plain_ms": plain,
                "library_ms": lib, "bound_ms": bound, "bound_by": by,
                "max_abs_err": err, "kernel_route": route,
                "shape": {"M": M, "K": K, "N": N, "r": r,
                          "trans_w": trans_w, "dtype": str(dt)}}

    main = c_case(1088, 4096, 4096, 8, False)
    others = {"slm_forward": c_case(1088, 1280, 1280, 8, False),
              "slm_dx_transposed_w": c_case(1088, 1280, 1280, 8, True),
              "llm_dx_transposed_w": c_case(1088, 4096, 4096, 8, True),
              "qwen3_q_o_forward": c_case(1088, 2048, 2048, 8, False),
              "qwen3_k_v_forward": c_case(1088, 2048, 1024, 8, False),
              "qwen3_q_o_dx": c_case(1088, 2048, 2048, 8, True),
              "qwen3_k_v_dx": c_case(1088, 1024, 2048, 8, True),
              # the ssm_training phase: mamba2's in_proj, and hymba's, whose
              # N = 6,482 (no multiple of 8) takes the FMA route both ways
              "mamba2_in_proj_forward": c_case(1088, 2560, 10576, 8, False),
              "hymba_in_proj_forward_fma": c_case(1088, 1600, 6482, 8, False,
                                                  want="fma"),
              "hymba_in_proj_dx_fma": c_case(1088, 6482, 1600, 8, True,
                                             want="fma")}
    rows.append({
        "name": "lora_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_matmul.py:55",
        "max_abs_err": max([main["max_abs_err"]]
                           + [o["max_abs_err"] for o in others.values()]),
        "tolerance": BF16_TOL,
        **{k: main[k] for k in ("ms", "ms_fma_route", "plain_ms",
                                "bound_ms", "bound_by", "library_ms",
                                "kernel_route", "shape")},
        "ms_fma_route_is": "the FMA route on the same inputs in this run",
        "library_call": "torch.matmul(x, W): the dense part alone (no "
                        "single PyTorch call computes the whole function)",
        "at_other_shapes": others,
    })

    # D: the CCL loss's 2 x (1 + 4) x 8 = 80 candidate sets of 1 + 3 rows.
    # Each pass times the kernel (every main-path launch) and an empty
    # kernel launched as it launches (the launch floor), replays in turn.
    B, k, d = 80, 4, 1280
    S = gram_log_volume_splits(B, k, d, dt.itemsize)
    S_bwd = gram_log_volume_splits(B, k, d, dt.itemsize, backward=True)
    vs, mask = gram_inputs(gen, B, k, d, dt)
    gout = torch.randn((B,), generator=gen, device="cuda")
    got, dots = gram_log_volume_cuda(vs, mask, return_dots=True)
    err = check_close("gram row", got, gram_log_volume_plain(vs, mask),
                      GRAM_TOL)
    t = graphs_ms({
        "kernel": lambda i: gram_log_volume_cuda(vs, mask),
        "floor": lambda i: gram_log_volume_empty_cuda(B * S, S)})
    plain = graph_ms(lambda i: gram_log_volume_plain(vs, mask))
    wide = gram_wide_sample(gen, dt)
    bytes_ = B * k * d * vs.element_size() + B * k + B * 4
    flops = B * (k * (k + 1) // 2 * 2 * d + k ** 3)
    bound, by = _bound(bytes_, flops, F32_FLOP_PER_S)
    shape = {"B": B, "k": k, "d": d, "dtype": str(dt), "splits": S}
    rows.append({
        "name": "gram_log_volume", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram_volume.cu",
        "replaces": "src/repro/kernels/gram_volume.py:56",
        "max_abs_err": err, "tolerance": GRAM_TOL, "ms": t["kernel"],
        "launch_floor_ms": t["floor"],
        "launch_floor_is": "an empty kernel launched as the kernel "
                           "launches (grid, cluster, PDL)",
        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "bound_counts": "the function's bytes: vs and the mask read once, "
                        "y written once (not the dots the kernel also "
                        "writes, B k k f32)",
        "library_ms": None, "shape": shape,
        "at_other_shapes": {"one_wide_sample": wide["forward"]}})

    vg = vs.clone().requires_grad_(True)
    want = torch.autograd.grad(gram_log_volume_plain(vg, mask), vg, gout)[0]
    err = rel_check("gram bwd row",
                    gram_log_volume_backward_cuda(vs, mask, gout, dots),
                    want, BF16_TOL, floor=GRAM_GRAD_FLOOR)
    t = graphs_ms({
        "kernel": lambda i: gram_log_volume_backward_cuda(vs, mask, gout,
                                                          dots),
        "floor": lambda i: gram_log_volume_empty_cuda(B * S_bwd)})

    def plain_bwd(i):
        v = vs.detach().requires_grad_(True)
        return torch.autograd.grad(gram_log_volume_plain(v, mask), v, gout)
    plain = graph_ms(plain_bwd)
    bytes_ = 2 * B * k * d * vs.element_size() + B * k + B * 4
    flops = B * (k * (k + 1) * d + 2 * k * k * d + 3 * k ** 3)
    bound, by = _bound(bytes_, flops, F32_FLOP_PER_S)
    rows.append({
        "name": "gram_log_volume_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram_volume.cu",
        "replaces": "src/repro/kernels/gram_volume.py:56 (its gradient; "
                    "the TPU kernel is forward only)",
        "max_abs_err": err["max_abs_err"], "max_rel_err": err["max_rel_err"],
        "grad_scale": err["scale"],
        "tolerance": "2e-2 + 1e-2 |x| on each sample divided by the larger "
        "of its largest |gradient| and 0.1 x the batch's",
        "ms": t["kernel"], "launch_floor_ms": t["floor"],
        "launch_floor_is": "an empty kernel launched as the backward "
                           "launches (grid, PDL)",
        "plain_ms": plain, "plain_is": "autograd of the plain forward "
        "(forward included)", "bound_ms": bound, "bound_by": by,
        "bound_counts": "one read of vs and one write of dvs (the mask and "
                        "dL/dy beside them)",
        "library_ms": None, "shape": {**shape, "splits": S_bwd},
        "at_other_shapes": {"one_wide_sample": wide["backward"]}})
    return rows


def gram_wide_sample(gen, dt):
    """D on one wide sample (B 1, k 8, d 4096), where the split rule
    splits: ms per launch, forward and backward, at the splits the rule
    picks, replays in turn."""
    import torch
    from repro_torch.kernels.gram_volume import (
        gram_log_volume_backward_cuda, gram_log_volume_cuda,
        gram_log_volume_splits)
    B, k, d = 1, 8, 4096
    vs = torch.randn((B, k, d), generator=gen, device="cuda").to(dt)
    mask = torch.ones((B, k), dtype=torch.bool, device="cuda")
    gout = torch.ones((B,), device="cuda")
    _, dots = gram_log_volume_cuda(vs, mask, return_dots=True)
    t = graphs_ms({"forward": lambda i: gram_log_volume_cuda(vs, mask),
                   "backward": lambda i: gram_log_volume_backward_cuda(
                       vs, mask, gout, dots)})
    return {p: {"shape": {"B": B, "k": k, "d": d, "dtype": str(dt),
                          "splits": gram_log_volume_splits(
                              B, k, d, vs.element_size(), p == "backward")},
                "ms": t[p]}
            for p in ("forward", "backward")}


# ---------------------------------------------------------------------------
# phase 8: two rounds over the int8 wire

CHANNEL_ROUND = dict(n_devices=3, local_steps_ccl=1, local_steps_amt=1,
                     server_steps=1, engine="loop", seed=0)
CHANNEL_ROUNDS = 2
# |x - deQ(Q(x))| <= scale / 2 exactly; f32 rounds x / scale and q * scale
STEP_SLACK = 1e-4


def wire_steps(ch, x, qmax):
    """(tile rows of x, each row's quantization step) for a stacked
    (N, ...) f32 tensor encoded by channel ``ch`` (plain version)."""
    from repro_torch.kernels.quantize import quantize_rows_plain
    rows = ch._to_rows(x.float())
    return rows, quantize_rows_plain(rows, qmax)[1][:, None]


def expected_comm_stats(runner, rounds):
    """The int8 wire's bytes from the upload templates: per leaf and
    client L codes and ceil(L / block) f32 scales."""
    N, block = runner.cfg.n_devices, runner.channel.spec.block
    leaves = [math.prod(t.shape[1:]) for t in runner.up_like.values()]
    per_client = sum(n + 4 * -(-n // block) for n in leaves)
    dense = sum(n * t.dtype.itemsize for n, t in
                zip(leaves, runner.up_like.values()))
    f32 = 4 * sum(leaves)
    return {"codec": "int8", "rounds": rounds,
            "uplink_bytes": rounds * N * per_client,
            "uplink_dense_bytes": rounds * N * dense,
            "uplink_f32_bytes": rounds * N * f32,
            "uplink_ratio": dense / per_client,
            "uplink_ratio_f32": f32 / per_client,
            "downlink_bytes": rounds * per_client,
            "uplink_client_bytes": {0: per_client}}


def phase_channel():
    """Two rounds of the round's federation over ChannelSpec("int8") with
    error feedback, without evaluation; every kernel counted per round."""
    import torch
    from repro_torch.core.channel import ChannelSpec
    from repro_torch.core.federated import FederatedConfig, FederatedRunner
    from repro_torch.core.lora import is_lora_leaf, partition
    from repro_torch.models.model import build_model

    slm_cfg, llm_cfg = round_models()
    spec = ChannelSpec(codec="int8")
    fcfg = FederatedConfig(channel=spec, **CHANNEL_ROUND)
    allocated_before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    runner = FederatedRunner(fcfg, build_model(slm_cfg), build_model(llm_cfg),
                             round_corpus(), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    N, qmax = fcfg.n_devices, 127

    metrics = []
    steps = {"ccl": runner.ccl_step, "amt": runner.amt_step,
             "seccl": runner.se_step}

    def logged(fn):
        def run(*args):
            out = fn(*args)
            metrics.append({k: float(v) for k, v in out[-1].items()})
            return out
        return run
    runner.ccl_step, runner.amt_step, runner.se_step = (
        logged(steps["ccl"]), logged(steps["amt"]), logged(steps["seccl"]))

    # what crosses the wire: the uplink's encoded input (uploads plus the
    # carried residuals) and what the server decodes, and the downlink
    ch, wire = runner.channel, {}
    roundtrip, roundtrip_tree = ch.roundtrip, ch.roundtrip_tree

    def rec_roundtrip(flat, state=None, rnd=0):
        dec, new_state = roundtrip(flat, state, rnd)
        if next(iter(flat.values())).shape[0] == N:
            wire["up_in"] = {k: v.float() + (state[k] if state else 0.0)
                             for k, v in flat.items()}
            wire["up_dec"] = dec
        return dec, new_state

    def rec_tree(tree, rnd=0):
        wire["down"] = roundtrip_tree(tree, rnd)
        return wire["down"]
    ch.roundtrip, ch.roundtrip_tree = rec_roundtrip, rec_tree

    train0 = snapshot_trainable(runner)
    K = len(runner.up_like)
    rounds, total = [], {}
    torch.cuda.reset_peak_memory_stats()
    for r in range(CHANNEL_ROUNDS):
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.run_round(evaluate=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        routes = check_tensor_core_routes(f"channel round {r}")
        want = expected_round_launches(runner, evaluate=False)
        if launches != want:
            raise AssertionError(f"channel round {r}: launches {launches} "
                                 f"!= expected {want}")
        if (launches["quantize_rows"], launches["dequantize_rows"]) != \
                (2 * K, 3 * K):
            raise AssertionError(f"channel round {r}: E/F launches")
        total = {n: total.get(n, 0) + v for n, v in launches.items()}

        # residuals and decoded uploads against their tiles' steps
        res_ratio = dec_ratio = 0.0
        nonzero = 0
        for k, x in wire["up_in"].items():
            rows, step = wire_steps(ch, x, qmax)
            e = ch._to_rows(runner.chan_state[k])
            if bool((e.abs() > step * (0.5 + STEP_SLACK)).any()):
                raise AssertionError(f"round {r} {k}: residual beyond half "
                                     "a step")
            nonzero += int((e != 0).sum())
            d = ch._to_rows(wire["up_dec"][k].float())
            # the decoded upload is rounded to the leaf's bf16 on decode
            if bool(((d - rows).abs() > step * (0.5 + STEP_SLACK)
                     + d.abs() * 2.0 ** -8).any()):
                raise AssertionError(f"round {r} {k}: decoded upload beyond "
                                     "half a step")
            safe = step.clamp(min=1e-30)
            res_ratio = max(res_ratio, float((e.abs() / safe).max()))
            dec_ratio = max(dec_ratio, float(((d - rows).abs() / safe).max()))
        if not nonzero:
            raise AssertionError(f"round {r}: every residual is zero")

        # the devices hold exactly the decoded downlink; the server SLM
        # keeps its own (undecoded) values
        for j, p in enumerate(runner.device_params):
            ups = partition(p, is_lora_leaf)
            if sorted(ups) != sorted(wire["down"]) or not all(
                    bits_equal(ups[k].float(), v.float())
                    for k, v in wire["down"].items()):
                raise AssertionError(f"round {r}: device {j} does not hold "
                                     "the decoded downlink")
        srv = partition(runner.server_slm, is_lora_leaf)
        if all(torch.equal(srv[k], v) for k, v in wire["down"].items()):
            raise AssertionError(f"round {r}: the server SLM holds the "
                                 "decoded downlink")
        rounds.append({"wall_s": wall, "launches": launches,
                       "launches_by_route": routes,
                       "max_residual_over_step": res_ratio,
                       "max_decode_err_over_step": dec_ratio,
                       "nonzero_residuals": nonzero})
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    for m in metrics:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite {bad} in {m}")
    unmoved = unmoved_leaves(train0, runner)
    if unmoved:
        raise AssertionError(f"{len(unmoved)} trainable leaves did not "
                             f"move, e.g. {unmoved[:5]}")
    shapes = sorted({tuple(t.shape[1:]) for t in runner.up_like.values()})
    stats = runner.comm_stats
    want = expected_comm_stats(runner, CHANNEL_ROUNDS)
    if stats != want:
        raise AssertionError(f"comm_stats {stats} != {want}")
    ch.roundtrip, ch.roundtrip_tree = roundtrip, roundtrip_tree
    result = {
        "slm": slm_cfg.name, "llm": llm_cfg.name, "dtype": slm_cfg.dtype,
        "channel": dataclasses.asdict(spec), "round": dict(CHANNEL_ROUND),
        "rounds": rounds, "evaluate": False, "init_s": init_s,
        "peak_mem_gb": peak_gb, "allocated_before_gb": allocated_before,
        "lora_leaves": K,
        "lora_leaf_shapes": shapes, "comm_stats": stats,
        "step_slack": STEP_SLACK, "steps": len(metrics),
        "first_step_metrics": metrics[0], "last_step_metrics": metrics[-1],
    }
    return result, total


def channel_kernel_rows():
    """Rows for E, F and B's backward at the rounds' shapes, from CUDA-graph
    replay; bounds from these inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_backward_plain,
        flash_attention_backward_route, flash_attention_cuda)
    from repro_torch.kernels.quantize import (
        WARPS_PER_BLOCK, dequantize_rows_cuda, dequantize_rows_plain,
        quantize_empty_cuda, quantize_rows_cuda, quantize_rows_grid,
        quantize_rows_plain)
    from repro_torch.models.layers import BIG_WINDOW
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []

    # E and F: one LoRA leaf of the uplink, 3 clients x 2,880 tiles of 128
    # f32 values (the leaf plus its residual); E also times an empty kernel
    # launched as it launches (the launch floor), replays in turn
    R, L = QUANT_SHAPES["uplink"]
    x = torch.randn((R, L), generator=gen, device="cuda") * 0.02
    q, s = quantize_rows_cuda(x, 127)
    pq, ps = quantize_rows_plain(x, 127)
    if not (bits_equal(q, pq) and bits_equal(s, ps)):
        raise AssertionError("quantize row: differs from the plain version")
    grid, rpw = quantize_rows_grid(
        R, True, torch.cuda.get_device_properties(0).multi_processor_count)
    t = graphs_ms({"kernel": lambda i: quantize_rows_cuda(x, 127),
                   "floor": lambda i: quantize_empty_cuda(
                       grid, 32 * WARPS_PER_BLOCK)})
    plain = graph_ms(lambda i: quantize_rows_plain(x, 127))
    bound, by = _bound(R * L * 4 + R * L + 4 * R, 5 * R * L, F32_FLOP_PER_S)
    rows.append({
        "name": "quantize_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:49",
        "max_abs_err": 0.0, "tolerance": "bit for bit", "ms": t["kernel"],
        "launch_floor_ms": t["floor"],
        "launch_floor_is": "an empty kernel launched as the kernel "
                           "launches (grid, PDL)",
        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes per-row "
                        "abs-max codes and scales",
        "shape": {"R": R, "L": L, "qmax": 127, "dtype": str(x.dtype),
                  "grid": grid, "rows_per_warp": rpw}})

    out = dequantize_rows_cuda(q, s)
    if not bits_equal(out, dequantize_rows_plain(q, s)):
        raise AssertionError("dequantize row: differs from the plain version")
    ms = graph_ms(lambda i: dequantize_rows_cuda(q, s))
    plain = graph_ms(lambda i: dequantize_rows_plain(q, s))
    lib = graph_ms(lambda i: torch.mul(q, s[:, None]))
    bound, by = _bound(R * L + 4 * R + 4 * R * L, R * L, F32_FLOP_PER_S)
    rows.append({
        "name": "dequantize_rows", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quantize.cu",
        "replaces": "src/repro/kernels/quantize.py:71",
        "max_abs_err": 0.0, "tolerance": "bit for bit", "ms": ms,
        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": lib, "library_call": "torch.mul(q, scale[:, None])",
        "shape": {"R": R, "L": L, "dtype": "int8 -> float32"}})

    # B's backward at the LLM's, the SLM's and qwen3's training shapes
    # (bf16; qwen3's 16 query heads over 8 KV heads)
    def b_case(B, S, H, D, K=None):
        dt = torch.bfloat16
        K = K or H
        q, do = (torch.randn((B, S, H, D), generator=gen,
                             device="cuda").to(dt) for _ in range(2))
        k, v = (torch.randn((B, S, K, D), generator=gen,
                            device="cuda").to(dt) for _ in range(2))
        o, lse = flash_attention_cuda(q, k, v, True, BIG_WINDOW,
                                      with_lse=True)
        args = (q, k, v, o, do, lse, True, BIG_WINDOW)
        route = flash_attention_backward_route(q, k, v)
        if route != "mma":
            raise AssertionError(f"flash bwd row: route {route}")
        got = flash_attention_backward_cuda(*args)
        want = flash_attention_backward_plain(*args)
        err = max((grad_rows("flash bwd row", g, w, BF16_TOL) for g, w in
                   zip(got, want)), key=lambda e: e["max_rel_err"])
        ms = graph_ms(lambda i: flash_attention_backward_cuda(*args))
        fma = graph_ms(lambda i: flash_attention_backward_cuda(
            *args, route="fma"))
        plain = graph_ms(lambda i: flash_attention_backward_plain(*args))
        # SDPA's backward: forward + backward less the forward alone
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa(i):
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
        both = graph_ms(lambda i: torch.autograd.grad(sdpa(i), (qt, kt, vt),
                                                      dot))
        fwd = graph_ms(sdpa)
        es = q.element_size()
        n, nk = B * S * H * D, B * S * K * D
        # read q, k, v, o, do and lse; write dq, dk, dv
        bytes_ = (3 * n + 2 * nk) * es + B * H * S * 4 + (n + 2 * nk) * es
        flops = 10 * D * B * H * S * (S + 1) // 2
        bound, by = _bound(bytes_, flops)
        return {"ms": ms, "ms_fma_route": fma, "kernel_route": route,
                "plain_ms": plain, "library_ms": both - fwd,
                "library_fwd_bwd_ms": both, "library_fwd_ms": fwd,
                "bound_ms": bound, "bound_by": by,
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"],
                "shape": {"B": B, "S": S, "H": H, "K": K, "D": D,
                          "dtype": str(dt)}}

    main = b_case(8, 136, 16, 256)
    rows.append({
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105 (its "
                    "gradient; the TPU kernel is forward only)",
        "tolerance": "2e-2 + 1e-2 |x| on each (position, head) row of D "
                     "divided by the larger of its largest |gradient| and "
                     "0.1 x the tensor's",
        **main,
        "ms_fma_route_is": "the FMA route on the same inputs in this run",
        "bound_counts": "5 products over the visible pairs (2 recomputed, "
                        "3 of the gradient)",
        "library_call": "scaled_dot_product_attention(enable_gqa=True): "
                        "forward + backward less the forward",
        "at_other_shapes": {"slm": b_case(8, 136, 20, 64),
                            "qwen3": b_case(8, 136, 16, 128, K=8)}})
    return rows

# ---------------------------------------------------------------------------
# phase 8b: heterogeneous cohorts under client faults, then CohortServer

HET_ROUNDS = 2
HET_FAULTS = dict(dropout=0.2, straggler=0.2, max_delay=2, byzantine=0.15,
                  attack="scaled_update", attack_scale=10.0, seed=3)
HET_TRIM = 0.2
HET_SERVE_REQUESTS = 8


def het_models():
    """SLM', QWEN' and LLM': the paper's SLM, qwen3-1.7b and the paper's
    LLM at their published widths and depths, each with the one 1280-wide
    connector latent the reference demands of every model of a federation
    (qwen3 also with the SLM's modality width, soft tokens and LoRA rank;
    its backbone is unchanged)."""
    from repro_torch.configs.qwen3_1p7b import CONFIG as QWEN
    slm, llm = round_models()
    qwen = dataclasses.replace(QWEN, connector_dim=1280, modality_dim=256,
                               n_soft_tokens=8, lora_rank=8)
    return slm, qwen, llm


def het_spec():
    """Three cohorts: 3 SLM' clients on modalities 0-1, 2 SLM' clients on
    modality 2 (rho 0.9, batch 4), 2 QWEN' clients; LLM' on the server.
    Trimmed-mean MMA under dropout, stragglers and one Byzantine client
    that scales its upload by 10."""
    from repro_torch.core.spec import ClientCohort, FaultSpec, FederationSpec
    slm, qwen, llm = het_models()
    return FederationSpec(
        cohorts=(ClientCohort(slm, 3, "av-edge", modalities=(0, 1)),
                 ClientCohort(slm, 2, "sub-edge", modalities=(2,), rho=0.9,
                              batch_size=4),
                 ClientCohort(qwen, 2, "qwen-edge")),
        server_llm=llm, rounds=HET_ROUNDS, local_steps_ccl=1,
        local_steps_amt=1, server_steps=1, engine="loop", seed=0,
        robust="trimmed_mean", trim_frac=HET_TRIM,
        faults=FaultSpec(**HET_FAULTS))


def trimmed_combine_f64(payloads, weights, contrib, shared, trim_frac):
    """The cross-cohort trimmed mean of the shared keys, recomputed on the
    host in float64 from the uploads the server received: per key, the
    sharing cohorts' clients in cohort order, the absent and late ones
    out, k = min(floor(trim_frac m), floor((m - 1) / 2)) values dropped
    from each end per coordinate (stable ranks: ties keep client order),
    the kept values averaged under their weights.  Returns {key: (ref,
    scale, k)}, scale the weighted mean of |kept values|."""
    import numpy as np
    parts = {}
    for c, ks in enumerate(shared):
        for k in ks:
            parts.setdefault(k, []).append(c)
    out = {}
    for k, cs in sorted(parts.items()):
        x = np.concatenate([payloads[c][k].float().cpu().numpy()
                            for c in cs]).astype(np.float64)
        w = np.concatenate([weights[c] for c in cs]).astype(np.float64)
        p = np.concatenate([contrib[c] for c in cs]).astype(bool)
        if not (w * p).sum() > 0.0:
            continue
        m = int(p.sum())
        kk = min(math.floor(trim_frac * m), (m - 1) // 2)
        pb = p.reshape((-1,) + (1,) * (x.ndim - 1))
        order = np.argsort(np.where(pb, x, np.inf), axis=0, kind="stable")
        ranks = np.argsort(order, axis=0, kind="stable")
        wk = w.reshape(pb.shape) * ((ranks >= kk) & (ranks < m - kk) & pb)
        out[k] = ((x * wk).sum(0) / wk.sum(0),
                  (np.abs(x) * wk).sum(0) / wk.sum(0), kk)
    return out


def aggregate_err(agg, ref, what):
    """The largest error of the device aggregate ``agg`` against the host's
    ``ref`` (from :func:`trimmed_combine_f64`) over bf16 rounding: half an
    ulp of the value plus one of the kept values' scale in f32 sums.
    Fails above 1."""
    import numpy as np
    if sorted(ref) != sorted(agg) or not ref:
        raise AssertionError(f"{what}: aggregated keys differ")
    worst = 0.0
    for k, (want, scale, _) in ref.items():
        got = agg[k].float().cpu().numpy().astype(np.float64)
        bound = 2.0 ** -8 * np.abs(want) + 2.0 ** -20 * scale + 1e-30
        ratio = float((np.abs(got - want) / bound).max())
        if ratio > 1.0:
            raise AssertionError(f"{what} {k}: aggregate off the host's by "
                                 f"{ratio} x bf16 rounding")
        worst = max(worst, ratio)
    return worst


def biting_trim_check(runner, payloads):
    """The port's cross-cohort trimmed mean at a trim that bites, on the
    round's decoded device uploads: every upload of the cohorts that share
    keys with the server counted present (the offline and late ones too),
    under the base weights, so k = 1 of the 5 SLM uploads per coordinate
    at trim_frac 0.2.  Holds ``mma.robust_combine_cohorts`` against the
    host's float64 recomputation, requires k > 0 on every key and the
    trimmed result to differ from the untrimmed weighted mean by more than
    the tolerance somewhere (else a wrong trim band could pass)."""
    import numpy as np
    from repro_torch.core import mma
    rts = [rt for rt in runner.cohorts if rt.shared]
    w = runner.agg_weights.float().cpu().numpy()
    ws = [w[rt.slice] for rt in rts]
    ups = [payloads[rt.idx] for rt in rts]
    shared = [rt.shared for rt in rts]
    ones = [np.ones(rt.n, np.float32) for rt in rts]
    agg = mma.robust_combine_cohorts(
        ups, ws, shared, runner._server_lora_dtypes, "trimmed_mean",
        present=ones, trim_frac=HET_TRIM)
    ref = trimmed_combine_f64(ups, ws, ones, shared, HET_TRIM)
    ks = sorted({kk for _, _, kk in ref.values()})
    if not ks or ks[0] < 1:
        raise AssertionError(f"the biting trim drops k = {ks}")
    err = aggregate_err(agg, ref, "biting trim")
    plain = trimmed_combine_f64(ups, ws, ones, shared, 0.0)
    effect = 0.0
    for k, (want, scale, _) in ref.items():
        bound = 2.0 ** -8 * np.abs(want) + 2.0 ** -20 * scale + 1e-30
        effect = max(effect, float((np.abs(plain[k][0] - want)
                                    / bound).max()))
    if not effect > 1.0:
        raise AssertionError(f"the biting trim moves the mean by only "
                             f"{effect} x bf16 rounding")
    return {"uploads": sum(rt.n for rt in rts), "trim_k": ks,
            "keys": len(ref), "max_err_over_bf16_rounding": err,
            "trim_effect_over_bf16_rounding": effect}


def phase_heterogeneous_round():
    """Two rounds of the heterogeneous federation on the loop engine
    (evaluation on the second only), every check of the round, then
    CohortServer on the trained cohort parameters."""
    import numpy as np
    import torch
    from repro_torch.core.federated import FederatedRunner
    from repro_torch.core.lora import default_trainable, flatten, \
        is_lora_leaf, partition

    spec = het_spec()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = FederatedRunner(spec, round_corpus(), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    names = [c.name for c in spec.cohorts]

    # per-cohort step timers and metric sinks
    seconds, metrics = {}, []

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds.setdefault(key, []).append(time.perf_counter() - t)
            metrics.append({k: float(v) for k, v in out[-1].items()})
            return out
        return run
    for rt, name in zip(runner.cohorts, names):
        rt.ccl_step = timed(rt.ccl_step, f"{name}/ccl")
        rt.amt_step = timed(rt.amt_step, f"{name}/amt")
    runner.se_step = timed(runner.se_step, "server/seccl")

    # what the robust combine saw and gave, each round
    combines = []
    robust_combine = runner._robust_combine

    def recording(payloads):
        agg, own = robust_combine(payloads)
        combines.append({"payloads": payloads, "agg": agg,
                         "w": runner._active_weights().copy(),
                         "contrib": runner._rnd_contrib.copy()})
        return agg, own
    runner._robust_combine = recording

    trees = {f"base/{n}": b for n, b in zip(names, runner.cohort_bases)}
    trees.update(server_slm=runner.server_slm, server_llm=runner.server_llm)
    frozen0 = {n: frozen_fingerprint(t) for n, t in trees.items()}
    lora_bytes = [sum(v.numel() * v.element_size() for v in partition(
        rt.device_params[0], is_lora_leaf).values()) for rt in runner.cohorts]

    rounds, total, out = [], {}, None
    servers0 = {n: t for n, t in snapshot_trainable(runner).items()
                if n.startswith("server")}
    torch.cuda.reset_peak_memory_stats()
    for r in range(HET_ROUNDS):
        before = snapshot_trainable(runner)
        evaluate = r == HET_ROUNDS - 1
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.run_round(evaluate=evaluate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        routes = check_tensor_core_routes(f"heterogeneous round {r}")
        want = expected_round_launches(runner, evaluate=evaluate)
        if launches != want:
            raise AssertionError(f"heterogeneous round {r}: launches "
                                 f"{launches} != expected {want}")
        total = {n: total.get(n, 0) + v for n, v in launches.items()}
        pres = runner._rnd_present.copy()
        contrib = runner._rnd_contrib.copy()
        if abs(float(runner._rnd_weights.sum()) - 1.0) > 1e-6:
            raise AssertionError(f"round {r}: weights sum to "
                                 f"{runner._rnd_weights.sum()}")

        # offline clients untouched, present clients' leaves moved
        for j, p in enumerate(runner.device_params):
            leaves, cur = before[f"device{j}"], flatten(p)
            same = [k for k, v in leaves.items() if torch.equal(cur[k], v)]
            if not pres[j] and len(same) != len(leaves):
                raise AssertionError(f"round {r}: offline client {j} "
                                     "changed")
            if pres[j] and same:
                raise AssertionError(f"round {r}: client {j}: {len(same)} "
                                     f"leaves did not move, e.g. {same[:3]}")

        # the server SLM's aggregate against the host's float64 trimmed,
        # renormalized cross-cohort combine of the same decoded uploads
        rec = combines[-1]
        w, cb = rec["w"], rec["contrib"]
        ref = trimmed_combine_f64(
            rec["payloads"], [w[rt.slice] for rt in runner.cohorts],
            [cb[rt.slice] for rt in runner.cohorts],
            [rt.shared for rt in runner.cohorts], HET_TRIM)
        worst = aggregate_err(rec["agg"], ref, f"round {r}")
        # k dropped from each end per key: the shared keys' (from the
        # host recomputation) and each cohort's own keys'
        trim_k = {"shared": {}}
        for _, _, kk in ref.values():
            trim_k["shared"][kk] = trim_k["shared"].get(kk, 0) + 1
        for rt, name in zip(runner.cohorts, names):
            if rt.own:
                m = int(cb[rt.slice].sum())
                trim_k[f"own/{name}"] = {
                    min(math.floor(HET_TRIM * m), (m - 1) // 2)
                    if m else 0: len(rt.own)}
        bite = biting_trim_check(runner, rec["payloads"])

        # bytes: present clients x each cohort's LoRA bytes up, each
        # cohort's leaves once down
        n_pres = [int(pres[rt.slice].sum()) for rt in runner.cohorts]
        want_up = sum(n * b for n, b in zip(n_pres, lora_bytes))
        if runner.comm_log[-1] != {"round": r, "uplink": want_up,
                                   "downlink": sum(lora_bytes)}:
            raise AssertionError(f"round {r}: comm_log {runner.comm_log[-1]}"
                                 f" != {want_up} up, {sum(lora_bytes)} down")
        rounds.append({
            "wall_s": wall, "evaluate": evaluate,
            "present": pres.astype(int).tolist(),
            "on_time": contrib.astype(int).tolist(),
            "weights": [float(x) for x in runner._rnd_weights],
            "launches": launches, "launches_by_route": routes,
            "aggregate_keys": len(ref),
            "max_aggregate_err_over_bf16_rounding": worst,
            "trim_k": trim_k, "biting_trim": bite})
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del combines

    # the servers' leaves moved over the rounds (a LoRA A leaf gets no
    # gradient while its B is still zero: in the first SE-CCL step)
    unmoved = [n for n in unmoved_leaves(servers0, runner)
               if n.startswith("server")]
    if unmoved:
        raise AssertionError(f"{len(unmoved)} server leaves did not move, "
                             f"e.g. {unmoved[:3]}")
    stats = runner.comm_stats
    if stats["uplink_client_bytes"] != dict(enumerate(lora_bytes)) or \
            stats["uplink_bytes"] != sum(x["uplink"] for x in
                                         runner.comm_log):
        raise AssertionError(f"comm_stats {stats}")
    for m in metrics + [out["summary"]] + out["client"] + [out["server"]]:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite {bad} in {m}")
    for n, t in trees.items():
        if frozen_fingerprint(t) != frozen0[n]:
            raise AssertionError(f"{n}: the frozen backbone changed")
    for rt, base in zip(runner.cohorts, runner.cohort_bases):
        bflat = flatten(base)
        for i, p in enumerate(rt.device_params):
            for k, v in flatten(p).items():
                if not default_trainable(k) and v is not bflat[k]:
                    raise AssertionError(f"{names[rt.idx]} client {i}: {k} "
                                         "is not the cohort's backbone")
    shared = [len(rt.shared) for rt in runner.cohorts]
    own = [len(rt.own) for rt in runner.cohorts]
    if shared[0] != shared[1] or shared[0] == 0 or shared[2] != 0 \
            or own[:2] != [0, 0] or own[2] == 0:
        raise AssertionError(f"shared keys {shared}, own keys {own}")

    result = {
        "cohorts": [{"name": c.name, "model": c.model.name,
                     "clients": c.n_clients, "modalities": c.modalities,
                     "rho": spec.cohort_rho(i),
                     "batch_size": spec.cohort_batch_size(i),
                     "layers": c.model.n_layers, "d_model": c.model.d_model,
                     "heads": [c.model.n_heads, c.model.n_kv_heads,
                               c.model.head_dim],
                     "shared_keys": shared[i], "own_keys": own[i],
                     "lora_bytes_per_client": lora_bytes[i]}
                    for i, c in enumerate(spec.cohorts)],
        "server_llm": spec.server_llm.name, "dtype": spec.server_llm.dtype,
        "connector_dim": 1280, "robust": spec.robust,
        "trim_frac": spec.trim_frac, "faults": HET_FAULTS,
        "byzantine": runner._faults.byzantine.astype(int).tolist(),
        "masks": runner.masks.astype(int).tolist(),
        "init_s": init_s, "rounds": rounds,
        "step_ms": {k: 1e3 * statistics.mean(v) for k, v in seconds.items()},
        "steps": {k: len(v) for k, v in seconds.items()},
        "round_wall_s": [x["wall_s"] for x in rounds],
        "peak_mem_gb": peak_gb,
        "summary": out["summary"],
        "comm_stats": stats,
        "first_step_metrics": metrics[0], "last_seccl_metrics": [
            m for m in metrics if "kt_llm" in m][-1],
    }
    serving, serve_launches, paged_qwen = phase_cohort_serving(runner, spec)
    result["serving"] = serving
    return result, total, serve_launches, paged_qwen


def phase_cohort_serving(runner, spec):
    """CohortServer on the trained parameters of each cohort's first client
    (merged): 8 soft-prompted requests a cohort, prompts of 20-240 tokens,
    budgets of 16-64, round-robin.  Checks budgets, free lists and the A
    and B launch counts, holds qwen3's prefill -> decode logits against a
    full forward, and times A at qwen3's fullest decode step."""
    import numpy as np
    import torch
    from repro_torch.launch.serve_engine import CohortServer, EngineConfig
    from repro_torch.models.layers import BIG_WINDOW, padded_vocab

    params = [rt.device_params[0] for rt in runner.cohorts]
    econf = EngineConfig(n_slots=8, page_size=16, n_pages=256,
                         max_pages_per_seq=32, max_out=64,
                         buckets=(32, 64, 128, 256))
    t0 = time.perf_counter()
    server = CohortServer(spec, params, econf)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engines = server.engines
    reqs = [make_requests(e.cfg, p, seed=20 + c, n=HET_SERVE_REQUESTS)
            for c, (e, p) in enumerate(zip(engines, params))]

    # qwen3's fullest decode step (the most cached tokens) for row A
    qwen = engines[2]
    snap = {"best": -1}
    tick = qwen.tick

    def snapping():
        busy = tick()
        sd = qwen.sched
        lens = torch.where(sd["active"], sd["seq_lens"] + 1, 0).int()
        if int(lens.sum()) > snap["best"]:
            snap.update(best=int(lens.sum()), state=(
                sd["block_tables"].clone(), sd["seq_lens"].clone(),
                sd["active"].clone()))
        return busy
    qwen.tick = snapping

    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rids = [[server.submit(c, t, max_new=m, prefix_embeds=s)
             for t, m, s in rs] for c, rs in enumerate(reqs)]
    done = server.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    qwen.tick = tick
    launches = read_counters()
    routes = check_tensor_core_routes("cohort serving")
    others = {n: v for n, v in launches.items()
              if v and n not in ("paged_attention", "flash_attention")}
    if others:
        raise AssertionError(f"cohort serving launched other kernels: "
                             f"{others}")
    want_a = sum(e.cfg.n_layers * e.n_steps for e in engines)
    want_b = sum(e.cfg.n_layers * e.n_prefills for e in engines)
    if launches["paged_attention"] != want_a or \
            launches["flash_attention"] != want_b or \
            any(e.n_prefills != HET_SERVE_REQUESTS for e in engines):
        raise AssertionError(f"cohort serving launches {launches}: A "
                             f"{want_a}, B {want_b} expected")
    per, n_tokens = [], 0
    for c, (e, rs, ids) in enumerate(zip(engines, reqs, rids)):
        V = padded_vocab(e.cfg)
        for rid, (_, budget, _) in zip(ids, rs):
            got = done[c][rid].out
            if len(got) != budget or got.min() < 0 or got.max() >= V:
                raise AssertionError(f"cohort {c} request {rid}: "
                                     f"{len(got)} tokens, budget {budget}")
            n_tokens += len(got)
        if sorted(e._free_pages) != list(range(1, econf.n_pages)) or \
                sorted(e._free_slots) != list(range(econf.n_slots)):
            raise AssertionError(f"cohort {c}: free lists not restored")
        lat = sorted(done[c][r].latency for r in ids)
        per.append({"model": e.cfg.name, "decode_steps": e.n_steps,
                    "prefills": e.n_prefills,
                    "decode_step_ms_mean": 1e3 * e.decode_seconds
                    / max(e.n_steps, 1),
                    "prefill_ms_mean": 1e3 * e.prefill_seconds
                    / max(e.n_prefills, 1),
                    "latency_p50_s": float(np.percentile(lat, 50)),
                    "latency_p99_s": float(np.percentile(lat, 99))})
    e2e_err, _ = prefill_decode_consistency(qwen.bundle, qwen.params,
                                            reqs[2][0][2])
    gen = torch.Generator(device="cuda").manual_seed(11)
    paged_qwen = paged_row(qwen, snap["state"],
                           [BIG_WINDOW] * qwen.cfg.n_layers, gen)
    serving = {
        "requests_per_cohort": HET_SERVE_REQUESTS, "tokens": n_tokens,
        "wall_s": wall, "tokens_per_s": n_tokens / wall, "init_s": init_s,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "by_cohort": per, "launches": launches,
        "launches_by_route": {n: routes[n] for n in
                              ("paged_attention", "flash_attention")},
        "qwen3_prefill_vs_decode_max_abs_err": e2e_err,
    }
    return serving, launches, paged_qwen


# ---------------------------------------------------------------------------
# phase 9: kernel G (the SSD chunk scan) against its plain version

# both sides compute in f32 on the same (bf16 or f32) values
SSD_TOL = dict(atol=2e-4, rtol=2e-4)
# the chunked SSD against the token-by-token recurrence at f32
# (tests/test_kernels.py's bound)
SSD_RECURRENCE_TOL = dict(atol=1e-4, rtol=1e-3)
SSD_SHAPES = {            # (B, S, H, P, G, N, chunk)
    "mamba2": (1, 256, 80, 64, 1, 128, 256),
    "hymba": (1, 256, 50, 64, 1, 16, 256),
    "groups2": (1, 256, 8, 64, 2, 64, 256),
    "mamba2_chunks3": (1, 768, 80, 64, 1, 128, 256),
    "batch2_chunks4": (2, 512, 16, 64, 1, 128, 128),
    "toy": (1, 16, 4, 16, 1, 8, 8),
}


def ssd_inputs(gen, B, S, H, P, G, N, dtype, a_div=1.0, dt_shift=0.0):
    """Model-like inputs: A = -linspace(1, 16, H) / a_div (the SSM's
    init), dt = softplus(N(0, 1) + dt_shift) f32."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = (0.5 * randn(B, S, H, P)).to(dtype)
    dt = torch.nn.functional.softplus(randn(B, S, H) + dt_shift)
    A = -torch.linspace(1.0, 16.0, H, device="cuda") / a_div
    Bm = (0.5 * randn(B, S, G, N)).to(dtype)
    Cm = (0.5 * randn(B, S, G, N)).to(dtype)
    return x, dt, A, Bm, Cm


def chunk_cum(dt, A, chunk):
    """The within-chunk cumulative dt * A, (B, S, H) f32."""
    import torch
    B, S, H = dt.shape
    return torch.cumsum((dt * A).reshape(B, S // chunk, chunk, H),
                        dim=2).reshape(B, S, H)


def phase_ssd_checks():
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ssd_recurrent_ref
    from repro_torch.kernels.ssd_scan import (ssd_chunk_cuda,
                                              ssd_chunk_plain,
                                              ssd_chunk_route)
    gen = torch.Generator(device="cuda").manual_seed(11)
    results, routes = {}, {}
    for name, (B, S, H, P, G, N, L) in SSD_SHAPES.items():
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, A, Bm, Cm = ssd_inputs(gen, B, S, H, P, G, N, dtype)
            cum = chunk_cum(dt, A, L)
            py, pst = ssd_chunk_plain(x, dt, cum, Bm, Cm, L)
            chosen = ssd_chunk_route(x, dt, cum, Bm, Cm, L)
            routes[f"{name}/{str(dtype)[6:]}"] = chosen
            for route in dict.fromkeys((chosen, "fma")):
                before = dict(ssd_chunk_cuda.launches_by_route)
                y, st = ssd_chunk_cuda(x, dt, cum, Bm, Cm, L, route=route)
                if route_delta(ssd_chunk_cuda, before) != {route: 1}:
                    raise AssertionError(f"ssd {name}: not on {route}")
                torch.cuda.synchronize()
                tag = f"{name}/{str(dtype)[6:]}/{route}"
                results[tag] = max(
                    check_close(f"ssd y {tag}", y, py, SSD_TOL),
                    check_close(f"ssd state {tag}", st, pst, SSD_TOL))
    want = {n: "mma" for n in ("mamba2", "hymba", "groups2",
                               "mamba2_chunks3", "batch2_chunks4")}
    if any(routes[f"{n}/bfloat16"] != r for n, r in want.items()) or \
            any(r != "fma" for t, r in routes.items() if "float32" in t):
        raise AssertionError(f"ssd routes {routes}")
    # the whole chunked SSD (one G launch, padding, the recurrence across
    # chunks, the final state) against the token-by-token recurrence, at
    # ragged S of 1, 2 and 3 chunks; decays that reach across chunks
    chunked = {}
    for S in (200, 300, 700):
        x, dt, A, Bm, Cm = ssd_inputs(gen, 1, S, 80, 64, 1, 128,
                                      torch.float32, a_div=8.0)
        n = ssd_chunk_cuda.launches
        y, h = ops.ssd_chunked(x, dt, A, Bm, Cm, 256, return_state=True)
        if ssd_chunk_cuda.launches != n + 1:
            raise AssertionError("ssd_chunked: not one launch of G")
        ry, rh = ssd_recurrent_ref(x, dt, A, Bm, Cm, return_state=True)
        torch.cuda.synchronize()
        chunked[f"S{S}"] = max(
            check_close(f"ssd_chunked y S={S}", y, ry, SSD_RECURRENCE_TOL),
            check_close(f"ssd_chunked state S={S}", h, rh,
                        SSD_RECURRENCE_TOL))
    # |A| dt up to ~16 x 6 per row: exp above the diagonal would be inf
    x, dt, A, Bm, Cm = ssd_inputs(gen, 1, 512, 80, 64, 1, 128,
                                  torch.bfloat16, dt_shift=5.0)
    cum = chunk_cum(dt, A, 256)
    py, pst = ssd_chunk_plain(x, dt, cum, Bm, Cm, 256)
    large = {}
    for route in ("mma", "fma"):
        y, st = ssd_chunk_cuda(x, dt, cum, Bm, Cm, 256, route=route)
        torch.cuda.synchronize()
        if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
            raise AssertionError(f"ssd {route}: non-finite output at large "
                                 "|A| dt")
        large[route] = max(
            check_close(f"ssd large decay y {route}", y, py, SSD_TOL),
            check_close(f"ssd large decay state {route}", st, pst, SSD_TOL))
    emit({"phase": "ssd_chunk_vs_plain", "max_abs_err": results,
          "routes": routes, "tolerance": SSD_TOL,
          "ssd_chunked_vs_recurrence_f32": chunked,
          "recurrence_tolerance": SSD_RECURRENCE_TOL,
          "large_decay_finite_max_abs_err": large,
          "min_cum": float(cum.min())})


# ---------------------------------------------------------------------------
# phase: kernel G′ (the SSD chunk scan's backward) against its plain version

# G′'s cases: name -> (B, S, H, P, G, N, chunk, with a state gradient)
SSD_BWD_CASES = {
    "mamba2_train": (8, 256, 80, 64, 1, 128, 256, False),
    "mamba2_chunks3": (1, 768, 80, 64, 1, 128, 256, True),
    "hymba_train": (8, 256, 50, 64, 1, 16, 256, False),
    "hymba_chunks2": (1, 512, 50, 64, 1, 16, 256, True),
    "groups2": (1, 128, 4, 16, 2, 8, 64, True),
}
# each row (the last axis) of a gradient against the larger of its own
# largest |value| and a tenth of the tensor's, at F32_TOL: both sides sum
# in f32 from the same values, in other orders (dB and dC over up to 80
# heads), and a kernel that writes zeros fails
SSD_BWD_FLOOR = 0.1
SSD_BWD_NAMES = ("dx", "ddt", "dcum", "dB", "dC")


def ssd_bwd_rows(tag, got, want):
    """rel_check of each of G′'s five outputs, a row per last axis."""
    return {f"{n}/{tag}": rel_check(
        f"ssd bwd {n} {tag}", g.reshape(-1, g.shape[-1]),
        w.reshape(-1, w.shape[-1]), F32_TOL, floor=SSD_BWD_FLOOR)
        for n, g, w in zip(SSD_BWD_NAMES, got, want)}


def ssd_bwd_inputs(gen, B, S, H, P, G, N, L, states, dtype, **kw):
    """G's model-like inputs (``ssd_inputs``), their cum, dy and (with
    ``states``) a nonzero state gradient."""
    import torch
    x, dt, A, Bm, Cm = ssd_inputs(gen, B, S, H, P, G, N, dtype, **kw)
    cum = chunk_cum(dt, A, L)
    dy = torch.randn((B, S, H, P), generator=gen, device="cuda")
    ds = 0.5 * torch.randn((B, S // L, H, P, N), generator=gen,
                           device="cuda") if states else None
    return x, dt, cum, Bm, Cm, dy, ds


def phase_ssd_bwd_checks():
    """G′ against ``ssd_chunk_bwd_plain`` at mamba2's and hymba's training
    shapes (batch 8, one chunk of 256: no state gradient, as in the round)
    and over several chunks with a state gradient, a toy with two groups,
    bf16 and f32, on the route function's choice and on "fma" (bf16 at
    the training shapes takes "mma"); strong decay (every output finite)
    and two launches bit-equal on both routes; then ``ops.ssd_chunked``'s
    whole backward at a ragged S of three chunks against the plain path's
    autograd, with exactly one G and one G′ launch (f32 on "fma", bf16 on
    "mma")."""
    import torch
    from repro_torch.kernels import ops, ssd_scan
    from repro_torch.kernels.ssd_scan import (ssd_chunk_bwd_cuda,
                                              ssd_chunk_bwd_plain,
                                              ssd_chunk_bwd_route,
                                              ssd_chunk_cuda)
    gen = torch.Generator(device="cuda").manual_seed(13)
    results, routes = {}, {}
    for name, (B, S, H, P, G, N, L, st) in SSD_BWD_CASES.items():
        for dtype in (torch.bfloat16, torch.float32):
            ins = ssd_bwd_inputs(gen, B, S, H, P, G, N, L, st, dtype)
            want = ssd_chunk_bwd_plain(*ins, L)
            chosen = ssd_chunk_bwd_route(*ins, L)
            routes[f"{name}/{str(dtype)[6:]}"] = chosen
            for route in dict.fromkeys((chosen, "fma")):
                n = ssd_chunk_bwd_cuda.launches
                before = dict(ssd_chunk_bwd_cuda.launches_by_route)
                got = ssd_chunk_bwd_cuda(*ins, L, route=route)
                if ssd_chunk_bwd_cuda.launches != n + 1 or \
                        route_delta(ssd_chunk_bwd_cuda, before) != {route: 1}:
                    raise AssertionError(f"ssd bwd {name}: not one launch "
                                         f"on {route}")
                torch.cuda.synchronize()
                results.update(ssd_bwd_rows(
                    f"{name}/{str(dtype)[6:]}/{route}", got, want))
    want_routes = {n: "mma" for n in SSD_BWD_CASES if n != "groups2"}
    if any(routes[f"{n}/bfloat16"] != r for n, r in want_routes.items()) \
            or any(r != "fma" for t, r in routes.items()
                   if "float32" in t or t.startswith("groups2")):
        raise AssertionError(f"ssd bwd routes {routes}")
    # |A| dt up to ~16 x 6 a row: exp above the diagonal would be inf
    ins = ssd_bwd_inputs(gen, 1, 512, 80, 64, 1, 128, 256, True,
                         torch.bfloat16, dt_shift=5.0)
    want = ssd_chunk_bwd_plain(*ins, 256)
    strong = {}
    for route in ssd_scan.BWD_ROUTES:
        got = ssd_chunk_bwd_cuda(*ins, 256, route=route)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in got):
            raise AssertionError(f"ssd bwd {route}: non-finite output under "
                                 "strong decay")
        strong.update(ssd_bwd_rows(f"strong_decay/{route}", got, want))
    # no float atomics: the same bits twice (80 heads into one group)
    L = SSD_BWD_CASES["mamba2_chunks3"][6]
    ins = ssd_bwd_inputs(gen, *SSD_BWD_CASES["mamba2_chunks3"][:7], True,
                         torch.bfloat16)
    for route in ssd_scan.BWD_ROUTES:
        a, b = (ssd_chunk_bwd_cuda(*ins, L, route=route) for _ in range(2))
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"ssd bwd {route}: two launches differ")
    # the chunked SSD's backward: one G and one G′ launch, G′ on the route
    # of the inputs' dtype; bf16 leaves get bf16 gradients (both paths
    # round f32 values that agree to ~1e-5: BF16_TOL), dt and A stay f32
    chunked, counts = {}, {}
    for route, dtype in (("fma", torch.float32), ("mma", torch.bfloat16)):
        x, dt, A, Bm, Cm = ssd_inputs(gen, 2, 700, 80, 64, 1, 128, dtype,
                                      a_div=8.0)
        wy = torch.randn(x.shape, generator=gen, device="cuda")
        wh = torch.randn((2, 80, 64, 128), generator=gen, device="cuda")
        grads, count = [], []
        for fn in (ssd_scan.ssd_chunk_autograd, ssd_scan.ssd_chunk_plain):
            saved, ops.ssd_chunk_autograd = ops.ssd_chunk_autograd, fn
            try:
                ins = [t.clone().requires_grad_(True)
                       for t in (x, dt, A, Bm, Cm)]
                n = (ssd_chunk_cuda.launches, ssd_chunk_bwd_cuda.launches)
                before = dict(ssd_chunk_bwd_cuda.launches_by_route)
                y, h = ops.ssd_chunked(*ins, 256, return_state=True)
                ((y.float() * wy).sum() + (h * wh).sum()).backward()
                count.append((ssd_chunk_cuda.launches - n[0],
                              ssd_chunk_bwd_cuda.launches - n[1]))
                moved = route_delta(ssd_chunk_bwd_cuda, before)
                if moved not in ({route: 1}, {}):
                    raise AssertionError(f"ssd_chunked backward on {moved}")
                grads.append([t.grad for t in ins])
            finally:
                ops.ssd_chunk_autograd = saved
        if count != [(1, 1), (0, 0)]:
            raise AssertionError(f"ssd_chunked backward launches {count}")
        counts[route] = count[0]
        torch.cuda.synchronize()
        for n, g, w in zip(("x", "dt", "A", "B", "C"), *grads):
            chunked[f"{n}/{route}"] = rel_check(
                f"ssd_chunked grad {n} {route}", g.reshape(-1, g.shape[-1]),
                w.reshape(-1, w.shape[-1]),
                BF16_TOL if g.dtype == torch.bfloat16 else F32_TOL,
                floor=SSD_BWD_FLOOR)
    emit({"phase": "ssd_chunk_bwd_vs_plain", "cases": SSD_BWD_CASES,
          "routes": routes, "max_abs_err": results, "strong_decay": strong,
          "bit_equal_twice": list(ssd_scan.BWD_ROUTES),
          "ssd_chunked_grads_vs_plain_autograd": chunked,
          "ssd_chunked_launches_G_Gbwd": counts,
          "tolerance": {"rows": F32_TOL, "floor": SSD_BWD_FLOOR,
                        "bf16_grads": BF16_TOL}})


# ---------------------------------------------------------------------------
# phases 10 / 11: serving the ssm and hybrid families at full width

N_RECURRENT_REQUESTS = 24


def serve_recurrent(cfg, econf, lo, hi, fixed, expect, consistency_lens,
                    tag, at_fullest=None):
    """Serve 24 soft-prompted requests (prompts lo-hi tokens, the first
    ones ``fixed``, budgets 16-64) through ``ServingEngine`` at full width
    (bf16, random weights from a seed).  Checks every budget, the free
    lists and the launch counters (``expect(prefills, steps)``), then
    prefill -> decode consistency at exact length for each S of
    ``consistency_lens``; then profiles an admission tick and four decode
    steps.  Returns (the {"..._serving": ...} metrics, the counted
    launches, ``at_fullest(engine, snap)`` or None): ``snap`` is the block
    tables, lengths and active slots of the main run's decode step with
    the most cached tokens, as ``phase_serving`` records it."""
    import numpy as np
    import torch
    from repro_torch.core.connector import init_unified
    from repro_torch.core.lora import flatten, is_lora_leaf
    from repro_torch.launch.serve_engine import ServingEngine
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.model import build_model

    bundle = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = init_unified(gen, bundle)
    for path, leaf in flatten(params).items():     # make merge_lora real work
        if path.endswith("_lora_b"):
            leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                   device="cuda") * 0.02)
    engine = ServingEngine(bundle, params, econf)
    if any(is_lora_leaf(p) for p in flatten(engine.params)):
        raise AssertionError("merged params still carry adapters")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = make_requests(cfg, params, seed=1, n=N_RECURRENT_REQUESTS, lo=lo,
                         hi=hi, fixed=fixed)
    del params

    for toks, _, soft in reqs[-3:]:            # warm-up
        engine.submit(toks, max_new=4, prefix_embeds=soft)
    engine.run()
    torch.cuda.synchronize()
    base = dict(steps=engine.n_steps, prefills=engine.n_prefills,
                dec=engine.decode_seconds, pre=engine.prefill_seconds)

    # the main path, counted
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rids = [engine.submit(t, max_new=m, prefix_embeds=s) for t, m, s in reqs]
    snap, best = None, -1
    while engine.busy:
        engine.tick()
        if at_fullest is not None:
            sd = engine.sched
            total = int(torch.where(sd["active"], sd["seq_lens"] + 1,
                                    0).sum())
            if total > best:        # the step with the most cached tokens
                best = total
                snap = (sd["block_tables"].clone(), sd["seq_lens"].clone(),
                        sd["active"].clone())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    routes = check_tensor_core_routes(f"{tag} serving")
    steps = engine.n_steps - base["steps"]
    prefills = engine.n_prefills - base["prefills"]
    want = {n: 0 for n in launches}
    want.update(expect(prefills, steps))
    if launches != want or prefills != len(reqs) or steps == 0:
        raise AssertionError(f"{tag} launches {launches} != {want} "
                             f"({prefills} prefills, {steps} steps)")

    V = padded_vocab(cfg)
    n_tokens = 0
    for rid, (_, budget, _) in zip(rids, reqs):
        out = engine.finished[rid].out
        if len(out) != budget:
            raise AssertionError(f"{tag} request {rid}: {len(out)} tokens, "
                                 f"budget {budget}")
        if out.min() < 0 or out.max() >= V:
            raise AssertionError(f"{tag} request {rid}: token id out of "
                                 "range")
        n_tokens += len(out)
    if sorted(engine._free_pages) != list(range(1, econf.n_pages)):
        raise AssertionError(f"{tag}: pages not returned to the free list")
    if sorted(engine._free_slots) != list(range(econf.n_slots)):
        raise AssertionError(f"{tag}: slots not returned to the free list")
    lat = sorted(engine.finished[r].latency for r in rids)
    P = cfg.n_soft_tokens
    metrics = {
        "model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
        "requests": len(reqs),
        "prompt_tokens": [int(min(len(r[0]) for r in reqs)),
                          int(max(len(r[0]) for r in reqs))],
        "chunks_per_prefill": sorted({-(-(P + len(r[0])) // cfg.ssm_chunk)
                                      for r in reqs}),
        "tokens": n_tokens, "wall_s": wall,
        "tokens_per_s": n_tokens / wall,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p99_s": float(np.percentile(lat, 99)),
        "decode_steps": steps,
        "decode_step_ms_mean": 1e3 * (engine.decode_seconds - base["dec"])
        / steps,
        "prefills": prefills,
        "prefill_ms_mean": 1e3 * (engine.prefill_seconds - base["pre"])
        / prefills,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
        "init_s": init_s,
        "launches": {n: v for n, v in launches.items() if v},
        "launches_by_route": {n: r for n, r in routes.items()
                              if any(r.values())},
    }
    metrics["prefill_vs_decode"] = recurrent_consistency(
        cfg, engine.params, reqs[0][2], consistency_lens)
    metrics["profile"] = phase_profile(engine, reqs, tag=f"{tag}_")
    extra = at_fullest(engine, snap) if at_fullest is not None else None
    return metrics, launches, extra


def recurrent_consistency(cfg, params, soft, lens):
    """Prefill -> decode consistency at exact length S for each S of
    ``lens``, held at ``E2E_TOL`` on the served weights upcast to f32:
    with random weights a bf16 SSM stack strays from its own f32 forward
    by more than that bound (a bf16 rounding of dt moves every later
    decay), while a wrong handoff moves the f32 logits by far more.  The
    bf16 run is measured and held only inside that noise: its decode may
    stray from its forward by no more than its forward strays from the
    f32 forward on the same tokens.  Every B and G launch of the f32 run
    takes the "fma" route, every one of the bf16 run "mma"."""
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.models.model import build_model
    bundle = build_model(cfg)
    b32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    p32 = unflatten({k: v.float() for k, v in flatten(params).items()})
    fns = {n: f for n, f in counters().items()
           if n in ("flash_attention", "ssd_chunk")}

    def on_route(route, run):
        """run(), then check that every B and G launch it made took
        ``route``; returns (run's result, launches per kernel and route)."""
        before = {n: dict(f.launches_by_route) for n, f in fns.items()}
        result = run()
        moved = {n: route_delta(f, before[n]) for n, f in fns.items()}
        off = {n: m for n, m in moved.items() if set(m) - {route}}
        if off:
            raise AssertionError(f"{cfg.name}: launches off {route}: {off}")
        return result, {n: m for n, m in moved.items() if m}

    out = {}
    for S in lens:
        (err32, full32), routes32 = on_route("fma", lambda: (
            prefill_decode_consistency(b32, p32, soft.float(), S=S, pad=0)))
        (err16, full16), routes16 = on_route("mma", lambda: (
            prefill_decode_consistency(bundle, params, soft, S=S, pad=0,
                                       tol=None)))
        noise = float((full16 - full32)[0, -9:].abs().max())
        if err16 > noise:
            raise AssertionError(f"{cfg.name} S={S}: bf16 decode strays "
                                 f"{err16:.3e} from its forward, more than "
                                 f"the forward's bf16 noise {noise:.3e}")
        out[f"S{S}"] = {"f32_max_abs_err": err32, "f32_tolerance": E2E_TOL,
                        "f32_launches_by_route": routes32,
                        "bf16_max_abs_err": err16,
                        "bf16_launches_by_route": routes16,
                        "bf16_forward_vs_f32_forward_max_abs": noise}
        del full16, full32
    del p32
    return out


MAMBA2_LAYERS = 16        # mamba2-2.7b's layers wherever it runs (of 64)


def mamba2_config():
    """mamba2-2.7b at full width, its first :data:`MAMBA2_LAYERS` layers
    (its layers are alike)."""
    from repro_torch.configs.mamba2_2p7b import CONFIG
    return dataclasses.replace(CONFIG, n_layers=MAMBA2_LAYERS)


def phase_ssm_serving():
    """mamba2-2.7b (:func:`mamba2_config`): prompts 20-700 (1, 2 and 3
    chunks of 256 with the 8 soft tokens); no pages; G once a layer of an
    admission, nothing else."""
    from repro_torch.launch.serve_engine import EngineConfig
    cfg = mamba2_config()
    econf = EngineConfig(n_slots=16, page_size=16, n_pages=2,
                         max_pages_per_seq=64, max_out=64)
    L = cfg.n_layers
    metrics, launches, _ = serve_recurrent(
        cfg, econf, 20, 700, (20, 300, 700),
        lambda prefills, steps: {"ssd_chunk": L * prefills},
        (300,), "ssm")
    return metrics, launches


def phase_hybrid_serving():
    """hymba-1.5b: prompts 20-1200, so the 1024 window bites in prefill (B)
    and decode (A) on the local layers; B and G 32 per admission, A 32 per
    decode step.  Returns (metrics, launches, row A at the run's fullest
    decode step: its 32 layers, each with its own window)."""
    import torch
    from repro_torch.configs.hymba_1p5b import CONFIG
    from repro_torch.launch.serve_engine import EngineConfig
    from repro_torch.models.transformer import window_array
    econf = EngineConfig(n_slots=16, page_size=16, n_pages=16 * 80 + 1,
                         max_pages_per_seq=80, max_out=64)
    L = CONFIG.n_layers
    gen = torch.Generator(device="cuda").manual_seed(5)
    return serve_recurrent(
        CONFIG, econf, 20, 1200, (20, 600, 1200),
        lambda prefills, steps: {"ssd_chunk": L * prefills,
                                 "flash_attention": L * prefills,
                                 "paged_attention": L * steps},
        (300, 1100), "hybrid",
        at_fullest=lambda engine, snap: paged_row(
            engine, snap, window_array(engine.cfg), gen))


def ssd_kernel_rows():
    """Row G at mamba2's and hymba's prefill shapes (bf16), from CUDA-graph
    replay; bounds from these inputs.  Each shape also times the FMA route
    on the same inputs."""
    import torch
    from repro_torch.kernels.ssd_scan import (ssd_chunk_cuda, ssd_chunk_plain,
                                              ssd_chunk_route)
    gen = torch.Generator(device="cuda").manual_seed(12)

    def case(B, S, H, P, G, N, L):
        x, dt, A, Bm, Cm = ssd_inputs(gen, B, S, H, P, G, N, torch.bfloat16)
        cum = chunk_cum(dt, A, L)
        route = ssd_chunk_route(x, dt, cum, Bm, Cm, L)
        if route != "mma":
            raise AssertionError(f"ssd row: route {route}")
        got = ssd_chunk_cuda(x, dt, cum, Bm, Cm, L)
        want = ssd_chunk_plain(x, dt, cum, Bm, Cm, L)
        err = max(check_close("ssd row y", got[0], want[0], SSD_TOL),
                  check_close("ssd row state", got[1], want[1], SSD_TOL))
        ms = graph_ms(lambda i: ssd_chunk_cuda(x, dt, cum, Bm, Cm, L))
        fma = graph_ms(lambda i: ssd_chunk_cuda(x, dt, cum, Bm, Cm, L,
                                                route="fma"))
        plain = graph_ms(lambda i: ssd_chunk_plain(x, dt, cum, Bm, Cm, L))
        nc, es = S // L, x.element_size()
        bytes_ = (B * S * H * P * es + 2 * B * S * G * N * es
                  + 2 * B * S * H * 4 + B * S * H * P * 4
                  + B * nc * H * P * N * 4)
        tri = L * (L + 1) // 2
        # C.B^T once per group, then per head the masked product with x
        # and the end state
        flops = 2 * B * nc * (G * tri * N + H * tri * P + H * L * P * N)
        bound, by = _bound(bytes_, flops)
        return {"ms": ms, "ms_fma_route": fma, "kernel_route": route,
                "plain_ms": plain, "bound_ms": bound,
                "bound_by": by, "max_abs_err": err, "bytes": bytes_,
                "flops": flops,
                "shape": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N,
                          "chunk": L, "dtype": str(x.dtype)}}

    main = case(*SSD_SHAPES["mamba2"])
    others = {"mamba2_chunks3": case(*SSD_SHAPES["mamba2_chunks3"]),
              "hymba": case(*SSD_SHAPES["hymba"])}
    return [{
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:55",
        "max_abs_err": max([main["max_abs_err"]]
                           + [o["max_abs_err"] for o in others.values()]),
        "tolerance": SSD_TOL,
        **{k: main[k] for k in ("ms", "ms_fma_route", "kernel_route",
                                "plain_ms", "bound_ms", "bound_by",
                                "shape", "bytes", "flops")},
        "ms_fma_route_is": "the FMA route on the same inputs in this run",
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the SSD "
                        "chunk scan",
        "at_other_shapes": others}]


def ssd_bwd_kernel_row():
    """Row G′ at mamba2's training shape (batch 8, one chunk of 256, 80
    heads, bf16, no state gradient: the round's launches), from CUDA-graph
    replay, on the route function's choice ("mma") beside the FMA route
    and the plain version on the same inputs in the same replays;
    hymba's training shape and three chunks with a state gradient also
    timed.  The bound counts the bytes of every input and output once and
    the products the causal triangle needs (dy.x^T, sum_i M dy_i, and dCB
    times B and C per head; C.B^T once per group; dS B_j and dS^T x_j per
    row and head where dS is given) at the tensor cores' bf16 rate."""
    import torch
    from repro_torch.kernels.ssd_scan import (ssd_chunk_bwd_cuda,
                                              ssd_chunk_bwd_plain,
                                              ssd_chunk_bwd_route)
    gen = torch.Generator(device="cuda").manual_seed(14)

    def case(B, S, H, P, G, N, L, st):
        ins = ssd_bwd_inputs(gen, B, S, H, P, G, N, L, st, torch.bfloat16)
        route = ssd_chunk_bwd_route(*ins, L)
        if route != "mma":
            raise AssertionError(f"ssd bwd row: route {route}")
        want = ssd_chunk_bwd_plain(*ins, L)
        err = max(max(r["max_rel_err"] for r in ssd_bwd_rows(
            f"row/{rt}", ssd_chunk_bwd_cuda(*ins, L, route=rt),
            want).values()) for rt in ("mma", "fma"))
        times = graphs_ms({
            "ms": lambda i: ssd_chunk_bwd_cuda(*ins, L),
            "ms_fma_route": lambda i: ssd_chunk_bwd_cuda(*ins, L,
                                                         route="fma"),
            "plain_ms": lambda i: ssd_chunk_bwd_plain(*ins, L)},
            n_calls=10)
        nc, es = S // L, ins[0].element_size()
        rows_h, rows_g = B * S * H, B * S * G * N
        bytes_ = (rows_h * P * es + 2 * rows_g * es + 2 * rows_h * 4
                  + rows_h * P * 4 + (B * nc * H * P * N * 4 if st else 0)
                  + rows_h * P * 4 + 2 * rows_h * 4 + 2 * rows_g * 4)
        tri = L * (L + 1) // 2
        flops = 2 * B * nc * (G * tri * N + H * tri * (2 * P + 2 * N)
                              + (2 * H * L * P * N if st else 0))
        bound, by = _bound(bytes_, flops)
        return {**times, "kernel_route": route, "bound_ms": bound,
                "bound_by": by, "max_abs_err": err, "bytes": bytes_,
                "flops": flops,
                "shape": {"B": B, "S": S, "H": H, "P": P, "G": G, "N": N,
                          "chunk": L, "dstates": st,
                          "dtype": str(ins[0].dtype)}}

    main = case(*SSD_BWD_CASES["mamba2_train"])
    others = {n: case(*SSD_BWD_CASES[n])
              for n in ("hymba_train", "mamba2_chunks3")}
    return {
        "name": "ssd_chunk_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:55 (its gradient: "
                    "jax.grad of src/repro/models/ssm.py:61 ssd_reference)",
        "max_abs_err": max([main["max_abs_err"]]
                           + [o["max_abs_err"] for o in others.values()]),
        "max_abs_err_is": "the largest error of a gradient row divided by "
                          "that row's scale (ssd_bwd_rows), on either route",
        "tolerance": {"rows": F32_TOL, "floor": SSD_BWD_FLOOR},
        **{k: main[k] for k in ("ms", "ms_fma_route", "kernel_route",
                                "plain_ms", "bound_ms", "bound_by",
                                "shape", "bytes", "flops")},
        "ms_fma_route_is": "the FMA route on the same inputs in this run",
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the SSD "
                        "chunk scan's gradient",
        "at_other_shapes": others}


# ---------------------------------------------------------------------------
# phase: the vectorized engine (grouped C, one stacked step against the
# loop engine's steps, one evaluated round on each engine)

# grouped C's cases: name -> (G, Mg, K, N, r, trans_w, dtype name)
GROUPED_CASES = {
    "slm_round": (3, 1088, 1280, 1280, 8, False, "bfloat16"),
    "slm_round_dx": (3, 1088, 1280, 1280, 8, True, "bfloat16"),
    "qwen3_k_v": (2, 1088, 2048, 1024, 8, False, "bfloat16"),
    "qwen3_k_v_dx": (2, 1088, 1024, 2048, 8, True, "bfloat16"),
    "small_mg": (3, 136, 1280, 1280, 8, False, "bfloat16"),
    "small_mg_dx": (3, 136, 1280, 1280, 8, True, "bfloat16"),
    "fma_f32": (3, 136, 1280, 1280, 8, False, "float32"),
    "fma_f32_dx": (3, 1088, 1280, 1280, 8, True, "float32"),
}
# the stacked step against the loop engine's steps at bf16 (the two paths
# round bf16 GEMMs of other shapes: cuBLAS at M = 3 x 1088 against 1088,
# through 36 layers forward and back): per-client losses to 1e-2
# relative; each client's gradient of each leaf within 2e-2 of its own
# L2 norm; and each row of it (last axis) within 0.15 of the row's
# largest |value|, floored at a tenth of the leaf's largest: twice the
# largest row deviation of the first full-width run (0.069, in 3 elements
# of one LoRA A leaf, where a row's entries cancel).  The updated leaves
# within two AdamW steps of lr (a gradient entry near 0 may change sign)
# plus the leaf's bf16 rounding.
STEP_LOSS_RTOL = 1e-2
STEP_GRAD_L2_RTOL = 2e-2
STEP_GRAD_TOL = dict(atol=0.15, rtol=0.0)
STEP_GRAD_FLOOR = 0.1
# the two engines' evaluated rounds at bf16: CE to 2e-2 relative, accuracy
# to 0.02 (a template token may flip), every LoRA leaf within 2 lr per
# AdamW step that moved it (device CCL + AMT steps, then SE-CCL) plus
# the leaf's bf16 rounding
ROUND_CE_RTOL = 2e-2
ROUND_ACC_ATOL = 0.02


def grouped_inputs(gen, G, Mg, K, N, r, dtype, trans_w=False):
    import torch
    x = torch.randn((G * Mg, K), generator=gen, device="cuda").to(dtype)
    wshape = (N, K) if trans_w else (K, N)
    w = (torch.randn(wshape, generator=gen, device="cuda") / math.sqrt(K)
         ).to(dtype)
    a = (torch.randn((G, K, r), generator=gen, device="cuda")
         / math.sqrt(K)).to(dtype)
    b = (0.1 * torch.randn((G, r, N), generator=gen, device="cuda")
         ).to(dtype)
    return x, w, a, b


def grouped_tile(G, Mg, N, r):
    """The wgmma route's tile for G groups (``big_tile`` of
    ``csrc/lora_matmul.cu``): "192x192" or "128x96"."""
    tiles = G * -(-Mg // 192) * -(-N // 192)
    return "192x192" if r == 8 and tiles >= 99 else "128x96"


def phase_grouped_lora_checks():
    """Grouped C against its plain version and against G ungrouped
    launches, forward and dx, on the route it should take; bit-equal to
    the ungrouped launches where both take one tile shape (per group the
    same tiles, K order and epilogue), else within the tolerance; the
    autograd gradients (dx, dA, dB) at the SLM's round shape; and a
    planted fault (every client on client 0's adapter) that must fail."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.lora_matmul import (lora_matmul_cuda,
                                                 lora_matmul_grouped_cuda,
                                                 lora_matmul_grouped_plain,
                                                 lora_matmul_grouped_route)
    gen = torch.Generator(device="cuda").manual_seed(13)
    results, vs_ungrouped = {}, {}
    for name, (G, Mg, K, N, r, tw, dt) in GROUPED_CASES.items():
        dtype = getattr(torch, dt)
        tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
        x, w, a, b = grouped_inputs(gen, G, Mg, K, N, r, dtype, tw)
        route = lora_matmul_grouped_route(x, w, a, b, tw)
        want_route = "wgmma" if dtype == torch.bfloat16 else "fma"
        before = dict(lora_matmul_grouped_cuda.launches_by_route)
        got = lora_matmul_grouped_cuda(x, w, a, b, 2.0, trans_w=tw)
        moved = {k: v - before[k] for k, v in
                 lora_matmul_grouped_cuda.launches_by_route.items()}
        if route != want_route or moved != {k: int(k == route)
                                            for k in moved}:
            raise AssertionError(f"grouped lora {name}: route {route}, "
                                 f"launches {moved}")
        want = lora_matmul_grouped_plain(x, w.t() if tw else w, a, b, 2.0)
        solo = torch.cat([lora_matmul_cuda(x[g * Mg:(g + 1) * Mg], w, a[g],
                                           b[g], 2.0, trans_w=tw)
                          for g in range(G)])
        torch.cuda.synchronize()
        results[name] = check_close(f"grouped lora {name}", got, want, tol)
        same_tile = route == "fma" or \
            grouped_tile(G, Mg, N, r) == grouped_tile(1, Mg, N, r)
        equal = bool(torch.equal(got, solo))
        if same_tile and not equal:
            raise AssertionError(f"grouped lora {name}: not bit-equal to "
                                 f"{G} ungrouped launches of one tile")
        vs_ungrouped[name] = {
            "route": route, "same_tile": same_tile, "bit_equal": equal,
            "tile": grouped_tile(G, Mg, N, r) if route == "wgmma" else
            "64x64 fma", "ungrouped_tile": grouped_tile(1, Mg, N, r)
            if route == "wgmma" else "64x64 fma",
            "max_abs_diff": check_close(f"grouped vs ungrouped {name}", got,
                                        solo, tol)}
    # autograd at the SLM's round shape: both launches on wgmma
    x, w, a, b = grouped_inputs(gen, 3, 1088, 1280, 1280, 8, torch.bfloat16)
    dy = torch.randn((3264, 1280), generator=gen, device="cuda").to(
        torch.bfloat16)
    grads = []
    for fn in (ops.lora_matmul_grouped, lora_matmul_grouped_plain):
        ins = [t.clone().requires_grad_(True) for t in (x, a, b)]
        n0 = lora_matmul_grouped_cuda.launches_by_route["wgmma"]
        fn(ins[0], w, ins[1], ins[2], 2.0).backward(dy)
        if fn is ops.lora_matmul_grouped and \
                lora_matmul_grouped_cuda.launches_by_route["wgmma"] != n0 + 2:
            raise AssertionError("grouped lora autograd: not 2 wgmma "
                                 "launches")
        grads.append([t.grad.reshape(-1, t.shape[-1]) for t in ins])
    torch.cuda.synchronize()
    for n, got, want in zip(("dx", "dA", "dB"), *grads):
        results[f"grad_{n}"] = rel_check(f"grouped lora {n}", got, want,
                                         BF16_TOL)
    # planted: client 0's adapter for every client must fail the check
    got = lora_matmul_grouped_cuda(x, w, a, b, 2.0)
    wrong = lora_matmul_grouped_plain(x, w, a[:1].expand_as(a),
                                      b[:1].expand_as(b), 2.0)
    try:
        check_close("planted", got, wrong, BF16_TOL)
    except AssertionError as e:
        planted = str(e)
    else:
        raise AssertionError("grouped lora: the planted adapter swap passed")
    return {"phase": "grouped_lora_vs_plain", "max_abs_err": results,
            "vs_ungrouped": vs_ungrouped, "planted_fault_failed": planted,
            "tolerance": {"bfloat16": BF16_TOL, "float32": F32_TOL,
                          "gradients": "each row over its largest |value|"}}


def grouped_lora_row():
    """Row of grouped C at the SLM's round shape (G 3 x 1088 x 1280 x
    1280, r 8, bf16) from CUDA-graph replay: the grouped launch, three
    ungrouped launches of the same work, cuBLAS x @ W at M = 3264, the
    plain version, replays in turn; dx (W read transposed) beside it."""
    import torch
    from repro_torch.kernels.lora_matmul import (lora_matmul_cuda,
                                                 lora_matmul_grouped_cuda,
                                                 lora_matmul_grouped_plain)
    gen = torch.Generator(device="cuda").manual_seed(17)
    G, Mg, K, N, r = 3, 1088, 1280, 1280, 8
    out = {}
    for tw in (False, True):
        x, w, a, b = grouped_inputs(gen, G, Mg, K, N, r, torch.bfloat16, tw)
        wt = w.t() if tw else w
        xs = [x[g * Mg:(g + 1) * Mg] for g in range(G)]
        t = graphs_ms({
            "grouped": lambda i: lora_matmul_grouped_cuda(x, w, a, b, 2.0,
                                                          trans_w=tw),
            "ungrouped_x3": lambda i: [lora_matmul_cuda(
                xs[g], w, a[g], b[g], 2.0, trans_w=tw) for g in range(G)],
            "cublas": lambda i: torch.matmul(x, wt),
            "plain": lambda i: lora_matmul_grouped_plain(x, wt, a, b, 2.0)})
        err = check_close("grouped lora row", lora_matmul_grouped_cuda(
            x, w, a, b, 2.0, trans_w=tw),
            lora_matmul_grouped_plain(x, wt, a, b, 2.0), BF16_TOL)
        M = G * Mg
        bytes_ = (M * K + K * N + G * K * r + G * r * N + M * N) * 2
        flops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
        bound, by = _bound(bytes_, flops)
        out["dx" if tw else "forward"] = {
            "ms": t["grouped"], "ungrouped_x3_ms": t["ungrouped_x3"],
            "plain_ms": t["plain"], "library_ms": t["cublas"],
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "tile": grouped_tile(G, Mg, N, r),
            "shape": {"G": G, "Mg": Mg, "K": K, "N": N, "r": r,
                      "trans_w": tw, "dtype": "torch.bfloat16"}}
    f = out["forward"]
    return {"name": "lora_matmul_grouped", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/lora_matmul.cu",
            "replaces": "src/repro/kernels/lora_matmul.py:55 (vmap over "
                        "the client axis)",
            "max_abs_err": max(o["max_abs_err"] for o in out.values()),
            "tolerance": BF16_TOL,
            **{k: f[k] for k in ("ms", "ungrouped_x3_ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms",
                                 "tile", "shape")},
            "ungrouped_x3_is": "three ungrouped launches of C, one a "
                               "client, in one timed call",
            "library_call": "torch.matmul(x, W) at M = G x Mg: the dense "
                            "part alone (no single PyTorch call computes "
                            "the whole function)",
            "at_other_shapes": {"dx_transposed_w": out["dx"]}}


def lora_leaves(tree):
    from repro_torch.core.lora import is_lora_leaf, partition
    return {k: v.detach().clone() for k, v in
            partition(tree, is_lora_leaf).items()}


def leaf_bound(lr, steps, want):
    """|got - want| allowed for a bf16 leaf after ``steps`` AdamW steps on
    two paths whose gradients differ at bf16 rounding: 2 lr a step (a
    first-moment sign may flip where the gradient is near 0) plus the
    leaf's bf16 half-ulp (2^-9 |x|, and 2^-8 for the sum's rounding)."""
    return 2.0 * lr * steps + 2.0 ** -8 * want.float().abs()


def step_check(tag, got_loss, want_loss, got_grads, want_grads):
    """Per-client losses and gradients of the stacked step against the
    loop engine's, every leaf measured before any is judged: raises with
    the worst leaves when any is out of tolerance.  Returns the worst
    errors: the losses', each leaf's L2 and row-wise ones."""
    import torch
    loss_rel, l2, rows, bad = [], {}, {}, []
    for g, (lw, gw) in enumerate(zip(want_loss, want_grads)):
        rel = abs(float(got_loss[g]) - float(lw)) / abs(float(lw))
        loss_rel.append(rel)
        if not rel <= STEP_LOSS_RTOL:
            bad.append(f"client {g} loss rel {rel:.3e}")
        for k, want in gw.items():
            got = got_grads[k][g].float().reshape(-1, want.shape[-1])
            want = want.float().reshape(-1, want.shape[-1])
            e2 = float(torch.linalg.vector_norm(got - want)
                       / torch.linalg.vector_norm(want).clamp(min=1e-30))
            scale = torch.maximum(
                want.abs().amax(dim=1, keepdim=True),
                STEP_GRAD_FLOOR * want.abs().max()).clamp(min=1e-30)
            er = float(((got - want).abs() / scale).max())
            l2[k] = max(l2.get(k, 0.0), e2)
            rows[k] = max(rows.get(k, 0.0), er)
            if not (e2 <= STEP_GRAD_L2_RTOL and er <= STEP_GRAD_TOL["atol"]
                    and bool(torch.isfinite(got).all())):
                bad.append(f"client {g} d{k}: L2 {e2:.3e}, row {er:.3e}")
    worst = {"loss_rel": max(loss_rel), "grad_l2_rel": max(l2.values()),
             "grad_row_rel": max(rows.values()),
             "grad_l2_rel_by_leaf": l2, "grad_row_rel_by_leaf": rows}
    if bad:
        raise AssertionError(f"{tag}: {len(bad)} out of tolerance: "
                             f"{bad[:12]}; worst L2 by leaf {l2}; worst "
                             f"row by leaf {rows}")
    return worst


def step_grads(bundle, sp, pub, anchor, loop_anchors, n_negatives):
    """The stacked CCL loss and its gradients over the G clients of
    ``sp`` (one backward of the sum), and each client's loss and
    gradients on the loop engine's path (its own tree, batch and
    anchor): (stacked losses, stacked grads, [loss], [grads])."""
    import torch
    from repro_torch.core import ccl as ccl_lib
    from repro_torch.core.lora import combine, gather_client, partition

    def grads(tree, batch, anc, stacked):
        train = {k: v.detach().requires_grad_(True)
                 for k, v in partition(tree).items()}
        loss, _ = ccl_lib.mlecs_loss(
            combine(tree, train), bundle, batch, anchor=anc,
            ccl_weight=0.5, n_negatives=n_negatives, stacked=stacked)
        return loss.detach(), ccl_lib.grads_of(torch.sum(loss), train)

    got_loss, got_grads = grads(sp, pub, anchor, True)
    personal = partition(sp)
    want = [grads(combine(sp, gather_client(personal, g)),
                  {k: v[g] for k, v in pub.items()}, loop_anchors[g], False)
            for g in range(len(loop_anchors))]
    return (got_loss, got_grads, [w[0] for w in want],
            [w[1] for w in want])


# the stacked step against the loop engine's steps at f32 (ROADMAP 3.6):
# the same state upcast, the same batches and anchors, TF32 off; each row
# of a gradient within 1e-3 of the row's largest |value| (floored as the
# bf16 check), losses and L2 to 1e-4 relative
STEP_F32_LOSS_RTOL = 1e-4
STEP_F32_GRAD_L2_RTOL = 1e-4
STEP_F32_GRAD_ROW_TOL = 1e-3


def stacked_step_check_f32(runner, sp, pub, anchor):
    """:func:`step_grads` at f32 on an f32 copy of the stacked state
    ``sp`` (the backbone and every client's leaves upcast), the same
    batches, and the stacked anchors upcast for both paths (the loop path
    takes client g's slice, so only the step differs): the worst errors
    by leaf, failing above the f32 bounds."""
    import torch
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.models.model import build_model
    bundle = build_model(dataclasses.replace(runner.cohorts[0].bundle.cfg,
                                             dtype="float32"))
    sp32 = unflatten({k: v.float() if v.is_floating_point() else v
                      for k, v in flatten(sp).items()})
    a32 = anchor.float()
    got_loss, got_grads, want_loss, want_grads = step_grads(
        bundle, sp32, pub, a32, list(a32), runner.cfg.n_negatives)
    torch.cuda.synchronize()
    loss_rel, l2, rows = [], {}, {}
    for g, (lw, gw) in enumerate(zip(want_loss, want_grads)):
        loss_rel.append(abs(float(got_loss[g]) - float(lw)) / abs(float(lw)))
        for k, want in gw.items():
            got = got_grads[k][g].reshape(-1, want.shape[-1])
            want = want.reshape(-1, want.shape[-1])
            l2[k] = max(l2.get(k, 0.0), float(
                torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want).clamp(min=1e-30)))
            scale = torch.maximum(
                want.abs().amax(dim=1, keepdim=True),
                STEP_GRAD_FLOOR * want.abs().max()).clamp(min=1e-30)
            rows[k] = max(rows.get(k, 0.0),
                          float(((got - want).abs() / scale).max()))
    out = {"max_loss_rel_err": max(loss_rel),
           "max_grad_l2_rel_err": max(l2.values()),
           "max_grad_row_rel_err": max(rows.values()),
           "grad_row_rel_err_by_leaf": rows,
           "tolerance": {"loss_rtol": STEP_F32_LOSS_RTOL,
                         "grad_l2_rtol": STEP_F32_GRAD_L2_RTOL,
                         "grad_rows": STEP_F32_GRAD_ROW_TOL}}
    if not (out["max_loss_rel_err"] <= STEP_F32_LOSS_RTOL
            and out["max_grad_l2_rel_err"] <= STEP_F32_GRAD_L2_RTOL
            and out["max_grad_row_rel_err"] <= STEP_F32_GRAD_ROW_TOL):
        worst = sorted(rows, key=rows.get, reverse=True)[:5]
        raise AssertionError(
            f"stacked step at f32: {out['max_loss_rel_err']:.3e} loss, "
            f"{out['max_grad_l2_rel_err']:.3e} L2, "
            f"{out['max_grad_row_rel_err']:.3e} row; worst leaves "
            f"{[(k, rows[k], l2[k]) for k in worst]}")
    return out


def stacked_step_check(runner):
    """One stacked CCL step against the loop engine's three, from one
    state whose LoRA B leaves are non-zero and different per client, on
    the same batches and anchors: per-client losses, gradients (row by
    row) and updated leaves; then the same gradients at f32.  A planted
    fault, client 0 on client 1's adapter, must fail the same check."""
    import torch
    from repro_torch.core import ccl as ccl_lib
    from repro_torch.core.lora import (combine, gather_client, is_lora_leaf,
                                       partition)
    from repro_torch.data.pipeline import to_tensors
    cfg, rt = runner.cfg, runner.cohorts[0]
    bundle = rt.bundle
    gen = torch.Generator(device="cuda").manual_seed(19)
    sp = rt.stacked_params
    sp = combine(sp, {k: (0.02 * torch.randn(v.shape, generator=gen,
                                             device="cuda")).to(v.dtype)
                      for k, v in partition(sp).items()
                      if k.endswith("_lora_b")})
    pubs = to_tensors(runner._streams.gather_steps(
        [f"pub/{j}" for j in range(rt.offset, rt.offset + rt.n)], 1),
        "cuda")
    pub = {k: v[0] for k, v in pubs.items()}
    anchor = runner.stacked_anchors(pub)
    personal = partition(sp)
    trees = [combine(sp, gather_client(personal, g)) for g in range(rt.n)]
    batches = [{k: v[g] for k, v in pub.items()} for g in range(rt.n)]
    got_loss, got_grads, want_loss, want_grads = step_grads(
        bundle, sp, pub, anchor, [runner.anchors(b) for b in batches],
        cfg.n_negatives)
    torch.cuda.synchronize()
    worst = step_check("stacked step", got_loss, want_loss, got_grads,
                       want_grads)

    # planted: client 0 trains on client 1's adapter
    swapped = combine(sp, {k: torch.cat([v[1:2], v[1:]]) for k, v in
                           partition(sp, is_lora_leaf).items()})
    bad_loss, bad_grads = step_grads(bundle, swapped, pub, anchor, [],
                                     cfg.n_negatives)[:2]
    try:
        step_check("planted", bad_loss, want_loss, bad_grads, want_grads)
    except AssertionError as e:
        planted = str(e)
    else:
        raise AssertionError("stacked step: the planted adapter swap passed")

    # the steps themselves: the stacked step and the loop engine's step
    loop_step = ccl_lib.make_local_step(
        bundle, runner.opt, ccl_weight=0.5, n_negatives=cfg.n_negatives,
        ccl_score=cfg.ccl_score)
    new_sp, new_opt, _ = rt.ccl_step(sp, rt.stacked_opt, pub, anchor)
    opts = runner.device_opt
    leaf_worst, moved = 0.0, 0
    for g, (tree, batch) in enumerate(zip(trees, batches)):
        p, o, _ = loop_step(tree, opts[g], batch, runner.anchors(batch))
        want = partition(p)
        got = partition(new_sp)
        for k, v in want.items():
            err = (got[k][g].float() - v.float()).abs()
            if bool((err > leaf_bound(cfg.lr, 1, v)).any()):
                raise AssertionError(f"stacked step: client {g} {k} "
                                     f"moved {float(err.max())} apart")
            leaf_worst = max(leaf_worst, float(err.max()))
            moved += int((got[k][g] != partition(tree)[k]).sum())
        if int(o["step"]) != int(new_opt["step"][g]):
            raise AssertionError("stacked step: AdamW step counts differ")
    torch.cuda.synchronize()
    del new_sp, new_opt, p, o
    f32 = stacked_step_check_f32(runner, sp, pub, anchor)
    return {"clients": rt.n, "loss": [float(x) for x in got_loss],
            "max_loss_rel_err": worst["loss_rel"],
            "max_grad_l2_rel_err": worst["grad_l2_rel"],
            "max_grad_row_rel_err": worst["grad_row_rel"],
            "grad_l2_rel_err_by_leaf": worst["grad_l2_rel_by_leaf"],
            "grad_row_rel_err_by_leaf": worst["grad_row_rel_by_leaf"],
            "max_leaf_abs_err": leaf_worst, "leaf_elements_moved": moved,
            "planted_fault_failed": planted, "float32": f32,
            "tolerance": {"loss_rtol": STEP_LOSS_RTOL,
                          "grad_l2_rtol": STEP_GRAD_L2_RTOL,
                          "grad_rows": STEP_GRAD_TOL,
                          "grad_floor": STEP_GRAD_FLOOR,
                          "leaves": "2 lr a step + 2^-8 |leaf|"}}


def engine_round(engine, seconds):
    """One evaluated round of the training configuration on ``engine``
    from the seed's states, counted and timed: (runner, record)."""
    import torch
    from repro_torch.core.federated import FederatedConfig, FederatedRunner
    from repro_torch.core.lora import default_trainable, flatten
    from repro_torch.models.model import build_model
    slm_cfg, llm_cfg = round_models()
    runner = FederatedRunner(FederatedConfig(**dict(ROUND, engine=engine)),
                             build_model(slm_cfg), build_model(llm_cfg),
                             round_corpus(), device="cuda")
    rt = runner.cohorts[0]

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds.setdefault(key, []).append(time.perf_counter() - t)
            return out
        return run
    steps = (rt.ccl_step, rt.amt_step)
    rt.ccl_step = timed(rt.ccl_step, f"{engine}/ccl")
    rt.amt_step = timed(rt.amt_step, f"{engine}/amt")
    init = {f"device{j}": trainable_copy(p)
            for j, p in enumerate(runner.device_params)}
    trees = {"device_base": runner.cohort_base,
             "server_slm": runner.server_slm,
             "server_llm": runner.server_llm}
    frozen0 = {n: frozen_fingerprint(t) for n, t in trees.items()}
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.run_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    routes = check_tensor_core_routes(f"{engine} round")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    rt.ccl_step, rt.amt_step = steps
    want = expected_round_launches(runner)
    if launches != want:
        raise AssertionError(f"{engine} round: launches {launches} != "
                             f"expected {want}")
    for n, t in trees.items():
        if frozen_fingerprint(t) != frozen0[n]:
            raise AssertionError(f"{engine} round: {n} changed")
    base = flatten(runner.cohort_base)
    for j, p in enumerate(runner.device_params):
        for k, v in flatten(p).items():
            if not default_trainable(k) and v is not base[k]:
                raise AssertionError(f"{engine} round: device {j}: {k} is "
                                     "not the shared backbone tensor")
    for m in [out["summary"]] + out["client"] + [out["server"]]:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{engine} round: non-finite {m}")
    return runner, {
        "init": init, "summary": out["summary"], "wall_s": wall,
        "peak_mem_gb": peak_gb, "launches": launches, "routes": routes,
        "leaves": {"server_slm": lora_leaves(runner.server_slm),
                   "server_llm": lora_leaves(runner.server_llm),
                   **{f"device{j}": lora_leaves(p)
                      for j, p in enumerate(runner.device_params)}}}


def phase_vectorized_round():
    """Grouped C's checks, then one evaluated round of the training
    configuration on the loop engine and one on the vectorized engine
    from the same seed's states (bit-equal at the start), each counted,
    timed and checked, held against each other; then one stacked CCL step
    against the loop engine's steps on the vectorized runner."""
    import torch
    emit(phase_grouped_lora_checks())
    seconds, rec = {}, {}
    for engine in ("loop", "vectorized"):
        runner, rec[engine] = engine_round(engine, seconds)
        if engine == "loop":
            del runner
            release()
    loop, vec = rec["loop"], rec["vectorized"]
    for j, leaves in loop["init"].items():
        other = vec["init"][j]
        if any(not torch.equal(v, other[k]) for k, v in leaves.items()):
            raise AssertionError(f"the engines' {j} did not start equal")
    for k in ("avg_ce", "server_ce"):
        a, b = loop["summary"][k], vec["summary"][k]
        if not abs(a - b) <= ROUND_CE_RTOL * abs(a):
            raise AssertionError(f"engines' {k}: {a} vs {b}")
    for k in ("avg_acc", "best_acc", "worst_acc", "server_acc"):
        if not abs(loop["summary"][k] - vec["summary"][k]) <= ROUND_ACC_ATOL:
            raise AssertionError(f"engines' {k}: {loop['summary'][k]} vs "
                                 f"{vec['summary'][k]}")
    cfg = runner.cfg
    n_steps = {"server_slm": ROUND["local_steps_ccl"]
               + ROUND["local_steps_amt"] + ROUND["server_steps"],
               "server_llm": ROUND["server_steps"]}
    leaf_err = {}
    for n, leaves in loop["leaves"].items():
        steps = n_steps.get(n, n_steps["server_slm"])
        for k, want in leaves.items():
            got = vec["leaves"][n][k]
            err = (got.float() - want.float()).abs()
            if bool((err > leaf_bound(cfg.lr, steps, want)).any()):
                raise AssertionError(f"engines' {n}:{k} {float(err.max())}"
                                     " apart")
            leaf_err[n] = max(leaf_err.get(n, 0.0), float(err.max()))
    if vec["launches"]["lora_matmul_grouped"] == 0:
        raise AssertionError("the vectorized round launched no grouped C")
    step = stacked_step_check(runner)
    del runner
    ms = {k: 1e3 * statistics.mean(v) for k, v in seconds.items()}
    result = {
        "config": {"slm": round_models()[0].name,
                   "llm": round_models()[1].name, "round": dict(ROUND),
                   "dtype": round_models()[0].dtype},
        "round_wall_s": {e: rec[e]["wall_s"] for e in rec},
        "step_ms": ms,
        "steps": {k: len(v) for k, v in seconds.items()},
        "stacked_step_ms_over_loop_client_step_ms": {
            kind: ms[f"vectorized/{kind}"] / ms[f"loop/{kind}"]
            for kind in ("ccl", "amt")},
        "peak_mem_gb": {e: rec[e]["peak_mem_gb"] for e in rec},
        "launches": {e: rec[e]["launches"] for e in rec},
        "launches_by_route": {e: rec[e]["routes"] for e in rec},
        "summary": {e: rec[e]["summary"] for e in rec},
        "max_leaf_abs_err_vs_loop": leaf_err,
        "tolerance": {"ce_rtol": ROUND_CE_RTOL, "acc_atol": ROUND_ACC_ATOL,
                      "leaves": "2 lr per AdamW step + 2^-8 |leaf|"},
        "stacked_step": step,
    }
    return result, vec["launches"]


# ---------------------------------------------------------------------------
# phase: distribution (torch.distributed: an NCCL group of world size 1)

DIST_DEPTH = dict(slm=6, qwen=4, llm=4)     # the overlap part's layers
DIST_MOE_TOKENS = (4, 512)                  # one phi3.5-moe layer's rows


def nccl_world1():
    """An NCCL process group of world size 1 from a ``file://`` store in a
    temporary directory (no network: NCCL's bootstrap socket on the
    loopback interface).  Returns the directory; raises where NCCL does
    not start (no CPU fallback)."""
    import tempfile
    import torch
    import torch.distributed as dist
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = tempfile.mkdtemp()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"process group on {dist.get_backend()}")
    return store


def dist_overlap_spec():
    """Two cohorts at reduced depth (``DIST_DEPTH``) of the heterogeneous
    phase's models: 2 SLM' clients on modalities 0-1 and 2 QWEN' clients
    on modality 2, LLM' on the server; the overlap engine at staleness 0,
    1 CCL + 1 AMT + 1 SE-CCL step."""
    from repro_torch.core.spec import ClientCohort, FederationSpec
    slm, qwen, llm = het_models()
    d = DIST_DEPTH
    return FederationSpec(
        cohorts=(ClientCohort(dataclasses.replace(slm, n_layers=d["slm"]), 2,
                              "av-edge", modalities=(0, 1)),
                 ClientCohort(dataclasses.replace(qwen, n_layers=d["qwen"]),
                              2, "qwen-edge", modalities=(2,))),
        server_llm=dataclasses.replace(llm, n_layers=d["llm"]), rounds=1,
        local_steps_ccl=1, local_steps_amt=1, server_steps=1,
        engine="overlap", staleness=0, seed=0)


def dist_round(make, mesh, tag, total):
    """One evaluated round of ``make(mesh)``'s runner, counted and timed
    to ``drain()``: exact launches and tensor-core routes, finite metrics;
    (record, summary, every client's LoRA leaves and the server models'
    trainables on the host)."""
    import torch
    runner = make(mesh)
    zero_counters()
    torch.cuda.synchronize()
    b0 = runner.exchanged_bytes
    t0 = time.perf_counter()
    out = runner.run_round()
    runner.drain()
    wall = time.perf_counter() - t0
    moved = runner.exchanged_bytes - b0
    launches = read_counters()
    want, fma = round_launch_plan(runner)
    routes = check_tensor_core_routes(tag, fma)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != expected "
                             f"{want}")
    for n, v in launches.items():
        total[n] = total.get(n, 0) + v
    for m in [out["summary"]] + out["client"] + [out["server"]]:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag}: non-finite {m}")
    leaves = trained_on_host(runner)
    runner.close()
    del runner
    release()
    return ({"wall_s": wall, "exchanged_bytes": moved, "launches": launches,
             "launches_by_route": routes}, out["summary"], leaves)


def dist_pair(name, make, mesh, total):
    """The round without a mesh, then with ``mesh``: bit-equal summaries
    and leaves, equal launches by kernel and route."""
    plain, s0, l0 = dist_round(make, None, f"{name} without a mesh", total)
    meshed, s1, l1 = dist_round(make, mesh, f"{name} on the mesh", total)
    if s0 != s1:
        raise AssertionError(f"{name}: summaries differ: {s0} vs {s1}")
    differ = [f"{n}:{k}" for n, leaves in l0.items()
              for k, v in leaves.items() if not bits_equal(v, l1[n][k])]
    if differ or l0.keys() != l1.keys():
        raise AssertionError(f"{name}: leaves differ: {differ[:8]}")
    for key in ("launches", "launches_by_route"):
        if plain[key] != meshed[key]:
            raise AssertionError(f"{name}: {key} {plain[key]} vs "
                                 f"{meshed[key]}")
    if meshed["exchanged_bytes"] <= 0 or plain["exchanged_bytes"]:
        raise AssertionError(f"{name}: gathered bytes {plain} / {meshed}")
    return {"round_wall_s": {"without_mesh": plain["wall_s"],
                             "with_mesh": meshed["wall_s"]},
            "all_gathered_bytes_per_round": meshed["exchanged_bytes"],
            "bit_equal": True,
            "leaves_compared": sum(len(v) for v in l0.values()),
            "launches": meshed["launches"],
            "launches_by_route": meshed["launches_by_route"],
            "summary": s1}


def dist_moe(mesh):
    """``moe_mlp_sharded`` in a sharding context on ``mesh`` against
    ``moe_mlp`` on one phi3.5-moe layer at full width: equal at f32, the
    bf16 gap printed."""
    import torch
    from repro_torch.configs.phi3p5_moe_42b_a6p6b import CONFIG as PHI
    from repro_torch.models import moe
    from repro_torch.sharding.partition import sharding_context
    from repro_torch.sharding.rules import rules_for
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32 = dataclasses.replace(PHI, dtype="float32")
    p = moe.init_moe(gen, f32)
    x = torch.randn((*DIST_MOE_TOKENS, PHI.d_model), generator=gen,
                    device="cuda")
    out = {}
    with torch.no_grad():
        for tag, cfg, pt, xt in (
                ("float32", f32, p, x),
                ("bfloat16", PHI, {k: v if k == "router" else
                                   v.to(torch.bfloat16)
                                   for k, v in p.items()},
                 x.to(torch.bfloat16))):
            want = moe.moe_mlp(pt, cfg, xt)
            with sharding_context(mesh, rules_for("train", False)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = moe.moe_mlp_sharded(pt, cfg, xt)
                torch.cuda.synchronize()
                ms = 1e3 * (time.perf_counter() - t0)
            out[tag] = {"y_max_abs_err": float((got[0].float()
                                                - want[0].float()).abs()
                                               .max()),
                        "aux_abs_err": abs(float(got[1]) - float(want[1])),
                        "aux": float(got[1]), "ms": ms,
                        "y": got[0].float()}
            if not all(torch.isfinite(t).all() for t in got):
                raise AssertionError(f"moe_mlp_sharded {tag}: non-finite")
    if not (out["float32"]["y_max_abs_err"] == 0.0
            and out["float32"]["aux_abs_err"] == 0.0):
        raise AssertionError(f"moe_mlp_sharded at f32: {out['float32']}")
    y32 = out["float32"].pop("y")
    gap = float((out["bfloat16"].pop("y") - y32).abs().max())
    return {"config": PHI.name, "rows_x_tokens": list(DIST_MOE_TOKENS),
            "experts": PHI.n_experts, "top_k": PHI.top_k,
            "capacity_factor": PHI.capacity_factor, **out,
            "bf16_vs_f32_y_max_abs": gap,
            "f32_y_max_abs": float(y32.abs().max())}


def phase_distribution():
    """The port's distribution at world size 1 on the card: an NCCL
    process group, ``make_federated_mesh()``; the vectorized round of the
    training configuration without and with ``mesh=``, then the overlap
    engine (staleness 0) on a two-cohort spec without and with
    ``make_cohort_meshes(2)``, each pair bit-equal with equal launches;
    ``moe_mlp_sharded`` on one phi3.5-moe layer against ``moe_mlp``;
    ``mma_psum_weights`` against its single-shard value.  Destroys the
    group at the end."""
    import shutil
    import torch
    import torch.distributed as dist
    from repro_torch.core.federated import (FederatedConfig,
                                            FederatedRunner)
    from repro_torch.core.mma import mma_psum_weights
    from repro_torch.launch.mesh import (make_cohort_meshes,
                                         make_federated_mesh,
                                         mesh_axis_sizes)
    from repro_torch.models.model import build_model
    store = nccl_world1()
    try:
        mesh = make_federated_mesh()
        total, res = {}, {
            "process_group": {"backend": dist.get_backend(),
                              "world_size": dist.get_world_size(),
                              "NCCL_SOCKET_IFNAME":
                                  os.environ.get("NCCL_SOCKET_IFNAME"),
                              "nccl": ".".join(map(str, torch.cuda.nccl
                                                   .version()))},
            "mesh": mesh_axis_sizes(mesh)}
        slm_cfg, llm_cfg = round_models()

        def vectorized(m):
            return FederatedRunner(
                FederatedConfig(**dict(ROUND, engine="vectorized")),
                build_model(slm_cfg), build_model(llm_cfg), round_corpus(),
                mesh=m, device="cuda")
        res["vectorized_round"] = dist_pair("vectorized round", vectorized,
                                            mesh, total)
        res["vectorized_round"]["config"] = {
            "slm": slm_cfg.name, "llm": llm_cfg.name,
            "round": dict(ROUND, engine="vectorized")}

        def overlap(m):
            return FederatedRunner(dist_overlap_spec(), round_corpus(),
                                   mesh=m, device="cuda")
        meshes = make_cohort_meshes(2)
        res["overlap_cohort_meshes"] = dist_pair("overlap(0) two cohorts",
                                                 overlap, meshes, total)
        res["overlap_cohort_meshes"]["depth"] = dict(DIST_DEPTH)
        res["moe_mlp_sharded"] = dist_moe(mesh)
        release()
        counts = torch.tensor([2, 3, 1], dtype=torch.int32, device="cuda")
        w = mma_psum_weights(counts, mesh.get_group("data"))
        single = mma_psum_weights(counts)
        if not torch.equal(w, single):
            raise AssertionError(f"mma_psum_weights {w} vs {single}")
        res["mma_psum_weights"] = {"group": float(w),
                                   "single_shard": float(single)}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return res, total


# ---------------------------------------------------------------------------
# phase: distribution past one rank (two gloo ranks sharing the one card)

RANKS = 2                  # gloo ranks, every one on cuda:0
RANKS_REGISTERED = 8       # the population's registered clients
RANKS_PER_ROUND = 4        # sampled a round: 2 a rank at data size 2
RANKS_TIMEOUT = 360.0      # s the ranks may take together (~85 s alone)
RANKS_PG_TIMEOUT = 240.0   # s a rank waits in a collective for its peers
RANKS_TOL = 1e-5           # (b): world 2 against world 1 (the same shapes)
MOE_GRAD_REL = 2e-4        # gradients row by row, of the row's largest
RANKS_OVERLAP_ROUNDS = 2   # staleness 1: round 1 applies round 0's output


def ranks_pop_kw():
    """The population runs' options: 4 a round, the LLM at DIST_DEPTH."""
    return dict(per_round=RANKS_PER_ROUND, llm_layers=DIST_DEPTH["llm"])


def ranks_overlap_spec():
    """:func:`dist_overlap_spec` at staleness 1 for two rounds."""
    return dataclasses.replace(dist_overlap_spec(), staleness=1,
                               rounds=RANKS_OVERLAP_ROUNDS)


def ranks_gloo_check(rank, world):
    """The collectives the port calls on the card (``all_gather``,
    ``all_reduce``, ``broadcast``; ``barrier``), each on CUDA tensors over
    the gloo group, against the values they must give."""
    import torch
    import torch.distributed as dist
    x = torch.full((3, 5), float(rank + 1), device="cuda")
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    summed = x.clone()
    dist.all_reduce(summed)
    cast = torch.full((7,), rank + 1, dtype=torch.bfloat16, device="cuda")
    dist.broadcast(cast, src=world - 1)
    dist.barrier()
    ok = {"all_gather": all(p.is_cuda and bool((p == i + 1).all())
                            for i, p in enumerate(parts)),
          "all_reduce": summed.is_cuda and bool(
              (summed == world * (world + 1) / 2).all()),
          "broadcast": cast.is_cuda and bool((cast == world).all())}
    if not all(ok.values()):
        raise AssertionError(f"gloo on CUDA tensors: {ok}")
    return {op: "cuda" for op in ok}


def ranks_leaves(runner):
    """Host copies of every registered client's LoRA (from the store) and,
    where this rank holds the server, the server models' trainables;
    without a sampler every client's LoRA (``device_params``)."""
    from repro_torch.core.lora import partition
    runner.drain()
    if runner.store is not None:
        out = pop_lora_on_host(runner, runner.store.ids())
        return {n: {k: v.cpu() for k, v in t.items()}
                for n, t in out.items()}
    out = {f"device{j}": {k: v.cpu() for k, v in lora_leaves(p).items()}
           for j, p in enumerate(runner.device_params)}
    if runner.server_slm is not None:
        out.update({n: {k: v.detach().cpu() for k, v in
                        partition(getattr(runner, n)).items()}
                    for n in ("server_slm", "server_llm")})
    return out


def leaves_gap(got, want, what):
    """The largest |got - want| over the leaves of ``want`` (which ``got``
    must all have)."""
    gap = 0.0
    for n, leaves in want.items():
        for k, v in leaves.items():
            if k not in got.get(n, {}):
                raise AssertionError(f"{what}: no {n}:{k}")
            gap = max(gap, float((got[n][k].float() - v.float()).abs()
                                 .max()))
    return gap


def summary_gap(a, b):
    if set(a) != set(b):
        raise AssertionError(f"summary keys {sorted(a)} vs {sorted(b)}")
    return max(abs(a[k] - b[k]) for k in a)


def batch_rounding_probe():
    """Which operations of a client step give a client's rows other bits
    when the stack holds 4 clients than when it holds 2 (world 1's
    working set against a rank's block), forward and backward: each at
    the population's shapes (8 x 136 rows a client, the SLM's d 1280, 20
    x 64 heads, LoRA rank 8, 36 layers of LoRA for the per-client norm,
    the vocabulary of 50,257; the server LLM's d 4096 for the anchors,
    which it computes over the stacked public batch), bf16, the first 2
    clients' part of the 4-client call against the 2-client call.  {op:
    (bit-equal, largest |difference|)}; :func:`step_rounding_probe` adds a
    whole step."""
    import torch
    from repro_torch.core import connector as conn
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    slm, _ = round_models()
    cparams = [conn.init_connector(gen, slm) for _ in range(4)]
    cstack = {k: torch.stack([c[k] for c in cparams]) for k in cparams[0]}
    keys = sorted(cstack)

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def with_grads(fn, inputs, cot):
        """fn's output and the gradients of its inputs under ``cot``."""
        inputs = [t.detach().requires_grad_(True) for t in inputs]
        y = fn(*inputs)
        grads = torch.autograd.grad(y, inputs, cot[:y.shape[0]].to(y.dtype))
        return [y, *grads]

    rows, d, n_max = 8 * 136, 1280, 4
    x, w, w_q = rand(n_max * rows, d), rand(d, 4 * d), rand(d, d)
    a, b = rand(n_max, d, 8), rand(n_max, 8, d)
    x_l, w_l, w_lq = rand(n_max * rows, 4096), rand(4096, 16384), \
        rand(4096, 4096)
    a_l, b_l = rand(4096, 8), rand(8, 4096)
    q, k, v = (rand(8 * n_max, 136, 20, 64) for _ in range(3))
    vs = rand(8 * n_max, 4, d)
    lora = rand(n_max, 36, d, 8)
    logits = rand(8 * n_max, 136, 50257)
    cot_c, cot_b = rand(n_max * rows, d), rand(8 * n_max, 136, d)
    cot_d = rand(8 * n_max, dtype=torch.float32)
    feats = rand(n_max, 8, slm.n_modalities, slm.modality_dim)
    fmask = torch.ones(feats.shape[:3], dtype=torch.bool, device="cuda")
    cot_s = rand(n_max, 8, slm.n_soft_tokens, slm.d_model)

    def connector(f, *leaves):
        soft, _, _ = conn.connector_prefix(dict(zip(keys, leaves)), slm, f,
                                           fmask[:f.shape[0]])
        return soft
    mask = torch.ones((8 * n_max, 4), dtype=torch.bool, device="cuda")
    cases = {
        "matmul x@W (cuBLAS)": lambda n: [x[:n * rows] @ w],
        "matmul x@W at the LLM's MLP (cuBLAS)": lambda n: [
            x_l[:n * rows] @ w_l],
        "C at the LLM's projections (the anchors)": lambda n: [
            ops.lora_matmul(x_l[:n * rows], w_lq, a_l, b_l, 2.0)],
        "C grouped, forward and backward": lambda n: with_grads(
            lambda xx, aa, bb: ops.lora_matmul_grouped(xx, w_q, aa, bb, 2.0),
            [x[:n * rows], a[:n], b[:n]], cot_c),
        "B forward and backward": lambda n: with_grads(
            ops.attention, [q[:8 * n], k[:8 * n], v[:8 * n]], cot_b),
        "D forward and backward": lambda n: with_grads(
            lambda t: ops.gram_log_volume(t, mask[:t.shape[0]]),
            [vs[:8 * n]], cot_d),
        "the connector (products batched over the clients), forward and "
        "backward": lambda n: with_grads(
            connector, [feats[:n]] + [cstack[k][:n] for k in keys], cot_s),
        "per-client sum of squares (AdamW's norm)": lambda n: [torch.sum(
            lora[:n].float() ** 2, dim=(1, 2, 3))],
        "log_softmax rows (the CE)": lambda n: [torch.log_softmax(
            logits[:8 * n].float(), dim=-1)],
    }
    out = {}
    for name, fn in cases.items():
        whole, part = fn(n_max), fn(n_max // 2)
        equal, gap = True, 0.0
        for tw, tp in zip(whole, part):
            tw, tp = tw[:tp.shape[0]].detach(), tp.detach()
            equal &= bits_equal(tw, tp)
            gap = max(gap, float((tw.float() - tp.float()).abs().max()))
        out[name] = {"bit_equal": equal, "max_abs": gap}
        del whole, part
    return out


def check_rounding_gap(tag, got, want, lr, steps, acc_tol):
    """A run whose client blocks have other row counts than ``want``'s
    (the card's dense products round by their row count) held to it:
    each CE within ``ROUND_CE_RTOL``, each accuracy within ``acc_tol``,
    each leaf within ``leaf_bound(lr, steps)``.  ``got`` / ``want``:
    (summary, leaves).  Returns the largest gaps."""
    (s1, l1), (s0, l0) = got, want
    if set(s1) != set(s0):
        raise AssertionError(f"{tag}: summary keys differ")
    for k, v in s0.items():
        lim = ROUND_CE_RTOL * abs(v) if k.endswith("ce") else acc_tol
        if not abs(s1[k] - v) <= lim:
            raise AssertionError(f"{tag}: {k} {s1[k]} vs {v}")
    over = 0.0
    for n, leaves in l0.items():
        for k, v in leaves.items():
            err = (l1[n][k].float() - v.float()).abs()
            over = max(over, float((err / leaf_bound(lr, steps, v)).max()))
    if over > 1.0:
        raise AssertionError(f"{tag}: a leaf {over} of its bound apart")
    return {"summary": summary_gap(s1, s0),
            "leaves": leaves_gap(l1, l0, tag), "leaves_of_bound": over}


def ranks_population(rank, world, out_dir, total):
    """(a) The population run on ``make_federated_mesh()``: rounds 0 and 1
    unevaluated, a checkpoint (rank 0 writes), round 2 evaluated; fresh
    runners load it and run round 2 again, bit for bit."""
    import torch
    from repro_torch.checkpointing import CheckpointManager
    from repro_torch.launch.mesh import make_federated_mesh
    mesh = make_federated_mesh()
    res, rounds = {}, {}
    runner, res["init_s"] = pop_runner(RANKS_REGISTERED, mesh=mesh,
                                       **ranks_pop_kw())
    blk = runner.cohorts[0].blk[0]
    per = RANKS_PER_ROUND // world
    if (blk.start, blk.stop) != (rank * per, rank * per + per):
        raise AssertionError(f"rank {rank}: block {blk}")
    res["block"] = [blk.start, blk.stop]
    gathered = []
    for r in range(2):
        b0 = runner.exchanged_bytes
        rounds[f"round{r}"], _ = pop_round(runner, f"rank {rank} round {r}",
                                           False, total)
        gathered.append(runner.exchanged_bytes - b0)
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = runner.save_checkpoint(mgr)
    res["save_s"] = time.perf_counter() - t0
    if rank == 0:
        # the parent loads it at world 1 while the ranks go on
        ready = os.path.join(out_dir, "ckpt.ready")
        with open(ready + ".tmp", "w") as f:
            f.write(str(step))
        os.replace(ready + ".tmp", ready)
    b0 = runner.exchanged_bytes
    rounds["round2"], first = pop_round(runner, f"rank {rank} round 2",
                                        True, total)
    gathered.append(runner.exchanged_bytes - b0)
    res["gathered_bytes_per_round"] = gathered
    snap = {"participants": first["participants"],
            "summary": first["summary"], "leaves": ranks_leaves(runner)}
    del runner
    release()
    again, res["resume_init_s"] = pop_runner(RANKS_REGISTERED, mesh=mesh,
                                             **ranks_pop_kw())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again.load_checkpoint(mgr, step)
    torch.cuda.synchronize()
    res["load_s"] = time.perf_counter() - t0
    rounds["resumed_round2"], second = pop_round(
        again, f"rank {rank} resumed round 2", True, total)
    gap = leaves_gap(ranks_leaves(again), snap["leaves"], "resumed")
    if second["participants"] != snap["participants"] or \
            second["summary"] != snap["summary"] or gap != 0.0:
        raise AssertionError(f"rank {rank}: resumed round 2 differs "
                             f"({second['summary']} vs {snap['summary']}, "
                             f"leaves {gap})")
    del again
    release()
    res.update(rounds=rounds, step=step, snapshot=snap,
               round_wall_s={k: v["wall_s"] for k, v in rounds.items()},
               resume_bit_equal=True)
    return res


def ranks_overlap(rank, world, total):
    """(b) The overlap engine at staleness 1 on ``make_cohort_meshes(2)``:
    every round's launches are this rank's plan (rank 0: cohort A and no
    server; rank 1: cohort B and the server chain)."""
    import torch
    from repro_torch.core.federated import FederatedRunner
    from repro_torch.launch.mesh import make_cohort_meshes
    runner = FederatedRunner(ranks_overlap_spec(), round_corpus(),
                             mesh=make_cohort_meshes(2), device="cuda")
    holds = runner._serves
    if holds != (rank == world - 1) or \
            (runner.server_slm is None) == holds:
        raise AssertionError(f"rank {rank}: serves {holds}")
    recs, summaries = [], []
    for r in range(RANKS_OVERLAP_ROUNDS):
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = runner.run_round()
        runner.drain()
        wall = time.perf_counter() - t0
        launches = read_counters()
        want = round_launch_plan(runner)[0]
        if launches != want:
            raise AssertionError(f"rank {rank} overlap round {r}: launches "
                                 f"{launches} != {want}")
        check_tensor_core_routes(f"rank {rank} overlap round {r}")
        for n, v in launches.items():
            total[n] = total.get(n, 0) + v
        recs.append({"wall_s": wall, "launches": launches})
        summaries.append(out["summary"])
    leaves = ranks_leaves(runner)
    runner.close()
    del runner
    release()
    return {"serves": holds, "rounds": recs, "summaries": summaries,
            "leaves": leaves}


def ranks_moe(rank, world):
    """(c) ``moe_mlp_sharded`` on (data, model) = (1, 2) on one phi3.5-moe
    layer at full width, f32, at a capacity that drops nothing: y, aux and
    the gradients of x, the router and every expert weight against
    ``moe_mlp``'s, row by row."""
    import torch
    from repro_torch.configs.phi3p5_moe_42b_a6p6b import CONFIG as PHI
    from repro_torch.launch.mesh import make_federated_mesh
    from repro_torch.models import moe
    from repro_torch.sharding.partition import sharding_context
    from repro_torch.sharding.rules import rules_for
    cfg = dataclasses.replace(PHI, dtype="float32",
                              capacity_factor=PHI.n_experts / PHI.top_k)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = {k: v.requires_grad_(True) for k, v in moe.init_moe(gen, cfg)
         .items()}
    x = torch.randn((*DIST_MOE_TOKENS, cfg.d_model), generator=gen,
                    device="cuda", requires_grad=True)
    proj = torch.randn(x.shape, generator=gen, device="cuda")
    leaves = {"x": x, **p}

    def grads(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = fn(p, cfg, x)
        g = torch.autograd.grad(torch.sum(y * proj) + aux,
                                list(leaves.values()))
        torch.cuda.synchronize()
        return (y.detach(), aux.detach(), dict(zip(leaves, g)),
                1e3 * (time.perf_counter() - t0))
    mesh = make_federated_mesh(n_model=2)
    with sharding_context(mesh, rules_for("train", False)):
        y, aux, got, ms = grads(moe.moe_mlp_sharded)
    y1, aux1, want, ms1 = grads(moe.moe_mlp)
    res = {"mesh": list(mesh.shape), "ms": ms, "plain_ms": ms1,
           "y_max_abs_err": float((y - y1).abs().max()),
           "aux_abs_err": abs(float(aux) - float(aux1)), "grad_rel": {}}
    for k, w in want.items():
        g = got[k].reshape(-1, w.shape[-1])
        w = w.reshape(-1, w.shape[-1])
        scale = w.abs().amax(dim=1, keepdim=True)
        rel = float(((g - w).abs() / scale.clamp(min=1e-30)).max())
        res["grad_rel"][k] = rel
        if not (bool(torch.isfinite(g).all()) and bool(
                ((g - w).abs() <= MOE_GRAD_REL * scale).all())):
            raise AssertionError(f"rank {rank}: moe d{k} {rel} of its rows'"
                                 " largest")
    if not (res["y_max_abs_err"] <= 2e-4 * float(y1.abs().max())
            and res["aux_abs_err"] <= 1e-4):
        raise AssertionError(f"rank {rank}: moe y / aux {res}")
    return res


def rank_note(rank, what):
    """One progress line of a rank on standard error."""
    print(f"chip_smoke: rank {rank}: {what}", file=sys.stderr, flush=True)


def rank_main(rank, world, out_dir):
    """One gloo rank on cuda:0 (spawned by :func:`phase_distribution_ranks`):
    the group from the ``file://`` store in ``out_dir``, the gloo check,
    then (a), (b) and (c); its result and its launches saved to
    ``<out_dir>/rank<r>.pt`` (the traceback where it failed).  The kernels
    were built by the parent: this process loads them."""
    import datetime
    import traceback
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        "gloo", init_method=f"file://{out_dir}/store", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=RANKS_PG_TIMEOUT))
    rank_note(rank, "in the gloo group")
    res = {}
    try:
        res["gloo_cuda"] = ranks_gloo_check(rank, world)
        total = {}
        torch.cuda.reset_peak_memory_stats()
        res["population"] = ranks_population(rank, world, out_dir, total)
        rank_note(rank, "(a) population done")
        res["overlap"] = ranks_overlap(rank, world, total)
        rank_note(rank, "(b) overlap done")
        res["moe"] = ranks_moe(rank, world)
        rank_note(rank, "(c) moe done")
        res["launches"] = total
        res["device"] = torch.cuda.get_device_name(0)
        res["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    except Exception:  # noqa: BLE001 — reported by the parent
        res = {"error": traceback.format_exc()}
    finally:
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()


def start_ranks(out_dir):
    """Start :data:`RANKS` ranks of :func:`rank_main` (spawn).  gloo binds
    to the loopback device (``GLOO_SOCKET_IFNAME=lo``), not to whatever
    address the host name resolves to."""
    import torch.multiprocessing as mp
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, RANKS, out_dir))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    return procs


def rank_result(procs, out_dir, r):
    """Rank ``r``'s saved result once its process has ended (None while
    it runs; ``{"error": ...}`` where it crashed without one)."""
    import torch
    p = procs[r]
    if p.is_alive():
        return None
    path = os.path.join(out_dir, f"rank{r}.pt")
    if not os.path.exists(path):
        return {"error": f"rank {r} saved nothing (exit code {p.exitcode})"}
    return torch.load(path, weights_only=False)


def join_ranks(procs, out_dir, deadline):
    """Join the ranks by ``deadline`` and return their results, in rank
    order.  Where one rank fails, the others (which would wait for it in
    their next collective) are killed at once; a rank still running at
    the deadline is killed; either fails the phase."""
    results = [None] * len(procs)
    while time.perf_counter() < deadline:
        for r in range(len(procs)):
            if results[r] is None:
                results[r] = rank_result(procs, out_dir, r)
        if all(results) or any("error" in x for x in results if x):
            break
        time.sleep(0.5)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    stop_ranks(procs)
    for r, res in enumerate(results):
        if res and "error" in res:
            raise AssertionError(f"rank {r} failed:\n{res['error']}")
    if hung or not all(results) or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks hung {hung} (deadline "
                             f"{RANKS_TIMEOUT} s), exit codes "
                             f"{[p.exitcode for p in procs]}")
    return results


def stop_ranks(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def wait_for_checkpoint(procs, out_dir, deadline):
    """The step of the checkpoint rank 0 wrote (``ckpt.ready``), once it
    is there; raises where a rank ended first or the deadline passed."""
    ready = os.path.join(out_dir, "ckpt.ready")
    while not os.path.exists(ready):
        if not all(p.is_alive() for p in procs):
            join_ranks(procs, out_dir, deadline)   # raises a rank's error
        if time.perf_counter() > deadline or \
                not all(p.is_alive() for p in procs):
            stop_ranks(procs)
            raise AssertionError(f"no checkpoint from the ranks (exit codes "
                                 f"{[p.exitcode for p in procs]})")
        time.sleep(0.5)
    with open(ready) as f:
        return int(f.read())


def step_rounding_probe(runner):
    """A client's trainable leaves after one stacked CCL step of
    ``runner``'s working set (4 clients, its live state and next batch)
    against the same step of the first 2 clients alone: (bit-equal,
    largest |difference|)."""
    from repro_torch.checkpointing.checkpoint import map_pytree
    from repro_torch.core import lora
    from repro_torch.data.pipeline import to_tensors
    rt = runner.cohorts[0]
    pub_np, _ = runner._assemble_cohorts(runner._round_idx)[0]
    pub = to_tensors({k: v[0] for k, v in pub_np.items()}, runner.device)
    anchors = runner.stacked_anchors(pub)

    def first(tree):
        return map_pytree(lambda t: t[:2], tree)
    whole, _, _ = rt.ccl_step(rt.stacked_params, rt.stacked_opt, pub,
                              anchors)
    part, _, _ = rt.ccl_step(
        lora.combine(rt.stacked_params,
                     first(lora.partition(rt.stacked_params))),
        first(rt.stacked_opt), first(pub), anchors[:2])
    whole, part = lora.partition(whole), lora.partition(part)
    return {"bit_equal": all(bits_equal(whole[k][:2], v)
                             for k, v in part.items()),
            "max_abs": max(float((whole[k][:2].float() - v.float()).abs()
                                 .max()) for k, v in part.items())}


def world1_population():
    """(a) at world 1: rounds 0 and 1 unevaluated, round 2 evaluated;
    (records, round 2's output, the leaves, the tolerance on the
    accuracies: a scored token of the smallest test set, or
    ``ROUND_ACC_ATOL``)."""
    w1 = {}
    runner, w1["init_s"] = pop_runner(RANKS_REGISTERED, **ranks_pop_kw())
    scored = min(float(t["loss_mask"][:, 1:].sum())
                 for t in runner.priv_test)
    for r in range(3):
        w1[f"round{r}"], last = pop_round(runner, f"world-1 round {r}",
                                          r == 2, {})
    leaves = ranks_leaves(runner)
    w1["step_probe"] = step_rounding_probe(runner)
    del runner
    release()
    return w1, last, leaves, max(ROUND_ACC_ATOL, 1.0 / scored)


def world1_overlap():
    """(b) at world 1: two evaluated rounds, counted."""
    import torch
    from repro_torch.core.federated import FederatedRunner
    runner = FederatedRunner(ranks_overlap_spec(), round_corpus(),
                             device="cuda")
    ov = {"summaries": [], "wall_s": [], "launches": []}
    for r in range(RANKS_OVERLAP_ROUNDS):
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ov["summaries"].append(runner.run_round()["summary"])
        runner.drain()
        ov["wall_s"].append(time.perf_counter() - t0)
        ov["launches"].append(read_counters())
    leaves = ranks_leaves(runner)
    runner.close()
    del runner
    release()
    return ov, leaves


def start_distribution_ranks():
    """Spawn :func:`phase_distribution_ranks`' ranks ahead of it, so that
    they start and run while this process runs the distribution phase:
    (processes, their directory, the time they started)."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    t0 = time.perf_counter()
    return start_ranks(out_dir), out_dir, t0


def phase_distribution_ranks(started=None):
    """The port past one rank: two gloo ranks spawned on the one card,
    each on cuda:0 (NCCL takes no two ranks on one device), against world
    size 1 in this process, which runs its own rounds while the ranks run
    theirs.  (a) the registered population at data size 2, (b) the
    overlap engine's server rank, (c) ``moe_mlp_sharded``'s backward; see
    :func:`rank_main`.  Here: (a) rounds 0-2 at world 1 held to rank 0's
    (summaries, every registered client's LoRA, the server models')
    within the bounds of paths that round otherwise
    (:func:`check_rounding_gap`: a rank's stack holds half the clients),
    then the world-2 checkpoint loaded at world 1 and round 2 again; (b)
    two rounds at world 1 (the same shapes as the ranks') held to the
    ranks' (clients from rank 0, the server from rank 1) at
    ``RANKS_TOL``, and the ranks' launches adding up to world 1's.
    ``started``: the ranks :func:`start_distribution_ranks` spawned (by
    default, spawned here)."""
    import shutil
    import torch
    from repro_torch.checkpointing import CheckpointManager
    beside = started is not None
    procs, out_dir, t0 = started or start_distribution_ranks()
    try:
        w1, last, w1_leaves, acc_tol = world1_population()
        ov, ov_leaves = world1_overlap()
        # (a) the world-2 checkpoint at world 1, once rank 0 wrote it
        step = wait_for_checkpoint(procs, out_dir, t0 + RANKS_TIMEOUT)
        ckpt = os.path.join(out_dir, "ckpt")
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f))
                         for f in os.listdir(ckpt))
        runner, _ = pop_runner(RANKS_REGISTERED, **ranks_pop_kw())
        t1 = time.perf_counter()
        runner.load_checkpoint(CheckpointManager(ckpt), step)
        torch.cuda.synchronize()
        w1["load_s"] = time.perf_counter() - t1
        w1["resumed_round2"], resumed = pop_round(
            runner, "world-1 round 2 from the world-2 checkpoint", True, {})
        resumed_leaves = ranks_leaves(runner)
        del runner
        release()
        ranks = join_ranks(procs, out_dir, t0 + RANKS_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        pop0 = ranks[0]["population"]
        for r in ranks[1:]:
            gap = leaves_gap(r["population"]["snapshot"]["leaves"],
                             pop0["snapshot"]["leaves"], "ranks")
            if gap or r["population"]["snapshot"]["summary"] != \
                    pop0["snapshot"]["summary"]:
                raise AssertionError(f"the ranks' population runs differ "
                                     f"({gap})")
        pop = {}
        snap = pop0["snapshot"]
        if not last["participants"] == resumed["participants"] == \
                snap["participants"]:
            raise AssertionError("world 1 sampled other participants")
        # a rank trains 2 clients where world 1 stacks 4, and on the card
        # a stacked step gives a client's leaves other bits in a stack of
        # 2 than of 4 (``step_rounding_probe``; B, C, D and the other
        # operations ``batch_rounding_probe`` covers do not), so the runs
        # are held within the bounds of two paths whose gradients differ
        # at rounding
        cfg = pop_spec(RANKS_REGISTERED).to_config()
        steps = 3 * (cfg.local_steps_ccl + cfg.local_steps_amt
                     + cfg.server_steps)
        want = (snap["summary"], snap["leaves"])
        pop["max_gap"] = {
            "world1": check_rounding_gap(
                "world 1", (last["summary"], w1_leaves), want, cfg.lr,
                steps, acc_tol),
            "world1_resumed": check_rounding_gap(
                "world 1 resumed", (resumed["summary"], resumed_leaves),
                want, cfg.lr, steps, acc_tol)}
        pop["tolerance"] = {"ce_rtol": ROUND_CE_RTOL, "acc_atol": acc_tol,
                            "leaves": "2 lr per AdamW step + 2^-8 |leaf|, "
                                      f"{steps} steps"}
        pop["batch_rounding_probe"] = {
            **batch_rounding_probe(),
            "the stacked CCL step (the leaves after it)": w1.pop(
                "step_probe")}

        # (b) against world 1, and what each rank left out
        client_rank, server_rank = ranks[0]["overlap"], ranks[-1]["overlap"]
        if client_rank["serves"] or not server_rank["serves"]:
            raise AssertionError("the server is not on the last rank only")
        ov["max_gap"] = {
            "summary": max(summary_gap(a, b) for rk in ranks for a, b in
                           zip(rk["overlap"]["summaries"],
                               ov["summaries"])),
            "clients": leaves_gap(client_rank["leaves"], {
                n: v for n, v in ov_leaves.items()
                if n.startswith("device")}, "overlap clients"),
            "server": leaves_gap(server_rank["leaves"], {
                n: v for n, v in ov_leaves.items()
                if n.startswith("server")}, "overlap server")}
        if max(ov["max_gap"].values()) > RANKS_TOL:
            raise AssertionError(f"overlap world 2 against world 1: {ov}")
        # every kernel's launches split over the ranks, nothing twice: rank
        # 0 ran none of the server chain's
        for r, (mine, whole) in enumerate(zip(
                zip(*(rk["overlap"]["rounds"] for rk in ranks)),
                ov["launches"])):
            summed = {n: sum(m["launches"][n] for m in mine) for n in whole}
            if summed != whole:
                raise AssertionError(f"overlap round {r}: the ranks' "
                                     f"launches {summed} != {whole}")
    finally:
        stop_ranks(procs)
        shutil.rmtree(out_dir, ignore_errors=True)
    total = {}
    for rk in ranks:
        for n, v in rk["launches"].items():
            total[n] = total.get(n, 0) + v
    slm, llm = round_models()
    res = {
        "ranks": RANKS, "backend": "gloo",
        "devices": [f"cuda:0, {rk['device']}" for rk in ranks],
        "gloo_cuda": ranks[0]["gloo_cuda"], "ranks_wall_s": ranks_s,
        "ranks_ran_beside_the_distribution_phase": beside,
        "world1_runs_beside_the_ranks": True,
        "population": {
            "config": {"slm": slm.name, "llm": llm.name,
                       "llm_layers": DIST_DEPTH["llm"],
                       "registered": RANKS_REGISTERED,
                       "per_round": RANKS_PER_ROUND, "codec": "int8",
                       "robust": "trimmed_mean", "faults": HET_FAULTS},
            "blocks": [rk["population"]["block"] for rk in ranks],
            "round_wall_s": {
                "world2": [rk["population"]["round_wall_s"]
                           for rk in ranks],
                "world1": {k: v["wall_s"] for k, v in w1.items()
                           if isinstance(v, dict)}},
            "gathered_bytes_per_round":
                pop0["gathered_bytes_per_round"],
            "checkpoint_bytes": ckpt_bytes,
            "save_s": pop0["save_s"],
            "load_s": {"world2": [rk["population"]["load_s"]
                                  for rk in ranks],
                       "world1": w1["load_s"]},
            "resume_bit_equal": True, **pop},
        "overlap": {
            "staleness": 1, "depth": dict(DIST_DEPTH),
            "server_rank": RANKS - 1,
            "round_wall_s": {"world2": [[x["wall_s"] for x in
                                         rk["overlap"]["rounds"]]
                                        for rk in ranks],
                             "world1": ov["wall_s"]},
            "launches": {"world1": ov["launches"],
                         "ranks": [[x["launches"] for x in
                                    rk["overlap"]["rounds"]]
                                   for rk in ranks]},
            "max_gap": ov["max_gap"]},
        "moe_mlp_sharded_backward": [rk["moe"] for rk in ranks],
        "peak_allocated_bytes": [rk["peak_allocated_bytes"] for rk in ranks],
        "tolerance": {"overlap_world2_vs_world1": RANKS_TOL,
                      "moe_grads_row_rel": MOE_GRAD_REL},
    }
    return res, total


# ---------------------------------------------------------------------------
# phase: the registered population (a sampler, the client store) and
# checkpoint / resume

POP_CLIENTS = 24          # registered clients of the resumed runs
POP_SMALL = 8             # registered clients of the memory comparison
POP_PER_ROUND = 3         # the working set (the vectorized_round's G)
POP_ROUNDS = 3            # rounds 0 and 1 unevaluated, then round 2
POP_MEM_RTOL = 0.01       # device memory at N 8 against N 24


def pop_spec(n, engine="vectorized", per_round=POP_PER_ROUND,
             llm_layers=None):
    """One cohort of ``n`` registered SLM' clients sampled ``per_round`` a
    round, LLM' on the server (its first ``llm_layers`` layers where
    given); trimmed-mean MMA under the heterogeneous phase's faults, the
    int8 wire with error feedback (the residuals ride in the store), 1
    CCL + 1 AMT + 1 SE-CCL step a round."""
    from repro_torch.core.channel import ChannelSpec
    from repro_torch.core.spec import (ClientCohort, FaultSpec,
                                       FederationSpec, ParticipantSampler)
    slm, llm = round_models(llm_layers)
    return FederationSpec(
        cohorts=(ClientCohort(slm, n, "population"),), server_llm=llm,
        rounds=POP_ROUNDS, local_steps_ccl=1, local_steps_amt=1,
        server_steps=1, engine=engine, seed=0, robust="trimmed_mean",
        trim_frac=HET_TRIM, faults=FaultSpec(**HET_FAULTS),
        sampler=ParticipantSampler(per_cohort=per_round, seed=0),
        channel=ChannelSpec(codec="int8"))


def pop_runner(n, engine="vectorized", store_dir=None, mesh=None, **kw):
    """(runner, seconds to build it) of :func:`pop_spec` (``kw`` its
    options), on ``mesh`` where given."""
    import torch
    from repro_torch.core.federated import FederatedRunner
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = FederatedRunner(pop_spec(n, engine, **kw), round_corpus(),
                             device="cuda", store_dir=store_dir, mesh=mesh)
    torch.cuda.synchronize()
    return runner, time.perf_counter() - t0


def pop_round(runner, tag, evaluate, total):
    """One counted round: exact launches over the working set, tensor-core
    routes, finite metrics; the counts add into ``total``.  Returns the
    round's record (with the device memory at its end) and its output."""
    import torch
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.run_round(evaluate=evaluate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    routes = check_tensor_core_routes(tag)
    want = expected_round_launches(runner, evaluate=evaluate)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != expected "
                             f"{want}")
    for n, v in launches.items():
        total[n] = total.get(n, 0) + v
    if evaluate:
        for m in [out["summary"]] + out["client"] + [out["server"]]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{tag}: non-finite {m}")
    return {"wall_s": wall, "evaluate": evaluate,
            "participants": [int(j) for j in runner._rnd_ids],
            "present": runner._rnd_present.astype(int).tolist(),
            "on_time": runner._rnd_contrib.astype(int).tolist(),
            "mem_allocated_bytes": torch.cuda.memory_allocated(),
            "launches": launches, "launches_by_route": routes}, out


def pop_lora_on_host(runner, ids):
    """Host copies of the LoRA leaves of the stored clients ``ids`` and of
    the server SLM and LLM."""
    from repro_torch.core.lora import is_lora_leaf
    out = {f"client{j}": {k: v.clone() for k, v in
                          runner.store.get(j)["train"].items()
                          if is_lora_leaf(k)} for j in ids}
    out.update({n: {k: v.cpu() for k, v in lora_leaves(t).items()}
                for n, t in (("server_slm", runner.server_slm),
                             ("server_llm", runner.server_llm))})
    return out


def entries_on_host(runner, ids):
    """Deep host copies of the store entries of ``ids`` (flat keys)."""
    from repro_torch.checkpointing import flatten_pytree
    return {j: {k: v.clone() for k, v in
                flatten_pytree(runner.store.get(j)).items()} for j in ids}


def checkpoint_dir(runner):
    """A fresh temporary directory for the runner's checkpoint, after
    checking that its file system holds twice the state's bytes."""
    import shutil
    import tempfile
    from repro_torch.checkpointing import flatten_pytree
    need = sum(t.numel() * t.element_size() for t in
               flatten_pytree(runner.checkpoint_state()).values())
    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    free = shutil.disk_usage(d).free
    if free < 2 * need:
        shutil.rmtree(d, ignore_errors=True)
        raise RuntimeError(
            f"the checkpoint needs {need} bytes and {d} has {free} free; "
            "point TMPDIR at a file system with twice that free")
    return d, need


def phase_population_rounds():
    """The registered population at full width: a runner of 24 clients
    sampled 3 a round runs rounds 0 and 1 unevaluated, saves a checkpoint
    and runs round 2 evaluated; a fresh runner loads the checkpoint and
    runs round 2 again, bit for bit.  A runner of 8 clients spilled to
    disk runs round 0: the device memory at the round's end equals the 24
    clients' within 1 % and the store is 8/24 of theirs.  A loop-engine
    runner runs round 0 from the same seed against the vectorized one.
    Every round: exact launches over the working set and tensor-core
    routes."""
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpointing import CheckpointManager
    total, rounds, res = {}, {}, {}
    cfg = pop_spec(POP_CLIENTS).to_config()

    # N = 24: rounds 0 and 1, the checkpoint, round 2
    runner, res["init_s"] = pop_runner(POP_CLIENTS)
    rt = runner.cohorts[0]
    if rt.work_n != POP_PER_ROUND or len(runner.store) != POP_CLIENTS:
        raise AssertionError(f"working set {rt.work_n}, store "
                             f"{len(runner.store)}")
    trees = {"base": runner.cohort_base, "server_slm": runner.server_slm,
             "server_llm": runner.server_llm}
    frozen0 = {n: frozen_fingerprint(t) for n, t in trees.items()}
    rec, _ = pop_round(runner, "population round 0", False, total)
    rounds["n24_round0"] = rec
    # round 0's result, kept on the host (the memory comparison below
    # must not see it)
    vec0 = {"summary": runner.evaluate()["summary"],
            "participants": rec["participants"],
            "leaves": pop_lora_on_host(runner, rec["participants"])}
    rounds["n24_round1"], _ = pop_round(runner, "population round 1",
                                        False, total)
    n24_store = runner.store.nbytes()
    ck, want_bytes = checkpoint_dir(runner)
    try:
        mgr = CheckpointManager(ck)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = runner.save_checkpoint(mgr)
        res["save_s"] = time.perf_counter() - t0
        res["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(ck, f)) for f in os.listdir(ck))
        res["checkpoint_state_bytes"] = want_bytes
        rec, first = pop_round(runner, "population round 2", True, total)
        rounds["n24_round2"] = rec
        snap = {"participants": first["participants"],
                "summary": first["summary"],
                "entries": entries_on_host(runner, first["participants"]),
                "server_slm": {k: v.cpu() for k, v in
                               lora_leaves(runner.server_slm).items()}}
        # (a comprehension: a loop variable would keep the first server
        # LLM alive past the runner, 12 GB of the memory comparison)
        changed = [n for n, t in trees.items()
                   if frozen_fingerprint(t) != frozen0[n]]
        if changed:
            raise AssertionError(f"population: {changed} changed")
        del runner, trees, rt
        release()

        # a fresh runner from the same seed resumes at round 2
        runner, res["resume_init_s"] = pop_runner(POP_CLIENTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner.load_checkpoint(mgr, step)
        torch.cuda.synchronize()
        res["load_s"] = time.perf_counter() - t0
        rec, again = pop_round(runner, "resumed round 2", True, total)
        rounds["n24_resumed_round2"] = rec
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    if again["participants"] != snap["participants"] or \
            again["summary"] != snap["summary"]:
        raise AssertionError(f"resume: {again['participants']} "
                             f"{again['summary']} != {snap['participants']}"
                             f" {snap['summary']}")
    unequal = [f"client{j}:{k}" for j, e in entries_on_host(
        runner, again["participants"]).items() for k, v in e.items()
        if not bits_equal(v, snap["entries"][j][k])]
    unequal += [f"server_slm:{k}" for k, v in
                lora_leaves(runner.server_slm).items()
                if not bits_equal(v, snap["server_slm"][k])]
    if unequal:
        raise AssertionError(f"resume: {len(unequal)} leaves not bit-equal,"
                             f" e.g. {unequal[:4]}")
    res["resume_bit_equal_leaves"] = sum(len(e) for e in
                                         snap["entries"].values()) \
        + len(snap["server_slm"])
    res["summary"] = snap["summary"]
    del runner, snap
    release()

    # N = 8 spilled to disk: device memory follows the working set
    spill = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        runner, res["n8_init_s"] = pop_runner(POP_SMALL, store_dir=spill)
        rounds["n8_round0"], _ = pop_round(runner, "8-client round 0",
                                           False, total)
        n8_store = runner.store.nbytes()
        res["n8_store_files"] = len(os.listdir(spill))
        del runner
        release()
    finally:
        shutil.rmtree(spill, ignore_errors=True)
    mem24 = rounds["n24_round0"]["mem_allocated_bytes"]
    mem8 = rounds["n8_round0"]["mem_allocated_bytes"]
    if abs(mem8 - mem24) > POP_MEM_RTOL * mem24:
        raise AssertionError(f"device memory {mem8} at N {POP_SMALL} vs "
                             f"{mem24} at N {POP_CLIENTS}")
    if n8_store * POP_CLIENTS != n24_store * POP_SMALL:
        raise AssertionError(f"store bytes {n8_store} at N {POP_SMALL} vs "
                             f"{n24_store} at N {POP_CLIENTS}")

    # the loop engine's round 0 from the same seed
    runner, res["loop_init_s"] = pop_runner(POP_CLIENTS, "loop")
    rec, _ = pop_round(runner, "loop-engine round 0", False, total)
    rounds["n24_loop_round0"] = rec
    if rec["participants"] != vec0["participants"]:
        raise AssertionError("the engines sampled other participants")
    loop0 = runner.evaluate()["summary"]
    for k in ("avg_ce", "server_ce"):
        if not abs(loop0[k] - vec0["summary"][k]) <= \
                ROUND_CE_RTOL * abs(loop0[k]):
            raise AssertionError(f"engines' {k}: {loop0[k]} vs "
                                 f"{vec0['summary'][k]}")
    # a template token may flip, as in the vectorized phase: here one
    # token of the smallest participant's test set (a few rows a client
    # at 24 clients) moves its accuracy by more than 0.02
    scored = min(float(runner.priv_test[j]["loss_mask"][:, 1:].sum())
                 for j in rec["participants"])
    acc_tol = max(ROUND_ACC_ATOL, 1.0 / scored)
    for k in ("avg_acc", "best_acc", "worst_acc", "server_acc"):
        if not abs(loop0[k] - vec0["summary"][k]) <= acc_tol:
            raise AssertionError(f"engines' {k}: {loop0[k]} vs "
                                 f"{vec0['summary'][k]}")
    n_steps = {"server_llm": cfg.server_steps}
    loop_leaves = pop_lora_on_host(runner, rec["participants"])
    leaf_err = {}
    for n, leaves in loop_leaves.items():
        steps = n_steps.get(n, cfg.local_steps_ccl + cfg.local_steps_amt
                            + cfg.server_steps)
        for k, want in leaves.items():
            err = (vec0["leaves"][n][k].float() - want.float()).abs()
            if bool((err > leaf_bound(cfg.lr, steps, want)).any()):
                raise AssertionError(f"engines' {n}:{k} {float(err.max())}"
                                     " apart")
            leaf_err[n] = max(leaf_err.get(n, 0.0), float(err.max()))
    summaries = {"vectorized": vec0["summary"], "loop": loop0}
    del runner, vec0, loop_leaves
    release()

    slm, llm = round_models()
    res.update({
        "config": {"slm": slm.name, "llm": llm.name, "dtype": slm.dtype,
                   "registered": [POP_CLIENTS, POP_SMALL],
                   "per_round": POP_PER_ROUND, "rounds": POP_ROUNDS,
                   "robust": "trimmed_mean", "trim_frac": HET_TRIM,
                   "faults": HET_FAULTS, "codec": "int8",
                   "error_feedback": True},
        "rounds": rounds,
        "round_wall_s": {k: v["wall_s"] for k, v in rounds.items()},
        "mem_allocated_bytes": {"n24": mem24, "n8": mem8},
        "mem_rel_diff": abs(mem8 - mem24) / mem24,
        "store_bytes": {"n24": n24_store, "n8": n8_store},
        "engines": {"summary_after_round0": summaries,
                    "max_leaf_abs_err_vs_loop": leaf_err},
        "tolerance": {"memory_rtol": POP_MEM_RTOL, "resume": "bit-equal",
                      "ce_rtol": ROUND_CE_RTOL, "acc_atol": acc_tol,
                      "leaves": "2 lr per AdamW step + 2^-8 |leaf|"},
    })
    return res, total




# ---------------------------------------------------------------------------
# phase: the overlap engine (staleness-pipelined rounds, the server phase
# on its own CUDA stream) and the sketch codec

OVERLAP_ROUND = dict(n_devices=3, local_steps_ccl=1, local_steps_amt=1,
                     server_steps=1, seed=0)
OVERLAP_SKETCH = dict(codec="sketch", sketch_rank=8, seed=0)
OVERLAP_MEM_ATOL = 2**30       # peak bytes against the vectorized runner's
BASIS_TOL = 1e-5               # |Q^T Q - I| on the card
PROJECTION_TOL = 1e-5          # a decoded f32 leaf sketched again


def overlap_runner(engine, staleness=0, channel=None):
    """The training configuration at 1 + 1 + 1 steps on ``engine``."""
    from repro_torch.core.federated import FederatedConfig, FederatedRunner
    from repro_torch.models.model import build_model
    slm_cfg, llm_cfg = round_models()
    cfg = FederatedConfig(**OVERLAP_ROUND, engine=engine,
                          staleness=staleness, channel=channel)
    return FederatedRunner(cfg, build_model(slm_cfg), build_model(llm_cfg),
                           round_corpus(), device="cuda")


def overlap_round(runner, tag, evaluate, total):
    """One counted round: exact launches (the vectorized engine's count),
    tensor-core routes, finite metrics; the wall time to ``sync()`` (the
    clients' side) and to ``drain()`` (everything queued)."""
    import torch
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.run_round(evaluate=evaluate)
    runner.sync()
    t_sync = time.perf_counter() - t0
    runner.drain()
    wall = time.perf_counter() - t0
    launches = read_counters()
    routes = check_tensor_core_routes(tag)
    want = expected_round_launches(runner, evaluate=evaluate)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches} != expected "
                             f"{want}")
    for n, v in launches.items():
        total[n] = total.get(n, 0) + v
    if evaluate:
        for m in [out["summary"]] + out["client"] + [out["server"]]:
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{tag}: non-finite {m}")
    return {"wall_s": wall, "sync_s": t_sync, "launches": launches,
            "launches_by_route": routes,
            "pending_server_outputs": len(runner._srv_q)}, out


def trained_on_host(runner):
    """Host copies of every client's LoRA leaves and the server models'
    trainables (after ``drain()``)."""
    from repro_torch.core.lora import partition
    runner.drain()
    out = {f"device{j}": {k: v.cpu() for k, v in lora_leaves(p).items()}
           for j, p in enumerate(runner.device_params)}
    out.update({n: {k: v.detach().cpu() for k, v in
                    partition(getattr(runner, n)).items()}
                for n in ("server_slm", "server_llm")})
    return out


def sketch_comm_stats(runner, rounds):
    """The sketch wire's bytes from the leaf shapes: a leaf (m, n) with n
    above the rank sends m x rank f32, else with m above it rank x n,
    else its dense bytes; every client present, one downlink a round."""
    r = runner.channel.spec.sketch_rank
    N = runner.cfg.n_devices

    def wire(shape, itemsize):
        m, n = math.prod(shape[:-1]), shape[-1]
        if len(shape) >= 2 and n > r:
            return 4 * m * r
        if len(shape) >= 2 and m > r:
            return 4 * r * n
        return math.prod(shape) * itemsize

    leaves = [(tuple(t.shape[1:]), t.dtype.itemsize)
              for t in runner.up_like.values()]
    per_client = sum(wire(s, i) for s, i in leaves)
    dense = sum(math.prod(s) * i for s, i in leaves)
    f32 = sum(4 * math.prod(s) for s, _ in leaves)
    return {"codec": "sketch", "rounds": rounds,
            "uplink_bytes": rounds * N * per_client,
            "uplink_dense_bytes": rounds * N * dense,
            "uplink_f32_bytes": rounds * N * f32,
            "uplink_ratio": dense / per_client,
            "uplink_ratio_f32": f32 / per_client,
            "downlink_bytes": rounds * per_client,
            "uplink_client_bytes": {0: per_client}}


def stream_concurrency(path):
    """Kernel time per CUDA stream in a profiler trace, the time the
    device had any kernel running (the union over streams) and the time
    kernels of two or more streams ran at once, in ms."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    spans = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            ts = float(ev["ts"])
            spans.setdefault(str(ev.get("args", {}).get("stream")), []).append(
                (ts, ts + float(ev.get("dur", 0.0))))

    def union(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def length(iv):
        return sum(b - a for a, b in iv) / 1e3

    merged = {k: union(v) for k, v in spans.items()}
    busy = length(union([x for v in merged.values() for x in v]))
    # a sweep over the per-stream unions' edges: the time at depth >= 2
    edges = sorted([(a, 1) for v in merged.values() for a, _ in v]
                   + [(b, -1) for v in merged.values() for _, b in v])
    both, depth, last = 0.0, 0, None
    for t, d in edges:
        if depth >= 2:
            both += t - last
        depth, last = depth + d, t
    return {"kernel_ms_by_stream": {k: length(v) for k, v in merged.items()},
            "launches_by_stream": {k: len(v) for k, v in spans.items()},
            "device_busy_ms": busy, "concurrent_ms": both / 1e3}


def clients_equal(runner):
    """Whether every client's LoRA leaves equal client 0's."""
    import torch
    from repro_torch.core.lora import is_lora_leaf, partition
    tr = partition(runner.cohorts[0].stacked_params, is_lora_leaf)
    return all(torch.equal(v[0], v[i]) for v in tr.values()
               for i in range(1, v.shape[0]))


def phase_overlap_rounds():
    """A vectorized runner and an ``engine="overlap", staleness=0`` runner
    from one seed run 2 evaluated rounds each, held against each other
    (bit-equal, else within the vectorized phase's bounds, the leaves
    that differ listed); then a ``staleness=1`` runner over the sketch
    uplink and downlink runs rounds 0 and 1 unevaluated and round 2
    evaluated: no delivery after round 0, one identical delivery on every
    client after round 1, one server output always pending, the exact
    bytes, the bases orthonormal on the card and equal to the host's, a
    decoded leaf a fixed point of the codec, the anchor model on the
    server LLM's own frozen tensors, the peak memory within 1 GB of the
    vectorized runner's.  Every round: exact launches, tensor-core
    routes, wall time to ``sync()`` and to ``drain()``."""
    import torch
    from repro_torch.core.channel import ChannelSpec
    from repro_torch.core.lora import default_trainable, flatten
    from repro_torch.core.threefry import sketch_basis
    total, rounds, peak, res = {}, {}, {}, {}
    cfg = None

    # step 1: the vectorized engine and overlap(0) from one seed
    snaps = {}
    for engine in ("vectorized", "overlap"):
        runner = overlap_runner(engine)
        cfg = runner.cfg
        torch.cuda.reset_peak_memory_stats()
        sums = []
        for i in range(2):
            rec, out = overlap_round(
                runner, f"{engine}(0) round {i}", True,
                total if engine == "overlap" else {})
            rounds[f"{engine}0_round{i}"] = rec
            sums.append(out["summary"])
        peak[f"{engine}0"] = torch.cuda.max_memory_allocated()
        snaps[engine] = {"summaries": sums,
                         "leaves": trained_on_host(runner)}
        if engine == "overlap":
            res["server_stream_used"] = (runner._srv_stream is not None
                                         and runner._srv_event is not None)
            runner.close()
        del runner
        release()
    vec, ov = snaps["vectorized"], snaps["overlap"]
    differ, leaf_err = [], {}
    n_steps = {"server_llm": cfg.server_steps}
    for n, leaves in vec["leaves"].items():
        steps = n_steps.get(n, cfg.local_steps_ccl + cfg.local_steps_amt
                            + cfg.server_steps)
        for k, want in leaves.items():
            got = ov["leaves"][n][k]
            if bits_equal(got, want):
                continue
            err = (got.float() - want.float()).abs()
            if bool((err > leaf_bound(cfg.lr, steps, want)).any()):
                raise AssertionError(f"overlap(0) {n}:{k} "
                                     f"{float(err.max())} from vectorized")
            differ.append({"leaf": f"{n}:{k}", "numel": want.numel(),
                           "max_abs_err": float(err.max())})
            leaf_err[n] = max(leaf_err.get(n, 0.0), float(err.max()))
    for a, b in zip(vec["summaries"], ov["summaries"]):
        for k in ("avg_ce", "server_ce"):
            if not abs(a[k] - b[k]) <= ROUND_CE_RTOL * abs(a[k]):
                raise AssertionError(f"overlap(0) {k}: {b[k]} vs {a[k]}")
        for k in ("avg_acc", "best_acc", "worst_acc", "server_acc"):
            if not abs(a[k] - b[k]) <= ROUND_ACC_ATOL:
                raise AssertionError(f"overlap(0) {k}: {b[k]} vs {a[k]}")
    res["staleness0"] = {
        "bit_equal": not differ and vec["summaries"] == ov["summaries"],
        "summaries_equal": vec["summaries"] == ov["summaries"],
        "leaves_compared": sum(len(v) for v in vec["leaves"].values()),
        "leaves_not_bit_equal": differ,
        "max_leaf_abs_err": leaf_err,
        "summary": {"vectorized": vec["summaries"][-1],
                    "overlap": ov["summaries"][-1]}}
    del snaps, vec, ov
    release()

    # step 2: staleness 1 over the sketch uplink and downlink
    runner = overlap_runner("overlap", 1, ChannelSpec(**OVERLAP_SKETCH))
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        rec, out = overlap_round(runner, f"overlap(1) sketch round {i}",
                                 i == 2, total)
        rounds[f"overlap1_sketch_round{i}"] = rec
        if len(runner._srv_q) != 1:
            raise AssertionError(f"round {i}: {len(runner._srv_q)} pending "
                                 "server outputs, expected 1")
        if i == 0 and clients_equal(runner):
            raise AssertionError("round 0 delivered (staleness 1)")
        if i == 1 and not clients_equal(runner):
            raise AssertionError("round 1: the clients hold different "
                                 "deliveries")
    peak["overlap1_sketch"] = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    runner.drain()
    res["drain_s"] = time.perf_counter() - t0
    res["summary_staleness1_sketch"] = out["summary"]
    want = sketch_comm_stats(runner, 3)
    if runner.comm_stats != want:
        raise AssertionError(f"comm_stats {runner.comm_stats} != {want}")
    res["comm_stats"] = want
    spec = runner.channel.spec
    basis_err = 0.0
    for (dim, idx, rnd, dev), q in runner.channel._bases.items():
        eye = torch.eye(spec.sketch_rank, device=q.device)
        basis_err = max(basis_err, float((q.T @ q - eye).abs().max()))
        host = torch.from_numpy(sketch_basis(spec.seed, dim, idx, rnd,
                                             spec.sketch_rank))
        if q.device.type != "cuda" or not torch.equal(q.cpu(), host):
            raise AssertionError(f"basis {(dim, idx, rnd)} on the card is "
                                 "not the host's")
    if basis_err > BASIS_TOL:
        raise AssertionError(f"a basis is {basis_err} from orthonormal")
    up = {k: v.float() for k, v in
          lora_leaves(runner.cohorts[0].stacked_params).items()}
    dec, _ = runner.channel.roundtrip(up, None, runner._rnd_no)
    again, _ = runner.channel.roundtrip(dec, None, runner._rnd_no)
    proj_err = max(float((again[k] - dec[k]).abs().max()) for k in dec)
    if proj_err > PROJECTION_TOL:
        raise AssertionError(f"a decoded leaf moves {proj_err} when "
                             "sketched again")
    srv = flatten(runner.server_llm)
    shared = [k for k, v in flatten(runner.cohorts[0].anchor_base).items()
              if not default_trainable(k)
              and v.data_ptr() == srv[k].data_ptr()]
    frozen = [k for k in srv if not default_trainable(k)]
    if len(shared) != len(frozen):
        raise AssertionError(f"the anchor model shares {len(shared)} of "
                             f"{len(frozen)} frozen server LLM leaves")
    if abs(peak["overlap1_sketch"] - peak["vectorized0"]) > OVERLAP_MEM_ATOL:
        raise AssertionError(f"peak {peak['overlap1_sketch']} B against the "
                             f"vectorized runner's {peak['vectorized0']}")
    # one more round under the profiler: does the server stream run
    # beside the clients' kernels while one host thread dispatches both?
    from torch.profiler import ProfilerActivity, profile
    out_dir = ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run_round(evaluate=False)
        runner.drain()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = out_dir / "trace_overlap1_round3.json"
    prof.export_chrome_trace(str(trace))
    conc = stream_concurrency(trace)
    conc.update(wall_ms=wall_ms, device_idle_share=(
        1.0 - conc["device_busy_ms"] / wall_ms) if conc["device_busy_ms"]
        else "not measured")
    res["profile_staleness1_round3"] = conc
    res.update({
        "bases": len(runner.channel._bases),
        "basis_max_abs_err_vs_identity": basis_err,
        "projection_max_abs_err": proj_err,
        "anchor_frozen_leaves_shared": len(shared)})
    runner.close()
    del runner, dec, again, up, srv
    release()

    slm, llm = round_models()
    res.update({
        "config": {"slm": slm.name, "llm": llm.name, "dtype": slm.dtype,
                   "round": dict(OVERLAP_ROUND), "sketch": OVERLAP_SKETCH},
        "rounds": rounds,
        "round_wall_s": {k: v["wall_s"] for k, v in rounds.items()},
        "round_sync_s": {k: v["sync_s"] for k, v in rounds.items()},
        "peak_mem_bytes": peak,
        "launches": total,
        "tolerance": {"staleness0": "bit-equal, else 2 lr per AdamW step "
                      "+ 2^-8 |leaf|", "ce_rtol": ROUND_CE_RTOL,
                      "acc_atol": ROUND_ACC_ATOL,
                      "peak_mem_atol_bytes": OVERLAP_MEM_ATOL,
                      "basis": BASIS_TOL, "projection": PROJECTION_TOL},
    })
    return res, total


# ---------------------------------------------------------------------------
# phase: training the ssm and hybrid families (G and G′ on the main path)

SSM_ROUND = dict(local_steps_ccl=1, local_steps_amt=1, server_steps=1,
                 batch_size=8, seed=0)


def ssm_models():
    """mamba2-2.7b (:func:`mamba2_config`), hymba-1.5b and the paper's LLM
    (:func:`round_models`) at their published widths, each with the one
    1280-wide connector latent the reference demands of every model of a
    federation."""
    from repro_torch.configs.hymba_1p5b import CONFIG as HYMBA
    _, llm = round_models()
    return (dataclasses.replace(mamba2_config(), connector_dim=1280),
            dataclasses.replace(HYMBA, connector_dim=1280), llm)


def ssm_spec(engine):
    """3 mamba2 clients on modalities 0-1, 2 hymba clients on modality 2,
    the LLM on the server; the server SLM is the first cohort's model, so
    SE-CCL trains a mamba2 too."""
    from repro_torch.core.spec import ClientCohort, FederationSpec
    mamba2, hymba, llm = ssm_models()
    return FederationSpec(
        cohorts=(ClientCohort(mamba2, 3, "mamba2-edge", modalities=(0, 1)),
                 ClientCohort(hymba, 2, "hymba-edge", modalities=(2,))),
        server_llm=llm, rounds=1, engine=engine, **SSM_ROUND)


def ssm_corpus():
    """The round's corpus over hymba's 32,001-token vocabulary, the
    smallest of the federation's (token ids past a model's vocabulary
    are refused)."""
    from repro_torch.data.synthetic import synthetic_multimodal_corpus
    return synthetic_multimodal_corpus(
        0, CORPUS["n_samples"], CORPUS["seq_len"],
        min(m.vocab_size for m in ssm_models()),
        n_classes=CORPUS["n_classes"], n_modalities=CORPUS["n_modalities"],
        modality_dim=CORPUS["modality_dim"],
        template_len=CORPUS["template_len"])


def adam_step_below_bf16(runner, who, key, leaf):
    """Whether trainable leaf ``key`` of ``who`` ("device{j}",
    "server_slm", "server_llm") had a gradient (a nonzero AdamW first
    moment) whose last AdamW step, recomputed from the optimizer state,
    lies under half the bf16 spacing of every element (2^-9 |x|), so that
    the step rounds back to the leaf's value: {"below", "last_step",
    "mu"} (the step's and the first moment's largest magnitudes)."""
    import torch
    if who.startswith("device"):
        j = int(who[len("device"):])
        rt = next(r for r in runner.cohorts
                  if r.offset <= j < r.offset + r.n)
        i = j - rt.offset
        if rt.stacked_opt is not None:
            o = rt.stacked_opt
            step, mu, nu = o["step"][i], o["mu"][key][i], o["nu"][key][i]
        else:
            o = rt.device_opt[i]
            step, mu, nu = o["step"], o["mu"][key], o["nu"][key]
    else:
        o = getattr(runner, f"{who}_opt")
        step, mu, nu = o["step"], o["mu"][key], o["nu"][key]
    t = step.float()
    u = runner.spec.lr * (mu / (1 - 0.9 ** t)) / (
        torch.sqrt(nu / (1 - 0.95 ** t)) + 1e-8)
    below = bool((u.abs() < 2.0 ** -9 * leaf.float().abs()).all()) \
        and bool((mu != 0).any())
    return {"below": below, "last_step": float(u.abs().max()),
            "mu": float(mu.abs().max())}


def ssm_round(engine, seconds, pre_eval):
    """One evaluated round of ``ssm_spec(engine)`` from the seed's states,
    counted, timed and checked: (runner, record)."""
    import torch
    from repro_torch.core.federated import FederatedRunner
    from repro_torch.core.lora import default_trainable, flatten
    spec = ssm_spec(engine)
    names = [c.name for c in spec.cohorts]
    runner = FederatedRunner(spec, ssm_corpus(), device="cuda")

    def timed(fn, key):
        def run(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            seconds.setdefault(key, []).append(time.perf_counter() - t)
            return out
        return run
    steps = [(rt.ccl_step, rt.amt_step) for rt in runner.cohorts]
    for rt, name in zip(runner.cohorts, names):
        rt.ccl_step = timed(rt.ccl_step, f"{engine}/{name}/ccl")
        rt.amt_step = timed(rt.amt_step, f"{engine}/{name}/amt")
    se_step = runner.se_step
    runner.se_step = timed(se_step, f"{engine}/server/seccl")
    trees = {f"base/{n}": b for n, b in zip(names, runner.cohort_bases)}
    trees.update(server_slm=runner.server_slm, server_llm=runner.server_llm)
    frozen0 = {n: frozen_fingerprint(t) for n, t in trees.items()}
    init = snapshot_trainable(runner)
    before = runner.evaluate()["summary"] if pre_eval else None
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.run_round()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    want, fma = round_launch_plan(runner)
    routes = check_tensor_core_routes(f"ssm {engine} round", fma)
    if launches != want:
        raise AssertionError(f"ssm {engine} round: launches {launches} != "
                             f"expected {want}")
    if not fma["lora_matmul" if engine == "loop" else "lora_matmul_grouped"]:
        raise AssertionError(f"ssm {engine} round: hymba's in_proj took no "
                             "FMA launch")
    for rt, (ccl, amt) in zip(runner.cohorts, steps):
        rt.ccl_step, rt.amt_step = ccl, amt
    runner.se_step = se_step
    for n, t in trees.items():
        if frozen_fingerprint(t) != frozen0[n]:
            raise AssertionError(f"ssm {engine} round: {n}: the frozen "
                                 "backbone changed")
    for rt, base in zip(runner.cohorts, runner.cohort_bases):
        bflat = flatten(base)
        for i, p in enumerate(rt.device_params):
            for k, v in flatten(p).items():
                if not default_trainable(k) and v is not bflat[k]:
                    raise AssertionError(f"ssm {engine} round: {names[rt.idx]}"
                                         f" client {i}: {k} is not the "
                                         "cohort's backbone")
    bad = [f"{n}:{k}" for n, t in snapshot_trainable(runner).items()
           for k, v in t.items() if not bool(torch.isfinite(v).all())]
    if bad:
        raise AssertionError(f"ssm {engine} round: non-finite {bad[:3]}")
    # one SE-CCL step from LoRA B = 0 gives the LLM's LoRA A no gradient;
    # any other leaf that did not move must have had a gradient whose
    # AdamW steps fell below half its bf16 spacing
    unmoved = set(unmoved_leaves(init, runner))
    no_grad = {f"server_llm:{k}" for k in init["server_llm"]
               if k.endswith("_lora_a")}
    if not no_grad <= unmoved:
        raise AssertionError(f"ssm {engine} round: the LLM's LoRA A moved: "
                             f"{sorted(no_grad - unmoved)[:3]}")
    now = snapshot_trainable(runner)
    below_bf16 = {}
    for name in sorted(unmoved - no_grad):
        who, key = name.split(":", 1)
        below_bf16[name] = adam_step_below_bf16(runner, who, key,
                                                now[who][key])
        if not below_bf16[name]["below"]:
            raise AssertionError(f"ssm {engine} round: {name} did not move"
                                 f": {below_bf16[name]}")
    for m in [out["summary"]] + out["client"] + [out["server"]]:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"ssm {engine} round: non-finite {m}")
    return runner, {
        "init": init, "before": before, "summary": out["summary"],
        "wall_s": wall, "peak_mem_bytes": peak, "launches": launches,
        "routes": routes, "fma_launches_of_C": fma,
        "unmoved_below_bf16_spacing": below_bf16,
        "leaves": {n: lora_leaves(t) for n, t in
                   [("server_slm", runner.server_slm),
                    ("server_llm", runner.server_llm)]
                   + [(f"device{j}", p)
                      for j, p in enumerate(runner.device_params)]}}


def phase_ssm_training():
    """One evaluated round of the ssm + hybrid federation on the vectorized
    engine, then one on the loop engine from the same seed's states (equal
    at the start), each counted (G, G′ and C's FMA launches at hymba's
    in_proj exactly), timed and checked; the two rounds' summaries and
    LoRA leaves held against each other."""
    import torch
    seconds, rec = {}, {}
    for engine in ("vectorized", "loop"):
        runner, rec[engine] = ssm_round(engine, seconds,
                                        pre_eval=engine == "vectorized")
        del runner
        release()
    vec, loop = rec["vectorized"], rec["loop"]
    for n, leaves in vec["init"].items():
        if any(not torch.equal(v, loop["init"][n][k])
               for k, v in leaves.items()):
            raise AssertionError(f"ssm rounds: {n} did not start equal")
    for k in ("avg_ce", "server_ce"):
        a, b = loop["summary"][k], vec["summary"][k]
        if not abs(a - b) <= ROUND_CE_RTOL * abs(a):
            raise AssertionError(f"ssm rounds' {k}: {a} vs {b}")
    for k in ("avg_acc", "best_acc", "worst_acc", "server_acc"):
        if not abs(loop["summary"][k] - vec["summary"][k]) <= ROUND_ACC_ATOL:
            raise AssertionError(f"ssm rounds' {k}: {loop['summary'][k]} vs"
                                 f" {vec['summary'][k]}")
    n_steps = {"server_llm": SSM_ROUND["server_steps"]}
    lr, leaf_err = ssm_spec("loop").lr, {}
    for n, leaves in loop["leaves"].items():
        steps = n_steps.get(n, SSM_ROUND["local_steps_ccl"]
                            + SSM_ROUND["local_steps_amt"]
                            + SSM_ROUND["server_steps"])
        for k, want in leaves.items():
            got = vec["leaves"][n][k]
            err = (got.float() - want.float()).abs()
            if bool((err > leaf_bound(lr, steps, want)).any()):
                raise AssertionError(f"ssm rounds' {n}:{k} "
                                     f"{float(err.max())} apart")
            leaf_err[n] = max(leaf_err.get(n, 0.0), float(err.max()))
    mamba2, hymba, llm = ssm_models()
    ms = {k: 1e3 * statistics.mean(v) for k, v in seconds.items()}
    result = {
        "config": {"cohorts": [[mamba2.name, 3, [0, 1]],
                               [hymba.name, 2, [2]]],
                   "server_llm": llm.name, "server_slm": mamba2.name,
                   "connector_dim": 1280, "dtype": mamba2.dtype,
                   "corpus_vocab": min(m.vocab_size for m in ssm_models()),
                   "remat": mamba2.remat, "round": dict(SSM_ROUND)},
        "round_wall_s": {e: rec[e]["wall_s"] for e in rec},
        "step_ms": ms, "steps": {k: len(v) for k, v in seconds.items()},
        "peak_mem_bytes": {e: rec[e]["peak_mem_bytes"] for e in rec},
        "before": vec["before"],
        "summary": {e: rec[e]["summary"] for e in rec},
        "launches": {e: rec[e]["launches"] for e in rec},
        "launches_by_route": {e: rec[e]["routes"] for e in rec},
        "fma_launches_of_C": {e: rec[e]["fma_launches_of_C"] for e in rec},
        "unmoved_below_bf16_spacing": {
            e: rec[e]["unmoved_below_bf16_spacing"] for e in rec},
        "hymba_in_proj_routes": projection_routes(hymba)["in_proj"],
        "max_leaf_abs_err_vs_loop": leaf_err,
        "tolerance": {"ce_rtol": ROUND_CE_RTOL, "acc_atol": ROUND_ACC_ATOL,
                      "leaves": "2 lr per AdamW step + 2^-8 |leaf|"},
    }
    total = {n: sum(rec[e]["launches"][n] for e in rec)
             for n in vec["launches"]}
    return result, total


# ---------------------------------------------------------------------------
# phase 16 / 17: ring-cache serving (generate), and the registry's dense
# and vlm configs at full width

# the ring decode against the paged decode on the same weights and tokens:
# at f32 both paths run the same kernels on the same keys and differ only
# in how A splits each key walk; at bf16 as the paged decode against the
# forward (E2E_TOL)
RING_PAGED_TOL_F32 = dict(atol=1e-3, rtol=1e-3)
CONSISTENCY_K = 8          # teacher-forced decode steps held per model


def served_params(bundle, seed=0):
    """Random params of ``bundle`` on the card from ``seed``, LoRA B filled
    too, so that merging is real work."""
    import torch
    from repro_torch.core.lora import flatten
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bundle.init(gen)
    for path, leaf in flatten(params).items():
        if path.endswith("_lora_b"):
            leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                   device="cuda") * 0.02)
    return params


def decode_weight_bytes(bundle, params):
    """Bytes of the served weights a decode step reads: all of them but an
    untied embedding table, of which a step gathers one row a slot, and
    (encdec) but the encoder, its frontend and the cross-attention's K / V
    projections, which only a prefill runs.  A moe step reads every
    expert (the E x C form)."""
    from repro_torch.core.lora import flatten
    skip = ("enc_layers/", "enc_norm", "frontend/", "dec_layers/xattn/wk",
            "dec_layers/xattn/wv")
    if not bundle.cfg.tie_embeddings:
        skip += ("tok/embed",)
    return sum(v.numel() * v.element_size()
               for k, v in flatten(params).items() if not k.startswith(skip))


def path_launches(cfg, prefills, steps):
    """The exact launches of a serving run: B (attention families) and G
    (ssm, hybrid) once a layer of each prefill, A once an attention layer
    of each decode step.  encdec: B once an encoder layer and twice a
    decoder layer (self- and cross-attention) of each prefill, A twice a
    decoder layer of each step (``layers.cross_attention_decode``)."""
    L = cfg.n_layers
    attn, ssd = cfg.family != "ssm", cfg.family in ("ssm", "hybrid")
    per_prefill, per_step = L * attn, L * attn
    if cfg.family == "encdec":
        per_prefill, per_step = cfg.n_enc_layers + 2 * L, 2 * L
    return {"flash_attention": per_prefill * prefills,
            "ssd_chunk": L * ssd * prefills,
            "paged_attention": per_step * steps}


def d256_fma(cfg, steps):
    """A's FMA launches a run must make: every one at D 256 (gemma),
    whose decode the mma walk does not take (``paged_attention.
    MMA_HEAD_DIMS``), none elsewhere."""
    from repro_torch.kernels.paged_attention import MMA_HEAD_DIMS
    if cfg.family == "ssm" or cfg.head_dim in MMA_HEAD_DIMS:
        return None
    return {"paged_attention": cfg.n_layers * steps}


def counted(tag, cfg, want, fma):
    """The counters since ``zero_counters``: exactly ``want``, every other
    kernel idle, and the tensor-core routes but ``fma``'s.  Returns
    (launches, the routes that took launches)."""
    launches = read_counters()
    full = dict.fromkeys(launches, 0)
    full.update(want)
    if launches != full:
        raise AssertionError(f"{tag} launches {launches} != {full}")
    routes = check_tensor_core_routes(tag, fma)
    return launches, {n: r for n, r in routes.items() if any(r.values())}


def generate_run(bundle, params, prompts, extra, max_new, tag):
    """One counted ``generate`` call on the served weights (merge=False):
    B rows of S tokens, ``max_new`` tokens each (the last sampled without
    a decode), after a warm-up call (max_new 2) and one prefill timed
    alone.  Returns (tokens, metrics, launches)."""
    import torch
    from repro_torch.launch.serve import generate, make_prefill
    from repro_torch.models.layers import padded_vocab
    cfg = bundle.cfg
    B, S = prompts.shape
    with torch.no_grad():
        generate(bundle, params, prompts, max_new=2, batch_extra=extra,
                 merge=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        make_prefill(bundle)(params, {"tokens": prompts, **extra})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
    zero_counters()
    t0 = time.perf_counter()
    toks = generate(bundle, params, prompts, max_new=max_new,
                    batch_extra=extra, merge=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = max_new - 1
    launches, routes = counted(f"{tag} generate", cfg,
                               path_launches(cfg, 1, steps),
                               d256_fma(cfg, steps))
    if tuple(toks.shape) != (B, max_new) or toks.device != prompts.device \
            or int(toks.min()) < 0 or int(toks.max()) >= padded_vocab(cfg):
        raise AssertionError(f"{tag} generate: bad tokens {toks.shape}")
    return toks, {
        "rows": B, "prompt_tokens": S, "max_new": max_new,
        "tokens": B * max_new, "wall_s": wall,
        "tokens_per_s": B * max_new / wall, "prefill_ms": 1e3 * prefill_s,
        "decode_step_ms_mean": 1e3 * (wall - prefill_s) / steps,
        "decode_step_ms_is": "(the counted call's wall - one prefill's "
                             "wall) / (max_new - 1)",
        "launches": {n: v for n, v in launches.items() if v},
        "launches_by_route": routes}, launches


def engine_run(bundle, params, prompts, extra_rows, max_new, econf, tag):
    """The same prompts through ``ServingEngine`` on the served weights
    (merge=False), one request a row, after one short warm-up request.
    Returns (each row's tokens, metrics, launches, the engine, the block
    tables, lengths and active slots of its step with the most cached
    tokens)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve_engine import ServingEngine
    cfg = bundle.cfg
    engine = ServingEngine(bundle, params, econf, merge=False)
    rows = prompts.cpu().numpy()
    engine.submit(rows[0][:32], max_new=2, **extra_rows[0])
    engine.run()
    torch.cuda.synchronize()
    base = dict(steps=engine.n_steps, prefills=engine.n_prefills,
                dec=engine.decode_seconds, pre=engine.prefill_seconds)
    zero_counters()
    t0 = time.perf_counter()
    rids = [engine.submit(r, max_new=max_new, **x)
            for r, x in zip(rows, extra_rows)]
    snap, best = None, -1
    while engine.busy:
        engine.tick()
        sd = engine.sched
        total = int(torch.where(sd["active"], sd["seq_lens"] + 1, 0).sum())
        if total > best:
            best = total
            snap = (sd["block_tables"].clone(), sd["seq_lens"].clone(),
                    sd["active"].clone())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = engine.n_steps - base["steps"]
    prefills = engine.n_prefills - base["prefills"]
    launches, routes = counted(f"{tag} engine", cfg,
                               path_launches(cfg, prefills, steps),
                               d256_fma(cfg, steps))
    outs = [engine.finished[r].out for r in rids]
    if prefills != len(rows) or any(len(o) != max_new for o in outs):
        raise AssertionError(f"{tag} engine: {prefills} prefills, "
                             f"{[len(o) for o in outs]} tokens")
    if sorted(engine._free_pages) != list(range(1, econf.n_pages)) \
            or sorted(engine._free_slots) != list(range(econf.n_slots)):
        raise AssertionError(f"{tag} engine: free lists not restored")
    n_tokens = sum(len(o) for o in outs)
    return np.stack(outs), {
        "requests": len(rows), "tokens": n_tokens, "wall_s": wall,
        "tokens_per_s": n_tokens / wall, "decode_steps": steps,
        "decode_step_ms_mean": 1e3 * (engine.decode_seconds - base["dec"])
        / steps,
        "prefill_ms_mean": 1e3 * (engine.prefill_seconds - base["pre"])
        / prefills,
        "launches": {n: v for n, v in launches.items() if v},
        "launches_by_route": routes}, launches, engine, snap


def ring_paged_consistency(bundle, params, toks, extra, tol, rp_tol):
    """Teacher-forced decode of the last ``CONSISTENCY_K`` tokens of
    ``toks`` (one row) after a prefill of the rest, on the ring path
    (``prefill`` + ``decode_step``) and on the paged path
    (``prefill_paged`` at exact length + ``insert_paged`` +
    ``decode_paged``): every step's logits, the prefill's included,
    against one full forward over the same tokens (``tol``; None:
    measured only), and the ring's against the paged path's (``rp_tol``).
    Returns the largest errors."""
    import torch
    from repro_torch.launch.serve import _reseat_cache
    from repro_torch.models.paged import pages_for
    K = CONSISTENCY_K
    S = toks.shape[1] - K
    ps = 16
    with torch.no_grad():
        full, _ = bundle.logits(params, {"tokens": toks, **extra})
        P = full.shape[1] - S - K
        pre = {"tokens": toks[:, :S], **extra}
        last, cache = bundle.prefill(params, pre)
        cache = _reseat_cache(bundle.init_cache(1, P + S + K, "cuda"), cache)
        n_pg = pages_for(P + S + K, ps)
        pstate = bundle.init_paged(1, n_pg + 1, ps, "cuda")
        plast, pack, kv_len = bundle.prefill_paged(params, pre, S)
        pstate = bundle.insert_paged(
            pstate, pack, 0, torch.arange(1, 1 + pages_for(kv_len, ps),
                                          device="cuda"))
        del pack
        bt = torch.arange(1, 1 + n_pg, dtype=torch.int32,
                          device="cuda")[None]
        lens = torch.full((1,), kv_len, dtype=torch.int32, device="cuda")
        active = torch.ones((1,), dtype=torch.bool, device="cuda")
        pairs = [(last[0], plast[0], full[0, P + S - 1])]
        for i in range(K):
            tok = toks[:, S + i:S + i + 1]
            ring, cache = bundle.decode_step(params, cache, tok, P + S + i)
            paged, pstate = bundle.decode_paged(params, pstate, bt, lens,
                                                tok, active)
            pairs.append((ring[0], paged[0], full[0, P + S + i]))
            lens = lens + 1
    out = dict.fromkeys(("ring_vs_forward", "paged_vs_forward",
                         "ring_vs_paged"), 0.0)
    for i, (ring, paged, want) in enumerate(pairs):
        for key, got, ref, t in (("ring_vs_forward", ring, want, tol),
                                 ("paged_vs_forward", paged, want, tol),
                                 ("ring_vs_paged", ring, paged, rp_tol)):
            out[key] = max(out[key], check_close(f"{key} step {i}", got, ref,
                                                 t or NO_TOL))
    out.update(prompt_tokens=S, prefix_tokens=P, decode_steps=K,
               tolerance_vs_forward=tol or "measured only",
               tolerance_ring_vs_paged=rp_tol)
    return out


def upcast_f32(bundle, params, n_layers=None):
    """The bundle and weights upcast to f32 (TF32 is off); only the first
    ``n_layers`` layers when given."""
    from repro_torch.core.lora import flatten, unflatten
    from repro_torch.models.model import build_model, with_overrides
    cut = {} if n_layers is None else {"n_layers": n_layers}
    b32 = build_model(with_overrides(bundle.cfg, dtype="float32", **cut))
    p32 = unflatten({
        k: (v[:n_layers] if n_layers and k.startswith("layers/") else v)
        .float() for k, v in flatten(params).items()})
    return b32, p32


def consistency(bundle, params, toks, extra, f32_layers=None):
    """``ring_paged_consistency`` on the weights upcast to f32 (against
    the forward at ``E2E_TOL``, ring against paged at
    ``RING_PAGED_TOL_F32``; the first ``f32_layers`` layers only where
    the model would not fit twice in f32), then on the served bf16
    weights (the forward measured only, ring against paged at
    ``E2E_TOL``).  The f32 runs launch on the FMA routes, counted in no
    path."""
    b32, p32 = upcast_f32(bundle, params, f32_layers)
    f32 = ring_paged_consistency(
        b32, p32, toks, {k: v.float() for k, v in extra.items()}, E2E_TOL,
        RING_PAGED_TOL_F32)
    del p32
    if f32_layers:
        f32["layers"] = f32_layers
    release()
    bf16 = ring_paged_consistency(bundle, params, toks, extra, None,
                                  E2E_TOL)
    return {"f32": f32, "bf16": bf16}


def ring_row(cfg, B, S_c, gen):
    """Row A on a ring at ``cfg``'s decode shape: B rows, a full ring of
    S_c slots a layer (the ring run's fullest step), each layer's (B, S_c,
    K, D) ring read as B pages of S_c entries; against the same keys read
    as pages of 16 (S_c / 16 a row: the same capacity, so the split rule
    picks the same cluster), their replays taken in turn; the bound from
    the bytes of the keys kept."""
    import torch
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_plain, paged_attention_splits)
    from repro_torch.models.layers import BIG_WINDOW
    H, K, D, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    if S_c % 16:
        raise AssertionError(f"ring capacity {S_c} is no multiple of 16")
    M = S_c // 16
    dt = cfg.torch_dtype
    kv = torch.randn((L, 2, B, S_c, K, D), generator=gen,
                     device="cuda").to(dt)
    qs = torch.randn((L, B, 1, H, D), generator=gen, device="cuda").to(dt)
    tables = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    bt = torch.arange(B * M, dtype=torch.int32, device="cuda").reshape(B, M)
    lens = torch.full((B,), S_c, dtype=torch.int32, device="cuda")

    def ring(i, fn=paged_attention_cuda):
        return fn(qs[i % L], kv[i % L, 0], kv[i % L, 1], tables, lens,
                  BIG_WINDOW)

    def pages(i):
        return paged_attention_cuda(
            qs[i % L], kv[i % L, 0].view(B * M, 16, K, D),
            kv[i % L, 1].view(B * M, 16, K, D), bt, lens, BIG_WINDOW)

    err = 0.0
    for i in range(L):
        got = ring(i)
        err = max(err, check_close(f"ring layer {i}", got,
                                   ring(i, paged_attention_plain), BF16_TOL),
                  check_close(f"ring vs pages layer {i}", got, pages(i),
                              BF16_TOL))
    t = graphs_ms({"ring": ring, "pages": pages,
                   "plain": lambda i: ring(i, paged_attention_plain)},
                  n_calls=L, reps=7)
    esz = kv.element_size()
    bytes_ = 2 * B * S_c * K * D * esz + 2 * B * H * D * esz + 8 * B
    bound, by = _bound(bytes_, 4 * B * S_c * H * D)
    return {"max_abs_err": err, "ms": t["ring"],
            "ms_pages_same_capacity": t["pages"], "plain_ms": t["plain"],
            "bound_ms": bound, "bound_by": by,
            "splits": paged_attention_splits(B, K, H // K, 1, S_c),
            "shape": {"rows": B, "ring_slots": S_c, "H": H, "K": K, "D": D,
                      "dtype": str(dt), "pages_same_capacity": [M, 16]}}


def flash_row(cfg, B, S, gen, causal=True):
    """Row B at a prefill of ``cfg``, B rows of S: causal within
    ``cfg.sliding_window`` (gemma3-1b's local layers: 4 / 1 heads of 256,
    window 512) or, with ``causal=False``, unmasked (whisper-medium's
    encoder: 16 heads of 64 over 1,536 frames): the kernel, its FMA route,
    the plain version and SDPA (the window as a mask), replayed in turn;
    the bound from the pairs the mask keeps."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain,
                                                     flash_attention_route)
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = cfg.sliding_window if causal else 0
    dt = cfg.torch_dtype
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    route = flash_attention_route(q, k, v)
    if route != "mma":
        raise AssertionError(f"flash row {cfg.name}: route {route}")
    err = check_close(f"flash row {cfg.name}",
                      flash_attention_cuda(q, k, v, causal, w),
                      flash_attention_plain(q, k, v, causal, w), BF16_TOL)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pos = torch.arange(S, device="cuda")
    mask = ((pos[None, :] <= pos[:, None])
            & (pos[:, None] - pos[None, :] < (w or S))) if causal else None
    t = graphs_ms({
        "kernel": lambda i: flash_attention_cuda(q, k, v, causal, w),
        "fma": lambda i: flash_attention_cuda(q, k, v, causal, w,
                                              route="fma"),
        "plain": lambda i: flash_attention_plain(q, k, v, causal, w),
        "sdpa": lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)})
    pairs = sum(min(i + 1, w or S) for i in range(S)) if causal else S * S
    bound, by = _bound((2 * B * S * H * D + 2 * B * S * K * D)
                       * q.element_size(), 4 * D * B * H * pairs)
    return {"ms": t["kernel"], "ms_fma_route": t["fma"],
            "plain_ms": t["plain"], "library_ms": t["sdpa"],
            "library_call": "scaled_dot_product_attention("
                            + ("attn_mask=the window, " if causal else "")
                            + "enable_gqa=True) on (B, H, S, D) copies",
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "kernel_route": route,
            "shape": {"B": B, "S": S, "H": H, "K": K, "D": D,
                      "causal": causal, "window": w, "dtype": str(dt)}}


def no_drop(cfg):
    """``cfg`` with an expert capacity that holds every token of a call
    (capacity_factor = n_experts / top_k, so C = T): the consistency
    checks compare paths whose calls hold different numbers of tokens (a
    prefill, a decode step, a forward), which the config's own capacity
    would make drop different assignments (ROADMAP, reference fault
    3.9)."""
    from repro_torch.models.model import with_overrides
    return with_overrides(cfg, capacity_factor=cfg.n_experts / cfg.top_k)


def serve_both(cfg, rows, S, max_new, extra=None, f32_layers=None,
               at_fullest=None):
    """``cfg`` at full width (bf16, random weights from a seed):
    ``generate`` with merge=True on the unmerged weights (max_new 4), then
    the counted ``generate_run`` on the merged weights (its first tokens
    must equal those), the same prompts through ``ServingEngine``, the
    two's greedy tokens compared, then ``consistency`` on one row (a moe
    model's on ``no_drop(cfg)``).  ``extra(rows, gen)``: the batch extras
    (the vlm family's frontend features, the encdec family's frames).
    Returns (metrics, the launches of the counted runs,
    ``at_fullest(engine, snap)`` or None)."""
    import torch
    from repro_torch.core.lora import flatten, is_lora_leaf, merge_lora
    from repro_torch.launch.serve import _prefix_len, generate
    from repro_torch.launch.serve_engine import EngineConfig
    from repro_torch.models.model import build_model
    from repro_torch.models.paged import pages_for
    from repro_torch.models.transformer import window_array
    tag = cfg.name
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = build_model(cfg)
    params = served_params(bundle)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(11)
    prompts = torch.randint(0, cfg.vocab_size, (rows, S + CONSISTENCY_K),
                            generator=gen, device="cuda")
    batch_extra = extra(rows, gen) if extra else {}
    by_merge = generate(bundle, params, prompts[:, :S], max_new=4,
                        batch_extra=batch_extra)
    with torch.no_grad():
        merged = merge_lora(params, cfg)
    del params
    if any(is_lora_leaf(p) for p in flatten(merged)):
        raise AssertionError(f"{tag}: merged params still carry adapters")
    toks, gen_metrics, gen_launches = generate_run(
        bundle, merged, prompts[:, :S], batch_extra, max_new, tag)
    if not torch.equal(by_merge, toks[:, :4]):
        raise AssertionError(f"{tag}: generate(merge=True) tokens differ "
                             "from the merged weights'")
    P = _prefix_len(cfg, batch_extra)
    M = pages_for(P + S + max_new, 16)
    econf = EngineConfig(n_slots=rows, page_size=16, n_pages=rows * M + 1,
                         max_pages_per_seq=M, max_out=max_new, buckets=(S,))
    extra_rows = [{k: v[i] for k, v in batch_extra.items()}
                  for i in range(rows)]
    etoks, eng_metrics, eng_launches, engine, snap = engine_run(
        bundle, merged, prompts[:, :S], extra_rows, max_new, econf, tag)
    same = etoks == toks.cpu().numpy()
    row = at_fullest(engine, snap) if at_fullest else None
    del engine
    release()
    metrics = {
        "model": cfg.name, "family": cfg.family, "dtype": cfg.dtype,
        "params": cfg.n_params(), "prefix_tokens": P,
        "decode_weight_bytes": decode_weight_bytes(bundle, merged),
        "init_s": init_s, "generate": gen_metrics, "engine": eng_metrics,
        "greedy_tokens_equal_share": float(same.mean()),
        "greedy_first_token_equal_share": float(same[:, 0].mean()),
        "windows": [] if cfg.family == "ssm"
        else sorted(set(window_array(cfg))),
        "consistency": consistency(
            build_model(no_drop(cfg)) if cfg.is_moe else bundle, merged,
            prompts[:1], {k: v[:1] for k, v in batch_extra.items()},
            f32_layers),
        "consistency_capacity_factor": (no_drop(cfg) if cfg.is_moe
                                        else cfg).capacity_factor,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
    }
    launches = {n: gen_launches[n] + eng_launches[n] for n in gen_launches}
    return metrics, launches, row


RING_CASES = (      # (config module, rows, prompt tokens, tokens generated)
    ("mlecs_paper", 8, 256, 32),     # a ring of 288 slots: 18 pages of 16
    ("mamba2_2p7b", 8, 300, 32),
    ("hymba_1p5b", 4, 1100, 32),     # past the 1024 window
)


def phase_ring_serving():
    """``generate`` on the ring cache at full width and published depth
    (mamba2's: :func:`mamba2_config`): ``mlecs-slm-720m``,
    ``mamba2-2.7b`` and ``hymba-1.5b`` (prompts past
    its window), each beside ``ServingEngine`` on the same prompts
    (``serve_both``); then row A on the SLM's ring against pages of the
    same capacity.  Returns (metrics, launches, the ring row)."""
    import importlib
    import torch
    out, total = {}, None
    for mod, rows, S, new in RING_CASES:
        m = importlib.import_module(f"repro_torch.configs.{mod}")
        cfg = getattr(m, "SLM", None) or m.CONFIG
        if mod == "mamba2_2p7b":
            cfg = mamba2_config()
        out[cfg.name], launches, _ = serve_both(cfg, rows, S, new)
        total = launches if total is None else \
            {n: total[n] + launches[n] for n in total}
        release()
    from repro_torch.configs.mlecs_paper import SLM
    rows, S, new = RING_CASES[0][1:]
    row = ring_row(SLM, rows, S + new,
                   torch.Generator(device="cuda").manual_seed(12))
    release()
    return out, total, row


def stub_frontend(cfg):
    """The stubbed frontend features, (rows, T, F) in the model dtype from
    the seeded generator: the vlm family's vision patches (256 of 1024 for
    internvl2-1b), the encdec family's audio frames (1,536 of 1024 for
    whisper-medium)."""
    def make(rows, gen):
        import torch
        return {"frontend_embeds": (torch.randn(
            (rows, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
            device="cuda") * 0.5).to(cfg.torch_dtype)}
    return make


REGISTRY_CASES = (  # (config module, rows, prompt tokens, tokens generated)
    ("gemma_2b", 4, 590, 24),       # 8 / 1 heads of 256: A on the FMA walk
    ("gemma3_1b", 4, 590, 24),      # the 512 window bites in 5 of 6 layers
    ("internvl2_1b", 4, 590, 24),   # behind 256 frontend tokens of 1024
    ("granite_20b", 4, 590, 24),    # 40.6 GB of bf16 weights
)
GRANITE_F32_LAYERS = 13            # a quarter of its 52 layers: 21 GB in f32


def phase_registry_serving():
    """gemma-2b, gemma3-1b, internvl2-1b and granite-20b at full width and
    published depth, each through ``generate`` and ``ServingEngine``
    (``serve_both``), each after the memory of what ran before is
    released; granite's decode step beside the bound of reading its
    weights once.  Returns (metrics, launches, row A at gemma-2b's and
    granite's engine's fullest decode step, row B at gemma3-1b's local
    layers)."""
    import importlib
    import torch
    from repro_torch.models.transformer import window_array
    gen = torch.Generator(device="cuda").manual_seed(13)
    out, total, rows_a = {}, None, {}
    for mod, rows, S, new in REGISTRY_CASES:
        cfg = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
        release()
        before = torch.cuda.memory_allocated()
        grab = None
        if mod in ("gemma_2b", "granite_20b"):
            def grab(engine, snap):
                return paged_row(engine, snap, window_array(engine.cfg), gen)
        metrics, launches, row = serve_both(
            cfg, rows, S, new,
            extra=stub_frontend(cfg) if cfg.frontend else None,
            f32_layers=GRANITE_F32_LAYERS if mod == "granite_20b" else None,
            at_fullest=grab)
        metrics["memory_allocated_before_gb"] = before / 2**30
        if row is not None:
            rows_a[cfg.name] = row
        if mod == "granite_20b":
            bound = metrics["decode_weight_bytes"] / HBM_BYTES_PER_S * 1e3
            metrics["decode_step_bound_ms"] = bound
            metrics["decode_step_bound_is"] = (
                "the bytes of the weights a step reads, once, over 3.35 TB/s")
            for run in ("generate", "engine"):
                if metrics[run]["decode_step_ms_mean"] < bound:
                    raise AssertionError(f"granite {run}: a decode step "
                                         f"under its {bound:.2f} ms bound")
        out[cfg.name] = metrics
        total = launches if total is None else \
            {n: total[n] + launches[n] for n in total}
    release()
    from repro_torch.configs.gemma3_1b import CONFIG as GEMMA3
    row_b = flash_row(GEMMA3, 4, 590, gen)
    release()
    return out, total, rows_a, row_b


def cross_row(cfg, B, gen):
    """The decode cross-attention of ``cfg`` (whisper-medium: 16 heads of
    64 over 1,536 frames), one token a row against each decoder layer's
    own cross cache (L x 25 MB at B 4, past the 50 MB L2): A with the
    cache read as one page a row (``layers.cross_attention_decode``, the
    path's choice) against B at Sq = 1 with ``causal=False``, the plain
    version and SDPA, their replays taken in turn; the bound from the
    bytes of the keys read."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_route)
    from repro_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_attention_plain, paged_attention_route,
        paged_attention_splits)
    H, K, D, L, T = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                     cfg.n_layers, cfg.frontend_tokens)
    dt = cfg.torch_dtype
    kv = torch.randn((L, 2, B, T, K, D), generator=gen,
                     device="cuda").to(dt)
    qs = torch.randn((L, B, 1, H, D), generator=gen, device="cuda").to(dt)
    tables = torch.arange(B, dtype=torch.int32, device="cuda")[:, None]
    lens = torch.full((B,), T, dtype=torch.int32, device="cuda")
    qt = qs.transpose(2, 3).contiguous()                    # (L, B, H, 1, D)
    kvt = kv.transpose(3, 4).contiguous()                   # (L, 2, B, K, T, D)

    def a(i, fn=paged_attention_cuda):
        return fn(qs[i % L], kv[i % L, 0], kv[i % L, 1], tables, lens, 0)

    def b(i):
        return flash_attention_cuda(qs[i % L], kv[i % L, 0], kv[i % L, 1],
                                    causal=False)

    err = 0.0
    for i in range(L):
        want = a(i, paged_attention_plain)
        err = max(err, check_close(f"cross A layer {i}", a(i), want,
                                   BF16_TOL),
                  check_close(f"cross B layer {i}", b(i), want, BF16_TOL))
    t = graphs_ms({
        "a": a, "b": b, "plain": lambda i: a(i, paged_attention_plain),
        "sdpa": lambda i: F.scaled_dot_product_attention(
            qt[i % L], kvt[i % L, 0], kvt[i % L, 1], enable_gqa=True)},
        n_calls=L, reps=7)
    esz = kv.element_size()
    bound, by = _bound(2 * B * T * K * D * esz + 2 * B * H * D * esz + 8 * B,
                       4 * B * T * H * D)
    return {"max_abs_err": err, "ms": t["a"], "ms_b_sq1": t["b"],
            "plain_ms": t["plain"], "library_ms": t["sdpa"],
            "library_call": "scaled_dot_product_attention(enable_gqa=True) "
                            "on (B, H, 1, D) / (B, K, T, D) copies",
            "faster": "A" if t["a"] <= t["b"] else "B",
            "path_takes": "A (layers.cross_attention_decode)",
            "bound_ms": bound, "bound_by": by,
            "a_route": paged_attention_route(qs[0], kv[0, 0], kv[0, 1]),
            "a_splits": paged_attention_splits(B, K, H // K, 1, T),
            "b_route": flash_attention_route(qs[0], kv[0, 0], kv[0, 1]),
            "shape": {"rows": B, "frames": T, "H": H, "K": K, "D": D,
                      "layers": L, "dtype": str(dt)}}


MOE_ENCDEC_CASES = (  # (config module, layers kept, rows, prompt, generated)
    ("phi3p5_moe_42b_a6p6b", 16, 4, 590, 24),   # 16 of 32: 21.1 B params
    ("qwen3_moe_235b_a22b", 8, 4, 590, 24),     # 8 of 94: 21.2 B params
    ("whisper_medium", None, 4, 128, 24),       # 24 + 24 layers, 1536 frames
)
# f32 consistency on the first layers only: a layer in f32 is 5.2 GB
# (phi3.5-moe) and 10 GB (qwen3-moe) beside ~42 GB of bf16 weights
MOE_F32_LAYERS = {"phi3p5_moe_42b_a6p6b": 4, "qwen3_moe_235b_a22b": 2}


def phase_moe_encdec_serving():
    """phi3.5-moe (16 of 32 layers) and qwen3-moe (8 of 94) at full width,
    and whisper-medium at full width and depth behind 1,536 stub frames,
    each through ``generate`` and ``ServingEngine`` (``serve_both``) after
    the memory of what ran before is released; the moe models' decode
    steps beside the bound of reading their weights once (every expert:
    the E x C form), their consistency checks on ``no_drop``.  Returns
    (metrics, launches, row A at qwen3-moe's fullest engine step, whisper's
    cross-attention A-against-B row, row B at whisper's encoder)."""
    import importlib
    import torch
    from repro_torch.models.model import with_overrides
    from repro_torch.models.transformer import window_array
    gen = torch.Generator(device="cuda").manual_seed(14)
    out, total, row_a = {}, None, None
    for mod, layers, rows, S, new in MOE_ENCDEC_CASES:
        full = importlib.import_module(f"repro_torch.configs.{mod}").CONFIG
        cfg = with_overrides(full, n_layers=layers) if layers else full
        release()
        before = torch.cuda.memory_allocated()
        grab = None
        if mod == "qwen3_moe_235b_a22b":
            def grab(engine, snap):
                return paged_row(engine, snap, window_array(engine.cfg), gen)
        metrics, launches, row = serve_both(
            cfg, rows, S, new,
            extra=stub_frontend(cfg) if cfg.frontend else None,
            f32_layers=MOE_F32_LAYERS.get(mod), at_fullest=grab)
        metrics.update(memory_allocated_before_gb=before / 2**30,
                       layers=cfg.n_layers, published_layers=full.n_layers,
                       published_params=full.n_params())
        if row is not None:
            row_a = row
        if cfg.is_moe:
            bound = metrics["decode_weight_bytes"] / HBM_BYTES_PER_S * 1e3
            metrics["decode_step_bound_ms"] = bound
            metrics["decode_step_bound_is"] = (
                "the bytes of the weights a step reads (every expert), "
                "once, over 3.35 TB/s")
            for run in ("generate", "engine"):
                if metrics[run]["decode_step_ms_mean"] < bound:
                    raise AssertionError(f"{cfg.name} {run}: a decode step "
                                         f"under its {bound:.2f} ms bound")
        out[cfg.name] = metrics
        total = launches if total is None else \
            {n: total[n] + launches[n] for n in total}
    release()
    from repro_torch.configs.whisper_medium import CONFIG as WHISPER
    cross = cross_row(WHISPER, 4, gen)
    release()
    enc = flash_row(WHISPER, 4, WHISPER.frontend_tokens, gen, causal=False)
    release()
    return out, total, row_a, cross, enc


# ---------------------------------------------------------------------------
# phase 18: the trainer (launch/train.py) at full width

TRAIN_LR = 1e-3             # run_training's default
SLM_TRAIN = dict(rows=8, seq=256, lora_steps=8, full_steps=3)
GEMMA_TRAIN = dict(rows=4, seq=1024, steps=2)
# AdamW moves every element of a trainable (d_in, d_out) matrix by ~lr
# against its gradient's sign, so a pre-activation moves by ~lr ||x||_1:
# ~3 at lr 1e-3 for phi3.5's 4096-wide soft-prompt generator, where the
# CE of the one batch trained on rose (10.68 -> 10.76 over 4 steps on an
# H100 80GB HBM3 at 700 W).  The wide models train at 1e-4.
PHI_TRAIN = dict(layers=8, rows=4, seq=512, steps=4, lr=1e-4)  # 8 of 32
WHISPER_TRAIN = dict(rows=4, seq=128, steps=4, lr=1e-4)
# chunked against full CE on gemma-2b (bf16, the same params and batches):
# losses to 1e-3 relative; the LoRA / connector gradients row by row within
# 2e-2 of the row's largest |value| (floored at STEP_GRAD_FLOOR of the
# leaf's, as every bf16 gradient row of this script: a row of rounding
# noise has no size of its own)
CHUNKED_LOSS_RTOL = 1e-3
CHUNKED_GRAD_TOL = 2e-2
# the stacked steps against the loop steps at f32 (TF32 off), SGD at lr 1
# (an updated leaf is p - g, so the check holds each client's gradient):
# every updated personal leaf row by row within 1e-4 of the row's largest
# |value|, losses to 1e-5 relative
STACKED_TRAIN = dict(G=3, rows=2, seq=256)
STACKED_LR = 1.0
STACKED_LEAF_TOL = 1e-4
STACKED_LOSS_RTOL = 1e-5


def trainer_corpus(seq_len, vocab):
    """``round_corpus``'s corpus at ``seq_len`` tokens a row over a vocab
    the model holds."""
    from repro_torch.data.synthetic import synthetic_multimodal_corpus
    return synthetic_multimodal_corpus(
        0, 256, seq_len, min(vocab, CORPUS["vocab_size"]),
        n_classes=CORPUS["n_classes"], n_modalities=CORPUS["n_modalities"],
        modality_dim=CORPUS["modality_dim"],
        template_len=CORPUS["template_len"])


def trainer_batches(mc, rows, seq, n, seed, gen):
    """``n`` batches of the trainer's stream (``pipeline.batches`` of
    :func:`trainer_corpus`) on the card; the frontend's stub features
    (vlm patches, encdec frames) from ``gen`` where ``mc`` has one."""
    from repro_torch.data.pipeline import batches
    it = batches(trainer_corpus(seq, mc.vocab_size), rows, seed=seed,
                 device="cuda")
    out = [next(it) for _ in range(n)]
    if mc.frontend:
        for b in out:
            b.update(stub_frontend(mc)(rows, gen))
    return out


def trainer_launches(mc, steps, stacked=False):
    """The exact launches of ``steps`` trained passes of ``mc`` through the
    trainer's loss (each pass: forward and backward, every adapted
    projection's C on ``projection_routes``' route; one D forward and
    backward per CCL loss), with C's grouped form for a stacked pass, and
    the FMA launches among them: ({kernel: n}, {kernel: FMA n}).

    A decoder-only pass behind the soft prompt launches what
    ``pass_launches`` counts.  An encdec pass (no prefix: the frames feed
    the encoder) launches, per encoder layer (no remat), B and each
    adapted projection's C once forward, B' once and C's dx once (the
    projector's output needs a gradient); per decoder layer, B twice
    (self- and cross-attention) forward and again under remat, B' twice,
    the self-attention's adapted projections' C forward (twice under
    remat) and dx but at layer 0, whose input is the frozen embedding.
    At f32 every C, B and B' launch takes the FMA route."""
    import torch
    routes = projection_routes(mc)
    c = {"wgmma": 0, "fma": 0}
    if mc.family == "encdec":
        Le, L = mc.n_enc_layers, mc.n_layers
        rem = 2 if mc.remat else 1
        for t, (fwd, dx) in routes.items():
            c[fwd] += Le + L * rem
            c[dx] += Le + L - (1 if t in ENTRY_PROJECTIONS else 0)
        p = {"c": c, "b": Le + 2 * L * rem, "b_bwd": Le + 2 * L}
    else:
        p = pass_launches(mc, True)
        c = p["c"]
    cname = "lora_matmul_grouped" if stacked else "lora_matmul"
    want = {cname: steps * (c["wgmma"] + c["fma"]),
            "flash_attention": steps * p["b"],
            "flash_attention_backward": steps * p["b_bwd"],
            "gram_log_volume": steps, "gram_log_volume_backward": steps}
    fma = {cname: steps * c["fma"]}
    if mc.torch_dtype == torch.float32:
        fma.update({k: want[k] for k in (cname, "flash_attention",
                                         "flash_attention_backward")})
    return want, fma


def summed(*counts):
    """The sum of launch dicts, key by key."""
    out = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def active_routes(tag, fma):
    """``check_tensor_core_routes``: the routes that took launches."""
    return {n: r for n, r in check_tensor_core_routes(tag, fma).items()
            if any(r.values())}


def exact(tag, got, want):
    full = dict.fromkeys(got, 0)
    full.update(want)
    if got != full:
        raise AssertionError(f"{tag} launches {got} != {full}")
    return got


def eval_ce(bundle, params, batch):
    """The trainer loss's CE on ``batch`` at ``params`` (no gradient)."""
    import torch
    from repro_torch.launch.train import mlecs_train_loss
    with torch.no_grad():
        return float(mlecs_train_loss(params, bundle, batch)[1]["ce"])


def moved(before, after):
    """The leaves of ``after`` that differ from ``before``'s, and those
    that do not: ([moved], [unmoved])."""
    import torch
    from repro_torch.core.lora import flatten
    b, a = flatten(before), flatten(after)
    same = [k for k in a if torch.equal(a[k], b[k])]
    return [k for k in a if k not in same], same


def timed_steps(step, params, opt_state, batches):
    """Run ``step`` over ``batches``: (params, opt_state, [metrics], [ms a
    step, host clock to a synchronize])."""
    import torch
    out, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        out.append({k: float(v) for k, v in m.items()})
    return params, opt_state, out, ms


def train_slm(total):
    """The paper's SLM at full width and depth (bf16, remat, connector
    latent 1280 as ``round_models``): ``run_training`` over ``batches`` of
    the trainer corpus, 8 LoRA-only AdamW steps, then 3 of a full
    fine-tune, each from the seed's params (drawn again here to compare)."""
    import contextlib
    import io
    import torch
    from repro_torch.core.ccl import init_unified
    from repro_torch.core.lora import default_trainable, flatten
    from repro_torch.data.pipeline import batches
    from repro_torch.launch.train import run_training
    from repro_torch.models.model import build_model
    slm, _ = round_models()
    bundle = build_model(slm)
    rows, seq = SLM_TRAIN["rows"], SLM_TRAIN["seq"]
    corpus = trainer_corpus(seq, slm.vocab_size)
    first = next(batches(corpus, rows, seed=0, device="cuda"))
    out = {}
    for mode, steps, ff in (("lora", SLM_TRAIN["lora_steps"], False),
                            ("full_finetune", SLM_TRAIN["full_steps"], True)):
        release()
        # run_training's params: the unified model from its seed
        init = init_unified(torch.Generator(device="cuda").manual_seed(0),
                            bundle)
        ce0 = eval_ce(bundle, init, first)
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        log = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            params, hist = run_training(
                bundle, batches(corpus, rows, seed=0, device="cuda"), steps,
                lr=TRAIN_LR, log_every=1, seed=0, full_finetune=ff,
                device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        want, fma = trainer_launches(slm, steps)
        got = exact(f"slm {mode}", read_counters(), want)
        routes = active_routes(f"slm {mode}", fma)
        total = summed(total, got)
        lines = log.getvalue().splitlines()
        if len(lines) != steps or not lines[-1].startswith(
                f"step {steps - 1:5d}  aux="):
            raise AssertionError(f"slm {mode}: step lines {lines[-2:]}")
        ce1 = eval_ce(bundle, params, first)
        if not (math.isfinite(ce1) and ce1 < ce0):
            raise AssertionError(f"slm {mode}: CE on the first batch {ce0} "
                                 f"-> {ce1}")
        mv, same = moved(init, params)
        # a leaf whose every element is over 2^9 lr (spg_scale's ones) does
        # not move in bf16: an AdamW step of ~lr rounds back to it
        fine = {k for k, v in flatten(init).items()
                if float(v.float().abs().min()) * 2.0 ** -9 > TRAIN_LR}
        if ff and set(same) - fine:
            raise AssertionError(f"slm full fine-tune: unmoved "
                                 f"{sorted(set(same) - fine)[:8]}")
        if not ff:
            bad = [k for k in mv if not default_trainable(k)]
            if bad:
                raise AssertionError(f"slm lora: frozen leaves moved {bad}")
        out[mode] = {"steps": steps, "first_batch_ce_before": ce0,
                     "first_batch_ce_after": ce1, "history": hist,
                     "last_line": lines[-1], "wall_s": wall,
                     "ms_per_step": wall * 1e3 / steps,
                     "peak_mem_bytes": peak, "leaves_moved": len(mv),
                     "leaves_unmoved": same if ff else len(same),
                     "launches": got,
                     "launches_by_route": routes}
        del init, params
    out["config"] = {"layers": slm.n_layers, "rows": rows, "seq": seq,
                     "lr": TRAIN_LR, "connector_dim": slm.connector_dim}
    return out, total


def train_grads(bundle, params, batch):
    """d mlecs_train_loss / d (LoRA + connector) at ``params``."""
    from repro_torch.core.ccl import grads_of
    from repro_torch.core.lora import combine, partition
    from repro_torch.launch.train import mlecs_train_loss
    train = {k: v.detach().requires_grad_(True)
             for k, v in partition(params).items()}
    loss, _ = mlecs_train_loss(combine(params, train), bundle, batch)
    return float(loss.detach()), grads_of(loss, train)


def train_gemma(total, gen):
    """gemma-2b at full width and depth (bf16, remat, vocab 256,000, tied):
    from one set of params and two batches of 4 x 1,024 tokens (+ 8 soft
    tokens), 2 AdamW steps on the full CE, then 2 on the chunked CE
    (``loss_chunk`` 512), each path's peak memory; the losses and, on the
    first batch, the LoRA / connector gradients of the two paths against
    each other."""
    import torch
    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.core.lora import partition
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models.model import build_model, with_overrides
    from repro_torch.optim.adamw import adamw
    release()
    opt = adamw(TRAIN_LR)
    paths = {impl: build_model(with_overrides(CONFIG, loss_impl=impl))
             for impl in ("full", "chunked")}
    params, _ = init_train_state(paths["full"], opt, gen)
    bs = trainer_batches(CONFIG, GEMMA_TRAIN["rows"], GEMMA_TRAIN["seq"],
                         GEMMA_TRAIN["steps"], 1, gen)
    out, losses, grads = {}, {}, {}
    for impl, bundle in paths.items():
        release()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        p, st, ms_hist, ms = timed_steps(
            make_train_step(bundle, opt), params,
            opt.init(partition(params)), bs)
        peak = torch.cuda.max_memory_allocated()
        want, fma = trainer_launches(CONFIG, GEMMA_TRAIN["steps"])
        got = exact(f"gemma {impl}", read_counters(), want)
        routes = active_routes(f"gemma {impl}", fma)
        total = summed(total, got)
        losses[impl] = [m["loss"] for m in ms_hist]
        if not all(math.isfinite(v) for v in losses[impl]):
            raise AssertionError(f"gemma {impl}: losses {losses[impl]}")
        del p, st
        release()
        grads[impl] = train_grads(bundle, params, bs[0])
        out[impl] = {"metrics": ms_hist, "ms_per_step": ms,
                     "peak_mem_bytes": peak,
                     "peak_above_start_bytes": peak - base,
                     "launches": got, "launches_by_route": routes}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["chunked"],
                                                losses["full"])]
    if max(rel) > CHUNKED_LOSS_RTOL:
        raise AssertionError(f"gemma chunked vs full losses {losses}")
    (lf, gf), (lc, gc) = grads["full"], grads["chunked"]
    errs = {k: rel_check(f"gemma chunked d{k}", gc[k].reshape(
        -1, gc[k].shape[-1]), gf[k].reshape(-1, gf[k].shape[-1]),
        dict(atol=CHUNKED_GRAD_TOL, rtol=0.0),
        floor=STEP_GRAD_FLOOR)["max_rel_err"] for k in gf}
    out.update(
        loss_rel_err=rel, grad_row_rel_err=max(errs.values()),
        grad_row_rel_err_by_leaf=errs,
        peak_gap_bytes=out["full"]["peak_mem_bytes"]
        - out["chunked"]["peak_mem_bytes"],
        tolerance={"loss_rtol": CHUNKED_LOSS_RTOL,
                   "grad_rows": CHUNKED_GRAD_TOL,
                   "grad_floor": STEP_GRAD_FLOOR},
        config={"rows": GEMMA_TRAIN["rows"], "seq": GEMMA_TRAIN["seq"],
                "soft_tokens": CONFIG.n_soft_tokens,
                "loss_chunk": CONFIG.loss_chunk,
                "vocab": CONFIG.vocab_size})
    del params
    return out, total


def train_model(tag, mc, spec, total, gen, checks):
    """``spec['steps']`` AdamW steps of ``make_train_step`` on ``mc``
    (bf16) from ``init_train_state``, every step on one batch of the
    trainer's stream, whose CE must fall (on a stream of new batches four
    steps of a random phi3.5-moe raised the first batch's CE on an H100,
    10.83 to 11.19: the steps the other batches take outweigh what one
    step learned); ``checks(init, trained leaves, metrics)`` on the
    result."""
    import torch
    from repro_torch.core.lora import partition
    from repro_torch.launch.train import init_train_state, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw
    release()
    bundle = build_model(mc)
    opt = adamw(spec["lr"])
    params, st = init_train_state(bundle, opt, gen)
    init = {k: v.clone() for k, v in partition(params).items()}
    bs = trainer_batches(mc, spec["rows"], spec["seq"], 1, 2,
                         gen) * spec["steps"]
    ce0 = eval_ce(bundle, params, bs[0])
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    new, st, hist, ms = timed_steps(make_train_step(bundle, opt), params,
                                    st, bs)
    peak = torch.cuda.max_memory_allocated()
    want, fma = trainer_launches(mc, spec["steps"])
    got = exact(tag, read_counters(), want)
    routes = active_routes(tag, fma)
    ce1 = eval_ce(bundle, new, bs[0])
    if not (all(math.isfinite(m["loss"]) for m in hist) and ce1 < ce0):
        raise AssertionError(f"{tag}: losses {hist}, CE on the batch "
                             f"{ce0} -> {ce1}")
    extra = checks(init, partition(new), hist)
    out = {"layers": mc.n_layers, "steps": spec["steps"], "rows":
           spec["rows"], "seq": spec["seq"], "lr": spec["lr"],
           "metrics": hist,
           "batch_ce_before": ce0, "batch_ce_after": ce1,
           "ms_per_step": ms, "peak_mem_bytes": peak, "launches": got,
           "launches_by_route": routes, **extra}
    del params, new, st
    return out, summed(total, got)


def check_moe(init, new, hist):
    aux = [m["aux"] for m in hist]
    if not all(a > 0 for a in aux):
        raise AssertionError(f"moe aux {aux}")
    return {"aux": aux}


def check_whisper(init, new, hist):
    """Every encoder LoRA leaf moved (the encoder's gradient is the sum
    of every decoder layer's cross K/V), the soft-prompt leaves not (the
    family takes no soft prompt: their gradient is 0, so AdamW's update
    is exactly 0)."""
    import torch
    enc = [k for k in new if k.startswith("enc_layers/") and "_lora_" in k]
    still = [k for k in enc if torch.equal(new[k], init[k])]
    spg = [k for k in ("connector/spg_scale", "connector/spg_bias",
                       "connector/spg_w1")
           if not torch.equal(new[k], init[k])]
    if not enc or still or spg:
        raise AssertionError(f"whisper: encoder LoRA unmoved {still} of "
                             f"{enc}; soft-prompt leaves moved {spg}")
    return {"encoder_lora_leaves_moved": len(enc)}


def stacked_against_loop(tag, mc, gen, total):
    """One stacked step of G clients (``ccl.make_stacked_step``, SGD at
    lr 1) against each client's loop step (``ccl.make_local_step``) at
    f32, from one backbone and G clients' own adapters, connectors (and
    projector), batches and anchors: the per-client losses and every
    updated personal leaf, row by row; the launches of both, exact (f32:
    every C and B launch on the FMA route)."""
    import torch
    from repro_torch.core import ccl
    from repro_torch.core.lora import (combine, partition, stack_clients,
                                       stack_trees)
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import sgd
    release()
    G, rows, seq = (STACKED_TRAIN[k] for k in ("G", "rows", "seq"))
    bundle = build_model(mc)
    params = ccl.init_unified(gen, bundle)
    pers = [{k: (0.02 * torch.randn(v.shape, generator=gen, device="cuda")
                 if k.endswith("_lora_b") else v + 0.02 * torch.randn(
                     v.shape, generator=gen, device="cuda"))
             for k, v in partition(params).items()} for _ in range(G)]
    bs = [trainer_batches(mc, rows, seq, 1, 10 + g, gen)[0]
          for g in range(G)]
    masks = torch.tensor([[1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=torch.bool,
                         device="cuda")
    for g, b in enumerate(bs):
        b["modality_mask"] = masks[g].expand_as(b["modality_mask"]).clone()
        b["modality_feats"] = b["modality_feats"] * b["modality_mask"][
            ..., None]
    batch = {k: torch.stack([b[k] for b in bs]) for k in bs[0]}
    c = mc.connector_dim or mc.d_model
    anchor = torch.randn((G, rows, c), generator=gen, device="cuda")
    opt = sgd(STACKED_LR)
    zero_counters()
    new, _, m = ccl.make_stacked_step(bundle, opt)(
        combine(params, stack_clients(pers)),
        stack_trees([opt.init(p) for p in pers]), batch, anchor)
    loop_step = ccl.make_local_step(bundle, opt)
    loop, loss = [], []
    for g in range(G):
        ng, _, mg = loop_step(combine(params, pers[g]), opt.init(pers[g]),
                              bs[g], anchor[g])
        loop.append(partition(ng))
        loss.append(float(mg["loss"]))
    (ws, fs), (wl, fl) = (trainer_launches(mc, 1, stacked=True),
                          trainer_launches(mc, G))
    got = exact(tag, read_counters(), summed(ws, wl))
    routes = active_routes(tag, summed(fs, fl))
    torch.cuda.synchronize()
    rel = [abs(float(m["loss"][g]) - loss[g]) / abs(loss[g])
           for g in range(G)]
    stacked = partition(new)
    errs = {}
    for g in range(G):
        for k, w in loop[g].items():
            e = rel_check(f"{tag} client {g} {k}",
                          stacked[k][g].reshape(-1, w.shape[-1]),
                          w.reshape(-1, w.shape[-1]),
                          dict(atol=STACKED_LEAF_TOL, rtol=0.0))
            errs[k] = max(errs.get(k, 0.0), e["max_rel_err"])
    if max(rel) > STACKED_LOSS_RTOL:
        raise AssertionError(f"{tag}: stacked losses {m['loss'].tolist()} "
                             f"vs loop {loss}")
    aux = m["aux"].tolist()
    del params, new, loop, stacked
    return {"layers": mc.n_layers, "G": G, "rows": rows, "seq": seq,
            "losses_stacked": m["loss"].tolist(), "losses_loop": loss,
            "aux": aux, "loss_rel_err": rel,
            "leaf_row_rel_err": max(errs.values()),
            "leaf_row_rel_err_by_leaf": errs, "launches": got,
            "launches_by_route": routes,
            "tolerance": {"leaf_rows": STACKED_LEAF_TOL,
                          "loss_rtol": STACKED_LOSS_RTOL,
                          "optimizer": f"sgd(lr={STACKED_LR})"}}, \
        summed(total, got)


def attn_rows(B, Sq, Sk, H, K, D, causal, gen):
    """B and B' at one of the trainer's attention shapes (bf16), each
    against its plain version and SDPA (B': its forward + backward less
    its forward), replayed in turn; bounds from the pairs the mask keeps.
    Returns (forward row, backward row)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_backward_plain,
        flash_attention_backward_route, flash_attention_cuda,
        flash_attention_plain, flash_attention_route)
    dt = torch.bfloat16
    q, do = (torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, K, D), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    if flash_attention_route(q, k, v) != "mma" or \
            flash_attention_backward_route(q, k, v) != "mma":
        raise AssertionError("trainer attention rows: not on mma")
    err = check_close("trainer flash row",
                      flash_attention_cuda(q, k, v, causal, 0),
                      flash_attention_plain(q, k, v, causal, 0), BF16_TOL)
    o, lse = flash_attention_cuda(q, k, v, causal, 0, with_lse=True)
    args = (q, k, v, o, do, lse, causal, 0)
    berr = max((grad_rows("trainer flash bwd row", g, w, BF16_TOL)
                for g, w in zip(flash_attention_backward_cuda(*args),
                                flash_attention_backward_plain(*args))),
               key=lambda e: e["max_rel_err"])
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa(i):
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
    t = graphs_ms({
        "fwd": lambda i: flash_attention_cuda(q, k, v, causal, 0),
        "fwd_plain": lambda i: flash_attention_plain(q, k, v, causal, 0),
        "sdpa": sdpa,
        "bwd": lambda i: flash_attention_backward_cuda(*args),
        "bwd_plain": lambda i: flash_attention_backward_plain(*args),
        "sdpa_both": lambda i: torch.autograd.grad(sdpa(i), (qt, kt, vt),
                                                   dot)})
    pairs = sum(min(Sk - Sq + i + 1, Sk) for i in range(Sq)) if causal \
        else Sq * Sk
    es = q.element_size()
    nq, nk = B * Sq * H * D, B * Sk * K * D
    fb, fby = _bound((2 * nq + 2 * nk) * es, 4 * D * B * H * pairs)
    bb, bby = _bound((3 * nq + 2 * nk) * es + B * H * Sq * 4
                     + (nq + 2 * nk) * es, 10 * D * B * H * pairs)
    shape = {"B": B, "Sq": Sq, "Sk": Sk, "H": H, "K": K, "D": D,
             "causal": causal, "dtype": str(dt)}
    return ({"ms": t["fwd"], "plain_ms": t["fwd_plain"],
             "library_ms": t["sdpa"], "bound_ms": fb, "bound_by": fby,
             "max_abs_err": err, "kernel_route": "mma", "shape": shape},
            {"ms": t["bwd"], "plain_ms": t["bwd_plain"],
             "library_ms": t["sdpa_both"] - t["sdpa"],
             "library_fwd_bwd_ms": t["sdpa_both"],
             "library_fwd_ms": t["sdpa"], "bound_ms": bb, "bound_by": bby,
             "max_abs_err": berr["max_abs_err"],
             "max_rel_err": berr["max_rel_err"], "kernel_route": "mma",
             "shape": shape})


# the trainer's new shapes for rows B / B' (B, Sq, Sk, H, K, D, causal),
# C (M, K, N, r: gemma-2b's q projection) and D (B, k, d: the SLM
# trainer's CCL loss)
TRAINER_ATTN_SHAPES = {
    "whisper_encoder": (4, 1536, 1536, 16, 16, 64, False),
    "whisper_cross": (4, 128, 1536, 16, 16, 64, False),
    "gemma2b_train": (4, 1032, 1032, 8, 1, 256, True)}
TRAINER_C_SHAPE = (4 * 1032, 2048, 2048, 8)
TRAINER_D_SHAPE = (128, 4, 1280)


def trainer_kernel_rows(gen):
    """The trainer's new shapes for rows B, B', C and D (bf16): B and B'
    at whisper-medium's encoder (4 x 1,536 frames, no mask) and
    cross-attention (128 queries over 1,536 frames) and at gemma-2b's
    training shape (4 x 1,032, 8 / 1 heads of 256, causal); C at gemma-2b's
    q projection with a full fine-tune's dW (x^T dy, one ``torch.matmul``)
    timed beside it; D and its backward at the SLM trainer's CCL loss (8
    rows: 2 x (1 + 7) candidate sets, 128 samples of 4 x 1280)."""
    import torch
    from repro_torch.kernels.gram_volume import (
        gram_log_volume_backward_cuda, gram_log_volume_cuda,
        gram_log_volume_plain)
    from repro_torch.kernels.lora_matmul import (lora_matmul_cuda,
                                                 lora_matmul_plain,
                                                 lora_matmul_route)
    rows = {"flash_attention": {}, "flash_attention_backward": {}}
    for name, shape in TRAINER_ATTN_SHAPES.items():
        fwd, bwd = attn_rows(*shape, gen)
        rows["flash_attention"][f"trainer_{name}"] = fwd
        rows["flash_attention_backward"][f"trainer_{name}"] = bwd
        release()

    M, K, N, r = TRAINER_C_SHAPE
    dt = torch.bfloat16
    x, w, a, b = lora_inputs(gen, M, K, N, r, dt)
    dy = torch.randn((M, N), generator=gen, device="cuda").to(dt)
    if lora_matmul_route(x, w, a, b) != "wgmma":
        raise AssertionError("trainer C row: not on wgmma")
    err = check_close("trainer lora row", lora_matmul_cuda(x, w, a, b, 2.0),
                      lora_matmul_plain(x, w, a, b, 2.0), BF16_TOL)
    xt = x.t()
    t = graphs_ms({"kernel": lambda i: lora_matmul_cuda(x, w, a, b, 2.0),
                   "plain": lambda i: lora_matmul_plain(x, w, a, b, 2.0),
                   "library": lambda i: torch.matmul(x, w),
                   "dw": lambda i: torch.matmul(xt, dy)})
    es = x.element_size()
    bound, by = _bound((M * K + K * N + K * r + r * N + M * N) * es,
                       2 * M * K * N + 2 * M * K * r + 2 * M * r * N)
    dw_bound, dw_by = _bound((M * K + M * N + K * N) * es, 2 * M * K * N)
    rows["lora_matmul"] = {"trainer_gemma2b_q_forward": {
        "ms": t["kernel"], "plain_ms": t["plain"], "library_ms":
        t["library"], "bound_ms": bound, "bound_by": by, "max_abs_err": err,
        "kernel_route": "wgmma", "dw_ms": t["dw"], "dw_bound_ms": dw_bound,
        "dw_bound_by": dw_by, "dw_is": "a full fine-tune's dW = x^T dy, "
        "one bf16 torch.matmul (no kernel of the port)",
        "shape": {"M": M, "K": K, "N": N, "r": r, "dtype": str(dt)}}}

    Bg, k, d = TRAINER_D_SHAPE
    vs, mask = gram_inputs(gen, Bg, k, d, dt)
    gout = torch.randn((Bg,), generator=gen, device="cuda")
    y, dots = gram_log_volume_cuda(vs, mask, return_dots=True)
    err = check_close("trainer gram row", y, gram_log_volume_plain(vs, mask),
                      GRAM_TOL)
    vg = vs.clone().requires_grad_(True)
    want = torch.autograd.grad(gram_log_volume_plain(vg, mask), vg, gout)[0]
    berr = rel_check("trainer gram bwd row", gram_log_volume_backward_cuda(
        vs, mask, gout, dots), want, BF16_TOL, floor=GRAM_GRAD_FLOOR)
    t = graphs_ms({"fwd": lambda i: gram_log_volume_cuda(vs, mask),
                   "bwd": lambda i: gram_log_volume_backward_cuda(
                       vs, mask, gout, dots)})
    fb, fby = _bound(Bg * k * d * es + Bg * k + Bg * 4,
                     Bg * (k * (k + 1) // 2 * 2 * d + k ** 3),
                     F32_FLOP_PER_S)
    bb, bby = _bound(2 * Bg * k * d * es + Bg * k + Bg * 4,
                     Bg * (k * (k + 1) * d + 2 * k * k * d + 3 * k ** 3),
                     F32_FLOP_PER_S)
    shape = {"B": Bg, "k": k, "d": d, "dtype": str(dt)}
    rows["gram_log_volume"] = {"trainer_slm_ccl": {
        "ms": t["fwd"], "bound_ms": fb, "bound_by": fby,
        "max_abs_err": err, "shape": shape}}
    rows["gram_log_volume_backward"] = {"trainer_slm_ccl": {
        "ms": t["bwd"], "bound_ms": bb, "bound_by": bby,
        "max_abs_err": berr["max_abs_err"],
        "max_rel_err": berr["max_rel_err"], "shape": shape}}
    return rows


def phase_trainer():
    """The trainer (``repro_torch.launch.train``) on the card, each case
    after the memory of what ran before is released: the paper's SLM
    (LoRA-only, then a full fine-tune) through ``run_training``;
    gemma-2b's chunked CE against its full CE; phi3.5-moe (8 of 32
    layers) and whisper-medium (full depth, modality features: the
    connector feeds CCL) through ``make_train_step``; then the moe and
    encdec stacked steps against the loop steps at f32 (qwen3-moe 2 of 94
    layers, whisper 2 + 2).  Returns (metrics, launches, the trainer's
    kernel rows at its new shapes)."""
    import torch
    from repro_torch.configs.phi3p5_moe_42b_a6p6b import CONFIG as PHI
    from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE
    from repro_torch.configs.whisper_medium import CONFIG as WHISPER
    from repro_torch.models.model import with_overrides
    gen = torch.Generator(device="cuda").manual_seed(27)
    total = dict.fromkeys(read_counters(), 0)
    out = {}
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1
    out["slm"], total = train_slm(total)
    lap("slm")
    out["gemma-2b"], total = train_gemma(total, gen)
    lap("gemma-2b")
    phi = with_overrides(PHI, n_layers=PHI_TRAIN["layers"])
    out["phi3.5-moe"], total = train_model("phi3.5-moe", phi, PHI_TRAIN,
                                           total, gen, check_moe)
    out["phi3.5-moe"].update(published_layers=PHI.n_layers,
                             params=phi.n_params())
    lap("phi3.5-moe")
    out["whisper-medium"], total = train_model(
        "whisper-medium", WHISPER, WHISPER_TRAIN, total, gen, check_whisper)
    lap("whisper-medium")
    out["stacked"] = {}
    for name, mc in (
            ("qwen3-moe", with_overrides(QWEN3_MOE, n_layers=2,
                                         dtype="float32")),
            ("whisper-medium", with_overrides(WHISPER, n_layers=2,
                                              n_enc_layers=2,
                                              dtype="float32"))):
        out["stacked"][name], total = stacked_against_loop(
            f"stacked {name}", mc, gen, total)
    lap("stacked")
    release()
    rows = trainer_kernel_rows(gen)
    lap("kernel_rows")
    out["seconds"] = seconds
    release()
    return out, total, rows


# ---------------------------------------------------------------------------
# phase 21: the dry run (launch/dryrun.py) on fake tensors

# the keys of the reference's dry-run result and of its roofline
# (``repro.launch.dryrun``'s ``res`` and ``terms``; tests/test_torch_dryrun.py
# holds the port's result to them)
DRYRUN_KEYS = ("arch", "shape", "variant", "mesh", "chips", "kind", "mode",
               "lower_s", "compile_s", "cost_analysis", "memory_analysis",
               "collectives", "model_flops_total", "model_flops_per_chip",
               "useful_flops_frac", "roofline", "layers_per_body",
               "n_params", "n_active_params", "n_lora_params")
DRYRUN_TERMS = ("compute_s", "compute_s_analytic", "memory_s",
                "memory_s_analytic", "collective_s")
DRYRUN_TIMEOUT_S = 300      # s for the two dry runs, from their start
DRYRUN_CASE = ("gemma-2b", "decode_32k")
# the trainer phase's gemma-2b case (GEMMA_TRAIN), as an InputShape
GEMMA_DRYRUN_SHAPE = ("gemma_train", GEMMA_TRAIN["seq"], GEMMA_TRAIN["rows"],
                      "train")
SUBPROCESSES = []           # what the watchdog kills besides mp children


def dryrun_trainer_main(out_path):
    """The dry run of the trainer phase's gemma-2b step at a (1, 1) mesh
    over a fake one-rank group, on the full and on the chunked CE, in a
    process of its own (the parent holds an NCCL group); writes {impl:
    result} to ``out_path``."""
    import torch.distributed as dist
    from repro_torch.configs import InputShape
    from repro_torch.launch.dryrun import dryrun_one
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    fake_world(1)
    try:
        mesh = make_host_mesh(device_type="cpu")
        shape = InputShape(*GEMMA_DRYRUN_SHAPE)
        out = {impl: dryrun_one("gemma-2b", shape.name, shape=shape,
                                mesh=mesh, overrides=[f"loss_impl={impl}"])
               for impl in ("full", "chunked")}
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def start_dryrun():
    """Start the dry run's two processes, which use only the host's CPU
    (before the build, whose ``nvcc`` processes they share the host with,
    so that no timed phase does):
    (a) ``python -m repro_torch.launch.dryrun`` for ``DRYRUN_CASE`` at 256
    fake ranks, (b) :func:`dryrun_trainer_main`.  Returns (processes,
    their directory, the time they started)."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    arch, shape = DRYRUN_CASE
    cmds = {
        "production": [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out-dir",
                       out_dir],
        "trainer": [sys.executable, "-c",
                    "import chip_smoke as c; c.dryrun_trainer_main("
                    f"{os.path.join(out_dir, 'trainer.json')!r})"]}
    t0 = time.perf_counter()
    procs = {}
    for name, cmd in cmds.items():
        log = open(os.path.join(out_dir, f"{name}.log"), "w")
        procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT)
        log.close()
        SUBPROCESSES.append(procs[name])
    return procs, out_dir, t0


def stop_dryrun(procs):
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def join_dryrun(started):
    """Wait for both dry runs (``DRYRUN_TIMEOUT_S`` from their start) and
    read their results: (the production JSON, checked by
    :func:`check_dryrun_result`; the trainer case's {impl: result}; the
    seconds from their start).  Raises with the end of its log where one
    failed or ran over."""
    procs, out_dir, t0 = started
    try:
        for name, p in procs.items():
            try:
                rc = p.wait(timeout=max(1.0, t0 + DRYRUN_TIMEOUT_S
                                        - time.perf_counter()))
            except subprocess.TimeoutExpired:
                rc = None
            if rc != 0:
                with open(os.path.join(out_dir, f"{name}.log")) as f:
                    tail = f.read()[-3000:]
                raise AssertionError(
                    f"dry run {name}: exit code {rc} after "
                    f"{time.perf_counter() - t0:.1f} s\n{tail}")
        wall = time.perf_counter() - t0
        arch, shape = DRYRUN_CASE
        with open(os.path.join(out_dir, f"{arch}__{shape}.json")) as f:
            prod = json.load(f)
        check_dryrun_result(prod)
        with open(os.path.join(out_dir, "trainer.json")) as f:
            trainer = json.load(f)
    finally:
        stop_dryrun(procs)
        shutil.rmtree(out_dir, ignore_errors=True)
    return prod, trainer, wall


def check_dryrun_result(res):
    """The production dry run's JSON: the reference's keys, its roofline
    terms finite and non-negative, the 16 x 16 mesh of 256 ranks."""
    missing = [k for k in DRYRUN_KEYS if k not in res]
    terms = {k: res["roofline"].get(k) for k in DRYRUN_TERMS}
    bad = {k: v for k, v in terms.items()
           if not (isinstance(v, (int, float)) and math.isfinite(v)
                   and v >= 0)}
    if missing or bad or res["roofline"].get("dominant") not in terms \
            or (res["mesh"], res["chips"]) != ("16x16", 256):
        raise AssertionError(f"dry run {DRYRUN_CASE}: missing keys "
                             f"{missing}, bad terms {bad}, roofline "
                             f"{res['roofline']}, mesh {res['mesh']} "
                             f"x {res['chips']}")


def real_argument_bytes():
    """The bytes on the card of the trainer phase's gemma-2b step's
    arguments, made as that phase makes them (``init_train_state``,
    AdamW over the LoRA partition) with the dry run's batch: each storage
    once."""
    import torch
    from repro_torch.configs import InputShape
    from repro_torch.configs.gemma_2b import CONFIG
    from repro_torch.launch.specs import train_batch_structs
    from repro_torch.launch.train import init_train_state
    from repro_torch.models.model import build_model
    from repro_torch.optim.adamw import adamw
    release()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, opt_state = init_train_state(build_model(CONFIG),
                                         adamw(TRAIN_LR), gen)
    batch = train_batch_structs(CONFIG, InputShape(*GEMMA_DRYRUN_SHAPE),
                                device="cuda")
    seen = {}
    for t in torch.utils._pytree.tree_leaves((params, opt_state, batch)):
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    del params, opt_state, batch
    release()
    return sum(seen.values())


def phase_dryrun(joined, trainer):
    """The dry run (``launch/dryrun.py``), started by :func:`start_dryrun`
    before the build and read by :func:`join_dryrun` after the kernel
    checks: (a) gemma-2b decode_32k at 256 fake ranks through the command
    line, its JSON complete and its terms finite; (b) the trainer phase's
    gemma-2b step at a (1, 1) fake mesh, full and chunked CE: the argument
    bytes it counts exactly equal to those of the step's params,
    optimizer state and batch made on the card, and the peak it predicts
    (arguments + temporaries) beside the trainer phase's measured
    ``max_memory_allocated`` (a finding, not a check)."""
    prod, tr, wall = joined
    real = real_argument_bytes()
    out = {"production": {k: prod[k] for k in (
        "arch", "shape", "mesh", "chips", "lower_s", "compile_s",
        "cost_analysis", "memory_analysis", "collectives", "roofline",
        "replicated_ops", "path")},
        "wall_s": wall, "real_argument_bytes": real, "trainer": {}}
    for impl, res in tr.items():
        mem = res["memory_analysis"]
        if mem["argument_size_in_bytes"] != real:
            raise AssertionError(
                f"dry run gemma-2b {impl}: argument bytes "
                f"{mem['argument_size_in_bytes']} != the card's {real}")
        measured = trainer["gemma-2b"][impl]
        out["trainer"][impl] = {
            "memory_analysis": mem,
            "predicted_peak_bytes": mem["argument_size_in_bytes"]
            + mem["temp_size_in_bytes"],
            "measured_peak_bytes": measured["peak_mem_bytes"],
            "measured_peak_above_start_bytes":
                measured["peak_above_start_bytes"],
            "lower_s": res["lower_s"], "compile_s": res["compile_s"],
            "replicated_ops": res["replicated_ops"]}
    return out


def release():
    """Free what the last phase left: its objects hold reference cycles
    (a runner's step closures refer back to it), so collect them before
    the caching allocator can return their memory."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


WATCHDOG_S = 1170.0     # s after the start: the run stops with a report


def start_watchdog(progress):
    """A daemon thread that, :data:`WATCHDOG_S` s after the start (a run
    is to end within 1,200 s), prints the last phase that ended and every
    thread's stack to standard error, kills the processes the script
    started (``multiprocessing``'s and ``SUBPROCESSES``) and exits with
    code 3."""
    import faulthandler
    import multiprocessing
    import threading

    def fire():
        time.sleep(WATCHDOG_S)
        note = (f"chip_smoke: still running {WATCHDOG_S:.0f} s after the "
                f"start; the last phase that ended: {progress['last']}")
        print(note, file=sys.stderr, flush=True)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        for child in multiprocessing.active_children():
            child.kill()
        for child in SUBPROCESSES:
            child.kill()
        print(note + "; stopped", file=sys.stderr, flush=True)
        os._exit(3)
    threading.Thread(target=fire, name="watchdog", daemon=True).start()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import repro_torch.kernels.ops  # noqa: F401  (fails here without the port)
    from repro_torch.configs.mamba2_2p7b import CONFIG as MAMBA2
    from repro_torch.configs.mlecs_paper import LLM
    seconds, progress = {}, {"last": None}
    start = t0 = time.perf_counter()
    start_watchdog(progress)

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1
        progress["last"] = name
        print(f"chip_smoke: {name} ended at {t1 - start:.1f} s",
              file=sys.stderr, flush=True)

    phase_card()
    emit({"phase": "depth", "round_llm_layers": ROUND_LLM_LAYERS,
          "published_llm_layers": LLM.n_layers,
          "population_rounds_llm_layers": LLM.n_layers,
          "distribution_ranks_llm_layers": DIST_DEPTH["llm"],
          "mamba2_layers": MAMBA2_LAYERS,
          "published_mamba2_layers": MAMBA2.n_layers,
          "slm": "full width and depth in every round"})
    # the dry run's processes use the host's CPU beside the build and the
    # kernel checks, which time nothing
    started = start_dryrun()
    try:
        phase_build()
        lap("build")
        phase_paged_checks()
        phase_flash_checks()
        phase_flash_grad_check()
        phase_quantize_checks()
        phase_lora_checks()
        phase_gram_checks()
        phase_ssd_checks()
        phase_ssd_bwd_checks()
        lap("kernel_checks")
    except BaseException:
        stop_dryrun(started[0])
        raise
    dry = join_dryrun(started)
    lap("dryrun_join")
    engine, snap, launches, serving, reqs = phase_serving()
    emit({"serving": serving})
    emit({"profile": phase_profile(engine, reqs)})
    kernels = phase_numbers(engine, snap)
    del engine, snap, reqs
    release()
    lap("serving")
    runner, training, train_launches = phase_training()
    emit({"training": training})
    emit({"training_profile": phase_training_profile(runner)})
    del runner
    release()
    lap("training")
    channel, channel_launches = phase_channel()
    emit({"channel": channel})
    release()
    lap("channel")
    het, het_launches, cohort_launches, paged_qwen = \
        phase_heterogeneous_round()
    emit({"heterogeneous_round": het})
    release()
    lap("heterogeneous_round")
    vectorized, vec_launches = phase_vectorized_round()
    emit({"vectorized_round": vectorized})
    release()
    lap("vectorized_round")
    # the ranks start and run beside the distribution phase (its round
    # times share the card with them; its checks do not depend on time)
    ranks = start_distribution_ranks()
    try:
        distribution, dist_launches = phase_distribution()
    except BaseException:
        stop_ranks(ranks[0])
        raise
    emit({"distribution": distribution})
    release()
    lap("distribution")
    dist_ranks, dist_ranks_launches = phase_distribution_ranks(ranks)
    emit({"distribution_ranks": dist_ranks})
    release()
    lap("distribution_ranks")
    population, pop_launches = phase_population_rounds()
    emit({"population_rounds": population})
    release()
    lap("population_rounds")
    overlap, overlap_launches = phase_overlap_rounds()
    emit({"overlap_rounds": overlap})
    release()
    lap("overlap_rounds")
    ssm_serving, ssm_launches = phase_ssm_serving()
    emit({"ssm_serving": ssm_serving})
    release()
    lap("ssm_serving")
    hybrid_serving, hybrid_launches, paged_hybrid = phase_hybrid_serving()
    emit({"hybrid_serving": hybrid_serving})
    row_a = kernels[0]
    row_a["at_other_shapes"] = {"hybrid": paged_hybrid, "qwen3": paged_qwen}
    row_a["max_abs_err"] = max(row_a["max_abs_err"],
                               paged_hybrid["max_abs_err"],
                               paged_qwen["max_abs_err"])
    release()
    lap("hybrid_serving")
    ssm_training, ssm_train_launches = phase_ssm_training()
    emit({"ssm_training": ssm_training})
    release()
    lap("ssm_training")
    ring, ring_launches, ring_a = phase_ring_serving()
    emit({"ring_serving": ring})
    release()
    lap("ring_serving")
    registry, registry_launches, registry_a, registry_b = \
        phase_registry_serving()
    emit({"registry_serving": registry})
    row_a["at_other_shapes"].update(ring_slm=ring_a, **registry_a)
    kernels[1]["at_other_shapes"]["gemma3_local"] = registry_b
    release()
    lap("registry_serving")
    moe_encdec, moe_encdec_launches, qwen3_moe_a, cross_a, whisper_b = \
        phase_moe_encdec_serving()
    emit({"moe_encdec_serving": moe_encdec})
    row_a["at_other_shapes"].update(qwen3_moe=qwen3_moe_a,
                                    whisper_cross=cross_a)
    kernels[1]["at_other_shapes"]["whisper_encoder"] = whisper_b
    for row, extra in ((row_a, [ring_a, *registry_a.values(), qwen3_moe_a,
                                cross_a]),
                       (kernels[1], [registry_b, whisper_b])):
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [e["max_abs_err"] for e in extra])
    release()
    lap("moe_encdec_serving")
    trainer, trainer_counts, trainer_rows = phase_trainer()
    emit({"trainer": trainer})
    release()
    lap("trainer")
    emit({"dryrun": phase_dryrun(dry, trainer)})
    lap("dryrun")
    kernels += training_kernel_rows()
    kernels.append(grouped_lora_row())
    kernels += channel_kernel_rows()
    kernels += ssd_kernel_rows()
    kernels.append(ssd_bwd_kernel_row())
    for row in kernels:     # the trainer's shapes
        extra = trainer_rows.get(row["name"], {})
        row.setdefault("at_other_shapes", {}).update(extra)
        row["max_abs_err"] = max([row["max_abs_err"]] + [
            e["max_abs_err"] for e in extra.values()])
    lap("kernel_rows")
    emit({"phase_seconds": seconds})
    # each row's launches: the counted runs of the main paths
    paths = {"serving": launches, "training_round": train_launches,
             "channel_rounds": channel_launches,
             "heterogeneous_rounds": het_launches,
             "cohort_serving": cohort_launches,
             "vectorized_round": vec_launches,
             "distribution": dist_launches,
             "distribution_ranks": dist_ranks_launches,
             "population_rounds": pop_launches,
             "overlap_rounds": overlap_launches,
             "ssm_serving": ssm_launches, "hybrid_serving": hybrid_launches,
             "ssm_training": ssm_train_launches,
             "ring_serving": ring_launches,
             "registry_serving": registry_launches,
             "moe_encdec_serving": moe_encdec_launches,
             "trainer": trainer_counts}
    for row in kernels:
        by_path = {p: n[row["name"]] for p, n in paths.items()
                   if n[row["name"]]}
        if not by_path:
            raise AssertionError(f"{row['name']}: no launch on a main path")
        row["launches_by_path"] = by_path
        row["launches"] = sum(by_path.values())
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
