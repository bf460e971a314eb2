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
   of 1, 2 and 3 chunks, and G's output at a large |A| dt;
5. serves 48 soft-prompted requests through ``ServingEngine`` at the full
   width of ``mlecs-slm-720m`` (bf16, random weights from a seed), checks
   every budget, the free lists and both launch counters, then checks the
   paged decode logits against a full forward over the same tokens;
6. prints a ``{"serving": ...}`` line, then profiles an admission tick
   and four decode steps (``torch.profiler``; kernel time against wall
   time, traces under ``build/profile/``) into a ``{"profile": ...}`` line;
7. runs one federated round of Algorithm 1 on the loop engine through
   ``FederatedRunner`` at full width (3 devices on ``mlecs-slm-720m``,
   ``mlecs-llm-6b`` on the server, both with a 1280-wide connector latent;
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
9. serves 24 soft-prompted requests each on ``mamba2-2.7b`` (prompts of
   20-700 tokens, no pages) and ``hymba-1.5b`` (20-1200, the window
   bites) at full width, checks budgets, free lists and exact launch
   counts (G 64 per mamba2 admission; B and G 32 per hymba admission,
   A 32 per decode step), every A, B and G launch on the "mma" route (SLM
   serving too), records hymba's fullest decode step for row A, holds
   prefill -> decode at exact length against a full
   forward on the served weights upcast to f32 (B and G on "fma") and the
   bf16 run inside the bf16 forward's own distance from f32 (on "mma"),
   profiles an
   admission tick and four decode steps, and prints ``{"ssm_serving":
   ...}`` and ``{"hybrid_serving": ...}`` lines;
10. prints ``{"phase_seconds": ...}`` and a ``{"kernels": [...]}`` line
   (times from CUDA-graph replay, bounds from this run's inputs; rows
   A-G, each with its launches on the main paths; the rows of the five
   two-route kernels, A, B, B's backward, C and G, also time their FMA
   route on the same inputs, ``ms_fma_route``; the rows of D (forward and
   backward) and E time an empty kernel launched as the kernel launches,
   ``launch_floor_ms``, replayed in turn with it (D's rows also one wide
   sample, at the split the rule picks for it); row A, at the SLM's and
   (``at_other_shapes.hybrid``) hymba's fullest decode step, also times
   every forced cluster size, ``ms_by_splits`` and ``ms_splits1``).

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
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
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
# one slot of 4,096 keys, GQA with a window, D 256
PAGED_CASES = {
    "slm": dict(B=16, H=20, K=20, D=64, ps=16, M=32),
    "slm_window": dict(B=16, H=20, K=20, D=64, ps=16, M=32, window=100),
    "gqa_window": dict(B=8, H=8, K=2, D=64, ps=16, M=12, window=37),
    "gqa_d256": dict(B=4, H=16, K=4, D=256, ps=8, M=6),
    "hymba_local": dict(B=16, H=25, K=5, D=64, ps=16, M=80, window=1024),
    "hymba_global": dict(B=16, H=25, K=5, D=64, ps=16, M=80),
    "one_slot_4096": dict(B=1, H=20, K=20, D=64, ps=16, M=256,
                          lens=[4096]),
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
    others = {"round_slm": b_case(8, s_round, H, K, D),
              "round_llm": b_case(8, s_round, llm.n_heads, llm.n_kv_heads,
                                  llm.head_dim)}
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
    and log-sum-exp, and the plain forward's autograd.  The round's
    shapes (batch 8, 8 soft + 128 tokens, the SLM's 20 heads of 64 and the
    LLM's 16 of 256) and a GQA case with a window, Sq < Sk and a ragged S;
    bf16 and f32."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_backward_cuda, flash_attention_backward_plain,
        flash_attention_backward_route, flash_attention_cuda,
        flash_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = {"slm": dict(B=8, Sq=136, Sk=136, H=20, K=20, D=64, window=0),
             "llm": dict(B=8, Sq=136, Sk=136, H=16, K=16, D=256, window=0),
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
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


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
    """C against its plain version on both routes: the SLM's and the LLM's
    projections at the training M = 8 x 136, ragged M/N/K (bf16 with K, N
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
    from repro_torch.kernels.lora_matmul import lora_matmul_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.kernels.quantize import (dequantize_rows_cuda,
                                              quantize_rows_cuda)
    from repro_torch.kernels.ssd_scan import ssd_chunk_cuda
    return {"paged_attention": paged_attention_cuda,
            "flash_attention": flash_attention_cuda,
            "flash_attention_backward": flash_attention_backward_cuda,
            "lora_matmul": lora_matmul_cuda,
            "gram_log_volume": gram_log_volume_cuda,
            "gram_log_volume_backward": gram_log_volume_backward_cuda,
            "quantize_rows": quantize_rows_cuda,
            "dequantize_rows": dequantize_rows_cuda,
            "ssd_chunk": ssd_chunk_cuda}


# the kernels with a tensor-core route and an FMA route, and the route
# every bf16 launch of the main paths must take
TENSOR_CORE_ROUTES = {"paged_attention": "mma",
                      "lora_matmul": "wgmma",
                      "flash_attention": "mma",
                      "flash_attention_backward": "mma",
                      "ssd_chunk": "mma"}


def zero_counters():
    for name, fn in counters().items():
        fn.launches = 0
        if name in TENSOR_CORE_ROUTES:
            fn.launches_by_route = dict.fromkeys(fn.launches_by_route, 0)


def read_counters():
    return {n: fn.launches for n, fn in counters().items()}


def check_tensor_core_routes(tag):
    """Every launch of A, C, B (forward and backward) and G since the last
    ``zero_counters`` took the tensor-core route; returns the per-route
    counts."""
    fns = counters()
    routes = {n: dict(fns[n].launches_by_route) for n in TENSOR_CORE_ROUTES}
    for name, counts in routes.items():
        off = {r: n for r, n in counts.items()
               if r != TENSOR_CORE_ROUTES[name] and n}
        if off:
            raise AssertionError(f"{tag}: {name} launched off the "
                                 f"tensor-core route: {counts}")
    return routes


def expected_round_launches(runner, evaluate=True):
    """Launches of every kernel in one round (evaluated or not), from the
    step structure.  A trained pass of an L-layer model launches C 4L
    times forward, 4L more when ``remat`` recomputes the layers in the
    backward, and 4L for dx (3 fewer on a raw batch: layer 0's wq/wk/wv
    inputs are the frozen embedding, which needs no gradient); B L times
    forward, L more under remat, and its backward L times.  Each CCL loss
    launches D once forward and once backward.  An eval batch is one
    forward without autograd: 4L C and L B.  A quantized channel encodes
    each of the K LoRA leaves once on the uplink and once on the downlink
    (E 2K) and decodes each of them on both (F 2K), plus once more for
    the uplink's error feedback (F 3K)."""
    cfg, s, l = runner.cfg, runner.slm.cfg, runner.llm.cfg

    def trained(mc, prefix):
        rem = 2 if mc.remat else 1
        L = mc.n_layers
        return 4 * L * rem + 4 * L - (0 if prefix else 3), L * rem

    bs = cfg.batch_size
    client_batches = sum(-(-t["tokens"].shape[0] // bs)
                         for t in runner.priv_test)
    server_batches = -(-runner.public_test["tokens"].shape[0] // bs)
    device_steps = cfg.n_devices * (cfg.local_steps_ccl + cfg.local_steps_amt)
    passes = [(s, True)] * device_steps + cfg.server_steps * [
        (l, True), (l, False), (s, True), (s, False)]
    c = sum(trained(m, p)[0] for m, p in passes)
    b = sum(trained(m, p)[1] for m, p in passes)
    b_bwd = sum(m.n_layers for m, _ in passes)
    if evaluate:
        c += 4 * (s.n_layers * client_batches + l.n_layers * server_batches)
        b += s.n_layers * client_batches + l.n_layers * server_batches
    d = cfg.n_devices * cfg.local_steps_ccl + cfg.server_steps
    k = len(runner.up_like) if not runner.channel.is_identity else 0
    return {"paged_attention": 0, "flash_attention": b,
            "flash_attention_backward": b_bwd, "lora_matmul": c,
            "gram_log_volume": d, "gram_log_volume_backward": d,
            "quantize_rows": 2 * k,
            "dequantize_rows": (3 if runner.channel.stateful else 2) * k,
            "ssd_chunk": 0}


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


def round_models():
    """The paper's SLM and LLM at full width, with one 1280-wide connector
    latent on both: the reference's FederationSpec refuses the paper's
    pair as published (SLM latent 1280, LLM latent 4096)."""
    from repro_torch.configs.mlecs_paper import LLM, SLM
    return (dataclasses.replace(SLM, connector_dim=1280),
            dataclasses.replace(LLM, connector_dim=1280))


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
    def c_case(M, K, N, r, trans_w):
        x, w, a, b = lora_inputs(gen, M, K, N, r, dt, trans_w=trans_w)
        route = lora_matmul_route(x, w, a, b, trans_w)
        if route != "wgmma":
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
              "llm_dx_transposed_w": c_case(1088, 4096, 4096, 8, True)}
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

    # B's backward at the LLM's and the SLM's training shapes (bf16)
    def b_case(B, S, H, D):
        dt = torch.bfloat16
        q, k, v, do = (torch.randn((B, S, H, D), generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
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
        n = B * S * H * D
        bytes_ = 5 * n * es + B * H * S * 4 + 3 * n * es
        flops = 10 * D * B * H * S * (S + 1) // 2
        bound, by = _bound(bytes_, flops)
        return {"ms": ms, "ms_fma_route": fma, "kernel_route": route,
                "plain_ms": plain, "library_ms": both - fwd,
                "library_fwd_bwd_ms": both, "library_fwd_ms": fwd,
                "bound_ms": bound, "bound_by": by,
                "max_abs_err": err["max_abs_err"],
                "max_rel_err": err["max_rel_err"],
                "shape": {"B": B, "S": S, "H": H, "K": H, "D": D,
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
        "at_other_shapes": {"slm": b_case(8, 136, 20, 64)}})
    return rows

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
        "model": cfg.name, "dtype": cfg.dtype, "requests": len(reqs),
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


def phase_ssm_serving():
    """mamba2-2.7b: prompts 20-700 (1, 2 and 3 chunks of 256 with the 8
    soft tokens); no pages; G 64 launches per admission, nothing else."""
    from repro_torch.configs.mamba2_2p7b import CONFIG
    from repro_torch.launch.serve_engine import EngineConfig
    econf = EngineConfig(n_slots=16, page_size=16, n_pages=2,
                         max_pages_per_seq=64, max_out=64)
    L = CONFIG.n_layers
    metrics, launches, _ = serve_recurrent(
        CONFIG, econf, 20, 700, (20, 300, 700),
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


def release():
    """Free what the last phase left: its objects hold reference cycles
    (a runner's step closures refer back to it), so collect them before
    the caching allocator can return their memory."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import repro_torch.kernels.ops  # noqa: F401  (fails here without the port)
    seconds = {}
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        t1 = time.perf_counter()
        seconds[name] = t1 - t0
        t0 = t1

    phase_card()
    phase_build()
    lap("build")
    phase_paged_checks()
    phase_flash_checks()
    phase_flash_grad_check()
    phase_quantize_checks()
    phase_lora_checks()
    phase_gram_checks()
    phase_ssd_checks()
    lap("kernel_checks")
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
    ssm_serving, ssm_launches = phase_ssm_serving()
    emit({"ssm_serving": ssm_serving})
    release()
    lap("ssm_serving")
    hybrid_serving, hybrid_launches, paged_hybrid = phase_hybrid_serving()
    emit({"hybrid_serving": hybrid_serving})
    row_a = kernels[0]
    row_a["at_other_shapes"] = {"hybrid": paged_hybrid}
    row_a["max_abs_err"] = max(row_a["max_abs_err"],
                               paged_hybrid["max_abs_err"])
    release()
    lap("hybrid_serving")
    kernels += training_kernel_rows()
    kernels += channel_kernel_rows()
    kernels += ssd_kernel_rows()
    lap("kernel_rows")
    emit({"phase_seconds": seconds})
    # each row's launches: the counted runs of the main paths
    paths = {"serving": launches, "training_round": train_launches,
             "channel_rounds": channel_launches,
             "ssm_serving": ssm_launches, "hybrid_serving": hybrid_launches}
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
