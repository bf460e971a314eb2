#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, then:

1. prints the card (``nvidia-smi`` name and power limit) and turns TF32 off;
2. holds the paged decode kernel against its plain PyTorch version on the
   card (SLM shapes, GQA, a window, scattered pages, an idle slot, lengths
   that end mid-page; bf16 and f32);
3. holds the prefill attention kernel against its plain version (SLM
   shapes at S in {32, 131, 256}, GQA, a window, Sq < Sk, D = 256);
4. serves 48 soft-prompted requests through ``ServingEngine`` at the full
   width of ``mlecs-slm-720m`` (bf16, random weights from a seed), checks
   every budget, the free lists and both launch counters, then checks the
   paged decode logits against a full forward over the same tokens;
5. prints a ``{"serving": ...}`` line, then profiles an admission tick
   and four decode steps (``torch.profiler``; kernel time against wall
   time, traces under ``build/profile/``) into a ``{"profile": ...}`` line;
6. prints a ``{"kernels": [...]}`` line (times from CUDA-graph replay,
   bounds from this run's inputs).

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises, so the script exits non-zero and prints no result; it also exits
non-zero when CUDA is unavailable or the port's sources are missing.
It imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_TOL = dict(atol=2e-4, rtol=2e-4)
# kernel and plain version both round one f32 result to bf16: <= 1-2 ulp
BF16_TOL = dict(atol=2e-2, rtol=1e-2)
# paged decode vs full forward at bf16 (tests/test_serving.py's bound):
# the two paths round bf16 products at different shapes
E2E_TOL = dict(atol=6e-2, rtol=5e-2)

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
    import torch
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
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n_calls)
    del graph
    return statistics.median(times)


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


def phase_build():
    import re
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    report = {}
    for name in _build.sources():
        log = _build.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        report[name] = {"max_registers": max(regs, default=None),
                        "max_spill_store_bytes": max(spills, default=None)}
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "ptxas": report})


# ---------------------------------------------------------------------------
# phase 2 / 3: kernels against their plain versions

def paged_case(gen, B, H, K, D, ps, M, dtype, window=0, idle=True):
    """Scattered, non-monotone page ids; lens ending mid-page; one idle slot."""
    import torch
    dev = "cuda"
    P = B * M + 1
    q = torch.randn((B, 1, H, D), generator=gen, device=dev).to(dtype)
    kp = torch.randn((P, ps, K, D), generator=gen, device=dev).to(dtype)
    vp = torch.randn((P, ps, K, D), generator=gen, device=dev).to(dtype)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bt = perm[:B * M].reshape(B, M).int().contiguous()
    lens = torch.randint(1, M * ps + 1, (B,), generator=gen, device=dev)
    lens[1] = M * ps - ps // 2          # ends mid-page
    lens[2] = ps + 1                    # one entry into the second page
    if idle:
        lens[0] = 0                     # idle slot: zeros, not NaN
    return q, kp, vp, bt, lens.int().contiguous(), window


def phase_paged_checks():
    import torch
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = {
        "slm": dict(B=16, H=20, K=20, D=64, ps=16, M=32),
        "slm_window": dict(B=16, H=20, K=20, D=64, ps=16, M=32, window=100),
        "gqa_window": dict(B=8, H=8, K=2, D=64, ps=16, M=12, window=37),
        "gqa_d256": dict(B=4, H=16, K=4, D=256, ps=8, M=6),
    }
    results = {}
    for name, kw in cases.items():
        for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
            args = paged_case(gen, dtype=dtype, **kw)
            got = paged_attention_cuda(*args)
            want = paged_attention_plain(*args)
            torch.cuda.synchronize()
            tag = f"{name}/{str(dtype)[6:]}"
            results[tag] = check_close(f"paged {tag}", got, want, tol)
            if float(got[0].float().abs().max()) != 0.0:
                raise AssertionError(f"paged {tag}: idle slot not zero")
    emit({"phase": "paged_attention_vs_plain", "max_abs_err": results})


def phase_flash_checks():
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
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
            got = flash_attention_cuda(q, k, v, causal=True, window=w)
            want = flash_attention_plain(q, k, v, causal=True, window=w)
            torch.cuda.synchronize()
            tag = f"{name}/{str(dtype)[6:]}"
            results[tag] = check_close(f"flash {tag}", got, want, tol)
    emit({"phase": "flash_attention_vs_plain", "max_abs_err": results})


# ---------------------------------------------------------------------------
# phase 4: the serving engine at full width

N_REQUESTS = 48


def make_requests(cfg, params, seed=0):
    """48 prompts (lengths 20-240, budgets 16-64) with 8-token soft prompts
    from the connector on random modality features and availability."""
    import numpy as np
    import torch
    from repro_torch.core.connector import connector_prefix
    rng = np.random.RandomState(seed)
    lens = rng.randint(20, 241, N_REQUESTS)
    budgets = rng.randint(16, 65, N_REQUESTS)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in lens]
    feats = rng.randn(N_REQUESTS, cfg.n_modalities,
                      cfg.modality_dim).astype(np.float32)
    mask = rng.rand(N_REQUESTS, cfg.n_modalities) < 0.6
    for i in np.nonzero(~mask.any(1))[0]:
        mask[i, rng.randint(cfg.n_modalities)] = True
    with torch.no_grad():
        soft, _, _ = connector_prefix(params["connector"], cfg,
                                      torch.from_numpy(feats).cuda(),
                                      torch.from_numpy(mask).cuda())
    if soft.shape != (N_REQUESTS, cfg.n_soft_tokens, cfg.d_model):
        raise AssertionError(f"soft prompt shape {tuple(soft.shape)}")
    if not torch.isfinite(soft.float()).all():
        raise AssertionError("non-finite soft prompt")
    return [(prompts[i], int(budgets[i]), soft[i]) for i in range(N_REQUESTS)]


def phase_serving():
    import numpy as np
    import torch
    from repro_torch.configs.mlecs_paper import SLM
    from repro_torch.core.connector import init_unified
    from repro_torch.core.lora import flatten, is_lora_leaf
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
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
    paged_attention_cuda.launches = 0
    flash_attention_cuda.launches = 0
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
    launches = {"paged_attention": paged_attention_cuda.launches,
                "flash_attention": flash_attention_cuda.launches}
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
    }

    e2e_err = prefill_decode_consistency(bundle, merged, reqs[0][2])
    serving["prefill_vs_decode_max_abs_err"] = e2e_err
    return engine, snap, launches, serving, reqs


def prefill_decode_consistency(bundle, params, soft, S=100, K=8, pad=28):
    """tests/test_serving.py's contract at full width: prefill a padded
    prompt, seat it in slot 1, decode K teacher-forced tokens and hold
    every step's logits against one full forward over the same tokens."""
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
        pstate = bundle.init_paged(2, 64, ps, "cuda")
        pre = torch.nn.functional.pad(toks[:, :S], (0, pad))
        last, pack, kv_len = bundle.prefill_paged(
            params, {"tokens": pre, "prefix_embeds": prefix}, S)
        errs = [check_close("prefill last logits", last[0], full[0, P + S - 1],
                            E2E_TOL)]
        slot = 1
        n_pg = pages_for(P + S + pad + K, ps)
        page_ids = torch.arange(1, 1 + n_pg, device="cuda")
        pstate = bundle.insert_paged(pstate, pack, slot, page_ids)
        bt = torch.zeros((2, 32), dtype=torch.int32, device="cuda")
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
                                    full[0, P + S + i], E2E_TOL))
            seq_lens = seq_lens + active.int()
    return max(errs)


# ---------------------------------------------------------------------------
# phase 5: where the serving time goes

KERNEL_GROUPS = (("paged_attention", ("paged_attention_kernel",)),
                 ("flash_attention", ("flash_attention_kernel",)),
                 ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "splitk")))


def _device_busy(prof, path):
    """Kernel time from the profiler's trace: (busy ms, ms by group, the
    eight kernels that took the most time)."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    groups, by_name = {}, {}
    busy = 0.0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        dur = float(ev.get("dur", 0.0)) / 1e3
        busy += dur
        name = ev.get("name", "")
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name.lower() for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + dur
        count, total = by_name.get(name[:80], (0, 0.0))
        by_name[name[:80]] = (count + 1, total + dur)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return busy, groups, [{"kernel": k, "launches": c, "ms": t}
                          for k, (c, t) in top]


def phase_profile(engine, reqs):
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
        busy, groups, top = _device_busy(prof,
                                         out_dir / f"trace_{window}.json")
        result[window] = {
            "ticks": n_ticks, "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": (1.0 - busy / wall) if busy else "not measured",
            "kernel_ms_by_group": groups, "top_kernels": top}
    engine.run()
    return result


# ---------------------------------------------------------------------------
# phase 6: numbers

def phase_numbers(engine, snap, launches):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     paged_attention_plain)
    from repro_torch.models.layers import BIG_WINDOW
    cfg = engine.cfg
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(4)
    kernels = []

    # A: the decode step with the most cached tokens in the main run, over
    # each layer's real pool in turn (36 x its working set >> 50 MB L2, so
    # the pages come from HBM as they do in a decode step)
    bt, seq_lens, active = snap
    lens = torch.where(active, seq_lens + 1, 0).int().contiguous()
    B = bt.shape[0]
    kp, vp = engine.pstate["k_pages"], engine.pstate["v_pages"]
    qs = torch.randn((cfg.n_layers, B, 1, H, D), generator=gen,
                     device="cuda").to(kp.dtype)

    def call_a(fn):
        return lambda i: fn(qs[i % cfg.n_layers], kp[i % cfg.n_layers],
                            vp[i % cfg.n_layers], bt, lens, BIG_WINDOW)

    got = paged_attention_cuda(qs[0], kp[0], vp[0], bt, lens, BIG_WINDOW)
    want = paged_attention_plain(qs[0], kp[0], vp[0], bt, lens, BIG_WINDOW)
    err_a = check_close("paged main-path", got, want, BF16_TOL)
    n_keys = int(lens.sum())
    esz = kp.element_size()
    bytes_a = (2 * n_keys * K * D * esz + 2 * B * H * D * esz
               + bt.numel() * 4 + lens.numel() * 4)
    flops_a = 4 * n_keys * H * D
    ms_a = graph_ms(call_a(paged_attention_cuda), n_calls=cfg.n_layers)
    plain_a = graph_ms(call_a(paged_attention_plain), n_calls=cfg.n_layers)
    bound_a = max(bytes_a / HBM_BYTES_PER_S, flops_a / BF16_FLOP_PER_S) * 1e3
    kernels.append({
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:113",
        "launches": launches["paged_attention"], "max_abs_err": err_a,
        "tolerance": BF16_TOL, "ms": ms_a, "plain_ms": plain_a,
        "bound_ms": bound_a,
        "bound_by": "bytes" if bytes_a / HBM_BYTES_PER_S
        >= flops_a / BF16_FLOP_PER_S else "operations",
        "library_ms": None,
        "shape": {"slots": B, "active": int(active.sum()), "cached_keys": n_keys,
                  "H": H, "K": K, "D": D, "page_size": kp.shape[2],
                  "max_pages_per_seq": bt.shape[1], "dtype": str(kp.dtype)},
    })

    # B: one prefill of the largest bucket (8 soft tokens + 256), the most
    # common prefill shape of the main run
    S = cfg.n_soft_tokens + 256
    q = torch.randn((1, S, H, D), generator=gen, device="cuda").to(kp.dtype)
    k = torch.randn((1, S, K, D), generator=gen, device="cuda").to(kp.dtype)
    v = torch.randn((1, S, K, D), generator=gen, device="cuda").to(kp.dtype)
    got = flash_attention_cuda(q, k, v, causal=True, window=BIG_WINDOW)
    want = flash_attention_plain(q, k, v, causal=True, window=BIG_WINDOW)
    err_b = check_close("flash main-path", got, want, BF16_TOL)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bytes_b = 4 * S * H * D * q.element_size()
    flops_b = 4 * D * H * S * (S + 1) // 2
    ms_b = graph_ms(lambda i: flash_attention_cuda(q, k, v, True, BIG_WINDOW))
    plain_b = graph_ms(lambda i: flash_attention_plain(q, k, v, True, BIG_WINDOW))
    lib_b = graph_ms(lambda i: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    bound_b = max(bytes_b / HBM_BYTES_PER_S, flops_b / BF16_FLOP_PER_S) * 1e3
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:105",
        "launches": launches["flash_attention"], "max_abs_err": err_b,
        "tolerance": BF16_TOL, "ms": ms_b, "plain_ms": plain_b,
        "bound_ms": bound_b,
        "bound_by": "bytes" if bytes_b / HBM_BYTES_PER_S
        >= flops_b / BF16_FLOP_PER_S else "operations",
        "library_ms": lib_b,
        "shape": {"B": 1, "S": S, "H": H, "K": K, "D": D,
                  "dtype": str(q.dtype)},
    })
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    import repro_torch.kernels.ops  # noqa: F401  (fails here without the port)
    phase_card()
    phase_build()
    phase_paged_checks()
    phase_flash_checks()
    engine, snap, launches, serving, reqs = phase_serving()
    emit({"serving": serving})
    emit({"profile": phase_profile(engine, reqs)})
    kernels = phase_numbers(engine, snap, launches)
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
