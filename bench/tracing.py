"""The window's readings: the device's busy time from the profiler's
trace (the union of kernel, memcpy and memset intervals over the window,
in every run) and, in the traced run, the kernels by name, the idle gaps
named by the benchmark span the host was in, and the benchmark's own
host spans (each round, each client step, each server step, bracketed by
``synchronize``).

The trace goes to a file under ``TMPDIR`` and is deleted once read.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiler(device_type: str):
    """A profiler of the device's activity (and the runtime calls CUPTI
    records with it), not of the host's operators."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if device_type == "cuda" else \
        [ProfilerActivity.CPU]
    return profile(activities=acts)


def short_name(name: str) -> str:
    """A kernel's function name without its template arguments, return
    type and namespace."""
    n = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    n = n.split("(")[0]
    depth, out = 0, []
    for ch in n:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out).split("::")[-1].strip()[:80] or name[:80]


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def read_trace(prof) -> Dict:
    """The device events of a finished profile: {"kernels": [(short name,
    full name, start us, duration us, grid)], "syncs": [end us of each
    cudaDeviceSynchronize]}."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        os.unlink(path)
    kernels, syncs = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        if cat in DEVICE_CATS:
            name = ev.get("name", "")
            grid = (ev.get("args") or {}).get("grid") or [1, 1, 1]
            kernels.append((short_name(name), name, float(ev["ts"]),
                            float(ev.get("dur", 0.0)), tuple(grid)))
        elif (cat == "cuda_runtime"
              and ev.get("name") == "cudaDeviceSynchronize"):
            syncs.append(float(ev["ts"]) + float(ev.get("dur", 0.0)))
    return {"kernels": kernels, "syncs": sorted(syncs)}


def busy_seconds(trace: Dict) -> float:
    """The seconds in which a kernel, memcpy or memset of ``trace`` ran:
    the union of their intervals, so work on streams that overlap counts
    once."""
    merged = _merge([(ts, ts + d) for _, _, ts, d, _ in trace["kernels"]])
    return sum(b - a for a, b in merged) / 1e6


def summary(trace: Dict, spans: List[tuple], host_syncs: List[int],
            window: Tuple[int, int]) -> Dict:
    """Busy seconds, the window, the top device operations and the
    longest idle gaps named by span.  ``spans`` are (name, t0 ns, t1 ns)
    on the host clock, ``host_syncs`` the host clock right after each of
    the benchmark's ``synchronize`` calls, ``window`` the traced window's
    host (start ns, end ns)."""
    kernels = trace["kernels"]
    merged = _merge([(ts, ts + d) for _, _, ts, d, _ in kernels])
    busy_s = sum(b - a for a, b in merged) / 1e6
    window_s = (window[1] - window[0]) / 1e9
    by_name: Dict[str, float] = {}
    for short, _, _, d, _ in kernels:
        by_name[short] = by_name.get(short, 0.0) + d / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = _named_gaps(merged, trace["syncs"], spans, host_syncs, window)
    idle = {}
    for name, s in gaps:
        idle[name] = idle.get(name, 0.0) + s
    return {"busy_s": busy_s, "window_s": window_s,
            "syncs": [len(trace["syncs"]), len(host_syncs)],
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in
                          sorted(gaps, key=lambda g: -g[1])[:10]],
            "idle_by_span": idle}


def _offset(dev_syncs, host_syncs) -> Optional[float]:
    """The trace clock's offset from the host's (ns): the median gap between
    the benchmark's synchronize calls and the trace's, matched one to one
    (the profiler may add its own at either end: the alignment whose
    offsets agree best); None where no alignment agrees within 1 ms."""
    n, extra = len(host_syncs), len(dev_syncs) - len(host_syncs)
    if not n or extra < 0:
        return None
    best = None
    for k in range(extra + 1):
        offs = [d * 1e3 - h for d, h in zip(dev_syncs[k:k + n], host_syncs)]
        mid = statistics.median(offs)
        spread = max(abs(o - mid) for o in offs)
        if spread < 1e6 and (best is None or spread < best[0]):
            best = (spread, mid)
    return None if best is None else best[1]


def _named_gaps(merged, dev_syncs, spans, host_syncs, window):
    """The gaps between busy intervals (and before the first, after the
    last), each named by the innermost benchmark span the host was in at
    its middle: the trace's clock is put on the host's by the median
    offset between the benchmark's synchronize calls in both
    (:func:`_offset`; unnamed where none agrees)."""
    if not merged:
        return []
    offset = _offset(dev_syncs, host_syncs)
    edges = [(None, merged[0][0])] + [(merged[i][1], merged[i + 1][0])
                                      for i in range(len(merged) - 1)]
    edges.append((merged[-1][1], None))
    out = []
    for a, b in edges:
        if offset is not None:
            lo = window[0] if a is None else a * 1e3 - offset
            hi = window[1] if b is None else b * 1e3 - offset
        elif a is None or b is None:
            continue
        else:
            lo, hi = a * 1e3, b * 1e3
        if hi <= lo:
            continue
        name = "unattributed"
        if offset is not None:
            mid = 0.5 * (lo + hi)
            inner = [s for s in spans if s[1] <= mid <= s[2]]
            name = min(inner, key=lambda s: s[2] - s[1])[0] if inner \
                else "outside"
            if name == "round":
                name = "round_rest"
        out.append((name, (hi - lo) / 1e9))
    return out


def planned_roofline(ctx: Dict, kernel: str, parts, grid_z_over: int = 0
                     ) -> Optional[float]:
    """``kernel``'s share of its roofline, in %: the bound time of the
    launches the traced rounds plan (``ctx["bound_s"]``, ``ctx["plan"]``:
    launches a round) over the device time of the traced kernels whose
    full name holds one of ``parts`` (and whose grid's z passes
    ``grid_z_over``).  Each part is one device kernel of every planned
    launch, so the trace holds each part the plan's launches times the
    rounds; where it holds another number of any part, the plan no longer
    describes the launches made and the share is None.  The counts go to
    ``ctx["launches"]``."""
    planned = ctx["plan"][kernel] * ctx["rounds"]
    counts, seconds = dict.fromkeys(parts, 0), 0.0
    for _, full, _, d, grid in ctx["kernels"]:
        if len(grid) >= 3 and grid[2] <= grid_z_over:
            continue
        part = next((p for p in parts if p in full), None)
        if part is not None:
            counts[part] += 1
            seconds += d / 1e6
    ctx.setdefault("launches", {})[kernel] = {"planned": planned, **counts}
    bound = ctx["bound_s"][kernel] * ctx["rounds"]
    if any(n != planned for n in counts.values()) or not seconds \
            or not bound:
        return None
    return 100.0 * bound / seconds


def span_seconds(ctx: Dict, name: str) -> List[float]:
    return [(t1 - t0) / 1e9 for n, t0, t1 in ctx["spans"] if n == name]


def round_rest_seconds(ctx: Dict) -> List[float]:
    """Each round's span less the step spans inside it."""
    steps = [s for s in ctx["spans"] if s[0] != "round"]
    out = []
    for n, t0, t1 in ctx["spans"]:
        if n == "round":
            inside = sum(b - a for _, a, b in steps if t0 <= a and b <= t1)
            out.append((t1 - t0 - inside) / 1e9)
    return out
