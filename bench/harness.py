"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result.

Set-up draws the corpus and the weights from the seed, builds the port's
``FederatedRunner`` on the vectorized engine and drives it through the
rounds the traffic follows (the first also warms every shape up); the
window then runs whole rounds (``run_round(evaluate=False)``) under the
profiler until its seconds have passed, the round running at the deadline
finishing and counting.  Once the window has closed and the peak memory has been read,
the program is freed and the plain reference follows the same rounds
from the same inputs; ``correct`` is the comparison of the two.
"""
from __future__ import annotations

import gc
import json
import math
import os
import sys
import time
from typing import Callable, Dict, Optional

import torch

from bench import compare, federation as F, ops, tracing, weights as W
from bench.manifest import Manifest
from bench.reference import model as RM
from bench.reference.round import ReferenceFederation

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks",
             "benchmarks_torch")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's, the JAX
    package's or its runners' (compared whole: ``repro_torch`` is none of
    them)."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class _GcClock:
    """Seconds and collections of Python's garbage collector while
    installed in ``gc.callbacks``."""

    def __init__(self):
        self.seconds, self.collections, self._t = 0.0, [0, 0, 0], None

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.collections[info["generation"]] += 1
            self._t = None


def host_usage() -> Dict[str, float]:
    """This process's CPU seconds, over all its threads (the autograd
    engine dispatches the backward from a thread of its own) and in the
    calling thread."""
    return {"cpu_s": time.process_time(), "thread_cpu_s": time.thread_time()}


def reference_readings(models: Dict, fed: Dict, data, seed: int, device,
                       rounds: int, precision: str = "f32",
                       half_batch: bool = False) -> Dict:
    """The plain reference's losses, first moments and changes over
    ``rounds`` rounds, from the same draw of weights as the program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sizes = [n for n, _ in fed["cohorts"]]
    w = W.draw(seed, models, sizes, device)
    ref = ReferenceFederation(fed, models, data, w, RM.Numerics(precision),
                              device, half_batch=half_batch)
    del w
    for _ in range(rounds):
        ref.run_round()
    out = {"losses": ref.losses(), "moments": ref.first_moments,
           "first": ref.first_step, "changes": ref.change_norms()}
    del ref
    _free(device)
    return out


class Program:
    """The port's federation of one cell, built from the seed and driven
    through its followed rounds (:meth:`setup`)."""

    def __init__(self, models: Dict, fed: Dict, traffic: Dict, data,
                 seed: int, device, plant: Optional[Callable] = None):
        self.models, self.fed, self.traffic = models, fed, traffic
        self.data, self.seed, self.device = data, seed, device
        self.stages: Dict[str, object] = {}
        t = time.perf_counter()
        sizes = [n for n, _ in fed["cohorts"]]
        w = W.draw(seed, models, sizes, device)
        _sync(device)
        self.stages["draw_s"] = time.perf_counter() - t
        state = W.init_state(w)
        del w
        _free(device)
        self.stages["to_host_s"] = time.perf_counter() - t
        self.init = F.init_trainables(state, sizes)
        self.runner = F.build_runner(models, fed, traffic, data, state,
                                     device)
        del state
        _sync(device)
        self.stages["runner_s"] = time.perf_counter() - t
        if plant is not None:
            plant(self.runner)
        self.hooks = F.StepHooks(self.runner, device)

    def setup(self) -> Dict:
        """The rounds the traffic follows; returns the program's readings
        (every step's losses, the first moments after the first round,
        the changes after the last)."""
        h = self.hooks
        h.record = True
        moments = None
        self.stages["rounds_s"] = []
        for r in range(self.traffic["followed_rounds"]):
            t = time.perf_counter()
            h.new_round()
            self.runner.run_round(evaluate=False)
            if r == 0:
                moments = F.moment_norms(self.runner)
            _sync(self.device)
            self.stages["rounds_s"].append(time.perf_counter() - t)
        _sync(self.device)
        out = {"losses": h.loss_dict(), "moments": moments,
               "first": {k: v for d in h.first.values()
                         for k, v in d.items()},
               "changes": F.change_norms(self.runner, self.init)}
        h.record = False
        h.losses = {}
        return out

    def window(self, seconds: float, trace: bool) -> Dict:
        """Whole rounds until ``seconds`` have passed, the device profiled
        (its busy seconds); with ``trace`` the steps and rounds are also
        bracketed by ``synchronize`` and the trace is summed up by span
        and kernel.  The objects set-up left are frozen out of the
        garbage collector's passes for the window, so a collection walks
        only what the window makes."""
        h = self.hooks
        h.timed = trace
        if not trace:
            h.release()
        prof = tracing.profiler(torch.device(self.device).type)
        gc.collect()
        gc.freeze()
        gc_clock = _GcClock()
        gc.callbacks.append(gc_clock)
        prof.__enter__()
        h.syncs, h.spans = [], []
        usage0 = host_usage()
        _sync(self.device)
        t0 = time.perf_counter_ns()
        if trace:
            h.syncs.append(t0)
        ends = []
        while True:
            r0 = h.sync() if trace else None
            self.runner.run_round(evaluate=False)
            if trace:
                h.spans.append(("round", r0, h.sync()))
            ends.append(time.perf_counter_ns())
            if ends[-1] - t0 >= seconds * 1e9:
                break
        _sync(self.device)
        t1 = time.perf_counter_ns()
        usage1 = host_usage()
        gc.callbacks.remove(gc_clock)
        gc.unfreeze()
        if trace:
            h.syncs.append(t1)
        ends[-1] = t1
        out = {"rounds": len(ends), "window_s": (t1 - t0) / 1e9,
               "rounds_s": [(b - a) / 1e9 for a, b in zip([t0] + ends, ends)],
               "host": {**{k: usage1[k] - usage0[k] for k in usage1},
                        "gc_s": gc_clock.seconds,
                        "gc_collections": gc_clock.collections,
                        "threads": torch.get_num_threads(),
                        "cpus": len(os.sched_getaffinity(0))}}
        prof.__exit__(None, None, None)
        trace_ = tracing.read_trace(prof)
        out["busy_s"] = tracing.busy_seconds(trace_)
        if trace:
            out["trace"] = tracing.summary(trace_, h.spans, h.syncs, (t0, t1))
            out["kernels"] = trace_["kernels"]
            out["spans"] = list(h.spans)
        return out

    def close(self) -> None:
        self.hooks.release()
        del self.runner, self.hooks
        _free(self.device)


def run(manifest: Manifest, cell_name: str, seed: int, seconds: float,
        trace: bool, device="cuda", t_start: Optional[float] = None,
        plant: Optional[Callable] = None, log=print) -> Dict:
    """One run of ``cell_name``; returns the result line's object (the
    caller prints it).  ``plant`` breaks the program underneath (the
    tests' faults); ``log`` takes the earlier lines."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = manifest.cell(cell_name)
    cfg, traffic = manifest.config(cell["config"]), manifest.traffic(
        cell["traffic"])
    limits = manifest.limits(cell_name)
    models = F.models(cfg)
    fed = F.fed_params(traffic, seed)
    data = F.corpus(models, traffic, seed)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    prog = Program(models, fed, traffic, data, seed, device, plant)
    readings_prog = prog.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    win = prog.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    comm = prog.runner.comm_stats
    prog_stages = prog.stages
    prog.close()
    del prog
    log(json_line({"program": {"round_s": win["window_s"] / win["rounds"],
                               "rounds": win["rounds"], "setup_s": setup_s,
                               "memory_peak_bytes": peak,
                               "stages": prog_stages}}))

    stages = dict(prog_stages)
    t = time.perf_counter()
    ref = reference_readings(models, fed, data, seed, device,
                             traffic["followed_rounds"])
    stages["reference_s"] = time.perf_counter() - t
    if torch.device(device).type == "cuda":
        stages["reference_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
    read = compare.readings(readings_prog, ref)
    correct, checks = compare.decide(read, limits)

    round_s = win["window_s"] / win["rounds"]
    # the device's busy seconds a whole round; none where no device ran
    round_device_s = win["busy_s"] / win["rounds"] if win["busy_s"] \
        else None
    if torch.device(device).type == "cuda" and round_device_s is None:
        raise RuntimeError("the profiler traced no device work in the "
                           "window")
    result_metrics = {}
    if not trace:
        values = {"round_s": round_s, "round_device_s": round_device_s,
                  "setup_s": setup_s}
        for m in manifest.end_to_end(cell_name):
            v = values[m["name"]]
            if v is not None:
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    extra = {"round_s": round_s, "round_device_s": round_device_s,
             "busy_s": win["busy_s"], "rounds": win["rounds"],
             "window_s": win["window_s"], "rounds_s": win["rounds_s"],
             "host": win["host"], "setup_s": setup_s,
             "memory_peak_bytes": peak, "comm_stats": comm,
             "stages": stages,
             "worst_entries": {k: v["entry"] for k, v in read.items()}}
    device_info = {"platform": "gpu" if torch.device(device).type == "cuda"
                   else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if torch.device(device).type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": win["rounds"],
           "failed": 0, "metrics": result_metrics, "device": device_info}
    if trace:
        t = win["trace"]
        ctx = {"spans": win["spans"], "kernels": win["kernels"],
               "rounds": win["rounds"], "window_s": t["window_s"],
               "busy_s": t["busy_s"],
               "bound_s": ops.round_bound_s(models, traffic),
               "plan": {k: len(v) for k, v in
                        ops.round_launches(models, traffic).items()},
               "model_flops_round": ops.round_model_flops(models, traffic)}
        for m in manifest.per_layer(cell_name):
            v = manifest.reader(m["name"])(ctx)
            if v is not None and math.isfinite(v):
                result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
        extra["idle_by_span"] = t["idle_by_span"]
        extra["launches"] = ctx.get("launches", {})
        extra["syncs_trace_host"] = t["syncs"]
    log(json_line({"run": extra}))
    out["checks"] = checks
    return out


def _clean(obj):
    """``obj`` with every non-finite float as a string (JSON has none)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    return obj


def json_line(obj) -> str:
    return json.dumps(_clean(obj))
