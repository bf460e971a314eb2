"""CPU tests of the benchmark: the manifest against the contract, the data
found by name, the import hygiene, the plain reference against the port on
toy federations, the result line, the op counts by hand, the trace
reduction, and the comparison's control and faults.

    python -m pytest bench -q
"""
from __future__ import annotations

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench import compare, harness, ops, tracing
from bench.conftest import BENCH, TOY_CELLS, write_toy_checkout
from bench.manifest import Manifest

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks",
             "benchmarks_torch"}
NUMBERS = {"loss_gap", "first_loss_gap", "grad_gap", "grad_median_gap",
           "moment_gap", "change_gap", "change_median_gap"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


# ---------------------------------------------------------------------------
# the manifest and the files it names

def test_manifest_keeps_the_contract():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(doc) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert doc["paths"] == ["bench"] and doc["command"][1] == "bench/run.py"
    assert 1 <= doc["run_seconds"] <= 51
    e2e = {m["name"] for m in doc["end_to_end"]}
    assert "setup_s" in e2e
    names = [c["name"] for c in doc["configs"]] + \
        [w["name"] for w in doc["workloads"]] + \
        [m["name"] for m in doc["end_to_end"] + doc["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in doc["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
    used = set()
    for w in doc["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        used.add(w["config"])
    assert used == {c["name"] for c in doc["configs"]}
    for m in doc["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in doc["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert _line(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    mf = Manifest(ROOT)
    for w in doc["workloads"]:
        assert len(mf.end_to_end(w["name"])) >= 2
        assert mf.per_layer(w["name"])
        mf.config(w["config"])
        mf.traffic(w["traffic"])
        lim = mf.limits(w["name"])
        assert set(lim) == NUMBERS
        assert any(v is not None for v in lim.values())
    for m in doc["per_layer"]:
        assert callable(mf.reader(m["name"]))
    assert len(json.dumps(doc)) < 64 * 1024


def test_a_cell_mix_and_metric_added_in_files_are_found(toy_checkout):
    (toy_checkout / "bench" / "metrics" / "toy_rounds.py").write_text(
        "def read(ctx):\n    return float(ctx['rounds'])\n")
    mf = Manifest(toy_checkout)
    for cell, (cfg, traffic) in TOY_CELLS.items():
        assert mf.cell(cell)["config"] == cfg
        assert mf.config(cfg)["name"] == cfg
        assert mf.traffic(traffic)["cohorts"]
    assert mf.reader("toy_rounds")({"rounds": 3}) == 3.0


# ---------------------------------------------------------------------------
# hygiene

def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole toy run in a fresh process, then sys.modules by whole
    top-level names (``repro_torch`` is allowed, ``repro`` is not)."""
    write_toy_checkout(tmp_path)
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from bench import harness\nfrom bench.manifest import Manifest\n"
        "harness.run(Manifest(%r), 'toy.dense', 7, 0.0, False, "
        "device='cpu', log=lambda s: None)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        % (str(ROOT), str(ROOT / "src"), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "repro_torch" in loaded and not loaded & FORBIDDEN


# ---------------------------------------------------------------------------
# the reference against the port

def _toy_limits():
    return dict.fromkeys(NUMBERS, 1e-3)


@pytest.mark.parametrize("cell", sorted(TOY_CELLS))
def test_the_plain_reference_follows_the_port(tmp_path, cell):
    """float32 toys on the CPU: the port's rounds and the reference's agree
    to rounding on every loss, first moment and change."""
    root = write_toy_checkout(tmp_path, limits=_toy_limits())
    out = harness.run(Manifest(root), cell, 2147483659, 0.0, False,
                      device="cpu", log=lambda s: None)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(tmp_path, trace):
    root = write_toy_checkout(tmp_path, limits=_toy_limits())
    logged = []
    out = harness.run(Manifest(root), "toy.dense", 3, 0.0, trace,
                      device="cpu", log=logged.append)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "client_step_ms" in out["metrics"]
    else:
        # no device ran on the CPU, so no device seconds a round
        assert set(out["metrics"]) == {"setup_s"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    line = harness.json_line(out)
    assert json.loads(line)["correct"] is True and "\n" not in line
    run = json.loads(logged[-1])["run"]
    assert run["rounds"] == out["attempted"] == len(run["rounds_s"])
    assert math.isclose(sum(run["rounds_s"]), run["window_s"])
    assert {"cpu_s", "thread_cpu_s", "gc_s", "gc_collections"} <= set(
        run["host"])


# ---------------------------------------------------------------------------
# the control and the faults

def _cell_limits(cell):
    return json.loads((BENCH / "limits" / f"{cell}.json").read_text())


def _plant_unchanged(runner):
    """Every client step returns its state unchanged."""
    for rt in runner.cohorts:
        for name in ("ccl_step", "amt_step"):
            fn = getattr(rt, name)

            def step(p, o, *a, _fn=fn, **k):
                return (p, o, _fn(p, o, *a, **k)[2])
            setattr(rt, name, step)


def _plant_half_batch(runner):
    """Every step sees half of each client's rows (the mean over the
    rest)."""
    for rt in runner.cohorts:
        for name in ("ccl_step", "amt_step"):
            fn = getattr(rt, name)

            def step(p, o, batch, anchor=None, *a, _fn=fn, **k):
                n = batch["tokens"].shape[1] // 2
                half = {key: v[:, :n] for key, v in batch.items()}
                return _fn(p, o, half, None if anchor is None
                           else anchor[:, :n], *a, **k)
            setattr(rt, name, step)


@pytest.mark.parametrize("plant", [_plant_unchanged, _plant_half_batch],
                         ids=["state_unchanged", "half_batch"])
@pytest.mark.parametrize("cell,real", [("toy.dense", "round.dense.c32"),
                                       ("toy.ssmhybrid", "round.dense.c32")])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, plant, cell,
                                                      real):
    """The whole run but the look for a card, the program broken under
    its timed path, held to the cell's own limits: ``correct`` false."""
    root = write_toy_checkout(tmp_path, limits=_cell_limits(real))
    out = harness.run(Manifest(root), cell, 11, 0.0, False, device="cpu",
                      plant=plant, log=lambda s: None)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell,real", [("toy.dense", "round.dense.c32"),
                                       ("toy.ssmhybrid", "round.dense.c32")])
def test_the_fp8_control_is_not_correct(tmp_path, cell, real):
    """The reference with fp8 products in the program's place fails one of
    the cell's limits (the chip readings at the cell's size are in
    PERF.md)."""
    from bench import federation as F
    root = write_toy_checkout(tmp_path)
    mf = Manifest(root)
    c = mf.cell(cell)
    cfg, traffic = mf.config(c["config"]), mf.traffic(c["traffic"])
    models = F.models(cfg)
    fed = F.fed_params(traffic, 13)
    data = F.corpus(models, traffic, 13)
    ref = harness.reference_readings(models, fed, data, 13, "cpu", 2)
    ctl = harness.reference_readings(models, fed, data, 13, "cpu", 2,
                                     precision="fp8")
    ok, checks = compare.decide(compare.readings(ctl, ref),
                                _cell_limits(real))
    assert not ok, checks


# ---------------------------------------------------------------------------
# op counts by hand, at PERF.md's kernel-table shapes

def test_grouped_lora_matmul_by_hand():
    """G 3 x 1088 rows, 1280 -> 1280, r 8 (PERF.md: bound 0.010950 ms,
    operations)."""
    f, b = ops.lora_matmul(3, 1088, 1280, 1280, 8)
    assert f == 2 * 3264 * 1280 * 1280 + 2 * 3264 * 1280 * 8 \
        + 2 * 3264 * 8 * 1280 == 10_829_168_640
    assert b == 2 * (3264 * 1280 + 1280 * 1280 + 3 * 1280 * 8
                     + 3 * 8 * 1280 + 3264 * 1280) == 20_111_360
    assert round(ops.bound_s(f, b) * 1e3, 6) == 0.010950


def test_flash_attention_backward_by_hand():
    """8 x 136, 16 heads of 256, causal (PERF.md: bound 0.021305 ms,
    bytes)."""
    f, b = ops.flash_attention_backward(8, 136, 16, 16, 256)
    pairs = 136 * 137 // 2
    assert f == 10 * 256 * 8 * 16 * pairs
    n = 8 * 136 * 16 * 256
    assert b == 2 * (3 * n + 2 * n) + 8 * 16 * 136 * 4 + 2 * (n + 2 * n)
    assert round(ops.bound_s(f, b) * 1e3, 6) == 0.021305
    assert ops.causal_pairs(10, 4) == 4 * 5 // 2 + 6 * 4


def test_ssd_chunk_bwd_by_hand():
    """mamba2's training shape: 8 rows, one chunk of 256, 80 heads of 64,
    state 128, no state gradient (PERF.md: 110,624,768 B, 0.033022 ms)."""
    f, b = ops.ssd_chunk_bwd(8, 256, 80, 64, 1, 128, 256)
    assert b == 110_624_768
    tri = 256 * 257 // 2
    assert f == 2 * 8 * (tri * 128 + 80 * tri * (2 * 64 + 2 * 128))
    assert round(ops.bound_s(f, b) * 1e3, 6) == 0.033022
    f2, _ = ops.ssd_chunk_bwd(8, 300, 80, 64, 1, 128, 256)
    assert f2 == 2 * 8 * (256 * 257 // 2 + 44 * 45 // 2) * (
        128 + 80 * (2 * 64 + 2 * 128))


def test_pass_flops_by_hand():
    m = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2,
         "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 250,
         "activation": "gelu", "lora_rank": 2,
         "lora_targets": ["wq", "wo"], "n_modalities": 3,
         "modality_dim": 4, "connector_dim": 6, "sliding_window": 0}
    dense = 2 * (8 * 8 + 8 * 4 + 8 * 4 + 8 * 8 + 8 * 32) + 8 * 256
    lora = 2 * ((8 * 2 + 2 * 8) + (8 * 2 + 2 * 8))
    T, rows, S = 3 * 5, 3, 5
    quad = 2 * 4 * 4 * 2 * (5 * 6 // 2) * rows
    conn = 2 * (3 * 4 * 6 + 3 * 6 * 6 + 6 * 6 + 6 * 8) * rows
    total = 2 * (dense + lora) * T + quad + conn \
        + 2 * dense * T + 4 * lora * T + 2 * quad + 2 * conn
    assert ops.pass_flops(m, rows, S) == total
    assert ops.pass_flops(m, rows, S, prefix=False) == total - 3 * conn


# ---------------------------------------------------------------------------
# the trace and the comparison

def test_busy_union_and_named_gaps():
    kernels = [("k", "k", 100.0, 50.0, (1, 1, 1)),
               ("k", "k", 120.0, 50.0, (1, 1, 2)),
               ("m", "m", 400.0, 100.0, (1, 1, 1))]
    # the trace's clock (us) is the host's (ns) / 1e3 + 1000 us
    trace = {"kernels": kernels, "syncs": [1000.0, 1600.0, 2000.0]}
    spans = [("round", 0, 1_000_000), ("server_step", 200_000, 350_000)]
    s = tracing.summary(trace, spans, [0, 600_000, 1_000_000],
                        (0, 1_000_000))
    assert math.isclose(s["busy_s"], 170e-6)
    assert s["device_ops"][0] == ["k", 100e-6]
    assert s["syncs"] == [3, 3]
    # idle: [0, 100) and [170, 400) us of the trace before 1000 us: the
    # host ran before the first sync; the gap (170, 400) ns-mapped lies
    # at host -830 .. -600 us: outside every span
    names = {n for n, _ in s["idle_gaps"]}
    assert names <= {"outside", "round_rest", "server_step"}


def test_the_device_seconds_a_round_are_the_union_over_whole_rounds(
        tmp_path, monkeypatch):
    """The window's device work (two kernels that overlap, one apart) over
    the rounds it held, in the untraced run's metrics; the traced run's
    wall seconds a round are its window over its rounds."""
    kernels = [("k", "k", 100.0, 50.0, (1, 1, 1)),
               ("k", "k", 120.0, 50.0, (1, 1, 2)),
               ("m", "m", 400.0, 100.0, (1, 1, 1))]
    assert math.isclose(tracing.busy_seconds({"kernels": kernels}), 170e-6)
    monkeypatch.setattr(tracing, "read_trace",
                        lambda prof: {"kernels": kernels, "syncs": []})
    root = write_toy_checkout(tmp_path, limits=_toy_limits())
    out = harness.run(Manifest(root), "toy.dense", 3, 0.0, False,
                      device="cpu", log=lambda s: None)
    assert math.isclose(out["metrics"]["round_device_s"]["value"],
                        170e-6 / out["attempted"])
    assert out["metrics"]["round_device_s"]["unit"] == "s"
    read = Manifest(ROOT).reader("round_wall_s")
    assert read({"rounds": 4, "window_s": 10.0}) == 2.5
    assert read({"rounds": 0, "window_s": 0.0}) is None


def test_a_roofline_is_silent_where_the_trace_departs_from_the_plan():
    """Two rounds of a plan of 2 launches a round, each one "a" and one
    "b" kernel; the launches with grid z 1 are left out where asked."""
    def kernel(name, dur, z=2):
        return (name, f"void {name}<int>(int)", 0.0, dur, (1, 1, z))
    ctx = {"rounds": 2, "plan": {"k": 2}, "bound_s": {"k": 1e-6},
           "kernels": [kernel("a", 1.0)] * 4 + [kernel("b", 3.0)] * 4
           + [kernel("a", 50.0, z=1)]}
    share = tracing.planned_roofline(ctx, "k", ("a", "b"), grid_z_over=1)
    assert math.isclose(share, 100.0 * 2e-6 / 16e-6)
    assert ctx["launches"]["k"] == {"planned": 4, "a": 4, "b": 4}
    ctx["kernels"] = ctx["kernels"][1:]          # one "a" launch gone
    assert tracing.planned_roofline(ctx, "k", ("a", "b"), 1) is None
    assert ctx["launches"]["k"] == {"planned": 4, "a": 3, "b": 4}
    ctx["kernels"] = [kernel("a", 1.0)] * 6 + [kernel("b", 3.0)] * 4
    assert tracing.planned_roofline(ctx, "k", ("a", "b"), 1) is None


def test_the_clocks_align_past_the_profiler_s_own_syncs():
    host = [0, 1_000_000, 2_500_000]
    dev = [500.0, 1500.0, 2500.0, 4000.0]          # one more, first
    assert tracing._offset(dev, host) == 1_500_000
    assert tracing._offset([1.0, 9000.0], [0, 1]) is None


def test_gaps_are_left_unnamed_when_the_syncs_do_not_match():
    trace = {"kernels": [("k", "k", 0.0, 1.0, (1, 1, 1)),
                         ("k", "k", 5.0, 1.0, (1, 1, 1))], "syncs": [1.0]}
    s = tracing.summary(trace, [], [1, 2], (0, 10_000))
    assert s["idle_gaps"] == [["unattributed", 4e-6]]


def test_the_comparison_measures_against_the_median_and_skips_nought():
    ref = {"a": 1.0, "b": 2.0, "c": 3.0, "tiny": 1e-9}
    assert compare.negligible(ref) == {"tiny"}
    g = compare.gaps({"a": 1.1, "b": 2.0, "c": 3.0, "tiny": 5.0}, ref,
                     {"tiny"})
    assert set(g) == {"a", "b", "c"} and math.isclose(g["a"], 0.1 / 2.0)
    assert compare.gaps({"a": 1.0}, {"a": 1.0, "b": 1.0})["b"] == math.inf
    ok, checks = compare.decide({"x": {"value": 0.5}, "y": {"value": 9.0}},
                                {"x": 1.0, "y": None})
    assert ok and checks["y"] == {"value": 9.0, "limit": None}

