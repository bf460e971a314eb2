"""The port's dry run against the reference's, field by field.

Runs ``repro.launch.dryrun.dryrun_one`` and ``repro_torch.launch.dryrun.
dryrun_one`` on the same (arch x input shape), each in a child process of
its own, and prints both values of every field beside their ratio (port
over reference): argument, output, alias and temp bytes a rank; the
collective bytes a rank, in all and by op; FLOP and bytes accessed; and
the FLOP of the reference's dot ops alone (summed from its post-SPMD HLO:
XLA's cost analysis also counts a FLOP for each element of an elementwise
op, the port's counter only matmuls and convolutions).

The reference's production mesh comes from ``jax.make_mesh``, whose axes
are Explicit on JAX 0.9, and its ``with_sharding_constraint`` refuses
Explicit axes.  So its child builds the same mesh with Auto axes in place
of ``repro.launch.dryrun.make_production_mesh``; nothing of ``src/repro``
changes.

Usage, from the root of a checkout (CPU only):

    python tools/dryrun_compare.py --arch gemma-2b --shape train_4k \\
        --set n_layers=1 --out-dir /tmp/cmp

``--mesh 4x4`` (or any ``DxM`` / ``PxDxM``) replaces the production mesh,
``--seq-len`` / ``--batch`` the input shape's sizes (its name and kind
stay).  Writes ``ref.json``, ``port.json`` and ``compare.json`` under
``--out-dir`` and nothing else.

The grid: every assigned arch x input shape (40 cells), or those of the
``--arch`` / ``--shape`` given (each may repeat), one cell after another
(``--jobs`` at once), each as above in ``<out-dir>/<arch>__<shape>/``:

    python tools/dryrun_compare.py --grid --set n_layers=1 \\
        --out-dir /tmp/grid [--shape decode_32k --shape long_500k]

writes ``grid.json`` (every cell's fields, its yardstick and the error of
a side that failed; the other side then stands alone) and prints one
table of port / reference ratios: argument, temp and collective bytes,
in all ("coll": the reference's loop bodies counted once a trip;
"coll0": its own count) and by op, FLOP and dot FLOP.  A cell is within
the yardstick where its temp and collective bytes lie within
``YARDSTICK`` of the reference's.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, path into the reference's JSON, path into the port's)
FIELDS = [
    ("argument bytes", ("memory_analysis", "argument_size_in_bytes")),
    ("output bytes", ("memory_analysis", "output_size_in_bytes")),
    ("alias bytes", ("memory_analysis", "alias_size_in_bytes")),
    ("temp bytes", ("memory_analysis", "temp_size_in_bytes")),
    ("collective bytes", ("collectives", "total_bytes")),
    ("collective bytes, loops x trips", ("collectives_by_trip",
                                         "total_bytes"),
     ("collectives", "total_bytes")),
    ("flops", ("cost_analysis", "flops")),
    ("dot flops", ("dot_flops",), ("cost_analysis", "flops")),
    ("bytes accessed", ("cost_analysis", "bytes accessed")),
]
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute", "broadcast")
# temp and collective bytes a rank, port / reference, that a cell keeps
YARDSTICK = (0.25, 4.0)
# temp and collective bytes a rank, one port run over another (two torch
# versions), that a cell keeps
PORT_BAND = (0.5, 2.0)
CELL_TIMEOUT_S = 3600       # a side of a grid cell (full depth: minutes)


def _mesh(text: str):
    dims = tuple(int(d) for d in text.split("x"))
    if len(dims) not in (2, 3):
        raise argparse.ArgumentTypeError(f"mesh {text!r}: DxM or PxDxM")
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return names, dims


def _shape(mod, args):
    base = mod.INPUT_SHAPES[args.shape]
    return type(base)(base.name, args.seq_len or base.seq_len,
                      args.batch or base.global_batch, base.kind)


_DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
_DOT = re.compile(r"\sdot\(%?([\w.\-]+),")


def hlo_dot_flops(text: str) -> int:
    """2 x output elements x contracted size, summed over every ``dot`` of
    an HLO module's text (each computation once, as XLA's cost analysis
    counts a loop body)."""
    shapes, total = {}, 0
    for line in text.splitlines():
        m = _DEF.match(line)
        if m is None:
            continue
        shapes[m.group(1)] = [int(d) for d in m.group(2).split(",") if d]
        dot = _DOT.search(line)
        if dot is None:
            continue
        lhs = shapes[dot.group(1)]
        contracted = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
        k = 1
        for d in contracted.group(1).split(","):
            k *= lhs[int(d)] if d else 1
        n = 1
        for d in shapes[m.group(1)]:
            n *= d
        total += 2 * n * k
    return total


_COMP = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\{\s*$")
_WHILE = re.compile(r"\swhile\(.*body=%?([\w.\-]+)")
_TRIPS = re.compile(r'known_trip_count"\s*:\s*\{\s*"n"\s*:\s*"(\d+)"')


def hlo_collectives_by_trip(text: str, per_line) -> dict:
    """The collective bytes of an HLO module's text with each loop body's
    counted once a trip (its ``known_trip_count``, nested loops
    multiplied), each line costed by ``per_line(line)`` (the reference's
    ``collective_bytes``): ``{"total_bytes", "per_op"}``.  (The
    reference's own count multiplies a body whose computation's name
    holds "body" or "while", which JAX 0.9's names do not.)"""
    comp, entry, loops, lines = "", None, {}, {}
    for line in text.splitlines():
        m = _COMP.match(line)
        if m:
            comp = m.group(1)
            entry = comp if line.startswith("ENTRY") else entry
            continue
        w = _WHILE.search(line)
        if w:
            trips = _TRIPS.search(line)
            loops.setdefault(comp, []).append(
                (w.group(1), int(trips.group(1)) if trips else 1))
        lines.setdefault(comp, []).append(line)
    mult = {}

    def walk(name, k):
        mult[name] = mult.get(name, 0) + k
        for body, trips in loops.get(name, ()):
            walk(body, k * trips)
    walk(entry, 1)
    per_op, total = {}, 0.0
    for name, k in mult.items():
        for line in lines.get(name, ()):
            one = per_line(line)
            for op, v in one["per_op"].items():
                d = per_op.setdefault(op, {"count": 0, "bytes": 0.0})
                d["count"] += v["count"]
                d["bytes"] += v["bytes"] * k
            total += one["total_bytes"] * k
    return {"total_bytes": total, "per_op": per_op}


def run_reference(args) -> dict:
    """The reference's ``dryrun_one`` on an Auto-axes mesh of
    ``args.mesh`` (it forces 512 host devices when imported), with the dot
    FLOP of its compiled module (``"dot_flops"``) and its collectives
    with each loop body counted once a trip (``"collectives_by_trip"``,
    :func:`hlo_collectives_by_trip`)."""
    import jax
    from jax.sharding import AxisType

    from repro.launch import dryrun as D
    names, dims = args.mesh
    D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        dims, names, axis_types=(AxisType.Auto,) * len(dims))
    D.INPUT_SHAPES = {**D.INPUT_SHAPES, args.shape: _shape(D, args)}
    texts = []
    count = D.collective_bytes      # the one reader of the compiled text

    def reading(text, *a, **k):
        texts.append(text)
        return count(text, *a, **k)
    D.collective_bytes = reading
    res = D.dryrun_one(args.arch, args.shape, multi_pod=len(dims) == 3,
                       overrides=args.overrides)
    res["dot_flops"] = hlo_dot_flops(texts[0])
    res["collectives_by_trip"] = hlo_collectives_by_trip(texts[0], count)
    return res


def run_port(args) -> dict:
    """The port's ``dryrun_one`` on a fake group of ``args.mesh``'s size."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import _mesh as device_mesh
    from repro_torch.launch.mesh import fake_world
    names, dims = args.mesh
    n = 1
    for d in dims:
        n *= d
    fake_world(n)
    try:
        mesh = device_mesh("cpu", range(n), dims, names)
        return D.dryrun_one(args.arch, args.shape, multi_pod=len(dims) == 3,
                            overrides=args.overrides, mesh=mesh,
                            shape=_shape(D, args))
    finally:
        dist.destroy_process_group()


def _get(res, path):
    for k in path:
        if not isinstance(res, dict) or k not in res:
            return None
        res = res[k]
    return res


def compare(ref, port) -> dict:
    """{field: {"ref", "port", "ratio"}} (ratio = port / ref; None where
    either is missing or the reference's is 0).  A side that failed
    (None) leaves its values None."""
    fields = list(FIELDS) + [
        (f"collective {op}", ("collectives_by_trip", "per_op", op, "bytes"),
         ("collectives", "per_op", op, "bytes"))
        for op in COLLECTIVE_OPS]
    out = {}
    for label, ref_path, *port_path in fields:
        r, p = _get(ref, ref_path), _get(port, (port_path or [ref_path])[0])
        if r is None and p is None:
            continue
        out[label] = {"ref": r, "port": p,
                      "ratio": p / r if r and p is not None else None}
    return out


def within_yardstick(fields: dict):
    """True where temp and collective bytes (the reference's loop bodies
    counted once a trip) both lie within ``YARDSTICK`` of the
    reference's (a cell that moves no collective bytes on either side
    keeps it); None where a side is missing."""
    lo, hi = YARDSTICK
    ok = True
    for name in ("temp bytes", "collective bytes, loops x trips"):
        v = fields.get(name)
        if v is None or v["ref"] is None or v["port"] is None:
            return None
        if v["ref"] == 0:
            ok &= v["port"] == 0
        else:
            ok &= lo <= v["ratio"] <= hi
    return bool(ok)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _children(argv, out_dir: Path, timeout=None):
    """Both sides' results ({side: result or None}) and the failures
    ({side: the end of its stderr}), each side run in a child process of
    its own, the two at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for side in ("ref", "port"):
        err = tempfile.TemporaryFile("w+")
        procs[side] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--side", side,
             *argv, "--out-dir", str(out_dir)], env=_env(),
            stdout=subprocess.DEVNULL, stderr=err), err)
    results, failed = {}, {}
    for side, (p, err) in procs.items():
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = f"timed out after {timeout} s"
        err.seek(0)
        tail = err.read()[-2000:]
        err.close()
        path = out_dir / f"{side}.json"
        if rc == 0 and path.exists():
            results[side] = json.loads(path.read_text())
        else:
            results[side] = None
            failed[side] = f"exit {rc}: {tail}"
    return results, failed


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=[])
    ap.add_argument("--shape", action="append", default=[])
    ap.add_argument("--grid", action="store_true",
                    help="every assigned arch x shape (or those given)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="grid cells run at once (two processes each)")
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (e.g. n_layers=1)")
    ap.add_argument("--mesh", type=_mesh, default=_mesh("16x16"))
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--ports", nargs=2, metavar=("RUN", "BASE"),
                    help="two directories of the port's dry-run JSONs: "
                         "RUN against BASE, cell by cell (no JAX)")
    ap.add_argument("--ref-grid", metavar="GRID_JSON",
                    help="with --ports: a --grid run's grid.json, each "
                         "side's temp and collective bytes against the "
                         "reference's")
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--side", choices=("ref", "port"), help=argparse.SUPPRESS)
    return ap


def _cell_argv(args, arch: str, shape: str):
    argv = ["--arch", arch, "--shape", shape,
            "--mesh", "x".join(map(str, args.mesh[1]))]
    for ov in args.overrides:
        argv += ["--set", ov]
    if args.seq_len:
        argv += ["--seq-len", str(args.seq_len)]
    if args.batch:
        argv += ["--batch", str(args.batch)]
    return argv


def _record(args, arch, shape, results, failed) -> dict:
    ref, port = results["ref"], results["port"]
    fields = compare(ref, port)
    kind = (port or ref or {}).get("kind")
    return {"arch": arch, "shape": shape, "kind": kind,
            "mesh": "x".join(map(str, args.mesh[1])),
            "overrides": args.overrides, "fields": fields,
            "within_yardstick": within_yardstick(fields),
            "errors": failed,
            "seconds": {side: r["lower_s"] + r["compile_s"]
                        for side, r in results.items() if r},
            "torch": (port or {}).get("torch"),
            "port_replicated_ops": (port or {}).get("replicated_ops")}


def run_cell(args, arch: str, shape: str, out_dir: Path) -> dict:
    """One cell: both sides in child processes, ``compare.json`` written
    beside their JSONs."""
    t0 = time.time()
    results, failed = _children(_cell_argv(args, arch, shape), out_dir,
                                timeout=CELL_TIMEOUT_S)
    rec = _record(args, arch, shape, results, failed)
    rec["wall_s"] = round(time.time() - t0, 1)
    (out_dir / "compare.json").write_text(json.dumps(rec, indent=1))
    return rec


def _fmt(v) -> str:
    if v is None:
        return "-"
    return f"{v:,.0f}" if float(v).is_integer() or abs(v) > 1e3 else f"{v:.4g}"


def _ratio(v) -> str:
    """A field's ratio for the grid's table: '-' where the port has
    nothing, '+<MB>' where only the port moves bytes."""
    r, p = (None, None) if v is None else (v["ref"], v["port"])
    if not p:
        return "0" if r and p == 0 else "-"
    mb = p / 1e6
    return (f"+{mb:.0f}M" if mb >= 100 else f"+{mb:.3g}M") if not r \
        else f"{p / r:.3g}"


GRID_COLUMNS = [("arg", "argument bytes"), ("temp", "temp bytes"),
                ("coll", "collective bytes, loops x trips"),
                ("coll0", "collective bytes"),
                ("ag", "collective all-gather"),
                ("ar", "collective all-reduce"),
                ("rs", "collective reduce-scatter"),
                ("a2a", "collective all-to-all"),
                ("cp", "collective collective-permute"),
                ("flop", "flops"), ("dot", "dot flops")]


def grid_table(records) -> str:
    """One line a cell: port / reference of each of ``GRID_COLUMNS``,
    the yardstick, and which side failed."""
    head = f"{'arch':<22}{'shape':<13}" + "".join(
        f"{c:>11}" for c, _ in GRID_COLUMNS) + "  within"
    lines = [head]
    for r in records:
        f = r["fields"]
        row = f"{r['arch']:<22}{r['shape']:<13}" + "".join(
            f"{_ratio(f.get(label)):>11}" for _, label in GRID_COLUMNS)
        ok = {True: "yes", False: "NO", None: "-"}[r["within_yardstick"]]
        if r["errors"]:
            ok += " (" + " and ".join(r["errors"]) + " failed)"
        lines.append(row + "  " + ok)
    return "\n".join(lines)


def run_grid(args) -> dict:
    """Every cell of ``args``' archs x shapes (all assigned by default),
    ``args.jobs`` at once; ``grid.json`` and the table."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.dryrun import ASSIGNED, INPUT_SHAPES
    archs = args.arch or ASSIGNED
    shapes = args.shape or list(INPUT_SHAPES)
    cells = [(a, s) for a in archs for s in shapes]
    out_dir = Path(args.out_dir)
    t0 = time.time()

    def one(cell):
        arch, shape = cell
        rec = run_cell(args, arch, shape, out_dir / f"{arch}__{shape}")
        failed = ", ".join(rec["errors"])
        print(f"[{time.time() - t0:7.1f} s] {arch} x {shape}: "
              f"{'failed: ' + failed if failed else 'done'}", flush=True)
        return rec
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        records = list(pool.map(one, cells))
    grid = {"mesh": "x".join(map(str, args.mesh[1])),
            "overrides": args.overrides, "yardstick": YARDSTICK,
            "wall_s": round(time.time() - t0, 1), "cells": records}
    (out_dir / "grid.json").write_text(json.dumps(grid, indent=1))
    print(f"grid on {grid['mesh']} {' '.join(args.overrides)}: port / "
          f"reference ({len(records)} cells, {grid['wall_s']} s)")
    print(grid_table(records))
    return grid


def _port_json(directory: Path) -> dict:
    """{(arch, shape): the port's dry-run JSON} of a directory written by
    ``python -m repro_torch.launch.dryrun --out-dir`` (``<arch>__<shape>
    .json``; tagged or multi-pod files are left out)."""
    out = {}
    for path in sorted(directory.glob("*.json")):
        parts = path.stem.split("__")
        if len(parts) == 2:
            out[tuple(parts)] = json.loads(path.read_text())
    return out


def compare_ports(run: dict, base: dict) -> dict:
    """One port run against another on the same cell (ratios ``run`` over
    ``base``): temp, collective and argument bytes a rank and each
    collective op's bytes, the ``replicated_ops`` only one side ran, and
    whether the cell stands within ``PORT_BAND`` (temp and collectives
    within the band, argument bytes equal, ``run``'s replicated ops a
    subset of ``base``'s)."""
    def ratio(path):
        r, b = _get(run, path), _get(base, path)
        if r is None or b is None:
            return {"run": r, "base": b, "ratio": None}
        return {"run": r, "base": b,
                "ratio": r / b if b else (1.0 if r == 0 else None)}
    fields = {label: ratio(path) for label, path in (
        ("temp bytes", ("memory_analysis", "temp_size_in_bytes")),
        ("collective bytes", ("collectives", "total_bytes")),
        ("argument bytes", ("memory_analysis", "argument_size_in_bytes")))}
    for op in COLLECTIVE_OPS:
        v = ratio(("collectives", "per_op", op, "bytes"))
        if v["run"] is not None or v["base"] is not None:
            fields[f"collective {op}"] = v
    rep_run = run.get("replicated_ops") or {}
    rep_base = base.get("replicated_ops") or {}
    lo, hi = PORT_BAND
    within = all(v["ratio"] is not None and lo <= v["ratio"] <= hi
                 for k, v in fields.items()
                 if k in ("temp bytes", "collective bytes")) and \
        fields["argument bytes"]["run"] == fields["argument bytes"]["base"] \
        and set(rep_run) <= set(rep_base)
    return {"fields": fields,
            "replicated_only_in_run": {k: v for k, v in rep_run.items()
                                       if k not in rep_base},
            "replicated_only_in_base": {k: v for k, v in rep_base.items()
                                        if k not in rep_run},
            "torch": [run.get("torch"), base.get("torch")],
            "within": within}


def _band(v) -> str:
    return "-" if v is None or v["ratio"] is None else f"{v['ratio']:.4g}"


def run_ports(args) -> dict:
    """``--ports RUN BASE``: every cell both directories hold, ``RUN``
    against ``BASE`` (:func:`compare_ports`); ``ports.json`` under
    ``--out-dir`` and one table."""
    run_dir, base_dir = (Path(p) for p in args.ports)
    runs, bases = _port_json(run_dir), _port_json(base_dir)
    cells = {}
    for key in sorted(set(runs) | set(bases)):
        if key in runs and key in bases:
            cells["__".join(key)] = compare_ports(runs[key], bases[key])
        else:
            cells["__".join(key)] = {"missing_in": "run" if key not in runs
                                     else "base", "within": False}
    if args.ref_grid:
        # each side against the reference's own dry run (a --grid run's
        # grid.json): temp and collective bytes (loops x trips) ratios
        grid = json.loads(Path(args.ref_grid).read_text())
        refs = {f"{c['arch']}__{c['shape']}": c["fields"]
                for c in grid["cells"]}
        for name, c in cells.items():
            ref = refs.get(name, {})
            for side in ("run", "base"):
                if side not in c.get("fields", {}).get("temp bytes", {}):
                    continue
                for label, ref_label in (
                        ("temp bytes", "temp bytes"),
                        ("collective bytes",
                         "collective bytes, loops x trips")):
                    r = (ref.get(ref_label) or {}).get("ref")
                    v = c["fields"][label][side]
                    c.setdefault(f"{side} / reference", {})[label] = \
                        v / r if r and v is not None else None
    out = {"run": str(run_dir), "base": str(base_dir), "band": PORT_BAND,
           "cells": cells}
    Path(args.out_dir, "ports.json").write_text(json.dumps(out, indent=1))
    some = next((c for c in cells.values() if "torch" in c), None)
    print(f"{run_dir} / {base_dir} (torch {some['torch'][0]} / "
          f"{some['torch'][1]}), band {PORT_BAND[0]}-{PORT_BAND[1]}x"
          if some else f"{run_dir} / {base_dir}: no cell in both")
    cols = [("temp", "temp bytes"), ("coll", "collective bytes"),
            ("arg", "argument bytes")] + [
        (short, f"collective {op}") for short, op in (
            ("ag", "all-gather"), ("ar", "all-reduce"),
            ("rs", "reduce-scatter"), ("a2a", "all-to-all"))]
    vs_ref = [(f"{side[0]}/ref {short}", side, label)
              for side in ("run", "base")
              for short, label in (("temp", "temp bytes"),
                                   ("coll", "collective bytes"))
              if args.ref_grid]
    print(f"{'cell':<44}" + "".join(f"{c:>10}" for c, _ in cols)
          + "".join(f"{c:>13}" for c, _, _ in vs_ref)
          + "  within  replicated only in run / only in base")
    for name, c in cells.items():
        if "missing_in" in c:
            print(f"{name:<44}  missing in {c['missing_in']}")
            continue
        row = f"{name:<44}" + "".join(
            f"{_band(c['fields'].get(label)):>10}" for _, label in cols)
        for _, side, label in vs_ref:
            ratio = c.get(f"{side} / reference", {}).get(label)
            row += f"{_band({'ratio': ratio}):>13}"
        rep = (f"{c['replicated_only_in_run'] or ''} / "
               f"{c['replicated_only_in_base'] or ''}")
        print(f"{row}  {'yes' if c['within'] else 'NO':<6}  "
              f"{rep if rep != ' / ' else ''}")
    n_in = sum(c["within"] for c in cells.values())
    print(f"{n_in} of {len(cells)} cells within")
    return out


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.ports:
        return run_ports(args)
    if args.grid:
        return run_grid(args)
    if len(args.arch) != 1 or len(args.shape) != 1:
        raise SystemExit("one --arch and one --shape, or --grid")
    args.arch, args.shape = args.arch[0], args.shape[0]
    if args.side:
        res = (run_reference if args.side == "ref" else run_port)(args)
        (out_dir / f"{args.side}.json").write_text(json.dumps(res, indent=1))
        return res
    results, failed = _children(_cell_argv(args, args.arch, args.shape),
                                out_dir)
    if failed:
        for side, tail in failed.items():
            print(f"the {side} dry run failed, {tail}", file=sys.stderr)
        raise RuntimeError(f"the {' and '.join(failed)} dry run failed")
    rec = _record(args, args.arch, args.shape, results, failed)
    (out_dir / "compare.json").write_text(json.dumps(rec, indent=1))
    table = rec["fields"]
    print(f"{args.arch} x {args.shape} on {rec['mesh']}"
          f" {' '.join(args.overrides)}")
    print(f"{'field':<28}{'reference':>22}{'port':>22}{'port/ref':>12}")
    for label, v in table.items():
        ratio = "" if v["ratio"] is None else f"{v['ratio']:.4g}"
        print(f"{label:<28}{_fmt(v['ref']):>22}{_fmt(v['port']):>22}"
              f"{ratio:>12}")
    return table


if __name__ == "__main__":
    main()
