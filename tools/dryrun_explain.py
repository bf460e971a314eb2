"""Where one dry-run cell's collective and temp bytes come from, in the
port and in the reference, by source.

The port (``repro_torch.launch.dryrun.dryrun_one``, in this process): each
collective a rank issues, grouped by the line of ``src/repro_torch`` that
issued it (the innermost frame outside the dry run itself), with its
bytes a rank by the dry run's own formulas (``collective_bytes``); and the
local storages live at the rank's peak that are no argument, grouped by
the op and line that made them.  The reference (``repro.launch.dryrun.
dryrun_one``, in a child process, its mesh made Auto as
``tools/dryrun_compare.py`` makes it): each collective of its post-SPMD
HLO, grouped by the JAX op name XLA kept in its metadata, costed by the
reference's own ``collective_bytes``.

Usage, from the root of a checkout (CPU only):

    python tools/dryrun_explain.py --arch qwen3-1.7b --shape long_500k \\
        --set n_layers=1 [--mesh 4x4] [--top 12] [--out FILE.json]

The same arguments as ``tools/dryrun_compare.py``'s single mode (one
``--arch`` and one ``--shape``); prints both sides' tables and, with
``--out``, writes them as JSON; ``--port-only`` runs the port's side
alone (on a host with no JAX).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import traceback
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tools")]

import dryrun_compare as C  # noqa: E402


def _where() -> str:
    """The innermost frame of ``src/repro_torch`` outside the dry run."""
    for fr in reversed(traceback.extract_stack()):
        path = fr.filename.replace(os.sep, "/")
        if "/repro_torch/" in path and not path.endswith("launch/dryrun.py"):
            return f"{path.split('src/')[-1]}:{fr.lineno} ({fr.name})"
    return "(the dry run's own placement)"


def _placed(tree) -> list:
    """[global shape, placements] of each DTensor leaf of ``tree``."""
    import torch
    from torch.distributed.tensor import DTensor
    return [[list(t.shape), [str(p) for p in t.placements]]
            for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, DTensor)]


def port_side(args) -> dict:
    """{"collectives": [[where, op, bytes a rank, count]], "peak": [[op,
    where, bytes, count]], "memory_analysis", "collective_total", "ops":
    [every op DTensor dispatched, in order: {"op", "where", "in", "out"
    (:func:`_placed`), "collective_bytes" a rank, "replicated"}]}."""
    from repro_torch.launch import dryrun as D
    plain = D.RankCost

    class Explaining(plain):
        def __init__(self):
            super().__init__()
            self.where = []            # one per record of .collectives
            self.made = {}             # storage id -> (op, where)
            self.at_peak = {}
            self.flops_at = {}         # where -> matmul FLOP
            self.ops = []              # one per op DTensor dispatched
            self.op = "argument"

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n, f = len(self.collectives), self.flops
            op, self.op = self.op, str(func)
            try:
                return super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self.op = op
                if len(self.collectives) > n or self.flops > f:
                    here = _where()
                    self.where += [here] * (len(self.collectives) - n)
                    if self.flops > f and not self._in_dtensor:
                        self.flops_at[here] = self.flops_at.get(here, 0) \
                            + self.flops - f

        def _dtensor_op(self, func, args, kwargs):
            n = len(self.collectives)
            replicated = sum(self.replicated.values())
            out = super()._dtensor_op(func, args, kwargs)
            moved = D.collective_bytes(self.collectives[n:])["total_bytes"]
            self.ops.append({
                "op": str(func), "where": _where(),
                "in": _placed(args), "out": _placed(out),
                "collective_bytes": moved,
                "replicated": sum(self.replicated.values()) > replicated})
            return out

        def track(self, tensors):
            new = super().track(tensors)
            if new:
                here = None
                for t in tensors:
                    key = id(t.untyped_storage())
                    if key not in self.made:
                        here = here or _where()
                        self.made[key] = (self.op, here)
                if self.live_bytes >= self.peak_bytes:
                    self.at_peak = {k: (self.made.get(k), n)
                                    for k, n in self._live.items()}
            return new
    costs = []

    def make():
        costs.append(Explaining())
        return costs[-1]
    D.RankCost = make
    try:
        res = C.run_port(args)
    finally:
        D.RankCost = plain
    cost = costs[-1]
    coll = defaultdict(lambda: [0.0, 0])
    for rec, where in zip(cost.collectives, cost.where):
        moved = D.collective_bytes([rec])["total_bytes"]
        c = coll[(where, rec.op)]
        c[0] += moved
        c[1] += 1
    peak = defaultdict(lambda: [0, 0])
    for (made, n) in cost.at_peak.values():
        if made is None or made[0] == "argument":
            continue
        p = peak[made]
        p[0] += n
        p[1] += 1
    return {"memory_analysis": res["memory_analysis"],
            "collective_total": res["collectives"]["total_bytes"],
            "collectives": sorted([[w, op, b, n] for (w, op), (b, n)
                                   in coll.items()], key=lambda r: -r[2]),
            "flops": res["cost_analysis"]["flops"],
            "flops_at": sorted(cost.flops_at.items(), key=lambda r: -r[1]),
            "peak": sorted([[op, w, b, n] for (op, w), (b, n)
                            in peak.items()], key=lambda r: -r[2]),
            "ops": cost.ops}


_OP_NAME = re.compile(r'op_name="([^"]*)"')


def ref_side(args) -> dict:
    """{"collectives": [[op name, op, bytes a rank, count]], ...} of the
    reference's compiled step."""
    from repro.launch import dryrun as D
    texts = []
    count = D.collective_bytes

    def reading(text, *a, **k):
        texts.append(text)
        return count(text, *a, **k)
    D.collective_bytes = reading
    cargs = argparse.Namespace(**vars(args))
    res = C.run_reference(cargs)
    D.collective_bytes = count
    coll = defaultdict(lambda: [0.0, 0])
    for line in texts[0].splitlines():
        one = count(line)
        if not one["total_bytes"]:
            continue
        name = _OP_NAME.search(line)
        (op,) = one["per_op"]
        c = coll[(name.group(1) if name else "?", op)]
        c[0] += one["total_bytes"]
        c[1] += 1
    return {"memory_analysis": res["memory_analysis"],
            "collective_total": res["collectives"]["total_bytes"],
            "collectives": sorted([[w, op, b, n] for (w, op), (b, n)
                                   in coll.items()], key=lambda r: -r[2]),
            "largest": largest_buffers(texts[0])}


_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\w+)\[([\d,]*)\]"
                    r"\S*\s+([\w\-]+)\(")
_BYTES = {"pred": 1, "s8": 1, "u8": 1, "bf16": 2, "f16": 2, "s16": 2,
          "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8, "u64": 8}
_NO_BUFFER = ("parameter", "bitcast", "get-tuple-element", "tuple",
              "constant")


def largest_buffers(text: str, top: int = 40):
    """The largest outputs of the instructions of the computations an HLO
    module runs outside fusions (the entry and loop bodies), by op and
    JAX op name: where XLA's temp bytes can lie (its buffer assignment,
    which reuses them, is not in the text)."""
    out, fused = [], False
    for line in text.splitlines():
        if line.startswith("%fused") or line.startswith("fused"):
            fused = True
        elif line and not line[0].isspace():
            fused = False
        m = _INSTR.match(line)
        if fused or m is None or m.group(3) in _NO_BUFFER:
            continue
        n = _BYTES.get(m.group(1), 0)
        for d in m.group(2).split(","):
            n *= int(d) if d else 1
        name = _OP_NAME.search(line)
        out.append([n, m.group(3), f"{m.group(1)}[{m.group(2)}]",
                    name.group(1) if name else "?"])
    return sorted(out, key=lambda r: -r[0])[:top]


def _print(title, side, top):
    mem = side["memory_analysis"]
    print(f"== {title}: temp {mem['temp_size_in_bytes']:,} B, argument "
          f"{mem['argument_size_in_bytes']:,} B, collectives "
          f"{side['collective_total']:,.0f} B a rank")
    for where, op, b, n in side["collectives"][:top]:
        print(f"  {b:>16,.0f}  {op:<15} x{n:<4} {where}")
    if "largest" in side:
        print("  the largest buffers outside fusions:")
        for n, op, shape, name in side["largest"][:top]:
            print(f"  {n:>16,}  {op:<15} {shape:<24} {name}")
    if "flops_at" in side:
        print(f"  matmul FLOP {side['flops']:,.0f}, by line:")
        for where, f in side["flops_at"][:top]:
            print(f"  {f:>16,}  {where}")
    if "peak" in side:
        print("  live at the peak (no argument):")
        for op, where, b, n in side["peak"][:top]:
            print(f"  {b:>16,}  {op:<34} x{n:<4} {where}")
    if "ops" in side:
        ops = sorted((o for o in side["ops"]
                      if o["collective_bytes"] or o["replicated"]),
                     key=lambda o: -o["collective_bytes"])
        print("  the ops that moved bytes or ran replicated (R), by bytes:")
        for o in ops[:top]:
            mark = "R" if o["replicated"] else " "
            print(f"  {o['collective_bytes']:>16,.0f} {mark} {o['op']:<34} "
                  f"{o['where']}\n{'':>22}in {o['in']} out {o['out']}")


def main(argv=None):
    ap = C._parser()
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out")
    ap.add_argument("--port-only", action="store_true",
                    help="the port's side alone (a host with no JAX)")
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--out-dir" not in argv:
        argv += ["--out-dir", "."]
    args = ap.parse_args(argv)
    if len(args.arch) != 1 or len(args.shape) != 1:
        raise SystemExit("one --arch and one --shape")
    args.arch, args.shape = args.arch[0], args.shape[0]
    if args.side == "ref":
        print(json.dumps(ref_side(args)))
        return None
    out = {"port": port_side(args)}
    if not args.port_only:
        ref = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), *argv, "--side",
             "ref"], env=C._env(), capture_output=True, text=True,
            check=True)
        out["ref"] = json.loads(ref.stdout.splitlines()[-1])
    print(f"{args.arch} x {args.shape} on {'x'.join(map(str, args.mesh[1]))}"
          f" {' '.join(args.overrides)}")
    if "ref" in out:
        _print("reference", out["ref"], args.top)
    _print("port", out["port"], args.top)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
