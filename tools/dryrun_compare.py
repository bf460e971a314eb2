"""The port's dry run against the reference's, field by field.

Runs ``repro.launch.dryrun.dryrun_one`` and ``repro_torch.launch.dryrun.
dryrun_one`` on the same (arch x input shape), each in a child process of
its own, and prints both values of every field beside their ratio (port
over reference): argument, output, alias and temp bytes a rank; the
collective bytes a rank, in all and by op; FLOP and bytes accessed.

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
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (label, path into a dry run's JSON)
FIELDS = [
    ("argument bytes", ("memory_analysis", "argument_size_in_bytes")),
    ("output bytes", ("memory_analysis", "output_size_in_bytes")),
    ("alias bytes", ("memory_analysis", "alias_size_in_bytes")),
    ("temp bytes", ("memory_analysis", "temp_size_in_bytes")),
    ("collective bytes", ("collectives", "total_bytes")),
    ("flops", ("cost_analysis", "flops")),
    ("bytes accessed", ("cost_analysis", "bytes accessed")),
]
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute", "broadcast")


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


def run_reference(args) -> dict:
    """The reference's ``dryrun_one`` on an Auto-axes mesh of
    ``args.mesh`` (it forces 512 host devices when imported)."""
    import jax
    from jax.sharding import AxisType

    from repro.launch import dryrun as D
    names, dims = args.mesh
    D.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
        dims, names, axis_types=(AxisType.Auto,) * len(dims))
    D.INPUT_SHAPES = {**D.INPUT_SHAPES, args.shape: _shape(D, args)}
    return D.dryrun_one(args.arch, args.shape, multi_pod=len(dims) == 3,
                        overrides=args.overrides)


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


def _get(res: dict, path):
    for k in path:
        if not isinstance(res, dict) or k not in res:
            return None
        res = res[k]
    return res


def compare(ref: dict, port: dict) -> dict:
    """{field: {"ref", "port", "ratio"}} (ratio = port / ref; None where
    either is missing or the reference's is 0)."""
    fields = list(FIELDS) + [
        (f"collective {op}", ("collectives", "per_op", op, "bytes"))
        for op in COLLECTIVE_OPS]
    out = {}
    for label, path in fields:
        r, p = _get(ref, path), _get(port, path)
        if r is None and p is None:
            continue
        out[label] = {"ref": r, "port": p,
                      "ratio": p / r if r and p is not None else None}
    return out


def _children(argv, out_dir: Path):
    """Both sides' results, each side run in a child process of its own,
    the two at once."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["JAX_PLATFORMS"] = "cpu"
    procs = {side: subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--side", side,
         *argv], env=env) for side in ("ref", "port")}
    failed = [side for side, p in procs.items() if p.wait() != 0]
    if failed:
        raise RuntimeError(f"the {' and '.join(failed)} dry run failed")
    return [json.loads((out_dir / f"{side}.json").read_text())
            for side in ("ref", "port")]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[], dest="overrides",
                    help="config override key=value (e.g. n_layers=1)")
    ap.add_argument("--mesh", type=_mesh, default=_mesh("16x16"))
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--side", choices=("ref", "port"), help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.side:
        res = (run_reference if args.side == "ref" else run_port)(args)
        (out_dir / f"{args.side}.json").write_text(json.dumps(res, indent=1))
        return res
    ref, port = _children(argv, out_dir)
    table = compare(ref, port)
    (out_dir / "compare.json").write_text(json.dumps(
        {"arch": args.arch, "shape": args.shape,
         "mesh": "x".join(map(str, args.mesh[1])),
         "overrides": args.overrides, "fields": table,
         "seconds": {"ref": ref["lower_s"] + ref["compile_s"],
                     "port": port["lower_s"] + port["compile_s"]},
         "torch": port.get("torch"), "port_replicated_ops":
         port.get("replicated_ops")}, indent=1))
    print(f"{args.arch} x {args.shape} on {'x'.join(map(str, args.mesh[1]))}"
          f" {' '.join(args.overrides)}")
    print(f"{'field':<28}{'reference':>22}{'port':>22}{'port/ref':>12}")
    for label, v in table.items():
        ratio = "" if v["ratio"] is None else f"{v['ratio']:.4g}"
        print(f"{label:<28}{_fmt(v['ref']):>22}{_fmt(v['port']):>22}"
              f"{ratio:>12}")
    return table


def _fmt(v) -> str:
    if v is None:
        return "-"
    return f"{v:,.0f}" if float(v).is_integer() or abs(v) > 1e3 else f"{v:.4g}"


if __name__ == "__main__":
    main()
