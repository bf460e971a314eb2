#!/usr/bin/env python3
"""The readings the comparison's limits are set from, on the card, at a
cell's own size (no measured window: the numbers compared come from the
rounds that set-up follows).

    python3 bench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control 11 12 13] [--fault 11 12 13] [--out FILE]

For each seed of ``--seeds``: the program (set-up's rounds) against the
plain reference, the lower reading.  For each seed of ``--control``: the
reference computed with fp8 products (the nearest precision below the
configuration's bf16) in the program's place, against the reference.
For each seed of ``--fault``: the reference with every step on half of
its rows (the mean over the rest) in the program's place.  A state left
unchanged reads 1 on the two leaf numbers and needs no run.  One JSON
line a reading goes to standard output and to ``--out``.
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path[1:] if Path(p or ".").resolve() != ROOT / "bench"]

    import torch
    from bench import compare, federation as F, harness
    from bench.manifest import Manifest

    if not torch.cuda.is_available():
        print("calibration needs a CUDA device", file=sys.stderr)
        return 2
    m = Manifest(ROOT)
    cell = m.cell(args.workload)
    cfg, traffic = m.config(cell["config"]), m.traffic(cell["traffic"])
    models = F.models(cfg)
    rounds = traffic["followed_rounds"]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = harness.json_line(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in dict.fromkeys(args.seeds + args.control + args.fault):
        fed = F.fed_params(traffic, seed)
        data = F.corpus(models, traffic, seed)
        t = time.perf_counter()
        ref = harness.reference_readings(models, fed, data, seed, "cuda",
                                         rounds)
        ref_s = time.perf_counter() - t
        sides = []
        if seed in args.seeds:
            prog = harness.Program(models, fed, traffic, data, seed, "cuda")
            sides.append(("program", prog.setup()))
            prog.close()
            del prog
        if seed in args.control:
            sides.append(("control_fp8", harness.reference_readings(
                models, fed, data, seed, "cuda", rounds, precision="fp8")))
        if seed in args.fault:
            sides.append(("fault_half_batch", harness.reference_readings(
                models, fed, data, seed, "cuda", rounds, half_batch=True)))
        for name, side in sides:
            read = compare.readings(side, ref)
            emit({"cell": args.workload, "seed": seed, "side": name,
                  "reference_s": ref_s,
                  **{k: v["value"] for k, v in read.items()},
                  "entries": {k: v["entry"] for k, v in read.items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
