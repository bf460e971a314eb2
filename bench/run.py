#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine it is started on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cells, their configurations, traffic
mixes, metrics and limits are named in ``BENCHMARK.json`` and found under
``bench/``.  Standard error carries the run's details and, last, each
number the comparison held against its limit; the last line of standard
output is the result as one JSON object.  The run needs the cell's cards
(``torch.cuda``) and exits with a non-zero code, printing no result,
without them, without the port (``src/repro_torch``), or when JAX or the
JAX package has been loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the checkout (the bench package) and the port; not this folder, whose
    # module names would shadow others'
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path[1:] if Path(p or ".").resolve() != ROOT / "bench"]

    import torch
    from bench import harness
    from bench.manifest import Manifest

    manifest = Manifest(ROOT)
    chips = manifest.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2

    def log(line):
        print(line, file=sys.stderr, flush=True)
    result = harness.run(manifest, args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START,
                         log=log)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.json_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
