"""How long the kernel build takes with and without ``--split-compile=0``,
and whether the flag changes any kernel's registers or spills.

Run on a machine with the CUDA toolkit, from the root of a checkout:

    python3 tools/nvcc_build_probe.py

Compiles every source of ``src/repro_torch/kernels/csrc`` the way
``repro_torch.kernels._build`` does (one ``nvcc`` a source, all started
together) into a temporary directory, once without the flag, once with
it and once more without it, and prints each pass's seconds by source as
JSON, then the kernels whose ``-Xptxas=-v`` registers or spill stores
differ between the two flag sets.
"""
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import _build  # noqa: E402

SPLIT = "--split-compile=0"
BASE = tuple(f for f in _build.NVCC_FLAGS if f != SPLIT)


def build_pass(flags, out_dir, tag):
    """Seconds until each source's nvcc ended, all started together."""
    t0 = time.perf_counter()
    procs = {}
    for name, src in _build.sources().items():
        log = open(os.path.join(out_dir, f"{tag}_{name}.log"), "w")
        procs[name] = subprocess.Popen(
            [_build.nvcc(), *flags, "-o",
             os.path.join(out_dir, f"{tag}_{name}.so"), str(src)],
            stdout=log, stderr=subprocess.STDOUT)
    ended = {}
    while len(ended) < len(procs):
        for name, p in procs.items():
            if name not in ended and p.poll() is not None:
                if p.returncode:
                    raise RuntimeError(f"{tag} {name}: nvcc exit "
                                       f"{p.returncode}")
                ended[name] = round(time.perf_counter() - t0, 1)
        time.sleep(0.2)
    return {"total_s": max(ended.values()), "by_source_s": ended}


def report(out_dir, tag):
    """{kernel: (registers, spill store bytes)} of one pass."""
    got = {}
    for name in _build.sources():
        with open(os.path.join(out_dir, f"{tag}_{name}.log")) as f:
            log = f.read()
        for fn, body in re.findall(
                r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry"
                r" function|\Z)", log, re.S):
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            got[fn] = (regs and int(regs.group(1)),
                       spill and int(spill.group(1)))
    return got


def main():
    with tempfile.TemporaryDirectory(prefix="nvcc_probe_") as out_dir:
        passes = {}
        for tag, flags in (("without", BASE), ("with", (*BASE, SPLIT)),
                           ("without_again", BASE)):
            passes[tag] = build_pass(flags, out_dir, tag)
            print(tag, json.dumps(passes[tag]), flush=True)
        a, b = report(out_dir, "without"), report(out_dir, "with")
        diff = {k: {"without": a.get(k), "with": b.get(k)}
                for k in sorted(set(a) | set(b)) if a.get(k) != b.get(k)}
        print(json.dumps({"cores": os.cpu_count(), "kernels": len(a),
                          "differ": diff}), flush=True)


if __name__ == "__main__":
    main()
