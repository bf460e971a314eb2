"""How fast a checkpoint of tensors on the card goes to a file and back:
the port's ``save_pytree`` / ``load_pytree`` beside the same file written
by ``np.savez`` and read by ``np.load`` (what they did before).

Run on a machine with one NVIDIA GPU, from the root of a checkout:

    python3 tools/checkpoint_io_probe.py [--gb 4.8]

The tree is bf16 and f32 leaves on cuda:0 (two thirds of the bytes
bf16), written under a temporary directory (``TMPDIR``), read back onto
the card and compared bit for bit.  Prints one JSON object: GB/s of each
path and of a plain read of the file, with the card's name and power
limit.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.checkpointing import checkpoint as ck  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def numpy_save(path, tree):
    arrays = {}
    for i, (_, leaf) in enumerate(sorted(ck.flatten_pytree(tree).items())):
        arrays[f"a{i}"] = ck._to_numpy(leaf)[0]
    np.savez(path + ".npz", **arrays)


def numpy_load(path, tree):
    out = {}
    with np.load(path + ".npz") as data:
        for i, k in enumerate(sorted(tree)):
            arr = np.array(data[f"a{i}"])
            t = torch.from_numpy(arr.view(np.int16) if arr.dtype == np.uint16
                                 else arr)
            out[k] = t.view(torch.bfloat16) if arr.dtype == np.uint16 else t
    return {k: v.to("cuda") for k, v in out.items()}


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=4.8)
    gb = ap.parse_args().gb
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = 4096
    n_bf16 = max(1, round(gb * 2 / 3 * 1e9 / (rows * 16384 * 2)))
    n_f32 = max(1, round(gb / 3 * 1e9 / (rows * 16384 * 4)))
    tree = {f"b{i:03d}": torch.randn(rows, 16384, generator=gen,
                                     device="cuda").to(torch.bfloat16)
            for i in range(n_bf16)}
    tree.update({f"f{i:03d}": torch.randn(rows, 16384, generator=gen,
                                          device="cuda")
                 for i in range(n_f32)})
    nbytes = sum(t.numel() * t.element_size() for t in tree.values())
    out = {"bytes": nbytes}
    with tempfile.TemporaryDirectory(prefix="ckpt_probe_") as d:
        for tag, save, load in (("numpy", numpy_save, numpy_load),
                                ("port", ck.save_pytree, ck.load_pytree)):
            path = os.path.join(d, tag)
            _, s = timed(lambda: save(path, tree))
            got, l_s = timed(lambda: load(path, tree))
            same = all(got[k].dtype == v.dtype and got[k].is_cuda
                       and torch.equal(bits(got[k]), bits(v))
                       for k, v in tree.items())
            del got
            t0 = time.perf_counter()
            with open(path + ".npz", "rb") as f:
                while f.read(1 << 26):
                    pass
            out[tag] = {"save_gb_s": nbytes / 1e9 / s,
                        "load_gb_s": nbytes / 1e9 / l_s,
                        "plain_read_gb_s": nbytes / 1e9
                        / (time.perf_counter() - t0),
                        "bit_equal": same}
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
