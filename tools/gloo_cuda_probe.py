"""Which collectives a gloo process group takes on CUDA tensors, with two
ranks sharing one card, and how long a 1 GiB all-reduce takes through
gloo on the card and staged through the host.

Run on a machine with one NVIDIA GPU, from the root of a checkout:

    python3 tools/gloo_cuda_probe.py

Each rank prints, as JSON, every case's result: ``ok`` (the values came
out right) and its seconds, or the error the collective raised.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def cases(rank, world):
    dev = "cuda:0"

    def all_gather(dtype=torch.float32):
        x = torch.full((4, 3), float(rank + 1), device=dev, dtype=dtype)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return all(p.is_cuda and float(p[0, 0]) == i + 1
                   for i, p in enumerate(parts))

    def all_reduce():
        x = torch.full((5,), float(rank + 1), device=dev)
        dist.all_reduce(x)
        return x.is_cuda and float(x[0]) == world * (world + 1) / 2

    def broadcast(dtype=torch.float32):
        x = torch.full((7,), rank + 1, device=dev, dtype=dtype)
        dist.broadcast(x, src=world - 1)
        return float(x[0]) == world

    def barrier():
        dist.barrier()
        return True

    def all_reduce_1gib(staged):
        x = torch.ones((256 * 2**20,), device=dev)
        if staged:
            host = x.cpu()
            dist.all_reduce(host)
            x.copy_(host)
        else:
            dist.all_reduce(x)
        return float(x[0]) == world

    return {"all_gather": all_gather,
            "all_gather_bf16": lambda: all_gather(torch.bfloat16),
            "all_reduce": all_reduce, "broadcast": broadcast,
            "broadcast_bf16": lambda: broadcast(torch.bfloat16),
            "broadcast_int8": lambda: broadcast(torch.int8),
            "barrier": barrier,
            "all_reduce_1GiB_cuda": lambda: all_reduce_1gib(False),
            "all_reduce_1GiB_host": lambda: all_reduce_1gib(True)}


def rank_main(rank, world, store, out_dir):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    res = {}
    try:
        for name, fn in cases(rank, world).items():
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ok = fn()
                torch.cuda.synchronize()
                res[name] = {"ok": bool(ok), "s": time.perf_counter() - t0}
            except RuntimeError as e:   # reported: gloo refused the case
                res[name] = {"error": repr(e)[:300]}
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    world = 2
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main,
                             args=(r, world, os.path.join(d, "store"), d))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for r in range(world):
            path = os.path.join(d, f"rank{r}.json")
            print(r, open(path).read() if os.path.exists(path) else
                  "no result")
        return 0 if all(p.exitcode == 0 for p in procs) else 1


if __name__ == "__main__":
    sys.exit(main())
