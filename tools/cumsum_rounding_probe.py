"""How far the rounding of one ``torch.cumsum`` moves an f32 trainer step
of an SSD model: the gap that ``chip_smoke.py``'s ``card_against_cpu``
check sees between the card and the CPU in the SSD's LoRA leaves.

``ops.ssd_chunked`` forms each chunk's cumulative decay with
``torch.cumsum`` over up to 256 positions.  On the CPU PyTorch accumulates
an f32 cumsum in double, on the card in f32, and the decay factors
exp(cum_i - cum_j) inherit the difference.  This probe runs one SGD (lr 1)
``make_train_step`` of a model (full width, 2 layers, f32, the batch of
``chip_smoke.CPU_STEP_CASES``) on the CPU twice, with torch's cumsum and
with one that adds in f32 position by position, and prints the loss gap
and each updated leaf's largest gap row by row against the row's largest
|value| (the check's measure; its tolerance is 1e-4).

    PYTHONPATH=src python tools/cumsum_rounding_probe.py [mamba2-2.7b]

It runs on the CPU only (~1 min for mamba2-2.7b on 8 cores).
"""
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core.ccl import init_unified  # noqa: E402
from repro_torch.core.lora import flatten, partition, unflatten  # noqa: E402
from repro_torch.data.pipeline import batches  # noqa: E402
from repro_torch.launch.train import make_train_step  # noqa: E402
from repro_torch.models.model import build_model, with_overrides  # noqa: E402
from repro_torch.optim.adamw import sgd  # noqa: E402

TORCH_CUMSUM = torch.cumsum


def f32_cumsum(x, dim, **kw):
    """cumsum of an f32 tensor with f32 adds, one position after another."""
    if x.dtype != torch.float32:
        return TORCH_CUMSUM(x, dim, **kw)
    xs = x.movedim(dim, 0)
    out = [xs[0]]
    for i in range(1, xs.shape[0]):
        out.append(out[-1] + xs[i])
    return torch.stack(out).movedim(0, dim)


def main(name="mamba2-2.7b"):
    rows, seq = chip_smoke.CPU_STEP_CASES[name]
    mc = with_overrides(get_config(name), n_layers=chip_smoke.CPU_STEP_LAYERS,
                        dtype="float32")
    gen = torch.Generator().manual_seed(27)
    bundle = build_model(mc)
    flat = flatten(init_unified(gen, bundle))
    flat.update({k: 0.02 * torch.randn(v.shape, generator=gen)
                 for k, v in flat.items() if k.endswith("_lora_b")})
    batch = next(batches(chip_smoke.trainer_corpus(seq, mc.vocab_size), rows,
                         seed=3, device="cpu"))
    opt = sgd(chip_smoke.STACKED_LR)
    step = make_train_step(bundle, opt)
    runs = {}
    for label, fn in (("torch", TORCH_CUMSUM), ("f32_adds", f32_cumsum)):
        torch.cumsum = fn
        try:
            params = unflatten(dict(flat))
            new, _, m = step(params, opt.init(partition(params)), batch)
        finally:
            torch.cumsum = TORCH_CUMSUM
        runs[label] = (float(m["loss"]), partition(new))
    (la, a), (lb, b) = runs["torch"], runs["f32_adds"]
    gaps = {}
    for k, w in a.items():
        w2, g = w.reshape(-1, w.shape[-1]), b[k].reshape(-1, w.shape[-1])
        scale = w2.abs().amax(1, keepdim=True).clamp(min=1e-30)
        gaps[k] = float(((g - w2).abs() / scale).max())
    print(json.dumps({"arch": name, "rows": rows, "seq": seq,
                      "loss_rel_gap": abs(la - lb) / abs(la),
                      "leaf_row_gap": dict(sorted(
                          gaps.items(), key=lambda kv: -kv[1]))}, indent=1))


if __name__ == "__main__":
    main(*sys.argv[1:])
