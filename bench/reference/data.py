"""The round's data as the reference works it out from the corpus and the
federation's seed: the public / private split, the train / test splits,
the MER modality masks and each client's shuffled batch stream.

These are copies of the program's numpy partition and stream arithmetic
(``repro_torch/data/multimodal.py`` and ``data/pipeline.py``, which copy
the JAX package's), so the reference derives every batch itself and
takes none from the program.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

FIELDS = ("tokens", "loss_mask", "modality_feats", "label", "template_start")
MASK_SEED_STRIDE = 7919      # cohort c's MER masks: from seed + c * 7919


def mer_partition(seed: int, n_devices: int, n_modalities: int, rho: float,
                  allowed: Optional[np.ndarray] = None) -> np.ndarray:
    """(n_devices, n_modalities) bool: each device keeps modality m with
    probability rho (within ``allowed``), at least one kept."""
    rng = np.random.default_rng(seed)
    masks = rng.random((n_devices, n_modalities)) < rho
    if allowed is not None:
        allowed = np.asarray(allowed, bool)
        masks &= allowed
        choices = np.flatnonzero(allowed)
    for j in range(n_devices):
        if not masks[j].any():
            if allowed is None:
                masks[j, rng.integers(n_modalities)] = True
            else:
                masks[j, choices[rng.integers(len(choices))]] = True
    return masks


def _slice(data: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    n = data["tokens"].shape[0]
    return {k: (v[idx] if isinstance(v, np.ndarray) and v.shape[:1] == (n,)
                else v) for k, v in data.items()}


def paper_split(data, n_devices: int, seed: int):
    """A quarter public, the rest split evenly over the devices."""
    n = data["tokens"].shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    n_pub = n // 4
    return (_slice(data, perm[:n_pub]),
            [_slice(data, s) for s in np.array_split(perm[n_pub:],
                                                     n_devices)])


def train_test_split(data, test_frac: float, seed: int):
    n = data["tokens"].shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    n_test = max(1, int(n * test_frac))
    return _slice(data, perm[n_test:]), _slice(data, perm[:n_test])


def index_stream(n: int, batch_size: int, seed: int) -> Iterator[np.ndarray]:
    """Infinite per-epoch-shuffled index batches (drop-last)."""
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            yield perm[i:i + batch_size]


def gather(data, idx, modality_mask: Optional[np.ndarray]):
    """A batch of rows ``idx``: the device's modality mask, unobservable
    features zeroed."""
    b = {k: data[k][idx] for k in FIELDS}
    B, M = b["modality_feats"].shape[:2]
    mm = np.ones((B, M), bool) if modality_mask is None else \
        np.broadcast_to(np.asarray(modality_mask, bool), (B, M))
    b["modality_mask"] = mm
    b["modality_feats"] = b["modality_feats"] * mm[..., None]
    return b


class Stream:
    """One named shuffle stream over a data split."""

    def __init__(self, data, batch_size: int, seed: int,
                 mask: Optional[np.ndarray] = None):
        self.data, self.mask = data, mask
        self.it = index_stream(data["tokens"].shape[0], batch_size, seed)

    def pull(self) -> Dict[str, np.ndarray]:
        return gather(self.data, next(self.it), self.mask)


def federation_data(corpus, fed: Dict) -> Dict:
    """Masks, splits and streams of a federation: ``fed`` holds
    ``cohorts`` [(n_clients, modalities or None)], ``seed``, ``rho``,
    ``batch_size``."""
    seed, rho, bs = fed["seed"], fed["rho"], fed["batch_size"]
    sizes = [n for n, _ in fed["cohorts"]]
    N = sum(sizes)
    M = corpus["modality_feats"].shape[1]
    masks = []
    for c, (n, mods) in enumerate(fed["cohorts"]):
        allowed = None
        if mods is not None:
            allowed = np.zeros(M, bool)
            allowed[list(mods)] = True
        masks.append(mer_partition(seed + MASK_SEED_STRIDE * c, n, M, rho,
                                   allowed))
    masks = np.concatenate(masks, axis=0)
    public, privates = paper_split(corpus, N, seed)
    pub_train, _ = train_test_split(public, 0.1, seed)
    priv_train = [train_test_split(pv, 0.1, seed + j + 1)[0]
                  for j, pv in enumerate(privates)]
    streams: Dict[str, Stream] = {}
    for j in range(N):
        streams[f"pub/{j}"] = Stream(pub_train, bs, seed + 100 + j, masks[j])
        streams[f"priv/{j}"] = Stream(priv_train[j], bs, seed + 200 + j,
                                      masks[j])
    streams["server"] = Stream(pub_train, bs, seed + 999)
    return {"masks": masks, "streams": streams,
            "mod_counts": [int(masks[j].sum()) for j in range(N)]}


def cohort_slices(fed: Dict) -> List[range]:
    out, acc = [], 0
    for n, _ in fed["cohorts"]:
        out.append(range(acc, acc + n))
        acc += n
    return out
