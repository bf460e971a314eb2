"""ClientStore and ParticipantSchedule: the registered-population layer
(port of ``repro.core.store``).

Cross-device federation registers far more clients than a round touches.
Client state is split in two layers:

* the **registered population** (:class:`ClientStore`): each client's
  personal state (its trainable LoRA and connector leaves and their AdamW
  moments) held on the host, or spilled to disk one ``client_<id>`` file a
  client in the :mod:`repro_torch.checkpointing` format.  The frozen
  backbone is not per client: every member of a cohort shares the
  cohort's, so the store scales with the personal state, not with the
  model times N;
* the **working set** of a round: the fixed-size stacked buffers on the
  device.  Each round the runner gathers the sampled clients' rows from
  the store (one host stack, one transfer a leaf), trains, and scatters the
  rows back.  Device memory follows the working set, not N.

:class:`ParticipantSchedule` draws each round's participants statelessly
from ``(seed, round)`` with numpy (the reference's salt and generator, so
its draws are the reference's).  Sampled local indices are sorted, so a
full-population sample is the identity.  Under a stateful wire codec each
entry holds a third key beside ``"train"`` and ``"opt"``: ``"chan"``, the
client's f32 error-feedback residual; ``put`` and ``scatter`` overwrite
whole entries, so every write carries ``"chan"`` forward.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpointing.checkpoint import (flatten_pytree,
                                                  load_pytree, map_pytree,
                                                  save_pytree)
from repro_torch.core.spec import ParticipantSampler

# salt of the per-round sampling draw's generator (cf. faults.FaultSchedule)
_SAMPLE_SALT = 0x5A3B1E


class ParticipantSchedule:
    """Deterministic per-round participant draws over the cohorts.

    ``round_locals(r)``: per cohort, the sorted LOCAL member indices;
    ``round_ids(r)``: the same as one GLOBAL id vector (the working set's
    row -> client map).  Any round can be drawn any number of times, in
    any order: a restored run replays the sampling from the round counter
    alone."""

    def __init__(self, sampler: ParticipantSampler,
                 cohort_sizes: Sequence[int], offsets: Sequence[int]):
        self.sampler = sampler
        self.sizes = tuple(int(n) for n in cohort_sizes)
        self.offsets = tuple(int(o) for o in offsets)
        self.counts = sampler.counts(self.sizes)

    @property
    def total(self) -> int:
        """The working set's size: clients sampled a round."""
        return sum(self.counts)

    @property
    def is_identity(self) -> bool:
        """True when every cohort samples all its members."""
        return self.counts == self.sizes

    def round_locals(self, rnd: int) -> List[np.ndarray]:
        """Per cohort, the sorted local indices sampled in round ``rnd``."""
        rng = np.random.default_rng(
            [int(self.sampler.seed), _SAMPLE_SALT, int(rnd)])
        return [np.sort(rng.permutation(n)[:k])
                for n, k in zip(self.sizes, self.counts)]

    def round_ids(self, rnd: int) -> np.ndarray:
        """Round ``rnd``'s sampled global client ids (working-set order)."""
        return np.concatenate([
            off + loc for off, loc in zip(self.offsets,
                                          self.round_locals(rnd))])


def _host_copy(leaf):
    """One leaf as a host tensor that owns its memory: a copy, never a
    view, even of a CPU tensor (a view of a stacked working set would pin
    the whole stack, and on the card an entry must not hold device
    memory)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf))


class ClientStore:
    """Host- or disk-resident registry of per-client personal state.

    An entry is a pytree ``{"train": <flat trainable dict>, "opt": <AdamW
    state>}`` (plus ``"chan"`` under a stateful codec), held as host
    tensors.  Pass ``directory`` to spill each client to its own
    ``client_<id>`` file (the store then keeps only empty templates, and
    ``gather`` reads the sampled rows back from disk)."""

    def __init__(self, directory: Optional[str] = None):
        self._dir = directory
        self._mem: Dict[int, Dict] = {}
        self._tmpl: Dict[int, Dict] = {}
        if directory is not None:
            os.makedirs(directory, exist_ok=True)

    def _path(self, cid: int) -> str:
        return os.path.join(self._dir, f"client_{int(cid)}")

    def put(self, cid: int, state: Dict) -> None:
        """Write client ``cid``'s personal state (a host copy)."""
        cid = int(cid)
        host = map_pytree(_host_copy, state)
        if self._dir is None:
            self._mem[cid] = host
            return
        save_pytree(self._path(cid), host)
        if cid not in self._tmpl:
            self._tmpl[cid] = map_pytree(
                lambda t: torch.empty(0, dtype=t.dtype), host)

    def get(self, cid: int) -> Dict:
        """Client ``cid``'s personal state (host tensors)."""
        cid = int(cid)
        if self._dir is None:
            return self._mem[cid]
        return load_pytree(self._path(cid), self._tmpl[cid])

    def gather(self, ids: Sequence[int]) -> Dict:
        """The sampled clients' states stacked on a new leading axis, on
        the host (the caller transfers once a leaf)."""
        rows = [self.get(cid) for cid in ids]
        return map_pytree(lambda *xs: torch.stack(xs), *rows)

    def scatter(self, ids: Sequence[int], stacked) -> None:
        """Write a stacked working set back, row by row (one device ->
        host transfer a leaf)."""
        host = map_pytree(lambda t: t.detach().cpu(), stacked)
        for i, cid in enumerate(ids):
            self.put(cid, map_pytree(lambda t, _i=i: t[_i], host))

    def __len__(self) -> int:
        return len(self._mem) if self._dir is None else len(self._tmpl)

    def ids(self) -> List[int]:
        """Sorted global ids of every registered client."""
        return sorted(self._mem if self._dir is None else self._tmpl)

    def nbytes(self) -> int:
        """Total host bytes of the registered population (reads every
        client under disk spill: for reporting, not hot paths)."""
        return sum(t.numel() * t.element_size()
                   for cid in self.ids()
                   for t in flatten_pytree(self.get(cid)).values())

    def state_pytree(self) -> Dict:
        """The whole population as one pytree (keys ``c<id>``), for a
        :class:`repro_torch.checkpointing.CheckpointManager` round trip."""
        return {f"c{cid}": self.get(cid) for cid in self.ids()}

    def load_state_pytree(self, tree: Dict) -> None:
        """Inverse of :meth:`state_pytree`."""
        for key, state in tree.items():
            self.put(int(key[1:]), state)
